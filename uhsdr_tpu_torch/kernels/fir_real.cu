// K8, the TX analytic FIR, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel uhsdr_tpu/pallas/fir.py::_fir_real_kernel
// (fir_real_analytic_pallas, entered from mod/modulators.py:120 for the
// AM modulator and :137 for the SSB modulator).  Per channel, in one pass
// over the block:
//   y[n] = sum_k h[k] * x[n-k], real f32 audio x through complex taps h
//     (the 201-tap TX Hilbert pair), decimation 1, over the carried real
//     history (the last taps-1 samples of the stream);
//   optionally conjugated (LSB), then rotated by
//     exp(j*2pi*(phase0 + delta*n)/2^32), uint32 modular phase;
//   emits y as interleaved complex64 and the new history.
//
// Bound on this card: operations.  At the TX flagship (8192 ch x 16384
// samples, 201 taps) it is 54 G FMA of FP32 on the CUDA cores (no tensor
// cores, no TF32) against 1.5 GiB of memory traffic (0.48 ms).  An SM
// issues four FMA warp instructions a clock but serves one shared-memory
// wavefront, so a FIR that loads a tap and a sample for each FMA pair is
// held by its shared loads (PR 4's body, one output a thread over a
// 512-word ring: 4.6x the FMA bound).
//
// Design (a register-blocked FIR, K5's stage A at decimation 1 with the
// planes and the taps exchanged: one real input, two tap planes).  One
// thread block of NT threads per channel walks the block's time tiles IN
// ORDER.  A tile is T_TILE outputs (TILE_BYTES of audio; at least the
// halo; one tile of the block's length, rounded up to R, where the block
// is shorter), in a linear shared-memory buffer whose first E columns
// hold the halo (sample n of the tile at column E + n); at a tile's end
// the last E columns are copied to the front, so no index wraps.
//   staging: the next tile's audio is copied to shared memory by cp.async
//     (16 bytes a thread) while this tile is filtered;
//   load: the staged samples go to their (padded) columns;
//   FIR: a thread owns R consecutive outputs and slides a window of R
//     samples through registers, so each new sample (one shared load) and
//     each tap (hr, hi) (half a broadcast float4 load) feed 2R FMAs.  The
//     taps are zero-padded to AP, whole chunks of R, so the hot loop has
//     no test.  Where the tile has too few outputs for every thread, the
//     chunks are split over P groups and the P partial sums added in a
//     fixed order;
//   rotation and store: one sincospif on the exact uint32 phase of a
//     thread's first output and a complex product with a per-block table
//     e^{j 2pi delta r / 2^32}, r < R, for the others (conjugated first
//     for LSB); float4 stores where the row is 16-byte aligned.
//   The tile buffer is padded one word in R (index i + i/R), so threads R
//   outputs apart read distinct banks.  Every sum's order depends on the
//   shapes (taps, block length) alone, never on the channel count or a
//   channel's place in the launch: batching channels changes no bit.  For
//   finite inputs the zero taps change no bit of a sum.  The only limit
//   on the taps is the block's shared memory (SMEM_MAX; the wrapper checks
//   cuda/fir.py::fir_real_geometry, the same rule).
// What holds it now: the FIR loop.  Alone (no load, no store) it runs at
// 62-66% of the FP32 peak at the TX shapes, and the loads and stores
// overlap it almost whole; a chunk of 8 taps compiles to 128 FFMA beside
// 12 shared loads and 4 loop instructions (at most 89% of the FMA issue),
// and the SM clock holds 1980 MHz under it (PERF.md section 6, `python -m
// uhsdr_tpu_torch.trace_fir_real`).  R = 16 (more registers, fewer blocks
// an SM) measured slower with the NCO, eight blocks an SM and 16 KB tiles
// no faster.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- geometry (cuda/fir.py::fir_real_geometry mirrors it) ----
constexpr int NT = 128;            // threads per block
constexpr int R = 8;               // outputs a thread holds in registers
constexpr int TILE_BYTES = 8192;   // bytes of audio a tile aims at
constexpr int SMEM_MAX = 225 * 1024;   // dynamic shared memory, bytes

// exp(j*2pi*ph/2^32): the signed reinterpretation shifts the angle by
// -2pi at most, invisible to sin/cos; sincospif keeps full f32 accuracy.
__device__ __forceinline__ void rotor(uint32_t ph, float* s, float* c) {
  const float x = (float)(int32_t)ph * 4.656612873077392578125e-10f;
  sincospif(x, s, c);
}

// the padded index of a buffer element: one spare word in R, so threads
// R elements apart read distinct banks (i >= 0)
__host__ __device__ __forceinline__ int pad(int i) {
  return i + (int)((unsigned)i / R);
}

__host__ __device__ __forceinline__ int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

struct Geom {
  int e;       // column of the tile's sample 0 (= ap)
  int ap;      // taps zero-padded to whole chunks of R
  int t_tile;  // outputs a tile, a multiple of R
  int p;       // tap groups
  int xs;      // tile buffer length (floats, padded)
  int pt;      // partial-sum row length (float2, padded)
  int smem;    // dynamic shared memory, bytes
};

// The tile geometry for (taps, B); false if it does not fit.
// cuda/fir.py::fir_real_geometry is the same rule.
bool geometry(int taps, int B, Geom* g) {
  if (taps < 1 || B < 0) return false;
  g->ap = round_up(taps, R);
  g->e = g->ap;
  int t = TILE_BYTES / 4 > g->e ? TILE_BYTES / 4 : g->e;
  if (B < t) t = B > R ? round_up(B, R) : R;    // one tile: no halo copy
  g->t_tile = t;
  const int nob = t / R;
  const int share = NT / nob > 1 ? NT / nob : 1;
  g->p = share < g->ap / R ? share : g->ap / R;
  g->xs = pad(g->e + t - 1) + 1;
  g->pt = pad(t - 1) + 1;
  const long floats = (long)t + round_up(g->xs, 4) + 2L * g->ap + 2 * R +
                      (g->p > 1 ? 2L * g->p * g->pt : 0);
  if (floats * 4 > SMEM_MAX) return false;
  g->smem = (int)(floats * 4);
  return true;
}

// 16-byte asynchronous copies from device memory to shared memory
// (cp.async: no register holds the data, so the copy of the next tile
// runs under this tile's FIR work)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage tb samples from sample n0 of this channel's row into st:
// asynchronous 16-byte copies where the row is aligned (`vec`), element
// copies for the rest.
__device__ __forceinline__ void stage_tile(const float* __restrict__ xc,
                                           int n0, int tb, bool vec,
                                           float* st) {
  const int nv = vec ? tb / 4 : 0;
  for (int k = threadIdx.x; k < nv; k += NT)
    cp_async16(st + 4 * k, xc + n0 + 4 * k);
  for (int k = nv * 4 + threadIdx.x; k < tb; k += NT) st[k] = xc[n0 + k];
  cp_async_commit();
}

// One chunk of R taps k0 .. k0+R-1 for R outputs: hk = the taps from k0
// ((re, im), zero past taps), xr = the tile buffer at column
// R*(E/R + ob - k0/R).  Output r takes x[ob*R + r - k] from w[(r - i) %
// R] at tap k = k0 + i; step i brings x[ob*R - k0 - i - 1] into the slot
// the last output has used (at the chunk's last step only if `more`
// chunks follow).
__device__ __forceinline__ void chunk(float (&ar)[R], float (&ai)[R],
                                      float (&w)[R],
                                      const float2* __restrict__ hk,
                                      const float* xr, bool more) {
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const float4 h2 = *reinterpret_cast<const float4*>(hk + i);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = i + q;
      const float hr = q == 0 ? h2.x : h2.z;
      const float hi = q == 0 ? h2.y : h2.w;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = w[(r - j + R) % R];
        ar[r] = fmaf(hr, v, ar[r]);
        ai[r] = fmaf(hi, v, ai[r]);
      }
      if (j < R - 1 || more) w[(R - 1 - j) % R] = xr[-j - 2];
    }
  }
}

// The R outputs of one item, y_r = conj?(a_r) e^{j 2pi (ph + delta r) /
// 2^32) (no rotation without the NCO), to o[0 .. nv): float4 stores
// where o is 16-byte aligned and the item whole, else float2.
template <bool NCO>
__device__ __forceinline__ void put_item(float2* __restrict__ o, int nv,
                                         const float (&ar)[R],
                                         const float (&ai)[R], int conj,
                                         uint32_t ph,
                                         const float2* __restrict__ tab) {
  float s0 = 0.f, c0 = 1.f;
  if constexpr (NCO) rotor(ph, &s0, &c0);
  float2 y[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float re = ar[r], im = conj ? -ai[r] : ai[r];
    if constexpr (NCO) {
      const float2 t = tab[r];
      const float co = c0 * t.x - s0 * t.y;
      const float sn = s0 * t.x + c0 * t.y;
      y[r] = make_float2(re * co - im * sn, re * sn + im * co);
    } else {
      y[r] = make_float2(re, im);
    }
  }
  if (nv == R && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
#pragma unroll
    for (int r = 0; r < R; r += 2)
      *reinterpret_cast<float4*>(o + r) =
          make_float4(y[r].x, y[r].y, y[r + 1].x, y[r + 1].y);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nv) o[r] = y[r];
  }
}

// Buffers (shared memory): st: the next tile's audio, staged; xbuf: the
// tile, sample n (n < 0: the halo) at column E + n; ht: AP taps (re, im),
// zero past taps; tab: rotors; part: the P partial sums (P > 1).  Every
// xbuf and part index goes through pad().  E is a multiple of R, so inside
// an R-step chunk every load sits at a compile-time offset from one base.
// NCO = false never reads phase.
template <bool NCO>
__global__ void __launch_bounds__(NT, 4) fir_real_kernel(
    const float* __restrict__ x, int B, const float* __restrict__ carry_in,
    const float2* __restrict__ h, int taps, int conj,
    const int64_t* __restrict__ phase, uint32_t delta, Geom geo,
    float2* __restrict__ out, float* __restrict__ carry_out) {
  extern __shared__ float4 smem4[];
  const int E = geo.e, AP = geo.ap, T_TILE = geo.t_tile, PT = geo.pt;
  float* sp = reinterpret_cast<float*>(smem4);
  float* st = sp;
  sp += T_TILE;
  float* xbuf = sp;
  sp += round_up(geo.xs, 4);
  float2* ht = reinterpret_cast<float2*>(sp);
  sp += 2 * AP;
  float2* tab = reinterpret_cast<float2*>(sp);
  sp += 2 * R;
  float2* part = reinterpret_cast<float2*>(sp);

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_hist = taps - 1;
  const size_t row = (size_t)c * B;
  const uint32_t ph0 = NCO ? (uint32_t)phase[c] : 0u;
  // 16-byte loads where this channel's row is aligned
  const bool vec = (reinterpret_cast<uintptr_t>(x + row) & 15) == 0;
  if (B > 0) stage_tile(x + row, 0, min(T_TILE, B), vec, st);

  for (int k = tid; k < AP; k += NT)
    ht[k] = k < taps ? h[k] : make_float2(0.f, 0.f);
  if (NCO && tid < R) {
    float s, co;
    rotor(delta * (uint32_t)tid, &s, &co);
    tab[tid] = make_float2(co, s);
  }
  // the halo columns 0..E-1: the history where a column holds a sample n
  // in [-(taps-1), 0), zero before it
  const float* hist = carry_in + (size_t)c * n_hist;
  for (int col = tid; col < E; col += NT) {
    const int n = col - E;
    xbuf[pad(col)] = n >= -n_hist ? hist[n + n_hist] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  const int nob = T_TILE / R, chunks = AP / R;
  for (int t0 = 0; t0 < B; t0 += T_TILE) {
    const int tv = min(T_TILE, B - t0);
    for (int j = tid; j < tv; j += NT) xbuf[pad(E + j)] = st[j];
    __syncthreads();
    // the next tile's audio, copied while this one is filtered
    if (t0 + T_TILE < B)
      stage_tile(x + row, t0 + T_TILE, min(T_TILE, B - t0 - T_TILE), vec,
                 st);

    // item (ob, pg): outputs m = ob*R + r over the chunks of group pg
    for (int it = tid; it < nob * geo.p; it += NT) {
      const int ob = it % nob, pg = it / nob;
      if (ob * R >= tv) continue;
      const int k_lo = R * (pg * chunks / geo.p);
      const int k_hi = R * ((pg + 1) * chunks / geo.p);
      float ar[R], ai[R];
#pragma unroll
      for (int r = 0; r < R; ++r) ar[r] = ai[r] = 0.f;
      // x[ob*R - k_lo + s] at column R*(E/R + ob - k_lo/R) + s
      const float* xr = xbuf + (R + 1) * (E / R + ob - k_lo / R);
      float w[R];
#pragma unroll
      for (int s = 0; s < R; ++s) w[s] = xr[s];
      // two chunks an iteration: the next chunk's loads are issued
      // under this one's FMAs (2.6% faster at the TX flagship)
#pragma unroll 2
      for (int k0 = k_lo; k0 < k_hi; k0 += R, xr -= R + 1)
        chunk(ar, ai, w, ht + k0, xr, k0 + R < k_hi);
      if (geo.p == 1) {
        const int m0 = t0 + ob * R;
        put_item<NCO>(out + row + m0, min(R, tv - ob * R), ar, ai, conj,
                      ph0 + delta * (uint32_t)m0, tab);
      } else {
        float2* pp = part + pg * PT + (R + 1) * ob;
#pragma unroll
        for (int r = 0; r < R; ++r) pp[r] = make_float2(ar[r], ai[r]);
      }
    }
    if (geo.p > 1) {
      // the P partial sums, in group order, are the outputs
      __syncthreads();
      for (int ob = tid; ob * R < tv; ob += NT) {
        const float2* pp = part + (R + 1) * ob;
        float ar[R], ai[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float2 z = pp[r];
          for (int pg = 1; pg < geo.p; ++pg) {
            const float2 v = pp[pg * PT + r];
            z.x += v.x;
            z.y += v.y;
          }
          ar[r] = z.x;
          ai[r] = z.y;
        }
        const int m0 = t0 + ob * R;
        put_item<NCO>(out + row + m0, min(R, tv - ob * R), ar, ai, conj,
                      ph0 + delta * (uint32_t)m0, tab);
      }
    }
    if (t0 + T_TILE < B) {
      // the next tile's halo: columns T_TILE .. T_TILE+E-1 to 0..E-1
      // (T_TILE >= E: the copy does not overlap its source)
      __syncthreads();
      for (int col = tid; col < E; col += NT)
        xbuf[pad(col)] = xbuf[pad(T_TILE + col)];
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // new history: the last n_hist samples of (history ++ block)
  for (int j = tid; j < n_hist; j += NT) {
    const int n = B - n_hist + j;
    carry_out[(size_t)c * n_hist + j] =
        n >= 0 ? x[row + n] : carry_in[(size_t)c * n_hist + (j + B)];
  }
}

template <bool NCO>
int launch(const void* x, int C, int B, const void* carry_in, const void* h,
           int taps, int conj, const void* phase, uint32_t delta, void* out,
           void* carry_out, cudaStream_t stream) {
  Geom geo;
  if (!geometry(taps, B, &geo)) return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaSuccess;
  auto kern = fir_real_kernel<NCO>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kern,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  kern<<<C, NT, geo.smem, stream>>>(
      (const float*)x, B, (const float*)carry_in, (const float2*)h, taps,
      conj, (const int64_t*)phase, delta, geo, (float2*)out,
      (float*)carry_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The geometry constants (cuda/fir.py checks its copy against them).
int uhsdr_fir_real_threads() { return NT; }
int uhsdr_fir_real_outputs_per_thread() { return R; }
int uhsdr_fir_real_tile_bytes() { return TILE_BYTES; }
int uhsdr_fir_real_smem_max() { return SMEM_MAX; }
// The dynamic shared memory for (taps, B), or -1 where it does not fit.
int uhsdr_fir_real_smem(int taps, int B) {
  Geom g;
  return geometry(taps, B, &g) ? g.smem : -1;
}

// x: (C, B) f32; carry_in, carry_out: (C, taps-1) f32; h: (taps,)
// complex64; out: (C, B) complex64.  use_nco: 0 leaves the output
// unrotated (phase is not read).  Returns a cudaError_t.
int uhsdr_fir_real_launch(const void* x, int C, int B, const void* carry_in,
                          const void* h, int taps, int conj, int use_nco,
                          const void* phase, unsigned int delta, void* out,
                          void* carry_out, void* stream) {
  if (use_nco)
    return launch<true>(x, C, B, carry_in, h, taps, conj, phase, delta, out,
                        carry_out, (cudaStream_t)stream);
  return launch<false>(x, C, B, carry_in, h, taps, conj, phase, delta, out,
                       carry_out, (cudaStream_t)stream);
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
