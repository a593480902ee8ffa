// K11, the biquad cascade, hand-written for Hopper (sm_90a).
//
// K11 replaces the TPU kernel uhsdr_tpu/pallas/iir.py::_make_kernel
// (biquad_cascade_pallas, demod/sam.py:213-216 for SAM's 7-stage z^-2
// allpass chains, and the dispatch fallback ops/iir.py:244-251).  Per
// row, S sections in order per sample, direct form II transposed:
//   y = b0*x + s1;  s1 = b1*x - a1*y + s2;  s2 = b2*x - a2*y;  x = y.
// The TPU kernel runs a dilated scan per 128-sample tile because a TPU
// has no cheap per-lane sequential walk; on the card the same function is
// the recurrence itself, which also sums in the order a float64
// reference does.
//
// Bound on this card: bytes (x in, y out: 512 MiB per call at 16384
// stacked rows x 4096), as long as enough rows are in flight to hide the
// latency of the S dependent sections a sample.  Design: the tile ring of
// ring.cuh (as kernels/alc.cu and kernels/pll.cu), a block owning NWALK *
// lw rows (lw lanes of each walker warp; the rule is
// cuda/iir.py::biquad_geometry: at most a block an SM, its four walkers
// on its four schedulers):
//   - the front warp copies tiles k+1 .. k+3 into the ring;
//   - four walker warps (lane = row, the 2S states and 5S coefficients in
//     registers, S a template parameter) walk a tile four samples a
//     float4 out of shared memory and write y over x;
//   - four output warps (lanes along time, each a walker's rows) store y
//     coalesced and free the stage.
// Compiled with -fmad=false: the products and sums stay the separate f32
// operations of the plain torch version (`ops.iir.biquad_cascade_block`),
// so the two agree bit for bit.
//
// K14, the same cascade by a two-level scan, is the second kernel of this
// source (`biquad_grouped_kernel` below).  SAM's sideband stage walks its
// allpass chains on the same ring in kernels/sam.cu.
#include "ring.cuh"

namespace {

constexpr int MAXLW = 32;           // row lanes of a K11 walker warp
constexpr int MAXS = 8;             // most sections in one cascade

// A block's dynamic shared memory: a stage is one plane of cb rows (y
// over x).
__host__ __device__ inline int bq_smem_bytes(int lw) {
  return STAGES * NWALK * lw * SS * (int)sizeof(float);
}

// ---------------------------------------------------------------------------
// K11
// ---------------------------------------------------------------------------

template <int S>
struct Cascade {
  float b0[S], b1[S], b2[S], a1[S], a2[S], s1[S], s2[S];

  __device__ __forceinline__ float step(float v) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const float out = b0[k] * v + s1[k];
      s1[k] = b1[k] * v - a1[k] * out + s2[k];
      s2[k] = b2[k] * v - a2[k] * out;
      v = out;
    }
    return v;
  }
};

// Walker warp wk: lane l < lw walks row wk * lw + l (the lanes past lw
// repeat the last row's walk and store nothing): y over x in its stage
// row, four samples a float4 in a whole tile, one at a time in a short
// (last) one.
template <int S>
__device__ void bq_walker(const float* __restrict__ state,
                          const float* __restrict__ sos,
                          float* __restrict__ state_out, const Geo& g,
                          int c0, int nc, int cb, int ntiles, float* stage,
                          int wk, int lane) {
  const int r = wk * g.lw + min(lane, g.lw - 1);
  const bool own = lane < g.lw && r < nc;
  const size_t c = (size_t)c0 + min(r, nc - 1);
  Cascade<S> f;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    f.b0[k] = sos[5 * k + 0];
    f.b1[k] = sos[5 * k + 1];
    f.b2[k] = sos[5 * k + 2];
    f.a1[k] = sos[5 * k + 3];
    f.a2[k] = sos[5 * k + 4];
    // state is (S, C, 2)
    const float2 s = reinterpret_cast<const float2*>(state)[k * g.C + c];
    f.s1[k] = s.x;
    f.s2[k] = s.y;
  }
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    const int cnt = min(TA, g.T - j * TA);
    float* row = stage + ((size_t)s * cb + r) * SS;
    bar_sync(BAR_FULL + s, 32 + WALK_T);
    if (cnt == TA) {
      float4* r4 = reinterpret_cast<float4*>(row);
#pragma unroll 2
      for (int q = 0; q < TA / 4; ++q) {
        const float4 x = r4[q];
        float4 y;             // four steps, in order
        y.x = f.step(x.x);
        y.y = f.step(x.y);
        y.z = f.step(x.z);
        y.w = f.step(x.w);
        if (own) r4[q] = y;
      }
    } else {
      for (int i = 0; i < cnt; ++i) {
        const float y = f.step(row[i]);
        if (own) row[i] = y;
      }
    }
    __syncwarp();
    bar_arrive(BAR_DONE + s, WALK_T + OUT_T);
  }
  if (own) {
#pragma unroll
    for (int k = 0; k < S; ++k)
      reinterpret_cast<float2*>(state_out)[k * g.C + c] =
          make_float2(f.s1[k], f.s2[k]);
  }
}

// Warps 0 .. NWALK-1 walk (one per scheduler), warp NWALK is the front,
// the rest form the output.
template <int S>
__global__ void __launch_bounds__(THREADS, 2) biquad_kernel(
    const float* __restrict__ x, const float* __restrict__ state,
    const float* __restrict__ sos, Geo g, float* __restrict__ y,
    float* __restrict__ state_out) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);   // [STAGES][cb][SS]
  const int cb = NWALK * g.lw;
  const int c0 = blockIdx.x * cb;
  const int nc = min(cb, g.C - c0);
  const int ntiles = (g.T + TA - 1) / TA;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < NWALK) {
    bq_walker<S>(state, sos, state_out, g, c0, nc, cb, ntiles, stage, warp,
                 lane);
  } else if (warp == NWALK) {
    front(ntiles, [&](int m) {
      const int t0 = m * TA;
      copy_rows(stage + (size_t)(m % STAGES) * cb * SS, SS, nc,
                min(TA, g.T - t0), TA, g.vec,
                [&](int r) { return x + (size_t)(c0 + r) * g.T + t0; },
                lane);
    });
  } else {
    const int ow = warp - NWALK - 1;
    const int r0 = ow * g.lw;
    output(y, g.T, c0, r0, max(0, min(g.lw, nc - r0)), ntiles, stage,
           cb * SS, 0, lane);
  }
}

template <int S>
int launch(const void* x, const void* state, const void* sos, const Geo& g,
           void* y, void* state_out, cudaStream_t stream) {
  const int smem = bq_smem_bytes(g.lw);
  cudaError_t e = cudaFuncSetAttribute(
      biquad_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int cb = NWALK * g.lw;
  biquad_kernel<S><<<(g.C + cb - 1) / cb, THREADS, smem, stream>>>(
      (const float*)x, (const float*)state, (const float*)sos, g, (float*)y,
      (float*)state_out);
  return (int)cudaGetLastError();
}

// K14: replaces uhsdr_tpu/pallas/iir.py::_make_kernel_grouped
// (biquad_cascade_pallas(impl="grouped")).  The same cascade as K11 by a
// two-level scan of the DF2T state u[t] = A u[t-1] + (g1, g2) x[t], A =
// [[-a1, 1], [-a2, 0]], g1 = b1 - a1 b0, g2 = b2 - a2 b0, per section in
// order:
//   1. local scans from zero state inside groups of L samples (the
//      carried state folded into sample 0), one thread per group;
//   2. a Hillis-Steele scan over the G group-end states with the
//      transitions (A^L)^(2^k);
//   3. the correction u[g, l] = v[g, l] + A^(l+1) q[g], q[g] the end
//      state of group g-1, then y = b0 x + s1[t-1].
// The TPU kernel scans 128-sample tiles with the carry in VMEM; here one
// thread block owns one channel's whole block, which stays in shared
// memory across the sections and the three phases (T = 4096: 16.5 KB),
// so 4096 samples are 128 groups: 128 threads a channel where K11 walks
// one.  A^1..A^L and (A^L)^(2^k) come from float64 on the host, rounded
// once, as the TPU kernel builds them.  A ragged last group is padded
// with zeros and the end state read at T-1.  Bound on this card: bytes
// (x in, y out), as K11.  -fmad=false keeps the plain version's separate
// products and sums.
constexpr int GMAX = 512;       // most groups = threads per block
constexpr int GLEVELS = 9;      // log2(GMAX) levels of (A^L)^(2^k)
constexpr int GHEAD = 5;        // b0, g1, g2, -a1, -a2

template <int L>
__global__ void __launch_bounds__(GMAX) biquad_grouped_kernel(
    const float* __restrict__ x, const float* __restrict__ state,
    const float* __restrict__ tab, int S, int C, int T,
    float* __restrict__ y, float* __restrict__ state_out) {
  constexpr int LS = L + 1;     // odd group stride: conflict-free walks
  constexpr int REC = GHEAD + 4 * L + 4 * GLEVELS;
  extern __shared__ float sm[];
  const int G = (T + L - 1) / L;
  float* tile = sm;                     // G * LS
  float* e1 = tile + G * LS;            // G
  float* e2 = e1 + G;                   // G
  float* tb = e2 + G;                   // S * REC
  float* st = tb + S * REC;             // 2 S: the carried states
  const int c = blockIdx.x;
  const int g = threadIdx.x;
  const bool live = g < G;
  const int base = g * L;
  const int lend = min(L, T - base) - 1;   // last valid sample of group
  const size_t row = (size_t)c * T;

  for (int i = g; i < S * REC; i += blockDim.x) tb[i] = tab[i];
  for (int i = g; i < 2 * S; i += blockDim.x)
    st[i] = state[((i >> 1) * C + c) * 2 + (i & 1)];
  for (int i = g; i < G * L; i += blockDim.x)
    tile[(i / L) * LS + i % L] = i < T ? x[row + i] : 0.f;
  __syncthreads();

  for (int k = 0; k < S; ++k) {
    const float* rec = tb + k * REC;
    const float b0 = rec[0], g1 = rec[1], g2 = rec[2];
    const float a11 = rec[3], a21 = rec[4];
    const float* P = rec + GHEAD;           // A^(l+1), row-major 2 x 2
    const float* Q = P + 4 * L;             // (A^L)^(2^j)
    const float s10 = st[2 * k], s20 = st[2 * k + 1];
    float* xt = tile + g * LS;

    // phase 1: local scan of this group from zero state
    float v1[L];
    float v1p = 0.f, v2p = 0.f, v2end = 0.f;
    if (live) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        float c1 = g1 * xt[l];
        float c2 = g2 * xt[l];
        if (l == 0 && g == 0) {
          c1 = c1 + (a11 * s10 + s20);
          c2 = c2 + a21 * s10;
        }
        const float n1 = c1 + a11 * v1p + v2p;
        const float n2 = c2 + a21 * v1p;
        v1[l] = n1;
        v1p = n1;
        v2p = n2;
        if (l == lend) v2end = n2;   // the last group's end
      }
      e1[g] = v1p;
      e2[g] = v2p;
    }
    __syncthreads();

    // phase 2: scan over the group ends
    int j = 0;
    for (int d = 1; d < G; d *= 2, ++j) {
      float p1 = 0.f, p2 = 0.f;
      const bool take = live && g >= d;
      if (take) {
        p1 = e1[g - d];
        p2 = e2[g - d];
      }
      __syncthreads();
      if (take) {
        const float* q = Q + 4 * j;
        e1[g] = e1[g] + q[0] * p1 + q[1] * p2;
        e2[g] = e2[g] + q[2] * p1 + q[3] * p2;
      }
      __syncthreads();
    }

    // phase 3: correction, output, end state
    if (live) {
      const float q1 = g > 0 ? e1[g - 1] : 0.f;
      const float q2 = g > 0 ? e2[g - 1] : 0.f;
      float prev = g > 0 ? q1 : s10;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float u1 = v1[l] + P[4 * l] * q1 + P[4 * l + 1] * q2;
        const float xv = xt[l];
        xt[l] = b0 * xv + prev;
        prev = u1;
        if (g == G - 1 && l == lend) {
          st[2 * k] = u1;
          st[2 * k + 1] = v2end + P[4 * l + 2] * q1 + P[4 * l + 3] * q2;
        }
      }
    }
    // the next section rewrites e1/e2 and reads st
    __syncthreads();
  }

  for (int i = g; i < T; i += blockDim.x)
    y[row + i] = tile[(i / L) * LS + i % L];
  for (int i = g; i < 2 * S; i += blockDim.x)
    state_out[((i >> 1) * C + c) * 2 + (i & 1)] = st[i];
}

template <int L>
int launch_grouped(const void* x, const void* state, const void* tab, int S,
                   int C, int T, void* y, void* state_out,
                   cudaStream_t stream) {
  const int G = (T + L - 1) / L;
  if (G > GMAX) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(G * (L + 1) + 2 * G + S * (GHEAD + 4 * L + 4 * GLEVELS) +
               2 * S) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      biquad_grouped_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = (G + 31) / 32 * 32;
  biquad_grouped_kernel<L><<<C, threads, smem, stream>>>(
      (const float*)x, (const float*)state, (const float*)tab, S, C, T,
      (float*)y, (float*)state_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int uhsdr_biquad_max_sections() { return MAXS; }
int uhsdr_biquad_threads() { return THREADS; }
int uhsdr_biquad_walkers() { return NWALK; }
int uhsdr_biquad_tile() { return TA; }
int uhsdr_biquad_stages() { return STAGES; }

// K11's dynamic shared memory a block at lw row lanes a walker, or -1
// outside 1..32.
int uhsdr_biquad_smem(int lw) {
  return lw >= 1 && lw <= MAXLW ? bq_smem_bytes(lw) : -1;
}

// K11.  x, y: (C, T) f32; state, state_out: (S, C, 2) f32; sos: (S, 5) f32
// rows [b0 b1 b2 a1 a2] on the device.  lw: the row lanes of a walker
// (cuda/iir.py::biquad_geometry); vec: x and y 16-byte aligned and T % 4
// == 0.  Requires 1 <= S <= MAXS, T >= 1 and 1 <= lw <= 32.  Returns a
// cudaError_t.
int uhsdr_biquad_launch(const void* x, const void* state, const void* sos,
                        int S, int C, int T, int lw, int vec, void* y,
                        void* state_out, void* stream) {
  using Launch = int (*)(const void*, const void*, const void*, const Geo&,
                         void*, void*, cudaStream_t);
  static const Launch table[MAXS] = {launch<1>, launch<2>, launch<3>,
                                     launch<4>, launch<5>, launch<6>,
                                     launch<7>, launch<8>};
  if (S < 1 || S > MAXS || T < 1 || C < 1 || lw < 1 || lw > MAXLW)
    return (int)cudaErrorInvalidValue;
  const Geo g{C, T, lw, vec};
  return table[S - 1](x, state, sos, g, y, state_out, (cudaStream_t)stream);
}

int uhsdr_biquad_grouped_max_groups() { return GMAX; }
int uhsdr_biquad_grouped_levels() { return GLEVELS; }

// K14.  x, y: (C, T) f32; state, state_out: (S, C, 2) f32; tab: S records
// of [b0, g1, g2, -a1, -a2, A^1..A^L (2 x 2 each, row-major), (A^L)^(2^j)
// for j < 9] f32 on the device (`cuda/iir.py::grouped_table`).  L is 16,
// 32 or 64; ceil(T / L) <= 512.  Returns a cudaError_t.
int uhsdr_biquad_grouped_launch(const void* x, const void* state,
                                const void* tab, int S, int C, int T, int L,
                                void* y, void* state_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S < 1 || S > MAXS || T < 1) return (int)cudaErrorInvalidValue;
  switch (L) {
    case 16: return launch_grouped<16>(x, state, tab, S, C, T, y, state_out, st);
    case 32: return launch_grouped<32>(x, state, tab, S, C, T, y, state_out, st);
    case 64: return launch_grouped<64>(x, state, tab, S, C, T, y, state_out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
