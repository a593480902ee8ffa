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
// K14, the same cascade by a two-level scan (a warp a row, a lane a
// group, tiles of 32 groups), is the second kernel of this source
// (`biquad_grouped_kernel` below).  SAM's sideband stage walks its
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
// order, a tile of 32 groups of L samples at a time, the state carried
// from tile to tile (the TPU kernel's structure at t_tile = 32 L):
//   1. local scans from zero state inside each group (the carried state
//      folded into the tile's sample 0);
//   2. a Hillis-Steele scan over the 32 group-end states with the
//      transitions (A^L)^(2^j), j < 5;
//   3. the correction u[g, l] = v[g, l] + A^(l+1) q[g], q[g] the end
//      state of group g-1 (0 for g = 0), then y = b0 x + s1[t-1]; the
//      tile's end state, read at its last valid sample, is the carry.
// Design: one warp a row, one lane a group.  A lane holds its group's L
// samples and L local states in registers through all S sections of a
// tile (section k's y is section k+1's x), phase 2 is five shuffles with
// no barrier, and the warp walks its row's tiles in order, the carry
// passing through two buffers of its own in shared memory.  Each warp
// copies its tiles into a ring of GSTAGES slots by cp.async, the next
// tile in flight while it walks the current one, rows of L + 4 floats so
// that a lane's float4 reads of its group hit no bank twice in a
// quarter-warp phase; y goes back into the slot and out in coalesced
// 16-byte stores.  The table of a block's sections (b0, g1, g2, -a1, -a2,
// A^1..A^L, (A^L)^(2^j)), from float64 on the host and rounded once as
// the TPU kernel builds it, is read once a block.  A ragged last tile is
// padded with zeros.  Bound on this card: the issue of its instructions,
// not its bytes (x in, y out: 0.16 ms at 16384 x 4096): under
// -fmad=false (the plain version's separate products and sums, so the
// two agree bit for bit) a sample and section is 13 FP32 operations, a
// table read and its share of the scan, about 16 instructions (a warp
// instruction doing 32 lanes' samples): at L = 32, 0.23 ms at full issue
// on the H100's 528 schedulers.  At L = 32 it keeps 20 warps an SM (96
// registers a lane, no spills), and the load and the stores hide behind
// the walk (trace_biquad.py).
constexpr int GLEVELS = 5;      // (A^L)^(2^j), j < 5: 32 groups a tile
constexpr int GHEAD = 8;        // b0, g1, g2, -a1, -a2 and 3 pad floats
constexpr int GW = 4;           // most warps (rows) a block
constexpr int GSTAGES = 2;      // tiles in a warp's ring
constexpr unsigned FULL = 0xffffffffu;

// floats of one section's record: the head, A^(l+1) and the levels, each
// 2 x 2 row-major; a multiple of 4, so every record is 16-byte aligned
__host__ __device__ constexpr int grec(int L) {
  return GHEAD + 4 * L + 4 * GLEVELS;
}

// floats a warp owns past the table: its ring and two carry buffers
__host__ __device__ constexpr int gwarp_floats(int L) {
  return GSTAGES * 32 * (L + 4) + 4 * MAXS;
}

// blocks an SM holds (__launch_bounds__' minimum): by registers (2 L
// floats a lane for x and the local states) and shared memory
template <int L> struct GMinBlocks;
template <> struct GMinBlocks<16> { static constexpr int value = 8; };
template <> struct GMinBlocks<32> { static constexpr int value = 5; };
template <> struct GMinBlocks<64> { static constexpr int value = 2; };

__host__ __device__ inline int grouped_smem_bytes(int L, int S, int warps) {
  return (S * grec(L) + warps * gwarp_floats(L)) * (int)sizeof(float);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Copy tile samples [0, n) of a row from src into a slot of 32 rows of
// L + 4 floats (group g's samples on row g), zeros past n; 16-byte copies
// where vec (then n % 4 == 0).
template <int L>
__device__ __forceinline__ void grouped_load(float* slot, const float* src,
                                             int n, bool vec, int lane) {
  constexpr int TL = 32 * L, LS = L + 4;
  if (vec) {
#pragma unroll 4
    for (int q = lane; q < TL / 4; q += 32) {
      const int i = 4 * q;
      float* dst = slot + (i / L) * LS + i % L;
      if (i < n)
        cp_async16(dst, src + i);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = lane; i < TL; i += 32) {
      float* dst = slot + (i / L) * LS + i % L;
      if (i < n)
        cp_async4(dst, src + i);
      else
        *dst = 0.f;
    }
  }
}

// Store samples [0, n) of a slot to the row at dst, coalesced.
template <int L>
__device__ __forceinline__ void grouped_store(const float* slot, float* dst,
                                              int n, bool vec, int lane) {
  constexpr int LS = L + 4;
  if (vec) {
    for (int q = lane; q < n / 4; q += 32) {
      const int i = 4 * q;
      *reinterpret_cast<float4*>(dst + i) =
          *reinterpret_cast<const float4*>(slot + (i / L) * LS + i % L);
    }
  } else {
    for (int i = lane; i < n; i += 32) dst[i] = slot[(i / L) * LS + i % L];
  }
}

// One section on one tile, lane = group: x (the lane's L samples) becomes
// y; cin holds the carried (s1, s2), and the lane holding the tile's last
// valid sample (group g_last, sample lend; lane 31 and L - 1 unless
// RAGGED) writes the tile's end state to cout.
template <int L, bool RAGGED>
__device__ __forceinline__ void grouped_section(float (&x)[L],
                                                const float* rec,
                                                const float* cin, float* cout,
                                                int lane, int g_last,
                                                int lend) {
  const float b0 = rec[0], g1 = rec[1], g2 = rec[2];
  const float a11 = rec[3], a21 = rec[4];
  const float s10 = cin[0], s20 = cin[1];

  // phase 1: the group's local scan from zero state
  float v1[L];
  float v1p = 0.f, v2p = 0.f, v2end = 0.f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float c1 = g1 * x[l];
    float c2 = g2 * x[l];
    if (l == 0 && lane == 0) {
      c1 = c1 + (a11 * s10 + s20);
      c2 = c2 + a21 * s10;
    }
    const float n1 = c1 + a11 * v1p + v2p;
    const float n2 = c2 + a21 * v1p;
    v1[l] = n1;
    v1p = n1;
    v2p = n2;
    if (RAGGED && l == lend) v2end = n2;
  }
  if (!RAGGED) v2end = v2p;

  // phase 2: scan over the 32 group ends; lanes below d keep their value
  const float4* Q = reinterpret_cast<const float4*>(rec + GHEAD + 4 * L);
  float e1 = v1p, e2 = v2p;
#pragma unroll
  for (int j = 0; j < GLEVELS; ++j) {
    const int d = 1 << j;
    const float p1 = __shfl_up_sync(FULL, e1, d);
    const float p2 = __shfl_up_sync(FULL, e2, d);
    const float4 q = Q[j];
    const float n1 = e1 + q.x * p1 + q.y * p2;
    const float n2 = e2 + q.z * p1 + q.w * p2;
    if (lane >= d) {
      e1 = n1;
      e2 = n2;
    }
  }

  // phase 3: correction and output; q = 0 for group 0, as the plain
  // version multiplies it
  float q1 = __shfl_up_sync(FULL, e1, 1);
  float q2 = __shfl_up_sync(FULL, e2, 1);
  if (lane == 0) {
    q1 = 0.f;
    q2 = 0.f;
  }
  float prev = lane == 0 ? s10 : q1;
  float s1e = 0.f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float2 p = *reinterpret_cast<const float2*>(rec + GHEAD + 4 * l);
    const float u1 = v1[l] + p.x * q1 + p.y * q2;
    x[l] = b0 * x[l] + prev;
    prev = u1;
    if (RAGGED && l == lend) s1e = u1;
  }
  if (!RAGGED) s1e = prev;
  if (lane == (RAGGED ? g_last : 31)) {
    const float2 p = *reinterpret_cast<const float2*>(
        rec + GHEAD + 4 * (RAGGED ? lend : L - 1) + 2);
    cout[0] = s1e;
    cout[1] = v2end + p.x * q1 + p.y * q2;
  }
}

// A block of `warps` warps, warp w on row blockIdx.x * warps + w.
template <int L>
__global__ void __launch_bounds__(GW * 32, GMinBlocks<L>::value)
    biquad_grouped_kernel(const float* __restrict__ x,
                          const float* __restrict__ state,
                          const float* __restrict__ tab, int S, int C, int T,
                          int vec, float* __restrict__ y,
                          float* __restrict__ state_out) {
  constexpr int TL = 32 * L, LS = L + 4, SLOT = 32 * LS, REC = grec(L);
  extern __shared__ float4 smem4[];
  float* tb = reinterpret_cast<float*>(smem4);        // S records
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < S * REC / 4; i += blockDim.x)
    smem4[i] = reinterpret_cast<const float4*>(tab)[i];
  __syncthreads();
  const int r = blockIdx.x * warps + warp;
  if (r >= C) return;
  float* ring = tb + S * REC + warp * gwarp_floats(L);   // GSTAGES slots
  float* carry = ring + GSTAGES * SLOT;                  // [2][2 MAXS]
  // state is (S, C, 2)
  if (lane < 2 * S)
    carry[lane] = state[((size_t)(lane >> 1) * C + r) * 2 + (lane & 1)];
  const float* xr = x + (size_t)r * T;
  float* yr = y + (size_t)r * T;
  const int ntiles = (T + TL - 1) / TL;
#pragma unroll
  for (int m = 0; m < GSTAGES - 1; ++m) {
    if (m < ntiles)
      grouped_load<L>(ring + m * SLOT, xr + (size_t)m * TL,
                      min(TL, T - m * TL), vec, lane);
    cp_commit();
  }
  for (int j = 0; j < ntiles; ++j) {
    const int m = j + GSTAGES - 1;
    if (m < ntiles)
      grouped_load<L>(ring + (m % GSTAGES) * SLOT, xr + (size_t)m * TL,
                      min(TL, T - m * TL), vec, lane);
    cp_commit();
    asm volatile("cp.async.wait_group %0;" ::"n"(GSTAGES - 1) : "memory");
    __syncwarp();
    float* slot = ring + (j % GSTAGES) * SLOT;
    float4* row = reinterpret_cast<float4*>(slot + lane * LS);
    float xv[L];
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      const float4 v = row[q];
      xv[4 * q] = v.x;
      xv[4 * q + 1] = v.y;
      xv[4 * q + 2] = v.z;
      xv[4 * q + 3] = v.w;
    }
    const float* cin = carry + (j & 1) * 2 * MAXS;
    float* cout = carry + ((j + 1) & 1) * 2 * MAXS;
    const int n = min(TL, T - j * TL);
    if (n == TL) {
      for (int k = 0; k < S; ++k)
        grouped_section<L, false>(xv, tb + k * REC, cin + 2 * k,
                                  cout + 2 * k, lane, 31, L - 1);
    } else {
      for (int k = 0; k < S; ++k)
        grouped_section<L, true>(xv, tb + k * REC, cin + 2 * k,
                                 cout + 2 * k, lane, (n - 1) / L,
                                 (n - 1) % L);
    }
#pragma unroll
    for (int q = 0; q < L / 4; ++q)
      row[q] = make_float4(xv[4 * q], xv[4 * q + 1], xv[4 * q + 2],
                           xv[4 * q + 3]);
    __syncwarp();
    grouped_store<L>(slot, yr + (size_t)j * TL, n, vec, lane);
    __syncwarp();      // the slot is the next tile's copy target
  }
  const float* fin = carry + (ntiles & 1) * 2 * MAXS;
  if (lane < 2 * S)
    state_out[((size_t)(lane >> 1) * C + r) * 2 + (lane & 1)] = fin[lane];
}

template <int L>
int launch_grouped(const void* x, const void* state, const void* tab, int S,
                   int C, int T, int warps, int vec, void* y,
                   void* state_out, cudaStream_t stream) {
  const int smem = grouped_smem_bytes(L, S, warps);
  cudaError_t e = cudaFuncSetAttribute(
      biquad_grouped_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(biquad_grouped_kernel<L>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  biquad_grouped_kernel<L><<<(C + warps - 1) / warps, 32 * warps, smem,
                             stream>>>(
      (const float*)x, (const float*)state, (const float*)tab, S, C, T, vec,
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

int uhsdr_biquad_grouped_levels() { return GLEVELS; }
int uhsdr_biquad_grouped_head() { return GHEAD; }
int uhsdr_biquad_grouped_warps() { return GW; }
int uhsdr_biquad_grouped_stages() { return GSTAGES; }

// K14's blocks an SM (its __launch_bounds__ minimum) at group length L,
// or -1 for a length it is not built for.
int uhsdr_biquad_grouped_blocks_per_sm(int L) {
  switch (L) {
    case 16: return GMinBlocks<16>::value;
    case 32: return GMinBlocks<32>::value;
    case 64: return GMinBlocks<64>::value;
    default: return -1;
  }
}

// K14's dynamic shared memory a block (the section table and each warp's
// ring and carries), or -1 outside L in {16, 32, 64}, 1 <= S <= MAXS,
// 1 <= warps <= GW.
int uhsdr_biquad_grouped_smem(int L, int S, int warps) {
  if (uhsdr_biquad_grouped_blocks_per_sm(L) < 0 || S < 1 || S > MAXS ||
      warps < 1 || warps > GW)
    return -1;
  return grouped_smem_bytes(L, S, warps);
}

// K14.  x, y: (C, T) f32; state, state_out: (S, C, 2) f32; tab: S records
// of grec(L) floats, [b0, g1, g2, -a1, -a2, 0, 0, 0, A^1..A^L (2 x 2
// each, row-major), (A^L)^(2^j) for j < 5] f32 on the device, 16-byte
// aligned (`cuda/iir.py::grouped_table`).  L is 16, 32 or 64; warps: rows
// a block, 1..4 (`cuda/iir.py::grouped_geometry`); vec: x and y 16-byte
// aligned and T % 4 == 0.  Any T >= 1.  Returns a cudaError_t.
int uhsdr_biquad_grouped_launch(const void* x, const void* state,
                                const void* tab, int S, int C, int T, int L,
                                int warps, int vec, void* y, void* state_out,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S < 1 || S > MAXS || T < 1 || C < 1 || warps < 1 || warps > GW)
    return (int)cudaErrorInvalidValue;
  switch (L) {
    case 16:
      return launch_grouped<16>(x, state, tab, S, C, T, warps, vec, y,
                                state_out, st);
    case 32:
      return launch_grouped<32>(x, state, tab, S, C, T, warps, vec, y,
                                state_out, st);
    case 64:
      return launch_grouped<64>(x, state, tab, S, C, T, warps, vec, y,
                                state_out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
