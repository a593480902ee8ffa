// IIR lattice ARMA filter, the CMSIS arm_iir_lattice_f32 recurrence,
// hand-written for Hopper (sm_90a).  A helper kernel with no TPU
// counterpart: the JAX package runs the lattice as a lax.scan over time
// with the stages unrolled (uhsdr_tpu/ops/lattice.py:33-72) and has no
// Pallas kernel for it.  Three places run it: the reference chain's
// PreFilter and anti-alias lattices (chain/refchain.py) and the FM TX
// voice bandpass IIR_TX_2k7_FM (chain/tx.py).  Per row and sample, with
// pk stored stage-reversed (k_N first) and N <= 12:
//   f = x; acc = (x * pv[N]) * 0          (NaN or inf in x gives NaN)
//   for m in 0..N-1:
//     f = f - pk[m] * g[m]; gn[m] = f * pk[m] + g[m];
//     acc = acc + gn[m] * pv[m]
//   y = acc + f * pv[N]
//   g = [gn[1], ..., gn[N-1], f]          (the one-slot shift)
//
// Bound on this card: bytes at the chains' shapes (x in, y out: 0.080 ms
// at 8192 x 4096, 0.321 ms at 8192 x 16384, at 3.35 TB/s), but a row's
// samples are a chain and every sample is 6N + 4 FP32 instructions (64
// at N = 10, acc's start included; -fmad=false keeps each product and sum
// apart).  The loop-carried chain is short: f of stage m at sample n
// feeds gn[m] (a multiply and an add), the next sample's pk[m-1] *
// g[m-1] (a multiply) and its f of stage m-1 (an add), and that f feeds
// stage m's (an add): 5 dependent operations a sample
// (cuda/lattice.py::LATTICE_STEP_CHAIN).  So a walker is bound by its
// issue, not by its latency, once its instructions are independent
// enough to issue back to back.
//
// Design: a lane a row on the tile ring of ring.cuh (as K11 and the ALC),
// a block owning NWALK * lw rows (the rule is cuda/lattice.py::
// lattice_geometry: at most a block an SM, its four walkers on its four
// schedulers, 16 lanes a walker at 8192 rows):
//   - the front warp copies tiles k+1 .. k+3 of x into the ring by 16-byte
//     cp.async;
//   - four walker warps (lane = row, the N-slot state in registers, pk and
//     pv in the launch's parameters) walk a tile in straight-line blocks
//     of WU = 8 samples, each written as a wavefront: stage m of sample u
//     at slot m + 2u, beside the later stages of the samples before it,
//     so that in-order issue finds independent instructions; x and y
//     move a float4 at a time, y over x;
//   - four output warps store y coalesced and free the stage.
// A block of 8 samples is 512 FP32 instructions, 8 KB of code.  A whole
// tile as one block (32 KB) ran at twice the cycles a sample (the
// instruction cache, trace_lattice_fm.py's wu32), and blocks of 4 or 16
// no faster than 8; a walk that carries a block's last samples into the
// next block's slots (no fill and drain at a block's edges) no faster
// either.  What is left is the walker's issue: at 16 of 32 lanes (8192
// rows on 528 schedulers) 64 FP32 instructions and the loads and stores
// a sample, at ~95 cycles a sample against ~70 instructions.
// Chosen over a lane a stage (a row's N stages on N lanes as a systolic
// wavefront, f and acc passed down by shuffle and gn up): that design
// fills the lanes a lane a row leaves empty (30 of 32 at N = 10, against
// 16 of 32 here) and would issue ~10 instructions a (row, stage, sample)
// against ~6.4 here (0.43 ms against 0.51 ms of issue at 8192 x 16384),
// but every tick of a row waits on a shuffle and four dependent
// operations, with 2.6 warps a scheduler to cover them, and at N = 11 and
// 12 it fills only 22 and 24 lanes.
// Compiled with -fmad=false so that every product and sum rounds as the
// plain version's (cuda/lattice.py::lattice_plain): bit for bit.
#include "ring.cuh"

namespace {

constexpr int MAX_N = 12;
constexpr int LAT_MAXLW = 32;       // row lanes of a walker warp
constexpr int WU = 8;               // samples a straight-line block walks
static_assert(TA % WU == 0 && WU % 4 == 0, "walk unit");

struct Coefs {
  float pk[MAX_N];
  float pv[MAX_N + 1];
};

struct LatGeo {
  int C, T, lw, vec;                // vec: x and y 16-byte aligned rows
};

// A block's dynamic shared memory: a stage is one plane of cb rows (y
// over x).
__host__ __device__ inline int lat_smem_bytes(int lw) {
  return STAGES * NWALK * lw * SS * (int)sizeof(float);
}

// U samples of a row through the N stages, in wavefront order: stage m of
// sample u at slot m + 2u, the samples of one slot in ascending u.
// slot[m] holds g[m] of the next sample to reach stage m: sample u reads
// it at stage m, and sample u - 1 wrote it at stage m + 1 (gn[m + 1]; f
// itself at the last stage), one slot before, so the operations of one
// slot are independent of each other.
template <int N, int U>
__device__ __forceinline__ void lattice_walk(float (&slot)[N],
                                             const float (&x)[U],
                                             float (&y)[U], const Coefs& co) {
  float f[U], acc[U];
#pragma unroll
  for (int d = 0; d < N + 2 * (U - 1); ++d) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int m = d - 2 * u;
      if (m < 0 || m >= N) continue;
      if (m == 0) {
        f[u] = x[u];
        acc[u] = x[u] * co.pv[N] * 0.0f;
      }
      const float g = slot[m];
      f[u] = f[u] - co.pk[m] * g;
      const float gn = f[u] * co.pk[m] + g;
      acc[u] = acc[u] + gn * co.pv[m];
      if (m > 0) slot[m - 1] = gn;
      if (m == N - 1) {
        slot[N - 1] = f[u];
        y[u] = acc[u] + f[u] * co.pv[N];
      }
    }
  }
}

// Walker warp wk: lane l < lw walks row wk * lw + l (the lanes past lw
// repeat the last row's walk and store nothing): y over x in its stage
// row, WU samples a straight-line block (x and y a float4 at a time),
// one sample at a time in a short (last) tile.
template <int N>
__device__ void lat_walker(const float* __restrict__ s_in,
                           float* __restrict__ s_out, const Coefs& co,
                           const LatGeo& g, int c0, int nc, int cb,
                           int ntiles, float* stage, int wk, int lane) {
  const int r = wk * g.lw + min(lane, g.lw - 1);
  const bool own = lane < g.lw && r < nc;
  const size_t c = (size_t)c0 + min(r, nc - 1);
  float slot[N];
#pragma unroll
  for (int m = 0; m < N; ++m) slot[m] = s_in[c * N + m];
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    const int cnt = min(TA, g.T - j * TA);
    float* row = stage + ((size_t)s * cb + r) * SS;
    bar_sync(BAR_FULL + s, 32 + WALK_T);
    if (cnt == TA) {
#pragma unroll 1
      for (int h = 0; h < TA; h += WU) {
        float4* r4 = reinterpret_cast<float4*>(row + h);
        float x[WU], y[WU];
#pragma unroll
        for (int q = 0; q < WU / 4; ++q) {
          const float4 v = r4[q];
          x[4 * q] = v.x;
          x[4 * q + 1] = v.y;
          x[4 * q + 2] = v.z;
          x[4 * q + 3] = v.w;
        }
        lattice_walk<N, WU>(slot, x, y, co);
        if (own) {
#pragma unroll
          for (int q = 0; q < WU / 4; ++q)
            r4[q] = make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2],
                                y[4 * q + 3]);
        }
      }
    } else {
      for (int i = 0; i < cnt; ++i) {
        const float x[1] = {row[i]};
        float y[1];
        lattice_walk<N, 1>(slot, x, y, co);
        if (own) row[i] = y[0];
      }
    }
    __syncwarp();
    bar_arrive(BAR_DONE + s, WALK_T + OUT_T);
  }
  if (own) {
#pragma unroll
    for (int m = 0; m < N; ++m) s_out[c * N + m] = slot[m];
  }
}

// Warps 0 .. NWALK-1 walk (one per scheduler), warp NWALK is the front,
// the rest form the output.
template <int N>
__global__ void __launch_bounds__(THREADS, 1) lattice_kernel(
    const float* __restrict__ x, const float* __restrict__ s_in,
    const Coefs co, const LatGeo g, float* __restrict__ y,
    float* __restrict__ s_out) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);   // [STAGES][cb][SS]
  const int cb = NWALK * g.lw;
  const int c0 = blockIdx.x * cb;
  const int nc = min(cb, g.C - c0);
  const int ntiles = (g.T + TA - 1) / TA;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < NWALK) {
    lat_walker<N>(s_in, s_out, co, g, c0, nc, cb, ntiles, stage, warp,
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

template <int N>
int launch(const float* x, const float* s, const Coefs& co, const LatGeo& g,
           float* y, float* so, cudaStream_t st) {
  const int smem = lat_smem_bytes(g.lw);
  cudaError_t e = cudaFuncSetAttribute(
      lattice_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int cb = NWALK * g.lw;
  lattice_kernel<N><<<(g.C + cb - 1) / cb, THREADS, smem, st>>>(x, s, co, g,
                                                                  y, so);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int uhsdr_lattice_max_stages() { return MAX_N; }
int uhsdr_lattice_max_lanes() { return LAT_MAXLW; }
int uhsdr_lattice_walkers() { return NWALK; }
int uhsdr_lattice_tile() { return TA; }
int uhsdr_lattice_stages() { return STAGES; }
int uhsdr_lattice_threads() { return THREADS; }

// A block's dynamic shared memory at lw row lanes a walker, or -1 outside
// 1..LAT_MAXLW.
int uhsdr_lattice_smem(int lw) {
  return lw >= 1 && lw <= LAT_MAXLW ? lat_smem_bytes(lw) : -1;
}

// x, y: (C, T) f32; s_in, s_out: (C, N) f32; pk (N,), pv (N+1,) f32 on the
// host, 1 <= N <= MAX_N; lw: the row lanes of a walker
// (cuda/lattice.py::lattice_geometry); vec: x and y 16-byte aligned and T
// % 4 == 0.  Returns a cudaError_t (cudaErrorInvalidValue for a shape the
// kernel does not take).
int uhsdr_lattice_launch(const void* x, const void* s_in, int C, int T,
                         const float* pk, const float* pv, int N, int lw,
                         int vec, void* y, void* s_out, void* stream) {
  if (N < 1 || N > MAX_N || C < 1 || T < 1 || lw < 1 || lw > LAT_MAXLW)
    return (int)cudaErrorInvalidValue;
  Coefs co = {};
  for (int m = 0; m < N; ++m) co.pk[m] = pk[m];
  for (int m = 0; m <= N; ++m) co.pv[m] = pv[m];
  const LatGeo g{C, T, lw, vec ? 1 : 0};
  const float* xp = (const float*)x;
  const float* sp = (const float*)s_in;
  float* yp = (float*)y;
  float* so = (float*)s_out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (N) {
#define UHSDR_LATTICE_CASE(n) \
  case n:                     \
    return launch<n>(xp, sp, co, g, yp, so, st);
    UHSDR_LATTICE_CASE(1)
    UHSDR_LATTICE_CASE(2)
    UHSDR_LATTICE_CASE(3)
    UHSDR_LATTICE_CASE(4)
    UHSDR_LATTICE_CASE(5)
    UHSDR_LATTICE_CASE(6)
    UHSDR_LATTICE_CASE(7)
    UHSDR_LATTICE_CASE(8)
    UHSDR_LATTICE_CASE(9)
    UHSDR_LATTICE_CASE(10)
    UHSDR_LATTICE_CASE(11)
    UHSDR_LATTICE_CASE(12)
#undef UHSDR_LATTICE_CASE
  }
  return (int)cudaErrorInvalidValue;
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
