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
// Bound on this card: bytes at the chains' shapes.  A row's samples are a
// chain: f of stage m at sample n feeds gn[m] (a multiply and an add), the
// next sample's pk[m-1] * g[m-1] (a multiply) and its f of stage m-1 (an
// add), and that f feeds stage m's (an add): 5 dependent FP32 operations
// a sample (cuda/lattice.py::LATTICE_STEP_CHAIN), 0.041 ms for 4096
// samples at 1.98 GHz, against 0.080 ms for the bytes of 8192 x 4096 f32
// in and out at 3.35 TB/s.
//
// Design: a lane a row, the N-stage state in registers, a warp a block (32
// rows).  The warp moves its rows through shared memory in tiles of 32
// samples: each lane loads one sample of each of the 32 rows (a 128-byte
// line a load), the tile is read transposed (a lane its own row, padded
// rows so no two lanes share a bank), each lane writes its outputs over
// its inputs, and the tile goes back out as it came in.  The next tile's
// loads are in flight in registers while a tile is walked.  pk and pv
// travel in the launch's parameters.  Compiled with -fmad=false so that
// every product and sum rounds as the plain version's
// (cuda/lattice.py::lattice_plain): bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_N = 12;
constexpr int TILE = 32;

struct Coefs {
  float pk[MAX_N];
  float pv[MAX_N + 1];
};

template <int N>
__global__ void __launch_bounds__(TILE) lattice_kernel(
    const float* __restrict__ x, const float* __restrict__ s_in, int C,
    int T, float* __restrict__ y, float* __restrict__ s_out, const Coefs co) {
  __shared__ float tile[TILE][TILE + 1];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * TILE;
  const int row = row0 + lane;
  const int nrows = min(TILE, C - row0);
  float g[N];
#pragma unroll
  for (int m = 0; m < N; ++m) g[m] = row < C ? s_in[(size_t)row * N + m] : 0.f;
  float nxt[TILE];
#pragma unroll
  for (int r = 0; r < TILE; ++r)
    nxt[r] = (r < nrows && lane < T) ? x[(size_t)(row0 + r) * T + lane] : 0.f;
  for (int t0 = 0; t0 < T; t0 += TILE) {
    __syncwarp();
#pragma unroll
    for (int r = 0; r < TILE; ++r) tile[r][lane] = nxt[r];
    __syncwarp();
    const int tn = t0 + TILE + lane;
#pragma unroll
    for (int r = 0; r < TILE; ++r)
      nxt[r] = (r < nrows && tn < T) ? x[(size_t)(row0 + r) * T + tn] : 0.f;
    const int nt = min(TILE, T - t0);
#pragma unroll 2
    for (int j = 0; j < nt; ++j) {
      const float xn = tile[lane][j];
      float f = xn;
      float acc = xn * co.pv[N] * 0.0f;
      float gn[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        f = f - co.pk[m] * g[m];
        gn[m] = f * co.pk[m] + g[m];
        acc = acc + gn[m] * co.pv[m];
      }
      acc = acc + f * co.pv[N];
#pragma unroll
      for (int m = 0; m + 1 < N; ++m) g[m] = gn[m + 1];
      g[N - 1] = f;
      tile[lane][j] = acc;
    }
    __syncwarp();
    const int t = t0 + lane;
#pragma unroll
    for (int r = 0; r < TILE; ++r)
      if (r < nrows && t < T) y[(size_t)(row0 + r) * T + t] = tile[r][lane];
  }
  if (row < C) {
#pragma unroll
    for (int m = 0; m < N; ++m) s_out[(size_t)row * N + m] = g[m];
  }
}

template <int N>
cudaError_t launch(const float* x, const float* s, int C, int T, float* y,
                   float* so, const Coefs& co, cudaStream_t st) {
  const int blocks = (C + TILE - 1) / TILE;
  lattice_kernel<N><<<blocks, TILE, 0, st>>>(x, s, C, T, y, so, co);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int uhsdr_lattice_max_stages() { return MAX_N; }
int uhsdr_lattice_tile() { return TILE; }

// x, y: (C, T) f32; s_in, s_out: (C, N) f32; pk (N,), pv (N+1,) f32 on the
// host, 1 <= N <= MAX_N.  Returns a cudaError_t (cudaErrorInvalidValue
// for a shape the kernel does not take).
int uhsdr_lattice_launch(const void* x, const void* s_in, int C, int T,
                         const float* pk, const float* pv, int N, void* y,
                         void* s_out, void* stream) {
  if (N < 1 || N > MAX_N || C < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  Coefs co = {};
  for (int m = 0; m < N; ++m) co.pk[m] = pk[m];
  for (int m = 0; m <= N; ++m) co.pv[m] = pv[m];
  const float* xp = (const float*)x;
  const float* sp = (const float*)s_in;
  float* yp = (float*)y;
  float* so = (float*)s_out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (N) {
#define UHSDR_LATTICE_CASE(n) \
  case n:                     \
    return (int)launch<n>(xp, sp, C, T, yp, so, co, st);
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
