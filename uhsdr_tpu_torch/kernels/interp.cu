// K4, the polyphase interpolator, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel uhsdr_tpu/pallas/fir.py::_interp_kernel
// (fir_interpolate_pallas, chain/rx.py:1103):
//   y[c, m*L + p] = sum_k h[k*L + p] * x[c, m - k],  k < S = ceil(taps/L),
// with the S-1 carried low-rate samples standing in for x[c, m<0]
// (ops/fir.py:191-215's streaming phase).
//
// Bound on this card: bytes.  At 8192 ch x 2048 -> 16384 samples (x8) it
// reads 64 MiB and writes 512 MiB; at x4 (8192 x 4096, S = 24) 128 MiB
// and 512 MiB, while its FMAs (3.2 G) take half that time at the FP32
// peak.  What held PR 1's body back was shared-memory load issue, one tap
// and one sample load a FMA or more.  Design: register blocking.
//   - Each thread owns R consecutive low-rate samples, R*L outputs: it
//     loads a window of H + R samples (H: S-1 rounded up to 4) from the
//     block's staged tile with float4 loads, once, and runs its R*L*S FMAs
//     out of registers.
//   - The taps are uniform: they travel in the launch's __grid_constant__
//     parameter struct, so each FFMA reads its tap from the constant bank
//     with no load.  The (L, S) instances the chains reach are templates
//     with compile-time tap indices and window slots: x2 (S 2, 8) and x4
//     (S 1, 4) at 48 kHz, x4 (S 24) and x8 (S 12) at 96 kHz, x8 (S 24) and
//     x16 (S 12) at 192 kHz (the table FIXED).  Any other (L, S) runs on
//     the generic instance (R = 4, run-time loops): up to MAX_TAPS padded
//     taps it reads them from the struct by index, past that from device
//     memory (uniform loads, cached), so any tap count runs.
//   - Stores: a warp stages its threads' outputs in shared memory (rows
//     of R*L + 4 floats: conflict-free float4 writes) and copies its
//     contiguous 32*R*L outputs to device memory, 16 bytes a lane over
//     consecutive addresses, so each store covers whole 128-byte lines
//     (at a tenth of the time of each thread storing its own outputs).
// Blocks are independent: a block stages one tile of THREADS*R low-rate
// samples of one channel with its left halo (from x or the carry).  The
// launch rule is mirrored by cuda/fir.py::interp_geometry.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_TAPS = 960;       // the generic instance's tap table
constexpr int SMEM_OPT_IN = 227 * 1024;   // a block's shared memory, most

template <int NH>
struct Args {
  const float* x;
  const float* carry;
  float* y;
  float* carry_out;
  const float* hd;   // the taps on the card (the generic instance past
                     // MAX_TAPS reads them there)
  int B, L, S, n_tile, taps;
  float h[NH];   // taps zero-padded to S*L: h[k*L + p]
};

// The (L, S) pairs with an instance of their own: the one list that the
// geometry, the dispatch and the library's getters read.
struct Pair {
  int L, S;
};
constexpr Pair FIXED[] = {{2, 2}, {2, 8},  {4, 1},  {4, 4},
                          {4, 24}, {8, 12}, {8, 24}, {16, 12}};
constexpr int N_FIXED = sizeof(FIXED) / sizeof(FIXED[0]);

bool fixed_instance(int L, int S) {
  for (const Pair& f : FIXED)
    if (f.L == L && f.S == S) return true;
  return false;
}

// low-rate samples a thread of a fixed instance: 32 outputs or more
__host__ __device__ constexpr int samples_a_thread(int L) {
  return L >= 8 ? 4 : 32 / L;
}

__host__ __device__ constexpr int halo(int S) { return (S - 1 + 3) / 4 * 4; }

struct Geometry {
  int fixed, R, H, tile, smem;
};

Geometry geometry(int L, int S) {
  Geometry g;
  g.fixed = fixed_instance(L, S);
  g.R = g.fixed ? samples_a_thread(L) : 4;
  g.H = halo(S);
  g.tile = THREADS * g.R;
  g.smem = (g.H + g.tile) * (int)sizeof(float);
  if (g.fixed) g.smem += THREADS * (g.R * L + 4) * (int)sizeof(float);
  return g;
}

// xs[i] = x[c, m0 - H + i] for i < H + tile: the carry for m < 0 (zeros
// before it and past B), float4 loads where the row is 16-byte aligned.
template <int NH>
__device__ __forceinline__ void stage_input(const Args<NH>& a, int c, int m0,
                                            int H, int tile, float* xs) {
  const int nh = a.S - 1;
  const bool vec = a.B % 4 == 0;
  const float* xr = a.x + (size_t)c * a.B;
  const float* cr = a.carry + (size_t)c * nh;
  auto sample = [&](int m) {
    return m >= a.B ? 0.f : m >= 0 ? xr[m] : m >= -nh ? cr[nh + m] : 0.f;
  };
  for (int i4 = threadIdx.x; i4 < (H + tile) / 4; i4 += THREADS) {
    const int m = m0 - H + 4 * i4;
    float4 v;
    if (vec && m >= 0 && m + 4 <= a.B) {
      v = *reinterpret_cast<const float4*>(xr + m);
    } else {
      v = make_float4(sample(m), sample(m + 1), sample(m + 2), sample(m + 3));
    }
    reinterpret_cast<float4*>(xs)[i4] = v;
  }
}

// new history: the last S-1 samples of (carry ++ x), by the block of the
// channel's last tile
template <int NH>
__device__ __forceinline__ void store_carry(const Args<NH>& a, int c) {
  const int nh = a.S - 1;
  for (int j = threadIdx.x; j < nh; j += THREADS) {
    const int m = a.B - nh + j;
    a.carry_out[(size_t)c * nh + j] =
        m >= 0 ? a.x[(size_t)c * a.B + m] : a.carry[(size_t)c * nh + m + nh];
  }
}

template <int L, int S>
__global__ void __launch_bounds__(THREADS) interp_fixed(
    const __grid_constant__ Args<L * S> a) {
  constexpr int R = samples_a_thread(L);
  constexpr int H = halo(S);
  constexpr int TILE = THREADS * R;
  constexpr int RL = R * L;
  constexpr int OS = RL + 4;        // a thread's row of staged outputs
  static_assert(R % 4 == 0 && RL % 4 == 0, "float4 windows and rows");
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);        // H + TILE samples
  const int c = blockIdx.x / a.n_tile;
  const int m0 = (blockIdx.x % a.n_tile) * TILE;
  const int cnt = min(TILE, a.B - m0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  stage_input(a, c, m0, H, TILE, xs);
  __syncthreads();

  // the window: x[m0 + R*tid - H ..), loaded once
  float w[H + R];
  const float4* w4 = reinterpret_cast<const float4*>(xs + R * tid);
#pragma unroll
  for (int i = 0; i < (H + R) / 4; ++i) {
    const float4 v = w4[i];
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
  float out[RL];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int p = 0; p < L; ++p) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < S; ++k) acc = fmaf(a.h[k * L + p], w[H + r - k], acc);
      out[r * L + p] = acc;
    }

  // the warp's outputs are contiguous, from (m0 + 32 R warp) L on: staged
  // in shared memory, then stored 16 bytes a lane over consecutive
  // addresses (each thread's own R*L outputs stored straight from its
  // registers, 16 bytes a lane 4 R L bytes apart, ran ten times slower on
  // the card)
  float* os = xs + H + TILE + warp * 32 * OS;
  float4* o4 = reinterpret_cast<float4*>(os + lane * OS);
#pragma unroll
  for (int i = 0; i < RL / 4; ++i)
    o4[i] = make_float4(out[4 * i], out[4 * i + 1], out[4 * i + 2],
                        out[4 * i + 3]);
  __syncwarp();
  const int n = max(0, min(cnt - 32 * R * warp, 32 * R)) * L;
  float* yw = a.y + ((size_t)c * a.B + m0 + 32 * R * warp) * L;
  const int n4 = (a.B * L) % 4 == 0 ? n / 4 : 0;   // rows 16-byte aligned
  for (int e4 = lane; e4 < n4; e4 += 32) {
    const int e = 4 * e4;
    *reinterpret_cast<float4*>(yw + e) =
        *reinterpret_cast<const float4*>(os + e / RL * OS + e % RL);
  }
  for (int e = 4 * n4 + lane; e < n; e += 32) yw[e] = os[e / RL * OS + e % RL];
  if (m0 + cnt == a.B) store_carry(a, c);
}

// Any other (L, S): R = 4 samples a thread, run-time loops, the window
// read from shared memory and the taps from the struct by index (NH =
// MAX_TAPS) or, past that, from the card's copy (NH = 1).
template <int NH>
__global__ void __launch_bounds__(THREADS) interp_generic(
    const __grid_constant__ Args<NH> a) {
  constexpr int R = 4;
  constexpr int TILE = THREADS * R;
  const int L = a.L, S = a.S, H = halo(S);
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int c = blockIdx.x / a.n_tile;
  const int m0 = (blockIdx.x % a.n_tile) * TILE;
  const int cnt = min(TILE, a.B - m0);
  stage_input(a, c, m0, H, TILE, xs);
  __syncthreads();
  float* yr = a.y + (size_t)c * a.B * L;
  for (int r = 0; r < R; ++r) {
    const int i = R * threadIdx.x + r;   // the sample's offset in the tile
    if (i >= cnt) break;
    for (int p = 0; p < L; ++p) {
      float acc = 0.f;
      for (int k = 0; k < S; ++k) {
        const int j = k * L + p;
        const float hk =
            NH > 1 ? a.h[j] : j < a.taps ? __ldg(a.hd + j) : 0.f;
        acc = fmaf(hk, xs[H + i - k], acc);
      }
      yr[(size_t)(m0 + i) * L + p] = acc;
    }
  }
  if (m0 + cnt == a.B) store_carry(a, c);
}

// A launch's operands: x (C, B) and carry on the card, the taps on the
// host (h, for the parameters) and on the card (hd), y and carry_out.
struct Launch {
  const float *x, *carry, *h, *hd;
  int C, B, taps, L, S;
  float *y, *carry_out;
};

template <int NH>
void fill(Args<NH>& a, const Launch& l, int tile) {
  a.x = l.x;
  a.carry = l.carry;
  a.y = l.y;
  a.carry_out = l.carry_out;
  a.hd = l.hd;
  a.B = l.B;
  a.L = l.L;
  a.S = l.S;
  a.taps = l.taps;
  a.n_tile = (l.B + tile - 1) / tile;
  for (int i = 0; i < NH; ++i)
    a.h[i] = i < l.taps && i < l.L * l.S && NH > 1 ? l.h[i] : 0.f;
}

template <int NH, typename Kernel>
cudaError_t launch(Kernel kernel, const Launch& l, cudaStream_t stream) {
  const Geometry g = geometry(l.L, l.S);
  Args<NH> a;
  fill(a, l, g.tile);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e != cudaSuccess) return e;
  kernel<<<l.C * a.n_tile, THREADS, g.smem, stream>>>(a);
  return cudaGetLastError();
}

// The instance of FIXED[I..] that is (L, S), else the generic one.
template <int I = 0>
cudaError_t dispatch(const Launch& l, cudaStream_t stream) {
  if constexpr (I < N_FIXED) {
    constexpr Pair f = FIXED[I];
    if (l.L == f.L && l.S == f.S)
      return launch<f.L * f.S>(interp_fixed<f.L, f.S>, l, stream);
    return dispatch<I + 1>(l, stream);
  } else {
    return l.L * l.S <= MAX_TAPS
               ? launch<MAX_TAPS>(interp_generic<MAX_TAPS>, l, stream)
               : launch<1>(interp_generic<1>, l, stream);
  }
}

}  // namespace

extern "C" {

int uhsdr_interp_threads() { return THREADS; }
int uhsdr_interp_max_taps() { return MAX_TAPS; }
int uhsdr_interp_n_fixed() { return N_FIXED; }

// FIXED[i] as out[0..1] = (L, S); returns 0, or -1 past the table.
int uhsdr_interp_fixed(int i, int* out) {
  if (i < 0 || i >= N_FIXED) return -1;
  out[0] = FIXED[i].L;
  out[1] = FIXED[i].S;
  return 0;
}

// K4's launch for interpolation by L with `taps` taps: out[0..5] = fixed
// instance (1) or generic (0), samples a thread R, halo H, tile (low-rate
// samples a block), dynamic shared memory (bytes), taps in the launch's
// parameters (1) or read from the card (0).  Returns 0, or -1 for a shape
// the kernel does not take (L < 1, taps < 1, or a halo of S - 1 samples
// past the card's shared memory).
int uhsdr_interp_geometry(int L, int taps, int* out) {
  if (L < 1 || taps < 1) return -1;
  const int S = (taps + L - 1) / L;
  const Geometry g = geometry(L, S);
  if (g.smem > SMEM_OPT_IN) return -1;
  out[0] = g.fixed;
  out[1] = g.R;
  out[2] = g.H;
  out[3] = g.tile;
  out[4] = g.smem;
  out[5] = g.fixed || L * S <= MAX_TAPS;
  return 0;
}

// x: (C, B) f32 and carry: (C, S-1) on the card; h: the taps on the HOST
// (copied into the launch's parameters) and hd the same taps on the card;
// y: (C, B*L); carry_out: (C, S-1).  Requires L >= 1, B >= 1.  Returns a
// cudaError_t.
int uhsdr_interp_launch(const void* x, const void* carry, int C, int B,
                        const void* h, const void* hd, int taps, int L,
                        void* y, void* carry_out, void* stream) {
  if (L < 1 || taps < 1 || B < 1 || C < 1 ||
      geometry(L, (taps + L - 1) / L).smem > SMEM_OPT_IN)
    return (int)cudaErrorInvalidValue;
  const Launch l{(const float*)x, (const float*)carry, (const float*)h,
                 (const float*)hd, C, B, taps, L, (taps + L - 1) / L,
                 (float*)y, (float*)carry_out};
  return (int)dispatch(l, (cudaStream_t)stream);
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
