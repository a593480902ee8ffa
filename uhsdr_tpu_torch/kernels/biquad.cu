// K11, the biquad cascade, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel uhsdr_tpu/pallas/iir.py::_make_kernel
// (biquad_cascade_pallas, demod/sam.py:213-216 for SAM's 7-stage z^-2
// allpass chains, and the dispatch fallback ops/iir.py:244-251).  Per
// channel, S sections in order per sample, direct form II transposed:
//   y = b0*x + s1;  s1 = b1*x - a1*y + s2;  s2 = b2*x - a2*y;  x = y.
// The TPU kernel runs a dilated scan per 128-sample tile because a TPU
// has no cheap per-lane sequential walk; on the card the same function is
// the recurrence itself, which also sums in the order a float64
// reference does.
//
// Bound on this card: bytes (x in, y out: 512 MiB per call at 16384
// stacked channels x 4096), as long as enough channels are in flight to
// hide the latency of the S dependent steps per sample.  Design as K3
// (kernels/agc.cu): a block owns CB = 32 channels, one warp walks them
// (one thread per channel, the 2*S state words and 5*S coefficients in
// registers, S a template parameter) and all 256 threads stage
// (channel x time) tiles through shared memory so global loads and
// stores stay coalesced.  Compiled with -fmad=false: the products and
// sums stay the separate f32 operations of the plain torch version
// (`ops.iir.biquad_cascade_block`), so the two agree bit for bit.
//
// K14, the same cascade by a two-level scan, is the second kernel of this
// source (`biquad_grouped_kernel` below).
#include <cuda_runtime.h>

namespace {

constexpr int CB = 32;          // channels per block
constexpr int TA = 128;         // time tile
constexpr int THREADS = 256;
constexpr int ST = TA + 1;      // odd row stride: conflict-free walk
constexpr int MAXS = 8;         // most sections in one cascade

template <int S>
__global__ void __launch_bounds__(THREADS) biquad_kernel(
    const float* __restrict__ x, const float* __restrict__ state,
    const float* __restrict__ sos, int C, int T, float* __restrict__ y,
    float* __restrict__ state_out) {
  __shared__ float tile[CB][ST];
  const int c0 = blockIdx.x * CB;
  const int tid = threadIdx.x;
  const int nc = min(CB, C - c0);
  const bool walker = tid < nc;

  float b0[S], b1[S], b2[S], a1[S], a2[S], s1[S], s2[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    b0[k] = sos[5 * k + 0];
    b1[k] = sos[5 * k + 1];
    b2[k] = sos[5 * k + 2];
    a1[k] = sos[5 * k + 3];
    a2[k] = sos[5 * k + 4];
    s1[k] = s2[k] = 0.f;
    if (walker) {       // state is (S, C, 2)
      const float2 s = reinterpret_cast<const float2*>(
          state)[(size_t)k * C + c0 + tid];
      s1[k] = s.x;
      s2[k] = s.y;
    }
  }

  for (int t0 = 0; t0 < T; t0 += TA) {
    const int cnt = min(TA, T - t0);
    for (int i = tid; i < CB * TA; i += THREADS) {
      const int c = i / TA, j = i % TA;
      if (c < nc && j < cnt) tile[c][j] = x[(size_t)(c0 + c) * T + t0 + j];
    }
    __syncthreads();
    if (walker) {
      // the next sample is read before this one's result is stored to
      // the same tile (at j + 1 = TA the read lands on the pad column)
      float v_next = tile[tid][0];
      for (int j = 0; j < cnt; ++j) {
        float v = v_next;
        v_next = tile[tid][j + 1];
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const float out = b0[k] * v + s1[k];
          s1[k] = b1[k] * v - a1[k] * out + s2[k];
          s2[k] = b2[k] * v - a2[k] * out;
          v = out;
        }
        tile[tid][j] = v;
      }
    }
    __syncthreads();
    for (int i = tid; i < CB * TA; i += THREADS) {
      const int c = i / TA, j = i % TA;
      if (c < nc && j < cnt) y[(size_t)(c0 + c) * T + t0 + j] = tile[c][j];
    }
    __syncthreads();
  }

  if (walker) {
#pragma unroll
    for (int k = 0; k < S; ++k)
      reinterpret_cast<float2*>(state_out)[(size_t)k * C + c0 + tid] =
          make_float2(s1[k], s2[k]);
  }
}

template <int S>
int launch(const void* x, const void* state, const void* sos, int C, int T,
           void* y, void* state_out, cudaStream_t stream) {
  biquad_kernel<S><<<(C + CB - 1) / CB, THREADS, 0, stream>>>(
      (const float*)x, (const float*)state, (const float*)sos, C, T,
      (float*)y, (float*)state_out);
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

// x, y: (C, T) f32; state, state_out: (S, C, 2) f32; sos: (S, 5) f32 rows
// [b0 b1 b2 a1 a2] on the device.  Requires 1 <= S <= MAXS and T >= 1.
// Returns a cudaError_t.
int uhsdr_biquad_launch(const void* x, const void* state, const void* sos,
                        int S, int C, int T, void* y, void* state_out,
                        void* stream) {
  using Launch = int (*)(const void*, const void*, const void*, int, int,
                         void*, void*, cudaStream_t);
  static const Launch table[MAXS] = {launch<1>, launch<2>, launch<3>,
                                     launch<4>, launch<5>, launch<6>,
                                     launch<7>, launch<8>};
  if (S < 1 || S > MAXS) return (int)cudaErrorInvalidValue;
  return table[S - 1](x, state, sos, C, T, y, state_out,
                      (cudaStream_t)stream);
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
