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

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
