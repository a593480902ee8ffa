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
// samples, 201 taps) it is 54 G FMA of FP32 on the CUDA cores against
// 1.5 GiB of memory traffic (0.48 ms).
//
// Design: one output a thread over a shared-memory history ring, at
// decimation 1 with one plane.  One thread block per channel walks the
// block's time tiles in order; the history lives in the ring of RING real
// samples, and the taps as (re, im) pairs, so each tap is one sample load
// (consecutive words across the warp), one broadcast 8-byte tap load and
// two FP32 FMAs.  Simple first: no register blocking, no tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TT = 128;         // outputs per time tile = threads per block
constexpr int RING = 512;       // history ring (power of two)

// exp(j*2pi*ph/2^32): the signed reinterpretation shifts the angle by
// -2pi at most, invisible to sin/cos; sincospif keeps full f32 accuracy.
__device__ __forceinline__ void rotor(uint32_t ph, float* s, float* c) {
  const float x = (float)(int32_t)ph * 4.656612873077392578125e-10f;
  sincospif(x, s, c);
}

template <bool NCO>
__global__ void __launch_bounds__(TT) fir_real_kernel(
    const float* __restrict__ x, int B, const float* __restrict__ carry_in,
    const float2* __restrict__ h, int taps, int conj,
    const int64_t* __restrict__ phase, uint32_t delta,
    float2* __restrict__ out, float* __restrict__ carry_out) {
  __shared__ float xs[RING];
  extern __shared__ float2 hs[];            // taps
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_hist = taps - 1;
  const size_t row = (size_t)c * B;
  const uint32_t ph0 = NCO ? (uint32_t)phase[c] : 0u;

  for (int k = tid; k < taps; k += TT) hs[k] = h[k];
  // history sample j sits at absolute index n = j - n_hist
  for (int j = tid; j < n_hist; j += TT)
    xs[(j - n_hist) & (RING - 1)] = carry_in[(size_t)c * n_hist + j];
  __syncthreads();

  for (int t0 = 0; t0 < B; t0 += TT) {
    const int n = t0 + tid;
    if (n < B) xs[n & (RING - 1)] = x[row + n];
    __syncthreads();
    if (n < B) {
      float yr = 0.f, yi = 0.f;
      for (int k = 0; k < taps; ++k) {
        const float v = xs[(n - k) & (RING - 1)];
        const float2 hk = hs[k];
        yr = fmaf(hk.x, v, yr);
        yi = fmaf(hk.y, v, yi);
      }
      if (conj) yi = -yi;
      if (NCO) {
        float s, co;
        rotor(ph0 + delta * (uint32_t)n, &s, &co);
        const float r = yr * co - yi * s;
        yi = yr * s + yi * co;
        yr = r;
      }
      out[row + n] = make_float2(yr, yi);
    }
    __syncthreads();
  }

  // new history: the last n_hist samples of (history ++ block)
  for (int j = tid; j < n_hist; j += TT) {
    const int n = B - n_hist + j;
    carry_out[(size_t)c * n_hist + j] =
        n >= 0 ? x[row + n] : carry_in[(size_t)c * n_hist + (j + B)];
  }
}

template <bool NCO>
int launch(const void* x, int C, int B, const void* carry_in, const void* h,
           int taps, int conj, const void* phase, uint32_t delta, void* out,
           void* carry_out, cudaStream_t stream) {
  const size_t smem = (size_t)taps * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(
      fir_real_kernel<NCO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  fir_real_kernel<NCO><<<C, TT, smem, stream>>>(
      (const float*)x, B, (const float*)carry_in, (const float2*)h, taps,
      conj, (const int64_t*)phase, delta, (float2*)out, (float*)carry_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Geometry the wrapper checks shapes against: taps - 1 + TT <= RING.
int uhsdr_fir_real_tile() { return TT; }
int uhsdr_fir_real_ring() { return RING; }

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
