// K6 and K7, the complex-tap decimating front, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernels uhsdr_tpu/pallas/fir.py::_fir_kernel (K6, :47)
// and ::_fir_nco_kernel (K7, :370), the complex-taps branch of
// fir_decimate_pallas (:828-855), entered from chain/rx.py:857 for the
// wide-SSB fronts (one complex FIR g_h (*) dec whose real part is the SSB
// audio).  Per channel, in one pass:
//   int16 (or f32) IQ planes -> f32 * in_scale;  per-channel max(|i|,|q|)
//     of the scaled raw input (the ADC peak tap);
//   K7 only: rotation by exp(j*2pi*(phase0 + delta*n)/2^32), uint32
//     modular phase; the carried history is RAW pre-mix IQ and is rotated
//     at n = j - (taps-1) (the contract of chain/rx.py:723-755);
//   y[m] = sum_k h[k] * z[m*decim - k] with complex taps h = hr + j*hi:
//     Re y = sum hr*zr - hi*zi,  Im y = sum hr*zi + hi*zr;
//   emits Re(y) alone (the chain's use, the TPU kernel's real_out), or y
//   as two f32 planes or one interleaved complex64 array, plus the new
//   raw history (last taps-1 scaled inputs) and the peaks.
// The TPU kernels read f32 planes only (fir_decimate_pallas converts int16
// first, :520-525); reading int16 here is the same arithmetic.
//
// Bound on this card: operations.  At the wide-SSB flagship (8192 ch x
// 16384 samples, decim 4, 245 complex taps, real output) it is 16.4 G FMA
// of FP32 on the CUDA cores against 0.63 GiB of memory traffic.
//
// Design: one output a thread over a shared-memory ring.  One thread
// block per channel walks the block's time tiles in order; the halo lives
// in the ring, stored polyphase (row = sample index mod decim, padded
// stride) so that the threads of a warp, one per output, read consecutive
// words for every tap.  Ring samples and taps are stored as interleaved (re, im) pairs, so
// each tap costs two 8-byte shared loads (the tap is a broadcast) for its
// two FMAs (real output) or four (complex output).  No tensor cores, no
// TF32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TT = 128;         // outputs per time tile = threads per block
constexpr int QA = 256;         // ring rows per phase (power of two)
constexpr int QS = QA + 1;      // padded row stride

enum OutKind { OUT_PLANES = 0, OUT_INTERLEAVED = 1, OUT_REAL = 2 };

__device__ __forceinline__ float as_f32(int16_t v) { return (float)v; }
__device__ __forceinline__ float as_f32(float v) { return v; }

// exp(j*2pi*ph/2^32): the signed reinterpretation shifts the angle by
// -2pi at most, invisible to sin/cos; sincospif keeps full f32 accuracy.
__device__ __forceinline__ void rotor(uint32_t ph, float* s, float* c) {
  const float x = (float)(int32_t)ph * 4.656612873077392578125e-10f;
  sincospif(x, s, c);
}

template <typename Tin, bool NCO, bool REAL>
__global__ void __launch_bounds__(TT) fir_cx_kernel(
    const Tin* __restrict__ xi, const Tin* __restrict__ xq, float in_scale,
    int B, const float2* __restrict__ carry_in,
    const int64_t* __restrict__ phase, uint32_t delta,
    const float2* __restrict__ h, int taps, int decim, int out_kind,
    float* __restrict__ out_a, float* __restrict__ out_b,
    float2* __restrict__ carry_out, float* __restrict__ peaks) {
  extern __shared__ float2 smem2[];
  float2* ring = smem2;                     // decim * QS samples
  float2* hs = ring + decim * QS;           // taps
  __shared__ float warp_pk[TT / 32];

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_hist = taps - 1;
  const int T_out = B / decim;
  const uint32_t ph0 = NCO ? (uint32_t)phase[c] : 0u;
  const size_t row = (size_t)c * B;
  const int OFF = decim * QA;   // bias keeps ring indices non-negative

  for (int k = tid; k < taps; k += TT) hs[k] = h[k];
  // raw history sample j sits at absolute index n = j - n_hist
  for (int j = tid; j < n_hist; j += TT) {
    const int n = j - n_hist;
    float2 v = carry_in[(size_t)c * n_hist + j];
    if (NCO) {
      float s, co;
      rotor(ph0 + delta * (uint32_t)n, &s, &co);
      v = make_float2(v.x * co - v.y * s, v.x * s + v.y * co);
    }
    const int no = n + OFF;
    ring[(no % decim) * QS + ((no / decim) & (QA - 1))] = v;
  }
  float pk = 0.f;
  __syncthreads();

  const int W = TT * decim;
  for (int t0 = 0; t0 < T_out; t0 += TT) {
    const int n0 = t0 * decim;
    for (int j = tid; j < W; j += TT) {
      const int n = n0 + j;
      if (n >= B) break;
      float a = as_f32(xi[row + n]) * in_scale;
      float b = as_f32(xq[row + n]) * in_scale;
      pk = fmaxf(pk, fmaxf(fabsf(a), fabsf(b)));
      if (NCO) {
        float s, co;
        rotor(ph0 + delta * (uint32_t)n, &s, &co);
        const float ar = a * co - b * s;
        b = a * s + b * co;
        a = ar;
      }
      const int no = n + OFF;
      ring[(no % decim) * QS + ((no / decim) & (QA - 1))] =
          make_float2(a, b);
    }
    __syncthreads();

    // sample decim*M - k with k = decim*a + b lives in phase row
    // (decim - b) % decim at ring row M - a - (b > 0)
    const int M = t0 + tid;
    if (M < T_out) {
      float yr = 0.f, yi = 0.f;
      for (int b = 0; b < decim; ++b) {
        const float2* rz = ring + ((decim - b) % decim) * QS;
        const int qb = M + QA - (b > 0 ? 1 : 0);
        int a = 0;
        for (int k = b; k < taps; k += decim, ++a) {
          const float2 hk = hs[k];
          const float2 z = rz[(qb - a) & (QA - 1)];
          yr = fmaf(hk.x, z.x, yr);
          yr = fmaf(-hk.y, z.y, yr);
          if (!REAL) {
            yi = fmaf(hk.x, z.y, yi);
            yi = fmaf(hk.y, z.x, yi);
          }
        }
      }
      const size_t o = (size_t)c * T_out + M;
      if (REAL) {
        out_a[o] = yr;
      } else if (out_kind == OUT_INTERLEAVED) {
        reinterpret_cast<float2*>(out_a)[o] = make_float2(yr, yi);
      } else {
        out_a[o] = yr;
        out_b[o] = yi;
      }
    }
    __syncthreads();
  }

  // new raw history: the last n_hist samples of (history ++ block),
  // scaled, before rotation
  for (int j = tid; j < n_hist; j += TT) {
    const int n = B - n_hist + j;
    float2 v;
    if (n >= 0) {
      v = make_float2(as_f32(xi[row + n]) * in_scale,
                      as_f32(xq[row + n]) * in_scale);
    } else {
      v = carry_in[(size_t)c * n_hist + (j + B)];
    }
    carry_out[(size_t)c * n_hist + j] = v;
  }
  for (int o = 16; o > 0; o >>= 1)
    pk = fmaxf(pk, __shfl_xor_sync(0xffffffffu, pk, o));
  if ((tid & 31) == 0) warp_pk[tid >> 5] = pk;
  __syncthreads();
  if (tid == 0) {
    float m = warp_pk[0];
    for (int w = 1; w < TT / 32; ++w) m = fmaxf(m, warp_pk[w]);
    peaks[c] = m;
  }
}

template <typename Tin, bool NCO, bool REAL>
int launch(const void* xi, const void* xq, float in_scale, int C, int B,
           const void* carry_in, const void* phase, uint32_t delta,
           const void* h, int taps, int decim, int out_kind, void* out_a,
           void* out_b, void* carry_out, void* peaks, cudaStream_t stream) {
  const size_t smem = (size_t)(decim * QS + taps) * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(
      fir_cx_kernel<Tin, NCO, REAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fir_cx_kernel<Tin, NCO, REAL><<<C, TT, smem, stream>>>(
      (const Tin*)xi, (const Tin*)xq, in_scale, B, (const float2*)carry_in,
      (const int64_t*)phase, delta, (const float2*)h, taps, decim, out_kind,
      (float*)out_a, (float*)out_b, (float2*)carry_out, (float*)peaks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile geometry the wrapper checks shapes against.
int uhsdr_fir_cx_tile() { return TT; }
int uhsdr_fir_cx_ring_rows() { return QA; }

// in_kind: 0 = int16 planes, 1 = float32 planes.  use_nco: 0 leaves the
// input unrotated (K6; phase is not read), 1 rotates it (K7).  h: taps
// interleaved complex64.  out_kind: 0 = two f32 planes (out_a, out_b),
// 1 = one interleaved complex64 array (out_a), 2 = the real plane alone
// (out_a).  Returns a cudaError_t.
int uhsdr_fir_cx_launch(int in_kind, const void* xi, const void* xq,
                        float in_scale, int C, int B, const void* carry_in,
                        int use_nco, const void* phase, unsigned int delta,
                        const void* h, int taps, int decim, int out_kind,
                        void* out_a, void* out_b, void* carry_out,
                        void* peaks, void* stream) {
  using Launch = int (*)(const void*, const void*, float, int, int,
                         const void*, const void*, uint32_t, const void*,
                         int, int, int, void*, void*, void*, void*,
                         cudaStream_t);
  static const Launch table[2][2][2] = {
      {{launch<int16_t, false, false>, launch<int16_t, false, true>},
       {launch<int16_t, true, false>, launch<int16_t, true, true>}},
      {{launch<float, false, false>, launch<float, false, true>},
       {launch<float, true, false>, launch<float, true, true>}}};
  return table[in_kind != 0][use_nco != 0][out_kind == OUT_REAL](
      xi, xq, in_scale, C, B, carry_in, phase, delta, h, taps, decim,
      out_kind, out_a, out_b, carry_out, peaks, (cudaStream_t)stream);
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
