// K1, the fused RX front, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel uhsdr_tpu/pallas/fir.py::_fir_kernel_rt_s2
// (entered from fir_decimate_pallas's fuse2 branch, chain/rx.py:840-855).
// Per channel, in one pass over the block:
//   int16 (or f32) IQ planes -> f32 * in_scale;  per-channel max(|i|,|q|);
//   rotation by exp(j*2pi*(phase0 + delta*n)/2^32), uint32 modular phase
//     (the carried history is RAW pre-mix IQ and is rotated at
//     n = j - (taps-1), the contract of chain/rx.py:723-755);
//   stage A: real-tap decimating FIR, output m at input index m*decim;
//   stage B: complex-tap FIR at the decimated rate, real output
//     Re(zA (*) g) (the fused Hilbert pair, I±Q);
//   emits the audio, the new raw history (last n_keep >= taps-1 scaled
//   inputs), the new stage-B history (last taps2-1 stage-A outputs) and
//   the peaks.
// The two-channel modes (iq, ssbstereo) run the same kernel with NB = 2
// stage-B filters on the one stage-A output: the reference's input-rate
// (2, taps) filter pair dec (*) upsample(g_k) (chain/rx.py:364-398) is,
// by the noble identity, stage A then g_k at the decimated rate.  Their
// raw history is the pair's (n_keep = taps-1 + decim*(taps2-1)), so the
// kernel reads the last taps-1 of a longer carry and writes n_keep.
//
// K15, the modulated-taps front (the template's MT = true), replaces
// uhsdr_tpu/pallas/fir.py::_fir_kernel_rt_s2_mt, which the reference
// selects for a static NCO delta under UHSDR_FRONT_MT=1 (fir.py:589-593):
// the translation folded into complex stage-A taps h'[k] = h[k]
// e^{-j delta k} (hc = h cos(delta k), hs = -h sin(delta k), built on the
// host from the exact uint32 phase in float64), stage A on the raw,
// unrotated input (no rotation of the block or of the raw history), and
// the absolute rotor e^{j(phase0 + delta decim m)} applied to the
// decimated stage-A output, its uint32 phase exact at that rate:
//   y[m] = e^{j(phase0 + delta m decim)} sum_k h'[k] x[m decim - k].
// Stage B, the peaks and both carries are K1's.  The TPU kernel runs its
// dots in one bf16 pass; this one in FP32 FMAs, as every kernel here.
// Complex taps double stage A's FMAs (21.9 G at the SSB flagship).
//
// Bound on this card: operations.  At 8192 ch x 16384 samples, decim 8,
// 227 + 199 taps it is 7.6 G FMA (stage A) + 6.7 G FMA (stage B) of
// FP32 on the CUDA cores (no tensor cores, no TF32), against 0.58 GB of
// memory traffic; NB = 2 doubles stage B (21 G FMA at the ssbstereo
// flagship).
//
// Design: one thread block per channel walks the block's time tiles IN
// ORDER (GPU blocks run in no order, so the TPU's sequential time grid
// and its VMEM halo scratch become a loop inside the block).  The halos
// live in shared-memory rings: stage A's input ring is stored
// polyphase (row = sample index mod decim) so that the threads of a
// warp, one per output, read consecutive words for every tap; stage B's
// ring holds the last RB stage-A outputs.  Each tap is one FP32 FMA per
// plane.  Simple and exact first: no tensor cores, no vector loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TT = 128;         // outputs per time tile = threads per block
constexpr int QA = 256;         // ring rows per phase (power of two)
constexpr int QS = QA + 1;      // padded row stride: conflict-free writes
constexpr int RB = 512;         // stage-B ring length (power of two)

__device__ __forceinline__ float as_f32(int16_t v) { return (float)v; }
__device__ __forceinline__ float as_f32(float v) { return v; }

// exp(j*2pi*ph/2^32): the signed reinterpretation shifts the angle by
// -2pi at most, invisible to sin/cos; sincospif keeps full f32 accuracy.
__device__ __forceinline__ void rotor(uint32_t ph, float* s, float* c) {
  const float x = (float)(int32_t)ph * 4.656612873077392578125e-10f;
  sincospif(x, s, c);
}

template <typename Tin, int NB, bool MT>
__global__ void __launch_bounds__(TT) front_kernel(
    const Tin* __restrict__ xi, const Tin* __restrict__ xq, float in_scale,
    int B, int n_keep, const float2* __restrict__ carry_in,
    const float2* __restrict__ carry2_in, const int64_t* __restrict__ phase,
    uint32_t delta, const float* __restrict__ h, int taps, int decim,
    const float* __restrict__ h_sin, const float* __restrict__ g_re,
    const float* __restrict__ g_im, int taps2, float* __restrict__ out, float2* __restrict__ carry_out,
    float2* __restrict__ carry2_out, float* __restrict__ peaks) {
  extern __shared__ float smem[];
  float* ring_r = smem;                     // decim * QS
  float* ring_i = ring_r + decim * QS;
  float* zr = ring_i + decim * QS;          // RB
  float* zi = zr + RB;
  float* hs = zi + RB;                      // taps
  float* hsn = hs + taps;                   // MT: taps (the sine taps)
  float* gr = hsn + (MT ? taps : 0);        // NB * taps2
  float* gi = gr + NB * taps2;
  __shared__ float warp_pk[TT / 32];

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_hist = taps - 1;
  const int n_hist2 = taps2 - 1;
  const int T_out = B / decim;
  const uint32_t ph0 = (uint32_t)phase[c];
  const size_t row = (size_t)c * B;
  const int OFF = decim * QA;   // bias keeps ring indices non-negative

  for (int k = tid; k < taps; k += TT) {
    hs[k] = h[k];
    if (MT) hsn[k] = h_sin[k];
  }
  for (int k = tid; k < NB * taps2; k += TT) {
    gr[k] = g_re[k];
    gi[k] = g_im[k];
  }
  // raw history sample j sits at absolute index n = j - n_hist; it is
  // column n_keep - n_hist + j of the carried row
  const float2* hist = carry_in + (size_t)c * n_keep + (n_keep - n_hist);
  for (int j = tid; j < n_hist; j += TT) {
    const int n = j - n_hist;
    const float2 v = hist[j];
    const int no = n + OFF;
    const int idx = (no % decim) * QS + ((no / decim) & (QA - 1));
    if (MT) {             // the taps carry the relative phase
      ring_r[idx] = v.x;
      ring_i[idx] = v.y;
      continue;
    }
    float s, co;
    rotor(ph0 + delta * (uint32_t)n, &s, &co);
    ring_r[idx] = v.x * co - v.y * s;
    ring_i[idx] = v.x * s + v.y * co;
  }
  // stage-B history: output index m = j - n_hist2
  for (int j = tid; j < n_hist2; j += TT) {
    const float2 v = carry2_in[(size_t)c * n_hist2 + j];
    const int p = (j - n_hist2) & (RB - 1);
    zr[p] = v.x;
    zi[p] = v.y;
  }
  float pk = 0.f;
  __syncthreads();

  const int W = TT * decim;
  for (int t0 = 0; t0 < T_out; t0 += TT) {
    const int n0 = t0 * decim;
    for (int j = tid; j < W; j += TT) {
      const int n = n0 + j;
      if (n >= B) break;
      const float a = as_f32(xi[row + n]) * in_scale;
      const float b = as_f32(xq[row + n]) * in_scale;
      pk = fmaxf(pk, fmaxf(fabsf(a), fabsf(b)));
      const int no = n + OFF;
      const int idx = (no % decim) * QS + ((no / decim) & (QA - 1));
      if (MT) {
        ring_r[idx] = a;
        ring_i[idx] = b;
        continue;
      }
      float s, co;
      rotor(ph0 + delta * (uint32_t)n, &s, &co);
      ring_r[idx] = a * co - b * s;
      ring_i[idx] = a * s + b * co;
    }
    __syncthreads();

    // stage A: sample decim*M - k with k = decim*a + b lives in phase
    // row (decim - b) % decim at ring row M - a - (b > 0)
    const int M = t0 + tid;
    if (M < T_out) {
      float ar = 0.f, ai = 0.f;
      for (int b = 0; b < decim; ++b) {
        const int r = (decim - b) % decim;
        const float* rr = ring_r + r * QS;
        const float* ri = ring_i + r * QS;
        const int qb = M + QA - (b > 0 ? 1 : 0);
        int a = 0;
        for (int k = b; k < taps; k += decim, ++a) {
          const int q = (qb - a) & (QA - 1);
          const float hk = hs[k];
          if (MT) {         // complex taps hc + j hs on raw samples
            const float sk = hsn[k], vr = rr[q], vi = ri[q];
            ar = fmaf(hk, vr, ar);
            ar = fmaf(-sk, vi, ar);
            ai = fmaf(sk, vr, ai);
            ai = fmaf(hk, vi, ai);
          } else {
            ar = fmaf(hk, rr[q], ar);
            ai = fmaf(hk, ri[q], ai);
          }
        }
      }
      if (MT) {             // the absolute rotor at the decimated rate
        float s, co;
        rotor(ph0 + delta * (uint32_t)(M * decim), &s, &co);
        const float wr = ar, wi = ai;
        ar = wr * co - wi * s;
        ai = wr * s + wi * co;
      }
      zr[M & (RB - 1)] = ar;
      zi[M & (RB - 1)] = ai;
    }
    __syncthreads();

    // stage B: y_b[M] = Re(sum_k g_b[k] z[M-k]), one stage-A sample load
    // feeding every filter
    if (M < T_out) {
      float y[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) y[b] = 0.f;
      for (int k = 0; k < taps2; ++k) {
        const int p = (M - k) & (RB - 1);
        const float a = zr[p], q = zi[p];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          y[b] = fmaf(gr[b * taps2 + k], a, y[b]);
          y[b] = fmaf(-gi[b * taps2 + k], q, y[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b)
        out[((size_t)c * NB + b) * T_out + M] = y[b];
    }
    __syncthreads();
  }

  // new raw history: the last n_keep samples of (history ++ block),
  // scaled, before rotation
  for (int j = tid; j < n_keep; j += TT) {
    const int n = B - n_keep + j;
    float2 v;
    if (n >= 0) {
      v = make_float2(as_f32(xi[row + n]) * in_scale,
                      as_f32(xq[row + n]) * in_scale);
    } else {
      v = carry_in[(size_t)c * n_keep + (j + B)];
    }
    carry_out[(size_t)c * n_keep + j] = v;
  }
  // new stage-B history: the last n_hist2 stage-A outputs
  for (int j = tid; j < n_hist2; j += TT) {
    const int p = (T_out - n_hist2 + j) & (RB - 1);
    carry2_out[(size_t)c * n_hist2 + j] = make_float2(zr[p], zi[p]);
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

template <typename Tin, int NB, bool MT>
int launch(const void* xi, const void* xq, float in_scale, int C, int B,
           int n_keep, const void* carry_in, const void* carry2_in,
           const void* phase, uint32_t delta, const void* h, int taps,
           int decim, const void* h_sin, const void* g_re, const void* g_im,
           int taps2, void* out, void* carry_out, void* carry2_out,
           void* peaks, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * decim * QS + 2 * RB + (MT ? 2 : 1) * taps +
               2 * NB * taps2) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      front_kernel<Tin, NB, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  front_kernel<Tin, NB, MT><<<C, TT, smem, stream>>>(
      (const Tin*)xi, (const Tin*)xq, in_scale, B, n_keep,
      (const float2*)carry_in, (const float2*)carry2_in,
      (const int64_t*)phase, delta, (const float*)h, taps, decim,
      (const float*)h_sin, (const float*)g_re, (const float*)g_im, taps2,
      (float*)out, (float2*)carry_out, (float2*)carry2_out, (float*)peaks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile geometry the wrapper checks shapes against.
int uhsdr_front_tile() { return TT; }
int uhsdr_front_ring_rows() { return QA; }
int uhsdr_front_ring2() { return RB; }

// in_kind: 0 = int16 planes, 1 = float32 planes.  nb: 1 or 2 stage-B
// filters (g_re, g_im: nb rows of taps2; out: (C, nb, B/decim)).  The raw
// carry rows hold n_keep >= taps-1 samples.  h_sin: NULL for K1; for K15
// (nb 1 only) the modulated taps' sine part, h then their cosine part.
// Returns a cudaError_t.
int uhsdr_front_launch(int in_kind, const void* xi, const void* xq,
                       float in_scale, int C, int B, int n_keep,
                       const void* carry_in, const void* carry2_in,
                       const void* phase, unsigned int delta, const void* h,
                       int taps, int decim, const void* h_sin,
                       const void* g_re, const void* g_im, int taps2,
                       int nb, void* out,
                       void* carry_out, void* carry2_out, void* peaks,
                       void* stream) {
  using Launch = int (*)(const void*, const void*, float, int, int, int,
                         const void*, const void*, const void*, uint32_t,
                         const void*, int, int, const void*, const void*,
                         const void*, int, void*, void*, void*, void*,
                         cudaStream_t);
  // [in_kind][NB = 1, NB = 2, K15]
  static const Launch table[2][3] = {
      {launch<int16_t, 1, false>, launch<int16_t, 2, false>,
       launch<int16_t, 1, true>},
      {launch<float, 1, false>, launch<float, 2, false>,
       launch<float, 1, true>}};
  if (nb < 1 || nb > 2 || (h_sin != nullptr && nb != 1))
    return (int)cudaErrorInvalidValue;
  return table[in_kind != 0][h_sin != nullptr ? 2 : nb - 1](
      xi, xq, in_scale, C, B, n_keep, carry_in, carry2_in, phase, delta, h,
      taps, decim, h_sin, g_re, g_im, taps2, out, carry_out, carry2_out,
      peaks, (cudaStream_t)stream);
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
