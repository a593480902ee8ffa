// The LPC impulse noise blanker, hand-written for Hopper (sm_90a): the
// whole of nr/blanker.py::process_block in one kernel.  A helper kernel
// with no TPU counterpart: the JAX package runs the frames of a block as a
// lax.scan of array operations (uhsdr_tpu/nr/blanker.py:229-255).  Per
// channel and 128-sample frame (alt_noise_blanking, audio_nr.c:2210-2536),
// on the working buffer b = the 26 repaired samples carried from the last
// frame ++ the frame (154 samples):
//   R[i] = sum_n s[n] s[n+i] over s = b[13..140], i = 0..10;
//   Levinson-Durbin -> e = (1, a1..a10) (R[0] loaded by 1 + 1e-9, 1 in
//   f32);  d = (b[13..] * e reversed) * e, zero history, 128 samples;
//   thr = (16 - nb_setting)/2 sqrt(max(var(d, ddof 1) sum(e[0..9]^2),
//   1e-30));  candidates: |d| > thr, |d| the max of |d| within +-3, from
//   position 13 on, the first 5 by position;
//   for each of the 5 slots in order (a slot with no impulse at position
//   10, added with weight 0): the 7-sample window at the position is
//   repaired by the forward order-10 prediction from the 10 samples
//   before and the backward one from the 10 after, cross-faded, blended
//   into b as b (1 - m) + m rep (later windows overwrite earlier ones);
//   out = b[13..140] (a delay of 13), the next context b[128..153].
//
// Bound on this card: bytes.  At the SSB flagship (8192 ch x 2048 samples
// at 12 kHz) it reads and writes 134 MB, 0.04 ms at 3.35 TB/s; its work
// (~2,000 instructions a frame and channel, mostly scalar chains of the
// Levinson recursion and the repairs) makes it issue-bound here.
//
// Design: a warp a channel, four a block, the frames in order.  The
// working buffer, the whitened signal and the detection magnitudes live in
// the warp's shared memory.  A lane takes samples n = lane + 32 m (m = 0..3)
// of a frame: R, the mean and the variance are each lane's left fold of
// its four terms and a butterfly of shuffles (the plain version's
// trees.lane_sum); Levinson runs in every lane alike; the candidates are
// four ballots, their first five set bits the slots; lane 0 walks the
// forward prediction and lane 1 the backward one of each slot, and every
// lane blends its samples.  Compiled with -fmad=false so that every
// product and sum rounds as the plain version's do (cuda/blanker.py::
// blanker_plain): bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int FRAME = 128;
constexpr int ORDER = 10;
constexpr int ILEN = 7;
constexpr int PL = 3;
constexpr int NIMP = 5;
constexpr int CTX = 26;
constexpr int WB = CTX + FRAME;       // 154
constexpr int DELAY = 13;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BUF = 160;              // WB rounded to 32
constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  float b[BUF];          // working buffer
  float t1[FRAME];       // whitened
  float a[FRAME];        // |detection signal|
  float fwd[ILEN], bwd[ILEN];
};

__device__ __forceinline__ float max_nan(float x, float m) {
  return x != x ? x : fmaxf(x, m);
}
// the larger of two, a NaN if either is one (torch.maximum, jnp.maximum)
__device__ __forceinline__ float maxn(float x, float y) {
  return x != x ? x : (y != y ? y : fmaxf(x, y));
}

__device__ __forceinline__ float tree(float v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) v = v + __shfl_xor_sync(FULL, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS) blanker_kernel(
    const float* __restrict__ x, const float* __restrict__ ctx_in, int C,
    int T, float mult, float* __restrict__ y, float* __restrict__ ctx_out) {
  __shared__ Smem sm_all[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + warp;
  if (c >= C) return;
  Smem& sm = sm_all[warp];
  float* b = sm.b;
  if (lane < CTX) b[lane] = ctx_in[(size_t)c * CTX + lane];
  const float* xr = x + (size_t)c * T;
  float* yr = y + (size_t)c * T;
  const int nfr = T / FRAME;
  for (int f = 0; f < nfr; ++f) {
#pragma unroll
    for (int m = 0; m < 4; ++m) b[CTX + lane + 32 * m] = xr[f * FRAME + lane + 32 * m];
    __syncwarp();
    const float* s = b + DELAY;
    // autocorrelation
    float R[ORDER + 1];
#pragma unroll
    for (int i = 0; i <= ORDER; ++i) {
      float p = 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int n = lane + 32 * m;
        const float t = n + i < FRAME ? s[n] * s[n + i] : 0.f;
        p = m == 0 ? t : p + t;
      }
      R[i] = tree(p);
    }
    // Levinson-Durbin, every lane alike
    float e[ORDER + 1];
    e[0] = 1.f;
#pragma unroll
    for (int i = 1; i <= ORDER; ++i) e[i] = 0.f;
    float alfa = R[0] * 1.0f;
#pragma unroll
    for (int mm = 1; mm <= ORDER; ++mm) {
      float sum = R[mm];
#pragma unroll
      for (int i = 1; i < mm; ++i) sum = sum + e[i] * R[mm - i];
      const float k = -sum / max_nan(alfa, 1e-30f);
      float na[ORDER + 1];
#pragma unroll
      for (int i = 1; i < mm; ++i) na[i] = e[i] + k * e[mm - i];
#pragma unroll
      for (int i = 1; i < mm; ++i) e[i] = na[i];
      e[mm] = k;
      alfa = alfa * (1.f - k * k);
    }
    // whitening (e reversed), then the matched filter (e), zero history
    float d[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int n = lane + 32 * m;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k <= ORDER; ++k)
        acc = acc + e[ORDER - k] * (n - k >= 0 ? s[n - k] : 0.f);
      sm.t1[n] = acc;
    }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int n = lane + 32 * m;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k <= ORDER; ++k)
        acc = acc + e[k] * (n - k >= 0 ? sm.t1[n - k] : 0.f);
      d[m] = acc;
      sm.a[n] = fabsf(acc);
    }
    const float mean = tree(((d[0] + d[1]) + d[2]) + d[3]) * (1.f / FRAME);
    float v = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float u = d[m] - mean;
      v = m == 0 ? u * u : v + u * u;
    }
    const float sigma2 = tree(v) / (float)(FRAME - 1);
    float lpc = e[0] * e[0];
#pragma unroll
    for (int k = 1; k < ORDER; ++k) lpc = lpc + e[k] * e[k];
    const float thr = mult * sqrtf(max_nan(sigma2 * lpc, 1e-30f));
    __syncwarp();
    // candidates: above threshold, the max within +-3, from 13 on
    unsigned bits[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int n = lane + 32 * m;
      const float an = sm.a[n];
      float mx = an;
#pragma unroll
      for (int q = 1; q <= PL; ++q) {
        const float l = n - q >= 0 ? sm.a[n - q] : 0.f;
        const float r = n + q < FRAME ? sm.a[n + q] : 0.f;
        mx = maxn(mx, maxn(l, r));
      }
      bits[m] = __ballot_sync(FULL, (an > thr) & (an >= mx) & (n >= DELAY));
    }
    int slot[NIMP];
    int found = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      unsigned bm = bits[m];
      while (bm && found < NIMP) {
        const int bit = __ffs(bm) - 1;
        slot[found++] = 32 * m + bit;
        bm &= bm - 1;
      }
    }
    // the repairs, slot by slot
    float af[ORDER];
#pragma unroll
    for (int j = 0; j < ORDER; ++j) af[j] = -e[j + 1];
#pragma unroll
    for (int k = 0; k < NIMP; ++k) {
      const bool ok = k < found;
      const int st = ok ? slot[k] : ORDER;
      if (lane == 0) {
        float cx[ORDER];
#pragma unroll
        for (int j = 0; j < ORDER; ++j) cx[j] = b[st - ORDER + j];
#pragma unroll
        for (int q = 0; q < ILEN; ++q) {
          float nxt = cx[ORDER - 1] * af[0];
#pragma unroll
          for (int j = 1; j < ORDER; ++j) nxt = nxt + cx[ORDER - 1 - j] * af[j];
#pragma unroll
          for (int j = 0; j < ORDER - 1; ++j) cx[j] = cx[j + 1];
          cx[ORDER - 1] = nxt;
          sm.fwd[q] = nxt;
        }
      } else if (lane == 1) {
        float cx[ORDER];
#pragma unroll
        for (int j = 0; j < ORDER; ++j) cx[j] = b[st + ILEN + j];
#pragma unroll
        for (int q = 0; q < ILEN; ++q) {
          float nxt = cx[0] * af[0];
#pragma unroll
          for (int j = 1; j < ORDER; ++j) nxt = nxt + cx[j] * af[j];
#pragma unroll
          for (int j = ORDER - 1; j > 0; --j) cx[j] = cx[j - 1];
          cx[0] = nxt;
          sm.bwd[ILEN - 1 - q] = nxt;
        }
      }
      __syncwarp();
      const float okf = ok ? 1.f : 0.f;
#pragma unroll
      for (int m = 0; m < 5; ++m) {
        const int n = lane + 32 * m;
        if (n < WB) {
          const int i = n - st;
          const bool win = i >= 0 && i < ILEN;
          float mk = 0.f, vl = 0.f;
          if (win) {
            const float w = (float)i / 6.f;
            const float rep = (1.f - w) * sm.fwd[i] + w * sm.bwd[i];
            mk = okf;
            vl = okf * rep;
          }
          b[n] = b[n] * (1.f - mk) + vl;
        }
      }
      __syncwarp();
    }
    // the delayed frame out, the repaired tail on as the next context
#pragma unroll
    for (int m = 0; m < 4; ++m)
      yr[f * FRAME + lane + 32 * m] = b[DELAY + lane + 32 * m];
    const float keep = lane < CTX ? b[FRAME + lane] : 0.f;
    __syncwarp();
    if (lane < CTX) b[lane] = keep;
    __syncwarp();
  }
  if (lane < CTX) ctx_out[(size_t)c * CTX + lane] = b[lane];
}

}  // namespace

extern "C" {

// x: (C, T) f32, T a positive multiple of 128; ctx_in: (C, 26) f32; mult:
// (16 - nb_setting) / 2.  y: (C, T) out, ctx_out: (C, 26) out.  Returns a
// cudaError_t.
int uhsdr_blanker_launch(const void* x, const void* ctx_in, int C, int T,
                         float mult, void* y, void* ctx_out, void* stream) {
  blanker_kernel<<<(C + WARPS - 1) / WARPS, THREADS, 0,
                   (cudaStream_t)stream>>>(
      (const float*)x, (const float*)ctx_in, C, T, mult, (float*)y,
      (float*)ctx_out);
  return (int)cudaGetLastError();
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
