// The spectral NR's gain machine, hand-written for Hopper (sm_90a):
// everything of nr/spectral.py::process_block between the forward and the
// inverse FFT, in one kernel.  A helper kernel with no TPU counterpart: the
// JAX package walks the frames as a lax.scan of elementwise operations and
// smooths and applies the gains as array operations (uhsdr_tpu/nr/
// spectral.py:148-256).  Per channel, frame by frame, per bin b < 128 of
// the frame's 256-point spectrum F (spectral_noise_reduction_3,
// audio_nr.c:1841-2180):
//   X = |F|^2;  while booting (init_count < 20): nest_acc += 0.05 X,
//   xt = 0.5 nest_acc;
//   ph1y = 1 / (1 + pfac exp(xih1r X / max(xt, 1e-20)));
//   pslp = ap pslp + (1 - ap) ph1y (frozen while booting);
//   ph1y = pslp > 0.99 ? 0.99 : min(ph1y, 1);
//   xt = ax xt + (1 - ax)((1 - ph1y) X + ph1y xt) (frozen while booting);
//   post = clip(X / max(xt, 1e-20), 0.001, 1000),
//   prio = max(alpha hk_old + (1 - alpha) max(post - 1, 0), 0),
//   v = prio post / (1 + prio), hk = max(sqrt(0.7212 v + v^2) / post,
//   0.001) in the band [lo, hi), else 1;  hk_old = post hk^2 (in the band,
//   not booting);
//   the musical-noise smoothing: ratio = sum(hk^2 X) / max(sum X, 1e-20)
//   over the band; where ratio <= thr, w = (int)(0.5 + 4 (1 - ratio/thr))
//   and the bins of [lo + w, hi - w) take the mean of hk over [b-w, b+w];
//   while booting the gains are 1;  F *= gain (bin 128 times 1), in place.
//
// Bound on this card: bytes.  At the SSB flagship (8192 ch x 16 frames of
// 129 complex bins) it reads and writes F, 271 MB, 0.081 ms at 3.35 TB/s;
// the recurrence is ~60 FP32 operations a bin and frame, 1.0 GFLOP.
//
// Design: a block a channel, a thread a bin (128), the carried state in
// registers, the frames in order.  The band sums are each warp's xor
// butterfly of shuffles and the four warps' sums added in pairs (the
// pairwise tree over the 128 bins of cuda/trees.py::pair_tree); the
// moving average reads its neighbours' gains from shared memory, a left
// fold from the lowest bin.  Compiled with -fmad=false so that every
// product and sum rounds as the plain version's do (cuda/nr.py::
// nr_gains_plain): bit for bit where this card's expf and hypotf give
// torch's exp and abs.
#include <cuda_runtime.h>

namespace {

constexpr int NB = 128;
constexpr int NBIN = NB + 1;
constexpr int THREADS = NB;
constexpr int MNW = 4;
constexpr int INIT_FRAMES = 20;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  float2* F;
  int C, nF;
  const float *xt, *pslp, *hk_old, *nest_acc;
  const int* cnt;
  int lo, hi;
  float alpha, one_m_alpha, thr, xih1r, pfac;
  float inv_nn[MNW];
  float *xt_out, *pslp_out, *hk_out, *acc_out;
  int* cnt_out;
};

__device__ __forceinline__ float min_nan(float x, float m) {
  return x != x ? x : fminf(x, m);
}
__device__ __forceinline__ float max_nan(float x, float m) {
  return x != x ? x : fmaxf(x, m);
}

__device__ __forceinline__ float tree(float v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) v = v + __shfl_xor_sync(FULL, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS) nr_kernel(Args a) {
  __shared__ float hks[NB];
  __shared__ float sums[2][NB / 32];
  const int c = blockIdx.x, b = threadIdx.x;
  const int warp = b >> 5, lane = b & 31;
  const size_t sidx = (size_t)c * NB + b;
  float xt = a.xt[sidx], pslp = a.pslp[sidx], hk_old = a.hk_old[sidx];
  float acc = a.nest_acc[sidx];
  int cnt = a.cnt[c];
  const bool band = b >= a.lo && b < a.hi;
  for (int f = 0; f < a.nF; ++f) {
    float2* Fr = a.F + ((size_t)c * a.nF + f) * NBIN;
    const float2 z = Fr[b];
    const float mag = hypotf(z.x, z.y);
    const float X = mag * mag;
    const bool booting = cnt < INIT_FRAMES;
    if (booting) {
      acc = acc + 0.05f * X;
      xt = 0.5f * acc;
    }
    float ph1y = 1.0f / (1.0f + a.pfac * expf(a.xih1r * X / max_nan(xt, 1e-20f)));
    if (!booting) pslp = 0.8691f * pslp + 0.1309f * ph1y;
    ph1y = pslp > 0.99f ? 0.99f : min_nan(ph1y, 1.0f);
    const float xtr = (1.0f - ph1y) * X + ph1y * xt;
    const float xt_new = 0.7405f * xt + 0.2595f * xtr;
    if (!booting) xt = xt_new;
    const float post = min_nan(max_nan(X / max_nan(xt, 1e-20f), 0.001f),
                               1000.0f);
    const float prio = max_nan(
        a.alpha * hk_old + a.one_m_alpha * max_nan(post - 1.0f, 0.0f), 0.0f);
    const float v = prio * post / (1.0f + prio);
    const float hk_band = max_nan(sqrtf(0.7212f * v + v * v) / post, 0.001f);
    const float hk = band ? hk_band : 1.0f;
    if (!booting && band) hk_old = post * hk * hk;
    cnt = cnt + 1;
    // the band's power before and after the gain
    const float pre_s = tree(band ? X : 0.0f);
    const float post_s = tree(band ? hk * hk * X : 0.0f);
    if (lane == 0) {
      sums[0][warp] = pre_s;
      sums[1][warp] = post_s;
    }
    hks[b] = hk;
    __syncthreads();
    const float pre = (sums[0][0] + sums[0][1]) + (sums[0][2] + sums[0][3]);
    const float pst = (sums[1][0] + sums[1][1]) + (sums[1][2] + sums[1][3]);
    const float ratio = pst / max_nan(pre, 1e-20f);
    const int nn = ratio <= a.thr
                       ? (int)(0.5f + 4.0f * (1.0f - ratio / a.thr)) : 0;
    float g = hk;
    if (nn > 0 && b >= a.lo + nn && b < a.hi - nn) {
      const float inv = a.inv_nn[nn - 1];
      float s = hks[b - nn] * inv;
      for (int j = -nn + 1; j <= nn; ++j) s = s + hks[b + j] * inv;
      g = s;
    }
    if (booting) g = 1.0f;
    Fr[b] = make_float2(z.x * g - z.y * 0.0f, z.x * 0.0f + z.y * g);
    if (b == 0) {
      const float2 zn = Fr[NB];
      Fr[NB] = make_float2(zn.x * 1.0f - zn.y * 0.0f, zn.x * 0.0f + zn.y * 1.0f);
    }
    __syncthreads();
  }
  a.xt_out[sidx] = xt;
  a.pslp_out[sidx] = pslp;
  a.hk_out[sidx] = hk_old;
  a.acc_out[sidx] = acc;
  if (b == 0) a.cnt_out[c] = cnt;
}

}  // namespace

extern "C" {

// F: (C, nF, 129) complex64, weighted in place.  xt, pslp, hk_old,
// nest_acc: (C, 128) f32; cnt: (C,) int32; lo, hi: the band's bins; then
// alpha, 1 - alpha, the power threshold, xih1r, pfac, 1/3, 1/5, 1/7, 1/9
// (f32).  The new state to the five outputs.  Returns a cudaError_t.
int uhsdr_nr_launch(void* F, int C, int nF, const void* xt, const void* pslp,
                    const void* hk_old, const void* nest_acc, const void* cnt,
                    int lo, int hi, float alpha, float one_m_alpha, float thr,
                    float xih1r, float pfac, float i3, float i5, float i7,
                    float i9, void* xt_out, void* pslp_out, void* hk_out,
                    void* acc_out, void* cnt_out, void* stream) {
  Args a;
  a.F = (float2*)F;
  a.C = C;
  a.nF = nF;
  a.xt = (const float*)xt;
  a.pslp = (const float*)pslp;
  a.hk_old = (const float*)hk_old;
  a.nest_acc = (const float*)nest_acc;
  a.cnt = (const int*)cnt;
  a.lo = lo;
  a.hi = hi;
  a.alpha = alpha;
  a.one_m_alpha = one_m_alpha;
  a.thr = thr;
  a.xih1r = xih1r;
  a.pfac = pfac;
  a.inv_nn[0] = i3;
  a.inv_nn[1] = i5;
  a.inv_nn[2] = i7;
  a.inv_nn[3] = i9;
  a.xt_out = (float*)xt_out;
  a.pslp_out = (float*)pslp_out;
  a.hk_out = (float*)hk_out;
  a.acc_out = (float*)acc_out;
  a.cnt_out = (int*)cnt_out;
  nr_kernel<<<C, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
