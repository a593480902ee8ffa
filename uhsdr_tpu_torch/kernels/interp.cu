// K4, the polyphase interpolator, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel uhsdr_tpu/pallas/fir.py::_interp_kernel
// (fir_interpolate_pallas, chain/rx.py:1103):
//   y[c, m*interp + p] = sum_k hpoly[k, p] * x[c, m - k],
//   hpoly[k, p] = h[k*interp + p], k < sub_len = ceil(taps/interp),
// with the sub_len-1 carried low-rate samples standing in for x[c, m<0]
// (ops/fir.py:191-215's streaming phase).
//
// Bound on this card: bytes.  At 8192 ch x 2048 -> 16384 samples it
// reads 64 MiB and writes 512 MiB; the 12-tap dot products are ~0.05 ms
// of FP32 work.  Design: blocks are independent (each reads its own
// left halo from x or the carry, so no block order is needed); a block
// stages CHUNK low-rate samples of one channel in shared memory and its
// threads each write 4 consecutive outputs as one 16-byte store, so
// neighbouring threads write neighbouring addresses.  Where interp is no
// multiple of 4 (the x2 of the 48 kHz decimation-2 paths) four outputs
// would straddle low-rate samples, and each thread writes one output.
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 1024;     // low-rate samples per block
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) interp_kernel(
    const float* __restrict__ x, const float* __restrict__ carry, int B,
    const float* __restrict__ h, int taps, int interp, int sub_len,
    int n_chunk, float* __restrict__ y, float* __restrict__ carry_out) {
  extern __shared__ float smem[];
  float* hp = smem;                          // sub_len * interp
  float* xs = hp + sub_len * interp;         // (sub_len - 1) + CHUNK
  const int c = blockIdx.x / n_chunk;
  const int m0 = (blockIdx.x % n_chunk) * CHUNK;
  const int tid = threadIdx.x;
  const int nh = sub_len - 1;
  const int cnt = min(CHUNK, B - m0);

  for (int k = tid; k < sub_len * interp; k += THREADS)
    hp[k] = k < taps ? h[k] : 0.f;
  for (int j = tid; j < nh + cnt; j += THREADS) {
    const int m = m0 - nh + j;
    xs[j] = m >= 0 ? x[(size_t)c * B + m] : carry[(size_t)c * nh + m + nh];
  }
  __syncthreads();

  float* yrow = y + ((size_t)c * B + m0) * interp;
  if (interp % 4 != 0) {
    for (int o = tid; o < cnt * interp; o += THREADS) {
      const int m = o / interp;
      const int p = o - m * interp;
      float acc = 0.f;
      for (int k = 0; k < sub_len; ++k)
        acc = fmaf(hp[k * interp + p], xs[nh + m - k], acc);
      yrow[o] = acc;
    }
  }
  const int n4 = interp % 4 == 0 ? cnt * interp / 4 : 0;
  for (int o4 = tid; o4 < n4; o4 += THREADS) {
    const int o = o4 * 4;
    const int m = o / interp;
    const int p = o - m * interp;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < sub_len; ++k) {
      const float xv = xs[nh + m - k];
      const float* hk = hp + k * interp + p;
      acc.x = fmaf(hk[0], xv, acc.x);
      acc.y = fmaf(hk[1], xv, acc.y);
      acc.z = fmaf(hk[2], xv, acc.z);
      acc.w = fmaf(hk[3], xv, acc.w);
    }
    *reinterpret_cast<float4*>(yrow + o) = acc;
  }

  // new history: the last sub_len-1 samples of (carry ++ x)
  if (m0 + cnt == B) {
    for (int j = tid; j < nh; j += THREADS) {
      const int m = B - nh + j;
      carry_out[(size_t)c * nh + j] =
          m >= 0 ? x[(size_t)c * B + m] : carry[(size_t)c * nh + m + nh];
    }
  }
}

}  // namespace

extern "C" {

// Requires interp >= 1.  Returns a cudaError_t.
int uhsdr_interp_launch(const void* x, const void* carry, int C, int B,
                        const void* h, int taps, int interp, void* y,
                        void* carry_out, void* stream) {
  const int sub_len = (taps + interp - 1) / interp;
  const int n_chunk = (B + CHUNK - 1) / CHUNK;
  const size_t smem =
      (size_t)(sub_len * interp + sub_len - 1 + CHUNK) * sizeof(float);
  interp_kernel<<<C * n_chunk, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)carry, B, (const float*)h, taps, interp,
      sub_len, n_chunk, (float*)y, (float*)carry_out);
  return (int)cudaGetLastError();
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
