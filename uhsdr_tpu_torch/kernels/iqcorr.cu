// Automatic IQ imbalance correction, hand-written for Hopper (sm_90a): the
// whole of ops/iqcorr.py::correct in one kernel.  A helper kernel with no
// TPU counterpart: the JAX package forms the sub-block sums as array
// reductions and walks the one-poles as a lax.scan
// (uhsdr_tpu/ops/iqcorr.py:56-101).  Per channel, in 32-sample sub-blocks
// j (the firmware's AudioDriver_RxHandleIqCorrection, audio_driver.c:
// 2254-2316, Moseley-Slump):
//   a1 = sum(sign(i) q)/32, a2 = sum|i|/32, a3 = sum|q|/32
//   t1 = -0.003 a1 + 0.997 t1, t2 = 0.003 a2 + 0.997 t2, t3 likewise
//   c1 = nz t1 t2 / (t2^2 + 1e-20),  h = (t3^2 - t1^2) / (t2^2 + 1e-20)
//   c2 = hp sqrt(max(h, 1e-20)) + (1 - hp)   (nz = |t2| > 1e-20,
//                                             hp = (h > 0) nz, as floats)
//   q' = q + c1 i, then i' = i c2            (the firmware's order)
// int16 planes are scaled by 1/32768 first.  The state is t1..t3, the last
// sub-block's c1 and c2, and the twin-peaks flag
// (t2 > 1e-6) & (|t1| / max(t2, 1e-12) > 0.45).
//
// Bound on this card: bytes.  At the SSB flagship (8192 ch x 16384 int16)
// it reads 0.54 GB and writes 1.07 GB of f32 planes, 0.48 ms at 3.35
// TB/s.  The walk is three one-poles a sub-block, 512 steps a channel.
//
// Design: a block a channel, 8 warps, the block's sub-blocks in chunks of
// CHUNK.  Each warp takes whole sub-blocks (32 samples: one a lane) and
// forms the three sums by an xor butterfly of shuffles, the pairwise tree
// of the plain version (cuda/trees.py::pair_tree); thread 0 walks the
// one-poles over the chunk (two dependent operations a step); every
// thread then forms c1 and c2 for its sub-blocks; the warps read their
// sub-blocks again (from L2) and store the corrected planes.  Compiled
// with -fmad=false so that every product and sum rounds as the plain
// version's do (cuda/iqcorr.py::iqcorr_plain): bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int SUB = 32;
constexpr int CHUNK = 256;          // sub-blocks a chunk
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load(const void* p, size_t k, bool i16) {
  if (i16) return (float)((const int16_t*)p)[k] * 3.0517578125e-05f;
  return ((const float*)p)[k];
}

// max(x, m) with the NaN of x kept, as torch.clamp_min and jnp.maximum
__device__ __forceinline__ float max_nan(float x, float m) {
  return x != x ? x : fmaxf(x, m);
}

__device__ __forceinline__ float tree(float v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) v = v + __shfl_xor_sync(FULL, v, off);
  return v;
}

template <bool I16>
__global__ void __launch_bounds__(THREADS) iqcorr_kernel(
    const void* __restrict__ ip, const void* __restrict__ qp,
    const float* __restrict__ t1_in, const float* __restrict__ t2_in,
    const float* __restrict__ t3_in, int T, float* __restrict__ io,
    float* __restrict__ qo, float* __restrict__ t1_out,
    float* __restrict__ t2_out, float* __restrict__ t3_out,
    float* __restrict__ c1_out, float* __restrict__ c2_out,
    unsigned char* __restrict__ twin_out) {
  __shared__ float s1[CHUNK], s2[CHUNK], s3[CHUNK];
  const int c = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nsub = T / SUB;
  const size_t row = (size_t)c * T;
  float t1 = 0.f, t2 = 0.f, t3 = 0.f;
  if (tid == 0) {
    t1 = t1_in[c];
    t2 = t2_in[c];
    t3 = t3_in[c];
  }
  for (int base = 0; base < nsub; base += CHUNK) {
    const int n = min(CHUNK, nsub - base);
    // the three sums of each sub-block
    for (int j = warp; j < n; j += WARPS) {
      const size_t k = row + (size_t)(base + j) * SUB + lane;
      const float x = load(ip, k, I16), y = load(qp, k, I16);
      const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
      const float a1 = tree(s * y), a2 = tree(fabsf(x)), a3 = tree(fabsf(y));
      if (lane == 0) {
        s1[j] = a1 * 0.03125f;
        s2[j] = a2 * 0.03125f;
        s3[j] = a3 * 0.03125f;
      }
    }
    __syncthreads();
    // the block-cadence one-poles, in order
    if (tid == 0) {
      for (int j = 0; j < n; ++j) {
        t1 = -0.003f * s1[j] + 0.997f * t1;
        t2 = 0.003f * s2[j] + 0.997f * t2;
        t3 = 0.003f * s3[j] + 0.997f * t3;
        s1[j] = t1;
        s2[j] = t2;
        s3[j] = t3;
      }
    }
    __syncthreads();
    // c1 and c2 of each sub-block, in place of t1 and t2
    for (int j = tid; j < n; j += THREADS) {
      const float u1 = s1[j], u2 = s2[j], u3 = s3[j];
      const float nz = fabsf(u2) > 1e-20f ? 1.f : 0.f;
      const float den = u2 * u2 + 1e-20f;
      const float c1 = nz * u1 * u2 / den;
      const float h = (u3 * u3 - u1 * u1) / den;
      const float hp = (h > 0.f ? 1.f : 0.f) * nz;
      const float c2 = hp * sqrtf(max_nan(h, 1e-20f)) + (1.f - hp);
      s1[j] = c1;
      s2[j] = c2;
      if (base + j == nsub - 1) {
        c1_out[c] = c1;
        c2_out[c] = c2;
      }
    }
    __syncthreads();
    // the corrected planes: q += c1 i, then i *= c2
    for (int j = warp; j < n; j += WARPS) {
      const size_t k = row + (size_t)(base + j) * SUB + lane;
      const float x = load(ip, k, I16), y = load(qp, k, I16);
      const float c1 = s1[j], c2 = s2[j];
      qo[k] = y + c1 * x;
      io[k] = x * c2;
    }
    __syncthreads();
  }
  if (tid == 0) {
    t1_out[c] = t1;
    t2_out[c] = t2;
    t3_out[c] = t3;
    const float pe = fabsf(t1) / max_nan(t2, 1e-12f);
    twin_out[c] = (t2 > 1e-6f) & (pe > 0.45f);
  }
}

}  // namespace

extern "C" {

// i16: 1 = int16 planes (scaled by 1/32768), 0 = f32 planes.  ip, qp:
// (C, T), T a positive multiple of 32; t1..t3: (C,) f32; io, qo: (C, T)
// f32 out; t1..t3, c1, c2 out (C,) f32; twin out (C,) bytes (0/1).
// Returns a cudaError_t.
int uhsdr_iqcorr_launch(int i16, const void* ip, const void* qp,
                        const void* t1, const void* t2, const void* t3,
                        int C, int T, void* io, void* qo, void* t1o,
                        void* t2o, void* t3o, void* c1o, void* c2o,
                        void* twin, void* stream) {
  auto k = i16 ? iqcorr_kernel<true> : iqcorr_kernel<false>;
  k<<<C, THREADS, 0, (cudaStream_t)stream>>>(
      ip, qp, (const float*)t1, (const float*)t2, (const float*)t3, T,
      (float*)io, (float*)qo, (float*)t1o, (float*)t2o, (float*)t3o,
      (float*)c1o, (float*)c2o, (unsigned char*)twin);
  return (int)cudaGetLastError();
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
