// K12, the FM discriminator, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel uhsdr_tpu/pallas/elemwise.py::_disc_kernel (:25,
// via fm_disc_pallas :41, called at demod/fm.py:155).  Per channel c and
// sample n, with z_d[n] = z[n-1] and z_d[0] the carried sample z_prev[c]
// (AudioDriver_DemodFM, audio_driver.c:1544-1737):
//   re = zr_d*zr + zi_d*zi,  im = zr_d*zi - zi_d*zr    (conj(z_d) * z)
//   out = atan2f(im, re)
// The TPU kernel carries a polynomial atan2 (its compiler has none); this
// one calls atan2f, so its plain version is the CPU reference's arithmetic
// (torch.atan2 of the same product).  Compiled without fast-math and with
// -fmad=false, so the products and sums are separate f32 operations as in
// the plain version.
//
// Bound on this card: bytes.  At the FM flagship (8192 ch x 8192 samples
// of complex64 in, f32 out) it moves 805 MB, 0.24 ms at 3.35 TB/s; the
// arithmetic (~40 FP32 operations a sample for the product and atan2f)
// is 2.7 G operations, 0.04 ms at 67 TFLOP/s.
//
// Design: one thread a sample, a 2-D grid (time tiles x channels).  A
// warp reads 32 consecutive samples with 8-byte loads (interleaved input)
// or two 4-byte loads (planes); the one-sample-delayed operand is the
// neighbour's word, served from L1, so device memory sees each input byte
// once.  Output stores are coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

template <bool PLANES>
__device__ __forceinline__ float2 load(const float* a, const float* b,
                                       size_t i) {
  if (PLANES) return make_float2(a[i], b[i]);
  return reinterpret_cast<const float2*>(a)[i];
}

template <bool PLANES>
__global__ void __launch_bounds__(THREADS) fm_disc_kernel(
    const float* __restrict__ za, const float* __restrict__ zb,
    const float2* __restrict__ z_prev, int C, int T,
    float* __restrict__ out) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= T) return;
  for (int c = blockIdx.y; c < C; c += gridDim.y) {
    const size_t i = (size_t)c * T + n;
    const float2 z = load<PLANES>(za, zb, i);
    const float2 d = n > 0 ? load<PLANES>(za, zb, i - 1) : z_prev[c];
    const float re = d.x * z.x + d.y * z.y;
    const float im = d.x * z.y - d.y * z.x;
    out[i] = atan2f(im, re);
  }
}

}  // namespace

extern "C" {

// in_kind: 0 = one interleaved complex64 array (za; zb unused), 1 = two
// f32 planes (za real, zb imaginary).  z_prev: (C,) complex64.  out:
// (C, T) f32.  Returns a cudaError_t.
int uhsdr_fm_disc_launch(int in_kind, const void* za, const void* zb,
                         const void* z_prev, int C, int T, void* out,
                         void* stream) {
  const dim3 grid((T + THREADS - 1) / THREADS, C < MAX_GRID_Y ? C
                                                             : MAX_GRID_Y);
  if (in_kind == 0) {
    fm_disc_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)za, nullptr, (const float2*)z_prev, C, T,
        (float*)out);
  } else {
    fm_disc_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)za, (const float*)zb, (const float2*)z_prev, C, T,
        (float*)out);
  }
  return (int)cudaGetLastError();
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
