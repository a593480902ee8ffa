// The FM modulator of the reference-table TX chain (mod/modulators.py::
// fm_modulate with table_quant), hand-written for Hopper (sm_90a).  A
// helper kernel with no TPU counterpart: the JAX package runs the
// pre-emphasis and the phase accumulator as two lax.scans
// (uhsdr_tpu/mod/modulators.py:244-340), the firmware's TxProcessor_FM
// (tx_processor.c:534-600).  Per channel and sample:
//   b = alpha * ((b + x) - a); a = x          (the 6 dB/oct pre-emphasis)
//   pre = b [+ add]                           (the subaudible tone, a plane
//                                              made in torch, when set)
//   r = word + pre * scale                    (a multiply, then an add)
//   s = floor(acc + r)
//   acc = s - 65536 floor(s / 65536)          (floor-mod 2^16, exact: r
//                                              may be negative)
//   k = floor(acc / 64)                       (the 10-bit DDS table index)
//   i = SIN[k], q = NEGCOS[k], swapped for a negative translate, each
//   times FM_MOD_AMPLITUDE_SCALING; a NaN accumulator gives NaN i and q
// The table is the firmware's 1024-entry DDS grid, made in torch from the
// plain version's f32 expressions.  The state is a (the last input), b
// and the accumulator as an int32 (a NaN accumulator stores 0).
//
// Bound on this card: bytes.  At the TX flagship (8192 ch x 16384 f32)
// it reads 0.54 GB and writes 1.07 GB, 0.48 ms at 3.35 TB/s.  The
// accumulator is a chain of 6 dependent FP32 operations a sample (the
// add, floor, the scaling, floor, the product, the difference;
// cuda/fm_mod.py::FM_MOD_STEP_CHAIN), 0.20 ms for 16384 samples at
// 1.98 GHz; the pre-emphasis' chain of 3 runs beside it.
//
// Design: as kernels/lattice.cu, a lane a channel and a warp a block; the
// warp moves 32 channels through shared memory in tiles of 32 samples
// (loaded and stored a 128-byte line at a time, read transposed, the next
// tile's loads in flight in registers), and the table sits in shared
// memory.  Compiled with -fmad=false so that every product and sum rounds
// as the plain version's (cuda/fm_mod.py::fm_mod_plain): bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int TABLE = 1024;

struct ModParams {
  float alpha, word, scale, amp;
  int swap;
};

template <bool ADD>
__global__ void __launch_bounds__(TILE) fm_mod_kernel(
    const float* __restrict__ x, const float* __restrict__ add,
    const float* __restrict__ a_in, const float* __restrict__ b_in,
    const int32_t* __restrict__ acc_in, const float* __restrict__ table,
    int C, int T, float* __restrict__ io, float* __restrict__ qo,
    float* __restrict__ a_out, float* __restrict__ b_out,
    int32_t* __restrict__ acc_out, const ModParams p) {
  __shared__ float tx[TILE][TILE + 1];
  __shared__ float tq[TILE][TILE + 1];
  __shared__ float ta[ADD ? TILE : 1][TILE + 1];
  __shared__ float tsin[TABLE];
  __shared__ float tcos[TABLE];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * TILE;
  const int row = row0 + lane;
  const int nrows = min(TILE, C - row0);
  for (int k = lane; k < TABLE; k += TILE) {
    tsin[k] = table[k];
    tcos[k] = table[TABLE + k];
  }
  float a = 0.f, b = 0.f, acc = 0.f;
  if (row < C) {
    a = a_in[row];
    b = b_in[row];
    acc = (float)acc_in[row];
  }
  float nx[TILE], na[ADD ? TILE : 1];
#pragma unroll
  for (int r = 0; r < TILE; ++r) {
    const bool ok = r < nrows && lane < T;
    const size_t k = (size_t)(row0 + r) * T + lane;
    nx[r] = ok ? x[k] : 0.f;
    if constexpr (ADD) na[r] = ok ? add[k] : 0.f;
  }
  for (int t0 = 0; t0 < T; t0 += TILE) {
    __syncwarp();
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      tx[r][lane] = nx[r];
      if constexpr (ADD) ta[r][lane] = na[r];
    }
    __syncwarp();
    const int tn = t0 + TILE + lane;
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      const bool ok = r < nrows && tn < T;
      const size_t k = (size_t)(row0 + r) * T + tn;
      nx[r] = ok ? x[k] : 0.f;
      if constexpr (ADD) na[r] = ok ? add[k] : 0.f;
    }
    const int nt = min(TILE, T - t0);
#pragma unroll 4
    for (int j = 0; j < nt; ++j) {
      const float xn = tx[lane][j];
      b = p.alpha * ((b + xn) - a);
      a = xn;
      float pre = b;
      if constexpr (ADD) pre = pre + ta[lane][j];
      const float r = p.word + pre * p.scale;
      const float s = floorf(acc + r);
      acc = s - 65536.f * floorf(s * (1.f / 65536.f));
      float iv, qv;
      if (acc != acc) {
        iv = qv = __int_as_float(0x7fc00000);
      } else {
        const int k = (int)floorf(acc * (1.f / 64.f));
        iv = tsin[k];
        qv = tcos[k];
      }
      if (p.swap) {
        const float t = iv;
        iv = qv;
        qv = t;
      }
      tx[lane][j] = iv * p.amp;
      tq[lane][j] = qv * p.amp;
    }
    __syncwarp();
    const int t = t0 + lane;
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      if (r < nrows && t < T) {
        const size_t k = (size_t)(row0 + r) * T + t;
        io[k] = tx[r][lane];
        qo[k] = tq[r][lane];
      }
    }
  }
  if (row < C) {
    a_out[row] = a;
    b_out[row] = b;
    acc_out[row] = acc != acc ? 0 : (int32_t)acc;
  }
}

}  // namespace

extern "C" {

int uhsdr_fm_mod_tile() { return TILE; }
int uhsdr_fm_mod_table() { return TABLE; }

// x: (C, T) f32 audio; add: (C, T) f32 or null; a_in, b_in: (C,) f32;
// acc_in: (C,) int32; table: (2, 1024) f32 [sin; -cos] on the card; io,
// qo: (C, T) f32 out; a_out, b_out: (C,) f32 out; acc_out: (C,) int32
// out.  Returns a cudaError_t.
int uhsdr_fm_mod_launch(const void* x, const void* add, const void* a_in,
                        const void* b_in, const void* acc_in,
                        const void* table, int C, int T, float alpha,
                        float word, float scale, float amp, int swap,
                        void* io, void* qo, void* a_out, void* b_out,
                        void* acc_out, void* stream) {
  if (C < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const ModParams p = {alpha, word, scale, amp, swap ? 1 : 0};
  auto k = add ? fm_mod_kernel<true> : fm_mod_kernel<false>;
  k<<<(C + TILE - 1) / TILE, TILE, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)add, (const float*)a_in,
      (const float*)b_in, (const int32_t*)acc_in, (const float*)table, C, T,
      (float*)io, (float*)qo, (float*)a_out, (float*)b_out,
      (int32_t*)acc_out, p);
  return (int)cudaGetLastError();
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
