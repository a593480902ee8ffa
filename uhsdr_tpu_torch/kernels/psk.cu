// BPSK demodulation (PSK31/63/125 at 12 kHz), hand-written for Hopper
// (sm_90a).  A helper kernel with no TPU counterpart: the JAX package's
// `demodulate` (uhsdr_tpu/modems/psk.py:79-118) runs the band-pass
// `iir.biquad_block` as a dilated scan, multiplies by the NCO's sine,
// takes a moving average over one carrier period (24 samples) as the
// difference of a block-long cumsum, picks a symbol at the end of every
// `rate` samples and compares it with the previous one.  Per channel and
// sample n:
//   y = b0 x + s1; s1 = b1 x - a1 y + s2; s2 = b2 x - a2 y
//   p[n] = sinf(float(phase) * 2pi/2^32) * y; phase += delta (mod 2^32)
// and at each symbol's last sample n:
//   sym = (p[n-23] + p[n-22] + ... + p[n]) / 24      (sample order)
//   bit = prev * sym < 0 ? 0 : 1; prev = sym
// The window is summed directly at the symbol's instant, where the JAX
// package differences a cumsum that rounds in proportion to the block's
// running sum; the sums here are the more exact ones.
//
// Bound on this card: bytes for the audio read once (8192 x 2048 f32,
// 0.020 ms at 3.35 TB/s); the loop-carried chain is the biquad's, four
// dependent FP32 operations a sample (cuda/psk.py::PSK_SAMPLE_CHAIN), and
// each sample also takes a sinf of some 20-40 instructions off the chain.
//
// Design: a lane a channel, a warp a block (8192 channels are 256
// one-warp blocks over all SMs' schedulers).  The warp stages tiles of 96
// samples of its 32 channels in shared memory (128-byte lines, rows
// padded against bank conflicts), the next tile's independent loads in
// flight in registers meanwhile; each lane walks its row in chunks of
// 24, the window, with the chunk's products in registers.  A symbol's
// window is the chunk that ends it, since every rate (96, 192, 384) is a
// multiple of 24 and a block starts on a symbol.  The recurrences are
// written with round-to-nearest intrinsics (never contracted to an FMA)
// and the division is IEEE, so every product, sum and quotient rounds as
// the plain version's (cuda/psk.py::psk_plain); the sine is the library's
// sinf, which torch.sin calls on the card: bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int WINDOW = 24;
constexpr int TILE = 96;
constexpr int LANES = 32;
constexpr int LOADS = TILE / LANES;  // a lane's loads of a row's tile

struct Biquad {
  float b0, b1, b2, a1, a2;
};

__global__ void __launch_bounds__(LANES) psk_kernel(
    const float* __restrict__ x, int C, int T, int rate, const Biquad q,
    unsigned delta, float scale, const float* __restrict__ bq_in,
    const long long* __restrict__ ph_in, const float* __restrict__ tail_in,
    const float* __restrict__ sym_in, const int* __restrict__ bit_in,
    int* __restrict__ bits, float* __restrict__ bq_out,
    long long* __restrict__ ph_out, float* __restrict__ tail_out,
    float* __restrict__ sym_out, int* __restrict__ bit_out) {
  __shared__ float tile[LANES][TILE + 1];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * LANES;
  const int row = row0 + lane;
  const int nrows = min(LANES, C - row0);
  const bool live = row < C;
  float s1 = live ? bq_in[2 * (size_t)row] : 0.f;
  float s2 = live ? bq_in[2 * (size_t)row + 1] : 0.f;
  unsigned acc = live ? (unsigned)ph_in[row] : 0u;
  float prev = live ? sym_in[row] : 0.f;
  int last_bit = live ? bit_in[row] : 1;
  float p[WINDOW];
  // the tail stands in the chunk's last 23 slots until a chunk is walked
  p[0] = 0.f;
#pragma unroll
  for (int j = 1; j < WINDOW; ++j)
    p[j] = live ? tail_in[(size_t)row * (WINDOW - 1) + j - 1] : 0.f;
  const int per_symbol = rate / WINDOW;
  const int n_sym = T / rate;
  int chunk = 0, k = 0;
  // the next tile's samples, loaded while this one is walked
  float nxt[LANES][LOADS];
#pragma unroll
  for (int r = 0; r < LANES; ++r)
#pragma unroll
    for (int l = 0; l < LOADS; ++l)
      nxt[r][l] = r < nrows ? x[(size_t)(row0 + r) * T + l * LANES + lane]
                            : 0.f;
  for (int t0 = 0; t0 < T; t0 += TILE) {
    __syncwarp();
#pragma unroll
    for (int r = 0; r < LANES; ++r)
#pragma unroll
      for (int l = 0; l < LOADS; ++l) tile[r][l * LANES + lane] = nxt[r][l];
    __syncwarp();
    const bool more = t0 + TILE < T;
#pragma unroll
    for (int r = 0; r < LANES; ++r)
#pragma unroll
      for (int l = 0; l < LOADS; ++l)
        nxt[r][l] = (more && r < nrows)
                        ? x[(size_t)(row0 + r) * T + t0 + TILE + l * LANES +
                            lane]
                        : 0.f;
#pragma unroll
    for (int c = 0; c < TILE / WINDOW; ++c) {
#pragma unroll
      for (int j = 0; j < WINDOW; ++j) {
        const float xn = tile[lane][c * WINDOW + j];
        const float y = __fadd_rn(__fmul_rn(q.b0, xn), s1);
        s1 = __fadd_rn(__fsub_rn(__fmul_rn(q.b1, xn), __fmul_rn(q.a1, y)),
                       s2);
        s2 = __fsub_rn(__fmul_rn(q.b2, xn), __fmul_rn(q.a2, y));
        p[j] = __fmul_rn(sinf(__fmul_rn(__uint2float_rn(acc), scale)), y);
        acc += delta;
      }
      if (++chunk == per_symbol) {
        chunk = 0;
        float sum = p[0];
#pragma unroll
        for (int j = 1; j < WINDOW; ++j) sum = __fadd_rn(sum, p[j]);
        const float sym = __fdiv_rn(sum, (float)WINDOW);
        last_bit = __fmul_rn(prev, sym) < 0.f ? 0 : 1;
        if (live) bits[(size_t)row * n_sym + k] = last_bit;
        prev = sym;
        ++k;
      }
    }
  }
  if (live) {
    bq_out[2 * (size_t)row] = s1;
    bq_out[2 * (size_t)row + 1] = s2;
    ph_out[row] = (long long)acc;
#pragma unroll
    for (int j = 1; j < WINDOW; ++j)
      tail_out[(size_t)row * (WINDOW - 1) + j - 1] = p[j];
    sym_out[row] = prev;
    bit_out[row] = last_bit;
  }
}

}  // namespace

extern "C" {

int uhsdr_psk_window() { return WINDOW; }

// x: (C, T) f32, T a positive multiple of rate, rate a multiple of TILE;
// bpf (5,) [b0 b1 b2 a1 a2] f32 on the host; delta the NCO's uint32
// increment and scale f32(2 pi / 2^32); the state, in and out: bq (C, 2)
// f32, phase (C,) int64 in [0, 2^32), tail (C, 23) f32, last symbol (C,)
// f32, last bit (C,) int32; bits (C, T / rate) int32.  Returns a
// cudaError_t (cudaErrorInvalidValue for a shape the kernel does not
// take).
int uhsdr_psk_launch(const void* x, int C, int T, int rate, const float* bpf,
                     unsigned delta, float scale, const void* bq_in,
                     const void* ph_in, const void* tail_in,
                     const void* sym_in, const void* bit_in, void* bits,
                     void* bq_out, void* ph_out, void* tail_out,
                     void* sym_out, void* bit_out, void* stream) {
  if (C < 1 || rate < TILE || rate % TILE || T < rate || T % rate)
    return (int)cudaErrorInvalidValue;
  const Biquad q = {bpf[0], bpf[1], bpf[2], bpf[3], bpf[4]};
  const int blocks = (C + LANES - 1) / LANES;
  psk_kernel<<<blocks, LANES, 0, (cudaStream_t)stream>>>(
      (const float*)x, C, T, rate, q, delta, scale, (const float*)bq_in,
      (const long long*)ph_in, (const float*)tail_in, (const float*)sym_in,
      (const int*)bit_in, (int*)bits, (float*)bq_out, (long long*)ph_out,
      (float*)tail_out, (float*)sym_out, (int*)bit_out);
  return (int)cudaGetLastError();
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
