// RTTY demodulation (45.45/50 Bd Baudot AFSK at 12 kHz), hand-written for
// Hopper (sm_90a).  A helper kernel with no TPU counterpart: the JAX
// package's `demodulate` (uhsdr_tpu/modems/rtty.py:135-247) runs the mark
// and space band-pass `iir.biquad_block`s as dilated scans, squares them,
// runs the ATC envelopes as a lax.scan (`_atc_scan`, :100-132), the
// 50 Hz low-pass biquad, the comparator, and the DPLL bit sync with the
// async UART as a second lax.scan (:170-227), then compacts the emitted
// codes by a scatter (:232-246).  Per channel and sample, all in f32:
//   mark = biquad(x), space = biquad(x); m = mark^2, s = space^2
//   ATC: each of the four decayavgs avg = (v - avg) * w + avg, w the fast
//        weight where v attacks (above an envelope, below a noise floor),
//        else the slow one; nf = min(noise floors);
//        mc = max(min(m, mark env), nf), sc likewise;
//        v1 = (mc - nf)(me - nf) - (sc - nf)(se - nf)
//             - 0.25 ((me - nf)^2 - (se - nf)^2)
//   else v1 = s - m
//   v1 = biquad(v1); bit = ATC ? v1 > 0 : v1 <= 0      (1 = mark)
//   DPLL/UART in the JAX package's blend form on exact small integers
//   (the start-bit waiter, +-nudges at edges, 5 data bits packed by exact
//   powers of two, the stop bit), each framed code written in order to the
//   channel's slots.
//
// Bound on this card: bytes for the audio read once (8192 x 2048 f32,
// 0.020 ms at 3.35 TB/s); the loop-carried FP32 chain is the low-pass
// biquad's, four dependent operations a sample
// (cuda/rtty.py::RTTY_SAMPLE_CHAIN), and each sample also issues some 120
// instructions off it (two more biquads, the envelopes, the DPLL).
//
// Design: a lane a channel with every register of its state in registers,
// a warp a block (8192 channels are 256 one-warp blocks over all SMs'
// schedulers).  The warp stages tiles of 32 samples of its 32 channels in
// shared memory (a 128-byte line a load, the transposed read padded
// against bank conflicts), the next tile's independent loads in flight in
// registers meanwhile, and each lane walks its row.  A framed code is
// written to its channel's next slot at once; a code past the last slot
// overwrites it, as the JAX package scatters overflowing codes to the last
// slot (its slot count leaves room for every code at the allowed baud
// rates).  Compiled with -fmad=false so that every product and sum rounds
// as the plain version's (cuda/rtty.py::rtty_plain): bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;
constexpr int TILE = 32;

struct Params {
  float mk[5], sp[5], lp[5];  // [b0 b1 b2 a1 a2] each
  float wf, w16, w48;         // the ATC's weights
  float ob, ob_half, ob_nudge;
};

struct Regs {
  const float* in[8];
  float* out[8];
};

__device__ __forceinline__ float pred(bool b) { return b ? 1.0f : 0.0f; }

__global__ void __launch_bounds__(LANES) rtty_kernel(
    const float* __restrict__ x, int C, int T, const Params p, const Regs rg,
    int atc, int n_slots, const float* __restrict__ mbq_in,
    const float* __restrict__ sbq_in, const float* __restrict__ lbq_in,
    const float* __restrict__ env_in, float* __restrict__ mbq_out,
    float* __restrict__ sbq_out, float* __restrict__ lbq_out,
    float* __restrict__ env_out, int* __restrict__ codes,
    int* __restrict__ nbytes) {
  __shared__ float tile[TILE][TILE + 1];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * LANES;
  const int row = row0 + lane;
  const int nrows = min(LANES, C - row0);
  const bool live = row < C;
  const size_t r2 = 2 * (size_t)row, r4 = 4 * (size_t)row;
  float m1 = live ? mbq_in[r2] : 0.f, m2 = live ? mbq_in[r2 + 1] : 0.f;
  float q1 = live ? sbq_in[r2] : 0.f, q2 = live ? sbq_in[r2 + 1] : 0.f;
  float l1 = live ? lbq_in[r2] : 0.f, l2 = live ? lbq_in[r2 + 1] : 0.f;
  float me = live ? env_in[r4] : 0.f, se = live ? env_in[r4 + 1] : 0.f;
  float mn = live ? env_in[r4 + 2] : 0.f, sn = live ? env_in[r4 + 3] : 0.f;
  float phase = live ? rg.in[0][row] : 0.f;
  float oldval = live ? rg.in[1][row] : 0.f;
  float changed = live ? rg.in[2][row] : 0.f;
  float run = live ? rg.in[3][row] : 0.f;
  float wstate = live ? rg.in[4][row] : 0.f;
  float whalf = live ? rg.in[5][row] : 0.f;
  float acc = live ? rg.in[6][row] : 0.f;
  float pos = live ? rg.in[7][row] : 0.f;
  int count = 0;
  int* out = codes + (size_t)row * n_slots;
  // the next tile's samples, loaded while this one is walked
  float nxt[LANES];
#pragma unroll
  for (int r = 0; r < LANES; ++r)
    nxt[r] = (r < nrows && lane < T) ? x[(size_t)(row0 + r) * T + lane]
                                     : 0.f;
  for (int t0 = 0; t0 < T; t0 += TILE) {
    const int nt = min(TILE, T - t0);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < LANES; ++r) tile[r][lane] = nxt[r];
    __syncwarp();
    const int tn = t0 + TILE + lane;
#pragma unroll
    for (int r = 0; r < LANES; ++r)
      nxt[r] = (r < nrows && tn < T) ? x[(size_t)(row0 + r) * T + tn] : 0.f;
    for (int j = 0; j < nt; ++j) {
      const float xn = tile[lane][j];
      // the mark and space band-passes, squared
      const float ym = p.mk[0] * xn + m1;
      m1 = p.mk[1] * xn - p.mk[3] * ym + m2;
      m2 = p.mk[2] * xn - p.mk[4] * ym;
      const float ys = p.sp[0] * xn + q1;
      q1 = p.sp[1] * xn - p.sp[3] * ys + q2;
      q2 = p.sp[2] * xn - p.sp[4] * ys;
      const float mk = ym * ym, sk = ys * ys;
      float v1;
      if (atc) {
        me = (mk - me) * (mk > me ? p.wf : p.w16) + me;
        se = (sk - se) * (sk > se ? p.wf : p.w16) + se;
        mn = (mk - mn) * (mk < mn ? p.wf : p.w48) + mn;
        sn = (sk - sn) * (sk < sn ? p.wf : p.w48) + sn;
        const float nf = mn < sn ? mn : sn;
        float mc = mk < me ? mk : me;
        mc = mc > nf ? mc : nf;
        float sc = sk < se ? sk : se;
        sc = sc > nf ? sc : nf;
        const float dm = me - nf, ds = se - nf;
        v1 = (mc - nf) * dm - (sc - nf) * ds - 0.25f * (dm * dm - ds * ds);
      } else {
        v1 = sk - mk;
      }
      // the low-pass and the comparator (1 = mark)
      const float yl = p.lp[0] * v1 + l1;
      l1 = p.lp[1] * v1 - p.lp[3] * yl + l2;
      l2 = p.lp[2] * v1 - p.lp[4] * yl;
      const float b = pred(atc ? yl > 0.f : yl <= 0.f);
      const float sp = 1.0f - b;
      // the start-bit waiter
      const float is_w = pred(run < 0.5f);
      const float w0 = pred(wstate < 0.5f);
      const float w1 = pred(wstate > 0.5f && wstate < 1.5f);
      float wstate_n = wstate + w0 * b + w1 * sp;
      const float start_half = pred(wstate_n > 1.5f && wstate_n < 2.5f);
      float whalf_n = start_half * p.ob_half + (1.0f - start_half) * whalf;
      wstate_n = wstate_n + start_half;
      const float in_conf = pred(wstate_n > 2.5f);
      whalf_n = whalf_n - in_conf;
      const float confirmed = in_conf * pred(whalf_n < 0.5f);
      const float got_start = is_w * confirmed * sp;
      wstate_n = wstate_n * (1.0f - confirmed);
      float run_n = run + got_start * (1.0f - run);
      phase = phase * (1.0f - got_start);
      acc = acc * (1.0f - got_start);
      pos = pos * (1.0f - got_start);
      // the DPLL
      const float active = pred(run > 0.5f);
      const float edge = active * pred(b != oldval) * (1.0f - changed);
      const float early = pred(phase < p.ob_half);
      phase = phase + edge * (2.0f * early - 1.0f) * p.ob_nudge;
      float changed_n = changed + edge;
      changed_n = changed_n < 1.0f ? changed_n : 1.0f;
      float phase_n = phase + active;
      const float bit_ready = active * pred(phase_n > p.ob - 0.5f);
      phase_n = phase_n - bit_ready * p.ob;
      changed_n = changed_n * (1.0f - bit_ready);
      // the UART: 5 data bits, LSB first, then the stop bit
      const float in_data = pred(pos < 4.5f);
      const float p2 = __int_as_float((127 + (int)pos) << 23);  // 2^pos
      const float acc_n = acc + bit_ready * in_data * b * p2;
      const float pos_n = pos + bit_ready;
      const float done = bit_ready * pred(pos_n > 5.5f);
      const float emit = done * acc_n + (1.0f - done) * -1.0f;
      run_n = run_n * (1.0f - done);
      if (emit >= 0.f) {
        if (live) out[count < n_slots ? count : n_slots - 1] = (int)emit;
        ++count;
      }
      phase = phase_n;
      oldval = b;
      changed = changed_n;
      run = run_n;
      wstate = wstate_n * (1.0f - active);
      whalf = whalf_n;
      acc = acc_n * (1.0f - done);
      pos = pos_n * (1.0f - done);
    }
  }
  if (!live) return;
  for (int k = count; k < n_slots; ++k) out[k] = -1;
  nbytes[row] = count;
  mbq_out[r2] = m1;
  mbq_out[r2 + 1] = m2;
  sbq_out[r2] = q1;
  sbq_out[r2 + 1] = q2;
  lbq_out[r2] = l1;
  lbq_out[r2 + 1] = l2;
  env_out[r4] = me;
  env_out[r4 + 1] = se;
  env_out[r4 + 2] = mn;
  env_out[r4 + 3] = sn;
  rg.out[0][row] = phase;
  rg.out[1][row] = oldval;
  rg.out[2][row] = changed;
  rg.out[3][row] = run;
  rg.out[4][row] = wstate;
  rg.out[5][row] = whalf;
  rg.out[6][row] = acc;
  rg.out[7][row] = pos;
}

}  // namespace

extern "C" {

// x: (C, T) f32; co: 21 f32 on the host (the mark, space and low-pass
// biquads [b0 b1 b2 a1 a2], the ATC's three weights, the bit timer's
// length, half length and nudge); regs: 16 device pointers on the host,
// the eight (C,) f32 DPLL/UART registers in and then out; the filter
// states (C, 2) and the envelopes (C, 4) in and out; codes (C, n_slots)
// int32 (-1 fill), nbytes (C,) int32.  Returns a cudaError_t
// (cudaErrorInvalidValue for a shape the kernel does not take).
int uhsdr_rtty_launch(const void* x, int C, int T, const float* co,
                      void* const* regs, int atc, int n_slots,
                      const void* mbq_in, const void* sbq_in,
                      const void* lbq_in, const void* env_in, void* mbq_out,
                      void* sbq_out, void* lbq_out, void* env_out,
                      void* codes, void* nbytes, void* stream) {
  if (C < 1 || T < 1 || n_slots < 1) return (int)cudaErrorInvalidValue;
  Params p;
  for (int i = 0; i < 5; ++i) {
    p.mk[i] = co[i];
    p.sp[i] = co[5 + i];
    p.lp[i] = co[10 + i];
  }
  p.wf = co[15];
  p.w16 = co[16];
  p.w48 = co[17];
  p.ob = co[18];
  p.ob_half = co[19];
  p.ob_nudge = co[20];
  Regs rg;
  for (int i = 0; i < 8; ++i) {
    rg.in[i] = (const float*)regs[i];
    rg.out[i] = (float*)regs[8 + i];
  }
  const int blocks = (C + LANES - 1) / LANES;
  rtty_kernel<<<blocks, LANES, 0, (cudaStream_t)stream>>>(
      (const float*)x, C, T, p, rg, atc, n_slots, (const float*)mbq_in,
      (const float*)sbq_in, (const float*)lbq_in, (const float*)env_in,
      (float*)mbq_out, (float*)sbq_out, (float*)lbq_out, (float*)env_out,
      (int*)codes, (int*)nbytes);
  return (int)cudaGetLastError();
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
