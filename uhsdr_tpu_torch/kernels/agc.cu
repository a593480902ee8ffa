// K3, the WDSP look-ahead AGC, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel uhsdr_tpu/pallas/agc.py::_make_fused_kernel
// with _make_machine_step (agc_pallas_fused, ops/agc.py:481).  Per channel:
//   xfull = delay ++ x;  output n is xfull[n] (the w-sample delay line);
//   rm[n] = max |xfull[n+1 .. n+w]| (look-ahead peak);
//   the fast and hang back-averages of |xfull[n]| update BEFORE the step;
//   the 5-state machine with carries [volts, save, hang, decay, state,
//   fba, hba], its branch masks blended exactly as _make_machine_step
//   does (pallas/agc.py:84-118);
//   after the volts series, the gain law
//   y = xfull[n] * (out_target - slope * min(log10(volts * inv_max), 0))
//       / volts.
//
// Bound on this card: the recurrence.  Its bytes (x in, y out: 128 MiB
// at 8192 x 2048) take ~0.04 ms, but each channel's T steps are a chain
// of dependent FP32 operations, so the floor is T times the latency of
// one step; 8192 channels are 256 warps, a fraction of what 132 SMs can
// keep in flight.  Design: a block owns CB = 32 channels (one warp walks
// them, one thread per channel, carries in registers) and loops over
// time tiles; all 256 threads stage each (channel x time) tile through
// shared memory so global loads and stores stay coalesced, compute the
// look-ahead max in parallel, and apply the gain law after the walk.
// The window is a run-time argument (w = 48 at 12 kHz, 96 at 24 kHz, 192
// at 48 kHz, up to MAXW = 256 as the TPU kernel); the two tiles are sized
// for MAXW and take 65.8 KB, above the 48 KB a kernel gets without opting
// in, so they live in dynamic shared memory.
//
// K13, the AGC machine alone, in the same source: it replaces
// uhsdr_tpu/pallas/agc.py::_make_kernel (agc_scan_pallas, entered from
// ops/agc.py::_run_machine for the linked stereo AGC of the two-channel
// modes).  Per channel it takes the look-ahead max rm and the delayed
// |x| ax, both (C, T), runs the back-averages and the machine step, and
// emits the volts series and the carries; the delay line, the linked
// detector and the gain law stay in torch around it.  Bound: the same
// recurrence as K3 (its bytes, rm and ax in and volts out, take ~0.06 ms
// at 8192 x 2048).  Design: K3's walk without the delay slab or the
// look-ahead max: a block owns CB = 32 channels, 128 threads stage each
// (channel x time) tile of rm and ax through shared memory coalesced,
// one warp walks them (one thread a channel, each step's inputs read one
// step ahead) and writes the volts back over the rm tile, which all
// threads then store coalesced.  K3 and K13 share `machine_step`.
// Per-channel gain-law rows (the TPU kernels' `chan` operand,
// pallas/agc.py:126-133 and :176-190): both kernels are templates on
// ROWS.  Without rows every channel takes the scalar settings, and the
// code is what it was before rows existed.  With rows, K3 takes a (3, C)
// f32 table [min_volts, slope_constant, hang_level] and K13 a (2, C)
// table [min_volts, hang_level]: the walking thread loads its channel's
// min_volts and hang_level into registers once, before the time loop,
// and K3 stages its block's 32 slopes in shared memory beside the two
// tiles for the gain-law pass.  A channel with rows gives the bits it
// gives alone with the same values as scalars.
// Compiled with -fmad=false: the masks compare floats (rm >= volts,
// hba > hang_level), so the arithmetic keeps the reference's separate
// f32 multiplies and adds.
#include <cuda_runtime.h>

namespace {

constexpr int CB = 32;          // channels per block
constexpr int TA = 128;         // time tile
constexpr int MAXW = 256;       // largest look-ahead window
constexpr int THREADS = 256;
constexpr int SX = (TA + MAXW) | 1;   // odd row strides: conflict-free walk
constexpr int SR = TA + 1;
constexpr int SMEM_BYTES = CB * (SX + SR) * (int)sizeof(float);
// K3 with rows: the block's slopes after the two tiles
constexpr int SMEM_ROWS_BYTES = SMEM_BYTES + CB * (int)sizeof(float);
constexpr int SCAN_THREADS = 128;   // K13: staging threads per block

struct Params {
  float attack, fast_d, long_d, hang_d, fast_bm, hang_bm, pop_ratio,
      hang_level, hang_time, hang_en, min_volts, out_target, slope,
      inv_max_input;
};

struct Machine {
  float volts, save, hang, decay, st, fba, hba;
};

__device__ __forceinline__ Machine load_machine(const float* carry, int C,
                                               int c) {
  Machine m;
  m.volts = carry[0 * (size_t)C + c];
  m.save = carry[1 * (size_t)C + c];
  m.hang = carry[2 * (size_t)C + c];
  m.decay = carry[3 * (size_t)C + c];
  m.st = carry[4 * (size_t)C + c];
  m.fba = carry[5 * (size_t)C + c];
  m.hba = carry[6 * (size_t)C + c];
  return m;
}

__device__ __forceinline__ void store_machine(const Machine& m, float* carry,
                                              int C, int c) {
  carry[0 * (size_t)C + c] = m.volts;
  carry[1 * (size_t)C + c] = m.save;
  carry[2 * (size_t)C + c] = m.hang;
  carry[3 * (size_t)C + c] = m.decay;
  carry[4 * (size_t)C + c] = m.st;
  carry[5 * (size_t)C + c] = m.fba;
  carry[6 * (size_t)C + c] = m.hba;
}

// One step of the 5-state machine, shared by K3 and K13: the back-averages
// of |x| update first, then the branch masks (differenced as
// pallas/agc.py:84-118 does) pick the new volts, state, save, hang and
// decay.  a_f, a_h: 1 - fast_bm, 1 - hang_bm; hang_level and min_volts
// are the channel's (its row, or the scalar settings).
__device__ __forceinline__ void machine_step(Machine& m, const Params& p,
                                             float a_f, float a_h,
                                             float hang_level,
                                             float min_volts, float rm,
                                             float ax) {
  const float one = 1.f;
  m.fba = a_f * m.fba + p.fast_bm * ax;
  m.hba = a_h * m.hba + p.hang_bm * ax;
  m.hang = fmaxf(m.hang - one, 0.f);

  const float volts = m.volts, st = m.st;
  const float att = rm >= volts ? 1.f : 0.f;
  const float natt = one - att;
  const float is0 = st < 0.5f ? 1.f : 0.f;
  const float is1 = (st > 0.5f && st < 1.5f) ? 1.f : 0.f;
  const float is2 = (st > 1.5f && st < 2.5f) ? 1.f : 0.f;
  const float is3 = (st > 2.5f && st < 3.5f) ? 1.f : 0.f;
  const float is4 = st > 3.5f ? 1.f : 0.f;
  const float ht = p.hang_en * (m.hba > hang_level ? 1.f : 0.f);
  const float s0_fast = volts > p.pop_ratio * m.fba ? 1.f : 0.f;
  const float s1_fastc = volts > m.save ? 1.f : 0.f;
  const float hc_wait = m.hang > 0.5f ? 1.f : 0.f;

  const float nf0 = is0 * natt;
  const float m0f = nf0 * s0_fast;
  const float m0nf = nf0 - m0f;
  const float m0h = m0nf * ht;
  const float m0l = m0nf - m0h;
  const float nf1 = is1 * natt;
  const float m1f = nf1 * s1_fastc;
  const float m1nf = nf1 - m1f;
  const float m1w = m1nf * hc_wait;
  const float m1z = m1nf - m1w;
  const float m1h = m1z * m.decay;
  const float m1l = m1z - m1h;
  const float n2 = is2 * natt;
  const float m2s = n2 * hc_wait;
  const float m2d = n2 - m2s;
  const float m3d = is3 * natt;
  const float m4d = is4 * natt;

  const float gF = m0f + m1f;
  const float gL = m0l + m1l + m3d;
  const float gH = m1h + m2d + m4d;
  const float gW = m0h + m1w + m2s;
  const float keff =
      att * p.attack + gF * p.fast_d + gL * p.long_d + gH * p.hang_d;
  const float new_volts = fmaxf(volts + (rm - volts) * keff, min_volts);
  const float new_st = gF + gW * 2.f + gL * 3.f + gH * 4.f;
  const float save_upd = att * (one - (is0 + is1));
  m.save = save_upd * volts + (one - save_upd) * m.save;
  m.hang = m0h * p.hang_time + (one - m0h) * m.hang;
  m.decay = m0h * one + (one - (m0h + m0l)) * m.decay;
  m.st = new_st;
  m.volts = new_volts;
}

// rows: (3, C) [min_volts, slope_constant, hang_level] when ROWS, else
// not read.
template <bool ROWS>
__global__ void __launch_bounds__(THREADS) agc_kernel(
    const float* __restrict__ x, const float* __restrict__ delay,
    const float* __restrict__ carry, const float* __restrict__ rows, int C,
    int T, int w, Params p, float* __restrict__ y,
    float* __restrict__ carry_out, float* __restrict__ delay_out) {
  extern __shared__ float smem[];
  // slab[c][j] = xfull[t0 + j]; rmv[c][j] = look-ahead max, then volts;
  // with rows, slope_s[c] = the channel's slope constant
  float (*slab)[SX] = reinterpret_cast<float (*)[SX]>(smem);
  float (*rmv)[SR] = reinterpret_cast<float (*)[SR]>(smem + CB * SX);
  float* slope_s = smem + CB * (SX + SR);
  const int c0 = blockIdx.x * CB;
  const int tid = threadIdx.x;
  const int nc = min(CB, C - c0);
  if constexpr (ROWS) {
    if (tid < nc) slope_s[tid] = rows[1 * (size_t)C + c0 + tid];
  }

  for (int i = tid; i < CB * w; i += THREADS) {
    const int c = i / w, j = i % w;
    slab[c][j] = c < nc ? delay[(size_t)(c0 + c) * w + j] : 0.f;
  }
  // the walking warp's carries
  Machine m{};
  const bool walker = tid < CB && tid < nc;
  float hang_level = p.hang_level, min_volts = p.min_volts;
  if (walker) {
    m = load_machine(carry, C, c0 + tid);
    if constexpr (ROWS) {
      min_volts = rows[0 * (size_t)C + c0 + tid];
      hang_level = rows[2 * (size_t)C + c0 + tid];
    }
  }
  const float a_f = 1.f - p.fast_bm;
  const float a_h = 1.f - p.hang_bm;

  int cnt = 0;
  for (int t0 = 0; t0 < T; t0 += TA) {
    cnt = min(TA, T - t0);
    for (int i = tid; i < CB * TA; i += THREADS) {
      const int c = i / TA, j = i % TA;
      if (c < nc && j < cnt) slab[c][w + j] = x[(size_t)(c0 + c) * T + t0 + j];
    }
    __syncthreads();
    for (int i = tid; i < CB * TA; i += THREADS) {
      const int c = i / TA, j = i % TA;
      if (c < nc && j < cnt) {
        float mx = fabsf(slab[c][j + 1]);
        for (int k = 2; k <= w; ++k) mx = fmaxf(mx, fabsf(slab[c][j + k]));
        rmv[c][j] = mx;
      }
    }
    __syncthreads();
    if (walker) {
      // Each step's inputs are read one step ahead: both tiles lie in one
      // shared array, so the compiler cannot itself move the next loads
      // above this step's store of volts, and the walk would wait on
      // them.  (The read at j + 1 = TA lands on the rows' pad column.)
      float rm_next = rmv[tid][0];
      float ax_next = fabsf(slab[tid][0]);
      for (int j = 0; j < cnt; ++j) {
        const float rm = rm_next;
        const float ax = ax_next;
        rm_next = rmv[tid][j + 1];
        ax_next = fabsf(slab[tid][j + 1]);
        machine_step(m, p, a_f, a_h, hang_level, min_volts, rm, ax);
        rmv[tid][j] = m.volts;
      }
    }
    __syncthreads();
    for (int i = tid; i < CB * TA; i += THREADS) {
      const int c = i / TA, j = i % TA;
      if (c < nc && j < cnt) {
        const float v = rmv[c][j];
        const float vo = fminf(log10f(p.inv_max_input * v), 0.f);
        const float slope = ROWS ? slope_s[c] : p.slope;
        y[(size_t)(c0 + c) * T + t0 + j] =
            slab[c][j] * ((p.out_target - slope * vo) / v);
      }
    }
    __syncthreads();
    if (t0 + TA < T) {   // next tile: its head is this tile's last w
      // slab[TA + j] moves to slab[j] in runs of TA columns, lowest first
      // with a barrier between: a run's targets are the run before's
      // sources when w > TA
      for (int j0 = 0; j0 < w; j0 += TA) {
        const int nj = min(TA, w - j0);
        for (int i = tid; i < CB * nj; i += THREADS) {
          const int c = i / nj, j = j0 + i % nj;
          slab[c][j] = slab[c][TA + j];
        }
        __syncthreads();
      }
    }
  }

  // new delay line: xfull[T .. T+w) = the last tile's slab[cnt .. cnt+w)
  for (int i = tid; i < CB * w; i += THREADS) {
    const int c = i / w, j = i % w;
    if (c < nc) delay_out[(size_t)(c0 + c) * w + j] = slab[c][cnt + j];
  }
  if (walker) store_machine(m, carry_out, C, c0 + tid);
}

// rows: (2, C) [min_volts, hang_level] when ROWS, else not read.
template <bool ROWS>
__global__ void __launch_bounds__(SCAN_THREADS) agc_scan_kernel(
    const float* __restrict__ rm, const float* __restrict__ ax,
    const float* __restrict__ carry, const float* __restrict__ rows, int C,
    int T, Params p, float* __restrict__ volts_out,
    float* __restrict__ carry_out) {
  // rms[c][j] = rm[t0 + j], then the volts of that step; axs = ax
  __shared__ float rms[CB][SR];
  __shared__ float axs[CB][SR];
  const int c0 = blockIdx.x * CB;
  const int tid = threadIdx.x;
  const int nc = min(CB, C - c0);
  Machine m{};
  const bool walker = tid < nc;
  float hang_level = p.hang_level, min_volts = p.min_volts;
  if (walker) {
    m = load_machine(carry, C, c0 + tid);
    if constexpr (ROWS) {
      min_volts = rows[0 * (size_t)C + c0 + tid];
      hang_level = rows[1 * (size_t)C + c0 + tid];
    }
  }
  const float a_f = 1.f - p.fast_bm;
  const float a_h = 1.f - p.hang_bm;

  for (int t0 = 0; t0 < T; t0 += TA) {
    const int cnt = min(TA, T - t0);
    for (int i = tid; i < CB * TA; i += SCAN_THREADS) {
      const int c = i / TA, j = i % TA;
      if (c < nc && j < cnt) {
        const size_t o = (size_t)(c0 + c) * T + t0 + j;
        rms[c][j] = rm[o];
        axs[c][j] = ax[o];
      }
    }
    __syncthreads();
    if (walker) {
      // inputs read one step ahead, as in K3 (the read at j + 1 = TA
      // lands on the rows' pad column)
      float rm_next = rms[tid][0];
      float ax_next = axs[tid][0];
      for (int j = 0; j < cnt; ++j) {
        const float r = rm_next;
        const float a = ax_next;
        rm_next = rms[tid][j + 1];
        ax_next = axs[tid][j + 1];
        machine_step(m, p, a_f, a_h, hang_level, min_volts, r, a);
        rms[tid][j] = m.volts;
      }
    }
    __syncthreads();
    for (int i = tid; i < CB * TA; i += SCAN_THREADS) {
      const int c = i / TA, j = i % TA;
      if (c < nc && j < cnt)
        volts_out[(size_t)(c0 + c) * T + t0 + j] = rms[c][j];
    }
    __syncthreads();
  }
  if (walker) store_machine(m, carry_out, C, c0 + tid);
}

}  // namespace

extern "C" {

int uhsdr_agc_max_window() { return MAXW; }

// Returns a cudaError_t.  Requires 1 <= w <= MAXW and T >= 1.  rows: a
// (3, C) f32 table [min_volts, slope_constant, hang_level], or nullptr
// for the scalar settings.
int uhsdr_agc_launch(const void* x, const void* delay, const void* carry,
                     const void* rows, int C, int T, int w, float attack,
                     float fast_d,
                     float long_d, float hang_d, float fast_bm,
                     float hang_bm, float pop_ratio, float hang_level,
                     float hang_time, float hang_en, float min_volts,
                     float out_target, float slope, float inv_max_input,
                     void* y, void* carry_out, void* delay_out,
                     void* stream) {
  Params p{attack, fast_d, long_d, hang_d, fast_bm, hang_bm, pop_ratio,
           hang_level, hang_time, hang_en, min_volts, out_target, slope,
           inv_max_input};
  const int grid = (C + CB - 1) / CB;
  cudaError_t e;
  if (rows == nullptr) {
    e = cudaFuncSetAttribute(agc_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    agc_kernel<false><<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)delay, (const float*)carry, nullptr,
        C, T, w, p, (float*)y, (float*)carry_out, (float*)delay_out);
  } else {
    e = cudaFuncSetAttribute(agc_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_ROWS_BYTES);
    if (e != cudaSuccess) return (int)e;
    agc_kernel<true><<<grid, THREADS, SMEM_ROWS_BYTES,
                       (cudaStream_t)stream>>>(
        (const float*)x, (const float*)delay, (const float*)carry,
        (const float*)rows, C, T, w, p, (float*)y, (float*)carry_out,
        (float*)delay_out);
  }
  return (int)cudaGetLastError();
}

// K13.  rm, ax, volts_out: (C, T) f32; carry, carry_out: (7, C); rows: a
// (2, C) f32 table [min_volts, hang_level], or nullptr for the scalar
// settings.  The gain-law parameters (out_target, slope, inv_max_input)
// are not read.  Returns a cudaError_t.  Requires T >= 1.
int uhsdr_agc_scan_launch(const void* rm, const void* ax, const void* carry,
                          const void* rows, int C, int T, float attack,
                          float fast_d,
                          float long_d, float hang_d, float fast_bm,
                          float hang_bm, float pop_ratio, float hang_level,
                          float hang_time, float hang_en, float min_volts,
                          void* volts_out, void* carry_out, void* stream) {
  Params p{attack, fast_d, long_d, hang_d, fast_bm, hang_bm, pop_ratio,
           hang_level, hang_time, hang_en, min_volts, 0.f, 0.f, 0.f};
  const int grid = (C + CB - 1) / CB;
  if (rows == nullptr)
    agc_scan_kernel<false><<<grid, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)rm, (const float*)ax, (const float*)carry, nullptr, C,
        T, p, (float*)volts_out, (float*)carry_out);
  else
    agc_scan_kernel<true><<<grid, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)rm, (const float*)ax, (const float*)carry,
        (const float*)rows, C, T, p, (float*)volts_out, (float*)carry_out);
  return (int)cudaGetLastError();
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
