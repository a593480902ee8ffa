// K3, the WDSP look-ahead AGC, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel uhsdr_tpu/pallas/agc.py::_make_fused_kernel
// with _make_machine_step (agc_pallas_fused, ops/agc.py:481).  Per channel:
//   xfull = delay ++ x;  output n is xfull[n] (the w-sample delay line);
//   rm[n] = max |xfull[n+1 .. n+w]| (look-ahead peak);
//   the fast and hang back-averages of |xfull[n]| update BEFORE the step;
//   the 5-state machine with carries [volts, save, hang, decay, state,
//   fba, hba], in select form (see machine_step);
//   after the volts series, the gain law
//   y = xfull[n] * (out_target - slope * min(log10(volts * inv_max), 0))
//       / volts;
//   the new delay line is xfull[T .. T+w).
//
// Bound on this card: the recurrence.  Its bytes (x in, y out: 128 MiB
// at 8192 x 2048) take ~0.04 ms, but each channel's T steps are a chain
// of dependent FP32 operations, so the floor is T times the latency of
// one step (7 dependent operations, see machine_step); 8192 channels are
// 256 warps, a fraction of what 132 SMs can keep in flight.
//
// Design: a block owns CB = 32 channels and 6 warps with three roles that
// pass time tiles of TA = 32 steps through a ring of STAGES = 4 stage
// buffers in shared memory, each handed on by a named barrier (bar.arrive
// by the producer, bar.sync by the consumer), so that no role waits on a
// block-wide barrier inside the tile loop:
//   - the front warp copies x tiles k+1 and k+2 from device memory into a
//     ring of the channel's last w + 3 TA or more samples of xfull (lanes
//     along time, cp.async), and for tile k (lane = channel) computes rm
//     by van Herk / Gil-Werman: xfull is cut into segments of w samples;
//     G, the max from the segment's start, runs in a register; when a
//     segment is complete, one backward pass writes H, the max to the
//     segment's end, into a w-slot array; then rm[n] = max(H[n+1],
//     G[n+w]), about 3 operations an output for any w, each exact.  It
//     writes (rm[n], xfull[n]) pairs into the stage buffer;
//   - the walker warp (lane = channel, carries in registers) runs the
//     machine over the stage's 32 steps, each step's inputs read one step
//     ahead, and writes volts over rm;
//   - four gain-law warps (lanes along time) apply the gain law to the
//     stage the walker finished and store y coalesced, then free the
//     stage for the front warp.
// The window is a run-time argument (w = 48 at 12 kHz, 96 at 24 kHz, 192
// at 48 kHz, up to MAXW = 256 as the TPU kernel); the shared memory is
// `geometry(w)` (cuda/agc.py::agc_geometry): 49-109 KB, two blocks an SM
// at every w.
//
// K13, the AGC machine alone, in the same source: it replaces
// uhsdr_tpu/pallas/agc.py::_make_kernel (agc_scan_pallas, entered from
// ops/agc.py::_run_machine for the linked stereo AGC of the two-channel
// modes).  Per channel it takes the look-ahead max rm and the delayed
// |x| ax, both (C, T), runs the back-averages and the machine step, and
// emits the volts series and the carries; the delay line, the linked
// detector and the gain law stay in torch around it.  Bound: the same
// recurrence as K3 (its bytes, rm and ax in and volts out, take ~0.06 ms
// at 8192 x 2048).  Design: a block owns CB = 32 channels, 128 threads
// stage each (channel x time) tile of rm and ax through shared memory
// coalesced, one warp walks them (one thread a channel, each step's
// inputs read one step ahead) and writes the volts back over the rm
// tile, which all threads then store coalesced.  K3 and K13 share
// `machine_step`.
// Per-channel gain-law rows (the TPU kernels' `chan` operand,
// pallas/agc.py:126-133 and :176-190): both kernels are templates on
// ROWS.  Without rows every channel takes the scalar settings.  With
// rows, K3 takes a (3, C) f32 table [min_volts, slope_constant,
// hang_level] and K13 a (2, C) table [min_volts, hang_level]: the walking
// thread loads its channel's min_volts and hang_level into registers
// once, before the time loop, and each K3 gain-law thread the slopes of
// its 8 channels.  A channel with rows gives the bits it gives alone with
// the same values as scalars.
// Compiled with -fmad=false: the branches compare floats (rm >= volts,
// hba > hang_level), so the arithmetic keeps the reference's separate
// f32 multiplies and adds.
#include <cuda_runtime.h>

namespace {

constexpr int CB = 32;          // channels per block
constexpr int MAXW = 256;       // largest look-ahead window

// K3
constexpr int TA = 32;          // time tile: one step a lane of the front
constexpr int STAGES = 4;       // stage buffers in the ring
constexpr int GAIN_WARPS = 4;
constexpr int GAIN_THREADS = 32 * GAIN_WARPS;
constexpr int THREADS = 64 + GAIN_THREADS;   // walker, front, gain law
constexpr int SS = TA + 1;      // a stage row's stride in float2s (the pad
                                // takes the walker's read one step ahead)
constexpr int GAIN_CH = CB / GAIN_WARPS;     // channels a gain thread takes
// named barriers (0 is __syncthreads'): stage s is full (front -> walker),
// holds volts (walker -> gain law), is free again (gain law -> front)
constexpr int BAR_FULL = 1;
constexpr int BAR_VOLTS = BAR_FULL + STAGES;
constexpr int BAR_FREE = BAR_VOLTS + STAGES;
static_assert(BAR_FREE + STAGES <= 16, "16 named barriers a block");
static_assert(CB % GAIN_WARPS == 0, "gain-law channels");

// K13
constexpr int TS = 128;         // time tile
constexpr int SR = TS + 1;
constexpr int SCAN_THREADS = 128;   // staging threads per block

// K3's shared memory for look-ahead w: the stage ring, then the
// segment-suffix maxima (w slots a channel), then the sample ring (w
// rounded up to TA, and 3 TA more: a multiple of TA, so a tile's samples
// never wrap); odd row strides, so a warp whose lanes are channels meets
// no bank conflict.
struct Geometry {
  int ring;    // slots of the sample ring
  int as;      // its row stride, floats
  int hs;      // the suffix maxima's row stride, floats
  int smem;    // dynamic shared memory, bytes
};

__host__ __device__ inline Geometry geometry(int w) {
  Geometry g;
  g.ring = (w + TA - 1) / TA * TA + 3 * TA;
  g.as = g.ring | 1;
  g.hs = w | 1;
  g.smem = (STAGES * CB * SS * 2 + CB * g.as + CB * g.hs) * (int)sizeof(float);
  return g;
}

struct Params {
  float attack, fast_d, long_d, hang_d, fast_bm, hang_bm, pop_ratio,
      hang_level, hang_time, hang_en, min_volts, out_target, slope,
      inv_max_input;
};

// The machine's carries; state and decay_type are whole numbers (0..4 and
// 0/1) in the f32 carry and live as ints here.
struct Machine {
  float volts, save, hang, fba, hba;
  int st, decay;
};

__device__ __forceinline__ Machine load_machine(const float* carry, int C,
                                               int c) {
  Machine m;
  m.volts = carry[0 * (size_t)C + c];
  m.save = carry[1 * (size_t)C + c];
  m.hang = carry[2 * (size_t)C + c];
  m.decay = carry[3 * (size_t)C + c] > 0.5f ? 1 : 0;
  const float st = carry[4 * (size_t)C + c];
  m.st = st < 0.5f ? 0 : st < 1.5f ? 1 : st < 2.5f ? 2 : st < 3.5f ? 3 : 4;
  m.fba = carry[5 * (size_t)C + c];
  m.hba = carry[6 * (size_t)C + c];
  return m;
}

__device__ __forceinline__ void store_machine(const Machine& m, float* carry,
                                              int C, int c) {
  carry[0 * (size_t)C + c] = m.volts;
  carry[1 * (size_t)C + c] = m.save;
  carry[2 * (size_t)C + c] = m.hang;
  carry[3 * (size_t)C + c] = (float)m.decay;
  carry[4 * (size_t)C + c] = (float)m.st;
  carry[5 * (size_t)C + c] = m.fba;
  carry[6 * (size_t)C + c] = m.hba;
}

// One step of the 5-state machine, shared by K3 and K13, in select form:
// the back-averages of |x| update first; then three compares of volts
// (rm >= volts, volts > pop_ratio * fba, volts > save) pick the step's
// new volts among three candidates, volts + (rm - volts) * k for k the
// attack, the fast decay, or the state's own multiplier (long decay, hang
// decay, or 0 to hold), and state, save, hang and decay are chosen by the
// same predicates off the volts chain.  The loop-carried chain from volts
// to the next volts: the compare, the fast predicate and two selects of
// the candidate, the update multiply and add running beside them (rm -
// volts first), the min-volts max: 7 operations.  The predicates are
// combined with & and | (no branch).
// It gives the bits of the blended form of pallas/agc.py:84-118 (and of
// the plain version, `cuda/agc.py::machine_step`) on every finite input:
// exactly one branch mask is 1, a product with a 0/1 mask is exact under
// -fmad=false, adding +-0 leaves a nonzero value as it was, the held
// branch's volts + (rm - volts) * 0 is volts, and a zero volts ends at
// min_volts > 0 either way.  a_f, a_h: 1 - fast_bm, 1 - hang_bm;
// hang_level and min_volts are the channel's (its row, or the scalars).
__device__ __forceinline__ void machine_step(Machine& m, const Params& p,
                                             float a_f, float a_h,
                                             float hang_level,
                                             float min_volts, float rm,
                                             float ax) {
  m.fba = a_f * m.fba + p.fast_bm * ax;
  m.hba = a_h * m.hba + p.hang_bm * ax;
  const float hc = fmaxf(m.hang - 1.f, 0.f);

  // off the volts chain: what a state does when it neither attacks nor
  // decays fast (new state 2 holds, 3 decays long, 4 decays by hang)
  const int st = m.st;
  const bool s0 = st == 0, s1 = st == 1, s2 = st == 2;
  const bool ht = (p.hang_en != 0.f) & (m.hba > hang_level);
  const bool wait = hc > 0.5f;
  const bool hold = (s0 & ht) | ((s1 | s2) & wait);
  const bool hangd = (st == 4) | (s2 & !wait) | (s1 & !wait & (m.decay != 0));
  const int st_slow = hold ? 2 : hangd ? 4 : 3;
  const float k_slow = hold ? 0.f : hangd ? p.hang_d : p.long_d;

  // the volts chain
  const float volts = m.volts;
  const float d = rm - volts;
  const float v_slow = volts + d * k_slow;
  const float v_fast = volts + d * p.fast_d;
  const float v_att = volts + d * p.attack;
  const bool att = rm >= volts;
  const bool f0 = volts > p.pop_ratio * m.fba;
  const bool f1 = volts > m.save;
  const bool fast = (s0 & f0) | (s1 & f1);
  m.volts = fmaxf(att ? v_att : fast ? v_fast : v_slow, min_volts);

  m.st = att ? 0 : fast ? 1 : st_slow;
  m.save = (att & (st >= 2)) ? volts : m.save;
  const bool s0_slow = !att & s0 & !f0;   // state 0's hang or long decay
  m.hang = (s0_slow & ht) ? p.hang_time : hc;
  m.decay = s0_slow ? (int)ht : m.decay;
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// --- K3's three roles ------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

// The front warp's copy of x tile t (steps t*TA ..) into the sample ring,
// lanes along time, one cp.async group a tile (empty past the block).
__device__ __forceinline__ void load_tile(const float* __restrict__ x, int T,
                                          int c0, int nc, int t,
                                          const Geometry& g, float* ring,
                                          int lane) {
  const int n = t * TA + lane;
  if (n < T) {
    const int slot = n % g.ring;     // xfull[w + n]: see agc_front
    for (int c = 0; c < nc; ++c) {  // load
      cp_async4(ring + c * g.as + slot, x + (size_t)(c0 + c) * T + n);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The suffix maxima of the segment that ends at ring slot `last`:
// hrow[k] = max |xfull| over the segment's samples k .. w-1, TA samples at
// a time: their loads first, then the chain of maxima (past the segment's
// first sample the chain runs on, and is not stored).
__device__ __forceinline__ void segment_suffix(const float* rrow,
                                               float* hrow, int w, int ring,
                                               int last) {
  float h = 0.f;
  int sl = last;     // the slot of the segment's sample k0
  for (int k0 = w - 1; k0 >= 0; k0 -= TA) {
    float v[TA];
#pragma unroll
    for (int q = 0; q < TA; ++q) {
      int s = sl - q;
      if (s < 0) s += ring;
      v[q] = fabsf(rrow[s]);
    }
#pragma unroll
    for (int q = 0; q < TA; ++q) {
      h = fmaxf(h, v[q]);
      if (q <= k0) hrow[k0 - q] = h;
    }
    sl -= TA;
    if (sl < 0) sl += ring;
  }
}

// The position of the next sample xfull[m] (m = w + j*TA at tile j's
// start) in its segment and its ring slot, and the slot of xfull[m - w].
struct FrontPos {
  int ph, ia, ib;
  float gm;          // G[m - 1], the max from its segment's start
};

// Tile j's rm and xfull of the outputs n = j*TA + i, i < cnt, into the
// stage row `st`, one output at a time (for w < TA: several segment ends
// a tile).
__device__ __forceinline__ void front_tile_any_w(const float* rrow,
                                                 float* hrow, int w, int R,
                                                 int cnt, FrontPos& f,
                                                 float2* st) {
  for (int i = 0; i < cnt; ++i) {
    const float a = fabsf(rrow[f.ia]);
    f.gm = f.ph == 0 ? a : fmaxf(f.gm, a);
    if (f.ph == w - 1) segment_suffix(rrow, hrow, w, R, f.ia);
    const float hn = hrow[f.ph == w - 1 ? 0 : f.ph + 1];
    st[i] = make_float2(fmaxf(hn, f.gm), rrow[f.ib]);
    f.ph = f.ph == w - 1 ? 0 : f.ph + 1;
    f.ia = f.ia == R - 1 ? 0 : f.ia + 1;
    f.ib = f.ib == R - 1 ? 0 : f.ib + 1;
  }
}

// The same for w >= TA, where a tile holds at most one segment end: the
// tile's samples (slots ia .. ia + TA, no wrap), the suffix maxima its
// outputs read and their delayed samples are loaded first; G runs along;
// if a segment ends in the tile, its backward pass runs and the outputs
// from its end on read the new suffix maxima.  The stage row takes all TA
// pairs (those past cnt are not read).
__device__ __forceinline__ void front_tile(const float* rrow, float* hrow,
                                           int w, int R, int cnt,
                                           FrontPos& f, float2* st) {
  if (w < TA) {
    front_tile_any_w(rrow, hrow, w, R, cnt, f, st);
    return;
  }
  const float* ga = rrow + f.ia;
  const int xsplit = R - f.ib;      // the delayed samples wrap here
  float gv[TA], hn[TA], xv[TA];
#pragma unroll
  for (int i = 0; i < TA; ++i) {
    gv[i] = fabsf(ga[i]);
    // past the segment's end (ph + 1 + i >= w) this reads a later slot, or
    // the next row, and is replaced below or not used
    hn[i] = hrow[f.ph + 1 + i];
    xv[i] = rrow[i < xsplit ? f.ib + i : f.ib + i - R];
  }
  // G restarts (from 0: every |x| >= +0) where ph + i = 0 or w
  const int rs = f.ph == 0 ? 0 : w - f.ph;
  float gm = f.gm;
#pragma unroll
  for (int i = 0; i < TA; ++i) {
    gm = fmaxf(i == rs ? 0.f : gm, gv[i]);
    gv[i] = gm;
  }
  const int ie = w - 1 - f.ph;    // the segment's end, if in the tile
  if (ie < cnt) {
    segment_suffix(rrow, hrow, w, R, f.ia + ie);
#pragma unroll
    for (int i = 0; i < TA; ++i)
      if (i >= ie) hn[i] = hrow[i - ie];
  }
#pragma unroll
  for (int i = 0; i < TA; ++i) st[i] = make_float2(fmaxf(hn[i], gv[i]), xv[i]);
  // (only the last tile is short, and nothing follows it)
  f.gm = gv[TA - 1];
  f.ph += cnt;
  if (f.ph >= w) f.ph -= w;
  f.ia += cnt;
  if (f.ia >= R) f.ia -= R;
  f.ib += cnt;
  if (f.ib >= R) f.ib -= R;
}

// The front warp: lane = channel for the sliding max, lanes along time
// for the copies.  xfull[m] sits in ring slot (m - w) mod R: tile j's
// samples xfull[w + j*TA ..] start at a multiple of TA.  The ring holds at
// least w + 3 TA samples: tile j's outputs read xfull[j*TA .. w +
// (j+1)*TA) while tiles j+1 and j+2 are in flight.
__device__ void agc_front(const float* __restrict__ x,
                          const float* __restrict__ delay,
                          float* __restrict__ delay_out, int c0, int nc,
                          int T, int w, int ntiles, const Geometry& g,
                          float2* stage, float* ring, float* hmax,
                          int lane) {
  // xfull[0 .. w) (the delay line) into slots R - w .. R, tiles 0 and 1
  // from slot 0
  for (int c = 0; c < nc; ++c)
    for (int d = lane; d < w; d += 32)
      ring[c * g.as + g.ring - w + d] = delay[(size_t)(c0 + c) * w + d];
  load_tile(x, T, c0, nc, 0, g, ring, lane);
  load_tile(x, T, c0, nc, 1, g, ring, lane);
  asm volatile("cp.async.wait_group 1;" ::: "memory");
  __syncwarp();

  // the delay line is the first segment: its suffix maxima (G restarts at
  // xfull[w], the next segment's first sample)
  const float* rrow = ring + lane * g.as;
  float* hrow = hmax + lane * g.hs;
  segment_suffix(rrow, hrow, w, g.ring, g.ring - 1);
  FrontPos f{0, 0, g.ring - w, 0.f};
  for (int j = 0; j < ntiles; ++j) {
    // tile j+2 takes the slots of samples at least R earlier, none read
    // after tile j-1
    load_tile(x, T, c0, nc, j + 2, g, ring, lane);
    const int cnt = min(TA, T - j * TA);
    const int s = j % STAGES;
    if (j >= STAGES) bar_sync(BAR_FREE + s, 32 + GAIN_THREADS);
    float2* st = stage + (s * CB + lane) * SS;
    front_tile(rrow, hrow, w, g.ring, cnt, f, st);
    bar_arrive(BAR_FULL + s, 64);
    asm volatile("cp.async.wait_group 1;" ::: "memory");   // tile j+1
    __syncwarp();
  }

  // the new delay line: xfull[T .. T+w), still in the ring
  for (int c = 0; c < nc; ++c)
    for (int d = lane; d < w; d += 32)
      delay_out[(size_t)(c0 + c) * w + d] =
          ring[c * g.as + (T + d - w + g.ring) % g.ring];
}

template <bool ROWS>
__device__ void agc_walker(const float* __restrict__ carry,
                           const float* __restrict__ rows, int C, int c0,
                           int nc, int T, int ntiles, const Params& p,
                           float2* stage, float* __restrict__ carry_out,
                           int lane) {
  Machine m{};
  float hang_level = p.hang_level, min_volts = p.min_volts;
  if (lane < nc) {
    m = load_machine(carry, C, c0 + lane);
    if constexpr (ROWS) {
      min_volts = rows[0 * (size_t)C + c0 + lane];
      hang_level = rows[2 * (size_t)C + c0 + lane];
    }
  }
  const float a_f = 1.f - p.fast_bm;
  const float a_h = 1.f - p.hang_bm;
  for (int j = 0; j < ntiles; ++j) {
    const int cnt = min(TA, T - j * TA);
    const int s = j % STAGES;
    bar_sync(BAR_FULL + s, 64);
    float2* st = stage + (s * CB + lane) * SS;
    // each step's inputs read one step ahead (the read at i + 1 = TA lands
    // on the row's pad)
    float2 next = st[0];
    for (int i = 0; i < cnt; ++i) {  // walk
      const float2 cur = next;
      next = st[i + 1];
      machine_step(m, p, a_f, a_h, hang_level, min_volts, cur.x,
                   fabsf(cur.y));
      st[i].x = m.volts;
    }
    bar_arrive(BAR_VOLTS + s, 32 + GAIN_THREADS);
  }
  if (lane < nc) store_machine(m, carry_out, C, c0 + lane);
}

template <bool ROWS>
__device__ void agc_gain(const float* __restrict__ rows, int C, int c0,
                         int nc, int T, int ntiles, const Params& p,
                         const float2* stage, float* __restrict__ y,
                         int gt) {
  const int lane = gt & 31, gw = gt >> 5;
  // this thread's channels: gw, gw + GAIN_WARPS, ...
  float slope[GAIN_CH];
#pragma unroll
  for (int k = 0; k < GAIN_CH; ++k) {
    const int c = gw + k * GAIN_WARPS;
    slope[k] = p.slope;
    if constexpr (ROWS) {
      if (c < nc) slope[k] = rows[1 * (size_t)C + c0 + c];
    }
  }
  for (int j = 0; j < ntiles; ++j) {
    const int cnt = min(TA, T - j * TA);
    const int s = j % STAGES;
    bar_sync(BAR_VOLTS + s, 32 + GAIN_THREADS);
    // every channel's law is computed (a row past nc holds what the stage
    // held before) and only the block's are stored: no branch keeps the
    // eight apart, so their logs interleave; each division then runs with
    // its own check
    float2 vx[GAIN_CH];
    float num[GAIN_CH];
#pragma unroll
    for (int k = 0; k < GAIN_CH; ++k) {  // gain law
      vx[k] = stage[(s * CB + gw + k * GAIN_WARPS) * SS + lane];
      const float vo = fminf(log10f(p.inv_max_input * vx[k].x), 0.f);
      num[k] = p.out_target - slope[k] * vo;
    }
    if (j + STAGES < ntiles) bar_arrive(BAR_FREE + s, 32 + GAIN_THREADS);
    const bool in_t = lane < cnt;
    float* yt = y + (size_t)c0 * T + j * TA + lane;
#pragma unroll
    for (int k = 0; k < GAIN_CH; ++k) {  // gain law stores
      const int c = gw + k * GAIN_WARPS;
      const float g = num[k] / vx[k].x;
      if (in_t && c < nc) yt[(size_t)c * T] = vx[k].y * g;
    }
  }
}

// rows: (3, C) [min_volts, slope_constant, hang_level] when ROWS, else
// not read.  Warp 0 walks, warp 1 is the front, warps 2-5 the gain law.
template <bool ROWS>
__global__ void __launch_bounds__(THREADS, 2) agc_kernel(
    const float* __restrict__ x, const float* __restrict__ delay,
    const float* __restrict__ carry, const float* __restrict__ rows, int C,
    int T, int w, Params p, float* __restrict__ y,
    float* __restrict__ carry_out, float* __restrict__ delay_out) {
  extern __shared__ float4 smem4[];
  const Geometry g = geometry(w);
  float2* stage = reinterpret_cast<float2*>(smem4);   // [STAGES][CB][SS]
  float* hmax = reinterpret_cast<float*>(stage + STAGES * CB * SS);
  float* ring = hmax + CB * g.hs;
  const int c0 = blockIdx.x * CB;
  const int nc = min(CB, C - c0);
  const int ntiles = (T + TA - 1) / TA;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0)
    agc_walker<ROWS>(carry, rows, C, c0, nc, T, ntiles, p, stage, carry_out,
                     lane);
  else if (warp == 1)
    agc_front(x, delay, delay_out, c0, nc, T, w, ntiles, g, stage, ring, hmax,
              lane);
  else
    agc_gain<ROWS>(rows, C, c0, nc, T, ntiles, p, stage, y,
                   threadIdx.x - 64);
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

  for (int t0 = 0; t0 < T; t0 += TS) {
    const int cnt = min(TS, T - t0);
    for (int i = tid; i < CB * TS; i += SCAN_THREADS) {
      const int c = i / TS, j = i % TS;
      if (c < nc && j < cnt) {
        const size_t o = (size_t)(c0 + c) * T + t0 + j;
        rms[c][j] = rm[o];
        axs[c][j] = ax[o];
      }
    }
    __syncthreads();
    if (walker) {
      // Each step's inputs are read one step ahead: both tiles lie in
      // shared memory, so the compiler cannot itself move the next loads
      // above this step's store of volts, and the walk would wait on
      // them.  (The read at j + 1 = TS lands on the rows' pad column.)
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
    for (int i = tid; i < CB * TS; i += SCAN_THREADS) {
      const int c = i / TS, j = i % TS;
      if (c < nc && j < cnt)
        volts_out[(size_t)(c0 + c) * T + t0 + j] = rms[c][j];
    }
    __syncthreads();
  }
  if (walker) store_machine(m, carry_out, C, c0 + tid);
}

template <bool ROWS>
cudaError_t launch_agc(const Params& p, const float* x, const float* delay,
                       const float* carry, const float* rows, int C, int T,
                       int w, float* y, float* carry_out, float* delay_out,
                       cudaStream_t stream) {
  const Geometry g = geometry(w);
  cudaError_t e = cudaFuncSetAttribute(
      agc_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e != cudaSuccess) return e;
  // all of the SM's 228 KB as shared memory: two blocks of up to 104 KB
  e = cudaFuncSetAttribute(agc_kernel<ROWS>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const int grid = (C + CB - 1) / CB;
  agc_kernel<ROWS><<<grid, THREADS, g.smem, stream>>>(
      x, delay, carry, rows, C, T, w, p, y, carry_out, delay_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int uhsdr_agc_max_window() { return MAXW; }

// K3's dynamic shared memory at look-ahead w (the same with rows: a gain
// thread keeps its slopes in registers), or -1 outside 1..MAXW.
int uhsdr_agc_smem(int w) { return w >= 1 && w <= MAXW ? geometry(w).smem : -1; }

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
  if (rows == nullptr)
    return (int)launch_agc<false>(
        p, (const float*)x, (const float*)delay, (const float*)carry,
        nullptr, C, T, w, (float*)y, (float*)carry_out, (float*)delay_out,
        (cudaStream_t)stream);
  return (int)launch_agc<true>(
      p, (const float*)x, (const float*)delay, (const float*)carry,
      (const float*)rows, C, T, w, (float*)y, (float*)carry_out,
      (float*)delay_out, (cudaStream_t)stream);
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
