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
// emits the volts series and the carries.  Bound: the same recurrence as
// K3 (its bytes, rm and ax in and volts out, take ~0.06 ms at 8192 x
// 2048).  Design: K3's roles and ring (scan_kernel): the front warp
// copies 32-step tiles of rm and ax into stage planes by cp.async, lanes
// along time, three tiles in flight; the walker warp walks them (lane =
// channel, each step's inputs read one step ahead) and writes the volts
// over rm; four output warps store the volts coalesced.
//
// The linked stereo AGC stage, the port's route for the two-channel
// modes (iq, ssbstereo, SAM stereo; ops/agc.py::run_stereo), is the same
// kernel with the whole stage around the machine (stereo_kernel): per
// channel xfull = delay ++ x on two planes (C, 2, w) and (C, 2, T); K3's
// front warp on both planes forms the linked detector a[n] = max(|L|,
// |R|) as it reads them and its look-ahead max rm by K3's van Herk pass;
// the walker runs the machine on (rm, a of the delayed pair); four
// gain-law warps apply K3's law to both delayed planes and store y (C, 2,
// T); the front writes the new (C, 2, w) delay line.  It replaces the
// torch route around K13 (the concatenation, abs().amax(), unfold().amax(),
// K13, the gain law and the product) and runs where the reference runs
// _run_machine's agc_scan_pallas.  Its shared memory is
// `stereo_geometry(w)` (cuda/agc.py::agc_stereo_geometry): two blocks an
// SM up to w = 96 (98 KB at w 48, 112 KB at 96), one at 192.
// Every max of the look-ahead and of the linked detector keeps a NaN
// (max_nan), as torch.amax, unfold().amax() and jnp.max do.
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

// K13 and the linked stage: the stage holds planes of CB rows of SS
// floats, K13's two (rm -> volts, ax), the stage's three (rm -> volts,
// the delayed L and R); the front keeps AHEAD tiles in flight
constexpr int SCAN_PLANES = 2;
constexpr int STEREO_PLANES = 3;
constexpr int AHEAD = STAGES - 1;

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

// K13's dynamic shared memory: the stage planes
constexpr int scan_smem() {
  return STAGES * SCAN_PLANES * CB * SS * (int)sizeof(float);
}

// The linked stage's at look-ahead w: its stage planes, the suffix
// maxima, the sample ring of two planes (rows of g.as floats, plane 1
// CB rows after plane 0)
__host__ __device__ inline Geometry stereo_geometry(int w) {
  Geometry g = geometry(w);
  g.smem = (STAGES * STEREO_PLANES * CB * SS + 2 * CB * g.as + CB * g.hs) *
           (int)sizeof(float);
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

// max(a, b), NaN if either is (torch.maximum's, clamp_min's and amax's
// rule; fmaxf drops a NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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
// min_volts > 0 either way.  Where rm or volts is not finite, the blended
// form's products by 0 make its volts NaN (0 x inf), and a NaN volts its
// save (0 x NaN): here a non-finite rm enters the candidates as NaN (the
// compare keeps it, so the state is the blended form's), every max keeps
// a NaN as torch.clamp_min and torch.maximum do, and a NaN volts is
// saved.  From finite carries a volts is finite or NaN (then for good),
// a save NaN only after its volts, a hang finite: on every state so
// reached the selects give the blended sums' bits.  a_f, a_h: 1 -
// fast_bm, 1 - hang_bm; hang_level and min_volts are the channel's (its
// row, or the scalars).
__device__ __forceinline__ void machine_step(Machine& m, const Params& p,
                                             float a_f, float a_h,
                                             float hang_level,
                                             float min_volts, float rm,
                                             float ax) {
  m.fba = a_f * m.fba + p.fast_bm * ax;
  m.hba = a_h * m.hba + p.hang_bm * ax;
  const float hc = max_nan(m.hang - 1.f, 0.f);
  const float rmc = isfinite(rm) ? rm : __int_as_float(0x7fffffff);

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
  const float d = rmc - volts;
  const float v_slow = volts + d * k_slow;
  const float v_fast = volts + d * p.fast_d;
  const float v_att = volts + d * p.attack;
  const bool att = rm >= volts;
  const bool f0 = volts > p.pop_ratio * m.fba;
  const bool f1 = volts > m.save;
  const bool fast = (s0 & f0) | (s1 & f1);
  m.volts = max_nan(att ? v_att : fast ? v_fast : v_slow, min_volts);

  m.st = att ? 0 : fast ? 1 : st_slow;
  m.save = ((att & (st >= 2)) | (volts != volts)) ? volts : m.save;
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

// --- K3's three roles (the front warp also the linked stage's) ---------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

// The front warp's copy of x tile t (steps t*TA ..) into the sample ring,
// lanes along time, one cp.async group a tile (empty past the block).  NP
// planes: x is (C, NP, T) and plane p's rows sit p*pl floats on.
template <int NP>
__device__ __forceinline__ void load_tile(const float* __restrict__ x, int T,
                                          int c0, int nc, int t,
                                          const Geometry& g, float* ring,
                                          int pl, int lane) {
  const int n = t * TA + lane;
  if (n < T) {
    const int slot = n % g.ring;     // xfull[w + n]: see agc_front
    for (int c = 0; c < nc; ++c) {  // load
#pragma unroll
      for (int q = 0; q < NP; ++q)
        cp_async4(ring + q * pl + c * g.as + slot,
                  x + ((size_t)(c0 + c) * NP + q) * T + n);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The detector of ring slot s: |x| (K3), or max(|L|, |R|) keeping a NaN
// (the linked stage, plane 1 pl floats on)
template <int NP>
__device__ __forceinline__ float detector(const float* rrow, int s, int pl) {
  if constexpr (NP == 1) {
    return fabsf(rrow[s]);
  } else {
    return max_nan(fabsf(rrow[s]), fabsf(rrow[s + pl]));
  }
}

// The suffix maxima of the segment that ends at ring slot `last`:
// hrow[k] = max detector over the segment's samples k .. w-1, TA samples
// at a time: their loads first, then the chain of maxima (past the
// segment's first sample the chain runs on, and is not stored).
template <int NP>
__device__ __forceinline__ void segment_suffix(const float* rrow, int pl,
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
      v[q] = detector<NP>(rrow, s, pl);
    }
#pragma unroll
    for (int q = 0; q < TA; ++q) {
      h = max_nan(h, v[q]);
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

// Where the front warp writes tile j's outputs n = j*TA + i into stage
// s: K3's float2 row (rm, xfull[n]); the linked stage's three plane rows
// (rm, the delayed L, the delayed R), CB rows apart.
template <int NP> struct Stage;
template <> struct Stage<1> {
  float2* st;
  __device__ __forceinline__ Stage(float* stage, int s, int lane)
      : st(reinterpret_cast<float2*>(stage) + (s * CB + lane) * SS) {}
  __device__ __forceinline__ void put(int i, float rm, float x0,
                                      float) const {
    st[i] = make_float2(rm, x0);
  }
};
template <> struct Stage<2> {
  float* st;
  __device__ __forceinline__ Stage(float* stage, int s, int lane)
      : st(stage + (s * STEREO_PLANES * CB + lane) * SS) {}
  __device__ __forceinline__ void put(int i, float rm, float x0,
                                      float x1) const {
    st[i] = rm;
    st[CB * SS + i] = x0;
    st[2 * CB * SS + i] = x1;
  }
};

// Tile j's rm and xfull of the outputs n = j*TA + i, i < cnt, into the
// stage, one output at a time (for w < TA: several segment ends a tile).
template <int NP, typename Out>
__device__ __forceinline__ void front_tile_any_w(const float* rrow, int pl,
                                                 float* hrow, int w, int R,
                                                 int cnt, FrontPos& f,
                                                 Out out) {
  for (int i = 0; i < cnt; ++i) {
    const float a = detector<NP>(rrow, f.ia, pl);
    f.gm = f.ph == 0 ? a : max_nan(f.gm, a);
    if (f.ph == w - 1) segment_suffix<NP>(rrow, pl, hrow, w, R, f.ia);
    const float hn = hrow[f.ph == w - 1 ? 0 : f.ph + 1];
    out.put(i, max_nan(hn, f.gm), rrow[f.ib],
            NP == 2 ? rrow[f.ib + pl] : 0.f);
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
// outputs (those past cnt are not read).
template <int NP, typename Out>
__device__ __forceinline__ void front_tile(const float* rrow, int pl,
                                           float* hrow, int w, int R,
                                           int cnt, FrontPos& f, Out out) {
  if (w < TA) {
    front_tile_any_w<NP>(rrow, pl, hrow, w, R, cnt, f, out);
    return;
  }
  const float* ga = rrow + f.ia;
  const int xsplit = R - f.ib;      // the delayed samples wrap here
  float gv[TA], hn[TA], xv[TA], xw[TA];   // xw: plane 1 (NP = 2)
#pragma unroll
  for (int i = 0; i < TA; ++i) {
    gv[i] = detector<NP>(ga, i, pl);
    // past the segment's end (ph + 1 + i >= w) this reads a later slot, or
    // the next row, and is replaced below or not used
    hn[i] = hrow[f.ph + 1 + i];
    const int sx = i < xsplit ? f.ib + i : f.ib + i - R;
    xv[i] = rrow[sx];
    if constexpr (NP == 2) xw[i] = rrow[sx + pl];
  }
  // G restarts (from 0: every detector value is >= +0 or NaN) where ph +
  // i = 0 or w
  const int rs = f.ph == 0 ? 0 : w - f.ph;
  float gm = f.gm;
#pragma unroll
  for (int i = 0; i < TA; ++i) {
    gm = max_nan(i == rs ? 0.f : gm, gv[i]);
    gv[i] = gm;
  }
  const int ie = w - 1 - f.ph;    // the segment's end, if in the tile
  if (ie < cnt) {
    segment_suffix<NP>(rrow, pl, hrow, w, R, f.ia + ie);
#pragma unroll
    for (int i = 0; i < TA; ++i)
      if (i >= ie) hn[i] = hrow[i - ie];
  }
#pragma unroll
  for (int i = 0; i < TA; ++i)
    out.put(i, max_nan(hn[i], gv[i]), xv[i], NP == 2 ? xw[i] : 0.f);
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
// (j+1)*TA) while tiles j+1 and j+2 are in flight.  NP = 1: K3 (x (C, T),
// delay (C, w), the float2 stage); NP = 2: the linked stage (x (C, 2, T),
// delay (C, 2, w), two ring planes, the three-plane stage).
template <int NP>
__device__ void agc_front(const float* __restrict__ x,
                          const float* __restrict__ delay,
                          float* __restrict__ delay_out, int c0, int nc,
                          int T, int w, int ntiles, const Geometry& g,
                          float* stage, float* ring, float* hmax,
                          int lane) {
  const int pl = CB * g.as;        // a ring plane's floats
  // xfull[0 .. w) (the delay line) into slots R - w .. R, tiles 0 and 1
  // from slot 0
  for (int c = 0; c < nc; ++c)
#pragma unroll
    for (int q = 0; q < NP; ++q)
      for (int d = lane; d < w; d += 32)
        ring[q * pl + c * g.as + g.ring - w + d] =
            delay[((size_t)(c0 + c) * NP + q) * w + d];
  load_tile<NP>(x, T, c0, nc, 0, g, ring, pl, lane);
  load_tile<NP>(x, T, c0, nc, 1, g, ring, pl, lane);
  asm volatile("cp.async.wait_group 1;" ::: "memory");
  __syncwarp();

  // the delay line is the first segment: its suffix maxima (G restarts at
  // xfull[w], the next segment's first sample)
  const float* rrow = ring + lane * g.as;
  float* hrow = hmax + lane * g.hs;
  segment_suffix<NP>(rrow, pl, hrow, w, g.ring, g.ring - 1);
  FrontPos f{0, 0, g.ring - w, 0.f};
  for (int j = 0; j < ntiles; ++j) {
    // tile j+2 takes the slots of samples at least R earlier, none read
    // after tile j-1
    load_tile<NP>(x, T, c0, nc, j + 2, g, ring, pl, lane);
    const int cnt = min(TA, T - j * TA);
    const int s = j % STAGES;
    if (j >= STAGES) bar_sync(BAR_FREE + s, 32 + GAIN_THREADS);
    const Stage<NP> out(stage, s, lane);
    front_tile<NP>(rrow, pl, hrow, w, g.ring, cnt, f, out);
    bar_arrive(BAR_FULL + s, 64);
    asm volatile("cp.async.wait_group 1;" ::: "memory");   // tile j+1
    __syncwarp();
  }

  // the new delay line: xfull[T .. T+w), still in the ring
  for (int c = 0; c < nc; ++c)
#pragma unroll
    for (int q = 0; q < NP; ++q)
      for (int d = lane; d < w; d += 32)
        delay_out[((size_t)(c0 + c) * NP + q) * w + d] =
            ring[q * pl + c * g.as + (T + d - w + g.ring) % g.ring];
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
    agc_front<1>(x, delay, delay_out, c0, nc, T, w, ntiles, g,
                 reinterpret_cast<float*>(stage), ring, hmax, lane);
  else
    agc_gain<ROWS>(rows, C, c0, nc, T, ntiles, p, stage, y,
                   threadIdx.x - 64);
}

// --- K13's and the linked stage's roles ----------------------------------

// K13's front warp: tiles of rm and ax into stage planes 0 and 1 (lanes
// along time, 4-byte cp.async), AHEAD tiles in flight; tile j is handed
// to the walker once it has landed, and tile j + AHEAD copied into the
// stage the output warps freed.
__device__ void scan_front(const float* __restrict__ rm,
                           const float* __restrict__ ax, int T, int c0,
                           int nc, int ntiles, float* stage, int lane) {
  auto load = [&](int j) {
    const int n = j * TA + lane;
    if (n < T) {
      float* st = stage + (j % STAGES) * SCAN_PLANES * CB * SS + lane;
      for (int c = 0; c < nc; ++c) {
        const size_t o = (size_t)(c0 + c) * T + n;
        cp_async4(st + c * SS, rm + o);  // K13 load
        cp_async4(st + (CB + c) * SS, ax + o);
      }
    }
  };
  for (int m = 0; m < AHEAD; ++m) {
    if (m < ntiles) load(m);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int j = 0; j < ntiles; ++j) {
    // tiles 0 .. j + AHEAD - 1 are committed: tile j has landed when at
    // most AHEAD - 1 groups are pending
    asm volatile("cp.async.wait_group %0;" ::"n"(AHEAD - 1) : "memory");
    __syncwarp();
    bar_arrive(BAR_FULL + j % STAGES, 64);
    const int m = j + AHEAD;
    if (m < ntiles) {
      // its stage held tile m - STAGES: wait until the output warps are
      // done with it
      if (m >= STAGES) bar_sync(BAR_FREE + m % STAGES, 32 + GAIN_THREADS);
      load(m);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
}

// The walker of K13 (LINKED = false: the detector is ax, plane 1) and of
// the linked stage (the detector max(|L|, |R|) of the delayed pair,
// planes 1 and 2, keeping a NaN): lane = channel, carries in registers,
// each step's inputs read one step ahead (the read at i + 1 = TA lands
// on the rows' pad); volts written over rm.  Rows: K13's (2, C)
// [min_volts, hang_level], the stage's (3, C) [min_volts, slope,
// hang_level].
template <bool ROWS, bool LINKED>
__device__ void plane_walker(const float* __restrict__ carry,
                             const float* __restrict__ rows, int C, int c0,
                             int nc, int T, int ntiles, const Params& p,
                             float* stage, float* __restrict__ carry_out,
                             int lane) {
  constexpr int NPL = LINKED ? STEREO_PLANES : SCAN_PLANES;
  Machine m{};
  float hang_level = p.hang_level, min_volts = p.min_volts;
  if (lane < nc) {
    m = load_machine(carry, C, c0 + lane);
    if constexpr (ROWS) {
      min_volts = rows[0 * (size_t)C + c0 + lane];
      hang_level = rows[(LINKED ? 2 : 1) * (size_t)C + c0 + lane];
    }
  }
  const float a_f = 1.f - p.fast_bm;
  const float a_h = 1.f - p.hang_bm;
  for (int j = 0; j < ntiles; ++j) {
    const int cnt = min(TA, T - j * TA);
    const int s = j % STAGES;
    bar_sync(BAR_FULL + s, 64);
    float* rp = stage + (s * NPL * CB + lane) * SS;
    const float* p1 = rp + CB * SS;
    auto det = [&](int i) {
      if constexpr (LINKED) {
        return max_nan(fabsf(p1[i]), fabsf(p1[CB * SS + i]));
      } else {
        return p1[i];
      }
    };
    float r_next = rp[0], a_next = det(0);
    for (int i = 0; i < cnt; ++i) {  // plane walk
      const float r = r_next, a = a_next;
      r_next = rp[i + 1];
      a_next = det(i + 1);
      machine_step(m, p, a_f, a_h, hang_level, min_volts, r, a);
      rp[i] = m.volts;
    }
    bar_arrive(BAR_VOLTS + s, 32 + GAIN_THREADS);
  }
  if (lane < nc) store_machine(m, carry_out, C, c0 + lane);
}

// K13's output warps: the volts of the stage the walker finished, lanes
// along time, stored coalesced; then the stage is free.
__device__ void scan_out(int T, int c0, int nc, int ntiles,
                         const float* stage, float* __restrict__ volts_out,
                         int gt) {
  const int lane = gt & 31, gw = gt >> 5;
  for (int j = 0; j < ntiles; ++j) {
    const int cnt = min(TA, T - j * TA);
    const int s = j % STAGES;
    bar_sync(BAR_VOLTS + s, 32 + GAIN_THREADS);
    float v[GAIN_CH];
#pragma unroll
    for (int k = 0; k < GAIN_CH; ++k)
      v[k] = stage[(s * SCAN_PLANES * CB + gw + k * GAIN_WARPS) * SS + lane];
    if (j + STAGES < ntiles) bar_arrive(BAR_FREE + s, 32 + GAIN_THREADS);
    float* vt = volts_out + (size_t)c0 * T + j * TA + lane;
#pragma unroll
    for (int k = 0; k < GAIN_CH; ++k) {  // volts stores
      const int c = gw + k * GAIN_WARPS;
      if (lane < cnt && c < nc) vt[(size_t)c * T] = v[k];
    }
  }
}

// The linked stage's gain-law warps: K3's law on the volts of the stage
// the walker finished, times both delayed planes, y (C, 2, T) stored
// coalesced (lanes along time).
template <bool ROWS>
__device__ void stereo_gain(const float* __restrict__ rows, int C, int c0,
                            int nc, int T, int ntiles, const Params& p,
                            const float* stage, float* __restrict__ y,
                            int gt) {
  const int lane = gt & 31, gw = gt >> 5;
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
    float v[GAIN_CH], xl[GAIN_CH], xr[GAIN_CH], num[GAIN_CH];
#pragma unroll
    for (int k = 0; k < GAIN_CH; ++k) {  // stage gain law
      const float* rp =
          stage + (s * STEREO_PLANES * CB + gw + k * GAIN_WARPS) * SS + lane;
      v[k] = rp[0];
      xl[k] = rp[CB * SS];
      xr[k] = rp[2 * CB * SS];
      const float vo = fminf(log10f(p.inv_max_input * v[k]), 0.f);
      num[k] = p.out_target - slope[k] * vo;
    }
    if (j + STAGES < ntiles) bar_arrive(BAR_FREE + s, 32 + GAIN_THREADS);
    float* yt = y + (size_t)c0 * 2 * T + j * TA + lane;
#pragma unroll
    for (int k = 0; k < GAIN_CH; ++k) {  // stage gain law stores
      const int c = gw + k * GAIN_WARPS;
      const float g = num[k] / v[k];
      if (lane < cnt && c < nc) {
        yt[(size_t)c * 2 * T] = xl[k] * g;
        yt[((size_t)c * 2 + 1) * T] = xr[k] * g;
      }
    }
  }
}

// K13.  rows: (2, C) [min_volts, hang_level] when ROWS, else not read.
// Warp 0 walks, warp 1 is the front, warps 2-5 store.
template <bool ROWS>
__global__ void __launch_bounds__(THREADS, 2) scan_kernel(
    const float* __restrict__ rm, const float* __restrict__ ax,
    const float* __restrict__ carry, const float* __restrict__ rows, int C,
    int T, Params p, float* __restrict__ volts_out,
    float* __restrict__ carry_out) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);  // [STAGES][2][CB][SS]
  const int c0 = blockIdx.x * CB;
  const int nc = min(CB, C - c0);
  const int ntiles = (T + TA - 1) / TA;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0)
    plane_walker<ROWS, false>(carry, rows, C, c0, nc, T, ntiles, p, stage,
                              carry_out, lane);
  else if (warp == 1)
    scan_front(rm, ax, T, c0, nc, ntiles, stage, lane);
  else
    scan_out(T, c0, nc, ntiles, stage, volts_out, threadIdx.x - 64);
}

// The linked stage.  x, y: (C, 2, T); delay, delay_out: (C, 2, w); rows:
// (3, C) [min_volts, slope_constant, hang_level] when ROWS, else not read.
// Warp 0 walks, warp 1 is the front, warps 2-5 the gain law.
template <bool ROWS>
__global__ void __launch_bounds__(THREADS, 2) stereo_kernel(
    const float* __restrict__ x, const float* __restrict__ delay,
    const float* __restrict__ carry, const float* __restrict__ rows, int C,
    int T, int w, Params p, float* __restrict__ y,
    float* __restrict__ carry_out, float* __restrict__ delay_out) {
  extern __shared__ float4 smem4[];
  const Geometry g = stereo_geometry(w);
  float* stage = reinterpret_cast<float*>(smem4);  // [STAGES][3][CB][SS]
  float* hmax = stage + STAGES * STEREO_PLANES * CB * SS;
  float* ring = hmax + CB * g.hs;                  // [2][CB][g.as]
  const int c0 = blockIdx.x * CB;
  const int nc = min(CB, C - c0);
  const int ntiles = (T + TA - 1) / TA;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0)
    plane_walker<ROWS, true>(carry, rows, C, c0, nc, T, ntiles, p, stage,
                             carry_out, lane);
  else if (warp == 1)
    agc_front<2>(x, delay, delay_out, c0, nc, T, w, ntiles, g, stage, ring,
                 hmax, lane);
  else
    stereo_gain<ROWS>(rows, C, c0, nc, T, ntiles, p, stage, y,
                      threadIdx.x - 64);
}

// One launch of a role-split kernel with `smem` bytes of dynamic shared
// memory, all of the SM's 228 KB set aside as shared memory.
template <typename Kernel, typename... Args>
cudaError_t launch_roles(Kernel kern, int C, int smem, cudaStream_t stream,
                         Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kern<<<(C + CB - 1) / CB, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
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
  const cudaStream_t st = (cudaStream_t)stream;
  const float *r = (const float*)rm, *a = (const float*)ax,
              *c = (const float*)carry, *rw = (const float*)rows;
  float *v = (float*)volts_out, *co = (float*)carry_out;
  return (int)(rows == nullptr
                   ? launch_roles(scan_kernel<false>, C, scan_smem(), st, r,
                                  a, c, rw, C, T, p, v, co)
                   : launch_roles(scan_kernel<true>, C, scan_smem(), st, r,
                                  a, c, rw, C, T, p, v, co));
}

// K13's dynamic shared memory.
int uhsdr_agc_scan_smem() { return scan_smem(); }

// The linked stage's dynamic shared memory at look-ahead w, or -1 outside
// 1..MAXW.
int uhsdr_agc_stereo_smem(int w) {
  return w >= 1 && w <= MAXW ? stereo_geometry(w).smem : -1;
}

// The linked stereo AGC stage: uhsdr_agc_launch's interface with x, y
// (C, 2, T) and delay, delay_out (C, 2, w).  Returns a cudaError_t.
// Requires 1 <= w <= MAXW and T >= 1.
int uhsdr_agc_stereo_launch(const void* x, const void* delay,
                            const void* carry, const void* rows, int C, int T,
                            int w, float attack, float fast_d, float long_d,
                            float hang_d, float fast_bm, float hang_bm,
                            float pop_ratio, float hang_level,
                            float hang_time, float hang_en, float min_volts,
                            float out_target, float slope,
                            float inv_max_input, void* y, void* carry_out,
                            void* delay_out, void* stream) {
  Params p{attack, fast_d, long_d, hang_d, fast_bm, hang_bm, pop_ratio,
           hang_level, hang_time, hang_en, min_volts, out_target, slope,
           inv_max_input};
  if (w < 1 || w > MAXW) return (int)cudaErrorInvalidValue;
  const int smem = stereo_geometry(w).smem;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *xs = (const float*)x, *d = (const float*)delay,
              *c = (const float*)carry, *rw = (const float*)rows;
  float *ys = (float*)y, *co = (float*)carry_out, *dout = (float*)delay_out;
  return (int)(rows == nullptr
                   ? launch_roles(stereo_kernel<false>, C, smem, st, xs, d, c,
                                  rw, C, T, w, p, ys, co, dout)
                   : launch_roles(stereo_kernel<true>, C, smem, st, xs, d, c,
                                  rw, C, T, w, p, ys, co, dout));
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
