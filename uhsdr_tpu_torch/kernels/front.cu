// K1, the fused RX front, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel uhsdr_tpu/pallas/fir.py::_fir_kernel_rt_s2
// (entered from fir_decimate_pallas's fuse2 branch, chain/rx.py:840-855).
// Per channel, in one pass over the block:
//   int16 (or f32) IQ planes -> f32 * in_scale;  per-channel max(|i|,|q|);
//   rotation by exp(j*2pi*(phase0 + delta*n)/2^32), uint32 modular phase
//     (the carried history is RAW pre-mix IQ and is rotated at
//     n = j - (taps-1), the contract of chain/rx.py:723-755);
//   stage A: real-tap decimating FIR, output m at input index m*decim;
//   stage B: complex-tap FIR at the decimated rate, real output
//     Re(zA (*) g) (the fused Hilbert pair, I±Q);
//   emits the audio, the new raw history (last n_keep >= taps-1 scaled
//   inputs), the new stage-B history (last taps2-1 stage-A outputs) and
//   the peaks.
// The two-channel modes (iq, ssbstereo) run the same kernel with NB = 2
// stage-B filters on the one stage-A output: the reference's input-rate
// (2, taps) filter pair dec (*) upsample(g_k) (chain/rx.py:364-398) is,
// by the noble identity, stage A then g_k at the decimated rate.  Their
// raw history is the pair's (n_keep = taps-1 + decim*(taps2-1)), so the
// kernel reads the last taps-1 of a longer carry and writes n_keep.
//
// Bound on this card: operations.  At 8192 ch x 16384 samples, decim 8,
// 227 + 199 taps it is 7.6 G FMA (stage A) + 6.7 G FMA (stage B) of FP32
// on the CUDA cores (no tensor cores, no TF32), against 0.58 GB of memory
// traffic; NB = 2 doubles stage B.  An SM issues four FMA warp
// instructions a clock but serves one shared-memory wavefront, so a FIR
// that loads a tap and a sample for each FMA is held by its shared loads
// (PR 6's body, one output a thread: ~1,480 warp loads against 852 FMAs
// an output, 8.9x the FMA bound).
//
// Design (a register-blocked FIR).  One thread block of NT threads per
// channel walks the block's time tiles IN ORDER (blocks run in no order,
// so the TPU's sequential time grid becomes a loop inside the block).  A
// tile is T_TILE outputs (about TILE_BYTES of each plane; more where a
// halo would not fit), in linear shared-memory buffers whose first
// columns hold the halo; at a tile's end the last columns are copied to
// the front, so no index wraps.
//   staging: the next tile's planes are copied to shared memory by
//     cp.async (16 bytes a thread) while this tile is filtered, so no
//     thread waits on device memory inside the tile loop.
//   load: a thread takes 8 consecutive staged samples, one sincospif on
//     the exact uint32 phase of the first and a complex product with a
//     per-block table e^{j 2pi delta r / 2^32}, r < 8, for the others,
//     and stores them polyphase (row = sample mod decim) so stage A's
//     sequences are contiguous.
//   stage A: a thread owns R consecutive outputs of one group of
//     polyphase rows; for row b it slides a window of R samples through
//     registers, so each tap (a broadcast load) and each new sample (one
//     load) feed 2R FMAs.  Rows are zero-padded to whole chunks of R taps
//     (10-14% more FMAs than the taps need, against a guarded tail chunk
//     that measured slower), so the hot loop has no test.  The rows are
//     split over P groups so that every thread works at every
//     decimation; the P partial sums are added in a fixed order.
//   stage B: the same window over the stage-A outputs, the taps kept as
//     (gr, -gi) pairs (NB = 2: one float4 for both filters) and padded
//     with zeros to whole chunks, split over PB groups, the partial sums
//     added in a fixed order.
//   Shared buffers are padded one word in R (index i + i/R), so threads
//   R outputs apart read distinct banks.  Every sum's order depends on
//   the shapes alone, never on the channel count or a channel's place in
//   the launch: batching channels changes no bit.  For finite inputs the
//   zero taps change no bit of a sum; a non-finite sample reaches the
//   few outputs whose padded taps span it.
// What holds it now: at the SSB flagship it runs at ~2.8x its FMA bound;
// stage A, stage B and the load each cost a share (PERF.md section 6,
// `python -m uhsdr_tpu_torch.trace_front`), no one of them dominant.
//
// K5, the real-tap decimating front of AM, SAM and FM, is K1 with no
// stage B (front_kernel<Tin, 0, NCO>).  It replaces
// uhsdr_tpu/pallas/fir.py::_fir_kernel_rt_s (fir_decimate_pallas's
// real-taps branch, entered from chain/rx.py:857 for the AM/SAM fronts
// and :763 for FM's).  Per channel: K1's scale and peaks; the rotation
// only with the NCO on (NCO = false: each sample is only scaled, the
// phase is not read); y[m] = sum_k h[k] z[m*decim - k] on both planes;
// y written as two f32 planes, one interleaved complex64 array or the
// real plane alone; the new raw history (the last taps-1 scaled inputs)
// and the peaks.  It has no stage-B buffers.  FreeDV's fronts (many
// channels, each at its own offset) give it a delta a channel: the DROW
// instance reads channel c's from a (C,) tensor once, at the block's start,
// and builds its rotor table from it as the others do from their one.  With one row group (P = 1)
// a thread writes its R outputs straight out; with more, one thread an
// output adds the P partial sums in order and writes it (coalesced
// float2 or f32 stores).  Its tile is K1's, halved until the block's
// shared memory is within SMEM_AIM, so three blocks of 4 warps share an
// SM at every shape the chains send it (decimation 1 to 16).  Bound on
// this card: operations.  At the SAM flagship (8192 ch x 16384 int16,
// decim 4, 239 taps) it is 16.0 G FMA of FP32 against 0.77 GiB of memory
// traffic.
//
// K7 and K6, the complex-tap wide-SSB front, are K5 with complex stage-A
// taps (front_kernel<Tin, 0, NCO, A_CX_RE> for the chain's real output,
// A_CX for the complex one).  They replace
// uhsdr_tpu/pallas/fir.py::_fir_nco_kernel (:370, K7, the NCO fused) and
// ::_fir_kernel (:47, K6, no NCO), fir_decimate_pallas's complex-taps
// branch (-> :863), entered from chain/rx.py:857 for the wide-SSB fronts
// (one complex FIR g_h (*) dec whose real part is the SSB audio):
//   y[m] = sum_k h[k] z[m*decim - k], h = hr + j hi,
//   Re y = sum hr zr - hi zi,  Im y = sum hr zi + hi zr.
// Bound on this card: operations.  At the wide-SSB flagship (8192 ch x
// 16384 int16 @ 96 kHz, decim 4, 245 taps, real output) it is 16.44 G FMA
// of FP32, 0.4908 ms at 33.5 T FMA/s, against 0.63 GiB of memory traffic;
// the rows padded to whole chunks (4 x 64 taps) make it 17.18 G FMA.  The
// real output is K5's work on a second tap plane: the taps are stored
// polyphase as (hr, -hi) pairs, zero-padded to whole chunks of R, so one
// float4 broadcast serves two taps (K8's form), and K5's two accumulator
// arrays take ar += hr zr and ai += (-hi) zi, one FMA each a tap and an
// output (K5's register count and dependency chains); the output is
// ar + ai, after the P groups' ordered sum where P > 1.  The complex
// output takes four FMAs a tap into the two arrays.  Everything else is
// K5's: the tiles, cp.async staging, the rotation, the polyphase store,
// the raw history, the peaks and the three output kinds; the tap buffer is
// twice K5's (cuda/fir.py::fir_cx_geometry), and shared memory is the one
// limit on the taps and the decimation.
//
// K15, the modulated-taps front, replaces
// uhsdr_tpu/pallas/fir.py::_fir_kernel_rt_s2_mt, which the reference
// selects for a static NCO delta under UHSDR_FRONT_MT=1 (fir.py:589-593):
// the translation folded into complex stage-A taps h'[k] = h[k]
// e^{-j delta k} (hc = h cos(delta k), hs = -h sin(delta k), built on the
// host from the exact uint32 phase in float64), stage A on the raw,
// unrotated input (no rotation of the block or of the raw history), and
// the absolute rotor e^{j(phase0 + delta decim m)} applied to the
// decimated stage-A output, its uint32 phase exact at that rate:
//   y[m] = e^{j(phase0 + delta m decim)} sum_k h'[k] x[m decim - k].
// Stage B, the peaks and both carries are K1's.  The TPU kernel runs its
// dots in one bf16 pass; this one in FP32 FMAs, as every kernel here.
// Complex taps double stage A's FMAs (21.9 G at the SSB flagship: bound
// by operations, 0.654 ms at 33.5 T FMA/s, against 0.58 GB of memory).
// It is K1's register-blocked kernel with K6's complex stage A
// (front_kernel<Tin, 1, true, A_CX>, MT below): the block and the raw
// history are loaded unrotated, as K6 loads them; stage A runs
// chunk_a<A_CX>, four FMAs a tap and an output, the taps (hr, -hi) pairs
// two to a float4 broadcast; the rotor moves from the input to the
// stage-A outputs, one sincospif an output on the exact uint32 phase
// phase0 + (delta decim mod 2^32) m, where K1 spends one on 8 input
// samples (the same count: decim 8); only the rotated outputs go on to
// stage B and its carry.  The tiles are K1's rule with the stage-A tap
// buffer doubled (cuda/fir.py::front_mt_geometry).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- K1 geometry (cuda/fir.py::front_geometry mirrors it) ----
constexpr int NT = 128;          // threads per block
constexpr int R = 8;             // outputs a thread holds in registers
constexpr int TILE_BYTES = 8192; // bytes of a plane a tile aims at
constexpr int SMEM_MAX = 225 * 1024;   // dynamic shared memory, bytes
constexpr int G = 8;             // samples a thread rotates at once
// K5's aim, bytes: three blocks an SM (3 x (72 KB + 1 KB the block
// reserves) within the SM's 228 KB)
constexpr int SMEM_AIM = 72 * 1024;

enum OutKind { OUT_PLANES = 0, OUT_INTERLEAVED = 1, OUT_REAL = 2 };
// stage A's taps: real (K1, K5), or complex (K6, K7) kept as (hr, -hi)
// with the real part of the output alone (A_CX_RE) or all of it (A_CX)
enum TapsA { A_REAL = 0, A_CX_RE = 1, A_CX = 2 };

__device__ __forceinline__ float as_f32(int16_t v) { return (float)v; }
__device__ __forceinline__ float as_f32(float v) { return v; }

// exp(j*2pi*ph/2^32): the signed reinterpretation shifts the angle by
// -2pi at most, invisible to sin/cos; sincospif keeps full f32 accuracy.
__device__ __forceinline__ void rotor(uint32_t ph, float* s, float* c) {
  const float x = (float)(int32_t)ph * 4.656612873077392578125e-10f;
  sincospif(x, s, c);
}

// the padded index of a buffer element: one spare word in R, so threads
// R elements apart read distinct banks (i >= 0)
__host__ __device__ __forceinline__ int pad(int i) {
  return i + (int)((unsigned)i / R);
}

__host__ __device__ __forceinline__ int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

struct Geom {
  int e;       // column of a row's sample 0 (= ap)
  int ze;      // index of stage-A output 0: taps2 rounded up to R
  int ap;      // polyphase tap row length: ceil(taps/decim) rounded up to R
  int t_tile;  // outputs a tile, a multiple of R
  int p;       // polyphase-row groups in stage A
  int pb;      // tap groups in stage B
  int rs;      // row stride of the input buffer (float2)
  int zs;      // stage-B buffer length (float2)
  int pt;      // partial-sum row length (padded)
  int st;      // staging buffer of a plane (floats)
  int smem;    // dynamic shared memory, bytes
};

// floats of the partial-sum buffer: stage A's P groups (two planes) and
// stage B's PB groups of nb filters; K5 (nb = 0) with one group has none
__host__ __device__ __forceinline__ int part_floats(const Geom& g, int nb) {
  if (nb == 0) return g.p > 1 ? g.pt * 2 * g.p : 0;
  return g.pt * (2 * g.p > nb * g.pb ? 2 * g.p : nb * g.pb);
}

// The tile geometry for (taps, taps2, decim, nb) on planes of in_bytes a
// sample; false if it does not fit.  nb = 0 is K5 (taps2 unused): no
// stage-B buffers, and the tile halved (down to the halo) until the
// buffers are within SMEM_AIM; cx is K6/K7 (nb = 0) or K15 (nb = 1),
// whose stage-A taps take two floats.  cuda/fir.py::front_geometry is
// the same rule.
bool geometry(int taps, int taps2, int decim, int nb, int in_bytes,
              Geom* g, bool cx = false) {
  if (taps < 1 || decim < 1 || nb < 0 || nb > 2 || (nb > 0 && taps2 < 1) ||
      (cx && nb > 1))
    return false;
  const int a0 = (taps + decim - 1) / decim;    // taps of polyphase row 0
  g->ap = round_up(a0, R);
  g->e = g->ap;
  g->ze = nb > 0 ? round_up(taps2, R) : 0;
  const int need = (nb > 0 && taps2 - 1 > g->e + 1 ? taps2 - 1 : g->e + 1);
  const int lo = (need + R - 1) / R;            // tiles longer than halos
  int nob = TILE_BYTES / in_bytes / (decim * R);
  nob = nob > lo ? nob : lo;
  long floats;
  for (;;) {
    g->t_tile = nob * R;
    const int share = NT / nob > 1 ? NT / nob : 1;
    g->p = share < decim ? share : decim;
    g->pb = nb == 0 ? 0 : share < taps2 ? share : taps2;
    g->rs = pad(g->e + g->t_tile) + 1;
    g->zs = nb > 0 ? pad(g->ze + g->t_tile - 1) + 1 : 0;
    g->pt = pad(g->t_tile - 1) + 1;
    g->st = round_up(g->t_tile * decim * in_bytes, 16) / 4;
    floats = 2L * g->st + round_up(2 * decim * g->rs, 4) +
             round_up(2 * g->zs, 4) +
             round_up((cx ? 2 : 1) * decim * g->ap, 4) + 2 * nb * g->ze +
             round_up(part_floats(*g, nb), 4) + 2 * G;
    if (nb > 0 || floats * 4 <= SMEM_AIM || nob == lo) break;
    nob = nob / 2 > lo ? nob / 2 : lo;
  }
  if (floats * 4 > SMEM_MAX) return false;
  g->smem = (int)(floats * 4);
  return true;
}

// 16-byte asynchronous copies from device memory to shared memory
// (cp.async: no register holds the data, so the copy of the next tile
// runs under this tile's FIR work)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage tb samples of both planes from sample n0 of this channel's rows
// into si, sq: asynchronous 16-byte copies where the rows are aligned
// (`vec`), element copies for the rest.
template <typename Tin>
__device__ __forceinline__ void stage_tile(const Tin* __restrict__ xi,
                                           const Tin* __restrict__ xq,
                                           int n0, int tb, bool vec, Tin* si,
                                           Tin* sq) {
  constexpr int V = 16 / sizeof(Tin);   // samples in 16 bytes
  const int nv = vec ? tb / V : 0;
  for (int k = threadIdx.x; k < nv; k += NT) {
    cp_async16(si + k * V, xi + n0 + k * V);
    cp_async16(sq + k * V, xq + n0 + k * V);
  }
  for (int k = nv * V + threadIdx.x; k < tb; k += NT) {
    si[k] = xi[n0 + k];
    sq[k] = xq[n0 + k];
  }
  cp_async_commit();
}

// 8 staged samples of one plane as floats (16-byte shared loads).  int16
// to exact floats: x = float(2^23 + (x + 2^15)) - (2^23 + 2^15), built
// from the bits (integer work and FADD in place of the slower I2F).
__device__ __forceinline__ void unpack8(const int16_t* p, float* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned ws[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned u = ws[k] ^ 0x80008000u;
    x[2 * k] = __uint_as_float(0x4B000000u | (u & 0xffffu)) - 8421376.f;
    x[2 * k + 1] = __uint_as_float(0x4B000000u | (u >> 16)) - 8421376.f;
  }
}

__device__ __forceinline__ void unpack8(const float* p, float* x) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// stage B's taps: (gr, -gi) for one filter, both filters in one float4
// (K5, NB = 0: none)
template <int NB> struct Taps2;
template <> struct Taps2<0> { using T = float; };
template <> struct Taps2<1> { using T = float2; };
template <> struct Taps2<2> { using T = float4; };

__device__ __forceinline__ void acc_b(float* y, float2 g, float2 z) {
  y[0] = fmaf(g.x, z.x, y[0]);
  y[0] = fmaf(g.y, z.y, y[0]);
}
__device__ __forceinline__ void acc_b(float* y, float4 g, float2 z) {
  y[0] = fmaf(g.x, z.x, y[0]);
  y[0] = fmaf(g.y, z.y, y[0]);
  y[1] = fmaf(g.z, z.x, y[1]);
  y[1] = fmaf(g.w, z.y, y[1]);
}

// Stage A, one chunk of R taps a0 .. a0+R-1 of polyphase row b for R
// outputs: hb = the row's taps from a0 (zero past the row's end; AK !=
// A_REAL: (hr, -hi) pairs, two to a float4), xr = the row at column
// R*(E/R + ob - a0/R).  Output r takes u_b[ob*R + r - a] from w[(r - a) %
// R]; step i brings u_b[ob*R - a - 1] into the slot the last output has
// used (at the chunk's last step only if `more` chunks follow).  A_REAL:
// ar, ai += h z; A_CX_RE: ar += hr zr, ai += -hi zi (Re y = ar + ai);
// A_CX: ar += hr zr - hi zi, ai += hr zi + hi zr.
template <int AK>
__device__ __forceinline__ void chunk_a(float (&ar)[R], float (&ai)[R],
                                        float2 (&w)[R],
                                        const float* __restrict__ hb,
                                        const float2* xr, bool more) {
  float4 h4;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float hk, hn;   // the real tap, or hr and -hi
    if constexpr (AK == A_REAL) {
      if (i % 4 == 0) h4 = *reinterpret_cast<const float4*>(hb + i);
      hk = i % 4 == 0 ? h4.x : i % 4 == 1 ? h4.y : i % 4 == 2 ? h4.z : h4.w;
      hn = 0.f;
    } else {
      if (i % 2 == 0) h4 = *reinterpret_cast<const float4*>(hb + 2 * i);
      hk = i % 2 == 0 ? h4.x : h4.z;
      hn = i % 2 == 0 ? h4.y : h4.w;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 v = w[(r - i + R) % R];
      if constexpr (AK == A_REAL) {
        ar[r] = fmaf(hk, v.x, ar[r]);
        ai[r] = fmaf(hk, v.y, ai[r]);
      } else if constexpr (AK == A_CX_RE) {
        ar[r] = fmaf(hk, v.x, ar[r]);
        ai[r] = fmaf(hn, v.y, ai[r]);
      } else {
        ar[r] = fmaf(hk, v.x, ar[r]);
        ar[r] = fmaf(hn, v.y, ar[r]);
        ai[r] = fmaf(hk, v.y, ai[r]);
        ai[r] = fmaf(-hn, v.x, ai[r]);
      }
    }
    if (i < R - 1 || more) w[(R - 1 - i) % R] = xr[-i - 2];
  }
}

// K5's output m: (re, im) as out_kind asks
__device__ __forceinline__ void put_out(float* __restrict__ out_a,
                                        float* __restrict__ out_b,
                                        int out_kind, size_t m, float re,
                                        float im) {
  if (out_kind == OUT_INTERLEAVED) {
    reinterpret_cast<float2*>(out_a)[m] = make_float2(re, im);
  } else {
    out_a[m] = re;
    if (out_kind == OUT_PLANES) out_b[m] = im;
  }
}

// Stage B, one chunk of R taps k0 .. k0+R-1 (zero past taps2): gk = the
// taps from k0, zr = the stage-A buffer at index R*(ZE/R + ob - k0/R);
// the window walks as in chunk_a.
template <int NB, typename GT>
__device__ __forceinline__ void chunk_b(float (&y)[R][NB], float2 (&w)[R],
                                        const GT* __restrict__ gk,
                                        const float2* zr, bool more) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const GT g = gk[i];
#pragma unroll
    for (int r = 0; r < R; ++r) acc_b(y[r], g, w[(r - i + R) % R]);
    if (i < R - 1 || more) w[(R - 1 - i) % R] = zr[-i - 2];
  }
}

// Buffers (shared memory, float2 unless noted):
//   si, sq (Tin): the raw planes of a tile, staged;
//   xbuf: D rows of RS; sample n of the tile (n < 0: the halo) in row
//     n mod D, column E + floor(n/D) + (n mod D > 0), so that row
//     (D - b) % D holds u_b[j] = x[jD - b] at column E + j for every b;
//   zbuf: stage-A output m (m < 0: the halo) at index ZE + m;
//   hp (float): D rows of AP polyphase taps, row b = h[D a + b], zero
//     beyond (AK != A_REAL: (hr, -hi) pairs, rows of 2 AP floats); gt: ZE
//     stage-B taps, zero past taps2; part: partial sums; tab: rotors.
// Every index goes through pad().  E and ZE are multiples of R, so inside
// an R-step chunk every load sits at a compile-time offset from one base.
// NB = 0 is K5 (and with complex taps, AK != A_REAL, K6/K7): no zbuf, gt
// or stage B; the stage-A outputs go to out (and out_b) as out_kind asks
// (A_CX_RE: OUT_REAL alone).  NCO = false (NB = 0 only) skips the
// rotation and never reads phase.  NB = 1 with AK = A_CX is K15 (MT):
// the input unrotated, the rotor on the stage-A outputs.  DROW (K5 with
// the NCO only) reads the channel's delta from deltas[c], once, where
// the others take the one delta_in of every channel.
template <typename Tin, int NB, bool NCO, int AK = A_REAL, bool DROW = false>
__global__ void __launch_bounds__(NT, 3) front_kernel(
    const Tin* __restrict__ xi, const Tin* __restrict__ xq, float in_scale,
    int B, int n_keep, const float2* __restrict__ carry_in,
    const float2* __restrict__ carry2_in, const int64_t* __restrict__ phase,
    const int64_t* __restrict__ deltas, uint32_t delta_in,
    const float* __restrict__ h, int taps, int decim,
    const float* __restrict__ g_re, const float* __restrict__ g_im,
    int taps2, Geom geo, float* __restrict__ out,
    float2* __restrict__ carry_out, float2* __restrict__ carry2_out,
    float* __restrict__ peaks, float* __restrict__ out_b, int out_kind) {
  using GT = typename Taps2<NB>::T;
  // K15: complex stage-A taps ahead of one stage-B filter
  constexpr bool MT = NB > 0 && AK == A_CX;
  static_assert(NB == 0 || AK == A_REAL || (MT && NB == 1 && NCO),
                "complex stage-A taps: K6/K7, or K15 with one stage B");
  static_assert(!DROW || (NB == 0 && AK == A_REAL && NCO),
                "a delta a channel: K5 with the NCO");
  // the input rotated (K1, K5 and K7 with the NCO); K15 rotates stage A's
  // outputs instead
  constexpr bool ROT_IN = NCO && !MT;
  constexpr int TW = AK == A_REAL ? 1 : 2;   // floats a stage-A tap
  extern __shared__ float4 smem4[];
  const int D = decim, E = geo.e, ZE = geo.ze, AP = geo.ap;
  const int T_TILE = geo.t_tile, RS = geo.rs, PT = geo.pt;
  const int HB = taps2 - 1;
  float* sp = reinterpret_cast<float*>(smem4);
  Tin* si = reinterpret_cast<Tin*>(sp);
  Tin* sq = reinterpret_cast<Tin*>(sp + geo.st);
  sp += 2 * geo.st;
  float2* xbuf = reinterpret_cast<float2*>(sp);
  sp += round_up(2 * D * RS, 4);
  float2* zbuf = reinterpret_cast<float2*>(sp);
  sp += round_up(2 * geo.zs, 4);
  float* hp = sp;
  sp += round_up(TW * D * AP, 4);
  GT* gt = reinterpret_cast<GT*>(sp);
  sp += 2 * NB * ZE;
  float* part = sp;
  sp += round_up(part_floats(geo, NB), 4);
  float2* tab = reinterpret_cast<float2*>(sp);
  __shared__ float warp_pk[NT / 32];

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_hist = taps - 1;
  const int T_out = B / D;
  const uint32_t ph0 = NCO ? (uint32_t)phase[c] : 0u;
  const uint32_t delta = DROW ? (uint32_t)deltas[c] : delta_in;
  const size_t row = (size_t)c * B;
  // 16-byte loads where this channel's rows are aligned
  const bool vec = ((reinterpret_cast<uintptr_t>(xi + row) |
                     reinterpret_cast<uintptr_t>(xq + row)) & 15) == 0;
  if (T_out > 0)
    stage_tile(xi + row, xq + row, 0, min(T_TILE, T_out) * D, vec, si, sq);

  for (int k = tid; k < D * AP; k += NT) {
    const int b = k / AP, src = D * (k - b * AP) + b;
    if constexpr (AK == A_REAL) {
      hp[k] = src < taps ? h[src] : 0.f;
    } else {
      const float2 v = src < taps ? reinterpret_cast<const float2*>(h)[src]
                                  : make_float2(0.f, 0.f);
      reinterpret_cast<float2*>(hp)[k] = make_float2(v.x, src < taps ? -v.y
                                                                     : 0.f);
    }
  }
  if constexpr (NB > 0) {
    for (int k = tid; k < ZE; k += NT) {      // zero taps up to ZE
      const bool in = k < taps2;
      const float r0 = in ? g_re[k] : 0.f, i0 = in ? -g_im[k] : 0.f;
      if (NB == 1) {
        reinterpret_cast<float2*>(gt)[k] = make_float2(r0, i0);
      } else {
        reinterpret_cast<float4*>(gt)[k] = make_float4(
            r0, i0, in ? g_re[taps2 + k] : 0.f, in ? -g_im[taps2 + k] : 0.f);
      }
    }
  }
  if (ROT_IN && tid < G) {
    float s, co;
    rotor(delta * (uint32_t)tid, &s, &co);
    tab[tid] = make_float2(co, s);
  }
  // the halo columns 0..E: the raw history (rotated where ROT_IN) where a
  // column holds a sample n in [-(taps-1), 0), zero elsewhere
  const float2* hist = carry_in + (size_t)c * n_keep + (n_keep - n_hist);
  for (int idx = tid; idx < D * (E + 1); idx += NT) {
    const int r = idx / (E + 1), col = idx - r * (E + 1);
    const int n = (col - E - (r > 0)) * D + r;
    float2 z = make_float2(0.f, 0.f);
    if (n < 0 && n >= -n_hist) {
      const float2 v = hist[n + n_hist];
      if constexpr (ROT_IN) {
        float s, co;
        rotor(ph0 + delta * (uint32_t)n, &s, &co);
        z = make_float2(v.x * co - v.y * s, v.x * s + v.y * co);
      } else {
        z = v;
      }
    }
    xbuf[r * RS + pad(col)] = z;
  }
  if constexpr (NB > 0) {
    for (int j = tid; j < ZE; j += NT)
      zbuf[pad(j)] = j >= ZE - HB ? carry2_in[(size_t)c * HB + j - (ZE - HB)]
                                  : make_float2(0.f, 0.f);
  }
  float pk = 0.f;
  cp_async_wait_all();
  __syncthreads();

  const int nob = T_TILE / R;
  const int step_r = (G * NT) % D, step_c = (G * NT) / D;
  int tv = 0;                      // valid outputs of the last tile
  for (int t0 = 0; t0 < T_out; t0 += T_TILE) {
    tv = min(T_TILE, T_out - t0);
    const int n0 = t0 * D, tb = tv * D;

    // scale, peak, rotate, store polyphase
    // sample l0 = G j sits in row l0 % D, column E + l0 / D (+1 in rows
    // > 0); both move by a constant as j moves by NT
    int rr0 = (G * tid) % D, cq0 = E + (G * tid) / D;
    for (int j = tid; j * G < tb; j += NT) {
      const int l0 = j * G;
      const int valid = min(G, tb - l0);
      float a[G], b[G];
      unpack8(si + l0, a);
      unpack8(sq + l0, b);
      // the scale folded into the rotor; the peak taken on raw values
      float s0 = 0.f, c0 = in_scale;
      if constexpr (ROT_IN) {
        rotor(ph0 + delta * (uint32_t)(n0 + l0), &s0, &c0);
        s0 *= in_scale;
        c0 *= in_scale;
      }
      int rr = rr0, cq = cq0;
      int p0 = pad(cq), p1 = pad(cq + 1);    // columns of rows 0 and > 0
#pragma unroll
      for (int r = 0; r < G; ++r) {
        if (r < valid) {
          pk = fmaxf(pk, fmaxf(fabsf(a[r]), fabsf(b[r])));
          float2 z;
          if constexpr (ROT_IN) {
            const float2 t = tab[r];
            const float co = c0 * t.x - s0 * t.y;
            const float sn = s0 * t.x + c0 * t.y;
            z = make_float2(a[r] * co - b[r] * sn, a[r] * sn + b[r] * co);
          } else {
            z = make_float2(a[r] * in_scale, b[r] * in_scale);
          }
          xbuf[rr * RS + (rr > 0 ? p1 : p0)] = z;
        }
        if (++rr == D) {
          rr = 0;
          p0 = p1;
          p1 = pad(++cq + 1);
        }
      }
      rr0 += step_r;
      cq0 += step_c;
      if (rr0 >= D) {
        rr0 -= D;
        ++cq0;
      }
    }
    __syncthreads();
    // the next tile's planes, copied while this one is filtered
    if (t0 + T_TILE < T_out)
      stage_tile(xi + row, xq + row, n0 + tb,
                 min(T_TILE, T_out - t0 - T_TILE) * D, vec, si, sq);

    // stage A, item (ob, pg): outputs m = ob*R + r over the rows of group
    // pg; row b's window w[s % R] holds u_b[ob*R + s] for s in
    // [-a, R-1-a] at tap a
    for (int it = tid; it < nob * geo.p; it += NT) {
      const int ob = it % nob, pg = it / nob;
      if (ob * R >= tv) continue;
      float ar[R], ai[R];
#pragma unroll
      for (int r = 0; r < R; ++r) ar[r] = ai[r] = 0.f;
      const int b_hi = (pg + 1) * D / geo.p;
      for (int b = pg * D / geo.p; b < b_hi; ++b) {
        // u_b[ob*R + s] at column R*(E/R + ob) + s
        const float2* xr = xbuf + (b == 0 ? 0 : D - b) * RS +
                           (R + 1) * (E / R + ob);
        const float* hb = hp + TW * b * AP;
        float2 w[R];
#pragma unroll
        for (int s = 0; s < R; ++s) w[s] = xr[s];
        for (int a0 = 0; a0 < AP; a0 += R, xr -= R + 1)
          chunk_a<AK>(ar, ai, w, hb + TW * a0, xr, a0 + R < AP);
      }
      if constexpr (NB == 0) {
        if (geo.p == 1) {
          // K5, one group: these R sums are the outputs (A_CX_RE: their
          // two parts' sum)
          const size_t o = (size_t)c * T_out + t0 + ob * R;
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (ob * R + r < tv)
              put_out(out, out_b, out_kind, o + r,
                      AK == A_CX_RE ? ar[r] + ai[r] : ar[r], ai[r]);
          continue;
        }
      }
      float2* pp = reinterpret_cast<float2*>(part) + pg * PT + (R + 1) * ob;
#pragma unroll
      for (int r = 0; r < R; ++r) pp[r] = make_float2(ar[r], ai[r]);
    }
    __syncthreads();
    if constexpr (NB == 0) {
      // K5: the P partial sums, in group order, are the outputs (A_CX_RE:
      // their two parts' sum)
      if (geo.p > 1) {
        for (int m = tid; m < tv; m += NT) {
          const float2* pp = reinterpret_cast<const float2*>(part) + pad(m);
          float2 z = pp[0];
          for (int pg = 1; pg < geo.p; ++pg) {
            const float2 v = pp[pg * PT];
            z.x += v.x;
            z.y += v.y;
          }
          put_out(out, out_b, out_kind, (size_t)c * T_out + t0 + m,
                  AK == A_CX_RE ? z.x + z.y : z.x, z.y);
        }
      }
    } else {
      // the P partial sums, in group order, are the stage-A outputs (K15:
      // rotated by e^{j 2pi (phase0 + delta decim m) / 2^32}, the phase's
      // uint32 product exact)
      for (int m = tid; m < tv; m += NT) {
        const float2* pp = reinterpret_cast<const float2*>(part) + pad(m);
        float2 z = pp[0];
        for (int pg = 1; pg < geo.p; ++pg) {
          const float2 v = pp[pg * PT];
          z.x += v.x;
          z.y += v.y;
        }
        if constexpr (MT) {
          float s, co;
          rotor(ph0 + delta * (uint32_t)((t0 + m) * D), &s, &co);
          z = make_float2(z.x * co - z.y * s, z.x * s + z.y * co);
        }
        zbuf[pad(ZE + m)] = z;
      }
      __syncthreads();

      // stage B, item (ob, pbi): taps [k_lo, k_hi) (whole chunks of the ZE
      // zero-padded taps) of outputs m = ob*R + r, y[m] = Re sum_k g[k]
      // z[m - k]; the window w[s % R] holds z[ob*R + s] for s in
      // [-k, R-1-k] at tap k
      for (int it = tid; it < nob * geo.pb; it += NT) {
        const int ob = it % nob, pbi = it / nob;
        if (ob * R >= tv) continue;
        const int k_lo = R * (pbi * (ZE / R) / geo.pb);
        const int k_hi = R * ((pbi + 1) * (ZE / R) / geo.pb);
        float y[R][NB];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int q = 0; q < NB; ++q) y[r][q] = 0.f;
        // z[ob*R - k0 + s] at index R*(ZE/R + ob - k0/R) + s
        const float2* zr = zbuf + (R + 1) * (ZE / R + ob - k_lo / R);
        float2 w[R];
#pragma unroll
        for (int s = 0; s < R; ++s) w[s] = zr[s];
        for (int k0 = k_lo; k0 < k_hi; k0 += R, zr -= R + 1)
          chunk_b(y, w, gt + k0, zr, k0 + R < k_hi);
        float* pp = part + pbi * NB * PT + (R + 1) * ob;
#pragma unroll
        for (int q = 0; q < NB; ++q)
#pragma unroll
          for (int r = 0; r < R; ++r) pp[q * PT + r] = y[r][q];
      }
      __syncthreads();
      // the PB partial sums, in group order, are the audio
      for (int m = tid; m < tv; m += NT) {
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          const float* pp = part + q * PT + pad(m);
          float y = pp[0];
          for (int pbi = 1; pbi < geo.pb; ++pbi) y += pp[pbi * NB * PT];
          out[((size_t)c * NB + q) * T_out + t0 + m] = y;
        }
      }
    }
    if (t0 + T_TILE < T_out) {
      // the next tile's halos: columns T_TILE .. T_TILE+E of each row to
      // 0..E, the last HB stage-A outputs (T_TILE > E, T_TILE >= HB: the
      // copies do not overlap their sources)
      for (int k = tid; k < D * (E + 1); k += NT) {
        const int r = k / (E + 1), col = k - r * (E + 1);
        xbuf[r * RS + pad(col)] = xbuf[r * RS + pad(T_TILE + col)];
      }
      if constexpr (NB > 0) {
        for (int j = ZE - HB + tid; j < ZE; j += NT)
          zbuf[pad(j)] = zbuf[pad(T_TILE + j)];
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // new raw history: the last n_keep samples of (history ++ block),
  // scaled, before rotation
  for (int j = tid; j < n_keep; j += NT) {
    const int n = B - n_keep + j;
    float2 v;
    if (n >= 0) {
      v = make_float2(as_f32(xi[row + n]) * in_scale,
                      as_f32(xq[row + n]) * in_scale);
    } else {
      v = carry_in[(size_t)c * n_keep + (j + B)];
    }
    carry_out[(size_t)c * n_keep + j] = v;
  }
  // new stage-B history: the last HB stage-A outputs
  if constexpr (NB > 0) {
    for (int j = tid; j < HB; j += NT)
      carry2_out[(size_t)c * HB + j] = zbuf[pad(ZE - HB + tv + j)];
  }
  for (int o = 16; o > 0; o >>= 1)
    pk = fmaxf(pk, __shfl_xor_sync(0xffffffffu, pk, o));
  if ((tid & 31) == 0) warp_pk[tid >> 5] = pk;
  __syncthreads();
  if (tid == 0) {
    float m = warp_pk[0];
    for (int w = 1; w < NT / 32; ++w) m = fmaxf(m, warp_pk[w]);
    peaks[c] = m * in_scale;   // max commutes with the rounded scaling
  }
}

struct Args {
  const void *xi, *xq;
  float in_scale;
  int C, B, n_keep;
  const void *carry_in, *carry2_in, *phase;
  uint32_t delta;
  const void* h;
  int taps, decim;
  const void *g_re, *g_im;
  int taps2;
  void *out, *carry_out, *carry2_out, *peaks;
  cudaStream_t stream;
  void* out_b;        // K5: the imaginary plane (out_kind OUT_PLANES)
  int out_kind;       // K5: OutKind
  const void* deltas;  // K5 DROW: (C,) int64 deltas, else unused
};

// K1 (NB = 1, 2; NCO), K5 (NB = 0), K6/K7 (NB = 0, AK != A_REAL) and K15
// (NB = 1, NCO, A_CX); K5 with a delta a channel (DROW)
template <typename Tin, int NB, bool NCO, int AK = A_REAL, bool DROW = false>
int launch_front(const Args& a) {
  Geom geo;
  if (!geometry(a.taps, a.taps2, a.decim, NB, (int)sizeof(Tin), &geo,
                AK != A_REAL))
    return (int)cudaErrorInvalidValue;
  auto kern = front_kernel<Tin, NB, NCO, AK, DROW>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kern,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  kern<<<a.C, NT, geo.smem, a.stream>>>(
      (const Tin*)a.xi, (const Tin*)a.xq, a.in_scale, a.B, a.n_keep,
      (const float2*)a.carry_in, (const float2*)a.carry2_in,
      (const int64_t*)a.phase, (const int64_t*)a.deltas, a.delta,
      (const float*)a.h, a.taps, a.decim,
      (const float*)a.g_re, (const float*)a.g_im, a.taps2, geo,
      (float*)a.out, (float2*)a.carry_out, (float2*)a.carry2_out,
      (float*)a.peaks, (float*)a.out_b, a.out_kind);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1's geometry constants (cuda/fir.py checks its copy against them).
int uhsdr_front_threads() { return NT; }
int uhsdr_front_outputs_per_thread() { return R; }
int uhsdr_front_tile_bytes() { return TILE_BYTES; }
int uhsdr_front_smem_max() { return SMEM_MAX; }
int uhsdr_front_smem_aim() { return SMEM_AIM; }
// K1's (nb 1, 2) or K5's (nb 0, taps2 unused) dynamic shared memory for
// a shape, or -1 where it does not fit.
int uhsdr_front_smem(int taps, int taps2, int decim, int nb, int in_bytes) {
  Geom g;
  return geometry(taps, taps2, decim, nb, in_bytes, &g) ? g.smem : -1;
}
// K6/K7's dynamic shared memory for a shape, or -1 where it does not fit.
int uhsdr_fir_cx_smem(int taps, int decim, int in_bytes) {
  Geom g;
  return geometry(taps, 1, decim, 0, in_bytes, &g, true) ? g.smem : -1;
}
// K15's dynamic shared memory for a shape (K1's with the stage-A tap
// buffer doubled), or -1 where it does not fit.
int uhsdr_front_mt_smem(int taps, int taps2, int decim, int in_bytes) {
  Geom g;
  return geometry(taps, taps2, decim, 1, in_bytes, &g, true) ? g.smem : -1;
}

// in_kind: 0 = int16 planes, 1 = float32 planes.  nb: 1 or 2 stage-B
// filters (g_re, g_im: nb rows of taps2; out: (C, nb, B/decim)).  The raw
// carry rows hold n_keep >= taps-1 samples.  Returns a cudaError_t.
int uhsdr_front_launch(int in_kind, const void* xi, const void* xq,
                       float in_scale, int C, int B, int n_keep,
                       const void* carry_in, const void* carry2_in,
                       const void* phase, unsigned int delta, const void* h,
                       int taps, int decim, const void* g_re,
                       const void* g_im, int taps2, int nb, void* out,
                       void* carry_out, void* carry2_out, void* peaks,
                       void* stream) {
  using Launch = int (*)(const Args&);
  // [in_kind][NB - 1]
  static const Launch table[2][2] = {
      {launch_front<int16_t, 1, true>, launch_front<int16_t, 2, true>},
      {launch_front<float, 1, true>, launch_front<float, 2, true>}};
  if (nb < 1 || nb > 2) return (int)cudaErrorInvalidValue;
  const Args a{xi, xq, in_scale, C, B, n_keep, carry_in, carry2_in, phase,
               delta, h, taps, decim, g_re, g_im, taps2, out, carry_out,
               carry2_out, peaks, (cudaStream_t)stream, nullptr, 0};
  return table[in_kind != 0][nb - 1](a);
}

// K15: K1's interface with one stage-B filter and h (taps,) complex64,
// the modulated stage-A taps h[k] e^{-j delta k}; the rotor runs on the
// stage-A outputs at delta * decim.  Returns a cudaError_t.
int uhsdr_front_mt_launch(int in_kind, const void* xi, const void* xq,
                          float in_scale, int C, int B, int n_keep,
                          const void* carry_in, const void* carry2_in,
                          const void* phase, unsigned int delta,
                          const void* h, int taps, int decim,
                          const void* g_re, const void* g_im, int taps2,
                          void* out, void* carry_out, void* carry2_out,
                          void* peaks, void* stream) {
  const Args a{xi, xq, in_scale, C, B, n_keep, carry_in, carry2_in, phase,
               delta, h, taps, decim, g_re, g_im, taps2, out, carry_out,
               carry2_out, peaks, (cudaStream_t)stream, nullptr, 0};
  return in_kind == 0 ? launch_front<int16_t, 1, true, A_CX>(a)
                      : launch_front<float, 1, true, A_CX>(a);
}

// K5.  in_kind: 0 = int16 planes, 1 = float32 planes.  use_nco: 0 leaves
// the input unrotated (phase is not read).  out_kind: 0 = two f32 planes
// (out_a, out_b), 1 = one interleaved complex64 array (out_a), 2 = the
// real plane alone (out_a).  The raw carry rows hold taps-1 samples.
// Returns a cudaError_t.
int uhsdr_fir_rt_launch(int in_kind, const void* xi, const void* xq,
                        float in_scale, int C, int B, const void* carry_in,
                        int use_nco, const void* phase, unsigned int delta,
                        const void* h, int taps, int decim, int out_kind,
                        void* out_a, void* out_b, void* carry_out,
                        void* peaks, void* stream) {
  using Launch = int (*)(const Args&);
  // [in_kind][use_nco]
  static const Launch table[2][2] = {
      {launch_front<int16_t, 0, false>, launch_front<int16_t, 0, true>},
      {launch_front<float, 0, false>, launch_front<float, 0, true>}};
  if (out_kind < OUT_PLANES || out_kind > OUT_REAL ||
      (out_kind == OUT_PLANES && out_b == nullptr) ||
      (use_nco != 0 && phase == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{xi, xq, in_scale, C, B, taps - 1, carry_in, nullptr, phase,
               delta, h, taps, decim, nullptr, nullptr, 0, out_a, carry_out,
               nullptr, peaks, (cudaStream_t)stream, out_b, out_kind};
  return table[in_kind != 0][use_nco != 0](a);
}

// K5 with the NCO and a delta a channel: uhsdr_fir_rt_launch's
// interface with deltas, (C,) int64 in [0, 2^32), in place of use_nco and
// the one delta.  Returns a cudaError_t.
int uhsdr_fir_rt_rows_launch(int in_kind, const void* xi, const void* xq,
                             float in_scale, int C, int B,
                             const void* carry_in, const void* phase,
                             const void* deltas, const void* h, int taps,
                             int decim, int out_kind, void* out_a,
                             void* out_b, void* carry_out, void* peaks,
                             void* stream) {
  if (out_kind < OUT_PLANES || out_kind > OUT_REAL ||
      (out_kind == OUT_PLANES && out_b == nullptr) || phase == nullptr ||
      deltas == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{xi, xq, in_scale, C, B, taps - 1, carry_in, nullptr, phase,
               0u, h, taps, decim, nullptr, nullptr, 0, out_a, carry_out,
               nullptr, peaks, (cudaStream_t)stream, out_b, out_kind,
               deltas};
  return in_kind == 0 ? launch_front<int16_t, 0, true, A_REAL, true>(a)
                      : launch_front<float, 0, true, A_REAL, true>(a);
}

// K6 (use_nco 0) and K7 (use_nco 1): K5's interface with h (taps,)
// complex64.  out_kind 2 (the real plane alone) runs A_CX_RE, the others
// A_CX.  Returns a cudaError_t.
int uhsdr_fir_cx_launch(int in_kind, const void* xi, const void* xq,
                        float in_scale, int C, int B, const void* carry_in,
                        int use_nco, const void* phase, unsigned int delta,
                        const void* h, int taps, int decim, int out_kind,
                        void* out_a, void* out_b, void* carry_out,
                        void* peaks, void* stream) {
  using Launch = int (*)(const Args&);
  // [in_kind][use_nco][out_kind == OUT_REAL]
  static const Launch table[2][2][2] = {
      {{launch_front<int16_t, 0, false, A_CX>,
        launch_front<int16_t, 0, false, A_CX_RE>},
       {launch_front<int16_t, 0, true, A_CX>,
        launch_front<int16_t, 0, true, A_CX_RE>}},
      {{launch_front<float, 0, false, A_CX>,
        launch_front<float, 0, false, A_CX_RE>},
       {launch_front<float, 0, true, A_CX>,
        launch_front<float, 0, true, A_CX_RE>}}};
  if (out_kind < OUT_PLANES || out_kind > OUT_REAL ||
      (out_kind == OUT_PLANES && out_b == nullptr) ||
      (use_nco != 0 && phase == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{xi, xq, in_scale, C, B, taps - 1, carry_in, nullptr, phase,
               delta, h, taps, decim, nullptr, nullptr, 0, out_a, carry_out,
               nullptr, peaks, (cudaStream_t)stream, out_b, out_kind};
  return table[in_kind != 0][use_nco != 0][out_kind == OUT_REAL](a);
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
