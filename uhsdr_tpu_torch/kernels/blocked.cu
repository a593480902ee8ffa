// K2, the fused blocked SOS cascade, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel uhsdr_tpu/pallas/iir.py::_make_blocked_kernel
// (biquad_cascade_blocked_pallas), the fused form of the chains' SOS
// stages: the PreFilter lattice as 5 sections (chain/rx.py), FM's
// 2-section squelch HPF (demod/fm.py) and the TX SOPRANO voice bandpass
// (chain/tx.py).  The whole cascade is one LTI system, run in R = 128
// sample chunks from the tables `ops/iir.py::_cascade_blocked_tables`
// builds in float64 on the host:
//   y_c = x_c M + u_{c-1} HS          (M (R, R) the zero-state Toeplitz
//   u_c = x_c G + u_{c-1} F^T          response, HS (2S, R), G (R, 2S),
//                                      F^T (2S, 2S); u the 2S states)
// with u carried exactly from chunk to chunk, in order (the reference's
// `exact_carry=True`: ~129 dB on the high-Q PreFilter SOS, where powers
// of F jumped across chunks hold ~52 dB).  Plain FP32 FMAs on the CUDA
// cores: TF32 would break the exact carry.
//
// Bound on this card: at the SSB flagship (8192 x 2048, S = 5) 1.43 G FMA
// of FP32 against 134 MB of traffic, about even; FM's squelch (S = 2) by
// its bytes, the TX voice bandpass as the PreFilter.  Per chunk and
// channel the triangle is R(R+1)/2 = 8256 FMAs, the state terms x G and
// u HS 2S R each and the carry u F^T 4 S^2.
//
// Design.  A ROW is one chunk of one channel.  A thread block of NW = 4
// warps walks ROUNDS of LANES = 32 rows: cpw channels x tr = 32 / cpw
// consecutive chunks, lane l of every warp holding row l (channel l / tr,
// chunk l % tr of the round).  `cuda/iir.py::blocked_geometry` picks cpw
// from C, T and S so that the blocks fill the card's waves (fewer
// channels a block, more chunks a round, where C is small).  A round's
// rows sit in a tile in shared memory, 132 floats a row (16-byte rows 16
// bytes apart in the banks: a float4 read of one column by 32 lanes from
// 32 rows takes the four wavefronts its 512 bytes need); a ring of SLOTS
// = 3 tiles is filled by 16-byte cp.async two rounds ahead, so the loads
// overlap the arithmetic of the rounds before.
//   Triangle (register-blocked): the 8 items of RO = 16 outputs of a row
//     go to the warps as the 4 pairs (b, 7 - b), each pair the same work
//     (so no warp waits on a longer share); a lane holds an item's 16
//     outputs and slides a window of 16 samples through registers, each
//     chunk's 16 taps and 16 samples read as float4s during the chunk
//     before, so a chunk is 256 FMAs beside 8 shared loads; the diagonal
//     chunk of taps runs only its 136 useful products (no padded FMA).
//     Then u_{c-1} HS is added and the outputs go out: four lanes swap
//     float4s (a 4 x 4 transpose by shuffles) so that a store writes 8
//     rows' 64-byte segments, where lanes = rows would touch 32 rows.
//   State terms off the serial chain: x_c G, the 2S end-state sums, is
//     summed by every warp over its own pair's 32 samples (like extra
//     output columns), the NW partial sums added in warp order.  Only
//     u_c = x_c G + u_{c-1} F^T runs in order, chunk by chunk, 2S lanes a
//     channel holding u in registers across rounds and exchanging it by
//     shuffles, and it runs one round AHEAD: in round m the warps sum x G
//     of round m+1, meet at the round's one barrier, run the chain of
//     round m+1 (its u_{c-1} for every row to shared memory) and then the
//     triangles of round m, whose u_{c-1} the chain wrote a round before.
// Every sum's order depends on the tables alone (NW is fixed; the chain's
// FMAs run in the same order whichever lane or round holds a row), never
// on C or a channel's place in the launch: batching channels changes no
// bit.
// What holds it now (python -m uhsdr_tpu_torch.trace_blocked): the
// triangle loop compiles to 512 FFMA beside 16 shared loads and 6 other
// instructions a pair of chunks, yet the kernel runs at 38-46% of the
// FP32 peak at 8192 channels: by the instructions a round against its
// time the SMs issue on about 60% of their cycles (an estimate; the card
// has no profiler of stalls here), with three blocks of 4 warps an SM
// (shared memory holds no more), and the last of the three waves of 1024
// blocks is 59% full.  Eight warps a block (8
// outputs a lane), two blocks an SM and the other grids measured slower.
#include <cuda_runtime.h>

namespace {

// ---- geometry (cuda/iir.py::blocked_geometry mirrors it) ----
constexpr int R = 128;             // chunk length
constexpr int RO = 16;             // outputs a lane holds in registers
constexpr int ITEMS = R / RO;      // items of a row
constexpr int PAIRS = ITEMS / 2;   // pairs (b, ITEMS - 1 - b): equal work
constexpr int NW = 4;              // warps a block (sets the x G order)
constexpr int NT = 32 * NW;        // threads a block
constexpr int LANES = 32;          // rows a round, one a lane
constexpr int XS = R + 4;          // tile row stride (floats; see below)
constexpr int SLOTS = 3;           // tiles in the ring
constexpr int MAXS = 8;            // most sections
constexpr unsigned FULL = 0xffffffffu;

static_assert(PAIRS % NW == 0, "the pairs deal out evenly to the warps");
static_assert(RO % 4 == 0 && 32 % (RO / 2) == 0, "float4 items; whole rows");

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Shared memory, in floats, for U = 2S states: h (row 0 of M), HS (U, R),
// GT = G^T (U, R), F^T (U, U), the x G partial sums [2][NW][LANES][U + 1],
// u_{c-1} of each row [2][LANES][U + 1] (rows U + 1 apart, an odd stride:
// the lanes of a row and the lanes of a channel both spread over the
// banks), the tiles [SLOTS][LANES][XS].  (Each channel's latest state
// stays in the registers of the lanes that carry it.)
__host__ __device__ constexpr int ustride(int U) { return U + 1; }

struct Layout {
  int hs, gt, ft, part, uprev, tile, floats;
};

__host__ __device__ constexpr Layout layout(int U) {
  Layout L{};
  int o = R;
  L.hs = o;
  o += U * R;
  L.gt = o;
  o += U * R;
  L.ft = o;
  o += round_up(U * U, 4);
  L.part = o;
  o += round_up(2 * NW * LANES * ustride(U), 4);
  L.uprev = o;
  o += round_up(2 * LANES * ustride(U), 4);
  L.tile = o;
  o += SLOTS * LANES * XS;
  L.floats = o;
  return L;
}

// 16-byte asynchronous copies from device memory to shared memory
// (cp.async: no register holds the data)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
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
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float f4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Column 4q of pair p (q < RO / 2): item p's RO columns, then item
// ITEMS-1-p's.
__device__ __forceinline__ int pair_col(int p, int q) {
  return 4 * q < RO ? RO * p + 4 * q : RO * (ITEMS - 1 - p) + 4 * q - RO;
}

// The rows of a round: row k holds channel c0 + k / tr, chunk m*tr + k%tr
// (tr = 2^ltr: shifts, not divisions, in the staging loop).
struct Round {
  const float* x;
  int C, T, n, c0, ltr, m;
  __device__ bool row(int k, int* ch, int* c) const {
    *ch = c0 + (k >> ltr);
    *c = (m << ltr) + (k & ((1 << ltr) - 1));
    return *ch < C && *c < n;
  }
};

// Stage this warp's pair columns of every row of round `rd` into `tile`
// (one cp.async group, possibly empty).
__device__ __forceinline__ void stage(const Round& rd, float* tile, int warp,
                                      int lane) {
  constexpr int PC = RO / 2;           // a pair's 16-byte columns
  for (int p = warp; p < PAIRS; p += NW) {
    const int col = pair_col(p, lane % PC);
    for (int k = lane / PC; k < LANES; k += 32 / PC) {
      int ch, c;
      if (rd.row(k, &ch, &c))
        cp_async16(tile + k * XS + col,
                   rd.x + (size_t)ch * rd.T + (size_t)c * R + col);
    }
  }
  cp_async_commit();
}

// This warp's x G partial sums for the row of `lane`: its pairs' items in
// order, each item's samples r = 0..RO-1 in order, into part[lane][i].
template <int U>
__device__ __forceinline__ void xg_partial(const float* tile,
                                           const float* __restrict__ gt,
                                           float* part, int warp, int lane) {
  const float* xr = tile + lane * XS;
  float g[U];
#pragma unroll
  for (int i = 0; i < U; ++i) g[i] = 0.f;
  for (int p = warp; p < PAIRS; p += NW) {  // xG
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int s0 = RO * (h2 ? ITEMS - 1 - p : p);
      float xv[RO];
#pragma unroll
      for (int r4 = 0; r4 < RO; r4 += 4) {
        const float4 v = *reinterpret_cast<const float4*>(xr + s0 + r4);
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[r4 + q] = f4(v, q);
      }
#pragma unroll
      for (int i = 0; i < U; ++i) {
#pragma unroll
        for (int r4 = 0; r4 < RO; r4 += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(gt + i * R + s0 + r4);
#pragma unroll
          for (int q = 0; q < 4; ++q) g[i] = fmaf(xv[r4 + q], f4(v, q), g[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < U; ++i) part[lane * ustride(U) + i] = g[i];
}

// The lanes that carry the chain: 2S lanes a channel, in groups of U2 (a
// power of two), GPP channels a pass, the passes dealt out to the warps;
// pass pi of this warp is ps = warp + pi * NW.  Its lane holds state i of
// channel chl of the block, u[pi] across rounds.
template <int U>
struct Carrier {
  static constexpr int U2 = U <= 2 ? 2 : U <= 4 ? 4 : U <= 8 ? 8 : 16;
  static constexpr int GPP = 32 / U2;                // channels a pass
  static constexpr int MAXP = (U2 + NW - 1) / NW;    // passes a warp
  int passes, i, base, warp, lane;
  float u[MAXP];
  __device__ Carrier(int cpw, int warp_, int lane_)
      : passes((cpw + GPP - 1) / GPP), i(lane_ % U2),
        base(lane_ & ~(U2 - 1)), warp(warp_), lane(lane_) {}
  __device__ int chl(int pi) const {
    return (warp + pi * NW) * GPP + lane / U2;
  }
  __device__ bool on(int pi, int cpw) const {
    return warp + pi * NW < passes && chl(pi) < cpw && i < U;
  }
};

// The in-order carry of one round (tv valid chunks a channel): for each
// row, u_{c-1} to uprev[row][i], then u_c = (sum over warps of the x G
// partials) + u_{c-1} F^T.
template <int U>
__device__ __forceinline__ void carry(Carrier<U>& cr, const float* part,
                                      const float* ft_s, float* uprev,
                                      int cpw, int tr, int tv) {
  constexpr int US = ustride(U);
#pragma unroll
  for (int pi = 0; pi < Carrier<U>::MAXP; ++pi) {
    if (cr.warp + pi * NW >= cr.passes) break;
    const bool on = cr.on(pi, cpw);
    const int chl = cr.chl(pi), i = cr.i;
    float ft[U];
#pragma unroll
    for (int j = 0; j < U; ++j) ft[j] = on ? ft_s[j * U + i] : 0.f;
    float u = cr.u[pi];
    for (int t = 0; t < tv; ++t) {
      const int row = chl * tr + t;
      float acc = 0.f;
      if (on) {
        uprev[row * US + i] = u;
        acc = part[row * US + i];
#pragma unroll
        for (int w = 1; w < NW; ++w) acc += part[(w * LANES + row) * US + i];
      }
#pragma unroll
      for (int j = 0; j < U; ++j)
        acc = fmaf(__shfl_sync(FULL, u, cr.base + j), ft[j], acc);
      u = acc;
    }
    cr.u[pi] = u;
  }
}

// One chunk of RO taps k0 .. k0+RO-1 for the RO outputs of an item at s0
// (k0 < s0): hq = the taps, nx = x[s0-k0-RO .. s0-k0-1] (both read one
// chunk ahead).  Output r takes x[s0 + r - k] from w[(r - j) % RO] at tap
// k = k0 + j; step j brings x[s0 - k0 - j - 1] into the slot the last
// output has used, so the window ends as the next chunk's.
__device__ __forceinline__ void chunk(float (&a)[RO], float (&w)[RO],
                                      const float4 (&hq)[RO / 4],
                                      const float4 (&nx)[RO / 4]) {
#pragma unroll
  for (int j = 0; j < RO; ++j) {
    const float hv = f4(hq[j / 4], j % 4);
#pragma unroll
    for (int r = 0; r < RO; ++r) a[r] = fmaf(hv, w[(r - j + RO) % RO], a[r]);
    // x[s0-k0-j-1] is element RO-1-j of nx
    w[(RO - 1 - j) % RO] = f4(nx[(RO - 1 - j) / 4], (RO - 1 - j) % 4);
  }
}

// RO taps from hk and the RO samples ending at xe (exclusive) as float4s.
__device__ __forceinline__ void ahead(float4 (&hq)[RO / 4],
                                      float4 (&nx)[RO / 4],
                                      const float* __restrict__ hk,
                                      const float* xe) {
#pragma unroll
  for (int q = 0; q < RO / 4; ++q) {
    hq[q] = *reinterpret_cast<const float4*>(hk + 4 * q);
    nx[q] = *reinterpret_cast<const float4*>(xe - RO + 4 * q);
  }
}

// The diagonal chunk k0 = s0: the window holds x[0..7]; output r takes
// x[r - j] for j <= r only (the 36 useful products).
__device__ __forceinline__ void diagonal(float (&a)[RO], const float (&w)[RO],
                                         const float4 (&hq)[RO / 4]) {
#pragma unroll
  for (int j = 0; j < RO; ++j) {
#pragma unroll
    for (int r = j; r < RO; ++r) a[r] = fmaf(f4(hq[j / 4], j % 4), w[r - j], a[r]);
  }
}

// The triangles of round `rd` for the row of `lane`: this warp's pairs'
// items, each its zero-state outputs, then u_{c-1} HS, then stored.
template <int U>
__device__ __forceinline__ void triangles(const Round& rd, const float* tile,
                                          const float* __restrict__ hsm,
                                          const float* __restrict__ hs,
                                          const float* uprev,
                                          float* __restrict__ y, int warp,
                                          int lane) {
  const float* xr = tile + lane * XS;
  float up[U];
#pragma unroll
  for (int j = 0; j < U; ++j) up[j] = uprev[lane * ustride(U) + j];
  for (int p = warp; p < PAIRS; p += NW) {
#pragma unroll 1
    for (int h2 = 0; h2 < 2; ++h2) {
      const int s0 = RO * (h2 ? ITEMS - 1 - p : p);
      float a[RO], w[RO];
#pragma unroll
      for (int r4 = 0; r4 < RO; r4 += 4) {
        const float4 v = *reinterpret_cast<const float4*>(xr + s0 + r4);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[r4 + q] = 0.f;
          w[r4 + q] = f4(v, q);
        }
      }
      // the chunks of taps, each chunk's taps and samples read during the
      // chunk before (past the diagonal the samples are not used)
      const float* xw = xr + s0;
      float4 hq[RO / 4], nx[RO / 4];
      ahead(hq, nx, hsm, xw);
#pragma unroll 2
      for (int k0 = 0; k0 < s0; k0 += RO, xw -= RO) {
        float4 hq2[RO / 4], nx2[RO / 4];
        ahead(hq2, nx2, hsm + k0 + RO, xw - RO);
        chunk(a, w, hq, nx);
#pragma unroll
        for (int q = 0; q < RO / 4; ++q) {
          hq[q] = hq2[q];
          nx[q] = nx2[q];
        }
      }
      diagonal(a, w, hq);
#pragma unroll
      for (int j = 0; j < U; ++j) {  // HS
#pragma unroll
        for (int r4 = 0; r4 < RO; r4 += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(hs + j * R + s0 + r4);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a[r4 + q] = fmaf(up[j], f4(v, q), a[r4 + q]);
        }
      }
      // to device memory: the Q = RO/4 lanes of a group swap float4s (a
      // Q x Q transpose in log2 Q xor stages), so that store s writes row
      // (group + s)'s RO outputs, a float4 a lane: RO * 4 contiguous bytes
      // a row, 32 / Q rows a store where lanes = rows would touch 32
      constexpr int Q = RO / 4;
      const int gi = lane & (Q - 1);
      float4 v[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q)
        v[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
#pragma unroll
      for (int m = 1; m < Q; m <<= 1) {
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          if (q & m) continue;
          const float4 snd = (gi & m) ? v[q] : v[q | m];
          const float4 rcv = make_float4(__shfl_xor_sync(FULL, snd.x, m),
                                         __shfl_xor_sync(FULL, snd.y, m),
                                         __shfl_xor_sync(FULL, snd.z, m),
                                         __shfl_xor_sync(FULL, snd.w, m));
          if (gi & m)
            v[q] = rcv;
          else
            v[q | m] = rcv;
        }
      }
#pragma unroll
      for (int s = 0; s < Q; ++s) {
        int ch, c;
        if (rd.row((lane & ~(Q - 1)) + s, &ch, &c))
          *reinterpret_cast<float4*>(y + (size_t)ch * rd.T + (size_t)c * R +
                                     s0 + 4 * gi) = v[s];
      }
    }
  }
}

// Blocks an SM holds by shared memory (an SM's 228 KB, 1 KB reserved a
// block): the registers a thread may take follow from it.
__host__ __device__ constexpr int resident(int U) {
  return 228 * 1024 / (4 * layout(U).floats + 1024);
}

// The state of channel group c0's channels: the carrier lane of (chl, 2s
// + j) loads state[s, c0 + chl, j] (0 past C) or stores it.
template <int U>
__device__ __forceinline__ void load_state(Carrier<U>& cr,
                                           const float* __restrict__ state,
                                           int c0, int C, int cpw) {
#pragma unroll
  for (int pi = 0; pi < Carrier<U>::MAXP; ++pi) {
    const int ch = c0 + cr.chl(pi), i = cr.i;
    cr.u[pi] = cr.on(pi, cpw) && ch < C
                   ? state[((i >> 1) * C + ch) * 2 + (i & 1)] : 0.f;
  }
}

template <int U>
__device__ __forceinline__ void store_state(const Carrier<U>& cr,
                                            float* __restrict__ state_out,
                                            int c0, int C, int cpw) {
#pragma unroll
  for (int pi = 0; pi < Carrier<U>::MAXP; ++pi) {
    const int ch = c0 + cr.chl(pi), i = cr.i;
    if (cr.on(pi, cpw) && ch < C)
      state_out[((i >> 1) * C + ch) * 2 + (i & 1)] = cr.u[pi];
  }
}

// Block b walks the cpw channels from b * cpw through all their rounds.
template <int U>
__global__ void __launch_bounds__(NT, resident(U)) blocked_kernel(
    const float* __restrict__ x, const float* __restrict__ state,
    const float* __restrict__ M, const float* __restrict__ HS,
    const float* __restrict__ G, const float* __restrict__ Ft, int C, int T,
    int cpw, float* __restrict__ y, float* __restrict__ state_out) {
  extern __shared__ float4 smem4[];
  constexpr Layout L = layout(U);
  float* sm = reinterpret_cast<float*>(smem4);
  float* hsm = sm;
  float* hs = sm + L.hs;
  float* gt = sm + L.gt;
  float* ft = sm + L.ft;
  float* part = sm + L.part;
  float* uprev = sm + L.uprev;
  float* tiles = sm + L.tile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tr = LANES / cpw, ltr = __ffs(tr) - 1;
  const int n = T / R;
  const int rounds = (n + tr - 1) / tr;
  const int c0 = (int)blockIdx.x * cpw;
  auto at = [&](int m) { return Round{x, C, T, n, c0, ltr, m}; };
  auto slot = [&](int m) { return tiles + (m % SLOTS) * LANES * XS; };

  // rounds 0 and 1 on their way while the tables load
  stage(at(0), slot(0), warp, lane);
  if (rounds > 1) stage(at(1), slot(1), warp, lane);
  for (int k = tid; k < R; k += NT) hsm[k] = M[k];  // row 0 of M is h
  for (int k = tid; k < U * R; k += NT) {
    hs[k] = HS[k];
    gt[k] = G[(k % R) * U + k / R];
  }
  for (int k = tid; k < U * U; k += NT) ft[k] = Ft[k];
  Carrier<U> cr(cpw, warp, lane);
  load_state(cr, state, c0, C, cpw);
  if (rounds > 1)
    cp_async_wait_one();
  else
    cp_async_wait_all();
  __syncthreads();                                  // the tables
  constexpr int PW = LANES * ustride(U);    // a warp's partial sums
  constexpr int UP = round_up(LANES * ustride(U), 4);
  xg_partial<U>(slot(0), gt, part + warp * PW, warp, lane);
  __syncthreads();
  carry<U>(cr, part, ft, uprev, cpw, tr, min(tr, n));

  for (int m = 0; m < rounds; ++m) {
    const int par = m & 1, nxt = (m + 1) & 1;
    if (m + 1 < rounds) {
      cp_async_wait_all();
      __syncwarp();
      xg_partial<U>(slot(m + 1), gt, part + (nxt * NW + warp) * PW, warp,
                    lane);
    }
    // the round's one barrier: x G of round m+1 and every warp's copies
    // of it visible; round m-1 done by all (its slot and buffers free)
    __syncthreads();
    if (m + 2 < rounds) stage(at(m + 2), slot(m + 2), warp, lane);
    if (m + 1 < rounds)
      carry<U>(cr, part + nxt * NW * PW, ft, uprev + nxt * UP, cpw, tr,
               min(tr, n - (m + 1) * tr));
    triangles<U>(at(m), slot(m), hsm, hs, uprev + par * UP, y, warp, lane);
  }
  store_state(cr, state_out, c0, C, cpw);
}

// The kernel's shared-memory attributes, set once.
template <int U>
cudaError_t configure() {
  auto kern = blocked_kernel<U>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      4 * layout(U).floats);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int U>
int launch(const void* x, const void* state, const void* M, const void* HS,
           const void* G, const void* Ft, int C, int T, int cpw, void* y,
           void* state_out, cudaStream_t stream) {
  static const cudaError_t configured = configure<U>();
  if (configured != cudaSuccess) return (int)configured;
  const int smem = 4 * layout(U).floats;
  blocked_kernel<U><<<(C + cpw - 1) / cpw, NT, smem, stream>>>(
      (const float*)x, (const float*)state, (const float*)M,
      (const float*)HS, (const float*)G, (const float*)Ft, C, T, cpw,
      (float*)y, (float*)state_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The geometry constants (cuda/iir.py checks its copy against them).
int uhsdr_blocked_chunk() { return R; }
int uhsdr_blocked_max_sections() { return MAXS; }
int uhsdr_blocked_outputs_per_lane() { return RO; }
int uhsdr_blocked_warps() { return NW; }
int uhsdr_blocked_slots() { return SLOTS; }
int uhsdr_blocked_row_stride() { return XS; }
// The dynamic shared memory a block takes for S sections, or -1.
int uhsdr_blocked_smem(int S) {
  return S < 1 || S > MAXS ? -1 : 4 * layout(2 * S).floats;
}

// x, y: (C, T) f32 with T % 128 == 0 and 16-byte aligned rows; state,
// state_out: (S, C, 2) f32; M (128, 128), HS (2S, 128), G (128, 2S), Ft
// (2S, 2S) f32 tables of `ops/iir.py::cascade`, on the device; cpw the
// channels a block (a power of two up to 32; cuda/iir.py::
// blocked_geometry).  Requires 1 <= S <= 8.  Returns a cudaError_t.
int uhsdr_blocked_launch(const void* x, const void* state, const void* M,
                         const void* HS, const void* G, const void* Ft,
                         int S, int C, int T, int cpw, void* y,
                         void* state_out, void* stream) {
  if (S < 1 || S > MAXS || T < R || T % R != 0 || C < 0 || cpw < 1 ||
      cpw > LANES || (cpw & (cpw - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (S) {
    case 1: return launch<2>(x, state, M, HS, G, Ft, C, T, cpw, y, state_out, s);
    case 2: return launch<4>(x, state, M, HS, G, Ft, C, T, cpw, y, state_out, s);
    case 3: return launch<6>(x, state, M, HS, G, Ft, C, T, cpw, y, state_out, s);
    case 4: return launch<8>(x, state, M, HS, G, Ft, C, T, cpw, y, state_out, s);
    case 5: return launch<10>(x, state, M, HS, G, Ft, C, T, cpw, y, state_out, s);
    case 6: return launch<12>(x, state, M, HS, G, Ft, C, T, cpw, y, state_out, s);
    case 7: return launch<14>(x, state, M, HS, G, Ft, C, T, cpw, y, state_out, s);
    default: return launch<16>(x, state, M, HS, G, Ft, C, T, cpw, y, state_out, s);
  }
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
