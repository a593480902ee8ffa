// The LPC impulse noise blanker, hand-written for Hopper (sm_90a): the
// whole of nr/blanker.py::process_block in one kernel.  A helper kernel
// with no TPU counterpart: the JAX package runs the frames of a block as a
// lax.scan of array operations (uhsdr_tpu/nr/blanker.py:229-255).  Per
// channel and 128-sample frame (alt_noise_blanking, audio_nr.c:2210-2536),
// on the working buffer b = the 26 repaired samples carried from the last
// frame ++ the frame (154 samples):
//   R[i] = sum_n s[n] s[n+i] over s = b[13..140], i = 0..10;
//   Levinson-Durbin -> e = (1, a1..a10) (R[0] loaded by 1 + 1e-9, 1 in
//   f32);  d = (b[13..] * e reversed) * e, zero history, 128 samples;
//   thr = (16 - nb_setting)/2 sqrt(max(var(d, ddof 1) sum(e[0..9]^2),
//   1e-30));  candidates: |d| > thr, |d| the max of |d| within +-3, from
//   position 13 on, the first 5 by position;
//   for each of the 5 slots in order (a slot with no impulse at position
//   10, added with weight 0): the 7-sample window at the position is
//   repaired by the forward order-10 prediction from the 10 samples
//   before and the backward one from the 10 after, cross-faded, blended
//   into b as b (1 - m) + m rep (later windows overwrite earlier ones);
//   out = b[13..140] (a delay of 13), the next context b[128..153].
// The sums over a frame are the plain version's trees.lane_sum over 32
// lanes (sample n in virtual lane n % 32, each virtual lane's left fold
// over its four samples, then a pairwise tree); the short dot products
// are left folds in the reference's order.  Compiled with -fmad=false so
// that every product and sum rounds as the plain version's do
// (cuda/blanker.py::blanker_plain): bit for bit.
//
// Bound on this card: bytes.  At the SSB flagship (8192 ch x 2048 samples
// at 12 kHz) it reads and writes 134 MB, 0.04 ms at 3.35 TB/s; its work
// (~2,900 FP32 operations a frame and channel: R, the two filters, the
// statistics, Levinson, the repairs) takes 0.015 ms at 67 TFLOP/s.  The
// work is issue: every phase is a scalar chain per channel.
//
// Design: two lanes a channel, up to 16 channels a warp, four warps a
// block, one a scheduler (`blanker_geometry` in cuda/blanker.py: the
// fewest channels a warp that gives every scheduler a warp; 16 at 8192
// channels, 128 blocks).  Lane h of a channel takes the virtual lanes
// 16h .. 16h + 15, the samples n = 16h + j + 32m (j < 16, m < 4):
//   - R: for each of its 16 virtual lanes the 11 lags' left folds over m,
//     from four sliding windows of s in registers, and the tree's first
//     four levels in the lane as the virtual lanes go; the fifth level is
//     one shuffle.  The mean and the variance the same way;
//   - Levinson and the threshold run in the channel's 2 lanes, not 32;
//   - the two filters: each lane its 64 outputs, a chunk's 16 as
//     interleaved accumulators (each output's sum in tap order) over a
//     window of 26 inputs in registers, the whitened frame through shared
//     memory;
//   - the candidates: |d| padded with zeros in shared memory, the max of
//     a 7-sample window from pairs and quads (max.NaN: a NaN anywhere in
//     it makes no candidate, as the plain version's NaN-propagating
//     maximum), 16 bits a chunk swapped by one shuffle;
//   - the repairs on the channel's pair, a slot at a time: lane 0 walks
//     the forward prediction on the 10 samples before the window, lane 1
//     the backward one on the 10 after, as the same instructions (either
//     is nxt = sum_j u[j] af[j] with u[0] the nearest sample, then u
//     shifts one on); 7 shuffles cross-fade them.  A slot reads its
//     samples through the blends before it: every blend turns a sample
//     outside its window into x * 1 + 0 (-0 to +0, a NaN to the card's),
//     which is idempotent, so a sample's value is the buffer's unless the
//     last slot's window missed it, where it is x * 1 + 0 of the buffer's.
//     An empty slot's contexts lie outside its window [10, 17), so the
//     first empty slot can change the next one's only where they hold a
//     -0 or a NaN; from the second empty slot on, each reads the same
//     bits, forms the same prediction, and its blend changes nothing
//     more.  So a frame runs min(found + 2, 5) slots, not 5.  (One empty
//     slot in place of two is not exact: a -0 context can turn the sign
//     of a zero in b[13..16].)
// Shared memory a channel: two working buffers (row stride 161; the next
// frame's samples are copied into the other by cp.async while this one
// runs, its context written there at the frame's end), the whitened
// frame (129), |d| with three zeros each side (161): strides 1 mod 32, so
// the lanes of 16 channels, the two halves 16 samples apart, meet 32
// banks.
#include <cuda_runtime.h>

namespace {

constexpr int FRAME = 128;
constexpr int ORDER = 10;
constexpr int ILEN = 7;
constexpr int PL = 3;
constexpr int NIMP = 5;
constexpr int CTX = 26;
constexpr int WB = CTX + FRAME;       // 154
constexpr int DELAY = 13;
constexpr unsigned FULL = 0xffffffffu;

// The layout, mirrored by cuda/blanker.py (which checks the exports)
constexpr int LANES = 2;              // lanes a channel
constexpr int VL = 32;                // the plain version's lanes
constexpr int HV = VL / LANES;        // virtual lanes a lane (16)
constexpr int WARPS = 4;              // warps a block: one a scheduler
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_CPW = 32 / LANES;   // channels a warp, at most
constexpr int BS = 161;               // working buffer row (>= WB), two
constexpr int TS = 129;               // whitened row (>= FRAME)
constexpr int AS = 161;               // |d| row: PL zeros, FRAME, PL zeros
constexpr int CH_FLOATS = 2 * BS + TS + AS;
static_assert(BS % 32 == 1 && TS % 32 == 1 && AS % 32 == 1, "banks");
static_assert(BS >= WB && AS >= FRAME + 2 * PL, "rows");

__host__ __device__ inline int nb_smem(int cpw) {
  return WARPS * cpw * CH_FLOATS * (int)sizeof(float);
}

__device__ __forceinline__ float max_nan(float x, float m) {
  return x != x ? x : fmaxf(x, m);
}
// the larger of two, a NaN if either is one
__device__ __forceinline__ float maxn(float x, float y) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}
// x * 1 + 0: what a blend does to a sample outside its window
__device__ __forceinline__ float canon(float x) { return x * 1.f + 0.f; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

// The pairwise tree over a lane's 16 virtual lanes, fed as they come
// (j = 0..15): level k keeps its left operand until its right one is
// ready.  Returns the lane's sum at j == 15.
struct Tree16 {
  float l0, l1, l2, l3;
  template <int J>
  __device__ __forceinline__ void push(float v, float& out) {
    if (J % 2 == 0) { l0 = v; return; }
    const float v1 = l0 + v;
    if (J % 4 == 1) { l1 = v1; return; }
    const float v2 = l1 + v1;
    if (J % 8 == 3) { l2 = v2; return; }
    const float v3 = l2 + v2;
    if (J % 16 == 7) { l3 = v3; return; }
    out = l3 + v3;
  }
};

// f(IC<0>{}), f(IC<1>{}), ..., f(IC<N - 1>{}): a loop whose index is a
// constant in each copy of the body
template <int J>
struct IC {
  static constexpr int value = J;
};
template <int N>
struct Unroll {
  template <typename F>
  __device__ __forceinline__ static void run(F& f) {
    Unroll<N - 1>::run(f);
    f(IC<N - 1>{});
  }
};
template <>
struct Unroll<0> {
  template <typename F>
  __device__ __forceinline__ static void run(F&) {}
};

__global__ void __launch_bounds__(THREADS, 1) blanker_kernel(
    const float* __restrict__ x, const float* __restrict__ ctx_in, int C,
    int T, int cpw, float mult, float* __restrict__ y,
    float* __restrict__ ctx_out) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cpb = WARPS * cpw;
  const int first = blockIdx.x * cpb + warp * cpw;
  if (first >= C) return;
  const int rows = min(cpw, C - first);
  // the working buffers of frames f even and odd: frame f + 1's samples
  // go into the other by cp.async while f runs, its context at f's end
  float* Bw0 = smem + warp * cpw * BS;
  float* Bw1 = smem + cpb * BS + warp * cpw * BS;
  float* Tw = smem + 2 * cpb * BS + warp * cpw * TS;
  float* Aw = smem + cpb * (2 * BS + TS) + warp * cpw * AS;
  const int h = lane & 1;
  // lanes past the live channels run the last one and store nothing
  const bool mine = (lane >> 1) < rows;
  const int r = min(lane >> 1, rows - 1);
  float* t1 = Tw + r * TS;
  float* av = Aw + r * AS + PL;          // av[-3..-1], av[128..130] = 0
  const int nfr = T / FRAME;

  for (int q = 0; q < rows; ++q) {
    if (lane < CTX) Bw0[q * BS + lane] = ctx_in[(size_t)(first + q) * CTX + lane];
    if (lane < PL) {
      Aw[q * AS + lane] = 0.f;
      Aw[q * AS + PL + FRAME + lane] = 0.f;
    }
  }
  // frame f's samples into the rows of Bd, after their context
  const float* xl = x + (size_t)first * T + lane;
  auto stage = [&](int f, float* Bd) {
    const float* src = xl + (size_t)f * FRAME;
    float* dst = Bd + CTX + lane;
    for (int q = 0; q < rows; ++q) {
#pragma unroll
      for (int m = 0; m < 4; ++m) cp_async4(dst + 32 * m, src + 32 * m);
      src += T;
      dst += BS;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  // the cross-fade's weights i / 6 (as the plain version's arange / 6)
  float wb[ILEN], wf[ILEN];
#pragma unroll
  for (int i = 0; i < ILEN; ++i) {
    wb[i] = __fdiv_rn((float)i, 6.f);
    wf[i] = 1.f - wb[i];
  }

  stage(0, Bw0);
  for (int f = 0; f < nfr; ++f) {
    float* Bw = f & 1 ? Bw1 : Bw0;         // this frame's buffers
    float* Bn = f & 1 ? Bw0 : Bw1;         // the next frame's
    float* b = Bw + r * BS;
    const float* s = b + DELAY;
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncwarp();
    if (f + 1 < nfr) stage(f + 1, Bn);

    // ---- R: 11 lags, the folds over m, the tree as the j go ----
    float R[ORDER + 1];
    {
      float wv[4][ORDER + 1];     // wv[m][q] = s[16h + 32m + j + q]
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int q = 0; q <= ORDER; ++q) wv[m][q] = s[HV * h + 32 * m + q];
      Tree16 tr[ORDER + 1];
      auto lag_fold = [&](auto jc) {
        constexpr int J = decltype(jc)::value;
        if (J > 0) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
#pragma unroll
            for (int q = 0; q < ORDER; ++q) wv[m][q] = wv[m][q + 1];
            wv[m][ORDER] = s[HV * h + 32 * m + J + ORDER];
          }
        }
#pragma unroll
        for (int i = 0; i <= ORDER; ++i) {
          float p = 0.f;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            float t = wv[m][0] * wv[m][i];
            // n + i >= 128 (only the upper half's last chunk): a zero
            if (m == 3 && J + i >= HV) t = h ? 0.f : t;
            p = m == 0 ? t : p + t;
          }
          tr[i].template push<J>(p, R[i]);
        }
      };
      Unroll<HV>::run(lag_fold);
#pragma unroll
      for (int i = 0; i <= ORDER; ++i)
        R[i] = R[i] + __shfl_xor_sync(FULL, R[i], 1);
    }

    // ---- Levinson-Durbin, in the channel's two lanes ----
    float e[ORDER + 1];
    e[0] = 1.f;
#pragma unroll
    for (int i = 1; i <= ORDER; ++i) e[i] = 0.f;
    {
      float alfa = R[0] * 1.0f;
#pragma unroll
      for (int mm = 1; mm <= ORDER; ++mm) {
        float sum = R[mm];
#pragma unroll
        for (int i = 1; i < mm; ++i) sum = sum + e[i] * R[mm - i];
        const float k = -sum / max_nan(alfa, 1e-30f);
        float na[ORDER + 1];
#pragma unroll
        for (int i = 1; i < mm; ++i) na[i] = e[i] + k * e[mm - i];
#pragma unroll
        for (int i = 1; i < mm; ++i) e[i] = na[i];
        e[mm] = k;
        alfa = alfa * (1.f - k * k);
      }
    }

    // ---- whitening (e reversed), zero history: t1.  The 16 outputs of
    // a chunk are 16 accumulators, the taps' sums in order ----
#pragma unroll 1
    for (int m = 0; m < 4; ++m) {
      const int n0 = HV * h + 32 * m;
      float wv[HV + ORDER];           // wv[q] = s[n0 - 10 + q]
#pragma unroll
      for (int q = 0; q < HV + ORDER; ++q) wv[q] = s[n0 - ORDER + q];
      float acc[HV];
#pragma unroll
      for (int j = 0; j < HV; ++j) acc[j] = 0.f;
#pragma unroll
      for (int k = 0; k <= ORDER; ++k)
#pragma unroll
        for (int j = 0; j < HV; ++j) {
          float v = wv[j + ORDER - k];
          if (j < k) v = (m > 0 || h) ? v : 0.f;   // n - k < 0
          acc[j] = acc[j] + e[ORDER - k] * v;
        }
#pragma unroll
      for (int j = 0; j < HV; ++j) t1[n0 + j] = acc[j];
    }
    __syncwarp();

    // ---- the matched filter (e): d, kept in av; the mean's folds ----
    float mp[HV];
#pragma unroll 1
    for (int m = 0; m < 4; ++m) {
      const int n0 = HV * h + 32 * m;
      float wv[HV + ORDER];
#pragma unroll
      for (int q = 0; q < HV + ORDER; ++q) wv[q] = t1[n0 - ORDER + q];
      float acc[HV];
#pragma unroll
      for (int j = 0; j < HV; ++j) acc[j] = 0.f;
#pragma unroll
      for (int k = 0; k <= ORDER; ++k)
#pragma unroll
        for (int j = 0; j < HV; ++j) {
          float v = wv[j + ORDER - k];
          if (j < k) v = (m > 0 || h) ? v : 0.f;
          acc[j] = acc[j] + e[k] * v;
        }
#pragma unroll
      for (int j = 0; j < HV; ++j) {
        av[n0 + j] = acc[j];
        mp[j] = m == 0 ? acc[j] : mp[j] + acc[j];
      }
    }
    float mean;
    {
      Tree16 tr;
      float sum = 0.f;
      auto feed = [&](auto jc) {
        tr.template push<decltype(jc)::value>(mp[decltype(jc)::value], sum);
      };
      Unroll<HV>::run(feed);
      mean = (sum + __shfl_xor_sync(FULL, sum, 1)) * (1.f / FRAME);
    }
    float sigma2;
    {
      float vp[HV];
#pragma unroll 1
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int j = 0; j < HV; ++j) {
          const float u = av[HV * h + 32 * m + j] - mean;
          vp[j] = m == 0 ? u * u : vp[j] + u * u;
        }
      Tree16 tr;
      float sum = 0.f;
      auto feed = [&](auto jc) {
        tr.template push<decltype(jc)::value>(vp[decltype(jc)::value], sum);
      };
      Unroll<HV>::run(feed);
      sigma2 = (sum + __shfl_xor_sync(FULL, sum, 1)) / (float)(FRAME - 1);
    }
    float lpc = e[0] * e[0];
#pragma unroll
    for (int k = 1; k < ORDER; ++k) lpc = lpc + e[k] * e[k];
    const float thr = mult * sqrtf(max_nan(sigma2 * lpc, 1e-30f));
    __syncwarp();

    // ---- candidates: above thr, the max within +-3, from 13 on ----
    unsigned mask = 0;       // 16 bits a chunk, chunks m = 0..1 / 2..3
    unsigned mask2 = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int n0 = HV * h + 32 * m;
      float a[HV + 2 * PL];            // |d[n0 - 3 ..  n0 + 18]|
#pragma unroll
      for (int q = 0; q < HV + 2 * PL; ++q) a[q] = fabsf(av[n0 - PL + q]);
      float p2[HV + 2 * PL - 1], p4[HV + 2 * PL - 3];
#pragma unroll
      for (int q = 0; q < HV + 2 * PL - 1; ++q) p2[q] = maxn(a[q], a[q + 1]);
#pragma unroll
      for (int q = 0; q < HV + 2 * PL - 3; ++q) p4[q] = maxn(p2[q], p2[q + 2]);
      unsigned bits = 0;
#pragma unroll
      for (int j = 0; j < HV; ++j) {
        const float an = a[j + PL];
        const float mx = maxn(p4[j], p4[j + PL]);
        bool hit = (an > thr) & (an >= mx);
        if (j < DELAY) hit = hit & ((m > 0) | (h == 1));
        bits |= (unsigned)hit << j;
      }
      if (m < 2) mask |= bits << (HV * m);
      else mask2 |= bits << (HV * (m - 2));
    }
    // the frame's 128 bits in order of n: word m = lane 0's chunk m in
    // the low half, lane 1's in the high half
    unsigned wd[4];
    {
      const unsigned o1 = __shfl_xor_sync(FULL, mask, 1);
      const unsigned o2 = __shfl_xor_sync(FULL, mask2, 1);
      const unsigned lo0 = h ? o1 : mask, hi0 = h ? mask : o1;
      const unsigned lo1 = h ? o2 : mask2, hi1 = h ? mask2 : o2;
      wd[0] = (lo0 & 0xffffu) | (hi0 << 16);
      wd[1] = (lo0 >> 16) | (hi0 & 0xffff0000u);
      wd[2] = (lo1 & 0xffffu) | (hi1 << 16);
      wd[3] = (lo1 >> 16) | (hi1 & 0xffff0000u);
    }
    int pos[NIMP];
    int found = 0;
#pragma unroll
    for (int k = 0; k < NIMP; ++k) {
      const int q = wd[0] ? 0 : wd[1] ? 1 : wd[2] ? 2 : wd[3] ? 3 : 4;
      const unsigned word = q == 0 ? wd[0] : q == 1 ? wd[1]
                          : q == 2 ? wd[2] : wd[3];
      pos[k] = 32 * q + __ffs(word) - 1;
      found += q < 4;
      const unsigned clear = word & (word - 1);
#pragma unroll
      for (int z = 0; z < 4; ++z) wd[z] = q == z ? clear : wd[z];
    }

    // ---- the repairs: min(found + 2, 5) slots, each on the pair ----
    float af[ORDER];
#pragma unroll
    for (int j = 0; j < ORDER; ++j) af[j] = -e[j + 1];
    const int nsl = min(found + 2, NIMP);
    const int kmax = __reduce_max_sync(FULL, mine ? nsl : 0);
    int pst = -2 * WB;                 // the last slot's window start
#pragma unroll 1
    for (int k = 0; k < kmax; ++k) {
      const bool act = k < nsl;
      const bool ok = k < found;
      const int pk = k == 0 ? pos[0] : k == 1 ? pos[1] : k == 2 ? pos[2]
                   : k == 3 ? pos[3] : pos[4];
      const int st = ok ? pk : ORDER;
      // lane 0: u[j] = b[st - 1 - j]; lane 1: u[j] = b[st + ILEN + j]
      const int o0 = h ? st + ILEN : st - 1, dir = h ? 1 : -1;
      float u[ORDER];
#pragma unroll
      for (int j = 0; j < ORDER; ++j) {
        const int n = o0 + dir * j;
        const float v = b[n];
        u[j] = (k > 0 && (unsigned)(n - pst) >= (unsigned)ILEN) ? canon(v) : v;
      }
      float fw[ILEN], bw[ILEN];
#pragma unroll
      for (int qq = 0; qq < ILEN; ++qq) {
        float nxt = u[0] * af[0];
#pragma unroll
        for (int j = 1; j < ORDER; ++j) nxt = nxt + u[j] * af[j];
#pragma unroll
        for (int j = ORDER - 1; j > 0; --j) u[j] = u[j - 1];
        u[0] = nxt;
        const float other = __shfl_xor_sync(FULL, nxt, 1);
        fw[qq] = h ? other : nxt;                 // forward step qq
        bw[ILEN - 1 - qq] = h ? nxt : other;      // backward step qq
      }
      const float okf = ok ? 1.f : 0.f;
      // lane 0 blends window samples 0..3, lane 1 samples 4..6
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = h ? ii + 4 : ii;
        if (i < ILEN && act && mine) {
          float rep;
          {
            const float r0 = wf[ii] * fw[ii] + wb[ii] * bw[ii];
            const int i1 = ii + 4 < ILEN ? ii + 4 : ILEN - 1;
            const float r1 = wf[i1] * fw[i1] + wb[i1] * bw[i1];
            rep = h ? r1 : r0;
          }
          const int n = st + i;
          const float v = b[n];
          const float cur = (k > 0 && (unsigned)(n - pst) >= (unsigned)ILEN)
                                ? canon(v) : v;
          b[n] = cur * (1.f - okf) + okf * rep;
        }
      }
      if (act) pst = st;
      __syncwarp();
    }

    // ---- out: the delayed frame, and the next frame's context, each
    // read through the last slot's blend ----
    float* yq = y + (size_t)first * T + (size_t)f * FRAME + lane;
#pragma unroll 2
    for (int q = 0; q < rows; ++q) {
      const int ps = __shfl_sync(FULL, pst, 2 * q);
      const float* bq = Bw + q * BS;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int n = DELAY + lane + 32 * m;
        const float v = bq[n];
        yq[32 * m] = (unsigned)(n - ps) >= (unsigned)ILEN ? canon(v) : v;
      }
      if (lane < CTX) {
        const int n = FRAME + lane;
        const float v = bq[n];
        Bn[q * BS + lane] = (unsigned)(n - ps) >= (unsigned)ILEN ? canon(v) : v;
      }
      yq += T;
    }
  }
  float* Bl = nfr & 1 ? Bw1 : Bw0;         // the context after the last
  __syncwarp();
  for (int q = 0; q < rows; ++q)
    if (lane < CTX) ctx_out[(size_t)(first + q) * CTX + lane] = Bl[q * BS + lane];
}

}  // namespace

extern "C" {

// x: (C, T) f32, T a positive multiple of 128; ctx_in: (C, 26) f32; cpw:
// channels a warp (1..16, `blanker_geometry`); mult: (16 - nb_setting) /
// 2.  y: (C, T) out, ctx_out: (C, 26) out.  Returns a cudaError_t.
int uhsdr_blanker_launch(const void* x, const void* ctx_in, int C, int T,
                         int cpw, float mult, void* y, void* ctx_out,
                         void* stream) {
  if (cpw < 1 || cpw > MAX_CPW || C < 1 || T < FRAME || T % FRAME)
    return (int)cudaErrorInvalidValue;
  const int smem = nb_smem(cpw);
  cudaError_t e = cudaFuncSetAttribute(
      blanker_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int cpb = WARPS * cpw;
  blanker_kernel<<<(C + cpb - 1) / cpb, THREADS, smem,
                   (cudaStream_t)stream>>>(
      (const float*)x, (const float*)ctx_in, C, T, cpw, mult, (float*)y,
      (float*)ctx_out);
  return (int)cudaGetLastError();
}

// the layout, as cuda/blanker.py mirrors it
int uhsdr_blanker_lanes() { return LANES; }
int uhsdr_blanker_warps() { return WARPS; }
int uhsdr_blanker_max_cpw() { return MAX_CPW; }
int uhsdr_blanker_smem(int cpw) { return nb_smem(cpw); }

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
