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
// Design: the tile ring of ring.cuh (as kernels/alc.cu and K11), a block
// owning NWALK * lw channels (the rule is cuda/fm_mod.py::fm_mod_geometry:
// at most a block an SM, its four walkers on its four schedulers):
//   - the front warp copies tiles k+1 .. k+3 of x, and of the subtone
//     plane when there is one, into the ring by 16-byte cp.async;
//   - four walker warps (lane = channel, a, b and the accumulator in
//     registers) run the two recurrences alone, four samples a float4
//     out of the stage, and write the table index k over x as an int
//     (-1 for a NaN accumulator);
//   - four output warps (lanes along time, each a walker's channels) read
//     k, look (SIN[k], NEGCOS[k]) up as one float2 in shared memory,
//     apply the NaN rule, the swap and the amplitude in the plain
//     version's order, and store i and q as 128-byte lines.
// So the lookups (on lanes of random phase, where banks collide), the
// swap, the products and both planes' stores leave the walker's chain.
// The table's rows are placed at fm_swz(k), k's low 4 bits (its bank
// pair) XORed with bits 4-7 and 6-9: a steady carrier at a multiple of
// fs / 64 (the translates 6, 9 and 12 kHz at 48 kHz) advances k by a
// multiple of 16 each sample, which would put a warp's lookups in one
// bank pair.
// Compiled with -fmad=false so that every product and sum rounds as the
// plain version's (cuda/fm_mod.py::fm_mod_plain): bit for bit.
#include <stdint.h>

#include "ring.cuh"

namespace {

constexpr int TABLE = 1024;
constexpr int FM_MAXLW = 32;        // channel lanes of a walker warp

struct ModParams {
  float alpha, word, scale, amp;
  int swap;                          // i and q swapped (a negative translate)
  int C, T, lw, vec;                 // vec: x and add 16-byte aligned rows
};

// A stage: the x plane (k over it), then the subtone plane when ADD, of
// cb rows each.  The table (float2 a row) follows the ring.
__host__ __device__ inline int fm_stage_floats(int cb, bool add) {
  return (add ? 2 : 1) * cb * SS;
}

__host__ __device__ inline int fm_smem_bytes(int lw, bool add) {
  return (STAGES * fm_stage_floats(NWALK * lw, add) + 2 * TABLE) *
         (int)sizeof(float);
}

// Where table row k sits: its low 4 bits (its bank pair) XORed with bits
// 4-7 and 6-9 of k.  A bijection on 0..1023 (only the low bits move).
__host__ __device__ __forceinline__ int fm_swz(int k) {
  return k ^ (((k >> 4) ^ (k >> 6)) & 15);
}

// One sample of the two recurrences; returns k, or -1 for a NaN
// accumulator.
template <bool ADD>
__device__ __forceinline__ int fm_step(float xn, float an, float& a, float& b,
                                       float& acc, const ModParams& p) {
  b = p.alpha * ((b + xn) - a);
  a = xn;
  float pre = b;
  if constexpr (ADD) pre = pre + an;
  const float r = p.word + pre * p.scale;
  const float s = floorf(acc + r);
  acc = s - 65536.f * floorf(s * (1.f / 65536.f));
  return acc != acc ? -1 : (int)floorf(acc * (1.f / 64.f));
}

// Walker warp wk: lane l < lw walks channel row wk * lw + l (the lanes
// past lw repeat the last row's walk and store nothing): k over x in its
// stage row, four samples a float4 in a whole tile, one at a time in a
// short (last) one.
template <bool ADD>
__device__ void fm_walker(const float* __restrict__ a_in,
                          const float* __restrict__ b_in,
                          const int32_t* __restrict__ acc_in,
                          float* __restrict__ a_out, float* __restrict__ b_out,
                          int32_t* __restrict__ acc_out, const ModParams& p,
                          int c0, int nc, int cb, int ntiles, float* stage,
                          int wk, int lane) {
  const int r = wk * p.lw + min(lane, p.lw - 1);
  const bool own = lane < p.lw && r < nc;
  const int c = c0 + min(r, nc - 1);
  float a = a_in[c], b = b_in[c], acc = (float)acc_in[c];
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    const int cnt = min(TA, p.T - j * TA);
    float* row = stage + (size_t)s * fm_stage_floats(cb, ADD) + r * SS;
    const float* arow = row + cb * SS;
    bar_sync(BAR_FULL + s, 32 + WALK_T);
    if (cnt == TA) {
      const float4* x4 = reinterpret_cast<const float4*>(row);
      const float4* a4 = reinterpret_cast<const float4*>(arow);
      int4* k4 = reinterpret_cast<int4*>(row);
#pragma unroll 4
      for (int q = 0; q < TA / 4; ++q) {
        const float4 xv = x4[q];
        const float4 av = ADD ? a4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
        int4 kv;
        kv.x = fm_step<ADD>(xv.x, av.x, a, b, acc, p);
        kv.y = fm_step<ADD>(xv.y, av.y, a, b, acc, p);
        kv.z = fm_step<ADD>(xv.z, av.z, a, b, acc, p);
        kv.w = fm_step<ADD>(xv.w, av.w, a, b, acc, p);
        if (own) k4[q] = kv;
      }
    } else {
      int* kr = reinterpret_cast<int*>(row);
      for (int i = 0; i < cnt; ++i) {
        const int k = fm_step<ADD>(row[i], ADD ? arow[i] : 0.f, a, b, acc, p);
        if (own) kr[i] = k;
      }
    }
    __syncwarp();
    bar_arrive(BAR_DONE + s, WALK_T + OUT_T);
  }
  if (own) {
    a_out[c] = a;
    b_out[c] = b;
    acc_out[c] = acc != acc ? 0 : (int32_t)acc;
  }
}

// Output warp ow: the rows of walker ow, lanes along time.  i and q of a
// row's tile are two 128-byte lines.
__device__ void fm_output(float* __restrict__ io, float* __restrict__ qo,
                          const ModParams& p, int c0, int nc,
                          int stage_floats, int ntiles, const float* stage,
                          const float2* tab, int ow, int lane) {
  const int r0 = ow * p.lw;
  const int nr = max(0, min(p.lw, nc - r0));
  const float nan = __int_as_float(0x7fc00000);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    const int cnt = min(TA, p.T - j * TA);
    bar_sync(BAR_DONE + s, WALK_T + OUT_T);
    for (int t = lane; t < cnt; t += 32) {
      const int* kp = reinterpret_cast<const int*>(
          stage + (size_t)s * stage_floats + r0 * SS + t);
      const size_t o = (size_t)(c0 + r0) * p.T + (size_t)j * TA + t;
#pragma unroll 4
      for (int i = 0; i < nr; ++i) {
        const int k = kp[i * SS];
        float iv = nan, qv = nan;
        if (k >= 0) {
          const float2 e = tab[fm_swz(k)];
          iv = e.x;
          qv = e.y;
        }
        if (p.swap) {
          const float t = iv;
          iv = qv;
          qv = t;
        }
        io[o + (size_t)i * p.T] = iv * p.amp;
        qo[o + (size_t)i * p.T] = qv * p.amp;
      }
    }
    __syncwarp();
    if (j + STAGES < ntiles) bar_arrive(BAR_FREE + s, 32 + OUT_T);
  }
}

// Warps 0 .. NWALK-1 walk (one per scheduler), warp NWALK is the front,
// the rest form the output.
template <bool ADD>
__global__ void __launch_bounds__(THREADS, 1) fm_mod_kernel(
    const float* __restrict__ x, const float* __restrict__ add,
    const float* __restrict__ a_in, const float* __restrict__ b_in,
    const int32_t* __restrict__ acc_in, const float* __restrict__ table,
    const ModParams p, float* __restrict__ io, float* __restrict__ qo,
    float* __restrict__ a_out, float* __restrict__ b_out,
    int32_t* __restrict__ acc_out) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  const int cb = NWALK * p.lw;
  const int sf = fm_stage_floats(cb, ADD);
  float2* tab = reinterpret_cast<float2*>(stage + STAGES * sf);
  for (int k = threadIdx.x; k < TABLE; k += THREADS)
    tab[fm_swz(k)] = make_float2(table[k], table[TABLE + k]);
  __syncthreads();
  const int c0 = blockIdx.x * cb;
  const int nc = min(cb, p.C - c0);
  const int ntiles = (p.T + TA - 1) / TA;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < NWALK) {
    fm_walker<ADD>(a_in, b_in, acc_in, a_out, b_out, acc_out, p, c0, nc, cb,
                   ntiles, stage, warp, lane);
  } else if (warp == NWALK) {
    front(ntiles, [&](int m) {
      const int t0 = m * TA;
      const int n = min(TA, p.T - t0);
      float* st = stage + (size_t)(m % STAGES) * sf;
      copy_rows(st, SS, nc, n, TA, p.vec,
                [&](int r) { return x + (size_t)(c0 + r) * p.T + t0; },
                lane);
      if constexpr (ADD)
        copy_rows(st + cb * SS, SS, nc, n, TA, p.vec,
                  [&](int r) { return add + (size_t)(c0 + r) * p.T + t0; },
                  lane);
    });
  } else {
    fm_output(io, qo, p, c0, nc, sf, ntiles, stage, tab, warp - NWALK - 1,
              lane);
  }
}

template <bool ADD>
int launch(const float* x, const float* add, const float* a_in,
           const float* b_in, const int32_t* acc_in, const float* table,
           const ModParams& p, float* io, float* qo, float* a_out,
           float* b_out, int32_t* acc_out, cudaStream_t st) {
  const int smem = fm_smem_bytes(p.lw, ADD);
  cudaError_t e = cudaFuncSetAttribute(
      fm_mod_kernel<ADD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int cb = NWALK * p.lw;
  fm_mod_kernel<ADD><<<(p.C + cb - 1) / cb, THREADS, smem, st>>>(
      x, add, a_in, b_in, acc_in, table, p, io, qo, a_out, b_out, acc_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int uhsdr_fm_mod_walkers() { return NWALK; }
int uhsdr_fm_mod_tile() { return TA; }
int uhsdr_fm_mod_stages() { return STAGES; }
int uhsdr_fm_mod_threads() { return THREADS; }
int uhsdr_fm_mod_table() { return TABLE; }
int uhsdr_fm_mod_max_lanes() { return FM_MAXLW; }

// A block's dynamic shared memory at lw channel lanes a walker, with or
// without the subtone plane; -1 outside 1..FM_MAXLW.
int uhsdr_fm_mod_smem(int lw, int add) {
  return lw >= 1 && lw <= FM_MAXLW ? fm_smem_bytes(lw, add != 0) : -1;
}

// x: (C, T) f32 audio; add: (C, T) f32 or null; a_in, b_in: (C,) f32;
// acc_in: (C,) int32; table: (2, 1024) f32 [sin; -cos] on the card; lw:
// the channel lanes of a walker (cuda/fm_mod.py::fm_mod_geometry); vec: x
// and add 16-byte aligned and T % 4 == 0; io, qo: (C, T) f32 out; a_out,
// b_out: (C,) f32 out; acc_out: (C,) int32 out.  Returns a cudaError_t.
int uhsdr_fm_mod_launch(const void* x, const void* add, const void* a_in,
                        const void* b_in, const void* acc_in,
                        const void* table, int C, int T, int lw, int vec,
                        float alpha, float word, float scale, float amp,
                        int swap, void* io, void* qo, void* a_out,
                        void* b_out, void* acc_out, void* stream) {
  if (C < 1 || T < 1 || lw < 1 || lw > FM_MAXLW)
    return (int)cudaErrorInvalidValue;
  const ModParams p = {alpha, word, scale, amp, swap ? 1 : 0,
                       C, T, lw, vec ? 1 : 0};
  const float* xp = (const float*)x;
  const float* ap = (const float*)add;
  const float* ai = (const float*)a_in;
  const float* bi = (const float*)b_in;
  const int32_t* ci = (const int32_t*)acc_in;
  const float* tp = (const float*)table;
  float *i_o = (float*)io, *q_o = (float*)qo;
  float *ao = (float*)a_out, *bo = (float*)b_out;
  int32_t* co = (int32_t*)acc_out;
  cudaStream_t st = (cudaStream_t)stream;
  return ap ? launch<true>(xp, ap, ai, bi, ci, tp, p, i_o, q_o, ao, bo, co,
                           st)
            : launch<false>(xp, ap, ai, bi, ci, tp, p, i_o, q_o, ao, bo, co,
                            st);
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
