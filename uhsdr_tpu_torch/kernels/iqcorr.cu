// Automatic IQ imbalance correction, hand-written for Hopper (sm_90a): the
// whole of ops/iqcorr.py::correct in one kernel.  A helper kernel with no
// TPU counterpart: the JAX package forms the sub-block sums as array
// reductions and walks the one-poles as a lax.scan
// (uhsdr_tpu/ops/iqcorr.py:56-101).  Per channel, in 32-sample sub-blocks
// j (the firmware's AudioDriver_RxHandleIqCorrection, audio_driver.c:
// 2254-2316, Moseley-Slump):
//   a1 = sum(sign(i) q)/32, a2 = sum|i|/32, a3 = sum|q|/32
//   t1 = -0.003 a1 + 0.997 t1, t2 = 0.003 a2 + 0.997 t2, t3 likewise
//   c1 = nz t1 t2 / (t2^2 + 1e-20),  h = (t3^2 - t1^2) / (t2^2 + 1e-20)
//   c2 = hp sqrt(max(h, 1e-20)) + (1 - hp)   (nz = |t2| > 1e-20,
//                                             hp = (h > 0) nz, as floats)
//   q' = q + c1 i, then i' = i c2            (the firmware's order)
// int16 planes are scaled by 1/32768 first.  The state is t1..t3, the last
// sub-block's c1 and c2, and the twin-peaks flag
// (t2 > 1e-6) & (|t1| / max(t2, 1e-12) > 0.45).
//
// Bound on this card: bytes.  At the SSB flagship (8192 ch x 16384 int16)
// it reads 0.54 GB and writes 1.07 GB of f32 planes, 0.48 ms at 3.35
// TB/s.  The walk is three one-poles a sub-block, 512 steps a channel.
//
// Design: a block a channel, five warps in two roles, the channel's
// sub-blocks in chunks of one 8 KB stage (both planes as they come: 64
// sub-blocks of int16, 32 of f32), each input byte read from global
// memory once:
//   - four worker warps copy chunk k + AHEAD into a ring of STAGES stages
//     by 16-byte cp.async (plain loads where a plane is not 16-byte
//     aligned), form chunk k's three sums out of the stage, hand them to
//     the walker (named barrier BAR_SUMS), then wait for chunk k - 1's c1
//     and c2 (BAR_CS) and write its corrected planes from the stage, 4
//     samples a lane in one 16-byte store a plane, a warp's stores 512
//     contiguous bytes;
//   - the walker warp: one lane walks the three one-poles over a chunk
//     (two dependent operations a step; a group of 8 steps' products
//     formed ahead), then the 32 lanes form c1 and c2 of its sub-blocks,
//     while the workers sum the next chunk and write the one before.
// A lane sums 8 consecutive samples: the pair tree's first three levels
// in the lane, the last two by xor shuffles among a sub-block's 4 lanes,
// the plain version's order (cuda/trees.py::pair_tree).  The sums and
// c1, c2 go through a pair of shared arrays a chunk, so the one barrier a
// chunk that holds the stores back is the one that needs c1 and c2.
// int16 samples become f32 by an integer add and a float subtract (s16f),
// exact, at full rate.  Four blocks an SM (MIN_BLOCKS, what the runtime
// places) keep 64 KB of copies in flight.  On the H100 at the SSB
// flagship this runs at 84% of the byte bound, the walk hidden (PERF.md
// section 6; trace_iqcorr_notch.py): the first body, which read the
// planes twice with 2-byte loads and stored 16-byte pieces 32 bytes
// apart, ran at 46%.  Compiled with -fmad=false so that every product and
// sum rounds as the plain version's do (cuda/iqcorr.py::iqcorr_plain):
// bit for bit.  The layout constants are mirrored by cuda/iqcorr.py
// (`iqcorr_geometry`), which checks them against the exports below.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUB = 32;                  // samples a sub-block
constexpr int WORKERS = 4;               // summing and storing warps
constexpr int THREADS = 32 * (WORKERS + 1);   // and the walker warp
constexpr int WORK_T = 32 * WORKERS;
constexpr int SPL = 8;                   // samples a lane
constexpr int STAGE_BYTES = 8192;        // a chunk of both planes
constexpr int STAGES = 4;
constexpr int AHEAD = 2;                 // chunks in flight past the summed
constexpr int CHUNK_MAX = STAGE_BYTES / (2 * SUB * 2);   // int16: 64
constexpr int MIN_BLOCKS = 4;            // blocks an SM the byte stream
                                         // needs (cuda/iqcorr.py)
constexpr unsigned FULL = 0xffffffffu;
// named barriers (0 is __syncthreads'): the workers among themselves; a
// chunk's sums are in S[p] (workers -> walker); its c1 and c2 are (walker
// -> workers)
constexpr int BAR_WORK = 1;
constexpr int BAR_SUMS = 2;
constexpr int BAR_CS = 4;
static_assert(STAGES >= AHEAD + 2, "a stage for the chunk being stored");
static_assert(SUB % SPL == 0 && 32 % (SUB / SPL) == 0, "a sub-block's lanes");

template <typename E>
__host__ __device__ constexpr int chunk_of() {   // sub-blocks a stage holds
  return STAGE_BYTES / (2 * SUB * (int)sizeof(E));
}

struct Smem {
  alignas(16) unsigned char stage[STAGES][STAGE_BYTES];
  float s[2][3][CHUNK_MAX];          // sums, then t1..t3, then c1, c2
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// max(x, m) with the NaN of x kept, as torch.clamp_min and jnp.maximum
__device__ __forceinline__ float max_nan(float x, float m) {
  return x != x ? x : fmaxf(x, m);
}

// An int16 sample v as f32 scaled by 2^-15: the bits of 384.0f (1.5 *
// 2^8, whose mantissa steps by 2^-15) plus v are 384 + v 2^-15 exactly for
// |v| <= 2^15, and subtracting 384 is exact (Sterbenz): the same float as
// (float)v * 2^-15, in two full-rate instructions in place of I2F's
// quarter rate and a product.
__device__ __forceinline__ float s16f(int v) {
  return __int_as_float(0x43C00000 + v) - 384.0f;
}
// the two int16 samples of a 32-bit word, in order
__device__ __forceinline__ void s16x2(unsigned w, float& lo, float& hi) {
  lo = s16f((int)(w << 16) >> 16);
  hi = s16f((int)w >> 16);
}

// a lane's 8 (or 4) consecutive samples of a plane in the stage, as f32
__device__ __forceinline__ void load8(const int16_t* p, float (&v)[SPL]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  s16x2(r.x, v[0], v[1]);
  s16x2(r.y, v[2], v[3]);
  s16x2(r.z, v[4], v[5]);
  s16x2(r.w, v[6], v[7]);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[SPL]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load4(const int16_t* p, float (&v)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  s16x2(r.x, v[0], v[1]);
  s16x2(r.y, v[2], v[3]);
}
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// the pair tree's first three levels over a lane's 8 samples
__device__ __forceinline__ float tree8(const float (&v)[SPL]) {
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}
// its last two, over the 4 lanes of a sub-block
__device__ __forceinline__ float tree4(float v) {
  v = v + __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// The workers' copy of chunk `ch` (n sub-blocks from sub-block base of a
// row at `row`) into a stage: 16-byte cp.async pieces, or plain loads
// where a plane is not 16-byte aligned.
template <typename E>
__device__ __forceinline__ void copy_chunk(unsigned char* stage,
                                           const E* __restrict__ ip,
                                           const E* __restrict__ qp,
                                           size_t off, int n, bool vec,
                                           int wt) {
  constexpr int CH = chunk_of<E>();
  E* si = reinterpret_cast<E*>(stage);
  E* sq = si + CH * SUB;
  if (vec) {
    constexpr int PER = 16 / (int)sizeof(E);    // elements a piece
    const int np = n * SUB / PER;               // pieces a plane
    for (int k = wt; k < 2 * np; k += WORK_T) {
      const bool qpl = k >= np;
      const int e = (qpl ? k - np : k) * PER;
      cp_async16((qpl ? sq : si) + e, (qpl ? qp : ip) + off + e);
    }
  } else {
    for (int e = wt; e < n * SUB; e += WORK_T) {
      si[e] = ip[off + e];
      sq[e] = qp[off + e];
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) iqcorr_kernel(
    const E* __restrict__ ip, const E* __restrict__ qp,
    const float* __restrict__ t1_in, const float* __restrict__ t2_in,
    const float* __restrict__ t3_in, int T, int vec, float* __restrict__ io,
    float* __restrict__ qo, float* __restrict__ t1_out,
    float* __restrict__ t2_out, float* __restrict__ t3_out,
    float* __restrict__ c1_out, float* __restrict__ c2_out,
    unsigned char* __restrict__ twin_out) {
  constexpr int CH = chunk_of<E>();
  __shared__ Smem sm;
  const int c = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nsub = T / SUB;
  const int nch = (nsub + CH - 1) / CH;
  const size_t row = (size_t)c * T;

  if (warp == WORKERS) {
    // ---- the walker warp
    float t1 = 0.f, t2 = 0.f, t3 = 0.f;
    if (lane == 0) {
      t1 = t1_in[c];
      t2 = t2_in[c];
      t3 = t3_in[c];
    }
    for (int k = 0; k < nch; ++k) {
      const int n = min(CH, nsub - k * CH);
      float* s1 = sm.s[k & 1][0];
      float* s2 = sm.s[k & 1][1];
      float* s3 = sm.s[k & 1][2];
      bar_sync(BAR_SUMS + (k & 1), THREADS);
      if (lane == 0) {
        // the block-cadence one-poles, in order; a group's products with
        // the sums first, off the chain
        int j = 0;
        for (; j + 8 <= n; j += 8) {
          float b1[8], b2[8], b3[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            b1[u] = -0.003f * s1[j + u];
            b2[u] = 0.003f * s2[j + u];
            b3[u] = 0.003f * s3[j + u];
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            t1 = b1[u] + 0.997f * t1;
            t2 = b2[u] + 0.997f * t2;
            t3 = b3[u] + 0.997f * t3;
            s1[j + u] = t1;
            s2[j + u] = t2;
            s3[j + u] = t3;
          }
        }
        for (; j < n; ++j) {
          t1 = -0.003f * s1[j] + 0.997f * t1;
          t2 = 0.003f * s2[j] + 0.997f * t2;
          t3 = 0.003f * s3[j] + 0.997f * t3;
          s1[j] = t1;
          s2[j] = t2;
          s3[j] = t3;
        }
      }
      __syncwarp();
      // c1 and c2 of each sub-block, in place of t1 and t2
      for (int j = lane; j < n; j += 32) {
        const float u1 = s1[j], u2 = s2[j], u3 = s3[j];
        const float nz = fabsf(u2) > 1e-20f ? 1.f : 0.f;
        const float den = u2 * u2 + 1e-20f;
        const float c1 = nz * u1 * u2 / den;
        const float h = (u3 * u3 - u1 * u1) / den;
        const float hp = (h > 0.f ? 1.f : 0.f) * nz;
        const float c2 = hp * sqrtf(max_nan(h, 1e-20f)) + (1.f - hp);
        s1[j] = c1;
        s2[j] = c2;
        if (k * CH + j == nsub - 1) {
          c1_out[c] = c1;
          c2_out[c] = c2;
        }
      }
      bar_arrive(BAR_CS + (k & 1), THREADS);
    }
    if (lane == 0) {
      t1_out[c] = t1;
      t2_out[c] = t2;
      t3_out[c] = t3;
      const float pe = fabsf(t1) / max_nan(t2, 1e-12f);
      twin_out[c] = (t2 > 1e-6f) & (pe > 0.45f);
    }
    return;
  }

  // ---- the worker warps.  Sums: lane l of warp w takes samples 8 (l %
  // 4) .. of sub-block 32 m + 8 w + l / 4 of a chunk, m = 0 .. CH / 32 -
  // 1.  Stores: lane l takes samples 4 l .. 4 l + 3 of each span of 128,
  // so that a warp's 16-byte stores fill 512 contiguous bytes.
  const int seg = (lane & 3) * SPL;
  const int sbl = warp * 8 + (lane >> 2);
  auto stage_of = [&](int k) { return sm.stage[k % STAGES]; };
  auto store = [&](int k) {
    const int ns = min(CH, nsub - k * CH) * SUB;
    const E* si = reinterpret_cast<const E*>(stage_of(k));
    const E* sq = si + CH * SUB;
    const float* c1s = sm.s[k & 1][0];
    const float* c2s = sm.s[k & 1][1];
    float* qd = qo + row + (size_t)k * CH * SUB;
    float* id = io + row + (size_t)k * CH * SUB;
#pragma unroll
    for (int e0 = 0; e0 < CH * SUB; e0 += 4 * WORK_T) {
      const int e = e0 + 4 * tid;
      if (e < ns) {
        float x[4], y[4];
        load4(si + e, x);
        load4(sq + e, y);
        const float c1 = c1s[e / SUB], c2 = c2s[e / SUB];
        *reinterpret_cast<float4*>(qd + e) = make_float4(
            y[0] + c1 * x[0], y[1] + c1 * x[1], y[2] + c1 * x[2],
            y[3] + c1 * x[3]);
        *reinterpret_cast<float4*>(id + e) = make_float4(
            x[0] * c2, x[1] * c2, x[2] * c2, x[3] * c2);
      }
    }
  };

  for (int k = 0; k < AHEAD; ++k) {
    if (k < nch)
      copy_chunk<E>(stage_of(k), ip, qp, row + (size_t)k * CH * SUB,
                    min(CH, nsub - k * CH), vec, tid);
    cp_commit();
  }
  for (int k = 0; k < nch; ++k) {
    const int n = min(CH, nsub - k * CH);
    // chunk k has landed once at most AHEAD - 1 groups are pending; the
    // barrier shows every worker's copies to all, and that chunk k - 2's
    // stores are done, so its stage takes chunk k + AHEAD
    asm volatile("cp.async.wait_group %0;" ::"n"(AHEAD - 1) : "memory");
    bar_sync(BAR_WORK, WORK_T);
    if (k + AHEAD < nch)
      copy_chunk<E>(stage_of(k + AHEAD), ip, qp,
                    row + (size_t)(k + AHEAD) * CH * SUB,
                    min(CH, nsub - (k + AHEAD) * CH), vec, tid);
    cp_commit();
    // the three sums of each sub-block of chunk k
    const E* si = reinterpret_cast<const E*>(stage_of(k));
    const E* sq = si + CH * SUB;
    float* s1 = sm.s[k & 1][0];
    float* s2 = sm.s[k & 1][1];
    float* s3 = sm.s[k & 1][2];
#pragma unroll
    for (int m = 0; m < CH; m += 32) {
      const int sb = m + sbl;
      float x[SPL], y[SPL];
      if (sb < n) {
        load8(si + sb * SUB + seg, x);
        load8(sq + sb * SUB + seg, y);
      } else {
#pragma unroll
        for (int e = 0; e < SPL; ++e) x[e] = y[e] = 0.f;
      }
      float sy[SPL], ax[SPL], ay[SPL];
#pragma unroll
      for (int e = 0; e < SPL; ++e) {
        const float s = x[e] > 0.f ? 1.f : (x[e] < 0.f ? -1.f : 0.f);
        sy[e] = s * y[e];
        ax[e] = fabsf(x[e]);
        ay[e] = fabsf(y[e]);
      }
      const float a1 = tree4(tree8(sy));
      const float a2 = tree4(tree8(ax));
      const float a3 = tree4(tree8(ay));
      if (sb < n && (lane & 3) == 0) {
        s1[sb] = a1 * 0.03125f;
        s2[sb] = a2 * 0.03125f;
        s3[sb] = a3 * 0.03125f;
      }
    }
    bar_arrive(BAR_SUMS + (k & 1), THREADS);
    // the corrected planes of chunk k - 1, once its c1 and c2 are formed
    if (k > 0) {
      bar_sync(BAR_CS + ((k - 1) & 1), THREADS);
      store(k - 1);
    }
  }
  bar_sync(BAR_CS + ((nch - 1) & 1), THREADS);
  store(nch - 1);
}

template <typename E>
int iqcorr_launch(const void* ip, const void* qp, const void* t1,
                  const void* t2, const void* t3, int C, int T, int vec,
                  void* io, void* qo, void* t1o, void* t2o, void* t3o,
                  void* c1o, void* c2o, void* twin, cudaStream_t stream) {
  auto k = iqcorr_kernel<E>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  k<<<C, THREADS, 0, stream>>>(
      (const E*)ip, (const E*)qp, (const float*)t1, (const float*)t2,
      (const float*)t3, T, vec, (float*)io, (float*)qo, (float*)t1o,
      (float*)t2o, (float*)t3o, (float*)c1o, (float*)c2o,
      (unsigned char*)twin);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// i16: 1 = int16 planes (scaled by 1/32768), 0 = f32 planes.  ip, qp:
// (C, T), T a positive multiple of 32; vec: both planes 16-byte aligned
// (16-byte copies); t1..t3: (C,) f32; io, qo: (C, T) f32 out, 16-byte
// aligned; t1..t3, c1, c2 out (C,) f32; twin out (C,) bytes (0/1).
// Returns a cudaError_t.
int uhsdr_iqcorr_launch(int i16, const void* ip, const void* qp,
                        const void* t1, const void* t2, const void* t3,
                        int C, int T, int vec, void* io, void* qo, void* t1o,
                        void* t2o, void* t3o, void* c1o, void* c2o,
                        void* twin, void* stream) {
  if (C < 1 || T < SUB || T % SUB) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (i16)
    return iqcorr_launch<int16_t>(ip, qp, t1, t2, t3, C, T, vec, io, qo, t1o,
                                  t2o, t3o, c1o, c2o, twin, s);
  return iqcorr_launch<float>(ip, qp, t1, t2, t3, C, T, vec, io, qo, t1o,
                              t2o, t3o, c1o, c2o, twin, s);
}

// the blocks an SM holds at once, as the runtime's occupancy calculator
// gives them
int uhsdr_iqcorr_occupancy(int i16) {
  int n = -1;
  cudaError_t e;
  if (i16) {
    cudaFuncSetAttribute(iqcorr_kernel<int16_t>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, iqcorr_kernel<int16_t>, THREADS, 0);
  } else {
    cudaFuncSetAttribute(iqcorr_kernel<float>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, iqcorr_kernel<float>, THREADS, 0);
  }
  return e == cudaSuccess ? n : -1;
}

// the layout, as cuda/iqcorr.py mirrors it
int uhsdr_iqcorr_threads() { return THREADS; }
int uhsdr_iqcorr_chunk(int i16) {
  return i16 ? chunk_of<int16_t>() : chunk_of<float>();
}
int uhsdr_iqcorr_stages() { return STAGES; }
int uhsdr_iqcorr_ahead() { return AHEAD; }
int uhsdr_iqcorr_stage_bytes() { return STAGE_BYTES; }
int uhsdr_iqcorr_smem() { return (int)sizeof(Smem); }
int uhsdr_iqcorr_min_blocks() { return MIN_BLOCKS; }

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
