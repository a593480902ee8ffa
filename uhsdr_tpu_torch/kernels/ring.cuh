// The warp-specialised tile ring that K11 (kernels/biquad.cu) and SAM's
// sideband stage (kernels/sam.cu) walk their recurrences on, as
// kernels/alc.cu and kernels/pll.cu do: a block owns NWALK * lw rows
// (lw lanes of each walker warp) and 9 warps in three roles that pass
// time tiles of TA samples through a ring of STAGES stage buffers in
// shared memory, each handed on by a named barrier (bar.arrive by the
// producer, bar.sync by the consumer), so that no role waits on a
// block-wide barrier inside the tile loop:
//   - the front warp (`front`) copies tiles k+1 .. k+3 into the ring by
//     16-byte cp.async, lanes along time (4-byte copies where rows are
//     not 16-byte aligned);
//   - NWALK walker warps, one per scheduler, wait on BAR_FULL + s, walk
//     the tile out of shared memory, write their outputs into the stage
//     and arrive on BAR_DONE + s;
//   - NOUT output warps (`output`, lanes along time, each a walker's
//     rows) store the outputs coalesced and free the stage.
// The layout constants are mirrored by cuda/ring.py; each library
// exports them and its wrapper checks the two agree.
#ifndef UHSDR_RING_CUH
#define UHSDR_RING_CUH
#include <cuda_runtime.h>

namespace {

constexpr int TA = 32;              // time tile: samples a stage holds
constexpr int SS = TA + 4;          // a real plane's row stride, floats:
                                    // 16-byte rows, float4 reads by row
                                    // lanes conflict-free
constexpr int STAGES = 4;           // stage buffers in the ring
constexpr int AHEAD = STAGES - 1;   // tiles the front keeps in flight
constexpr int NWALK = 4;            // walker warps: one per scheduler
constexpr int NOUT = NWALK;         // output warps: one per walker
constexpr int WALK_T = 32 * NWALK;
constexpr int OUT_T = 32 * NOUT;
constexpr int THREADS = WALK_T + 32 + OUT_T;
// named barriers (0 is __syncthreads'): stage s holds the inputs (front
// -> walkers), holds the outputs (walkers -> output), is free (output ->
// front)
constexpr int BAR_FULL = 1;
constexpr int BAR_DONE = BAR_FULL + STAGES;
constexpr int BAR_FREE = BAR_DONE + STAGES;
static_assert(BAR_FREE + STAGES <= 16, "16 named barriers a block");
static_assert(TA % 32 == 0 && SS % 32 == 4, "tile layout");

struct Geo {
  int C, T, lw;    // rows (K11) or channels (SAM), samples, lanes a walker
  int vec;         // rows 16-byte aligned: 16-byte copies
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

// A copy of nr rows of a tile into a plane of row stride `stride`: n
// floats a row (of at most `width`) from src(r) on, 16 bytes a lane where
// vec (n a multiple of 4), else 4.
template <typename Src>
__device__ __forceinline__ void copy_rows(float* plane, int stride, int nr,
                                          int n, int width, bool vec,
                                          Src src, int lane) {
  if (vec) {
    const int q4 = width / 4;
    for (int i = lane; i < nr * q4; i += 32) {
      const int r = i / q4, q = 4 * (i % q4);
      if (q < n) cp_async16(plane + r * stride + q, src(r) + q);
    }
  } else {
    for (int r = 0; r < nr; ++r)
      for (int q = lane; q < n; q += 32)
        cp_async4(plane + r * stride + q, src(r) + q);
  }
}

// The front warp: tiles 0 .. AHEAD-1 first, then for each tile j: hand
// it on once it has landed, and copy tile j + AHEAD into the stage the
// output warps freed.  load(m) issues tile m's copies; one cp.async
// group a tile.
template <typename Load>
__device__ __forceinline__ void front(int ntiles, Load load) {
  for (int m = 0; m < AHEAD; ++m) {
    if (m < ntiles) load(m);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int j = 0; j < ntiles; ++j) {
    // tiles 0 .. j + AHEAD - 1 are committed: tile j has landed when at
    // most AHEAD - 1 groups are pending
    asm volatile("cp.async.wait_group %0;" ::"n"(AHEAD - 1) : "memory");
    __syncwarp();
    bar_arrive(BAR_FULL + j % STAGES, 32 + WALK_T);
    const int m = j + AHEAD;
    if (m < ntiles) {
      // its stage held tile m - STAGES: wait until the output warps are
      // done with it
      if (m >= STAGES) bar_sync(BAR_FREE + m % STAGES, 32 + OUT_T);
      load(m);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
}

// An output warp: for each tile, once the walkers are done with it, the
// rows [r0, r0 + nr) of the stage's output plane (row stride SS) go to
// rows g0 + r of y (T samples a row), lanes along time; then the stage is
// freed.
__device__ __forceinline__ void output(float* __restrict__ y, int T,
                                       size_t g0, int r0, int nr, int ntiles,
                                       float* stage, int stage_floats,
                                       int plane, int lane) {
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    const int cnt = min(TA, T - j * TA);
    bar_sync(BAR_DONE + s, WALK_T + OUT_T);
    if (lane < cnt) {
      const float* pl = stage + (size_t)s * stage_floats + plane;
      float* yt = y + (g0 + r0) * T + (size_t)j * TA + lane;
#pragma unroll 4
      for (int k = 0; k < nr; ++k)
        yt[(size_t)k * T] = pl[(r0 + k) * SS + lane];
    }
    __syncwarp();
    if (j + STAGES < ntiles) bar_arrive(BAR_FREE + s, 32 + OUT_T);
  }
}

}  // namespace

#endif  // UHSDR_RING_CUH
