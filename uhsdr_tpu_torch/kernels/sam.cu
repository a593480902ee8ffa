// SAM's sideband stage, hand-written for Hopper (sm_90a): demod/sam.py's
// usb, lsb and stereo routes after the PLL (the reference's
// demod/sam.py:188-236) in one launch, walked on the tile ring of
// ring.cuh as K11 (kernels/biquad.cu) walks its cascade.  The TPU kernel
// it takes the place of is K11's counterpart,
// uhsdr_tpu/pallas/iir.py::_make_kernel (biquad_cascade_pallas, which the
// reference runs on the two stacked allpass pairs, demod/sam.py:200-216);
// the products, delays, combine and fade leveler around it were array
// operations there.
//
// The front warp stages the channel's iq, cos and sin (K10's outputs)
// and four lanes walk each channel, one a path:
//   a = cos*i delayed one sample, b = sin*i, c = sin*q delayed one
//   sample, d = cos*q;
// a and c through the C0 allpass chain, b and d through C1, each section
// [c, 0, 1, 0, c] as y = c*x + s1; s1 = s2; s2 = x - c*y (the DF2T
// recurrence with its products by 0 and 1 dropped: the same values on
// finite inputs, a zero's sign aside, and what the plain version
// `cuda/sam.py::sam_sideband_plain` computes).  Quad shuffles bring the
// four paths together in the plain version's order, usb = (a - b) +
// (d + c), lsb = (a + b) - (d - c), and the lane that owns an audio
// channel runs the fade leveler on it (dc = mR*dc + aR*audio; dci =
// mI*dci + aI*corr, corr = i*cos + q*sin; out = audio + dci - dc); the
// output warps store the audio, (C, T) or stereo's (C, 2, T), LSB left.
// Bound: bytes (iq, cos and sin in, audio out: 20 B a channel and sample
// at one sideband).  Four lanes a channel put 8192 channels in 1024 walker
// warps, about two a scheduler; one a channel would leave half the
// schedulers empty.  -fmad=false as K11: bit-equal to the plain version.
#include "ring.cuh"

namespace {

constexpr int SSI = 2 * TA + 4;     // the complex iq plane's row stride
constexpr int SAM_MAXLW = 8;        // channels of a walker warp
constexpr int SAM_S = 7;            // sections of SAM's allpass chains
static_assert(SSI % 32 == 4, "tile layout");

// SAM's launch: the two chains' coefficients c (rows [c, 0, 1, 0, c]), the
// fade leveler's poles and their 1 - m as f32
struct SamParams {
  float c0[SAM_S], c1[SAM_S];
  float mR, aR, mI, aI;
};

__host__ __device__ inline int sam_stage_floats(int cb, int na) {
  return cb * (SSI + (2 + na) * SS);
}

__host__ __device__ inline int sam_smem_bytes(int lw, int na) {
  return STAGES * sam_stage_floats(NWALK * lw, na) * (int)sizeof(float);
}

// A SAM walker lane: its path's chain (coefficients and states), the
// delayed product, and on the lanes that own an audio channel the fade
// leveler's two states.
struct SamLane {
  float cf[SAM_S], s1[SAM_S], s2[SAM_S];
  float prev, dc, dci;
  bool use_cos, use_i, delayed, first;   // first: lane 0 of its quad
};

// One sample of a quad: each lane its path through its chain, the quad's
// four outputs by shuffles, the audio (MODE 0 usb, 1 lsb on the first
// lane; 2: lsb on the first, usb on the second), the fade leveler.  All
// 32 lanes run it (the shuffles need them).
template <int MODE, bool FADE>
__device__ __forceinline__ float sam_step(SamLane& L, const SamParams& p,
                                          float i, float q, float cs,
                                          float sn) {
  const float pr = (L.use_cos ? cs : sn) * (L.use_i ? i : q);
  float v = L.delayed ? L.prev : pr;
  L.prev = pr;
#pragma unroll
  for (int k = 0; k < SAM_S; ++k) {
    const float out = L.cf[k] * v + L.s1[k];
    L.s1[k] = L.s2[k];
    L.s2[k] = v - L.cf[k] * out;
    v = out;
  }
  const float y1 = __shfl_xor_sync(0xffffffffu, v, 1);
  const float y2 = __shfl_xor_sync(0xffffffffu, v, 2);
  const float y3 = __shfl_xor_sync(0xffffffffu, v, 3);
  float audio;
  if (MODE == 0) {
    audio = (v - y1) + (y3 + y2);            // lane a: (a - b) + (d + c)
  } else if (MODE == 1) {
    audio = (v + y1) - (y3 - y2);            // lane a: (a + b) - (d - c)
  } else {                                   // lane a: lsb; lane b: usb
    const float a = L.first ? v : y1, b = L.first ? y1 : v;
    const float c = L.first ? y2 : y3, d = L.first ? y3 : y2;
    audio = L.first ? (a + b) - (d - c) : (a - b) + (d + c);
  }
  if (FADE) {
    const float corr = i * cs + q * sn;
    L.dc = p.mR * L.dc + p.aR * audio;
    L.dci = p.mI * L.dci + p.aI * corr;
    audio = audio + L.dci - L.dc;
  }
  return audio;
}

// Walker warp wk: quad l < lw walks channel wk * lw + l, lane 4l + k its
// path k (a, b, c, d); the quads past lw repeat the last channel's walk
// and store nothing.
template <int MODE, bool FADE>
__device__ void sam_walker(const float* __restrict__ ap_in,
                           const float* __restrict__ ds_in,
                           const float* __restrict__ fade_in,
                           float* __restrict__ ap_out,
                           float* __restrict__ ds_out,
                           float* __restrict__ fade_out, const SamParams& p,
                           const Geo& g, int c0, int nc, int cb, int ntiles,
                           float* stage, int wk, int lane) {
  constexpr int NA = MODE == 2 ? 2 : 1;
  const int path = lane & 3;
  const int lc = wk * g.lw + min(lane >> 2, g.lw - 1);
  const bool own = (lane >> 2) < g.lw && lc < nc;
  const bool writes = own && path < NA;
  const size_t c = (size_t)c0 + min(lc, nc - 1);
  SamLane L;
  L.use_cos = path == 0 || path == 3;
  L.use_i = path < 2;
  L.delayed = (path & 1) == 0;
  L.first = path == 0;
#pragma unroll
  for (int k = 0; k < SAM_S; ++k) {
    L.cf[k] = path & 1 ? p.c1[k] : p.c0[k];
    // ap_state is (4, SAM_S, C, 2)
    const float2 s = reinterpret_cast<const float2*>(
        ap_in)[((size_t)path * SAM_S + k) * g.C + c];
    L.s1[k] = s.x;
    L.s2[k] = s.y;
  }
  // ds is (C, 2): [a's product, c's product] of the last sample
  L.prev = L.delayed ? ds_in[2 * c + (path >> 1)] : 0.f;
  // the fade states are (2, C, NA): dc, then dc_insert
  const size_t fo = c * NA + min(path, NA - 1);
  L.dc = FADE ? fade_in[fo] : 0.f;
  L.dci = FADE ? fade_in[(size_t)g.C * NA + fo] : 0.f;
  const int sf = sam_stage_floats(cb, NA);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    const int cnt = min(TA, g.T - j * TA);
    float* st = stage + (size_t)s * sf;
    const float* iq = st + lc * SSI;
    const float* cs = st + cb * SSI + lc * SS;
    const float* sn = cs + cb * SS;
    float* out = st + cb * (SSI + 2 * SS) + (lc * NA + min(path, NA - 1)) * SS;
    bar_sync(BAR_FULL + s, 32 + WALK_T);
    if (cnt == TA) {
#pragma unroll 2
      for (int q = 0; q < TA / 4; ++q) {
        const float4 za = reinterpret_cast<const float4*>(iq)[2 * q];
        const float4 zb = reinterpret_cast<const float4*>(iq)[2 * q + 1];
        const float4 c4 = reinterpret_cast<const float4*>(cs)[q];
        const float4 s4 = reinterpret_cast<const float4*>(sn)[q];
        float4 o;
        o.x = sam_step<MODE, FADE>(L, p, za.x, za.y, c4.x, s4.x);
        o.y = sam_step<MODE, FADE>(L, p, za.z, za.w, c4.y, s4.y);
        o.z = sam_step<MODE, FADE>(L, p, zb.x, zb.y, c4.z, s4.z);
        o.w = sam_step<MODE, FADE>(L, p, zb.z, zb.w, c4.w, s4.w);
        if (writes) reinterpret_cast<float4*>(out)[q] = o;
      }
    } else {
      for (int t = 0; t < cnt; ++t) {
        const float o = sam_step<MODE, FADE>(L, p, iq[2 * t], iq[2 * t + 1],
                                             cs[t], sn[t]);
        if (writes) out[t] = o;
      }
    }
    __syncwarp();
    bar_arrive(BAR_DONE + s, WALK_T + OUT_T);
  }
  if (own) {
#pragma unroll
    for (int k = 0; k < SAM_S; ++k)
      reinterpret_cast<float2*>(ap_out)[((size_t)path * SAM_S + k) * g.C +
                                        c] = make_float2(L.s1[k], L.s2[k]);
    if (L.delayed) ds_out[2 * c + (path >> 1)] = L.prev;
  }
  if (FADE && writes) {
    fade_out[fo] = L.dc;
    fade_out[(size_t)g.C * NA + fo] = L.dci;
  }
}

template <int MODE, bool FADE>
__global__ void __launch_bounds__(THREADS, 2) sam_sideband_kernel(
    const float* __restrict__ iq, const float* __restrict__ cos_p,
    const float* __restrict__ sin_p, const float* __restrict__ ap_in,
    const float* __restrict__ ds_in, const float* __restrict__ fade_in,
    SamParams p, Geo g, float* __restrict__ audio,
    float* __restrict__ ap_out, float* __restrict__ ds_out,
    float* __restrict__ fade_out) {
  constexpr int NA = MODE == 2 ? 2 : 1;
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  const int cb = NWALK * g.lw;
  const int c0 = blockIdx.x * cb;
  const int nc = min(cb, g.C - c0);
  const int ntiles = (g.T + TA - 1) / TA;
  const int sf = sam_stage_floats(cb, NA);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < NWALK) {
    sam_walker<MODE, FADE>(ap_in, ds_in, fade_in, ap_out, ds_out, fade_out,
                           p, g, c0, nc, cb, ntiles, stage, warp, lane);
  } else if (warp == NWALK) {
    front(ntiles, [&](int m) {
      const int t0 = m * TA, cnt = min(TA, g.T - t0);
      float* st = stage + (size_t)(m % STAGES) * sf;
      copy_rows(st, SSI, nc, 2 * cnt, 2 * TA, g.vec, [&](int r) {
        return iq + 2 * ((size_t)(c0 + r) * g.T + t0);
      }, lane);
      copy_rows(st + cb * SSI, SS, nc, cnt, TA, g.vec, [&](int r) {
        return cos_p + (size_t)(c0 + r) * g.T + t0;
      }, lane);
      copy_rows(st + cb * (SSI + SS), SS, nc, cnt, TA, g.vec, [&](int r) {
        return sin_p + (size_t)(c0 + r) * g.T + t0;
      }, lane);
    });
  } else {
    const int ow = warp - NWALK - 1;
    const int r0 = ow * g.lw;
    output(audio, g.T, (size_t)c0 * NA, r0 * NA,
           max(0, min(g.lw, nc - r0)) * NA, ntiles, stage, sf,
           cb * (SSI + 2 * SS), lane);
  }
}

template <int MODE, bool FADE>
int launch_sam(const void* iq, const void* cos_p, const void* sin_p,
               const void* ap_in, const void* ds_in, const void* fade_in,
               const SamParams& p, const Geo& g, void* audio, void* ap_out,
               void* ds_out, void* fade_out, cudaStream_t stream) {
  const int smem = sam_smem_bytes(g.lw, MODE == 2 ? 2 : 1);
  cudaError_t e = cudaFuncSetAttribute(
      sam_sideband_kernel<MODE, FADE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int cb = NWALK * g.lw;
  sam_sideband_kernel<MODE, FADE><<<(g.C + cb - 1) / cb, THREADS, smem,
                                    stream>>>(
      (const float*)iq, (const float*)cos_p, (const float*)sin_p,
      (const float*)ap_in, (const float*)ds_in, (const float*)fade_in, p, g,
      (float*)audio, (float*)ap_out, (float*)ds_out, (float*)fade_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int uhsdr_sam_threads() { return THREADS; }
int uhsdr_sam_walkers() { return NWALK; }
int uhsdr_sam_tile() { return TA; }
int uhsdr_sam_stages() { return STAGES; }

// The stage's dynamic shared memory a block at lw channels a walker
// (1..8) and na audio channels (1 or 2), or -1.
int uhsdr_sam_sideband_smem(int lw, int na) {
  return lw >= 1 && lw <= SAM_MAXLW && (na == 1 || na == 2)
             ? sam_smem_bytes(lw, na)
             : -1;
}

// SAM's sideband stage.  iq: (C, T) complex64; cos_p, sin_p: (C, T) f32
// (K10's); ap_in, ap_out: (4, 7, C, 2) f32; ds_in, ds_out: (C, 2) f32;
// fade_in, fade_out: (2, C, na) f32 [dc, dc_insert] (read and written
// only with fade); coef: 14 floats on the host, C0's then C1's section
// coefficient c; aR = 1 - mR, aI = 1 - mI as f32.  mode: 0 usb, 1 lsb, 2
// stereo (audio (C, 2, T), LSB left; na = 2); else audio (C, T).  lw:
// channels a walker (cuda/sam.py::sam_geometry); vec: every (C, T) plane
// 16-byte aligned and T % 4 == 0.  Returns a cudaError_t.
int uhsdr_sam_sideband_launch(const void* iq, const void* cos_p,
                              const void* sin_p, const void* ap_in,
                              const void* ds_in, const void* fade_in,
                              const float* coef, float mR, float aR, float mI,
                              float aI, int C, int T, int lw, int vec,
                              int mode, int fade, void* audio, void* ap_out,
                              void* ds_out, void* fade_out, void* stream) {
  if (T < 1 || C < 1 || lw < 1 || lw > SAM_MAXLW || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  SamParams p;
  for (int k = 0; k < SAM_S; ++k) {
    p.c0[k] = coef[k];
    p.c1[k] = coef[SAM_S + k];
  }
  p.mR = mR;
  p.aR = aR;
  p.mI = mI;
  p.aI = aI;
  const Geo g{C, T, lw, vec};
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         const void*, const void*, const SamParams&,
                         const Geo&, void*, void*, void*, void*,
                         cudaStream_t);
  static const Launch table[3][2] = {
      {launch_sam<0, false>, launch_sam<0, true>},
      {launch_sam<1, false>, launch_sam<1, true>},
      {launch_sam<2, false>, launch_sam<2, true>}};
  return table[mode][fade ? 1 : 0](iq, cos_p, sin_p, ap_in, ds_in, fade_in,
                                   p, g, audio, ap_out, ds_out, fade_out,
                                   (cudaStream_t)stream);
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
