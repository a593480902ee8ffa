// CW keying detection, hand-written for Hopper (sm_90a).  A helper kernel
// with no TPU counterpart: the JAX package's `keying_detect`
// (uhsdr_tpu/modems/cw.py:73-141) projects each 88-sample frame onto
// cos/sin vectors as a matmul (:80-82), then runs the fldigi-style ATC as
// a lax.scan over frames (:98-112) or the FIR smoother (:118-121), and the
// two-sample debounce as a second lax.scan (:124-134).  Per channel and
// frame f of bs samples x[f*bs + j]:
//   zr = x0 c0 + x1 c1 + ... (sample order), zi likewise with s; m = zr zr + zi zi
//   ATC:  env += (m - env) / (m > env ? w_fast : w_env)
//         noise += (m - noise) / (m < noise ? w_fast : w_noise)
//         cl = min(max(m, noise), env) as selects; span = env - noise
//         v1 = (cl - noise) span - 0.8 span span
//         keyed = 0.1 v1 + 0.9 old >= 0; old = v1
//   else: keyed = 0.1 m + 0.9 old >= thresh; old = m
//   debounce: cw2 = change ? keyed : cw; change = !change && keyed != cw2
//
// Bound on this card: bytes.  The audio is read once (8192 x 2048 f32 at
// the RX flagship's decoder tap, 67 MB, 0.020 ms at 3.35 TB/s); a frame's
// loop-carried chain is the projection's running sum, one add a sample
// (cuda/cw.py::CW_SAMPLE_CHAIN), 2024 dependent adds, ~0.004 ms at 1.98 GHz
// with two chains (zr, zi) side by side.
//
// Design: a lane a channel with its state in registers, a warp a block
// (32 channels; 8192 channels are 256 one-warp blocks, spread over all
// SMs' schedulers).  The warp stages a frame of its 32 channels in shared
// memory (a 128-byte line a load, rows padded so a lane reading its own
// row meets no bank conflict) and each lane walks its row; the next
// frame's loads, all independent, are in flight in registers meanwhile
// (a first body that issued them one row at a time, each load waiting for
// the last, ran 35x its byte bound on the card).  The
// projection vectors travel in the launch's parameters, read at
// unrolled (static) offsets.  Compiled with -fmad=false and true division,
// so every product, sum and quotient rounds as the plain version's
// (cuda/cw.py::cw_detect_plain): bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_BS = 128;
constexpr int LANES = 32;
constexpr int LOADS = MAX_BS / LANES;  // a lane's loads of a row's frame

struct Proj {
  float c[MAX_BS];
  float s[MAX_BS];
};

__global__ void __launch_bounds__(LANES) cw_kernel(
    const float* __restrict__ x, int C, int T, int bs, const Proj pr,
    float thresh, float wf, float we, float wn, int atc, int nc,
    const float* __restrict__ sig_in, const bool* __restrict__ cw_in,
    const bool* __restrict__ ch_in, const float* __restrict__ env_in,
    const float* __restrict__ noise_in, bool* __restrict__ keying,
    float* __restrict__ sig_out, bool* __restrict__ cw_out,
    bool* __restrict__ ch_out, float* __restrict__ env_out,
    float* __restrict__ noise_out) {
  __shared__ float tile[LANES][MAX_BS + 1];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * LANES;
  const int row = row0 + lane;
  const int nrows = min(LANES, C - row0);
  const bool live = row < C;
  float old = live ? sig_in[row] : 0.f;
  bool cw = live ? cw_in[row] : false;
  bool ch = live ? ch_in[row] : false;
  float env = live ? env_in[row] : 0.f;
  float noise = live ? noise_in[row] : 0.f;
  const int nblk = T / bs;
  // the next frame's samples, loaded while this one is walked
  float nxt[LANES][LOADS];
#pragma unroll
  for (int r = 0; r < LANES; ++r)
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int j = k * LANES + lane;
      nxt[r][k] = (r < nrows && j < bs) ? x[(size_t)(row0 + r) * T + j] : 0.f;
    }
  for (int f = 0; f < nblk; ++f) {
    __syncwarp();
#pragma unroll
    for (int r = 0; r < LANES; ++r)
#pragma unroll
      for (int k = 0; k < LOADS; ++k) tile[r][k * LANES + lane] = nxt[r][k];
    __syncwarp();
    const size_t tn = (size_t)(f + 1) * bs;
    const bool more = f + 1 < nblk;
#pragma unroll
    for (int r = 0; r < LANES; ++r)
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int j = k * LANES + lane;
        nxt[r][k] = (more && r < nrows && j < bs)
                        ? x[(size_t)(row0 + r) * T + tn + j] : 0.f;
      }
    float zr = tile[lane][0] * pr.c[0];
    float zi = tile[lane][0] * pr.s[0];
#pragma unroll
    for (int j = 1; j < MAX_BS; ++j) {
      if (j < bs) {
        const float v = tile[lane][j];
        zr = zr + v * pr.c[j];
        zi = zi + v * pr.s[j];
      }
    }
    const float m = zr * zr + zi * zi;
    bool keyed;
    if (atc) {
      env = env + (m - env) / (m > env ? wf : we);
      noise = noise + (m - noise) / (m < noise ? wf : wn);
      float cl = m < noise ? noise : m;
      cl = cl > env ? env : cl;
      const float span = env - noise;
      const float v1 = (cl - noise) * span - 0.8f * span * span;
      keyed = 0.1f * v1 + 0.9f * old >= 0.0f;
      old = v1;
    } else {
      keyed = 0.1f * m + 0.9f * old >= thresh;
      old = m;
    }
    if (nc) {
      const bool cw2 = ch ? keyed : cw;
      ch = !ch && keyed != cw2;
      cw = cw2;
    } else {
      cw = keyed;
    }
    if (live) keying[(size_t)row * nblk + f] = cw;
  }
  if (live) {
    sig_out[row] = old;
    cw_out[row] = cw;
    ch_out[row] = ch;
    env_out[row] = env;
    noise_out[row] = noise;
  }
}

}  // namespace

extern "C" {

int uhsdr_cw_max_blocksize() { return MAX_BS; }

// x: (C, T) f32, T a positive multiple of bs <= MAX_BS; cs, sn: (bs,) f32
// on the host; the state leaves (C,): siglevel, cw_state (bool), change
// (bool), env, noise, in and out; keying (C, T / bs) bool.  Returns a
// cudaError_t (cudaErrorInvalidValue for a shape the kernel does not
// take).
int uhsdr_cw_launch(const void* x, int C, int T, int bs, const float* cs,
                    const float* sn, float thresh, float wf, float we,
                    float wn, int atc, int nc, const void* sig_in,
                    const void* cw_in, const void* ch_in, const void* env_in,
                    const void* noise_in, void* keying, void* sig_out,
                    void* cw_out, void* ch_out, void* env_out,
                    void* noise_out, void* stream) {
  if (bs < 1 || bs > MAX_BS || C < 1 || T < bs || T % bs)
    return (int)cudaErrorInvalidValue;
  Proj pr = {};
  for (int j = 0; j < bs; ++j) {
    pr.c[j] = cs[j];
    pr.s[j] = sn[j];
  }
  const int blocks = (C + LANES - 1) / LANES;
  cw_kernel<<<blocks, LANES, 0, (cudaStream_t)stream>>>(
      (const float*)x, C, T, bs, pr, thresh, wf, we, wn, atc, nc,
      (const float*)sig_in, (const bool*)cw_in, (const bool*)ch_in,
      (const float*)env_in, (const float*)noise_in, (bool*)keying,
      (float*)sig_out, (bool*)cw_out, (bool*)ch_out, (float*)env_out,
      (float*)noise_out);
  return (int)cudaGetLastError();
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
