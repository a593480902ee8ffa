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
// with u carried exactly from chunk to chunk (the reference's
// `exact_carry=True`: ~129 dB on the high-Q PreFilter SOS).
//
// Bound on this card: at the SSB flagship (8192 x 2048, S = 5) 1.43 G FMA
// of FP32 against 134 MB of traffic, about even; FM's squelch and the TX
// voice bandpass the same (the triangle is 64.5 FMA a sample, the state
// terms 4S + 4S^2/R more).
//
// Design: the TPU walks the chunks on its sequential grid axis with u in
// VMEM scratch; here one thread block owns CT = 8 channels and walks
// their n = T/128 chunks in order, u in shared memory across chunks.  A
// chunk (8 x 128 samples) is staged through shared memory with 16-byte
// loads (the next chunk's loads are issued before this chunk's
// arithmetic); thread s computes output column s for all 8 channels.  M
// is Toeplitz (M[r, s] = h[s - r] for s >= r), so only the impulse
// response h lives in shared memory, zero-padded on the left so that
// r > s reads 0 and a warp's loop stops at its own last column (the
// triangle skipped a warp at a time).  The 2S end states (one thread
// each) use the chunk after the outputs, then a barrier, then u moves.
// Plain FP32 FMAs on the CUDA cores: TF32 would break the exact carry.
#include <cuda_runtime.h>

namespace {

constexpr int R = 128;          // chunk length = threads per block
constexpr int CT = 8;           // channels per block
constexpr int MAXS = 8;         // most sections
constexpr int MAXU = 2 * MAXS;  // most states
constexpr int XS = R + 4;       // chunk row stride: 16-byte rows, 4 banks apart

__global__ void __launch_bounds__(R) blocked_kernel(
    const float* __restrict__ x, const float* __restrict__ state,
    const float* __restrict__ M, const float* __restrict__ HS,
    const float* __restrict__ G, const float* __restrict__ Ft, int S,
    int C, int T, float* __restrict__ y, float* __restrict__ state_out) {
  __shared__ __align__(16) float xs[CT][XS];
  __shared__ float hp[2 * R];       // hp[R + k] = h[k], hp[k < R] = 0
  __shared__ float hs[MAXU][R];     // HS
  __shared__ float gs[R][MAXU];     // G
  __shared__ float fs[MAXU][MAXU];  // F^T
  __shared__ float u[CT][MAXU];

  const int U = 2 * S;
  const int s = threadIdx.x;
  const int c0 = blockIdx.x * CT;
  const int nc = min(CT, C - c0);
  const int n = T / R;

  hp[s] = 0.f;
  hp[R + s] = M[s];                 // row 0 of M is h
  for (int j = 0; j < U; ++j) {
    hs[j][s] = HS[j * R + s];
    gs[s][j] = G[s * U + j];
  }
  for (int i = s; i < U * U; i += R) fs[i / U][i % U] = Ft[i];
  // state (S, C, 2): u[c][2k + j] = state[k, c, j]
  for (int i = s; i < CT * U; i += R) {
    const int c = i / U, j = i % U;
    u[c][j] = c < nc ? state[((j >> 1) * C + c0 + c) * 2 + (j & 1)] : 0.f;
  }
  // a chunk is CT x R floats = 2 float4 per thread
  float4 pf[2];
  auto load = [&](int t0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int f = s + k * R;
      const int c = f / (R / 4), q = f % (R / 4);
      pf[k] = c < nc ? *reinterpret_cast<const float4*>(
                           x + (size_t)(c0 + c) * T + t0 + 4 * q)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int f = s + k * R;
      *reinterpret_cast<float4*>(&xs[f / (R / 4)][4 * (f % (R / 4))]) = pf[k];
    }
  };
  load(0);
  store();
  __syncthreads();

  // this thread's end state, if any: channel ec, state ei
  const bool ender = s < CT * U;
  const int ec = ender ? s / U : 0, ei = ender ? s % U : 0;
  // the warp's last column + 1: r beyond it reads zeros for every lane
  const int rmax = (s | 31) + 1;

  for (int ch = 0; ch < n; ++ch) {
    const int t0 = ch * R;
    if (ch + 1 < n) load(t0 + R);

    float acc[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[c] = 0.f;
    for (int j = 0; j < U; ++j) {
      const float hv = hs[j][s];
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[c] = fmaf(u[c][j], hv, acc[c]);
    }
    for (int r = 0; r < rmax; r += 4) {
      const float h0 = hp[R + s - r], h1 = hp[R + s - r - 1];
      const float h2 = hp[R + s - r - 2], h3 = hp[R + s - r - 3];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(&xs[c][r]);
        acc[c] = fmaf(v.x, h0, acc[c]);
        acc[c] = fmaf(v.y, h1, acc[c]);
        acc[c] = fmaf(v.z, h2, acc[c]);
        acc[c] = fmaf(v.w, h3, acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < CT; ++c)
      if (c < nc) y[(size_t)(c0 + c) * T + t0 + s] = acc[c];

    float un = 0.f;
    if (ender) {
      for (int j = 0; j < U; ++j) un = fmaf(u[ec][j], fs[j][ei], un);
      for (int r = 0; r < R; ++r) un = fmaf(xs[ec][r], gs[r][ei], un);
    }
    __syncthreads();
    if (ender) u[ec][ei] = un;
    if (ch + 1 < n) store();
    __syncthreads();
  }

  for (int i = s; i < nc * U; i += R) {
    const int c = i / U, j = i % U;
    state_out[((j >> 1) * C + c0 + c) * 2 + (j & 1)] = u[c][j];
  }
}

}  // namespace

extern "C" {

int uhsdr_blocked_chunk() { return R; }
int uhsdr_blocked_max_sections() { return MAXS; }

// x, y: (C, T) f32 with T % 128 == 0 and 16-byte aligned rows; state,
// state_out: (S, C, 2) f32; M (128, 128), HS (2S, 128), G (128, 2S), Ft
// (2S, 2S) f32 tables of `ops/iir.py::cascade`, on the device.  Requires
// 1 <= S <= 8.  Returns a cudaError_t.
int uhsdr_blocked_launch(const void* x, const void* state, const void* M,
                         const void* HS, const void* G, const void* Ft,
                         int S, int C, int T, void* y, void* state_out,
                         void* stream) {
  if (S < 1 || S > MAXS || T % R != 0) return (int)cudaErrorInvalidValue;
  blocked_kernel<<<(C + CT - 1) / CT, R, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)state, (const float*)M,
      (const float*)HS, (const float*)G, (const float*)Ft, S, C, T,
      (float*)y, (float*)state_out);
  return (int)cudaGetLastError();
}

const char* uhsdr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
