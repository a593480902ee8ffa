"""The NLMS and leaky-LMS adaptive filters: wrappers around the
hand-written kernel `kernels/lms.cu`, beside their plain torch versions.

Helper kernels with no TPU counterpart: the JAX package runs both as a
`lax.scan` over time (uhsdr_tpu/ops/lms.py:103-151).  On the card a torch
time loop would cost about eight launches a sample, 2048 samples a block,
so each filter is one launch: `nlms` (the auto-notch and the NLMS NR) and
`leaky` (WDSP's variable-leak LMS with its lidx walk), either giving the
error (notch) or the prediction (NR).  The wrappers take the plain
version only for tensors on the CPU; for CUDA tensors they check their
arguments, launch the kernel on the current stream (building it on first
use), raise if the launch failed and add one to ``LMS.launches`` or
``LMS_LEAKY.launches``.  There is no fallback.

The kernel gives a channel LANES lanes, tap j to lane j % LANES; the two
dot products of a step (w . ref and ref . ref) are each lane's left fold
of its taps and then a pairwise tree over the lanes (`trees.lane_sum`),
which the plain versions spell out, so kernel and plain version agree bit
for bit; the kernel is built with -fmad=false.
"""
from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel, stream_ptr
from .trees import lane_sum

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

LMS = CudaKernel("lms", "lms.cu", {
    "uhsdr_lms_launch": ([_I] * 6 + [_P] * 5 + [_F] * 8 + [_P] * 6, _I),
}, extra_flags=("-fmad=false",))
# the leaky instance's launches, counted apart (one library)
LMS_LEAKY = CudaKernel("lms_leaky", "lms.cu", lib_of=LMS)

# lanes a channel (`kernels/lms.cu`'s G) and the taps a lane it is built
# for
LANES = 8
TAPS_PER_LANE = (8, 12)


def _check_taps(L: int):
    if L % LANES or L // LANES not in TAPS_PER_LANE:
        raise ValueError(f"lms: {L} taps; the kernel takes "
                         f"{[LANES * p for p in TAPS_PER_LANE]}")


def nlms_plain(params, w, hist, x):
    """Plain torch version of the NLMS instance (`ops.lms.run`): per
    sample, ref = the delayed window, pred = w . ref, err = x - pred,
    norm = ref . ref + 1e-9, w = leak w + (mu err / norm) ref.  params:
    `ops.lms.LmsParams`; w (C, L); hist (C, L + D); x (C, T).  Returns
    (y (C, T): err or pred, w, hist), the new history its own storage."""
    L, D = params.num_taps, params.delay
    win = torch.cat([hist, x], dim=-1)
    out = []
    for n in range(x.shape[-1]):
        ref = win[:, n + 1:n + 1 + L]
        xn = win[:, n + L + D]
        pred = lane_sum(w * ref, LANES)
        err = xn - pred
        norm = lane_sum(ref * ref, LANES) + 1e-9
        w = params.leak * w + (params.mu * err / norm)[:, None] * ref
        out.append(err if params.output_error else pred)
    return (torch.stack(out, dim=-1), w,
            win[:, win.shape[-1] - (L + D):].clone())


def leaky_plain(params, w, hist, lidx, ngamma, x):
    """Plain torch version of the leaky instance (`ops.lms.leaky_lms_run`,
    audio_driver.c:521-577): the NLMS step with the leakage ngamma driven
    by the nel/nev walk of lidx.  params: `ops.lms.LeakyLmsParams`; w (C,
    L); hist (C, L + D); lidx, ngamma (C,); x (C, T).  Returns (y, w,
    hist, lidx, ngamma)."""
    L, D = params.num_taps, params.delay
    tmu = params.two_mu
    win = torch.cat([hist, x], dim=-1)
    out = []
    for n in range(x.shape[-1]):
        ref = win[:, n + 1:n + 1 + L]
        xn = win[:, n + L + D]
        y = lane_sum(w * ref, LANES)
        sigma = lane_sum(ref * ref, LANES)
        inv_sigp = 1.0 / (sigma + 1e-10)
        err = xn - y
        out.append(err if params.output_error else y)
        nel = (err * (1.0 - tmu * sigma * inv_sigp)).abs()
        nev = (xn - (1.0 - tmu * ngamma) * y
               - tmu * err * sigma * inv_sigp).abs()
        lidx = torch.where(
            nev < nel, torch.clamp_max(lidx + params.lincr, params.lidx_max),
            torch.clamp_min(lidx - params.ldecr, params.lidx_min))
        ngamma = params.gamma * (lidx * lidx) * (lidx * lidx) \
            * params.den_mult
        c0 = 1.0 - tmu * ngamma
        c1 = tmu * err * inv_sigp
        w = c0[:, None] * w + c1[:, None] * ref
    return (torch.stack(out, dim=-1), w,
            win[:, win.shape[-1] - (L + D):].clone(), lidx, ngamma)


def _launch(kernel, leaky: bool, params, w, hist, x, lidx=None,
            ngamma=None):
    dev = x.device
    L, D = params.num_taps, params.delay
    _check_taps(L)
    if x.ndim != 2 or x.shape[-1] < 1:
        raise ValueError("lms: x must be (C, T), T >= 1")
    C, T = x.shape
    ts = [w, hist, x] + ([lidx, ngamma] if leaky else [])
    if (w.shape != (C, L) or hist.shape != (C, L + D)
            or (leaky and (lidx.shape != (C,) or ngamma.shape != (C,)))):
        raise ValueError(f"lms: w (C, {L}), hist (C, {L + D})"
                         + (", lidx and ngamma (C,)" if leaky else ""))
    if any(t.dtype != torch.float32 or t.device != dev
           or not t.is_contiguous() for t in ts):
        raise ValueError("lms: contiguous f32 tensors on one device")
    y = torch.empty_like(x)
    w_out = torch.empty_like(w)
    h_out = torch.empty_like(hist)
    l_out = torch.empty((C,), dtype=torch.float32, device=dev)
    g_out = torch.empty_like(l_out)
    if leaky:
        f = (params.two_mu, params.gamma, params.lidx_min, params.lidx_max,
             params.den_mult, params.lincr, params.ldecr, 0.0)
        sl = (lidx.data_ptr(), ngamma.data_ptr())
    else:
        f = (params.mu, params.leak) + (0.0,) * 6
        sl = (None, None)
    err = LMS.lib().uhsdr_lms_launch(
        int(leaky), int(bool(params.output_error)), L, D, C, T,
        w.data_ptr(), hist.data_ptr(), x.data_ptr(), *sl, *f,
        y.data_ptr(), w_out.data_ptr(), h_out.data_ptr(), l_out.data_ptr(),
        g_out.data_ptr(), stream_ptr(dev))
    LMS.check(err)
    kernel.launches += 1
    return y, w_out, h_out, l_out, g_out


def nlms(params, w, hist, x):
    """The NLMS filter over one block (the kernel on CUDA tensors, the
    plain version on CPU ones); arguments and results as
    `nlms_plain`'s."""
    if x.device.type == "cpu":
        return nlms_plain(params, w, hist, x)
    return _launch(LMS, False, params, w, hist, x)[:3]


def leaky(params, w, hist, lidx, ngamma, x):
    """The leaky LMS over one block; arguments and results as
    `leaky_plain`'s."""
    if x.device.type == "cpu":
        return leaky_plain(params, w, hist, lidx, ngamma, x)
    return _launch(LMS_LEAKY, True, params, w, hist, x, lidx, ngamma)
