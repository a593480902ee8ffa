"""CW keying detection: wrapper around the hand-written kernel
`kernels/cw.cu`, beside its plain torch version.

A helper kernel with no TPU counterpart: the JAX package computes the
per-frame tone magnitude as a matmul onto cos/sin vectors and runs the
ATC envelopes and the two-sample debounce as `lax.scan`s over frames
(uhsdr_tpu/modems/cw.py:73-141); on the card a torch loop over frames
costs tens of launches a frame.  The kernel walks a channel a lane with
the whole state in registers.  The wrapper takes the plain version only
for tensors on the CPU; for CUDA tensors it checks its arguments,
launches the kernel on the current stream (building it on first use),
raises if the launch failed and adds one to ``CW.launches``.  There is
no fallback.  The kernel is built with -fmad=false and repeats the plain
version's operations in its order: bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..ops import steps
from .build import CudaKernel, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

CW = CudaKernel("cw", "cw.cu", {
    "uhsdr_cw_launch": ([_P, _I, _I, _I, _P, _P, _F, _F, _F, _F, _I, _I,
                         _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
                        _I),
    "uhsdr_cw_max_blocksize": ([], _I),
}, extra_flags=("-fmad=false",))

# as `kernels/cw.cu` defines them: the longest frame a launch takes (the
# reference's is 88 samples) and the channels a block (one a lane)
MAX_BLOCKSIZE = 128
LANES = 32
# the loop-carried chain of a frame in dependent FP32 operations: the
# projection's running sum (an add a sample, the products beside it)
CW_SAMPLE_CHAIN = 1
SIGNAL_TAU = np.float32(0.1)
ONE_MINUS_TAU = np.float32(1.0 - 0.1)
ATC_SPAN = np.float32(0.8)


class CwConsts(NamedTuple):
    """The kernel's scalars: the threshold and the ATC's three weights,
    as the JAX package rounds them (uhsdr_tpu/modems/cw.py:99-102)."""
    thresh: np.float32
    w_fast: np.float32
    w_env: np.float32
    w_noise: np.float32


def consts(thresh: float) -> CwConsts:
    return CwConsts(np.float32(thresh),
                    np.float32(max(thresh / 1000.0 / 4.0, 1.0)),
                    np.float32(max(thresh / 1000.0 * 16.0, 1.0)),
                    np.float32(max(thresh / 1000.0 * 48.0, 1.0)))


class CwLeaves(NamedTuple):
    """The detector's state, each (C,): siglevel, env, noise f32;
    cw_state, change bool (the JAX package's CwRxState order aside)."""
    siglevel: torch.Tensor
    cw_state: torch.Tensor
    change: torch.Tensor
    env: torch.Tensor
    noise: torch.Tensor


def cw_detect_plain(cos_v, sin_v, thresh: float, atc: bool,
                    noisecancel: bool, state: CwLeaves, audio: torch.Tensor):
    """Plain torch version of the kernel.  audio (C, T) f32, T a
    multiple of the frame length; returns (keying (C, T/bs) bool, new
    state).  Per frame: zr = x0 c0 + x1 c1 + ... summed in sample order
    (the same for zi), mag2 = zr zr + zi zi; the ATC's envelopes divide
    by their weights (true division), or the FIR smoother; then the
    two-sample debounce, stepping over frames (`ops/steps.py::scan`)."""
    k = consts(thresh)
    cos_v = np.asarray(cos_v, np.float32)
    sin_v = np.asarray(sin_v, np.float32)
    bs = cos_v.shape[0]
    C, T = audio.shape
    frames = audio[:, :T // bs * bs].reshape(C, T // bs, bs)
    zr = frames[..., 0] * float(cos_v[0])
    zi = frames[..., 0] * float(sin_v[0])
    for j in range(1, bs):
        zr = zr + frames[..., j] * float(cos_v[j])
        zi = zi + frames[..., j] * float(sin_v[j])
    mag2 = zr * zr + zi * zi
    wf, we, wn, tau, keep, span_w, th, zero = steps.consts(
        (k.w_fast, k.w_env, k.w_noise, SIGNAL_TAU, ONE_MINUS_TAU, ATC_SPAN,
         k.thresh, 0.0), audio.device.type == "cpu")
    sel = steps.sel

    def step(carry, xs):
        old, cw, ch, env, noise = carry
        (m,) = xs
        if atc:
            env = env + (m - env) / sel(m > env, wf, we)
            noise = noise + (m - noise) / sel(m < noise, wf, wn)
            cl = sel(m < noise, noise, m)
            cl = sel(cl > env, env, cl)
            span = env - noise
            v1 = (cl - noise) * span - span_w * span * span
            ns = tau * v1 + keep * old >= zero
            old = v1
        else:
            ns = tau * m + keep * old >= th
            old = m
        if noisecancel:
            # a pending change takes the new state and clears; else a
            # change is pending where the new state differs
            cw2 = sel(ch, ns, cw)
            ch = ~ch & (ns != cw2)
            cw = cw2
        else:
            cw = ns
        return (old, cw, ch, env, noise), (steps.pred(cw),)

    carry, (keyed,) = steps.scan(step, tuple(state), (mag2,))
    return keyed.to(torch.bool), CwLeaves(*carry)


def cw_detect(cos_v, sin_v, thresh: float, atc: bool, noisecancel: bool,
              state: CwLeaves, audio: torch.Tensor):
    """Keying detection over one block (the kernel on CUDA tensors, the
    plain version on CPU ones).  audio: (C, T) f32, T a positive
    multiple of the frame length len(cos_v) <= MAX_BLOCKSIZE; state a
    `CwLeaves` of (C,) tensors.  Returns (keying (C, T/bs) bool,
    new_state)."""
    if audio.device.type == "cpu":
        return cw_detect_plain(cos_v, sin_v, thresh, atc, noisecancel,
                               state, audio)
    cos_v = np.ascontiguousarray(np.asarray(cos_v, np.float32).reshape(-1))
    sin_v = np.ascontiguousarray(np.asarray(sin_v, np.float32).reshape(-1))
    bs = cos_v.shape[0]
    if not (1 <= bs <= MAX_BLOCKSIZE) or sin_v.shape != cos_v.shape:
        raise ValueError(f"cw: frame of {bs} samples, the kernel takes 1 "
                         f"to {MAX_BLOCKSIZE}")
    if audio.ndim != 2 or audio.dtype != torch.float32:
        raise ValueError("cw: audio must be (C, T) f32")
    C, T = audio.shape
    if C < 1 or T < bs or T % bs:
        raise ValueError(f"cw: {C} channels of {T} samples, not a positive "
                         f"multiple of {bs}")
    want = (torch.float32, torch.bool, torch.bool, torch.float32,
            torch.float32)
    for leaf, dt in zip(state, want):
        if leaf.shape != (C,) or leaf.dtype != dt:
            raise ValueError(f"cw: state leaves must be (C,) "
                             f"{[str(w) for w in want]}")
    ts = (audio,) + tuple(state)
    if any(t.device != audio.device or not t.is_contiguous() for t in ts):
        raise ValueError("cw: contiguous tensors on one device")
    k = consts(thresh)
    keying = torch.empty((C, T // bs), dtype=torch.bool, device=audio.device)
    new = CwLeaves(*(torch.empty_like(t) for t in state))
    err = CW.lib().uhsdr_cw_launch(
        audio.data_ptr(), C, T, bs, cos_v.ctypes.data, sin_v.ctypes.data,
        float(k.thresh), float(k.w_fast), float(k.w_env), float(k.w_noise),
        int(atc), int(noisecancel), *(t.data_ptr() for t in state),
        keying.data_ptr(), *(t.data_ptr() for t in new),
        stream_ptr(audio.device))
    CW.check(err)
    CW.launches += 1
    return keying, new
