"""K11 (the biquad cascade): wrapper around the hand-written kernel
`kernels/biquad.cu`, beside its plain torch version.

The wrapper takes the plain version only for tensors on the CPU.  For
CUDA tensors it checks device, dtype, shape and contiguity, launches the
kernel on the current stream (building it on first use), raises if the
launch failed, and adds one to ``BIQUAD.launches``.  There is no fallback.

Replaces uhsdr_tpu/pallas/iir.py::_make_kernel (:44), entered from
`biquad_cascade_pallas` (:336).  On the slice's path it runs SAM's two
stacked 7-section z^-2 allpass chains (demod/sam.py:213-216); it takes
any SOS rows [b0, b1, b2, a1, a2], up to 8 sections.  On the card it is
bound by its bytes; see the note in the source.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops import iir as iir_ops
from .build import CudaKernel, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int

BIQUAD = CudaKernel("biquad", "biquad.cu", {
    "uhsdr_biquad_launch": ([_P, _P, _P, _I, _I, _I, _P, _P, _P], _I),
    "uhsdr_biquad_max_sections": ([], _I),
}, extra_flags=("-fmad=false",))


def biquad_cascade_plain(sos, state, x):
    """Plain torch version of K11: the sequential DF2T recurrence
    (`ops.iir.biquad_cascade_block`)."""
    return iir_ops.biquad_cascade_block(sos, state, x)


def biquad_cascade(sos, state, x):
    """S-section biquad cascade (K11).  sos: (S, 5) f32 rows
    [b0, b1, b2, a1, a2]; state: (S, C, 2) f32 DF2T states; x: (C, T) f32.
    Returns (y (C, T), new_state (S, C, 2))."""
    if x.device.type == "cpu":
        return biquad_cascade_plain(sos, state, x)
    dev = x.device
    if x.ndim != 2 or x.shape[-1] < 1:
        raise ValueError("biquad_cascade: x must be (C, T), T >= 1")
    C, T = x.shape
    lib = BIQUAD.lib()
    S = sos.shape[0]
    if sos.shape != (S, 5) or not 1 <= S <= lib.uhsdr_biquad_max_sections():
        raise ValueError(
            f"biquad_cascade: sos must be (S, 5) with 1 <= S <= "
            f"{lib.uhsdr_biquad_max_sections()}, got {tuple(sos.shape)}")
    if state.shape != (S, C, 2):
        raise ValueError("biquad_cascade: state must be (S, C, 2)")
    ts = (sos, state, x)
    if any(t.dtype != torch.float32 or t.device != dev
           or not t.is_contiguous() for t in ts):
        raise ValueError("biquad_cascade: contiguous f32 tensors on one "
                         "device")
    y = torch.empty_like(x)
    new_state = torch.empty_like(state)
    err = lib.uhsdr_biquad_launch(
        x.data_ptr(), state.data_ptr(), sos.data_ptr(), S, C, T,
        y.data_ptr(), new_state.data_ptr(), stream_ptr(dev))
    BIQUAD.check(err)
    BIQUAD.launches += 1
    return y, new_state
