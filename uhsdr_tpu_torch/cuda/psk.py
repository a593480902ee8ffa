"""BPSK demodulation: wrapper around the hand-written kernel
`kernels/psk.cu`, beside its plain torch version.

A helper kernel with no TPU counterpart: the JAX package runs the
band-pass biquad as a dilated scan, the NCO product and a cumulative-sum
moving average as array passes, and picks the symbols by a strided
gather (uhsdr_tpu/modems/psk.py:79-118); on the card a torch loop over
the biquad's samples costs some ten launches a sample.  The kernel walks
a channel a lane with the filter state, the phase accumulator and the
last carrier period's products in registers.  The wrapper takes the
plain version only for tensors on the CPU; for CUDA tensors it checks
its arguments, launches the kernel on the current stream (building it on
first use), raises if the launch failed and adds one to
``PSK.launches``.  There is no fallback.  The kernel's recurrences are
written with round-to-nearest intrinsics (no contraction) and its sine
is the library's `sinf`, which `torch.sin` calls: bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..ops import iir, nco
from .build import CudaKernel, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint

PSK = CudaKernel("psk", "psk.cu", {
    "uhsdr_psk_launch": ([_P, _I, _I, _I, _P, _U, _F, _P, _P, _P, _P, _P,
                          _P, _P, _P, _P, _P, _P, _P], _I),
    "uhsdr_psk_window": ([], _I),
})

# as `kernels/psk.cu` defines them: the moving average's window (the
# reference's PSK_BUF_LEN at 12 kHz), the samples of a staged tile, the
# channels a block (one a lane)
WINDOW = 24
TILE = 96
LANES = 32
# the loop-carried chain of a sample: the biquad's s1 -> y (an add) ->
# a1 * y (a multiply) -> the subtraction -> the s2 add
PSK_SAMPLE_CHAIN = 4


class PskLeaves(NamedTuple):
    """The demodulator's state: bq (C, 2) f32, phase (C,) int64 in
    [0, 2^32), tail (C, window - 1) f32 (the last products), last_symbol
    (C,) f32, last_bit (C,) int32."""
    bq: torch.Tensor
    phase: torch.Tensor
    tail: torch.Tensor
    last_symbol: torch.Tensor
    last_bit: torch.Tensor


def psk_plain(bpf, delta: int, rate: int, state: PskLeaves,
              audio: torch.Tensor):
    """Plain torch version of the kernel.  audio (C, T) f32, T a
    multiple of `rate`.  The biquad runs sample by sample
    (`ops/iir.py::biquad_block`); the carrier is sin of the JAX
    package's f32 angle (`ops/nco.py::angle_f32`); each symbol is the sum
    of the last window products in sample order, taken directly at its
    instant from the carried tail and the block, divided by the window
    (true division); bit = 0 where the previous symbol times this one is
    negative, else 1.  Returns (bits (C, T/rate) int32, new state)."""
    C, T = audio.shape
    L = state.tail.shape[-1] + 1
    y, bq = iir.biquad_block(bpf, state.bq, audio)
    prod = torch.sin(nco.angle_f32(nco.phase_ramp(state.phase, delta, T))) * y
    full = torch.cat([state.tail, prod], dim=-1)
    n_sym = T // rate
    start = torch.arange(n_sym, device=audio.device) * rate + (rate - 1)
    acc = full[:, start]
    for j in range(1, L):
        acc = acc + full[:, start + j]
    symbols = acc / torch.full_like(acc, float(L))
    prev = torch.cat([state.last_symbol[:, None], symbols[:, :-1]], dim=-1)
    bits = torch.where(prev * symbols < 0, 0, 1).to(torch.int32)
    new = PskLeaves(bq, nco.advance(state.phase, delta, T),
                    full[:, full.shape[-1] - (L - 1):].contiguous(),
                    symbols[:, -1].contiguous(), bits[:, -1].contiguous())
    return bits, new


def psk(bpf, delta: int, rate: int, state: PskLeaves, audio: torch.Tensor):
    """BPSK demodulation over one block (the kernel on CUDA tensors, the
    plain version on CPU ones).  audio: (C, T) f32, T a positive multiple
    of `rate`; bpf (5,) [b0 b1 b2 a1 a2]; delta the NCO's uint32
    increment; state a `PskLeaves`.  The kernel takes the 12 kHz window
    (24) and rates that are multiples of its tile (96, 192, 384).
    Returns (bits (C, T/rate) int32, new_state)."""
    if audio.device.type == "cpu":
        return psk_plain(bpf, delta, rate, state, audio)
    if audio.ndim != 2 or audio.dtype != torch.float32:
        raise ValueError("psk: audio must be (C, T) f32")
    C, T = audio.shape
    L = state.tail.shape[-1] + 1
    if L != WINDOW or rate % TILE or C < 1 or T < rate or T % rate:
        raise ValueError(f"psk: window {L}, rate {rate}, {C} x {T}: the "
                         f"kernel takes window {WINDOW}, rates that are "
                         f"multiples of {TILE}, T a positive multiple of "
                         f"the rate")
    want = ((C, 2), (C,), (C, L - 1), (C,), (C,))
    dts = (torch.float32, torch.int64, torch.float32, torch.float32,
           torch.int32)
    for leaf, shp, dt in zip(state, want, dts):
        if tuple(leaf.shape) != shp or leaf.dtype != dt:
            raise ValueError(f"psk: state leaves must be {want} of {dts}")
    ts = (audio,) + tuple(state)
    if any(t.device != audio.device or not t.is_contiguous() for t in ts):
        raise ValueError("psk: contiguous tensors on one device")
    c = np.ascontiguousarray(np.asarray(bpf, np.float32).reshape(5))
    bits = torch.empty((C, T // rate), dtype=torch.int32, device=audio.device)
    new = PskLeaves(*(torch.empty_like(t) for t in state))
    err = PSK.lib().uhsdr_psk_launch(
        audio.data_ptr(), C, T, rate, c.ctypes.data, int(delta) & nco.MASK32,
        float(nco.PHASE_SCALE_F32), *(t.data_ptr() for t in state),
        bits.data_ptr(), *(t.data_ptr() for t in new),
        stream_ptr(audio.device))
    PSK.check(err)
    PSK.launches += 1
    return bits, new
