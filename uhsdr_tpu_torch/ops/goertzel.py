"""Single-bin tone energy detection.

The counterpart of `uhsdr_tpu.ops.goertzel`: the reference's Goertzel
recurrences (FM subtone detection, `audio_driver.c:1694`,
`audio_filter.c:1281-1303`; the CW decoder, `cw/cw_decoder.c:128-300`)
evaluate one DFT bin, so the direct projection |sum_n x[n] e^{-j w n}|^2
is computed instead, with the phase carried across blocks.  Plain torch
sums: the JAX package computes these with XLA reductions and no kernel,
and no chain calls them.  The angle is the JAX package's f32 one
(`ops/nco.py::angle_f32`).
"""
from __future__ import annotations

import torch

from . import nco


def goertzel_block(x: torch.Tensor, phase0: torch.Tensor, delta):
    """Complex DFT projection of block x (..., T) at the NCO frequency
    (phase0 (...,) int64 in [0, 2^32), delta the uint32 increment).
    Returns (z (...,) complex64 partial sum for this block, new_phase).
    Accumulate z across blocks, then take |z|^2 for tone power."""
    T = x.shape[-1]
    ph = nco.angle_f32(nco.phase_ramp(phase0, delta, T))
    zr = (x * torch.cos(ph)).sum(-1)
    zi = -(x * torch.sin(ph)).sum(-1)
    return torch.complex(zr, zi), nco.advance(phase0, delta, T)


def tone_power(x: torch.Tensor, freq_hz: float, fs: float) -> torch.Tensor:
    """One-shot normalized tone power of a block: |proj|^2 / (T/2)^2 gives
    the amplitude^2 of a unit sine."""
    delta = int(nco.freq_to_delta(freq_hz, fs))
    z, _ = goertzel_block(x, torch.zeros(x.shape[:-1], dtype=torch.int64,
                                         device=x.device), delta)
    T = x.shape[-1]
    return (z.abs() / (T / 2.0)) ** 2
