"""Automatic IQ imbalance correction (Moseley-Slump) with twin-peaks
detection.

The torch counterpart of `uhsdr_tpu.ops.iqcorr`.  Reference:
`AudioDriver_RxHandleIqCorrection` (`audio_driver.c:2254-2316`), per
32-sample block:

  teta1 = -lp(sum sign(i) q),  teta2 = lp(sum |i|),  teta3 = lp(sum |q|)
  (one-pole lowpass 0.003/0.997 at block cadence)
  c1 = teta1/teta2,  c2 = sqrt((teta3^2 - teta1^2)/teta2^2)
  correction (order matters): q += c1 i;  i *= c2.

Twin-peaks detection (`AudioDriver_RxHandleTwinpeaks:2173-2253`) emits a
per-channel flag where the settled I/Q phase estimate is implausible.
The whole block runs in one kernel (`cuda.iqcorr.iqcorr`; its plain
version on the CPU).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..cuda import iqcorr as iqcorr_kernel

SUBBLOCK = iqcorr_kernel.SUBBLOCK


class IqCorrState(NamedTuple):
    teta1: torch.Tensor     # (C,) smoothed accumulators
    teta2: torch.Tensor
    teta3: torch.Tensor
    c1: torch.Tensor
    c2: torch.Tensor
    twinpeak: torch.Tensor  # (C,) bool suspicion flag


def init_state(batch_shape, device=None) -> IqCorrState:
    bs = tuple(batch_shape)

    def z():
        return torch.zeros(bs, dtype=torch.float32, device=device)

    return IqCorrState(teta1=z(), teta2=z(), teta3=z(), c1=z(),
                       c2=torch.ones(bs, dtype=torch.float32, device=device),
                       twinpeak=torch.zeros(bs, dtype=torch.bool,
                                            device=device))


def correct(state: IqCorrState, i: torch.Tensor, q: torch.Tensor):
    """i, q: (C, T) int16 (full scale 32768) or f32 planes, T % 32 == 0.
    Returns (i_out, q_out, new_state): f32 planes at full scale 1."""
    T = i.shape[-1]
    if T < SUBBLOCK or T % SUBBLOCK:
        raise ValueError(f"IQ correction: block length {T} is not a "
                         f"positive multiple of {SUBBLOCK}")
    i_c, q_c, t1, t2, t3, c1, c2, twin = iqcorr_kernel.iqcorr(
        state.teta1.contiguous(), state.teta2.contiguous(),
        state.teta3.contiguous(), i.contiguous(), q.contiguous())
    return i_c, q_c, IqCorrState(t1, t2, t3, c1, c2, twin)
