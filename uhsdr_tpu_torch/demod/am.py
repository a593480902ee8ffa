"""AM envelope demodulation with the WDSP fade leveler.

The torch counterpart of `uhsdr_tpu.demod.am`.  Reference:
`AudioDriver_DemodSAM`'s DEMOD_AM branch (`audio_driver.c:2011-2024`):
envelope ``sqrt(I^2+Q^2)`` per sample, then the fade leveler
(`AudioDriver_FadeLeveler`, `audio_driver.c:1911-1923`):

    dc        = mtauR*dc + (1-mtauR)*audio        (tauR = 0.02 s)
    dc_insert = mtauI*dc_insert + (1-mtauI)*corr  (tauI = 1.4 s)
    out       = audio + dc_insert - dc

Both smoothers are linear one-poles and run as `ops.iir.one_pole_block`.
For plain AM the reference passes corr = 0, so dc_insert only decays and
the fade leveler is a slow DC tracker and subtractor.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import iir


class FadeLevelerParams(NamedTuple):
    mtauR: float   # f32 value of exp(-1/(fs*0.02))
    mtauI: float   # f32 value of exp(-1/(fs*1.4))


def fade_leveler_params(fs: float) -> FadeLevelerParams:
    return FadeLevelerParams(
        mtauR=float(np.float32(np.exp(-1.0 / (fs * 0.02)))),
        mtauI=float(np.float32(np.exp(-1.0 / (fs * 1.4)))))


class FadeLevelerState(NamedTuple):
    dc: torch.Tensor         # (...,)
    dc_insert: torch.Tensor  # (...,)


def fade_leveler_init(batch_shape, device=None) -> FadeLevelerState:
    z = torch.zeros(tuple(batch_shape), dtype=torch.float32, device=device)
    return FadeLevelerState(dc=z, dc_insert=z.clone())


def fade_leveler(params: FadeLevelerParams, state: FadeLevelerState,
                 audio: torch.Tensor, corr: torch.Tensor | None):
    """corr=None is a structurally zero corr input (plain AM): dc_insert
    then has the closed form dci[n] = mtauI^(n+1) * dci0, powers taken in
    float64 and rounded to f32, with no filtering pass."""
    dc, dc_last = iir.one_pole_block(params.mtauR, 1.0 - params.mtauR,
                                     state.dc, audio)
    if corr is None:
        decay = iir.decay_table(params.mtauI, audio.shape[-1],
                                str(audio.device))
        dci = state.dc_insert[..., None] * decay
        dci_last = dci[..., -1]
    else:
        dci, dci_last = iir.one_pole_block(params.mtauI, 1.0 - params.mtauI,
                                           state.dc_insert, corr)
    out = audio + dci - dc
    return out, FadeLevelerState(dc=dc_last, dc_insert=dci_last)


def demod(iq: torch.Tensor, params: FadeLevelerParams,
          state: FadeLevelerState, fade_leveler_on: bool = True):
    """iq: (..., T) complex at the decimated rate -> (audio, new_state)."""
    env = iq.abs()
    if fade_leveler_on:
        return fade_leveler(params, state, env, None)
    return env, state
