"""LPC impulse noise blanker ("alternate noise blanking").

The torch counterpart of `uhsdr_tpu.nr.blanker`.  Reference:
`alt_noise_blanking` (`audio_nr.c:2210-2536`), per 128-sample frame at
the decimated rate: the order-10 autocorrelation of the frame,
Levinson-Durbin, whitening and matched filtering with the prediction-
error filter, a threshold of ``(16 - nb_setting) * 0.5 * sqrt(var * P)``,
up to 5 impulses a frame (above the threshold and the largest within
+-3 samples), each repaired over 7 samples by a cross-fade of the
forward and backward order-10 predictions.  The firmware's 154-sample
working buffer is a carried 26-sample context, so the output is delayed
13 samples and repairs may straddle frames and blocks.  The whole block
is one kernel (`cuda.blanker.blanker`; its plain version on the CPU).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cuda import blanker as blanker_kernel

FRAME = blanker_kernel.FRAME
CONTEXT = blanker_kernel.CONTEXT
DELAY = blanker_kernel.DELAY


class NbParams(NamedTuple):
    threshold_mult: float   # (16 - nb_setting) * 0.5, an f32 value


def make_params(nb_setting: int = 8) -> NbParams:
    """nb_setting 0..15 (larger = more aggressive), the reference's
    `ts.dsp.nb_setting` (`audio_nr.c:2434`)."""
    return NbParams(float(np.float32((16 - nb_setting) * 0.5)))


def params_from_numpy(p) -> NbParams:
    return NbParams(float(np.float32(p.threshold_mult)))


class NbState(NamedTuple):
    context: torch.Tensor   # (..., CONTEXT) repaired tail of the last frame


def init_state(batch_shape, device=None) -> NbState:
    return NbState(context=torch.zeros(tuple(batch_shape) + (CONTEXT,),
                                       dtype=torch.float32, device=device))


def process_block(params: NbParams, state: NbState, x: torch.Tensor):
    """x: (..., T) with T % 128 == 0.  Returns (y, new_state); the output
    is delayed DELAY (13) samples, as the reference's."""
    T = x.shape[-1]
    if T % FRAME:
        raise ValueError(f"blanker: block length {T} is not a multiple "
                         f"of {FRAME}")
    lead = x.shape[:-1]
    y, ctx = blanker_kernel.blanker(
        params.threshold_mult,
        state.context.reshape(-1, CONTEXT).contiguous(),
        x.reshape(-1, T).contiguous())
    return y.reshape(x.shape), NbState(ctx.reshape(lead + (CONTEXT,)))
