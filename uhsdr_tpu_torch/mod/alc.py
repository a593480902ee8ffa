"""TX voice compressor / look-ahead ALC (KA7OEI design).

The torch counterpart of `uhsdr_tpu.mod.alc`.  Reference:
`TxProcessor_VoiceCompressor` (`tx_processor.c:173-245`) with constants
`audio_driver.h:403-406`: ALC_VAL_MAX=1, ALC_VAL_MIN=0.001,
ALC_ATTACK=0.1, ALC_KNEE=30000.  Per sample:

    alc_var = |x * alc_val|/KNEE - 1
    alc_var < 0:  alc_val -= alc_val * decay  * alc_var    (slow gain-up)
    else:         alc_val -= alc_val * ATTACK * alc_var    (fast gain-down)
    clip alc_val to [MIN, MAX]

The gain is applied to audio *delayed* by a fixed number of samples so
the attack leads the audio (click-free).  The whole stage (the post-filter
gain, the recurrence, the gain scaling, the delayed product and the new
delay line) is the fused ALC kernel, `uhsdr_tpu_torch.cuda.alc.alc_run`
(its plain version on the CPU).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cuda import alc as alc_kernel


class AlcParams(NamedTuple):
    decay: float            # per-sample decay coefficient (f32 value)
    delay: int              # look-ahead delay in samples
    postfilt_gain: float    # f32 value
    gain_scaling: float     # f32 value


def make_params(decay: float = 0.02, delay: int = 64,
                postfilt_gain: float = 4.0,
                gain_scaling: float = 1.0) -> AlcParams:
    def f32(v):
        return float(np.float32(v))

    return AlcParams(f32(decay), int(delay), f32(postfilt_gain / 2.0 + 0.5),
                     f32(gain_scaling))


def params_from_numpy(p) -> AlcParams:
    """The reference's AlcParams (NumPy scalars) -> the port's."""
    return AlcParams(float(np.float32(p.decay)), int(p.delay),
                     float(np.float32(p.postfilt_gain)),
                     float(np.float32(p.gain_scaling)))


class AlcState(NamedTuple):
    alc_val: torch.Tensor    # (C,)
    delay_buf: torch.Tensor  # (C, delay)


def init_state(batch_shape, params: AlcParams, device=None) -> AlcState:
    bs = tuple(batch_shape)
    return AlcState(
        alc_val=torch.ones(bs, dtype=torch.float32, device=device),
        delay_buf=torch.zeros(bs + (params.delay,), dtype=torch.float32,
                              device=device))


def run(params: AlcParams, state: AlcState, x: torch.Tensor):
    """x: (C, T) audio.  Returns (y, new_state); the new delay line holds
    its own (C, delay) storage."""
    y, alc_val, delay_buf = alc_kernel.alc_run(
        params, state.alc_val, state.delay_buf.contiguous(), x.contiguous())
    return y, AlcState(alc_val=alc_val, delay_buf=delay_buf)
