"""RX audio output stage — the torch counterpart of
`uhsdr_tpu.chain.output`, the tail of `AudioDriver_RxProcessor`
(`audio_driver.c:2845-2941`): AF gain scaling, mute, keyboard-beep tone
injection (`softdds_addSingleTone`), and saturating conversion to the
output sample range.

Elementwise torch on the chain's device (the JAX package leaves it to
XLA, with no Pallas kernel).  Mute and beep gate are runtime inputs (a
bool, or a per-channel tensor), not configuration, as the reference's
`ads.af_disabled` / `ads.beep_active` flip between blocks without a
chain rebuild.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import nco

IQ_RATE = 48000.0


class OutputParams(NamedTuple):
    gain: float               # f32 value: linear AF gain (incl. 1/full_scale)
    beep_delta: int           # uint32 NCO increment for the beep tone
    beep_level: float         # f32 value: additive beep amplitude


class OutputState(NamedTuple):
    beep_phase: torch.Tensor  # (...,) int64 in [0, 2^32)


def make_params(af_gain: int = 16, beep_freq_hz: float = 1000.0,
                beep_volume: int = 10, fs: float = IQ_RATE,
                input_full_scale: float = 32768.0) -> OutputParams:
    """af_gain 0..30 and beep_volume 0..20 (the registry ranges); the
    volume law value^2 normalized to 1.0 at the default.  input_full_scale
    is the audio sample value mapped to output 1.0: the RX chain's audio
    sits at the firmware's int16 scale (the AGC's out_target 4096 of
    +-32768), so the default mirrors the reference's float->int16
    saturating cast; pass 1.0 for unit-scale audio."""
    g = (float(af_gain) / 16.0) ** 2 / float(input_full_scale)
    beep = 0.1 * (float(beep_volume) / 10.0) ** 2
    return OutputParams(gain=float(np.float32(g)),
                        beep_delta=int(nco.freq_to_delta(beep_freq_hz, fs)),
                        beep_level=float(np.float32(beep)))


def params_from_numpy(p) -> OutputParams:
    """The reference's OutputParams (NumPy leaves) -> the port's."""
    return OutputParams(float(np.float32(p.gain)),
                        int(np.asarray(p.beep_delta)),
                        float(np.float32(p.beep_level)))


def init_state(batch_shape, device=None) -> OutputState:
    return OutputState(beep_phase=torch.zeros(
        tuple(batch_shape), dtype=torch.int64, device=device))


def _gate(v, audio: torch.Tensor) -> torch.Tensor | float:
    """A bool, or a per-channel (...,) tensor broadcast over time."""
    if isinstance(v, torch.Tensor) and v.ndim:
        return v.to(device=audio.device, dtype=torch.float32)[..., None]
    return float(v)


def output_block(params: OutputParams, state: OutputState,
                 audio: torch.Tensor, mute=False, beep=False):
    """audio: (..., T) f32.  mute/beep: a bool, or (...,) bool/f32 tensors
    gating per channel.  Returns (audio_out clipped to [-1, 1],
    new_state)."""
    T = audio.shape[-1]
    y = audio * params.gain
    y = y * (1.0 - _gate(mute, audio))
    tone_blk, new_phase = nco.tone(state.beep_phase, params.beep_delta, T)
    y = y + tone_blk * params.beep_level * _gate(beep, audio)
    # the saturating output conversion (the reference's float->int16 clamp)
    return torch.clamp(y, -1.0, 1.0), OutputState(beep_phase=new_phase)
