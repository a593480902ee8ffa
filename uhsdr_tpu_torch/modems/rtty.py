"""RTTY modem (45.45/50 Bd Baudot FSK).

The counterpart of `uhsdr_tpu.modems.rtty` (reference
`drivers/audio/rtty.c`): RX (`Rtty_Demodulator_ProcessSample:634`,
`RttyDecoder_demodulator:466`) is two band-pass biquads (mark 915 Hz,
space 915 + shift), squared magnitudes, the optional fldigi ATC
(decayavg envelopes and noise-floor clipping), a ~50 Hz low-pass, a
comparator, the DPLL bit sync (`RttyDecoder_getBitDPLL:558`, +-1/32 bit
nudges) and the 5 x 1.5 async frame, giving Baudot codes.  The whole
demodulator is one launch of the hand-written kernel `kernels/rtty.cu`
on the card (`cuda/rtty.py`), its plain version on the CPU; codes to
text runs on the host (`modems/rtty_text.py::BaudotDecoder`).  TX
(`Rtty_Modulator_GenSample:806`) keys one phase-continuous accumulator
between the two tones: an int64 cumsum of the per-sample deltas, masked
to 32 bits (rtty.py:264-274 of the JAX package).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy import signal as sps

from ..chain.rx import resolve_device
from ..cuda import rtty as rtty_k
from ..ops import nco

MARK_FREQ = 915.0
SHIFTS = (85.0, 170.0, 200.0, 425.0, 450.0, 850.0)
SPEEDS = (45.45, 50.0)


def _bandpass_biquad(f0: float, fs: float, q: float = 20.0) -> np.ndarray:
    b, a = sps.iirpeak(f0, q, fs=fs)
    return np.concatenate([b, a[1:]]).astype(np.float32)


def _lowpass_biquad(fc: float, fs: float) -> np.ndarray:
    z, p, k = sps.butter(2, fc / (fs / 2), btype="low", output="zpk")
    sos = sps.zpk2sos(z, p, k)[0]
    return np.concatenate([sos[:3], sos[4:]]).astype(np.float32)


class RttyParams(NamedTuple):
    fs: float
    baud: float
    shift: float
    one_bit: int             # samples per bit
    mark_bp: np.ndarray      # (5,) biquad
    space_bp: np.ndarray
    lpf: np.ndarray
    atc: bool
    stopbits: float          # 1.5 or 2


def make_params(fs: float = 12000.0, baud: float = 45.45,
                shift: float = 170.0, atc: bool = True,
                stopbits: float = 1.5) -> RttyParams:
    return RttyParams(
        fs=fs, baud=baud, shift=shift,
        one_bit=int(round(fs / baud)),
        mark_bp=_bandpass_biquad(MARK_FREQ, fs),
        space_bp=_bandpass_biquad(MARK_FREQ + shift, fs),
        lpf=_lowpass_biquad(50.0, fs),
        atc=atc, stopbits=stopbits)


RttyRxState = rtty_k.RttyLeaves


def init_state(batch_shape, device=None) -> RttyRxState:
    """Zero state on `device` (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    bs = tuple(batch_shape)

    def z(shape=()):
        return torch.zeros(bs + shape, dtype=torch.float32, device=dev)
    return RttyRxState(z((2,)), z((2,)), z((2,)), z((4,)),
                       *(z() for _ in rtty_k.DPLL_LEAVES))


def max_bytes(params: RttyParams, T: int) -> int:
    """The code slots a block of T samples returns."""
    return rtty_k.max_bytes(T, params.fs, params.baud)


def demodulate(params: RttyParams, state: RttyRxState, audio: torch.Tensor):
    """audio (C, T) f32 at 12 kHz -> (codes (C, max_bytes) int32 in
    arrival order, -1 = none; nbytes (C,) int32; new_state), on audio's
    device.  The codes are raw 5-bit Baudot."""
    return rtty_k.rtty(params.mark_bp, params.space_bp, params.lpf,
                       params.one_bit, params.atc,
                       max_bytes(params, audio.shape[-1]), state, audio)


def modulate(params: RttyParams, phase0: torch.Tensor, bits: torch.Tensor):
    """bits: (C, T) bool (True = mark) at the sample rate
    (`rtty_text.codes_to_bits`).  Returns (audio (C, T) f32, new_phase):
    one uint32 accumulator whose per-sample delta switches between the
    tones, the sine taken of the JAX package's f32 angle."""
    d_mark = int(nco.freq_to_delta(MARK_FREQ, params.fs))
    d_space = int(nco.freq_to_delta(MARK_FREQ + params.shift, params.fs))
    deltas = torch.where(bits, d_mark, d_space).to(torch.int64)
    acc = (phase0[..., None] + torch.cumsum(deltas, dim=-1)) & nco.MASK32
    return torch.sin(nco.angle_f32(acc)), acc[..., -1]


def state_to_numpy(state: RttyRxState) -> dict:
    """The JAX package's RttyRxState layout as NumPy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def state_from_numpy(s, device=None) -> RttyRxState:
    """A RttyRxState (or its dict, JAX or NumPy leaves) on `device`."""
    dev = resolve_device(device)
    s = s._asdict() if hasattr(s, "_asdict") else s
    return RttyRxState(**{k: torch.from_numpy(np.array(
        s[k], np.float32)).to(dev) for k in RttyRxState._fields})
