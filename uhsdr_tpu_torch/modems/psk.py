"""BPSK modem (PSK31/63/125).

The counterpart of `uhsdr_tpu.modems.psk` (reference
`drivers/audio/psk.c`): RX (`Psk_Demodulator_ProcessSample:606`) is a
band-pass biquad around the 500 Hz audio offset, a product detector
against a 500 Hz NCO, a moving average over one carrier period
(PSK_BUF_LEN = 12000/500 = 24), a symbol every `rate` samples
(384/192/96 for 31.25/62.5/125 Bd) and a differential decision (a sign
flip is 0); the reference's timing correction is disabled (`psk.c:661`),
so the symbol clock is strictly periodic.  The demodulator is one launch
of the hand-written kernel `kernels/psk.cu` on the card (`cuda/psk.py`),
its plain version on the CPU; bits to text runs on the host
(`modems/psk_text.py::VaricodeDecoder`).  TX is elementwise torch: the
sign and envelope planes (from `psk_text.bits_to_waveform_params`) times
the carrier's sine, taken of the JAX package's f32 angle.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy import signal as sps

from ..chain.rx import resolve_device
from ..cuda import psk as psk_k
from ..ops import nco

PSK_OFFSET = 500.0
RATES = {31: 384, 63: 192, 125: 96}   # samples per symbol @12 kHz


def _bandpass(fs: float, baud: float) -> np.ndarray:
    bw = max(baud, 31.25)
    z, p, k = sps.butter(1, [(PSK_OFFSET - bw) / (fs / 2),
                             (PSK_OFFSET + bw) / (fs / 2)],
                         btype="band", output="zpk")
    sos = sps.zpk2sos(z, p, k)[0]
    return np.concatenate([sos[:3], sos[4:]]).astype(np.float32)


class PskParams(NamedTuple):
    fs: float
    speed: int              # 31 | 63 | 125
    rate: int               # samples per symbol
    buf_len: int            # carrier period in samples
    bpf: np.ndarray


def make_params(fs: float = 12000.0, speed: int = 31) -> PskParams:
    return PskParams(fs=fs, speed=speed, rate=RATES[speed],
                     buf_len=int(fs / PSK_OFFSET),
                     bpf=_bandpass(fs, {31: 31.25, 63: 62.5,
                                        125: 125.0}[speed]))


class PskRxState(NamedTuple):
    bpf_bq: torch.Tensor      # (C, 2) f32
    nco_phase: torch.Tensor   # (C,) int64 in [0, 2^32)
    prod_tail: torch.Tensor   # (C, buf_len - 1) f32 sin-product history
    sample_offset: torch.Tensor  # (C,) int32 position within the symbol
    last_symbol: torch.Tensor    # (C,) f32
    last_bit: torch.Tensor       # (C,) int32


def init_state(batch_shape, params: PskParams, device=None) -> PskRxState:
    """Zero state on `device` (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    bs = tuple(batch_shape)
    f32 = dict(dtype=torch.float32, device=dev)
    return PskRxState(
        bpf_bq=torch.zeros(bs + (2,), **f32),
        nco_phase=torch.zeros(bs, dtype=torch.int64, device=dev),
        prod_tail=torch.zeros(bs + (params.buf_len - 1,), **f32),
        sample_offset=torch.zeros(bs, dtype=torch.int32, device=dev),
        last_symbol=torch.zeros(bs, **f32),
        last_bit=torch.ones(bs, dtype=torch.int32, device=dev))


def _delta(params: PskParams) -> int:
    return int(nco.freq_to_delta(PSK_OFFSET, params.fs))


def demodulate(params: PskParams, state: PskRxState, audio: torch.Tensor):
    """audio (C, T) f32 at 12 kHz, T a positive multiple of the rate.
    Returns (bits (C, T // rate) int32, new_state), on audio's device."""
    if audio.shape[-1] % params.rate:
        raise ValueError(f"psk: block of {audio.shape[-1]} samples, not a "
                         f"multiple of {params.rate}")
    leaves = psk_k.PskLeaves(state.bpf_bq, state.nco_phase, state.prod_tail,
                             state.last_symbol, state.last_bit)
    bits, new = psk_k.psk(params.bpf, _delta(params), params.rate, leaves,
                          audio)
    return bits, PskRxState(new.bq, new.phase, new.tail, state.sample_offset,
                            new.last_symbol, new.last_bit)


def modulate(params: PskParams, phase0: torch.Tensor, signs: torch.Tensor,
             envelope: torch.Tensor):
    """signs/envelope: (C, T) per-sample carrier sign (+-1) and amplitude
    envelope (`psk_text.bits_to_waveform_params`).  Audio = sign * env *
    sin(2 pi f0 t), phase-continuous, the angle in f32 as the JAX
    package's (psk.py:121-130).  Returns (audio, new_phase)."""
    T = signs.shape[-1]
    delta = _delta(params)
    ph = nco.angle_f32(nco.phase_ramp(phase0, delta, T))
    return signs * envelope * torch.sin(ph), nco.advance(phase0, delta, T)


def state_to_numpy(state: PskRxState) -> dict:
    """The JAX package's PskRxState layout as NumPy arrays (the phase as
    uint32)."""
    out = {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}
    out["nco_phase"] = out["nco_phase"].astype(np.uint32)
    return out


def state_from_numpy(s, device=None) -> PskRxState:
    """A PskRxState (or its dict, JAX or NumPy leaves) on `device`."""
    dev = resolve_device(device)
    s = s._asdict() if hasattr(s, "_asdict") else s
    dts = {"nco_phase": np.int64, "sample_offset": np.int32,
           "last_bit": np.int32}
    return PskRxState(**{k: torch.from_numpy(np.array(
        np.asarray(s[k]).astype(dts.get(k, np.float32)))).to(dev)
        for k in PskRxState._fields})
