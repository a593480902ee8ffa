"""TX modulators: SSB (phasing), AM (dual sideband + carrier), CW carrier
shaping.  The torch counterpart of `uhsdr_tpu.mod.modulators`.

Reference: `tx_processor.c` —
  * SSB `TxProcessor_SSB:467-491`: 201-tap TX Hilbert pair (I/Q swapped for
    LSB) then FreqShift.  Here: one complex analytic FIR; LSB = conjugate.
  * AM `TxProcessor_AM:734-810`: Hilbert pair then in-place both-sideband +
    carrier: i = (I-Q) + 2C, q = (Q-I) - 2C with C = AM_CARRIER_LEVEL,
    then FreqShift.  Note q = -i: the pre-shift signal is a real DSB
    waveform duplicated with opposite signs.
  * CW: a keyed envelope on a tone at the translate + sidetone offset.

The analytic FIR, with the SSB modulator's conjugation and frequency
shift fused, runs in the K8 kernel (`uhsdr_tpu_torch.cuda.fir.fir_real`;
its plain version on the CPU), as the reference runs it in
`fir_real_analytic_pallas` off the CPU.  FM (`TxProcessor_FM:534-600`)
is not ported yet: its functions raise NotImplementedError naming the
ROADMAP item.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import data as refdata
from ..cuda import fir as fir_kernels
from ..ops import design, nco

IQ_RATE = 48000.0
TX_TAPS = 201                    # filters.h / audio_filter.c:1239-1249
# Reference AM_CARRIER_LEVEL is 5100 DAC units against ~30000 full-scale
# audio (audio_driver.h:429); in the normalized +/-1.0 audio domain of the
# legacy front the equivalent relative carrier is ~0.5.
AM_CARRIER_LEVEL = 0.5

_ROADMAP_FM = ("FM TX: ROADMAP.md queue A item 8 (fm_modulate's "
               "pre-emphasis and phase-accumulator recurrences and the "
               "serial voice lattice, ops/lattice.py::iir_lattice_block)")


class SsbModParams(NamedTuple):
    fir: torch.Tensor       # (TX_TAPS,) complex64 analytic filter
    nco_delta: int          # uint32
    lsb: bool               # conjugate before the shift


def _fir(re, im, device=None) -> torch.Tensor:
    """f32 real and imaginary taps -> a complex64 tensor on `device`."""
    h = np.asarray(re, np.float32) + 1j * np.asarray(im, np.float32)
    return torch.as_tensor(h.astype(np.complex64), device=device)


def _params(h: np.ndarray, translate_hz: float, lsb: bool,
            device=None) -> SsbModParams:
    return SsbModParams(_fir(h.real, h.imag, device),
                        int(nco.freq_to_delta(translate_hz, IQ_RATE)),
                        bool(lsb))


def ssb_params(f_lo: float = 150.0, f_hi: float = 2850.0,
               translate_hz: float = 6000.0, lsb: bool = False,
               device=None) -> SsbModParams:
    """The legacy redesigned analytic filter (front="scipy")."""
    h = design.complex_bandpass_fir(TX_TAPS, f_lo, f_hi, IQ_RATE)
    return _params(h, translate_hz, lsb, device)


def _tx_hilbert_pair():
    return (refdata.fir("iq_tx_wide_i").astype(np.float32),
            refdata.fir("iq_tx_wide_q").astype(np.float32))


def ssb_params_ref(translate_hz: float = 6000.0, lsb: bool = False,
                   device=None) -> SsbModParams:
    """The firmware's 201-tap TX Hilbert pair (filters/iq_tx_filter.c
    iq_tx_wide) as the analytic filter, in the capture convention of the
    reference (mod/modulators.py:71-89): the mcHF's TX mixer flips the
    spectrum between the DAC and the antenna, applied here as a
    conjugation of the pair: usb -> h_i - j h_q, lsb -> h_q - j h_i."""
    h_i, h_q = _tx_hilbert_pair()
    re, im = (h_q, -h_i) if lsb else (h_i, -h_q)
    return _params(re + 1j * im, translate_hz, False, device)


def params_from_numpy(p, device=None):
    """The reference's SsbModParams or AmModParams (NumPy leaves) -> the
    port's."""
    fir = _fir(p.fir_re, p.fir_im, device)
    delta = int(np.asarray(p.nco_delta))
    if hasattr(p, "carrier_level"):
        return AmModParams(fir, delta, float(p.carrier_level))
    return SsbModParams(fir, delta, bool(p.lsb))


class SsbModState(NamedTuple):
    carry: torch.Tensor     # (C, taps-1) f32 audio history
    phase: torch.Tensor     # (C,) int64 in [0, 2^32)


def ssb_init(batch_shape, device=None) -> SsbModState:
    bs = tuple(batch_shape)
    return SsbModState(
        carry=torch.zeros(bs + (TX_TAPS - 1,), dtype=torch.float32,
                          device=device),
        phase=torch.zeros(bs, dtype=torch.int64, device=device))


def ssb_modulate(params: SsbModParams, state: SsbModState,
                 audio: torch.Tensor):
    """audio (C, T) f32 -> (iq (C, T) complex64, new_state): the analytic
    FIR, the LSB conjugation and the frequency shift in one K8 launch."""
    z, carry = fir_kernels.fir_real(
        params.fir, state.carry, audio.contiguous(),
        nco=(state.phase, params.nco_delta), conj=params.lsb)
    phase = nco.advance(state.phase, params.nco_delta, audio.shape[-1])
    return z, SsbModState(carry=carry, phase=phase)


class AmModParams(NamedTuple):
    fir: torch.Tensor       # (TX_TAPS,) complex64 analytic filter
    nco_delta: int
    carrier_level: float


def am_params(translate_hz: float = 6000.0,
              carrier_level: float = AM_CARRIER_LEVEL,
              device=None) -> AmModParams:
    """The legacy redesigned filter and the unit-domain carrier."""
    h = design.complex_bandpass_fir(TX_TAPS, 150.0, 2850.0, IQ_RATE)
    p = _params(h, translate_hz, False, device)
    return AmModParams(p.fir, p.nco_delta, float(carrier_level))


def am_params_ref(translate_hz: float = 6000.0, device=None) -> AmModParams:
    """Reference AM: TX Hilbert pair + AM_CARRIER_LEVEL=5100 DAC counts
    (audio_driver.h:429) on count-domain audio (the ref front)."""
    h_i, h_q = _tx_hilbert_pair()
    p = _params(h_i + 1j * h_q, translate_hz, False, device)
    return AmModParams(p.fir, p.nco_delta, 5100.0)


def am_init(batch_shape, device=None) -> SsbModState:
    return ssb_init(batch_shape, device)


def am_modulate(params: AmModParams, state: SsbModState,
                audio: torch.Tensor):
    """audio (C, T) f32 -> (iq (C, T) complex64, new_state): the analytic
    FIR (K8, no shift), the carrier and the sideband fold, then the
    frequency shift."""
    z, carry = fir_kernels.fir_real(params.fir, state.carry,
                                    audio.contiguous())
    s = (z.real - z.imag) + 2.0 * params.carrier_level
    iq, phase = nco.mix(torch.complex(s, -s), state.phase, params.nco_delta)
    return iq, SsbModState(carry=carry, phase=phase)


def cw_carrier(envelope: torch.Tensor, phase0: torch.Tensor, delta):
    """envelope (C, T) in [0, 1] -> keyed IQ carrier at the sidetone/offset
    frequency (reference: CW TX at the translate offset,
    tx_processor.c:856-889).  Returns (iq, new_phase)."""
    osc, phase = nco.tone_iq(phase0, delta, envelope.shape[-1])
    return envelope * osc, phase


def fm_mod_params(*args, **kwargs):
    raise NotImplementedError(_ROADMAP_FM)


def fm_modulate(*args, **kwargs):
    raise NotImplementedError(_ROADMAP_FM)


def fm_tone_burst(*args, **kwargs):
    raise NotImplementedError(_ROADMAP_FM)
