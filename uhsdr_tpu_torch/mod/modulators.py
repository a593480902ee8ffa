"""TX modulators: SSB (phasing), AM (dual sideband + carrier), FM (phase
accumulator), CW carrier shaping.  The torch counterpart of
`uhsdr_tpu.mod.modulators`.

Reference: `tx_processor.c` —
  * SSB `TxProcessor_SSB:467-491`: 201-tap TX Hilbert pair (I/Q swapped for
    LSB) then FreqShift.  Here: one complex analytic FIR; LSB = conjugate.
  * AM `TxProcessor_AM:734-810`: Hilbert pair then in-place both-sideband +
    carrier: i = (I-Q) + 2C, q = (Q-I) - 2C with C = AM_CARRIER_LEVEL,
    then FreqShift.  Note q = -i: the pre-shift signal is a real DSB
    waveform duplicated with opposite signs.
  * FM `TxProcessor_FM:534-600`: one-pole pre-emphasis differentiator
    (alpha 0.05), optional subaudible-tone / tone-burst add, then a 16-bit
    integer phase accumulator stepping by (carrier word + scaled audio),
    sin table for I, +90 deg for Q.
  * CW: a keyed envelope on a tone at the translate + sidetone offset.

The analytic FIR, with the SSB modulator's conjugation and frequency
shift fused, runs in the K8 kernel (`uhsdr_tpu_torch.cuda.fir.fir_real`;
its plain version on the CPU), as the reference runs it in
`fir_real_analytic_pallas` off the CPU.  The reference-table FM
modulator (the firmware's sequential pre-emphasis, its truncating
accumulator and the 10-bit DDS grid) is one launch of the helper kernel
`cuda.fm_mod.fm_mod`; the legacy one (a blocked one-pole and an integer
cumulative sum) is torch, as the reference leaves it to XLA.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import data as refdata
from ..cuda import fir as fir_kernels
from ..cuda import fm_mod as fm_kernels
from ..ops import design, iir, nco

IQ_RATE = 48000.0
TX_TAPS = 201                    # filters.h / audio_filter.c:1239-1249
# Reference AM_CARRIER_LEVEL is 5100 DAC units against ~30000 full-scale
# audio (audio_driver.h:429); in the normalized +/-1.0 audio domain of the
# legacy front the equivalent relative carrier is ~0.5.
AM_CARRIER_LEVEL = 0.5

FM_TX_HPF_ALPHA = 0.05
# The reference's FM_MOD_SCALING=16 assumes +/-30000-unit (DAC-scale)
# audio; the legacy front's audio is normalized +/-1.0, so the domain
# ratio is folded into the accumulator scaling (16 * 30000).
FM_MOD_SCALING_2K5 = 16.0 * 30000.0
FM_MOD_ACC_BITS = 16
FM_SUBAUDIBLE_SCALE = 0.00045
FM_MOD_AMPLITUDE_SCALING = 0.875


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


class FmModParams(NamedTuple):
    freq_word: int          # carrier shift accumulator step (16-bit domain)
    mod_scale: float        # audio -> accumulator step scaling (f32 value)
    subtone_delta: int | None   # uint32 DDS for the subaudible tone
    subtone_scale: float    # f32 value
    swap_iq: bool           # negative translate
    table_quant: bool = False   # the ref front's 10-bit DDS grid
    #                             (tx_processor.c:585-588): the kernel


def fm_mod_params(translate_hz: float = 6000.0, dev_5khz: bool = False,
                  subtone_hz: float = 0.0,
                  count_domain: bool = False) -> FmModParams:
    """count_domain: audio arrives in int16-count units (the ref-front
    chain scales to the firmware's domain), so the accumulator step is
    the bare FM_MOD_SCALING=16 (tx_processor.c:498) and the phase is
    quantized to the DDS table grid (the reference's
    mod/modulators.py:212-230)."""
    mult = 2.0 if dev_5khz else 1.0
    word = int(((1 << FM_MOD_ACC_BITS) * abs(translate_hz)) // IQ_RATE)
    sub = (int(nco.freq_to_delta(subtone_hz, IQ_RATE)) if subtone_hz > 0
           else None)
    scale = 16.0 if count_domain else FM_MOD_SCALING_2K5
    return FmModParams(word, float(np.float32(scale * mult)), sub,
                       float(np.float32(FM_SUBAUDIBLE_SCALE * mult)),
                       translate_hz < 0, table_quant=count_domain)


def fm_params_from_numpy(p) -> FmModParams:
    """The reference's FmModParams (NumPy leaves) -> the port's."""
    sub = None if p.subtone_delta is None else int(
        np.asarray(p.subtone_delta))
    return FmModParams(int(p.freq_word), float(np.float32(p.mod_scale)), sub,
                       float(np.float32(p.subtone_scale)), bool(p.swap_iq),
                       bool(p.table_quant))


class FmModState(NamedTuple):
    hpf_a: torch.Tensor     # (C,) f32 pre-emphasis input history
    hpf_b: torch.Tensor     # (C,) f32 pre-emphasis output
    accum: torch.Tensor     # (C,) int32 16-bit phase accumulator
    sub_phase: torch.Tensor  # (C,) int64 in [0, 2^32)


def fm_mod_init(batch_shape, device=None) -> FmModState:
    bs = tuple(batch_shape)
    return FmModState(
        hpf_a=torch.zeros(bs, dtype=torch.float32, device=device),
        hpf_b=torch.zeros(bs, dtype=torch.float32, device=device),
        accum=torch.zeros(bs, dtype=torch.int32, device=device),
        sub_phase=torch.zeros(bs, dtype=torch.int64, device=device))


def fm_modulate(params: FmModParams, state: FmModState, audio: torch.Tensor):
    """audio (C, T) f32 -> (iq (C, T) complex64, new_state).  Table mode:
    one `cuda.fm_mod.fm_mod` launch (the subaudible tone, when set, comes
    in as a plane made here).  Legacy mode: the blocked one-pole
    pre-emphasis and the integer accumulator as an exact cumulative sum of
    rounded steps, the phase at full resolution."""
    T = audio.shape[-1]
    sub_phase, sub = state.sub_phase, None
    if params.subtone_delta is not None:
        tone_blk, sub_phase = nco.tone(state.sub_phase, params.subtone_delta,
                                       T)
        sub = tone_blk * params.subtone_scale
    if params.table_quant:
        i, q, a, b, acc = fm_kernels.fm_mod(
            audio.contiguous(), sub, state.hpf_a, state.hpf_b, state.accum,
            FM_TX_HPF_ALPHA, float(params.freq_word), params.mod_scale,
            FM_MOD_AMPLITUDE_SCALING, params.swap_iq)
        return torch.complex(i, q), FmModState(a, b, acc, sub_phase)
    # 6 dB/oct pre-emphasis: b[n] = alpha*(b[n-1] + a[n] - a[n-1])
    a_d = torch.cat([state.hpf_a[..., None], audio[..., :-1]], dim=-1)
    pre, hpf_b = iir.one_pole_block(FM_TX_HPF_ALPHA, FM_TX_HPF_ALPHA,
                                    state.hpf_b, audio - a_d)
    if sub is not None:
        pre = pre + sub
    mask = (1 << FM_MOD_ACC_BITS) - 1
    steps = params.freq_word + torch.round(pre * params.mod_scale).to(
        torch.int64)
    acc = state.accum.to(torch.int64)[..., None] + torch.cumsum(steps, -1)
    ph = (acc & mask).to(torch.float32) * float(
        np.float32(2.0 * np.pi / (1 << FM_MOD_ACC_BITS)))
    i_s, q_s = torch.cos(ph), torch.sin(ph)
    if params.swap_iq:
        i_s, q_s = q_s, i_s
    iq = torch.complex(i_s * FM_MOD_AMPLITUDE_SCALING,
                       q_s * FM_MOD_AMPLITUDE_SCALING)
    return iq, FmModState(hpf_a=audio[..., -1].contiguous(), hpf_b=hpf_b,
                          accum=(acc[..., -1] & mask).to(torch.int32),
                          sub_phase=sub_phase)


# --- FM tone burst (repeater access) ---------------------------------------
# Reference: `tx_processor.c:519,561-563` adds a NON-pre-emphasized burst
# tone at ~2/3 system modulation while active (suppressing the subaudible
# tone); frequencies 1750 / 2135 Hz (`audio_management.c:328`).
FM_TONE_BURST_FREQS = (0.0, 1750.0, 2135.0)
FM_TONE_BURST_SCALE = float(np.float32(1.0 / 4266.0))   # of FM_MOD_SCALING


def fm_tone_burst(phase0: torch.Tensor, mode: int, n: int,
                  fs: float = IQ_RATE):
    """`n` samples of the tone burst for `mode` (0 off, 1 1750 Hz, 2 2135
    Hz).  Returns (audio_addend, new_phase); the addend goes onto the FM
    modulator's post-pre-emphasis audio while the burst is keyed."""
    freq = FM_TONE_BURST_FREQS[mode]
    if freq == 0.0:
        return torch.zeros(phase0.shape + (n,), dtype=torch.float32,
                           device=phase0.device), phase0
    tone_blk, new_phase = nco.tone(phase0, int(nco.freq_to_delta(freq, fs)),
                                   n)
    return tone_blk * FM_TONE_BURST_SCALE * 4266.0, new_phase
