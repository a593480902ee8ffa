"""Codec2 700C vocoder — the reference 700D radio mode's speech codec.

CODEC2_MODE_700C (the reference firmware's `mchf-eclipse/drivers/freedv/
freedv_api.c:218`, dispatch `codec2.c:321-322`) encodes 40 ms of
speech into 28 bits with the "newamp1" amplitude model (`newamp1.c`):

  analyse_one_frame x4 (sinusoidal model: Wo, {Am}, voicing — shared
  with 1300, see codec2_1300.py) -> resample the harmonic amplitude
  envelope from variable rate L to fixed rate K=20 on a mel frequency
  grid (`resample_const_rate_f`) -> remove mean -> two-stage K=20 VQ,
  512 entries/stage, mbest depth-5 search (`rate_K_mbest_encode`,
  codebooks imported as data: uhsdr_tpu_torch/data/newamp1_cb.npz from
  `codebooknewamp1.c`) -> scalar-quantise the mean (16-level,
  `codebooknewamp1_energy.c`) and log-Wo (6 bits, index 0 stolen to
  signal unvoiced) -> pack 9+9+4+6 natural binary (no gray).

Decode (`codec2_decode_700c` codec2.c:2024, `newamp1_indexes_to_model`
newamp1.c:536): codebook sum -> `post_filter_newamp1` (formant raise,
pf_gain 1.5, energy-normalised) -> +mean -> linear 25->100 Hz
interpolation of the rate-K surface and Wo/voicing (`interp_Wo_v`) ->
resample back to rate L (`resample_rate_L`) -> minimum-phase harmonic
phases via a 128-pt cepstral lift (`determine_phase`/`mag_to_phase`,
phase.c) -> the shared sinusoidal synthesiser (phase_synth_zero_order,
postfilter, overlap-add `synthesise`, audio gain 1.5, ear protection —
codec2_1300.synth_from_H).

Like the 1300 implementation, discrete state (L per subframe, PRNG
consumption order) is replicated exactly so the waveform tracks the
compiled reference decoder (tests/test_codec2_golden.py bounds it).

A copy of the JAX package's NumPy module of the same name (the port
imports nothing of that package): the same arrays and decisions,
its data read from the port's own `data` package.
"""
from __future__ import annotations

import numpy as np

from .. import data
from .codec2_1300 import (
    FS, N_SAMP, MAX_AMP, FFT_ENC, WO_MIN, WO_MAX,
    Codec2Decoder1300, Codec2Encoder1300, _BitUnpacker, _f32,
)

K = 20                    # NEWAMP1_K (newamp1.h:35)
PHASE_NFFT = 128          # NEWAMP1_PHASE_NFFT (newamp1.h:34)
MBEST_DEPTH = 5           # NEWAMP1_VQ_MBEST_DEPTH (newamp1.c:43)
BITS_PER_FRAME = 28       # 9 + 9 + 4 + 6
WO_UV = float(np.float32(2.0 * np.pi / 100.0))   # unvoiced placeholder Wo


def ftomel(f_hz: float) -> float:
    """newamp1.c:96 (note the floorf snap to integer mel)."""
    return float(np.floor(np.float32(
        2595.0 * np.log10(1.0 + f_hz / 700.0) + 0.5)))


def mel_sample_freqs_khz(k: int = K) -> np.ndarray:
    """newamp1.c:101 mel_sample_freqs_kHz over [ftomel(200), ftomel(3700)]."""
    mel_start, mel_end = ftomel(200.0), ftomel(3700.0)
    mel = mel_start + (mel_end - mel_start) / (k - 1) * np.arange(k)
    return 0.7 * (10.0 ** (mel / 2595.0) - 1.0)


RATE_K_FREQS_KHZ = mel_sample_freqs_khz()


def interp_para(xp: np.ndarray, yp: np.ndarray, x: np.ndarray) -> np.ndarray:
    """newamp1.c:57 second-order parabolic interpolator.  The segment
    index advances while xp[k+1] < x (strict), clamped to np-3 — for
    ascending x this equals counting abscissae xp[1:] strictly below x."""
    xp = np.asarray(xp, np.float64)
    yp = np.asarray(yp, np.float64)
    x = np.asarray(x, np.float64)
    k = np.clip(np.searchsorted(xp[1:], x, side="left"), 0, len(xp) - 3)
    x1, y1 = xp[k], yp[k]
    x2, y2 = xp[k + 1], yp[k + 1]
    x3, y3 = xp[k + 2], yp[k + 2]
    a = ((y3 - y2) / (x3 - x2) - (y2 - y1) / (x2 - x1)) / (x3 - x1)
    b = ((y3 - y2) / (x3 - x2) * (x2 - x1)
         + (y2 - y1) / (x2 - x1) * (x3 - x2)) / (x3 - x1)
    return a * (x - x2) ** 2 + b * (x - x2) + y2


def post_filter_newamp1(vec: np.ndarray, pf_gain: float = 1.5) -> np.ndarray:
    """newamp1.c:237 — pre-emphasise 20 dB/dec over 300 Hz, scale in the
    log domain (raises formants / suppresses anti-formants), normalise
    energy, de-emphasise."""
    pre = 20.0 * np.log10(RATE_K_FREQS_KHZ / 0.3)
    v = vec + pre
    e_before = np.sum(10.0 ** (v / 10.0))
    v = v * pf_gain
    e_after = np.sum(10.0 ** (v / 10.0))
    gain_db = 10.0 * np.log10(e_after / e_before)
    return v - gain_db - pre


def decode_log_Wo(index: int, bits: int = 6) -> float:
    """quantise.c decode_log_Wo (float32 arithmetic)."""
    w0 = _f32(np.log10(np.float32(WO_MIN)))
    w1 = _f32(np.log10(np.float32(WO_MAX)))
    step = _f32((w1 - w0) / (1 << bits))
    return _f32(10.0 ** np.float32(_f32(w0 + step * index)))


def encode_log_Wo(Wo: float, bits: int = 6) -> int:
    """quantise.c encode_log_Wo."""
    w0 = _f32(np.log10(np.float32(WO_MIN)))
    w1 = _f32(np.log10(np.float32(WO_MAX)))
    norm = (_f32(np.log10(np.float32(Wo))) - w0) / (w1 - w0)
    index = int(np.floor((1 << bits) * norm + 0.5))
    return int(np.clip(index, 0, (1 << bits) - 1))


def interp_Wo_v(Wo1: float, Wo2: float, v1: int, v2: int):
    """newamp1.c:280 — 25 Hz -> 100 Hz Wo/voicing interpolation.
    Returns (Wo[4], L[4], voicing[4]); Wo values are float32 like the
    reference MODEL fields, L = floor(pi / Wo) on the f32 value."""
    M = 4
    Wo_ = np.full(M, WO_UV)
    v_ = np.zeros(M, int)
    if v1 and not v2:
        Wo_[0] = Wo_[1] = _f32(Wo1)
        v_[0] = v_[1] = 1
    elif not v1 and v2:
        Wo_[2] = Wo_[3] = _f32(Wo2)
        v_[2] = v_[3] = 1
    elif v1 and v2:
        c = 1.0 - np.arange(M) / M
        Wo_ = np.array([_f32(Wo1 * ci + Wo2 * (1.0 - ci)) for ci in c])
        v_[:] = 1
    # floorf(M_PI/Wo): the double quotient converts to float32 before
    # the floor (can round up across an integer boundary)
    L_ = np.floor((np.pi / Wo_).astype(np.float32)).astype(int)
    return Wo_, L_, v_


def resample_rate_L(Wo: float, L: int, rate_K_vec: np.ndarray) -> np.ndarray:
    """newamp1.c:329 — rate-K envelope back to the L harmonics of Wo.
    Returns A[0..MAX_AMP] with A[m] for m=1..L."""
    xp = np.concatenate([[0.0], RATE_K_FREQS_KHZ, [4.0]])
    yp = np.concatenate([[0.0], rate_K_vec, [0.0]])
    m = np.arange(1, L + 1)
    rate_L_freqs = m * Wo * (FS / 2000.0) / np.pi
    AmdB = interp_para(xp, yp, rate_L_freqs)
    A = np.zeros(MAX_AMP + 1)
    A[1:L + 1] = 10.0 ** (AmdB / 20.0)
    return A


def mag_to_phase(Gdbfk: np.ndarray, nfft: int = PHASE_NFFT) -> np.ndarray:
    """phase.c mag_to_phase: minimum-phase response from an amplitude
    spectrum via the folded real cepstrum.  Gdbfk: (nfft/2+1,) dB."""
    ns = nfft // 2 + 1
    Sdb = np.zeros(nfft)
    Sdb[:ns] = Gdbfk
    Sdb[ns:] = Gdbfk[ns - 2:0:-1]           # negative freqs
    c = np.fft.ifft(Sdb)                     # kiss inverse / Nfft
    cf = np.zeros(nfft, complex)
    cf[0] = c[0]
    cf[1:ns - 1] = c[1:ns - 1] + c[nfft - 1:ns - 1:-1]
    cf[ns - 1] = c[ns - 1]
    Cf = np.fft.fft(cf)
    scale = 20.0 / np.log(10.0)
    return Cf[:ns].imag / scale


def determine_phase(Wo: float, L: int, A: np.ndarray) -> np.ndarray:
    """newamp1.c:371 — harmonic phases H[m-1], m=1..L, sampled from the
    minimum-phase response of the interpolated magnitude envelope."""
    ns = PHASE_NFFT // 2 + 1
    m = np.arange(1, L + 1)
    AmdB = 20.0 * np.log10(A[1:L + 1])
    rate_L_freqs = m * Wo * (FS / 2000.0) / np.pi
    sample_freqs = (FS / 1000.0) * np.arange(ns) / PHASE_NFFT
    Gdbfk = interp_para(rate_L_freqs, AmdB, sample_freqs)
    phase = mag_to_phase(Gdbfk)
    b = np.floor(0.5 + m * Wo * PHASE_NFFT / (2.0 * np.pi)).astype(int)
    return np.exp(1j * phase[b])


class Codec2Decoder700C(Codec2Decoder1300):
    """Stateful 700C frame decoder: 28 bits / 40 ms -> 320 samples @8 k,
    tracking codec2_decode_700c (shares the sinusoidal synthesis state —
    PRNG, ex_phase, bg_est, overlap-add — with the 1300 base)."""

    def __init__(self):
        super().__init__()
        cb = data.newamp1_codebooks()
        self._vq1 = np.asarray(cb["vq1"])
        self._vq2 = np.asarray(cb["vq2"])
        self._energy_cb = np.asarray(cb["energy"])
        # codec2_create newamp1 init (codec2.c:258-266)
        self.prev_rate_K_vec = np.zeros(K)
        self.Wo_left = 0.0
        self.voicing_left = 0

    def decode_frame(self, bits28: np.ndarray,
                     ber_est: float = 0.0) -> np.ndarray:
        del ber_est   # 700C has no soft-mute branch (decode, not _ber)
        up = _BitUnpacker(np.asarray(bits28, np.uint8))
        idx = [up.take(9, gray=False), up.take(9, gray=False),
               up.take(4, gray=False), up.take(6, gray=False)]

        # newamp1_indexes_to_rate_K_vec
        no_mean = self._vq1[idx[0]] + self._vq2[idx[1]]
        no_mean = post_filter_newamp1(no_mean, 1.5)
        mean = float(self._energy_cb[idx[2]])
        rate_K_vec = no_mean + mean

        if idx[3]:
            Wo_right, voicing_right = decode_log_Wo(idx[3]), 1
        else:
            Wo_right, voicing_right = WO_UV, 0

        # 25 Hz -> 100 Hz interpolation of the amplitude surface
        c = 1.0 - np.arange(4)[:, None] / 4.0
        surface = self.prev_rate_K_vec[None, :] * c \
            + rate_K_vec[None, :] * (1.0 - c)
        Wo_, L_, v_ = interp_Wo_v(self.Wo_left, Wo_right,
                                  self.voicing_left, voicing_right)

        out = np.zeros(4 * N_SAMP, np.int16)
        for i in range(4):
            A = resample_rate_L(Wo_[i], L_[i], surface[i])
            H = determine_phase(Wo_[i], L_[i], A)
            out[i * N_SAMP:(i + 1) * N_SAMP] = self.synth_from_H(
                float(Wo_[i]), int(L_[i]), int(v_[i]), A, H, gain=1.5)

        self.prev_rate_K_vec = rate_K_vec
        self.Wo_left = Wo_right
        self.voicing_left = voicing_right
        return out


def resample_const_rate_f(Wo: float, L: int, A: np.ndarray) -> np.ndarray:
    """newamp1.c:125 — harmonic amplitudes to the fixed rate-K mel grid,
    clipped to a 50 dB dynamic range below the peak."""
    m = np.arange(1, L + 1)
    AmdB = 20.0 * np.log10(A[1:L + 1] + 1e-16)
    AmdB = np.maximum(AmdB, AmdB.max() - 50.0)
    rate_L_freqs = m * Wo * (FS / 2000.0) / np.pi
    return interp_para(rate_L_freqs, AmdB, RATE_K_FREQS_KHZ)


def rate_K_mbest_encode(x: np.ndarray, vq1: np.ndarray,
                        vq2: np.ndarray) -> tuple[int, int]:
    """newamp1.c:164 two-stage mbest (depth 5) VQ search."""
    e1 = np.sum((x[None, :] - vq1) ** 2, axis=1)
    top = np.argsort(e1, kind="stable")[:MBEST_DEPTH]
    # stage 2: total error is ||x - cb1[n1] - cb2[n2]||^2 (the mbest
    # target is the stage-1 residual), candidates scanned in C order
    resid = x[None, :] - vq1[top]                       # (5, K)
    e2 = np.sum((resid[:, None, :] - vq2[None, :, :]) ** 2, axis=2)
    j, n2 = np.unravel_index(np.argmin(e2), e2.shape)
    return int(top[j]), int(n2)


class Codec2Encoder700C(Codec2Encoder1300):
    """700C frame encoder: 320 samples -> (28,) bits (newamp1 encoder,
    codec2.c:1977 + newamp1_model_to_indexes newamp1.c:409).  Reuses the
    1300 analysis pipeline (NLP pitch, harmonic amplitudes, MBE
    voicing)."""

    def __init__(self):
        super().__init__()
        cb = data.newamp1_codebooks()
        self._vq1 = np.asarray(cb["vq1"])
        self._vq2 = np.asarray(cb["vq2"])
        self._energy_cb = np.asarray(cb["energy"])

    def encode_frame(self, speech320: np.ndarray) -> np.ndarray:
        speech320 = np.asarray(speech320, np.float64).reshape(4, N_SAMP)
        for i in range(4):
            Wo, L, A, voiced = self._analyse_one_frame(speech320[i])
        # newamp1_model_to_indexes on the LAST subframe's model
        rate_K_vec = resample_const_rate_f(Wo, L, A)
        mean = float(np.sum(rate_K_vec) / K)
        n1, n2 = rate_K_mbest_encode(rate_K_vec - mean,
                                     self._vq1, self._vq2)
        e_idx = int(np.argmin((self._energy_cb - mean) ** 2))
        if voiced:
            w_idx = encode_log_Wo(Wo) or 1      # index 0 is "unvoiced"
        else:
            w_idx = 0

        bits = []
        for value, width in ((n1, 9), (n2, 9), (e_idx, 4), (w_idx, 6)):
            for b in range(width - 1, -1, -1):   # natural binary, no gray
                bits.append((int(value) >> b) & 1)
        return np.array(bits, np.uint8)
