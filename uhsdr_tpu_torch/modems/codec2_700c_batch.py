"""Batched Codec2 700C decoder — C channels per call (the 700D analog
of `codec2_1300_batch`; VERDICT r4 #3's "codec2 frame loop" for the
OTHER FreeDV mode).

`codec2_700c.Codec2Decoder700C` decodes one 28-bit frame per call and
is ~74% of the per-channel 700D RX cost.  This module vectorizes the
whole decode path over a leading channel axis — natural-binary unpack,
two-stage VQ lookup, newamp1 post filter, 25->100 Hz Wo/voicing and
amplitude-surface interpolation, batched parabolic interpolation
(`interp_para` with per-channel abscissae via masked counting), the
128-pt cepstral minimum-phase lift, and the shared batched sinusoidal
synthesiser (`codec2_1300_batch.Codec2FleetDecoder1300._synth_from_H`,
PRNG jump tables included) — with per-channel state in arrays.
Subset decode (`idx=`) supports ragged frame arrival across a fleet.

A copy of the JAX package's NumPy module of the same name (the port
imports nothing of that package): the same arrays and decisions,
its data read from the port's own `data` package.
"""
from __future__ import annotations

import numpy as np

from . import codec2_700c as c7
from .codec2_1300_batch import Codec2FleetDecoder1300, L_MAX, _M_IDX
from .. import data

K = c7.K
PHASE_NFFT = c7.PHASE_NFFT
N_SAMP = c7.N_SAMP
MAX_AMP = c7.MAX_AMP
FS = c7.FS
WO_UV = c7.WO_UV


def _f32a(x):
    return np.asarray(x, np.float32).astype(np.float64)


def _interp_para_vec(xp: np.ndarray, yp: np.ndarray, x: np.ndarray,
                     valid: np.ndarray | None = None) -> np.ndarray:
    """Batched `interp_para`: xp/yp (C, P) per-channel abscissae (only
    the first n_c entries meaningful when `valid` (C,) is given — the
    rest must be +inf in xp), x (C, Q) query points.  Matches the
    scalar's segment rule: k = clip(#(xp[1:] strictly < x), 0, P_c-3)."""
    Cn, P = xp.shape
    # count of xp[c, 1:] strictly below x[c, q]
    cnt = np.sum(xp[:, None, 1:] < x[:, :, None], axis=-1)
    hi = (valid - 3)[:, None] if valid is not None else P - 3
    k = np.clip(cnt, 0, np.maximum(hi, 0))
    rows = np.arange(Cn)[:, None]
    x1, y1 = xp[rows, k], yp[rows, k]
    x2, y2 = xp[rows, k + 1], yp[rows, k + 1]
    x3, y3 = xp[rows, k + 2], yp[rows, k + 2]
    a = ((y3 - y2) / (x3 - x2) - (y2 - y1) / (x2 - x1)) / (x3 - x1)
    b = ((y3 - y2) / (x3 - x2) * (x2 - x1)
         + (y2 - y1) / (x2 - x1) * (x3 - x2)) / (x3 - x1)
    return a * (x - x2) ** 2 + b * (x - x2) + y2


def _post_filter_vec(vec: np.ndarray, pf_gain: float = 1.5) -> np.ndarray:
    pre = 20.0 * np.log10(c7.RATE_K_FREQS_KHZ / 0.3)
    v = vec + pre
    e_before = np.sum(10.0 ** (v / 10.0), axis=-1)
    v = v * pf_gain
    e_after = np.sum(10.0 ** (v / 10.0), axis=-1)
    gain_db = 10.0 * np.log10(e_after / e_before)
    return v - gain_db[:, None] - pre


def _decode_log_wo_vec(index: np.ndarray) -> np.ndarray:
    """Matches `decode_log_Wo` op-for-op: the exponent sum runs in
    float64 and is THEN cast to f32, the power runs in float64 on the
    f32 exponent, and the result is cast to f32 (tiny Wo rounding
    differences accumulate in ex_phase over frames, so op order
    matters)."""
    w0 = c7._f32(np.log10(np.float32(c7.WO_MIN)))
    w1 = c7._f32(np.log10(np.float32(c7.WO_MAX)))
    step = c7._f32((w1 - w0) / 64)
    e = (w0 + step * index.astype(np.float64)).astype(np.float32)
    return (10.0 ** e.astype(np.float64)).astype(np.float32) \
        .astype(np.float64)


class Codec2FleetDecoder700C(Codec2FleetDecoder1300):
    """C-channel batched `Codec2Decoder700C` (28 bits/frame/channel)."""

    def __init__(self, n_channels: int):
        super().__init__(n_channels)
        cb = data.newamp1_codebooks()
        self._vq1 = np.asarray(cb["vq1"])
        self._vq2 = np.asarray(cb["vq2"])
        self._energy_cb = np.asarray(cb["energy"])
        self.prev_rate_K_vec = np.zeros((n_channels, K))
        self.Wo_left = np.zeros(n_channels)
        self.voicing_left = np.zeros(n_channels, np.int64)

    _SUB_STATE = ("prev_lsps", "prev_e", "prev_Wo", "prev_voiced",
                  "ex_phase", "bg_est", "Sn_", "rand_state",
                  "prev_rate_K_vec", "Wo_left", "voicing_left")

    def decode_frames(self, bits: np.ndarray,
                      ber_est: np.ndarray | float = 0.0,
                      idx: np.ndarray | None = None) -> np.ndarray:
        """bits (C, 28) uint8 -> (C, 320) int16.  idx: channel subset."""
        if idx is not None:
            idx = np.asarray(idx)
            sub = Codec2FleetDecoder700C.__new__(Codec2FleetDecoder700C)
            sub.C = idx.size
            sub.Pn = self.Pn
            for n in ("_vq1", "_vq2", "_energy_cb"):
                setattr(sub, n, getattr(self, n))
            for n in self._SUB_STATE:
                setattr(sub, n, getattr(self, n)[idx].copy())
            out = sub.decode_frames(bits)
            for n in self._SUB_STATE:
                getattr(self, n)[idx] = getattr(sub, n)
            return out
        del ber_est   # 700C has no soft-mute branch
        Cn = self.C
        b = np.asarray(bits, np.int64).reshape(Cn, c7.BITS_PER_FRAME)
        widths = (9, 9, 4, 6)
        pos, fields = 0, []
        for w in widths:                     # natural binary, no gray
            weights = (1 << np.arange(w - 1, -1, -1)).astype(np.int64)
            fields.append(b[:, pos:pos + w] @ weights)
            pos += w
        i0, i1, i2, i3 = fields

        no_mean = self._vq1[i0] + self._vq2[i1]          # (C, K)
        no_mean = _post_filter_vec(no_mean, 1.5)
        rate_K_vec = no_mean + self._energy_cb[i2][:, None]

        voiced_r = i3 > 0
        Wo_right = np.where(voiced_r, _decode_log_wo_vec(i3), WO_UV)

        # 25 -> 100 Hz amplitude surface (C, 4, K)
        c = 1.0 - np.arange(4)[None, :, None] / 4.0
        surface = (self.prev_rate_K_vec[:, None, :] * c
                   + rate_K_vec[:, None, :] * (1.0 - c))

        # interp_Wo_v, vectorized (newamp1.c:280)
        v1 = self.voicing_left.astype(bool)
        v2 = voiced_r
        Wo_ = np.full((Cn, 4), WO_UV)
        v_ = np.zeros((Cn, 4), np.int64)
        m1 = v1 & ~v2                        # left voiced only
        Wo_[m1, :2] = _f32a(self.Wo_left[m1])[:, None]
        v_[m1, :2] = 1
        m2 = ~v1 & v2                        # right voiced only
        Wo_[m2, 2:] = _f32a(Wo_right[m2])[:, None]
        v_[m2, 2:] = 1
        m3 = v1 & v2                         # both: linear blend
        if np.any(m3):
            cc = 1.0 - np.arange(4) / 4.0
            blend = (self.Wo_left[m3][:, None] * cc[None, :]
                     + Wo_right[m3][:, None] * (1.0 - cc)[None, :])
            Wo_[m3] = _f32a(blend)
            v_[m3] = 1
        L_ = np.floor((np.pi / Wo_).astype(np.float32)).astype(np.int64)

        out = np.zeros((Cn, 4 * N_SAMP), np.int16)
        xp_fixed = np.concatenate([[0.0], c7.RATE_K_FREQS_KHZ, [4.0]])
        ns = PHASE_NFFT // 2 + 1
        sample_freqs = (FS / 1000.0) * np.arange(ns) / PHASE_NFFT
        for i in range(4):
            Wo, L, v = Wo_[:, i], L_[:, i], v_[:, i]
            mask = _M_IDX[None, :] <= L[:, None]          # (C, L_MAX)
            rate_L_freqs = _M_IDX[None, :] * Wo[:, None] * (FS / 2000.0) \
                / np.pi
            # resample_rate_L: fixed abscissae, per-channel queries
            xp = np.broadcast_to(xp_fixed, (Cn, K + 2))
            yp = np.concatenate([np.zeros((Cn, 1)), surface[:, i],
                                 np.zeros((Cn, 1))], axis=-1)
            AmdB = _interp_para_vec(xp, yp,
                                    np.where(mask, rate_L_freqs, 0.0))
            A = np.zeros((Cn, MAX_AMP + 1))
            A[:, 1:L_MAX + 1] = np.where(mask, 10.0 ** (AmdB / 20.0), 0.0)

            # determine_phase: per-channel abscissae (masked +inf),
            # fixed queries
            AmdB_h = 20.0 * np.log10(np.maximum(A[:, 1:L_MAX + 1], 1e-99))
            xp_h = np.where(mask, rate_L_freqs, np.inf)
            Gdbfk = _interp_para_vec(
                xp_h, np.where(mask, AmdB_h, 0.0),
                np.broadcast_to(sample_freqs, (Cn, ns)), valid=L)
            # mag_to_phase, batched (phase.c)
            Sdb = np.zeros((Cn, PHASE_NFFT))
            Sdb[:, :ns] = Gdbfk
            Sdb[:, ns:] = Gdbfk[:, ns - 2:0:-1]
            cep = np.fft.ifft(Sdb, axis=-1)
            cf = np.zeros((Cn, PHASE_NFFT), complex)
            cf[:, 0] = cep[:, 0]
            cf[:, 1:ns - 1] = (cep[:, 1:ns - 1]
                               + cep[:, PHASE_NFFT - 1:ns - 1:-1])
            cf[:, ns - 1] = cep[:, ns - 1]
            Cf = np.fft.fft(cf, axis=-1)
            phase = Cf[:, :ns].imag / (20.0 / np.log(10.0))
            bidx = np.floor(0.5 + _M_IDX[None, :] * Wo[:, None]
                            * PHASE_NFFT / (2.0 * np.pi)).astype(int)
            bidx = np.clip(bidx, 0, ns - 1)
            rows = np.arange(Cn)[:, None]
            H = np.exp(1j * phase[rows, bidx])            # (C, L_MAX)
            out[:, i * N_SAMP:(i + 1) * N_SAMP] = self._synth_from_H(
                Wo, L, v, A, H, mask, gain=1.5)

        self.prev_rate_K_vec = rate_K_vec
        self.Wo_left = Wo_right.astype(float)
        self.voicing_left = voiced_r.astype(np.int64)
        return out
