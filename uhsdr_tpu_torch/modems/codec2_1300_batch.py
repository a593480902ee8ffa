"""Batched Codec2 1300 decoder — C channels per call, state in arrays.

`codec2_1300.Codec2Decoder1300` decodes one 52-bit frame per call in
scalar NumPy at ~4.7 ms/frame — 0.12x real time, capping a FreeDV fleet
at ~8 channels per host core (VERDICT r4 #3).  This module re-implements
the SAME decode pipeline (codec2.c:1249-1360 and helpers — see
codec2_1300.py's docstring for the reference map) vectorized over a
leading channel axis:

  * every piece of decoder state is a (C, ...) array (prev LSPs/Wo/E/
    voicing, excitation phase, background estimate, overlap-add memory,
    PRNG state);
  * the variable harmonic count L (10..80, per channel per subframe) is
    handled by computing all harmonics up to MAX and masking;
  * the reference's `codec2_rand` LCG is consumed with per-channel
    data-dependent counts (unvoiced phases draw L values, the voiced
    postfilter draws one per replaced harmonic) — reproduced EXACTLY
    with an LCG jump table (a^k, b_k mod 2^64) so channel c's k-th draw
    this subframe equals the scalar decoder's k-th sequential draw;
  * harmonic band energies use per-channel cumulative sums (float64;
    the summation-order difference vs the scalar loop is ~1e-15
    relative — tests bound the stream-level match at >=60 dB and the
    compiled-reference golden bound is unchanged).

`decode_frames(bits (C, 52), ber_est (C,)) -> (C, 320) int16` is the
whole 40 ms frame for every channel in one call.

A copy of the JAX package's NumPy module of the same name (the port
imports nothing of that package): the same arrays and decisions,
its data read from the port's own `data` package.
"""
from __future__ import annotations

import numpy as np

from . import codec2_1300 as c2

C2 = c2
LPC_ORD = c2.LPC_ORD
N_SAMP = c2.N_SAMP
FFT_ENC = c2.FFT_ENC
FFT_DEC = c2.FFT_DEC
MAX_AMP = c2.MAX_AMP
L_MAX = 80
WO_MIN = c2.WO_MIN
PI_C = c2.PI_C

_LCG_A = 1103515245
_LCG_C = 12345
_MASK64 = (1 << 64) - 1


def _lcg_jump_tables(kmax: int):
    """(A_k, B_k) uint64 tables, k = 0..kmax: state after k LCG steps is
    A_k*s + B_k mod 2^64."""
    A = np.empty(kmax + 1, np.uint64)
    B = np.empty(kmax + 1, np.uint64)
    a, b = 1, 0
    for k in range(kmax + 1):
        A[k] = a
        B[k] = b
        a2 = (a * _LCG_A) & _MASK64
        b2 = (b * _LCG_A + _LCG_C) & _MASK64
        a, b = a2, b2
    return A, B


_JA, _JB = _lcg_jump_tables(2 * L_MAX + 4)


def _lcg_draws(state: np.ndarray, kmax: int):
    """draws[c, k] = the (k+1)-th codec2_rand value from state[c]
    (k = 0..kmax-1), plus the jump tables for advancing."""
    s = state[:, None]
    with np.errstate(over="ignore"):
        nxt = _JA[None, 1:kmax + 1] * s + _JB[None, 1:kmax + 1]
    return ((nxt >> np.uint64(16)) % np.uint64(32768)).astype(np.float64)


def _lcg_advance(state: np.ndarray, counts: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        return _JA[counts] * state + _JB[counts]


def _gray_to_binary(f: np.ndarray) -> np.ndarray:
    t = f ^ (f >> 8)
    t ^= t >> 4
    t ^= t >> 2
    t ^= t >> 1
    return t


def _unpack_fields(bits: np.ndarray):
    """(C, 52) -> voiced (C, 4), wo_idx (C,), e_idx (C,),
    lsp_idx (C, 10) — MSB-first Gray fields (pack.c)."""
    _, cb_bits = c2._lsp_codebooks()
    widths = [1, 1, 1, 1, c2.WO_BITS, c2.E_BITS] + cb_bits
    pos = 0
    fields = []
    b = bits.astype(np.int64)
    for w in widths:
        weights = (1 << np.arange(w - 1, -1, -1)).astype(np.int64)
        raw = b[:, pos:pos + w] @ weights
        fields.append(_gray_to_binary(raw))
        pos += w
    voiced = np.stack(fields[:4], axis=1)
    return voiced, fields[4], fields[5], np.stack(fields[6:], axis=1)


def _decode_wo_vec(idx: np.ndarray) -> np.ndarray:
    step = np.float32((c2.WO_MAX - c2.WO_MIN) / (1 << c2.WO_BITS))
    return (np.float32(c2.WO_MIN)
            + (step * idx.astype(np.float32)).astype(np.float32)) \
        .astype(np.float32).astype(np.float64)


def _decode_energy_vec(idx: np.ndarray) -> np.ndarray:
    step = (c2.E_MAX_DB - c2.E_MIN_DB) / (1 << c2.E_BITS)
    return 10.0 ** ((c2.E_MIN_DB + step * idx) / 10.0)


def _L_of_vec(Wo: np.ndarray) -> np.ndarray:
    return (PI_C / Wo.astype(np.float32).astype(np.float64)) \
        .astype(np.int64)


def _check_lsp_order_vec(lsp: np.ndarray) -> np.ndarray:
    """Vectorized fast path + exact scalar fallback for the (rare)
    channels whose decoded LSPs are out of order (the C bubble's
    restart-at-1 sequence matters for exactness)."""
    bad = np.any(lsp[:, 1:] < lsp[:, :-1], axis=1)
    if np.any(bad):
        lsp = lsp.copy()
        for ci in np.nonzero(bad)[0]:
            lsp[ci] = c2.check_lsp_order(lsp[ci])
    return lsp


def _bw_expand_vec(lsp: np.ndarray, min_sep_low=50.0,
                   min_sep_high=100.0) -> np.ndarray:
    lsp = lsp.copy()
    r = np.pi / 4000.0
    for i in range(1, 4):
        lim = lsp[:, i - 1] + min_sep_low * r
        lsp[:, i] = np.maximum(lsp[:, i], lim)
    for i in range(4, LPC_ORD):
        lim = lsp[:, i - 1] + min_sep_high * r
        lsp[:, i] = np.maximum(lsp[:, i], lim)
    return lsp


def _lsp_to_lpc_vec(lsp: np.ndarray) -> np.ndarray:
    """lsp.c lsp_to_lpc, all channels at once (static 11x5 loop of
    (C,)-vector ops — identical op order to the scalar cascade)."""
    Cn = lsp.shape[0]
    order = LPC_ORD
    freq = np.cos(lsp)                       # (C, 10)
    Wp = np.zeros((Cn, 4 * (order // 2) + 2))
    ak = np.zeros((Cn, order + 1))
    xin1 = np.ones(Cn)
    xin2 = np.ones(Cn)
    for j in range(order + 1):
        for i in range(order // 2):
            n1 = 4 * i
            xout1 = xin1 - 2.0 * freq[:, 2 * i] * Wp[:, n1] + Wp[:, n1 + 1]
            xout2 = (xin2 - 2.0 * freq[:, 2 * i + 1] * Wp[:, n1 + 2]
                     + Wp[:, n1 + 3])
            Wp[:, n1 + 1] = Wp[:, n1]
            Wp[:, n1 + 3] = Wp[:, n1 + 2]
            Wp[:, n1] = xin1
            Wp[:, n1 + 2] = xin2
            xin1, xin2 = xout1, xout2
        n4 = 4 * (order // 2 - 1) + 3
        xout1 = xin1 + Wp[:, n4 + 1]
        xout2 = xin2 - Wp[:, n4 + 2]
        ak[:, j] = (xout1 + xout2) * 0.5
        Wp[:, n4 + 1] = xin1
        Wp[:, n4 + 2] = xin2
        xin1 = np.zeros(Cn)
        xin2 = np.zeros(Cn)
    return ak


_M_IDX = np.arange(1, L_MAX + 1)             # (L_MAX,) harmonic numbers


def _aks_to_M2_vec(ak: np.ndarray, Wo: np.ndarray, L: np.ndarray,
                   E: np.ndarray):
    """Batched aks_to_M2 + lpc_post_filter + bass boost.  Returns
    (A (C, MAX_AMP+1), Aw (C, FFT_ENC//2+1))."""
    Cn = ak.shape[0]
    a = np.zeros((Cn, FFT_ENC))
    a[:, : LPC_ORD + 1] = ak
    Aw = np.fft.rfft(a, axis=-1)
    Pw = 1.0 / (Aw.real[:, : FFT_ENC // 2] ** 2
                + Aw.imag[:, : FFT_ENC // 2] ** 2 + 1e-6)

    x = np.zeros((Cn, FFT_ENC))
    x[:, 0] = ak[:, 0]
    x[:, 1: LPC_ORD + 1] = ak[:, 1:] * (c2.GAMMA **
                                        np.arange(1, LPC_ORD + 1))
    Ww = np.fft.rfft(x, axis=-1)
    Ww2 = Ww.real[:, : FFT_ENC // 2] ** 2 + Ww.imag[:, : FFT_ENC // 2] ** 2
    Rw = np.sqrt(Ww2 * Pw)
    e_before = 1e-4 + np.sum(Pw, axis=-1)
    Pfw = Rw ** c2.BETA
    Pw = Pw * Pfw * Pfw
    e_after = 1e-4 + np.sum(Pw, axis=-1)
    Pw *= ((e_before / e_after) * E)[:, None]
    Pw[:, : FFT_ENC // 8] *= 1.4 * 1.4

    # harmonic band sums via per-channel cumsum (band edges per channel)
    r = 2.0 * np.pi / FFT_ENC
    am = ((_M_IDX[None, :] - 0.5) * Wo[:, None] / r + 0.5).astype(int)
    bm = ((_M_IDX[None, :] + 0.5) * Wo[:, None] / r + 0.5).astype(int)
    # m > L entries are masked below; clamp them into range (the scalar
    # loop never evaluates them)
    am = np.minimum(am, FFT_ENC // 2)
    bm = np.minimum(bm, FFT_ENC // 2)
    cps = np.concatenate([np.zeros((Cn, 1)), np.cumsum(Pw, axis=-1)],
                         axis=-1)
    rows = np.arange(Cn)[:, None]
    band = cps[rows, bm] - cps[rows, am]
    mask = _M_IDX[None, :] <= L[:, None]
    A = np.zeros((Cn, MAX_AMP + 1))
    A[:, 1: L_MAX + 1] = np.sqrt(np.maximum(band, 0.0)) * mask
    return A, Aw


class Codec2FleetDecoder1300:
    """C-channel batched `Codec2Decoder1300` (state layout above)."""

    def __init__(self, n_channels: int):
        Cn = n_channels
        self.C = Cn
        self.prev_lsps = np.tile(
            np.arange(LPC_ORD) * np.pi / (LPC_ORD + 1), (Cn, 1))
        self.prev_e = np.ones(Cn)
        self.prev_Wo = np.full(Cn, WO_MIN)
        self.prev_voiced = np.zeros(Cn, np.int64)
        self.ex_phase = np.zeros(Cn)
        self.bg_est = np.zeros(Cn)
        self.Sn_ = np.zeros((Cn, 2 * N_SAMP))
        self.rand_state = np.ones(Cn, np.uint64)
        self.Pn = c2.Codec2Decoder1300._synthesis_window()

    def decode_frames(self, bits: np.ndarray,
                      ber_est: np.ndarray | float = 0.0,
                      idx: np.ndarray | None = None) -> np.ndarray:
        """bits (C, 52) uint8; ber_est (C,) or scalar.
        Returns (C, 320) int16.

        idx: optional channel-subset indices — bits/ber then cover only
        those channels (ragged frame arrival across a fleet): state is
        gathered, the subset decoded as a batch, and state scattered
        back; other channels are untouched."""
        if idx is not None:
            idx = np.asarray(idx)
            sub = Codec2FleetDecoder1300.__new__(Codec2FleetDecoder1300)
            sub.C = idx.size
            sub.Pn = self.Pn
            for name in ("prev_lsps", "prev_e", "prev_Wo", "prev_voiced",
                         "ex_phase", "bg_est", "Sn_", "rand_state"):
                setattr(sub, name, getattr(self, name)[idx].copy())
            out = sub.decode_frames(bits, ber_est)
            for name in ("prev_lsps", "prev_e", "prev_Wo", "prev_voiced",
                         "ex_phase", "bg_est", "Sn_", "rand_state"):
                getattr(self, name)[idx] = getattr(sub, name)
            return out
        Cn = self.C
        bits = np.asarray(bits).reshape(Cn, c2.FRAME_BITS)
        ber = np.broadcast_to(np.asarray(ber_est, float), (Cn,))
        voiced4, wo_idx, e_idx, lsp_idx = _unpack_fields(bits)
        Wo3 = _decode_wo_vec(wo_idx)
        e3 = _decode_energy_vec(e_idx)
        cbs, _ = c2._lsp_codebooks()
        lsp_hz = np.stack([cbs[i][lsp_idx[:, i]]
                           for i in range(LPC_ORD)], axis=1)
        lsps3 = _bw_expand_vec(_check_lsp_order_vec(
            (np.pi / 4000.0) * lsp_hz))

        mute = ber > 0.15
        if np.any(mute):
            voiced4 = np.where(mute[:, None], 0, voiced4)
            e3 = np.where(mute, c2.decode_energy(10), e3)
            lsps3 = np.where(mute[:, None],
                             _bw_expand_vec(lsps3, 200.0, 200.0), lsps3)
        L3 = _L_of_vec(Wo3)

        # subframe interpolation (interp.c), vectorized over channels
        sub_lsps, sub_Wo, sub_L, sub_e, sub_v = [], [], [], [], []
        for i in range(3):
            w = 0.25 * (i + 1)
            v = voiced4[:, i].astype(bool)
            # interp_Wo2 voicing trap
            v = v & ~(~self.prev_voiced.astype(bool)
                      & ~voiced4[:, 3].astype(bool))
            both = self.prev_voiced.astype(bool) & voiced4[:, 3].astype(bool)
            interp_wo = ((1.0 - w) * self.prev_Wo + w * Wo3) \
                .astype(np.float32).astype(np.float64)
            Wo = np.where(
                v & both, interp_wo,
                np.where(v & voiced4[:, 3].astype(bool), Wo3,
                         np.where(v & self.prev_voiced.astype(bool),
                                  self.prev_Wo, WO_MIN)))
            Wo = np.where(v, Wo, WO_MIN)
            sub_lsps.append((1.0 - w) * self.prev_lsps + w * lsps3)
            sub_Wo.append(Wo)
            sub_L.append(_L_of_vec(Wo))
            sub_e.append(10.0 ** ((1.0 - w) * np.log10(self.prev_e)
                                  + w * np.log10(e3)))
            sub_v.append(v.astype(np.int64))
        sub_lsps.append(lsps3)
        sub_Wo.append(Wo3)
        sub_L.append(L3)
        sub_e.append(e3)
        sub_v.append(voiced4[:, 3])

        out = np.zeros((Cn, c2.SAMPLES_PER_FRAME), np.int16)
        for i in range(4):
            ak = _lsp_to_lpc_vec(sub_lsps[i])
            A, Aw = _aks_to_M2_vec(ak, sub_Wo[i], sub_L[i], sub_e[i])
            # apply_lpc_correction
            corr = sub_Wo[i] < np.pi * 150.0 / 4000.0
            A[:, 1] = np.where(corr, A[:, 1] * 0.032, A[:, 1])
            out[:, i * N_SAMP:(i + 1) * N_SAMP] = self._synth_subframe(
                sub_Wo[i], sub_L[i], sub_v[i], A, Aw)

        self.prev_lsps = lsps3
        self.prev_e = e3
        self.prev_Wo = Wo3
        self.prev_voiced = voiced4[:, 3].astype(np.int64)
        return out

    def _synth_subframe(self, Wo, L, voiced, A, Aw) -> np.ndarray:
        Cn = self.C
        r = 2.0 * np.pi / FFT_ENC
        rows = np.arange(Cn)[:, None]
        mask = _M_IDX[None, :] <= L[:, None]            # (C, L_MAX)
        b = (_M_IDX[None, :] * Wo[:, None] / r + 0.5).astype(int)
        b = np.minimum(b, FFT_ENC // 2)
        H = np.conj(Aw[rows, b])                        # (C, L_MAX)
        return self._synth_from_H(Wo, L, voiced, A, H, mask)

    def _synth_from_H(self, Wo, L, voiced, A, H, mask,
                      gain: np.ndarray | float = 1.0) -> np.ndarray:
        Cn = self.C
        v = voiced.astype(bool)
        # phase_synth_zero_order
        self.ex_phase = self.ex_phase + Wo * N_SAMP
        self.ex_phase -= 2.0 * np.pi * np.floor(
            self.ex_phase / (2.0 * np.pi) + 0.5)

        draws = _lcg_draws(self.rand_state, L_MAX)      # (C, L_MAX)
        # unvoiced: harmonic m (1-based) consumes draw m-1
        ph_unv = 2.0 * np.pi * draws / c2.CODEC2_RAND_MAX
        Ex = np.where(v[:, None],
                      np.exp(1j * self.ex_phase[:, None] * _M_IDX[None, :]),
                      np.exp(1j * ph_unv))
        A_ = H * Ex
        phi = np.zeros((Cn, L_MAX + 1))
        phi[:, 1:] = np.arctan2(A_.imag, A_.real + 1e-12) * mask
        consumed = np.where(v, 0, L).astype(np.int64)
        self.rand_state = _lcg_advance(self.rand_state, consumed)

        # postfilter (postfilter.c)
        Am = A[:, 1: L_MAX + 1] * mask
        e = 1e-12 + np.sum(Am ** 2, axis=-1)
        e = 10.0 * np.log10(e / np.maximum(L, 1))
        upd = (e < c2.BG_THRESH) & ~v
        self.bg_est = np.where(
            upd, self.bg_est * (1.0 - c2.BG_BETA) + e * c2.BG_BETA,
            self.bg_est)
        thresh = 10.0 ** ((self.bg_est + c2.BG_MARGIN) / 20.0)
        repl = v[:, None] & mask & (Am < thresh[:, None])
        if np.any(repl):
            draws2 = _lcg_draws(self.rand_state, L_MAX)
            # j-th replaced harmonic (in m order) consumes draw j
            j = np.cumsum(repl, axis=-1) - 1
            ph_r = (2.0 * np.pi / c2.CODEC2_RAND_MAX) * \
                np.take_along_axis(draws2, np.maximum(j, 0), axis=-1)
            phi[:, 1:] = np.where(repl, ph_r, phi[:, 1:])
            self.rand_state = _lcg_advance(
                self.rand_state, repl.sum(axis=-1).astype(np.int64))

        # synthesise (sine.c)
        Sw = np.zeros((Cn, FFT_DEC // 2 + 1), np.complex128)
        bdec = (_M_IDX[None, :] * Wo[:, None] * FFT_DEC
                / (2.0 * np.pi) + 0.5).astype(int)
        bdec = np.minimum(bdec, FFT_DEC // 2 - 1)
        vals = A[:, 1: L_MAX + 1] * np.exp(1j * phi[:, 1:]) * mask
        rows = np.arange(Cn)[:, None]
        # ascending-m assignment semantics (later m wins on collision):
        # np fancy assignment applies in index order = m ascending
        Sw[rows, np.where(mask, bdec, 0)] = np.where(mask, vals, 0.0)
        Sw[:, 0] = 0.0
        sw = np.fft.irfft(Sw, FFT_DEC, axis=-1) * FFT_DEC

        Sn_ = self.Sn_
        Sn_[:, : N_SAMP - 1] = Sn_[:, N_SAMP: 2 * N_SAMP - 1]
        Sn_[:, N_SAMP - 1] = 0.0
        Sn_[:, : N_SAMP - 1] += (sw[:, FFT_DEC - N_SAMP + 1:]
                                 * self.Pn[None, : N_SAMP - 1])
        Sn_[:, N_SAMP - 1: 2 * N_SAMP] = (
            sw[:, : N_SAMP + 1] * self.Pn[None, N_SAMP - 1: 2 * N_SAMP])

        frame = Sn_[:, :N_SAMP].copy()
        if not np.all(np.asarray(gain) == 1.0):
            frame *= np.broadcast_to(np.asarray(gain, float),
                                     (Cn,))[:, None]
        mx = frame.max(axis=-1)
        over = mx / 30000.0
        scale = np.where(over > 1.0, 1.0 / (over * over + 1e-30), 1.0)
        frame *= scale[:, None]
        return np.trunc(np.clip(frame, -32767, 32767)).astype(np.int16)
