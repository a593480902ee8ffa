"""Codec2 CODEC2_MODE_1300 — the vocoder inside FreeDV 1600.

Bit-interoperable re-implementation of the reference's decode path
(`drivers/freedv/codec2.c:1249-1360` `codec2_decode_1300` and the helpers
it calls in quantise.c / interp.c / lsp.c / phase.c / postfilter.c /
sine.c), operating on the SAME 52-bit frames the firmware transmits:

  4 x voicing (1 bit)                       [0:4]
  Wo index (7 bits, linear quantiser)       [4:11]   decode_Wo
  energy index (5 bits, -10..40 dB log)     [11:16]  decode_energy
  10 scalar-quantised LSPs (36 bits)        [16:52]  decode_lsps_scalar

All fields are Gray-coded MSB-first (`pack.c unpack_natural_or_gray`).
The LSP quantiser codebooks are the reference's own tables, imported as
data (`tools/parse_codec2_codebooks.py` -> data/codec2_cb.npz).

Decode pipeline per 40 ms frame (4 x 10 ms subframes):
  unpack -> dequantise Wo/E/LSP -> interpolate 3 intermediate subframes
  (`interp.c`: linear LSPs, voicing-gated Wo, log-domain energy) ->
  LSP->LPC (`lsp.c:lsp_to_lpc` cascade recursion) -> LPC spectrum ->
  per-harmonic amplitudes with the LPC post filter + bass boost
  (`quantise.c:aks_to_M2`/`lpc_post_filter`, beta .2 gamma .5) ->
  zero-order phase synthesis with the reference's own LCG PRNG for
  unvoiced phases (`phase.c`, `sine.c codec2_rand`) -> background-noise
  postfilter (`postfilter.c`) -> frequency-domain sinusoidal synthesis
  with trapezoidal overlap-add (`sine.c synthesise`) -> ear protection.

The PRNG sequence and consumption order are replicated exactly, so the
decoder's unvoiced excitation phase matches the reference's.  The
waveform is reference-close, not bit-exact: the float32 evaluation
order differs, so tests/test_codec2_golden.py bounds the match at
>=25 dB overall / >=10 dB per-segment vs the compiled reference
(measured ~37 dB overall, 63 dB median segmental).

A copy of the JAX package's NumPy module of the same name (the port
imports nothing of that package): the same arrays and decisions,
its data read from the port's own `data` package.
"""
from __future__ import annotations

import numpy as np

from .. import data

# defines.h / quantise.h / sine.c c2const_create (Fs=8000, N_S=0.01)
FS = 8000
N_SAMP = 80              # 10 ms subframe
M_PITCH = 320
FFT_ENC = 512
FFT_DEC = 512
LPC_ORD = 10
MAX_AMP = 160
P_MIN, P_MAX = 20, 160
# the reference's PI/TWO_PI macros (defines.h:43-45) are truncated
# decimals, and C2CONST stores Wo_min/max as float32 — model->L = PI/Wo
# truncates differently than exact math (PI/Wo_min = 79.999998 -> 79!),
# and every L feeds the PRNG consumption count, so these roundings are
# replicated exactly
PI_C = 3.141592654
TWO_PI_C = 6.283185307
WO_MIN = float(np.float32(TWO_PI_C / P_MAX))
WO_MAX = float(np.float32(TWO_PI_C / P_MIN))


def _f32(x) -> float:
    return float(np.float32(x))


def _L_of(Wo: float) -> int:
    """model->L = PI/model->Wo (C float truncation semantics)."""
    return int(PI_C / _f32(Wo))
WO_BITS = 7
E_BITS = 5
E_MIN_DB, E_MAX_DB = -10.0, 40.0
TW = 40                  # Fs * TW_S (trapezoidal overlap)
BG_THRESH, BG_BETA, BG_MARGIN = 40.0, 0.1, 6.0   # postfilter.c:47-49
BETA, GAMMA = 0.2, 0.5   # codec2.c codec2_create lpc post filter defaults
CODEC2_RAND_MAX = 32768
FRAME_BITS = 52
SAMPLES_PER_FRAME = 4 * N_SAMP


def _lsp_codebooks():
    cb = data._codec2_cb()
    bits = cb["lsp_cb_bits"]
    return [np.asarray(cb[f"lsp_cb_{i}"], np.float64)
            for i in range(10)], [int(b) for b in bits]


class _Rand:
    """The reference's `codec2_rand` LCG (`sine.c:680-687`) — the
    unvoiced-phase source; replicated so waveforms match exactly."""

    def __init__(self):
        self.next = 1

    def __call__(self) -> int:
        self.next = (self.next * 1103515245 + 12345) & 0xFFFFFFFFFFFFFFFF
        return (self.next // 65536) % 32768


def _gray_to_binary(field: int) -> int:
    t = field ^ (field >> 8)
    t ^= t >> 4
    t ^= t >> 2
    t ^= t >> 1
    return t


class _BitUnpacker:
    """MSB-first field unpacker with Gray decode (pack.c)."""

    def __init__(self, bits52: np.ndarray):
        self.bits = np.asarray(bits52).astype(np.uint8).reshape(-1)
        self.pos = 0

    def take(self, width: int, gray: bool = True) -> int:
        field = 0
        for _ in range(width):
            field = (field << 1) | int(self.bits[self.pos])
            self.pos += 1
        return _gray_to_binary(field) if gray else field


def decode_wo(index: int) -> float:
    """quantise.c decode_Wo — LINEAR quantiser (1300 mode), f32 math."""
    step = _f32((WO_MAX - WO_MIN) / (1 << WO_BITS))
    return _f32(WO_MIN + _f32(step * index))


def decode_energy(index: int) -> float:
    step = (E_MAX_DB - E_MIN_DB) / (1 << E_BITS)
    return 10.0 ** ((E_MIN_DB + step * index) / 10.0)


def decode_lsps_scalar(indexes) -> np.ndarray:
    cbs, _ = _lsp_codebooks()
    lsp_hz = np.array([cbs[i][indexes[i]] for i in range(LPC_ORD)])
    return (np.pi / 4000.0) * lsp_hz


def check_lsp_order(lsp: np.ndarray) -> np.ndarray:
    """quantise.c check_lsp_order — bubble with restart, +-0.1 nudge."""
    lsp = lsp.copy()
    i = 1
    while i < LPC_ORD:
        if lsp[i] < lsp[i - 1]:
            tmp = lsp[i - 1]
            lsp[i - 1] = lsp[i] - 0.1
            lsp[i] = tmp + 0.1
            i = 1
        i += 1
    return lsp


def bw_expand_lsps(lsp: np.ndarray, min_sep_low=50.0,
                   min_sep_high=100.0) -> np.ndarray:
    lsp = lsp.copy()
    r = np.pi / 4000.0
    for i in range(1, 4):
        if lsp[i] - lsp[i - 1] < min_sep_low * r:
            lsp[i] = lsp[i - 1] + min_sep_low * r
    for i in range(4, LPC_ORD):
        if lsp[i] - lsp[i - 1] < min_sep_high * r:
            lsp[i] = lsp[i - 1] + min_sep_high * r
    return lsp


def lsp_to_lpc(lsp: np.ndarray) -> np.ndarray:
    """lsp.c lsp_to_lpc — cascade-of-quadratics reconstruction of
    A(z) = (P(z)+Q(z))/2 driven by an impulse."""
    order = LPC_ORD
    freq = np.cos(lsp)
    Wp = np.zeros(4 * (order // 2) + 2)
    ak = np.zeros(order + 1)
    xin1 = xin2 = 1.0
    for j in range(order + 1):
        for i in range(order // 2):
            n1 = 4 * i
            xout1 = xin1 - 2.0 * freq[2 * i] * Wp[n1] + Wp[n1 + 1]
            xout2 = xin2 - 2.0 * freq[2 * i + 1] * Wp[n1 + 2] + Wp[n1 + 3]
            Wp[n1 + 1] = Wp[n1]
            Wp[n1 + 3] = Wp[n1 + 2]
            Wp[n1] = xin1
            Wp[n1 + 2] = xin2
            xin1, xin2 = xout1, xout2
        n4 = 4 * (order // 2 - 1) + 3
        xout1 = xin1 + Wp[n4 + 1]
        xout2 = xin2 - Wp[n4 + 2]
        ak[j] = (xout1 + xout2) * 0.5
        Wp[n4 + 1] = xin1
        Wp[n4 + 2] = xin2
        xin1 = xin2 = 0.0
    return ak


def _aks_to_M2(ak: np.ndarray, Wo: float, L: int, E: float):
    """quantise.c aks_to_M2 with the LPC post filter + bass boost
    enabled (decoder defaults).  Returns (A[1..L], Aw half-spectrum)."""
    a = np.zeros(FFT_ENC)
    a[: LPC_ORD + 1] = ak
    Aw = np.fft.rfft(a)            # kiss_fftr forward, unscaled
    Pw = 1.0 / (Aw.real[: FFT_ENC // 2] ** 2
                + Aw.imag[: FFT_ENC // 2] ** 2 + 1e-6)

    # lpc_post_filter (quantise.c:735-830)
    x = np.zeros(FFT_ENC)
    x[0] = ak[0]
    coeff = GAMMA
    for i in range(1, LPC_ORD + 1):
        x[i] = ak[i] * coeff
        coeff *= GAMMA
    Ww = np.fft.rfft(x)
    Ww2 = Ww.real[: FFT_ENC // 2] ** 2 + Ww.imag[: FFT_ENC // 2] ** 2
    Rw = np.sqrt(Ww2 * Pw)
    e_before = 1e-4 + np.sum(Pw)
    Pfw = Rw ** BETA
    Pw = Pw * Pfw * Pfw
    e_after = 1e-4 + np.sum(Pw)
    Pw *= (e_before / e_after) * E
    Pw[: FFT_ENC // 8] *= 1.4 * 1.4          # bass boost 0-1 kHz

    # harmonic magnitudes: A_m = sqrt(sum Pw over the band of harmonic m)
    r = 2.0 * np.pi / FFT_ENC
    A = np.zeros(MAX_AMP + 1)
    for m in range(1, L + 1):
        am = int((m - 0.5) * Wo / r + 0.5)
        bm = int((m + 0.5) * Wo / r + 0.5)
        bm = min(bm, FFT_ENC // 2)
        A[m] = np.sqrt(np.sum(Pw[am:bm]))
    return A, Aw


class Codec2Decoder1300:
    """Stateful frame decoder: 52 bits / 40 ms -> 320 samples @8 kHz,
    tracking `codec2_decode_1300` (PRNG, overlap-add and background-
    estimate state included)."""

    def __init__(self):
        # codec2_create init (codec2.c:180-192)
        self.prev_lsps = np.arange(LPC_ORD) * np.pi / (LPC_ORD + 1)
        self.prev_e = 1.0
        self.prev_Wo = WO_MIN
        self.prev_voiced = 0
        self.ex_phase = 0.0
        self.bg_est = 0.0
        self.Sn_ = np.zeros(2 * N_SAMP)
        self.rand = _Rand()
        self.Pn = self._synthesis_window()

    @staticmethod
    def _synthesis_window() -> np.ndarray:
        Pn = np.zeros(2 * N_SAMP)
        n, tw = N_SAMP, TW
        Pn[n // 2 - tw: n // 2 + tw] = np.arange(2 * tw) / (2.0 * tw)
        Pn[n // 2 + tw: 3 * n // 2 - tw] = 1.0
        Pn[3 * n // 2 - tw: 3 * n // 2 + tw] = \
            1.0 - np.arange(2 * tw) / (2.0 * tw)
        return Pn

    def decode_frame(self, bits52: np.ndarray,
                     ber_est: float = 0.0) -> np.ndarray:
        up = _BitUnpacker(bits52)
        voiced = [up.take(1) for _ in range(4)]
        Wo3 = decode_wo(up.take(WO_BITS))
        L3 = _L_of(Wo3)
        e3 = decode_energy(up.take(E_BITS))
        _, cb_bits = _lsp_codebooks()
        lsp_idx = [up.take(cb_bits[i]) for i in range(LPC_ORD)]
        lsps3 = bw_expand_lsps(check_lsp_order(decode_lsps_scalar(lsp_idx)))

        # codec2.c:1297 soft mute: a badly-corrupted frame (channel BER
        # estimate > 0.15) is forced unvoiced with the quiet energy
        # index and heavily bandwidth-expanded LSPs, so the decoder
        # squelches instead of screeching.
        if ber_est > 0.15:
            voiced = [0, 0, 0, 0]
            e3 = decode_energy(10)
            lsps3 = bw_expand_lsps(lsps3, 200.0, 200.0)

        # interpolate the 3 intermediate 10 ms subframes (interp.c)
        lsps, Wos, Ls, es, vs = [], [], [], [], []
        for i in range(3):
            w = 0.25 * (i + 1)
            v = voiced[i]
            # interp_Wo2 voicing trap
            if v and not self.prev_voiced and not voiced[3]:
                v = 0
            if v:
                if self.prev_voiced and voiced[3]:
                    Wo = _f32((1.0 - w) * self.prev_Wo + w * Wo3)
                elif voiced[3]:
                    Wo = Wo3
                elif self.prev_voiced:
                    Wo = self.prev_Wo
                else:
                    Wo = WO_MIN
            else:
                Wo = WO_MIN
            lsps.append((1.0 - w) * self.prev_lsps + w * lsps3)
            Wos.append(Wo)
            Ls.append(_L_of(Wo))
            es.append(10.0 ** ((1.0 - w) * np.log10(self.prev_e)
                               + w * np.log10(e3)))
            vs.append(v)
        lsps.append(lsps3)
        Wos.append(Wo3)
        Ls.append(L3)
        es.append(e3)
        vs.append(voiced[3])

        out = np.zeros(SAMPLES_PER_FRAME, np.int16)
        for i in range(4):
            ak = lsp_to_lpc(lsps[i])
            A, Aw = _aks_to_M2(ak, Wos[i], Ls[i], es[i])
            # apply_lpc_correction (quantise.c)
            if Wos[i] < np.pi * 150.0 / 4000.0:
                A[1] *= 0.032
            out[i * N_SAMP:(i + 1) * N_SAMP] = self._synth_subframe(
                Wos[i], Ls[i], vs[i], A, Aw)

        self.prev_lsps = lsps3
        self.prev_e = e3
        self.prev_Wo = Wo3
        self.prev_voiced = voiced[3]
        return out

    def _synth_subframe(self, Wo, L, voiced, A, Aw) -> np.ndarray:
        # sample_phase (phase.c): synthesis filter phase = conj(A(e^jw))
        r = 2.0 * np.pi / FFT_ENC
        b = (np.arange(1, L + 1) * Wo / r + 0.5).astype(int)
        H = np.conj(Aw[b])
        return self.synth_from_H(Wo, L, voiced, A, H)

    def synth_from_H(self, Wo, L, voiced, A, H,
                     gain: float = 1.0) -> np.ndarray:
        """synthesise_one_frame (codec2.c) from per-harmonic phase
        responses H (0-based, H[m-1] = harmonic m, |H| arbitrary — only
        its angle is used).  Shared by the LPC modes (H sampled from
        A(e^jw)) and 700C (H from newamp1 `determine_phase`)."""
        # phase_synth_zero_order
        self.ex_phase += Wo * N_SAMP
        self.ex_phase -= 2.0 * np.pi * np.floor(
            self.ex_phase / (2.0 * np.pi) + 0.5)
        phi = np.zeros(L + 1)
        for m in range(1, L + 1):
            if voiced:
                Ex = np.exp(1j * self.ex_phase * m)
            else:
                ph = 2.0 * np.pi * self.rand() / CODEC2_RAND_MAX
                Ex = np.exp(1j * ph)
            A_ = H[m - 1] * Ex
            phi[m] = np.arctan2(A_.imag, A_.real + 1e-12)

        # postfilter (postfilter.c)
        e = 1e-12 + np.sum(A[1:L + 1] ** 2)
        e = 10.0 * np.log10(e / L)
        if e < BG_THRESH and not voiced:
            self.bg_est = self.bg_est * (1.0 - BG_BETA) + e * BG_BETA
        if voiced:
            thresh = 10.0 ** ((self.bg_est + BG_MARGIN) / 20.0)
            for m in range(1, L + 1):
                if A[m] < thresh:
                    phi[m] = (2.0 * np.pi / CODEC2_RAND_MAX) * self.rand()

        # synthesise (sine.c): freq-domain placement + irfft + trapezoid
        Sw = np.zeros(FFT_DEC // 2 + 1, np.complex128)
        bdec = (np.arange(1, L + 1) * Wo * FFT_DEC
                / (2.0 * np.pi) + 0.5).astype(int)
        bdec = np.minimum(bdec, FFT_DEC // 2 - 1)
        for m in range(1, L + 1):
            Sw[bdec[m - 1]] = A[m] * np.exp(1j * phi[m])
        sw = np.fft.irfft(Sw, FFT_DEC) * FFT_DEC   # kiss inverse, unscaled

        Sn_ = self.Sn_
        # shift memories
        Sn_[: N_SAMP - 1] = Sn_[N_SAMP: 2 * N_SAMP - 1]
        Sn_[N_SAMP - 1] = 0.0
        Sn_[: N_SAMP - 1] += sw[FFT_DEC - N_SAMP + 1:] * Pn_head(self.Pn)
        Sn_[N_SAMP - 1: 2 * N_SAMP] = sw[: N_SAMP + 1] \
            * self.Pn[N_SAMP - 1: 2 * N_SAMP]

        frame = Sn_[:N_SAMP].copy()
        if gain != 1.0:
            # codec2.c synthesise_one_frame: gain applied to the output
            # segment only (the overlap memory stays unscaled), BEFORE
            # ear protection
            frame *= gain
        # ear_protection (codec2.c; note: positive max, no abs)
        mx = frame.max() if len(frame) else 0.0
        over = mx / 30000.0
        if over > 1.0:
            frame *= 1.0 / (over * over)
        # float->short conversion truncates toward zero (C cast)
        return np.trunc(np.clip(frame, -32767, 32767)).astype(np.int16)


def Pn_head(Pn: np.ndarray) -> np.ndarray:
    return Pn[: N_SAMP - 1]


# ---------------------------------------------------------------------------
# Encoder (codec2_encode_1300, codec2.c:1179-1238, and the analysis
# pipeline it drives: analyse_one_frame :2494-2532, sine.c dft_speech /
# two_stage_pitch_refinement / estimate_amplitudes / est_voicing_mbe,
# nlp.c pitch estimator, quantise.c speech_to_uq_lsps + scalar encoders)
# ---------------------------------------------------------------------------

NW = 279                 # analysis window length (c2const_create, Fs=8k)
V_THRESH = 6.0           # defines.h:50
NLP_DEC = 5              # nlp.c:49
NLP_COEFF = 0.95         # DC notch (nlp.c:47)
PE_FFT = 512             # nlp.c:48
CNLP = 0.3               # nlp.c:54


def _analysis_window():
    """make_analysis_window (sine.c:100-205): normalized Hamming w[] on
    the m_pitch buffer and its real symmetric DFT W[] centered at
    FFT_ENC/2."""
    w = np.zeros(M_PITCH)
    j = np.arange(NW)
    w[M_PITCH // 2 - NW // 2: M_PITCH // 2 + NW // 2 + 1][:NW] = \
        0.5 - 0.5 * np.cos(2.0 * np.pi * j / (NW - 1))
    m = np.sum(w ** 2)
    w *= 1.0 / np.sqrt(m * FFT_ENC)
    wshift = np.zeros(FFT_ENC)
    wshift[: NW // 2] = w[M_PITCH // 2: M_PITCH // 2 + NW // 2]
    wshift[FFT_ENC - NW // 2:] = w[M_PITCH // 2 - NW // 2: M_PITCH // 2]
    W = np.fft.fft(wshift).real
    return w, np.concatenate([W[FFT_ENC // 2:], W[:FFT_ENC // 2]])


def _dft_speech(Sn: np.ndarray, w: np.ndarray) -> np.ndarray:
    """sine.c dft_speech: window centred on m_pitch/2, halves swapped so
    FFT phases are correct."""
    x = np.zeros(FFT_ENC, np.complex128)
    x[: NW // 2] = (Sn * w)[M_PITCH // 2: M_PITCH // 2 + NW // 2]
    x[FFT_ENC - NW // 2:] = (Sn * w)[M_PITCH // 2 - NW // 2: M_PITCH // 2]
    return np.fft.fft(x)


def _hs_pitch_refine(Sw2: np.ndarray, Wo: float, pmin, pmax, pstep):
    """sine.c hs_pitch_refinement on the magnitude-squared spectrum."""
    L = int(PI_C / Wo)
    r = 2.0 * np.pi / FFT_ENC
    best_Wo, best_E = Wo, 0.0
    p = pmin
    while p <= pmax:
        Wt = 2.0 * np.pi / p
        b = (np.arange(1, L + 1) * Wt / r + 0.5).astype(int)
        E = float(np.sum(Sw2[np.clip(b, 0, FFT_ENC - 1)]))
        if E > best_E:
            best_E, best_Wo = E, Wt
        p += pstep
    return best_Wo


def _lpc_to_lsp(a: np.ndarray) -> np.ndarray | None:
    """LSPs = zeros of P'(z), Q'(z) on the unit circle, found on the
    x = cos(w) axis.  Same polynomials as lsp.c lpc_to_lsp; the root
    search uses numpy's Chebyshev machinery instead of the C grid-
    bisection (roots are identical up to float tolerance — the encoder
    does not need the C's 0.006-rad grid quantization)."""
    order = LPC_ORD
    m = order // 2
    P = np.zeros(m + 1)
    Q = np.zeros(m + 1)
    P[0] = Q[0] = 1.0
    for i in range(1, m + 1):
        P[i] = a[i] + a[order + 1 - i] - P[i - 1]
        Q[i] = a[i] - a[order + 1 - i] + Q[i - 1]
    P[:m] *= 2.0
    Q[:m] *= 2.0
    # cheb_poly_eva evaluates sum_k coef[k] T_k(x) with coef reversed
    roots = []
    for poly in (P, Q):
        c = np.zeros(m + 1)
        c[: m + 1] = poly[::-1]          # T_0..T_m coefficients
        r = np.polynomial.chebyshev.chebroots(c)
        r = np.real(r[np.abs(np.imag(r)) < 1e-9])
        roots.append(np.sort(r[(r > -1.0) & (r < 1.0)])[::-1])
    if len(roots[0]) != m or len(roots[1]) != m:
        return None
    lsp = np.empty(order)
    lsp[0::2] = np.arccos(roots[0])
    lsp[1::2] = np.arccos(roots[1])
    return np.sort(lsp)


class Codec2Encoder1300:
    """Stateful 1300-mode encoder: 320 samples @8 kHz -> 52 bits.

    Analysis is the reference pipeline (NLP pitch -> harmonic-sum
    refinement -> MBE voicing -> LPC/LSP + scalar quantisers); it is not
    required to be bit-identical with the reference ENCODER (pitch/LSP
    root search use cleaner numerics), only to emit valid 1300 streams —
    interop is judged by what the reference DECODER (and ours) renders
    from them (tests/test_codec2_golden.py)."""

    def __init__(self):
        self.Sn = np.zeros(M_PITCH)
        self.w, self.W = _analysis_window()
        self.nlp_sq = np.zeros(M_PITCH)
        self.nlp_mem_x = 0.0
        self.nlp_mem_y = 0.0
        self.nlp_fir_mem = np.zeros(48)
        self.nlp_fir = np.asarray(data.array("nlp_fir"), np.float64)
        nw = M_PITCH // NLP_DEC
        self.nlp_w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(nw)
                                        / (nw - 1))
        self.prev_f0 = 1.0 / 0.02        # codec2.c:179

    # ---- NLP pitch estimator (nlp.c:251-400) ----
    def _nlp(self) -> float:
        m, n = M_PITCH, N_SAMP
        sq_new = self.Sn[m - n:] ** 2
        out = np.empty(n)
        for i, s in enumerate(sq_new):       # DC notch (one pole)
            notch = s - self.nlp_mem_x + NLP_COEFF * self.nlp_mem_y
            self.nlp_mem_x = s
            self.nlp_mem_y = notch
            out[i] = notch + 1.0
        # 48-tap LPF (streaming FIR over the new samples)
        filt = np.empty(n)
        for i in range(n):
            self.nlp_fir_mem[:-1] = self.nlp_fir_mem[1:]
            self.nlp_fir_mem[-1] = out[i]
            filt[i] = float(self.nlp_fir_mem @ self.nlp_fir)
        self.nlp_sq[: m - n] = self.nlp_sq[n:]
        self.nlp_sq[m - n:] = filt
        # decimate x5, window, 512 FFT, |.|^2
        x = np.zeros(PE_FFT, np.complex128)
        x[: m // NLP_DEC] = self.nlp_sq[::NLP_DEC] * self.nlp_w
        Fw = np.abs(np.fft.fft(x)) ** 2
        pmin, pmax = P_MIN, P_MAX
        lo, hi = PE_FFT * NLP_DEC // pmax, PE_FFT * NLP_DEC // pmin
        gmax_bin = lo + int(np.argmax(Fw[lo: hi + 1]))
        gmax = Fw[gmax_bin]
        # post_process_sub_multiples (nlp.c:430-480)
        cmax_bin = gmax_bin
        prev_bin = int(self.prev_f0 * PE_FFT * NLP_DEC / FS)
        mult = 2
        while gmax_bin // mult >= lo:
            b = gmax_bin // mult
            bmin, bmax = max(int(0.8 * b), lo), int(1.2 * b)
            thresh = CNLP * gmax * (0.5 if bmin < prev_bin < bmax else 1.0)
            seg = Fw[bmin: bmax + 1]
            lmax_bin = bmin + int(np.argmax(seg))
            lmax = Fw[lmax_bin]
            if lmax > thresh and lmax > Fw[lmax_bin - 1] \
                    and lmax > Fw[lmax_bin + 1]:
                cmax_bin = lmax_bin
            mult += 1
        best_f0 = cmax_bin * FS / (PE_FFT * NLP_DEC)
        self.prev_f0 = best_f0
        return FS / best_f0                  # pitch period in samples

    def _analyse_one_frame(self, speech80: np.ndarray):
        self.Sn[: M_PITCH - N_SAMP] = self.Sn[N_SAMP:]
        self.Sn[M_PITCH - N_SAMP:] = speech80
        Sw = _dft_speech(self.Sn, self.w)
        Sw2 = np.abs(Sw) ** 2
        pitch = self._nlp()
        Wo = 2.0 * np.pi / pitch
        # two-stage harmonic-sum refinement (sine.c:303-335)
        Wo = _hs_pitch_refine(Sw2, Wo, 2 * np.pi / Wo - 5,
                              2 * np.pi / Wo + 5, 1.0)
        Wo = _hs_pitch_refine(Sw2, Wo, 2 * np.pi / Wo - 1,
                              2 * np.pi / Wo + 1, 0.25)
        Wo = float(np.clip(Wo, WO_MIN, WO_MAX))
        L = int(np.floor(PI_C / Wo))
        if Wo * L >= 0.95 * np.pi:
            L -= 1
        # estimate_amplitudes (sine.c:405-450)
        r = 2.0 * np.pi / FFT_ENC
        A = np.zeros(MAX_AMP + 1)
        for mh in range(1, L + 1):
            am = int((mh - 0.5) * Wo / r + 0.5)
            bm = int((mh + 0.5) * Wo / r + 0.5)
            A[mh] = np.sqrt(np.sum(Sw2[am:bm]))
        # est_voicing_mbe (sine.c:455-570)
        sig = 1e-4 + np.sum(A[1: L // 4 + 1] ** 2)
        error = 1e-4
        l_1000 = int(L * 1000.0 / (FS / 2))
        for lh in range(1, l_1000 + 1):
            al = int(np.ceil((lh - 0.5) * Wo * FFT_ENC / (2 * np.pi)))
            bl = int(np.ceil((lh + 0.5) * Wo * FFT_ENC / (2 * np.pi)))
            offset = int(FFT_ENC / 2 - lh * Wo * FFT_ENC / (2 * np.pi)
                         + 0.5)
            Wseg = self.W[offset + al: offset + bl]
            Sseg = Sw[al:bl]
            den = float(np.sum(Wseg ** 2))
            Am = np.sum(Sseg * Wseg) / (den + 1e-30)
            error += float(np.sum(np.abs(Sseg - Am * Wseg) ** 2))
        voiced = 1 if 10.0 * np.log10(sig / error) > V_THRESH else 0
        l_2000 = int(L * 2000.0 / (FS / 2))
        l_4000 = int(L * 4000.0 / (FS / 2))
        elow = 1e-4 + np.sum(A[1: l_2000 + 1] ** 2)
        ehigh = 1e-4 + np.sum(A[l_2000: l_4000 + 1] ** 2)
        eratio = 10.0 * np.log10(elow / ehigh)
        if voiced == 0 and eratio > 10.0:
            voiced = 1
        if voiced == 1:
            if eratio < -10.0:
                voiced = 0
            if eratio < -4.0 and Wo <= 60.0 * 2 * np.pi / FS:
                voiced = 0
        return Wo, L, A, voiced

    def _speech_to_uq_lsps(self):
        """quantise.c speech_to_uq_lsps: windowed LPC analysis + 15 Hz
        bandwidth expansion + LSP conversion."""
        Wn = self.Sn * self.w
        e = float(np.sum(Wn ** 2))
        if e == 0.0:
            return np.arange(LPC_ORD) * np.pi / LPC_ORD, 0.0
        R = np.array([np.dot(Wn[: M_PITCH - j], Wn[j:])
                      for j in range(LPC_ORD + 1)])
        # levinson_durbin (lpc.c)
        a_prev = np.zeros(LPC_ORD + 1)
        Ee = R[0]
        a_cur = np.zeros(LPC_ORD + 1)
        for i in range(1, LPC_ORD + 1):
            s = float(np.dot(a_prev[1:i], R[i - 1:0:-1]))
            k = -(R[i] + s) / Ee if Ee != 0 else 0.0
            if abs(k) > 1.0:
                k = 0.0
            a_cur[1:i] = a_prev[1:i] + k * a_prev[i - 1:0:-1]
            a_cur[i] = k
            Ee *= (1 - k * k)
            a_prev = a_cur.copy()
        ak = a_cur.copy()
        ak[0] = 1.0
        E = float(np.dot(ak, R))
        ak_bw = ak * (0.994 ** np.arange(LPC_ORD + 1))
        lsp = _lpc_to_lsp(ak_bw)
        if lsp is None:
            lsp = np.arange(LPC_ORD) * np.pi / LPC_ORD
        return lsp, E

    def encode_frame(self, speech320: np.ndarray) -> np.ndarray:
        """320 samples -> (52,) bits in the reference packing order."""
        speech320 = np.asarray(speech320, np.float64).reshape(4, N_SAMP)
        voiced = []
        Wo = WO_MIN
        for i in range(4):
            Wo, _L, _A, v = self._analyse_one_frame(speech320[i])
            voiced.append(v)
        bits = []

        def pack(value, width):
            g = int(value) ^ (int(value) >> 1)        # binary -> Gray
            for b in range(width - 1, -1, -1):
                bits.append((g >> b) & 1)

        for v in voiced:
            pack(v, 1)
        # encode_Wo (linear, quantise.c)
        idx = int(np.floor((1 << WO_BITS) * (Wo - WO_MIN)
                           / (WO_MAX - WO_MIN) + 0.5))
        pack(int(np.clip(idx, 0, (1 << WO_BITS) - 1)), WO_BITS)
        lsp, E = self._speech_to_uq_lsps()
        e_db = 10.0 * np.log10(max(E, 1e-12))
        eidx = int(np.floor((1 << E_BITS) * (e_db - E_MIN_DB)
                            / (E_MAX_DB - E_MIN_DB) + 0.5))
        pack(int(np.clip(eidx, 0, (1 << E_BITS) - 1)), E_BITS)
        cbs, cb_bits = _lsp_codebooks()
        lsp_hz = lsp * 4000.0 / np.pi
        for i in range(LPC_ORD):
            k = int(np.argmin((cbs[i] - lsp_hz[i]) ** 2))
            pack(k, cb_bits[i])
        return np.array(bits, np.uint8)
