"""1300 bit/s LPC/LSP vocoder (Codec2-1300-class, for FreeDV 1600 mode).

Role in the reference: the embedded Codec2 library (`drivers/freedv/
codec2.c`, ~113 kLoC subsystem) encodes 8 kHz speech at 1300 bit/s for
FreeDV 1600 (`freedv_api.c:143-146`).  This is an independent vocoder of
the same class and exact frame economy — NOT bit-compatible with Codec2
(different quantizer tables and synthesis model; Codec2 uses a sinusoidal
MBE-style model, this uses classic LPC-10-style excitation/synthesis):

frame = 40 ms (320 samples) -> 52 bits:
  * 4  voicing bits (one per 10 ms subframe, like Codec2 1300)
  * 7  pitch bits (log-quantized 50..400 Hz)
  * 5  energy bits (log-quantized)
  * 36 LSP bits, scalar-quantized with allocation [5,5,4,4,4,4,3,3,2,2]

52 bits / 40 ms = 1300 bit/s; FreeDV 1600 adds 11 Golay parity bits over
the 12 perceptually-critical bits (voicing+pitch+energy, see
`modems/freedv.py`) + 1 text bit = 64 bits / 40 ms = 1600 bit/s = two
FDMDV symbols.

A copy of the JAX package's NumPy module of the same name (the port
imports nothing of that package): the same arrays and decisions,
its data read from the port's own `data` package.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

FS = 8000
FRAME = 320            # 40 ms
SUBFRAME = 80          # 10 ms
ORDER = 10
PITCH_MIN = 20         # 400 Hz
PITCH_MAX = 160        # 50 Hz

LSP_BITS = (5, 5, 4, 4, 4, 4, 3, 3, 2, 2)     # 36 bits
assert sum(LSP_BITS) == 36
PITCH_BITS = 7
ENERGY_BITS = 5
VOICING_BITS = 4
BITS_PER_FRAME = VOICING_BITS + PITCH_BITS + ENERGY_BITS + sum(LSP_BITS)
assert BITS_PER_FRAME == 52

# per-index LSP quantizer ranges (rad), roughly tracking formant spacing
_LSP_LO = np.array([0.05, 0.15, 0.35, 0.60, 0.90, 1.20, 1.55, 1.90,
                    2.25, 2.60])
_LSP_HI = np.array([0.50, 0.85, 1.20, 1.55, 1.90, 2.25, 2.60, 2.85,
                    3.00, 3.10])


# ---------------------------------------------------------------------------
# LPC <-> LSP
# ---------------------------------------------------------------------------

def lpc_to_lsp(a: np.ndarray) -> np.ndarray:
    """a: (ORDER+1,) prediction-error filter (a[0]=1) -> LSP frequencies
    (ORDER,) in (0, pi), ascending.  Root-finding on the sum/difference
    polynomials via dense evaluation + bisection."""
    p = np.concatenate([a, [0.0]]) + np.concatenate([[0.0], a])[::-1] * 0
    # P(z) = A(z) + z^-(n+1) A(z^-1); Q(z) = A(z) - z^-(n+1) A(z^-1)
    n = ORDER
    P = np.zeros(n + 2)
    Q = np.zeros(n + 2)
    for i in range(n + 2):
        ar = a[i] if i <= n else 0.0
        al = a[n + 1 - i] if 0 <= n + 1 - i <= n else 0.0
        P[i] = ar + al
        Q[i] = ar - al
    # deflate known roots: P has root at z=-1, Q at z=+1
    P = np.polynomial.polynomial.polydiv(P[::-1], [1.0, 1.0])[0][::-1]
    Q = np.polynomial.polynomial.polydiv(Q[::-1], [-1.0, 1.0][::-1])[0][::-1]

    def eval_on_circle(c: np.ndarray, w: np.ndarray) -> np.ndarray:
        # symmetric polynomial of even degree 2m: value on unit circle is
        # real after factoring e^{-jmw}; just evaluate magnitude-signed
        z = np.exp(1j * w)
        vals = np.polyval(c[::-1], z) * np.exp(-1j * w * (len(c) - 1) / 2)
        return vals.real

    grid = np.linspace(1e-3, np.pi - 1e-3, 512)
    lsps = []
    for poly in (P, Q):
        v = eval_on_circle(poly, grid)
        sign_change = np.where(np.diff(np.sign(v)) != 0)[0]
        for i in sign_change:
            lo, hi = grid[i], grid[i + 1]
            flo = eval_on_circle(poly, np.array([lo]))[0]
            for _ in range(30):
                mid = 0.5 * (lo + hi)
                fm = eval_on_circle(poly, np.array([mid]))[0]
                if flo * fm <= 0:
                    hi = mid
                else:
                    lo, flo = mid, fm
            lsps.append(0.5 * (lo + hi))
    lsps = np.sort(np.array(lsps))
    if len(lsps) != ORDER:
        # numerical fallback: evenly spaced
        lsps = np.linspace(0.2, 3.0, ORDER)
    return lsps


def lsp_to_lpc(lsp: np.ndarray) -> np.ndarray:
    """LSP (ORDER,) -> prediction-error filter a (ORDER+1,)."""
    wp = lsp[0::2]    # P roots
    wq = lsp[1::2]    # Q roots
    P = np.array([1.0])
    for w in wp:
        P = np.convolve(P, [1.0, -2 * np.cos(w), 1.0])
    Q = np.array([1.0])
    for w in wq:
        Q = np.convolve(Q, [1.0, -2 * np.cos(w), 1.0])
    P = np.convolve(P, [1.0, 1.0])      # restore z=-1 root
    Q = np.convolve(Q, [1.0, -1.0])     # restore z=+1 root
    a = 0.5 * (P + Q)
    return a[: ORDER + 1]


def _autocorr_lpc(x: np.ndarray) -> tuple[np.ndarray, float]:
    """Windowed autocorrelation LPC with lag windowing; returns
    (a (ORDER+1,), residual energy)."""
    w = np.hamming(len(x))
    xw = x * w
    R = np.array([np.dot(xw[: len(x) - i], xw[i:]) for i in range(ORDER + 1)])
    R[0] *= 1.0001
    R[0] += 1e-6
    # lag window (slight bandwidth expansion, stabilizes quantization)
    lag = np.exp(-0.5 * (2 * np.pi * 60.0 * np.arange(ORDER + 1) / FS) ** 2)
    R = R * lag
    a = np.zeros(ORDER + 1)
    a[0] = 1.0
    err = R[0]
    for m in range(1, ORDER + 1):
        acc = R[m] + np.dot(a[1:m], R[m - 1:0:-1])
        k = -acc / err
        a[1:m] = a[1:m] + k * a[m - 1:0:-1]
        a[m] = k
        err *= (1 - k * k)
    return a, max(err, 1e-9)


def _estimate_pitch(x: np.ndarray) -> tuple[int, float]:
    """Autocorrelation pitch over the frame; returns (lag, periodicity)."""
    x = x - x.mean()
    e0 = np.dot(x, x) + 1e-9
    best_lag, best_r = PITCH_MIN, 0.0
    ac = np.correlate(x, x, "full")[len(x) - 1:]
    for lag in range(PITCH_MIN, min(PITCH_MAX, len(x) - 1)):
        r = ac[lag] / e0
        if r > best_r:
            best_r, best_lag = r, lag
    return best_lag, best_r


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------

def _quant(value, lo, hi, bits):
    n = (1 << bits) - 1
    idx = int(round((value - lo) / (hi - lo) * n))
    return max(0, min(n, idx))


def _dequant(idx, lo, hi, bits):
    n = (1 << bits) - 1
    return lo + (hi - lo) * idx / n


@dataclass
class VocoderFrame:
    voicing: np.ndarray      # (4,) bool
    pitch_lag: int
    energy: float            # residual RMS
    lsp: np.ndarray          # (10,) rad


def encode_frame(x: np.ndarray) -> np.ndarray:
    """x: (320,) float speech -> (52,) bits."""
    assert x.shape == (FRAME,)
    a, res_e = _autocorr_lpc(x)
    lsp = lpc_to_lsp(a)
    lag, periodicity = _estimate_pitch(x)

    bits = []
    # voicing per subframe: periodic AND has energy
    for sf in range(4):
        seg = x[sf * SUBFRAME:(sf + 1) * SUBFRAME]
        e = np.sqrt(np.mean(seg ** 2))
        v = (periodicity > 0.35) and (e > 1e-4 * 32768)
        bits.append(1 if v else 0)
    # pitch: log-quantized lag
    log_lag = np.log2(max(lag, PITCH_MIN) / PITCH_MIN)
    log_max = np.log2(PITCH_MAX / PITCH_MIN)
    pidx = _quant(log_lag, 0.0, log_max, PITCH_BITS)
    bits += [int(b) for b in format(pidx, f"0{PITCH_BITS}b")]
    # energy: log RMS of the frame
    rms = np.sqrt(np.mean(x ** 2)) + 1e-9
    eidx = _quant(np.log10(rms), -1.0, 4.5, ENERGY_BITS)
    bits += [int(b) for b in format(eidx, f"0{ENERGY_BITS}b")]
    # LSPs
    for i, nb in enumerate(LSP_BITS):
        li = _quant(lsp[i], _LSP_LO[i], _LSP_HI[i], nb)
        bits += [int(b) for b in format(li, f"0{nb}b")]
    out = np.array(bits, np.uint8)
    assert out.size == BITS_PER_FRAME
    return out


def decode_frame_bits(bits: np.ndarray) -> VocoderFrame:
    bits = np.asarray(bits).astype(int)
    pos = 0
    voicing = bits[pos: pos + 4].astype(bool)
    pos += 4
    pidx = int("".join(map(str, bits[pos: pos + PITCH_BITS])), 2)
    pos += PITCH_BITS
    log_max = np.log2(PITCH_MAX / PITCH_MIN)
    lag = int(round(PITCH_MIN * 2 ** _dequant(pidx, 0.0, log_max,
                                              PITCH_BITS)))
    eidx = int("".join(map(str, bits[pos: pos + ENERGY_BITS])), 2)
    pos += ENERGY_BITS
    rms = 10.0 ** _dequant(eidx, -1.0, 4.5, ENERGY_BITS)
    lsp = np.zeros(ORDER)
    for i, nb in enumerate(LSP_BITS):
        li = int("".join(map(str, bits[pos: pos + nb])), 2)
        pos += nb
        lsp[i] = _dequant(li, _LSP_LO[i], _LSP_HI[i], nb)
    # enforce ascending order with minimal separation (quantization can
    # cross adjacent lines; unsorted LSPs make A(z) unstable)
    for i in range(1, ORDER):
        if lsp[i] <= lsp[i - 1] + 0.01:
            lsp[i] = lsp[i - 1] + 0.01
    return VocoderFrame(voicing=voicing, pitch_lag=lag, energy=rms, lsp=lsp)


# ---------------------------------------------------------------------------
# 700 bit/s frame variant (for the FreeDV 700D-class mode)
# ---------------------------------------------------------------------------

LSP_BITS_700 = (3, 3, 2, 2, 2, 2, 1, 1, 1, 0)    # 17 bits; line 10 fixed
PITCH_BITS_700 = 6
ENERGY_BITS_700 = 4
BITS_PER_FRAME_700 = 1 + PITCH_BITS_700 + ENERGY_BITS_700 + sum(LSP_BITS_700)
assert BITS_PER_FRAME_700 == 28   # 28 bits / 40 ms = 700 bit/s


def encode_frame_700(x: np.ndarray) -> np.ndarray:
    """x: (320,) -> (28,) bits (Codec2-700C economy: whole-frame voicing,
    coarser pitch/energy/LSP quantizers)."""
    assert x.shape == (FRAME,)
    a, _ = _autocorr_lpc(x)
    lsp = lpc_to_lsp(a)
    lag, periodicity = _estimate_pitch(x)
    rms = np.sqrt(np.mean(x ** 2)) + 1e-9

    bits = [1 if (periodicity > 0.35 and rms > 1e-4 * 32768) else 0]
    log_max = np.log2(PITCH_MAX / PITCH_MIN)
    pidx = _quant(np.log2(max(lag, PITCH_MIN) / PITCH_MIN), 0.0, log_max,
                  PITCH_BITS_700)
    bits += [int(b) for b in format(pidx, f"0{PITCH_BITS_700}b")]
    eidx = _quant(np.log10(rms), -1.0, 4.5, ENERGY_BITS_700)
    bits += [int(b) for b in format(eidx, f"0{ENERGY_BITS_700}b")]
    for i, nb in enumerate(LSP_BITS_700):
        if nb == 0:
            continue
        li = _quant(lsp[i], _LSP_LO[i], _LSP_HI[i], nb)
        bits += [int(b) for b in format(li, f"0{nb}b")]
    out = np.array(bits, np.uint8)
    assert out.size == BITS_PER_FRAME_700
    return out


def decode_frame_700_bits(bits: np.ndarray) -> VocoderFrame:
    bits = np.asarray(bits).astype(int)
    pos = 0
    v = bool(bits[pos]); pos += 1
    voicing = np.full(4, v, bool)
    pidx = int("".join(map(str, bits[pos: pos + PITCH_BITS_700])), 2)
    pos += PITCH_BITS_700
    log_max = np.log2(PITCH_MAX / PITCH_MIN)
    lag = int(round(PITCH_MIN * 2 ** _dequant(pidx, 0.0, log_max,
                                              PITCH_BITS_700)))
    eidx = int("".join(map(str, bits[pos: pos + ENERGY_BITS_700])), 2)
    pos += ENERGY_BITS_700
    rms = 10.0 ** _dequant(eidx, -1.0, 4.5, ENERGY_BITS_700)
    lsp = np.zeros(ORDER)
    for i, nb in enumerate(LSP_BITS_700):
        if nb == 0:
            lsp[i] = 0.5 * (_LSP_LO[i] + _LSP_HI[i])
            continue
        li = int("".join(map(str, bits[pos: pos + nb])), 2)
        pos += nb
        lsp[i] = _dequant(li, _LSP_LO[i], _LSP_HI[i], nb)
    for i in range(1, ORDER):
        if lsp[i] <= lsp[i - 1] + 0.01:
            lsp[i] = lsp[i - 1] + 0.01
    return VocoderFrame(voicing=voicing, pitch_lag=lag, energy=rms, lsp=lsp)


@dataclass
class Synthesizer:
    """Streaming decoder with LSP interpolation and excitation phase
    continuity across frames."""
    prev_lsp: np.ndarray = field(
        default_factory=lambda: np.linspace(0.3, 2.9, ORDER))
    prev_energy: float = 0.0
    filt_state: np.ndarray = field(default_factory=lambda: np.zeros(ORDER))
    pitch_phase: int = 0
    rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng(42))

    def synthesize(self, f: VocoderFrame) -> np.ndarray:
        out = np.zeros(FRAME)
        for sf in range(4):
            t = (sf + 1) / 4.0
            lsp = (1 - t) * self.prev_lsp + t * f.lsp
            a = lsp_to_lpc(lsp)
            e = (1 - t) * self.prev_energy + t * f.energy
            # excitation
            if f.voicing[sf]:
                exc = np.zeros(SUBFRAME)
                ph = self.pitch_phase
                while ph < SUBFRAME:
                    exc[ph] = 1.0
                    ph += f.pitch_lag
                self.pitch_phase = ph - SUBFRAME
                exc *= np.sqrt(f.pitch_lag)        # unit power impulse train
                # mix a little noise to avoid buzz
                exc = 0.9 * exc + 0.25 * self.rng.standard_normal(SUBFRAME)
            else:
                exc = self.rng.standard_normal(SUBFRAME)
            # LPC synthesis 1/A(z) (direct form II transposed)
            y = np.zeros(SUBFRAME)
            st = self.filt_state
            for n in range(SUBFRAME):
                yn = exc[n] - np.dot(a[1:], st)
                y[n] = yn
                st = np.concatenate([[yn], st[:-1]])
            self.filt_state = st
            # scale subframe to target RMS
            cur = np.sqrt(np.mean(y ** 2)) + 1e-9
            y *= e / cur
            out[sf * SUBFRAME:(sf + 1) * SUBFRAME] = y
        self.prev_lsp = f.lsp
        self.prev_energy = f.energy
        return out


@dataclass
class Vocoder:
    """encode/decode convenience pairing (codec2_encode/decode analog)."""
    synth: Synthesizer = field(default_factory=Synthesizer)

    def encode(self, speech: np.ndarray) -> np.ndarray:
        """speech: (k*320,) -> (k, 52) bits."""
        x = np.asarray(speech, np.float64)
        nfr = len(x) // FRAME
        return np.stack([encode_frame(x[i * FRAME:(i + 1) * FRAME])
                         for i in range(nfr)])

    def decode(self, bits: np.ndarray) -> np.ndarray:
        """bits: (k, 52) -> (k*320,) speech."""
        b = np.asarray(bits).reshape(-1, BITS_PER_FRAME)
        return np.concatenate([self.synth.synthesize(decode_frame_bits(row))
                               for row in b])
