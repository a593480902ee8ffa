"""OFDM modem — FreeDV 700D's waveform, BIT- AND WAVEFORM-COMPATIBLE
with the reference's `drivers/freedv/ofdm.c`.

Reference waveform (defaults from `ofdm_create`, `ofdm.c:153-230`):

  * Fs 8000, Ts 18 ms -> Rs = 55.5556 Hz symbol/carrier spacing,
    M = Fs/Rs = 144 core samples, Ncp = 16 cyclic-prefix samples
    -> 160 samples/symbol;
  * Nc = 17 QPSK data carriers; the carrier DFT spans Nc+2 = 19 bins at
    frequencies (nlower + col) * Rs with nlower = round(1500/Rs - Nc/2)
    = 19 (`ofdm.c:303-306`), i.e. 1055.6..2055.6 Hz;
  * modem frame = Ns = 8 symbols: row 0 carries BPSK pilots on all 19
    carriers (`pilotvalues`, `ofdm.c:70-79`), rows 1..7 carry Nc QPSK
    symbols each on the middle carriers (edge carriers zero,
    `ofdm_txframe`, `ofdm.c:706-775`);
  * 238 bits/frame; Gray QPSK constellation [1, j, -j, -1] with
    index = (bits[2i] << 1) | bits[2i+1] (`ofdm_mod`, `ofdm.c:839-864`;
    `qpsk_mod/qpsk_demod`, `ofdm.c:127-138`);
  * synthesis = explicit carrier-matrix IDFT scaled 1/M (`idft`,
    `ofdm.c:515-541`), CP = last Ncp samples copied in front.

Interop proof: `tests/test_freedv_interop.py::test_ofdm_reference_
modulator_demodulates` demodulates golden vectors produced by the
reference's own `ofdm_mod` COMPILED FROM the reference firmware's source
(`tools/gen_ofdm_ref.c`) with zero bit errors.

OFDM is the most TPU-friendly waveform here (mod/demod are carrier-
matrix matmuls), but like the FDMDV stack it runs host-side off the hot
IQ path, matching the reference's deferred-processing design.

A copy of the JAX package's NumPy module of the same name (the port
imports nothing of that package): the same arrays and decisions,
its data read from the port's own `data` package.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

FS = 8000.0
TS = 0.018
RS = 1.0 / TS                    # 55.5556 Hz
M = int(FS / RS)                 # 144 core samples
NCP = 16
SYMBOL = M + NCP                 # 160 samples
NC = 17                          # QPSK data carriers
NS = 8                           # symbols per frame (1 pilot + 7 data)
DATA_SYMBOLS = NS - 1
FRAME_SYMBOLS = NS
FRAME_SAMPLES = NS * SYMBOL      # 1280 = 160 ms
BITS_PER_SYMBOL = NC * 2         # 34
BITS_PER_FRAME = DATA_SYMBOLS * BITS_PER_SYMBOL   # 238
# C roundf rounds half AWAY from zero: roundf(18.5) = 19 (Python's
# banker's round would give 18 and shift every carrier one bin)
NLOWER = int(np.floor(1500.0 / RS - NC / 2.0 + 0.5))          # 19

# ofdm.c:70-79 (first Nc+2 entries used)
_PILOTVALUES = np.array([
    -1, -1, 1, 1, -1, -1, -1, 1,
    -1, 1, -1, 1, 1, 1, 1, 1,
    1, 1, 1, -1, -1, 1, -1, 1,
    -1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, -1, 1, 1, 1, 1,
    1, -1, -1, -1, -1, -1, -1, 1,
    -1, 1, -1, 1, -1, -1, 1, -1,
    1, 1, 1, 1, -1, 1, -1, 1], np.float64)
PILOTS = _PILOTVALUES[:NC + 2].astype(np.complex128)      # (19,)

# Gray QPSK (ofdm.c:60-65)
_QPSK = np.array([1.0, 1.0j, -1.0j, -1.0], np.complex128)

# carrier synthesis matrix: W[col, row] = exp(j*2pi*(NLOWER+col)*row/M)
_COLS = NLOWER + np.arange(NC + 2)
_W = np.exp(2j * np.pi * _COLS[:, None] * np.arange(M)[None, :] / M)


def _synth_symbol(carriers: np.ndarray) -> np.ndarray:
    """(Nc+2,) carrier values -> (SYMBOL,) time samples with CP
    (idft + CP copy, ofdm.c:515-541, 744-762)."""
    core = (carriers @ _W) / M
    return np.concatenate([core[-NCP:], core])


_PILOT_WAVE = _synth_symbol(PILOTS)


def _dft_carriers(core: np.ndarray) -> np.ndarray:
    """(M,) core samples -> (Nc+2,) carrier values (matched to the
    synthesis scaling: a clean symbol returns its carrier values)."""
    return (np.conj(_W) @ core)


@dataclass
class OfdmModulator:
    """One frame per call: bits (238,) -> (1280,) complex baseband —
    sample-exact vs the reference `ofdm_mod`."""

    def modulate_frame(self, bits: np.ndarray) -> np.ndarray:
        bits = np.asarray(bits).astype(int).reshape(-1)
        assert bits.shape == (BITS_PER_FRAME,)
        idx = (bits[0::2] << 1) | bits[1::2]              # (119,)
        syms = _QPSK[idx].reshape(DATA_SYMBOLS, NC)
        out = [_PILOT_WAVE]
        for s in range(DATA_SYMBOLS):
            row = np.zeros(NC + 2, np.complex128)
            row[1:NC + 1] = syms[s]
            out.append(_synth_symbol(row))
        return np.concatenate(out).astype(np.complex64)


def _qpsk_slice(eq: np.ndarray) -> np.ndarray:
    """Equalized symbols (..., NC) -> bits (..., NC, 2) in tx order
    (qpsk_demod, ofdm.c:133-138: rotate +45deg; b_first = imag<0,
    b_second = real<0)."""
    rot = eq * np.exp(1j * np.pi / 4)
    b_first = (rot.imag < 0).astype(np.uint8)
    b_second = (rot.real < 0).astype(np.uint8)
    return np.stack([b_first, b_second], axis=-1)


@dataclass
class OfdmDemodulator:
    """Streaming RX: frame sync by pilot correlation, pilot-aided
    coherent demod of the reference waveform, hardened for HF channels
    (the role of the reference's sync state machine, `ofdm.c:900-1100`):

      * CHANNEL TRACKING: the per-carrier estimate is linearly
        interpolated between THIS frame's pilot row and the NEXT frame's
        (one-frame lookahead, like the reference's rx buffer) so Doppler
        rotation over the 160 ms frame doesn't stale the equalizer;
      * MAX-RATIO soft metrics: data symbols are combined as
        carr * conj(h) (no division — deep fades weight DOWN instead of
        amplifying noise) and exported as LLRs for the LDPC decoder;
      * continuous-phase frequency derotation with pilot-phase tracking
        (CP-based estimate only for acquisition; the cyclic prefix
        correlates with ISI under multipath);
      * per-frame +-8-sample timing drift search and quality-gated
        resync.

    `demod()` returns (hard_bits, snr_estimates); the matching soft
    LLRs for each returned frame are appended to `self.llrs`.
    """
    foff_hz: float = 0.0
    in_sync: bool = False
    _buf: np.ndarray = field(default_factory=lambda: np.zeros(0, np.complex64))
    frames: int = 0
    _pend: tuple | None = None        # (data_carr (7,NC+2), hest (19,))
    _phase: float = 0.0               # continuous derotation phase
    _sync_frames: int = 0
    _bad_frames: int = 0
    llrs: list = field(default_factory=list)

    def _pilot_quality(self, seg: np.ndarray) -> float:
        p = _PILOT_WAVE / np.linalg.norm(_PILOT_WAVE)
        return float(abs(np.vdot(p, seg)) / (np.linalg.norm(seg) + 1e-12))

    # coarse acquisition frequency grid: +-40 Hz in 4 Hz steps — the
    # residual (<=2 Hz) is inside the inter-pilot phase tracker's
    # unambiguous range (+-1/(2*0.16s) = +-3.1 Hz)
    _FREQS = np.arange(-40.0, 41.0, 4.0)

    @staticmethod
    def _rotated_pilots():
        n = np.arange(SYMBOL)
        waves = _PILOT_WAVE[None, :] * np.exp(
            2j * np.pi * OfdmDemodulator._FREQS[:, None] * n[None, :] / FS)
        return waves / np.linalg.norm(_PILOT_WAVE)

    def _find_pilot(self, sig: np.ndarray) -> tuple[int, float, float]:
        """Joint coarse (timing, frequency) search: correlate every
        candidate offset against the pilot wave rotated over _FREQS
        (a 15 Hz offset rotates 108 deg across the 20 ms symbol and
        halves the unrotated correlation — the reference's coarse sync
        also searches timing x frequency, ofdm.c:900-1000)."""
        if not hasattr(self, "_pw_rot"):
            self._pw_rot = self._rotated_pilots()
        n = len(sig) - SYMBOL

        def score(off):
            """Noncoherent combination over the pilot at `off` AND the
            next frame's pilot — one faded pilot can't mislead the
            frequency bin choice."""
            seg = sig[off: off + SYMBOL]
            qs = np.abs(self._pw_rot.conj() @ seg) \
                / (np.linalg.norm(seg) + 1e-12)
            off2 = off + FRAME_SAMPLES
            if off2 + SYMBOL <= len(sig):
                seg2 = sig[off2: off2 + SYMBOL]
                qs = qs + np.abs(self._pw_rot.conj() @ seg2) \
                    / (np.linalg.norm(seg2) + 1e-12)
                qs = qs * 0.5
            k = int(np.argmax(qs))
            return float(qs[k]), float(self._FREQS[k])

        best = (0, -1.0, 0.0)
        for off in range(0, min(n, FRAME_SAMPLES), 4):
            q, f = score(off)
            if q > best[1]:
                best = (off, q, f)
        off0, _, f0 = best
        for off in range(max(0, off0 - 4), min(n, off0 + 5)):
            q, f = score(off)
            if q > best[1]:
                best = (off, q, f)
        return best

    def _cp_freq_estimate(self, sym: np.ndarray) -> float:
        corr = np.vdot(sym[:NCP], sym[M: M + NCP])
        return float(np.angle(corr) / (2 * np.pi * M / FS))

    def _emit(self, data_carr, h0, h1, bits_out, snrs):
        """Equalize 7 data symbols with per-carrier channel interpolated
        from pilot h0 (frame start) toward h1 (next frame's pilot; h1 may
        equal h0 on flush)."""
        rows = []
        for s in range(DATA_SYMBOLS):
            w = (s + 1) / float(NS)
            h = (1.0 - w) * h0 + w * h1
            # max-ratio metric: carr*conj(h) — equalization + |h|^2
            # reliability weighting in one step, fade-safe
            rows.append(data_carr[s, 1:NC + 1] * np.conj(h[1:NC + 1]))
        met = np.stack(rows)                         # (7, NC)
        rot = met * np.exp(1j * np.pi / 4)
        b_first = (rot.imag < 0).astype(np.uint8)
        b_second = (rot.real < 0).astype(np.uint8)
        bits = np.stack([b_first, b_second], axis=-1).reshape(-1)
        scale = 4.0 / (np.sqrt(np.mean(np.abs(met) ** 2)) + 1e-12)
        llr = np.stack([rot.imag, rot.real], axis=-1).reshape(-1) * scale
        bits_out.append(bits)
        self.llrs.append(llr)
        # EVM-style SNR from the normalized constellation
        hm = np.abs(met)
        nz = hm > 1e-9
        evm = float(np.mean(np.abs(
            met[nz] / hm[nz]
            - _QPSK[(b_first[nz].astype(int) << 1)
                    | b_second[nz].astype(int)]) ** 2)) + 1e-9
        snr_est = 10 * np.log10(1.0 / evm)
        snrs.append(snr_est)
        self.frames += 1
        # aliased-lock / lost-channel watchdog: a tracker caught on the
        # +-6.25 Hz inter-pilot alias rotates the constellation 45 deg
        # per symbol — EVM collapses while pilot correlation stays fine.
        # Two consecutive hopeless frames force re-acquisition.
        if snr_est < 4.0:
            self._bad_frames += 1
            if self._bad_frames >= 2:
                self.in_sync = False
                self._bad_frames = 0
        else:
            self._bad_frames = 0

    def _derotate(self, frame: np.ndarray) -> np.ndarray:
        n = np.arange(len(frame))
        out = frame * np.exp(-1j * (self._phase
                                    + 2 * np.pi * self.foff_hz * n / FS))
        self._phase = float(np.mod(
            self._phase + 2 * np.pi * self.foff_hz * len(frame) / FS,
            2 * np.pi))
        return out

    def demod(self, sig: np.ndarray):
        """Append samples; demodulate every complete synced frame (with
        one frame of channel-interpolation lookahead — call `flush()` at
        stream end for the final frame).
        Returns (bits (n_frames, 238) uint8, snr_estimates (n_frames,))."""
        self._buf = np.concatenate([self._buf,
                                    np.asarray(sig, np.complex64)])
        bits_out, snrs = [], []
        while True:
            if not self.in_sync:
                self._pend = None
                if len(self._buf) < 2 * FRAME_SAMPLES:
                    break
                off, q, f0 = self._find_pilot(self._buf[:2 * FRAME_SAMPLES])
                if q < 0.35:       # noise-only floor ~0.08
                    self._buf = self._buf[FRAME_SAMPLES:]
                    continue
                self._buf = self._buf[off:]
                self.in_sync = True
                self._phase = 0.0
                self.foff_hz = f0
                self._sync_frames = 0
            if len(self._buf) < FRAME_SAMPLES + 16:
                break
            # per-frame timing refinement (+-8 samples of drift)
            best_d, best_q = 0, -1.0
            derot = np.exp(-2j * np.pi * self.foff_hz
                           * np.arange(SYMBOL) / FS)
            for d in range(-8, 9):
                if d < 0 and self.frames == 0:
                    continue
                seg = self._buf[max(d, 0): max(d, 0) + SYMBOL]
                if len(seg) < SYMBOL:
                    continue
                q = self._pilot_quality(seg * derot)
                if q > best_q:
                    best_q, best_d = q, d
            if best_q < 0.1:
                self.in_sync = False
                self._buf = self._buf[FRAME_SAMPLES:]
                continue
            if best_d > 0:
                self._buf = self._buf[best_d:]
            frame = self._derotate(self._buf[:FRAME_SAMPLES])
            self._buf = self._buf[FRAME_SAMPLES:]

            syms = frame.reshape(FRAME_SYMBOLS, SYMBOL)
            carr = np.stack([_dft_carriers(s[NCP:]) for s in syms])  # (8,19)
            hest = carr[0] / PILOTS                  # (19,) at frame start
            if float(np.mean(np.abs(hest))) < 1e-6:
                self.in_sync = False
                continue

            if self._pend is not None:
                pend_carr, h_prev = self._pend
                # pilot-phase frequency tracking: the common rotation of
                # the channel between consecutive pilots estimates the
                # residual offset — but under fading the channel phase
                # itself random-walks, so the loop must be WEAK (gain
                # 0.1: estimator noise ~0.1 Hz at 1 Hz Doppler while
                # still tracking ~0.1 Hz/s drift), coherence-weighted
                # (fade transitions give garbage deltas) and clamped
                num = np.sum(np.conj(h_prev) * hest)
                den = float(np.sum(np.abs(h_prev) * np.abs(hest))) + 1e-30
                coh = abs(num) / den
                dphi = float(np.angle(num + 1e-30))
                # two-stage gain: fast pull-in of the coarse-grid
                # residual for the first frames, then weak tracking so
                # fading phase noise doesn't random-walk the estimate
                gain = 0.5 if self._sync_frames < 4 else 0.1
                self._sync_frames += 1
                self.foff_hz += gain * coh * dphi / (2 * np.pi
                                                     * FRAME_SAMPLES / FS)
                self._emit(pend_carr, h_prev, hest, bits_out, snrs)
            self._pend = (carr[1:], hest)
        if not bits_out:
            return (np.zeros((0, BITS_PER_FRAME), np.uint8), np.zeros(0))
        return np.stack(bits_out).astype(np.uint8), np.array(snrs)

    def flush(self):
        """Emit the final pending frame (equalized with its own pilot
        only).  Returns (bits, snrs) like `demod`."""
        if self._pend is None:
            return (np.zeros((0, BITS_PER_FRAME), np.uint8), np.zeros(0))
        bits_out, snrs = [], []
        pend_carr, h_prev = self._pend
        self._pend = None
        self._emit(pend_carr, h_prev, h_prev, bits_out, snrs)
        return np.stack(bits_out).astype(np.uint8), np.array(snrs)
