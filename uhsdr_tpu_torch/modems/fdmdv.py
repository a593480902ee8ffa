"""FDMDV multicarrier DQPSK modem — bit/waveform-compatible with the
reference's `drivers/freedv/fdmdv.c` (FreeDV 1600 mode).

Waveform parameters are the reference's EXACTLY (fdmdv_internal.h:43-76,
fdmdv_create `fdmdv.c:76-196`, fdmdv_set_fsep `:255-276`,
bits_to_dqpsk_symbols `:280-321`, tx_filter_and_upconvert `:430-520`):

  * FS=8000, RS=50 baud (M=160 samples/symbol), Nc=16 data carriers;
  * carrier c at (-Nc/2+c)*75 Hz for c<8 and (-Nc/2+c+1)*75 for c>=8,
    relative to the 1500 Hz centre; BPSK pilot at the centre, amplitude
    2x, alternating +,+,-,-,... (sign flip on odd frames — the frame
    parity beacon);
  * DQPSK mapping 00->x1, 01->xj, 10->x(-j), 11->x(-1) (the "new"
    mapping, old_qpsk_mapping=0);
  * pulse shaping with the exact `gt_alpha5_root` root-cosine table
    (rn.h, imported by tools/parse_freedv_vectors.py), x sqrt(2)/2
    symbol gain, x M filter gain, x2 output gain;
  * TX carrier phases spread as exp(j*2*pi*c/(Nc+1)) (PAPR).

TX is a sample-exact port of the semantics (validated by demodulating
the firmware's own recorded vectors with the same RX, and our TX with
the same RX — see tests/test_freedv_interop.py).  RX is our own
TPU-era design (batch matched filter + closed-form 50 Hz envelope
timing estimate, the same estimator class as rx_est_timing
`fdmdv.c:846-920`, pilot-FFT frequency acquisition) — interoperability
is proven on the reference's recorded off-air vectors
(`drivers/audio/freedv_test_data.c`).

Modulator output / demodulator input are the reference's complex
"passband" convention: carriers at 900..2100 Hz (fdmdv_mod's tx_fdm).

A copy of the JAX package's NumPy module of the same name (the port
imports nothing of that package): the same arrays and decisions,
its data read from the port's own `data` package.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import data as _refdata

FS = 8000
RS = 50
M = FS // RS          # 160 samples/symbol
NSYM = 6              # pulse spans 6 symbols
NC = 16               # FreeDV 1600: freedv_api.c:143
FSEP = 75.0
FCENTRE = 1500.0
P = 4                 # timing oversample factor (reference P)
PILOT_AMP = 2.0       # prev_tx_symbols[Nc].real = 2.0 (fdmdv.c:132)

BITS_PER_SYMBOL = NC * 2   # 32 -> 1600 bit/s


_GT = np.asarray(_refdata.freedv("gt_alpha5_root"), np.float64)
_NTAPS = _GT.size                     # 960 = NSYM * M
assert _NTAPS == NSYM * M

# polyphase TX matrix: GTP[j, i] = gt[M-1-i + j*M]
# (tx_filter_and_upconvert inner loop, fdmdv.c:465-475)
_GTP = np.stack([_GT[M - 1 - np.arange(M) + j * M] for j in range(NSYM)])

# carrier frequencies RELATIVE to centre (rad/sample omega and Hz)
_off = np.array([(-NC // 2 + c) if c < NC // 2 else (-NC // 2 + c + 1)
                 for c in range(NC)], np.float64) * FSEP
CARRIER_OFFSETS = np.concatenate([_off, [0.0]])       # (NC+1,), pilot last
CARRIER_FREQS = FCENTRE + _off
PILOT_FREQ = FCENTRE
_W = 2 * np.pi * CARRIER_OFFSETS / FS                 # rad/sample (baseband)
_WB = 2 * np.pi * FCENTRE / FS

# DQPSK phase-increment map (bits_to_dqpsk_symbols, new mapping):
# (msb,lsb): 00 -> *1, 01 -> *j, 11 -> *-1, 10 -> *-j
_INC = {(0, 0): 1.0 + 0j, (0, 1): 1j, (1, 1): -1.0 + 0j, (1, 0): -1j}


def bits_to_increments(bits: np.ndarray) -> np.ndarray:
    """(..., 2*NC) 0/1 -> (..., NC) complex phase increments."""
    b = np.asarray(bits).reshape(-1, NC, 2)
    msb, lsb = b[..., 0], b[..., 1]
    inc = np.where((msb == 0) & (lsb == 0), 1.0 + 0j,
                   np.where((msb == 0) & (lsb == 1), 1j,
                            np.where((msb == 1) & (lsb == 1), -1.0 + 0j,
                                     -1j)))
    return inc


def increments_to_bits(d: np.ndarray) -> np.ndarray:
    """(..., NC) complex diffs -> (..., NC*2) bits (nearest increment)."""
    ang = np.angle(d)
    q = np.round(ang / (np.pi / 2)).astype(int) % 4
    # q: 0 -> d~1 (00), 1 -> d~j (01), 2 -> d~-1 (11), 3 -> d~-j (10)
    msb = ((q == 2) | (q == 3)).astype(np.uint8)
    lsb = ((q == 1) | (q == 2)).astype(np.uint8)
    out = np.stack([msb, lsb], axis=-1)
    return out.reshape(out.shape[:-2] + (NC * 2,))


@dataclass
class FdmdvModulator:
    """Sample-exact fdmdv_mod: one call per 20 ms symbol/frame."""
    prev_symbols: np.ndarray = field(default_factory=lambda: np.concatenate(
        [np.ones(NC, complex), [PILOT_AMP + 0j]]))
    pilot_bit: int = 0
    filter_mem: np.ndarray = field(
        default_factory=lambda: np.zeros((NC + 1, NSYM), complex))
    phase: np.ndarray = field(default_factory=lambda: np.exp(
        2j * np.pi * np.arange(NC + 1) / (NC + 1)))
    fbb_phase: complex = 1.0 + 0j

    def modulate_symbol(self, bits: np.ndarray) -> np.ndarray:
        """bits: (32,) 0/1 -> (160,) complex passband (carriers at
        900..2100 Hz), fdmdv_mod semantics (sans FDMDV_SCALE)."""
        bits = np.asarray(bits).reshape(BITS_PER_SYMBOL)
        inc = bits_to_increments(bits)[0]               # (NC,)
        symbols = np.empty(NC + 1, complex)
        symbols[:NC] = self.prev_symbols[:NC] * inc
        # +1 -1 BPSK pilot: flip when pilot_bit set (fdmdv.c:311-320)
        symbols[NC] = (-self.prev_symbols[NC] if self.pilot_bit
                       else self.prev_symbols[NC])
        self.pilot_bit ^= 1
        self.prev_symbols = symbols

        # push gain-scaled symbol into the sparse filter memory
        # (tx_filter_memory[c][NSYM-1] = symbol * sqrt(2)/2, fdmdv.c:457)
        mem = np.empty_like(self.filter_mem)
        mem[:, :-1] = self.filter_mem[:, 1:]
        mem[:, -1] = symbols * (np.sqrt(2.0) / 2.0)
        # filter: bb[c, i] = M * sum_j mem[c, j] * gt[M-1-i + j*M]
        bb = M * np.einsum("cj,ji->ci", mem, _GTP)
        self.filter_mem = mem

        # per-carrier upconversion: phase advances BEFORE use ->
        # factor phase[c] * e^{j w_c (i+1)}
        i1 = np.arange(1, M + 1)
        carr = self.phase[:, None] * np.exp(1j * _W[:, None] * i1[None, :])
        fdm = (bb * carr).sum(axis=0)
        # centre upshift + output x2 (fdmdv.c:485-497)
        fbb = self.fbb_phase * np.exp(1j * _WB * i1)
        out = 2.0 * fdm * fbb
        # advance + renormalize oscillators
        self.phase = self.phase * np.exp(1j * _W * M)
        self.phase /= np.abs(self.phase)
        self.fbb_phase = self.fbb_phase * np.exp(1j * _WB * M)
        self.fbb_phase /= abs(self.fbb_phase)
        return out.astype(np.complex64)

    def modulate_frame(self, bits: np.ndarray) -> np.ndarray:
        """bits: (n_sym, 32) or flat multiple of 32 -> (n_sym*160,)."""
        b = np.asarray(bits).reshape(-1, BITS_PER_SYMBOL)
        return np.concatenate([self.modulate_symbol(row) for row in b])


@dataclass
class FdmdvDemodulator:
    """Batch/streaming RX: pilot-FFT frequency acquisition, matched
    filter (exact gt taps), closed-form 50 Hz envelope timing (the
    rx_est_timing estimator class), DQPSK decision."""
    foff_hz: float = 0.0
    acquired: bool = False
    prev_rx_symbols: np.ndarray = field(
        default_factory=lambda: np.ones(NC + 1, complex))
    buf: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.complex128))
    t0_abs: int = 0                   # absolute time of buf[0]
    timing: float | None = None       # symbol sampling phase in [0, M)
    timing_acc: complex = 0.0 + 0j    # envelope DFT accumulator
    timing_n: int = 0
    next_sample: float | None = None  # absolute time of next symbol centre
    rot: float = 0.0                  # residual per-symbol DQPSK rotation
    sync: bool = False

    def _mf_all(self, seg: np.ndarray, t0: int) -> np.ndarray:
        """Matched-filter all carriers over seg.  Returns (NC+1, L_valid)
        where output t corresponds to absolute sample t0+NTAPS-1+t."""
        n_abs = t0 + np.arange(len(seg))
        # downshift to per-carrier baseband with ABSOLUTE-time mixers
        # (all offsets are multiples of 25 Hz -> period 320 samples)
        mixer = np.exp(-1j * np.outer(_W + _WB, n_abs % 320))  # (NC+1, L)
        zb = mixer * seg[None, :]
        # correct for the frequency-offset estimate
        if self.foff_hz != 0.0:
            zb = zb * np.exp(-2j * np.pi * self.foff_hz * n_abs / FS)[None, :]
        from scipy.signal import fftconvolve
        mf = fftconvolve(zb, _GT[None, ::-1], mode="valid", axes=1)
        return mf

    def _acquire_freq(self, sig: np.ndarray) -> float:
        """Coarse frequency offset from the pilot.  The pilot's DBPSK
        pattern +,-,-,+,+,-,-,... has period 4 symbols (80 ms), putting
        its two spectral lines at +-Rs/4 = +-12.5 Hz around the centre;
        correlate the spectrum with that line pair."""
        n = len(sig)
        w = np.hanning(n)
        z = sig * np.exp(-2j * np.pi * FCENTRE * np.arange(n) / FS)
        nfft = 8 * n
        F = np.abs(np.fft.fftshift(np.fft.fft(z * w, nfft)))
        freqs = np.fft.fftshift(np.fft.fftfreq(nfft, 1 / FS))
        zone = (freqs > -200) & (freqs < 200)
        cand = freqs[zone]
        Fz = F[zone]
        df = freqs[1] - freqs[0]
        k = int(round(12.5 / df))
        score = Fz[:-2 * k] + Fz[2 * k:]
        i = int(np.argmax(score))
        return float(cand[i] + 12.5)

    def demod_symbols(self, sig: np.ndarray):
        """sig: (k*M,) complex passband (carriers at 900..2100 Hz).
        Returns (bits (n, 32), sync_flags (n,)) — sync flag True when the
        pilot flipped (odd frame, the 40 ms parity beacon)."""
        sig = np.asarray(sig, np.complex128)
        if not self.acquired and len(self.buf) + len(sig) >= 6 * M:
            probe = np.concatenate([self.buf, sig])[:8 * M]
            self.foff_hz = self._acquire_freq(probe)
            self.acquired = True

        seg = np.concatenate([self.buf, sig])
        if len(seg) < _NTAPS + M:
            self.buf = seg
            return (np.zeros((0, BITS_PER_SYMBOL), np.uint8),
                    np.zeros(0, bool))

        mf = self._mf_all(seg, self.t0_abs)       # (NC+1, L)
        L = mf.shape[1]
        # matched-filter output t aligns with absolute time base:
        mf_t0 = self.t0_abs + _NTAPS - 1          # abs time of mf[:, 0]

        # --- timing: DFT of the data-carrier envelope at 50 Hz ---
        env = np.abs(mf[:NC]).sum(axis=0)
        t_abs = mf_t0 + np.arange(L)
        self.timing_acc += np.sum(env * np.exp(-2j * np.pi * t_abs / M))
        self.timing_n += L
        if self.timing_n >= 4 * M:
            # envelope ~ A + B*cos(2*pi*(t - tau)/M)  =>
            # angle(DFT@50Hz) = -2*pi*tau/M
            ph = -(np.angle(self.timing_acc) / (2 * np.pi)) * M
            self.timing = float(ph % M)
            # decay so timing can track slow clock drift
            self.timing_acc *= 0.5
            self.timing_n //= 2

        if self.timing is None:
            self.buf = seg[-(_NTAPS + M):]
            self.t0_abs += len(seg) - len(self.buf)
            return (np.zeros((0, BITS_PER_SYMBOL), np.uint8),
                    np.zeros(0, bool))

        # symbol sampling instants: absolute times == timing (mod M)
        first = mf_t0
        k0 = int(np.ceil((first - self.timing) / M))
        bits_out, sync_out = [], []
        while True:
            t_samp = self.timing + k0 * M
            idx = int(round(t_samp - mf_t0))
            if idx >= L:
                break
            if self.next_sample is not None and t_samp <= self.next_sample - M / 2:
                k0 += 1
                continue
            z = mf[:, idx]
            d = z * np.conj(self.prev_rx_symbols)
            self.prev_rx_symbols = z
            # residual-frequency de-rotation: the pilot's diff is +-real,
            # so its angle mod pi is the common DQPSK rotation per symbol
            # (a small leftover foff rotates every d by the same angle)
            dp = d[NC]
            theta = np.angle(dp if dp.real >= 0 else -dp)
            self.rot = 0.9 * self.rot + 0.1 * theta
            dd = d[:NC] * np.exp(-1j * self.rot)
            bits_out.append(increments_to_bits(dd[None, :])[0])
            sync_out.append(bool(np.real(dp) < 0.0))
            self.next_sample = t_samp + M
            k0 += 1

        keep = _NTAPS + M
        self.buf = seg[-keep:]
        self.t0_abs += len(seg) - keep
        if not bits_out:
            return (np.zeros((0, BITS_PER_SYMBOL), np.uint8),
                    np.zeros(0, bool))
        return np.stack(bits_out), np.array(sync_out, bool)
