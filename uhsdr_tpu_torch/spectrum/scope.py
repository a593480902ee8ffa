"""Spectrum scope / waterfall analytics, dBm estimation, SNAP carrier
tuner, zoom FFT.

The counterpart of `uhsdr_tpu.spectrum.scope` (reference
`drivers/ui/lcd/ui_spectrum.c`): Hann window -> 256/512/1024-point FFT ->
magnitude -> IIR time averaging -> quadrant reorder -> dBm
(`UiSpectrum_CalculateDBm`: 19.8 log10 of the passband's summed bins) and
SNAP (`UiSpectrum_CalculateSnap`: the peak bin and a 3-point
Jacobsen-Kootsookos interpolation, 0.2/0.8 smoothing), with the zoom FFT
(`audio_driver.c:1860-1909`: 2..32x by a lowpass and decimation ahead of
the FFT).

On the card the FFT is cuFFT (`ops/fftutil.py::cfft`; the JAX package
uses `jnp.fft` here, no Pallas kernel) and the zoom decimator is K5
(`cuda/fir.py::fir_rt`, the real-tap decimating front), whose carry is
its raw history, the JAX package's complex ``zoom_carry``.  The input is
the RX chain's ``spectrum_iq`` tap, (i, q) planes (int16 meaning counts /
32768, or f32), or a complex tensor.  Without zoom only the last
``fft_len`` samples of a block are read; the JAX package concatenates
the whole tail and block first (scope.py:117), with the same result.

Reference quirk, kept: ``IQ_RATE`` fixes the bin width at 48 kHz whatever
the capture rate, so at 96 kHz dBm and SNAP use a 48 kHz bin width.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..chain.rx import _planes, resolve_device
from ..cuda import fir as fir_k
from ..ops import design, fftutil

IQ_RATE = 48000.0
DBM_SLOPE = 19.8
SCOPE_PREAMP_GAIN = 1.0
ZOOM_TAPS = 127


class ScopeParams(NamedTuple):
    fft_len: int            # 256 | 512 | 1024
    magnify: int            # 0..5 -> 1x..32x zoom
    avg_alpha: float        # spectrum IIR averaging constant
    dbm_constant: float
    translate_hz: float
    f_lo: float             # filter passband (audio Hz)
    f_hi: float
    mode: str               # usb | lsb | am | sam | cw | fm
    zoom_fir: np.ndarray | None


def make_params(fft_len: int = 256, magnify: int = 0,
                avg_alpha: float = 0.25, dbm_constant: float = 0.0,
                translate_hz: float = 6000.0, f_lo: float = 150.0,
                f_hi: float = 2850.0, mode: str = "usb") -> ScopeParams:
    zoom_fir = None
    if magnify > 0:
        decim = 1 << magnify
        zoom_fir = design.decimation_fir(ZOOM_TAPS, decim,
                                         IQ_RATE).astype(np.float32)
    return ScopeParams(fft_len, magnify, avg_alpha, dbm_constant,
                       translate_hz, f_lo, f_hi, mode, zoom_fir)


class ScopeState(NamedTuple):
    iq_tail: torch.Tensor     # (C, fft_len) complex64 last IQ (post zoom)
    zoom_carry: torch.Tensor  # (C, taps-1) complex64 zoom raw history
    avg_mag: torch.Tensor     # (C, fft_len) f32 averaged magnitudes
    snap_freq: torch.Tensor   # (C,) f32 smoothed carrier estimate (Hz)


def init_state(batch_shape, params: ScopeParams, device=None) -> ScopeState:
    """Zero state on `device` (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    bs = tuple(batch_shape)
    taps = params.zoom_fir.shape[-1] - 1 if params.zoom_fir is not None \
        else 0
    c64 = dict(dtype=torch.complex64, device=dev)
    return ScopeState(
        iq_tail=torch.zeros(bs + (params.fft_len,), **c64),
        zoom_carry=torch.zeros(bs + (taps,), **c64),
        avg_mag=torch.zeros(bs + (params.fft_len,), dtype=torch.float32,
                            device=dev),
        snap_freq=torch.zeros(bs, dtype=torch.float32, device=dev))


def _passband_bins(params: ScopeParams):
    """(posbin, Lbin, Ubin, bin_bw) mirroring UiSpectrum_CalculateDBm."""
    n = params.fft_len
    decim = 1 << params.magnify
    bin_bw = IQ_RATE / decim / n
    # with fftshift layout, the dial (translate offset) sits ABOVE the
    # spectrum center by translate_hz
    bin_offset = params.translate_hz / bin_bw if params.magnify == 0 else 0.0
    posbin = n // 2 + bin_offset
    lo, hi = params.f_lo, params.f_hi
    if params.mode in ("am", "sam", "fm"):
        bw_lower, bw_upper = -hi, hi
    elif params.mode == "lsb":
        bw_lower, bw_upper = -hi, -lo
    else:
        bw_lower, bw_upper = lo, hi
    lbin = int(np.clip(round(posbin + bw_lower / bin_bw), 0, n - 1))
    ubin = int(np.clip(round(posbin + bw_upper / bin_bw), lbin + 1, n - 1))
    return posbin, lbin, ubin, bin_bw


@functools.lru_cache(maxsize=None)
def _on_device(values: bytes, device: torch.device) -> torch.Tensor:
    """An f32 table (the window, the zoom taps) on `device`, copied there
    once: a copy from the host a block would wait for the card."""
    return torch.frombuffer(bytearray(values), dtype=torch.float32).to(device)


def _complex(iq, n: int) -> torch.Tensor:
    """The last n samples of the block as complex64 (int16 planes
    scaled by 1/32768)."""
    if not isinstance(iq, tuple):
        return iq[..., max(0, iq.shape[-1] - n):].to(torch.complex64)
    i, q = (p[..., max(0, p.shape[-1] - n):] for p in iq)
    return torch.complex(*fir_k.scale_planes(i, q))


def process(params: ScopeParams, state: ScopeState, iq):
    """iq: the raw (pre-translate) IQ of a block, (C, T): the chain's
    ``spectrum_iq`` planes or a complex tensor, the reference's 48 kHz
    tap.  Returns (outputs, new_state); outputs: ``spectrum`` (C,
    fft_len) averaged linear magnitudes (fftshifted, ascending
    frequency), ``dbm`` (C,) the passband power estimate, ``dbm_hz``
    (C,), ``snap_freq`` (C,) the carrier offset estimate (Hz, relative to
    the dial)."""
    n = params.fft_len
    zoom_carry = state.zoom_carry
    if params.magnify > 0:
        i, q = _planes(iq)
        h = _on_device(params.zoom_fir.tobytes(), zoom_carry.device)
        z, zoom_carry, _ = fir_k.fir_rt(h, zoom_carry, i.contiguous(),
                                        q.contiguous(), 1 << params.magnify)
    else:
        z = _complex(iq, n)
    if z.shape[-1] < n:
        z = torch.cat([state.iq_tail, z], dim=-1)[..., -n:]
    else:
        z = z[..., z.shape[-1] - n:]
    win = _on_device(fftutil.hann(n).tobytes(), z.device)
    mag = fftutil.cfft(z * win, n).abs()
    # fftshift so bins ascend in frequency (reference reorders quadrants)
    mag = torch.roll(mag, n // 2, dims=-1)
    avg = state.avg_mag + params.avg_alpha * (mag - state.avg_mag)

    posbin, lbin, ubin, bin_bw = _passband_bins(params)
    band = avg[..., lbin:ubin + 1] * SCOPE_PREAMP_GAIN
    sum_db = band.sum(-1)
    dbm = torch.where(
        sum_db > 0,
        DBM_SLOPE * torch.log10(torch.clamp(sum_db, min=1e-20))
        + (params.dbm_constant - 225.0 - (3.0 if n == 1024 else 0.0)),
        -145.0)
    dbm_hz = dbm - 10.0 * np.log10((ubin - lbin) * bin_bw)

    # --- SNAP carrier estimate ---
    maxbin = torch.clamp(band.argmax(-1) + lbin, 1, n - 2)
    b1, b2, b3 = (avg.gather(-1, (maxbin + d)[..., None])[..., 0]
                  for d in (-1, 0, 1))
    denom = torch.clamp(b1 + b2 + b3, min=1e-8)
    delta2 = bin_bw * (1.36 * (b3 - b1)) / denom
    delta2 = torch.where(delta2.abs() > bin_bw, 0.0, delta2)
    # (no reference "+1" here: that term compensates its quadrant-reorder
    # indexing, which the fftshift layout doesn't have)
    delta1 = (maxbin - posbin) * bin_bw
    snap = 0.2 * (delta1 + delta2) + 0.8 * state.snap_freq
    new_state = ScopeState(iq_tail=z, zoom_carry=zoom_carry, avg_mag=avg,
                           snap_freq=snap)
    return ({"spectrum": avg, "dbm": dbm, "dbm_hz": dbm_hz,
             "snap_freq": snap}, new_state)


def waterfall_row(spectrum: torch.Tensor, floor_db: float = -20.0,
                  range_db: float = 60.0) -> torch.Tensor:
    """Log-scale a spectrum row to 0..255 palette indices (the reference's
    waterfall palette mapping, `ui_spectrum.c:1099+`)."""
    db = 20.0 * torch.log10(torch.clamp(spectrum, min=1e-12))
    scaled = (db - floor_db) / range_db
    return torch.clamp(scaled * 255.0, 0.0, 255.0).to(torch.float32)


class WaterfallImage:
    """Rolling waterfall display buffer with automatic floor tracking (a
    copy of the JAX package's NumPy class; `ui_spectrum.c:1099-1348`,
    floor AGC around `:1466-1500`): a (rows, fft_len) uint8 image of
    palette indices for one channel; the floor tracks the 10th percentile
    of each row with one-pole smoothing."""

    def __init__(self, fft_len: int, rows: int = 128, range_db: float = 60.0,
                 floor_alpha: float = 0.1):
        self.image = np.zeros((rows, fft_len), np.uint8)
        self.range_db = float(range_db)
        self.floor_alpha = float(floor_alpha)
        self.floor_db = -20.0
        self._filled = 0

    def push(self, spectrum) -> None:
        """spectrum: (fft_len,) linear magnitudes (one channel; a tensor
        or an array)."""
        if isinstance(spectrum, torch.Tensor):
            spectrum = spectrum.detach().cpu().numpy()
        db = 20.0 * np.log10(np.maximum(np.asarray(spectrum), 1e-12))
        target_floor = float(np.percentile(db, 10.0))
        self.floor_db += self.floor_alpha * (target_floor - self.floor_db)
        row = np.clip((db - self.floor_db) / self.range_db * 255.0,
                      0.0, 255.0).astype(np.uint8)
        self.image = np.roll(self.image, 1, axis=0)
        self.image[0] = row
        self._filled = min(self._filled + 1, self.image.shape[0])


# S-meter: dBm -> S units (the reference's FFT/dBm-based S-meter path,
# `ui_driver.c:241-275` S_Meter_Cal_dbm: S1 = -121 dBm, 6 dB per S-unit
# to S9 = -73 dBm, then 5 dB per displayed "+dB over S9" step)
def dbm_to_s_units(dbm) -> torch.Tensor:
    """Returns fractional S-units (1.0 = S1 ... 9.0 = S9; above S9 each
    +5 dB adds 1.0, i.e. 10.0 = S9+5, 11.0 = S9+10 ...)."""
    dbm = torch.as_tensor(dbm, dtype=torch.float32)
    below = 9.0 + (dbm - (-73.0)) / 6.0          # 6 dB per S-unit
    above = 9.0 + (dbm - (-73.0)) / 5.0          # 5 dB per +step
    s = torch.where(dbm <= -73.0, below, above)
    return torch.clamp(s, 0.0, 9.0 + 15.0)


def state_to_numpy(state: ScopeState) -> dict:
    """The JAX package's ScopeState layout as NumPy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def state_from_numpy(s, device=None) -> ScopeState:
    """A ScopeState (or its dict, JAX or NumPy leaves) on `device`."""
    dev = resolve_device(device)
    s = s._asdict() if hasattr(s, "_asdict") else s
    dts = {"avg_mag": np.float32, "snap_freq": np.float32}
    return ScopeState(**{k: torch.from_numpy(np.array(
        s[k], dts.get(k, np.complex64))).to(dev)
        for k in ScopeState._fields})
