"""Reference firmware coefficient tables, imported as data.

A copy of the loaders in `uhsdr_tpu.data` that the port reads, over
copies of its data files (`ref_filters.npz`, `ref_paths.json`,
generated by ``tools/parse_ref_filters.py`` from the UHSDR reference's
`drivers/audio/filters/*.c` and `audio_filter.c`; `digimode_tables.npz`,
by ``tools/parse_digimode_tables.py``; FreeDV's `freedv_ref.npz`,
`ldpc_ref.npz`, `codec2_cb.npz` and `newamp1_cb.npz`).  The port keeps its
own copy so that it imports nothing of the JAX package.  All arrays are
float64 (the C sources are decimal literals); consumers cast to f32 at
the chain boundary, as the firmware's float32_t arithmetic does.
"""
from __future__ import annotations

import functools
import json
import pathlib

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent


@functools.lru_cache(maxsize=1)
def _npz():
    return np.load(_DIR / "ref_filters.npz")


@functools.lru_cache(maxsize=1)
def _meta() -> dict:
    return json.loads((_DIR / "ref_paths.json").read_text())


@functools.lru_cache(maxsize=1)
def _freedv_npz():
    return np.load(_DIR / "freedv_ref.npz")


def freedv(name: str) -> np.ndarray:
    """FreeDV reference data (tools/parse_freedv_vectors.py):
    ``test_iq``, ``gt_alpha5_root``, ``pilot_coeff``, ``test_bits``."""
    return np.asarray(_freedv_npz()[name])


@functools.lru_cache(maxsize=1)
def ldpc():
    """HRA_112_112 LDPC code tables from the reference
    (tools/parse_ldpc_ref.py): ``H_rows``, ``H_cols``, ``input``,
    ``detected``."""
    return np.load(_DIR / "ldpc_ref.npz")


@functools.lru_cache(maxsize=1)
def _codec2_cb():
    """Codec2 scalar LSP quantiser codebooks (CODEC2_MODE_1300), imported
    from the reference's generated `codebook.c` by
    ``tools/parse_codec2_codebooks.py``."""
    return np.load(_DIR / "codec2_cb.npz")


@functools.lru_cache(maxsize=1)
def newamp1_codebooks():
    """newamp1 rate-K amplitude VQ (CODEC2_MODE_700C): ``vq1``/``vq2``
    (512, 20) two-stage codebooks and ``energy`` (16,) scalar mean
    quantiser, imported from the reference's generated
    `codebooknewamp1.c` / `codebooknewamp1_energy.c` by
    ``tools/parse_codec2_codebooks.py``."""
    return np.load(_DIR / "newamp1_cb.npz")


@functools.lru_cache(maxsize=1)
def digimode_tables():
    """Digital-mode TX lookup tables: ``ascii2baudot`` (128,) uint8
    (rtty.c Ascii2Baudot, charset flag in bit 5), ``psk_varicode``
    (256,) uint16 (psk.c fldigi varicode, MSB-first), ``cw_sm_table``
    (128,) f64 (cw_gen.c keying envelope smoothing table)."""
    return np.load(_DIR / "digimode_tables.npz")


def array(name: str) -> np.ndarray:
    """A named coefficient array (e.g. ``i_rx_new_coeffs``)."""
    return np.asarray(_npz()[name])


def fir(name: str, num_taps: int | None = None) -> np.ndarray:
    """A FIR impulse response in NATURAL order (h[0] = first tap).

    CMSIS stores pCoeffs time-reversed; `arm_fir_f32` computes
    y[n] = sum_j c[j]·x[n-(N-1)+j], i.e. the impulse response is
    reversed(pCoeffs).  Returns h with y[n] = sum_m h[m]·x[n-m].
    """
    c = array(name)
    if num_taps is not None:
        c = c[:num_taps]
    return c[::-1].copy()


def decimator(name: str) -> np.ndarray:
    """Decimation FIR impulse response (natural order).  CMSIS
    `arm_fir_decimate_f32` keeps phase 0: y[k] = filtered[k*M]."""
    inst = _meta()["instances"][name]
    assert inst["kind"] == "fir_decimate"
    return fir(name + "__pCoeffs", inst["numTaps"])


def interpolator(name: str, rate: int) -> tuple[np.ndarray, int]:
    """(impulse response in natural order, num_taps) for
    `arm_fir_interpolate_f32` with L = ``rate``.  The firmware passes the
    instance's ``phaseLength`` field as the init call's numTaps argument
    (`audio_driver.c:1213-1218`), so the stored table length IS the total
    tap count."""
    inst = _meta()["instances"][name]
    assert inst["kind"] == "fir_interpolate"
    num_taps = inst["phaseLength"]
    c = array(name + "__pCoeffs")[:num_taps]
    return c[::-1].copy(), num_taps


def interp_passband_gain(name: str, rate: int,
                         fs: float = 48000.0) -> float:
    """Mean passband magnitude response of a reference interpolation
    filter (evaluated at the interpolated rate over 300-2000 Hz).  Its
    tables do not embed the x`rate` gain that compensates zero-stuffing,
    unlike `ops.design.interpolation_fir`: the legacy front folds the
    ratio into its post-AGC scale to land at the firmware's level."""
    h, _ = interpolator(name, rate)
    n = np.arange(len(h))
    f = np.linspace(300.0, 2000.0, 18)
    H = np.abs(np.exp(-2j * np.pi * np.outer(f, n) / fs) @ h)
    return float(H.mean())


def lattice(name: str) -> tuple[np.ndarray, np.ndarray]:
    """(pkCoeffs, pvCoeffs) for an `arm_iir_lattice_instance_f32`, in the
    CMSIS storage order the recurrence consumes directly."""
    inst = _meta()["instances"][name]
    assert inst["kind"] == "iir_lattice"
    n = inst["numStages"]
    return array(name + "__pk")[:n], array(name + "__pv")[:n + 1]


BW_KEYS = {  # FilterInfo id -> bw_key (chain/filterpaths.py naming)
    "AUDIO_300HZ": "300HZ", "AUDIO_500HZ": "500HZ", "AUDIO_1P4KHZ": "1P4KHZ",
    "AUDIO_1P6KHZ": "1P6KHZ", "AUDIO_1P8KHZ": "1P8KHZ", "AUDIO_2P1KHZ": "2P1KHZ",
    "AUDIO_2P3KHZ": "2P3KHZ", "AUDIO_2P5KHZ": "2P5KHZ", "AUDIO_2P7KHZ": "2P7KHZ",
    "AUDIO_2P9KHZ": "2P9KHZ", "AUDIO_3P2KHZ": "3P2KHZ", "AUDIO_3P4KHZ": "3P4KHZ",
    "AUDIO_3P6KHZ": "3P6KHZ", "AUDIO_3P8KHZ": "3P8KHZ", "AUDIO_4P0KHZ": "4P0KHZ",
    "AUDIO_4P2KHZ": "4P2KHZ", "AUDIO_4P4KHZ": "4P4KHZ", "AUDIO_4P6KHZ": "4P6KHZ",
    "AUDIO_4P8KHZ": "4P8KHZ", "AUDIO_5P0KHZ": "5P0KHZ", "AUDIO_5P5KHZ": "5P5KHZ",
    "AUDIO_6P0KHZ": "6P0KHZ", "AUDIO_6P5KHZ": "6P5KHZ", "AUDIO_7P0KHZ": "7P0KHZ",
    "AUDIO_7P5KHZ": "7P5KHZ", "AUDIO_8P0KHZ": "8P0KHZ", "AUDIO_8P5KHZ": "8P5KHZ",
    "AUDIO_9P0KHZ": "9P0KHZ", "AUDIO_9P5KHZ": "9P5KHZ", "AUDIO_10P0KHZ": "10P0KHZ",
}


def find_path(mode: str, bw_key: str, select_id: int | None = None,
              name: str | None = None) -> dict:
    """Look up a FilterPathInfo row.  ``mode`` uses the chain naming
    (usb/lsb/cw map to the firmware's SSB/CW filter modes,
    `AudioFilter_GetFilterModeFromDemodMode`)."""
    fmode = {"usb": "ssb", "lsb": "ssb", "ssbstereo": "ssb",
             "iq": "ssb"}.get(mode, mode)
    rows = [p for p in _meta()["paths"]
            if fmode in p["modes"] and BW_KEYS.get(p["bw_id"]) == bw_key]
    if name is not None:
        rows = [p for p in rows if p["name"] == name]
    if select_id is not None:
        rows = [p for p in rows if p["select_id"] == select_id]
    if not rows:
        raise KeyError(f"no reference path for mode={mode} bw={bw_key}")
    return rows[0]


def uses_decimated_iq(path: dict, mode: str) -> bool:
    """The reference's front-end structure switch (`audio_driver.c:2718`):
    narrow SSB/CW paths (the i_rx_new high-suppression Hilbert set)
    decimate IQ before the Hilbert pair; AM/SAM always decimate first;
    wide SSB Hilberts at 48 kHz and decimates the demodulated audio."""
    if mode in ("am", "sam"):
        return True
    if mode == "fm":
        return False
    return path["fir_i"] == "i_rx_new_coeffs"
