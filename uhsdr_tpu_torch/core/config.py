"""Configuration registry + persistence.

The reference persists a 144-row table of `ConfigEntryDescriptor`s
(`drivers/ui/ui_configuration.c:61-282`: {type, eeprom_id, ptr, default,
min, max}) through a 3-backend store (RAM / I2C EEPROM / flash-emulated
EEPROM, `misc/config_storage.c`, `misc/v_eprom/uhsdr_flash.c`), plus
band/VFO memories, with host-side backup via `uhsdr_tool.py`.

Here the same semantics — typed entries with defaults and min/max
clamping, grouped persistence, versioning — back a plain dict registry
with JSON save/load (the "EEPROM"), and streaming DSP state checkpointing
to .npz (which the reference does NOT have: its DSP state is rebuilt on
every chain switch, SURVEY §5 "Checkpoint/resume").

The registry, `BandMemories` and `Config` are copies of the JAX package's
(the port imports nothing of that package), over a copy of its
`data/ref_config.json`.  `save_state` / `load_state` write and read that
package's `.npz` layout, so a checkpoint of either package restores into
the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np

CONFIG_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ConfigEntry:
    name: str
    default: Any
    min: float | None = None
    max: float | None = None
    typ: type = int
    doc: str = ""
    choices: tuple = ()       # for str entries: CAT enumeration order
    ref_id: int | None = None  # the reference's real EEPROM id
                               # (ui_configuration.h) when the entry
                               # mirrors a firmware row

    def clamp(self, value):
        v = self.typ(value)
        if self.typ in (int, float):
            if self.min is not None:
                v = max(v, self.typ(self.min))
            if self.max is not None:
                v = min(v, self.typ(self.max))
        return v

    @property
    def eeprom_id(self) -> int:
        """16-bit variable id for the CAT/EEPROM transport: the
        reference's REAL EEPROM id (ui_configuration.h) when the entry
        mirrors a firmware row, else a stable synthetic id above the
        firmware's range."""
        if self.ref_id is not None:
            return self.ref_id
        return 0x1000 + REGISTRY.index(self)

    def cat_encode(self, value) -> int:
        """Encode a config value into the 16-bit CAT wire format:
        ints pass through, floats are x10 fixed-point, strings are their
        index in `choices`."""
        if self.typ is str:
            try:
                return self.choices.index(value)
            except ValueError:
                return 0
        if self.typ is float:
            return int(round(float(value) * 10.0)) & 0xFFFF
        return int(value) & 0xFFFF

    def cat_decode(self, raw: int):
        if self.typ is str:
            if 0 <= raw < len(self.choices):
                return self.choices[raw]
            return self.default
        if self.typ is float:
            if raw >= 0x8000:
                raw -= 0x10000
            return raw / 10.0
        if raw >= 0x8000 and self.min is not None and self.min < 0:
            raw -= 0x10000
        return raw


# Registry mirroring the DSP-relevant rows of the reference's table
# (ui_configuration.h EEPROM ids; hardware-only rows like LCD/PA bias have
# no equivalent here).
REGISTRY: list[ConfigEntry] = [
    ConfigEntry("audio_gain", 16, 0, 30, int, "AF gain"),
    ConfigEntry("rf_gain", 50, 0, 50, int),
    ConfigEntry("agc_mode", "med", typ=str,
                doc="very_long|long|slow|med|fast|off",
                choices=("very_long", "long", "slow", "med", "fast", "off")),
    ConfigEntry("agc_wdsp_thresh_db", 60.0, 0, 120, float),
    ConfigEntry("agc_wdsp_slope_db", 6.0, 0, 20, float),
    ConfigEntry("agc_wdsp_hang_time_ms", 250, 0, 5000, int),
    ConfigEntry("agc_wdsp_hang_enable", 0, 0, 1, int),
    ConfigEntry("dsp_nr_enable", 0, 0, 1, int),
    ConfigEntry("dsp_nr_strength", 141, 0, 200, int,
                doc="alpha = 0.799 + strength/1000"),
    ConfigEntry("dsp_notch_enable", 0, 0, 1, int),
    ConfigEntry("iq_freq_mode", 2, 0, 4, int,
                doc="0=off 1=+6k 2=-6k 3=+12k 4=-12k translate"),
    ConfigEntry("filter_bw_key", "2P3KHZ", typ=str,
                doc="all 31 bandwidth IDs (FilterInfo, audio_filter.c:47-80)",
                choices=("300HZ", "500HZ", "1P4KHZ", "1P6KHZ", "1P8KHZ",
                         "2P1KHZ", "2P3KHZ", "2P5KHZ", "2P7KHZ", "2P9KHZ",
                         "3P2KHZ", "3P4KHZ", "3P6KHZ", "3P8KHZ", "4P0KHZ",
                         "4P2KHZ", "4P4KHZ", "4P6KHZ", "4P8KHZ", "5P0KHZ",
                         "5P5KHZ", "6P0KHZ", "6P5KHZ", "7P0KHZ", "7P5KHZ",
                         "8P0KHZ", "8P5KHZ", "9P0KHZ", "9P5KHZ", "10P0KHZ")),
    ConfigEntry("filter_path_name", "LPF", typ=str,
                choices=("LPF", "BPF", "HILBERT", "FIR", "IIR")),
    ConfigEntry("dmod_mode", "usb", typ=str, doc="usb|lsb|cw|am|sam|fm",
                choices=("usb", "lsb", "cw", "am", "sam", "fm")),
    ConfigEntry("sam_pll_zeta_x100", 60, 10, 100, int),
    ConfigEntry("sam_pll_omega", 200, 50, 1000, int),
    ConfigEntry("sam_fmax", 500, 50, 1000, int),
    ConfigEntry("sam_sideband", "both", typ=str,
                choices=("both", "usb", "lsb", "stereo")),
    ConfigEntry("fade_leveler", 1, 0, 1, int),
    ConfigEntry("fm_sql_threshold", 0, 0, 24, int),
    ConfigEntry("fm_subaudible_tone_hz", 0.0, 0, 300, float),
    ConfigEntry("fm_dev_5khz", 0, 0, 1, int),
    ConfigEntry("cw_sidetone_freq", 700, 400, 1000, int),
    ConfigEntry("cw_speed_wpm", 20, 5, 48, int),
    ConfigEntry("cw_keyer_mode", "iambic_b", typ=str,
                choices=("iambic_a", "iambic_b", "ultimatic", "straight")),
    ConfigEntry("cw_decoder_thresh", 32000, 1000, 1000000, int),
    ConfigEntry("tx_comp_level", 2, -1, 13, int),
    ConfigEntry("tx_postfilt_gain", 4, 1, 25, int),
    ConfigEntry("rtty_shift_hz", 170.0, 85, 850, float),
    ConfigEntry("rtty_baud", 45.45, 45.45, 50.0, float),
    ConfigEntry("psk_speed", 31, 31, 125, int),
    ConfigEntry("spectrum_fft_len", 256, 256, 1024, int),
    ConfigEntry("spectrum_magnify", 0, 0, 5, int),
    ConfigEntry("spectrum_avg_alpha_x100", 25, 5, 100, int),
    ConfigEntry("dbm_constant", 0, -100, 100, int),
    ConfigEntry("iq_gain_balance_x1000", 0, -500, 500, int),
    ConfigEntry("iq_phase_balance_x1000", 0, -500, 500, int),
    ConfigEntry("beep_freq", 1000, 200, 3000, int),
    ConfigEntry("beep_volume", 10, 0, 20, int),
]

# --- the reference's full registry, imported as data -----------------------
# (tools/parse_ref_config.py <- ui_configuration.c:61-282; 156 rows incl.
# the macro-generated per-band power-factor and IQ-balance rows)

# curated entries above that MIRROR a firmware row: name -> EEPROM symbol.
# They get the real EEPROM id; the remaining firmware rows are generated.
_CURATED_REF = {
    "audio_gain": "EEPROM_AUDIO_GAIN",
    "agc_mode": "EEPROM_AGC_WDSP_MODE",
    "agc_wdsp_thresh_db": "EEPROM_AGC_WDSP_THRESH",
    "agc_wdsp_slope_db": "EEPROM_AGC_WDSP_SLOPE",
    "agc_wdsp_hang_enable": "EEPROM_AGC_WDSP_HANG",
    "dsp_nr_strength": "EEPROM_DSP_NR_STRENGTH",
    "iq_freq_mode": "EEPROM_FREQ_CONV_MODE",
    "fm_sql_threshold": "EEPROM_FM_SQUELCH_SETTING",
    "cw_sidetone_freq": "EEPROM_SIDETONE_FREQ",
    "cw_speed_wpm": "EEPROM_CW_KEYER_SPEED",
    "cw_keyer_mode": "EEPROM_CW_KEYER_MODE",
    "cw_decoder_thresh": "EEPROM_CW_DECODER_THRESH",
    "tx_comp_level": "EEPROM_TX_AUDIO_COMPRESS",
    "tx_postfilt_gain": "EEPROM_ALC_POSTFILT_TX_GAIN",
    "dbm_constant": "EEPROM_DBM_CALIBRATE",
    "beep_freq": "EEPROM_KEYBOARD_BEEP_FREQ",
    "beep_volume": "EEPROM_BEEP_LOUDNESS",
    "spectrum_magnify": "EEPROM_SPECTRUM_MAGNIFY",
    "sam_pll_zeta_x100": "EEPROM_SAM_PLL_STEP_RESPONSE",
    "sam_pll_omega": "EEPROM_SAM_PLL_BANDWIDTH",
    "sam_fmax": "EEPROM_SAM_PLL_LOCKING_RANGE",
    "fade_leveler": "EEPROM_SAM_FADE_LEVELER",
}


def _load_ref_rows():
    import pathlib
    path = (pathlib.Path(__file__).resolve().parent.parent / "data"
            / "ref_config.json")
    return json.loads(path.read_text())


_REF_DATA = _load_ref_rows()

# dedupe by eeprom name keeping the LAST occurrence (the table lists
# EEPROM_FLAGS2 twice; the later row carries the real default/range)
_REF_ROWS: dict[str, dict] = {}
for _r in _REF_DATA["rows"]:
    _REF_ROWS[_r["eeprom_name"]] = _r

# attach real ids to curated entries
_ref_by_name = {r["eeprom_name"]: r for r in _REF_ROWS.values()}
REGISTRY = [
    dataclasses.replace(
        e, ref_id=_ref_by_name[_CURATED_REF[e.name]]["eeprom_id"])
    if e.name in _CURATED_REF and _CURATED_REF[e.name] in _ref_by_name
    else e
    for e in REGISTRY
]

# generate entries for every remaining firmware row
_claimed = {sym for sym in _CURATED_REF.values()}
for _r in _REF_ROWS.values():
    if _r["eeprom_name"] in _claimed:
        continue
    _name = _r["eeprom_name"].lower().removeprefix("eeprom_")
    REGISTRY.append(ConfigEntry(
        name=_name,
        default=int(_r["default"]),
        min=_r["min"], max=_r["max"], typ=int,
        doc=("calibration; " if _r["calib"] else "")
        + f"{_r['eeprom_name']} -> {_r['target']} ({_r['type']})",
        ref_id=_r["eeprom_id"],
    ))

_BY_NAME = {e.name: e for e in REGISTRY}
_BY_ID = {e.eeprom_id: e for e in REGISTRY}


# --- band/VFO memories (ui_configuration.c:545-620, 920-923) ---------------

class BandMemories:
    """Per-band VFO A/B memories: dial frequency (uint32, stored as
    high/low 16-bit words in the reference) + demod mode word.  EEPROM id
    layout from the imported table (EEPROM_BAND0_MODE_A + i, etc.)."""

    IDS = {k: v for k, v in _REF_DATA["band_memory"]["ids"].items()}
    NUM_BANDS = int(_REF_DATA["band_memory"].get("num_bands") or 17)

    def __init__(self):
        def _default_dial(i):
            try:
                from ..control.radio import BANDS
                if i < len(BANDS):
                    return int(BANDS[i][1])
            except Exception:
                pass
            return 7_000_000 + 10_000 * i
        # mode word: reference packs decod mode etc.; we store the demod
        # mode index (0=lsb 1=usb 2=cw 3=am 4=sam 5=fm) like dmod_mode
        self.dial = {v: [_default_dial(i) for i in range(self.NUM_BANDS)]
                     for v in ("A", "B")}
        self.mode = {v: [0] * self.NUM_BANDS for v in ("A", "B")}

    # --- 16-bit word transport (CAT clone / EEPROM image) ---
    def read_word(self, var_id: int) -> int | None:
        for vfo, base_m, base_h, base_l in (
                ("A", self.IDS.get("EEPROM_BAND0_MODE_A"),
                 self.IDS.get("EEPROM_BAND0_FREQ_HIGH_A"),
                 self.IDS.get("EEPROM_BAND0_FREQ_LOW_A")),
                ("B", self.IDS.get("EEPROM_BAND0_MODE_B"),
                 self.IDS.get("EEPROM_BAND0_FREQ_HIGH_B"),
                 self.IDS.get("EEPROM_BAND0_FREQ_LOW_B"))):
            for base, getter in (
                    (base_m, lambda v, i: self.mode[v][i] & 0xFFFF),
                    (base_h, lambda v, i: (self.dial[v][i] >> 16) & 0xFFFF),
                    (base_l, lambda v, i: self.dial[v][i] & 0xFFFF)):
                if base is not None and base <= var_id < base + self.NUM_BANDS:
                    return getter(vfo, var_id - base)
        return None

    def write_word(self, var_id: int, value: int) -> bool:
        value &= 0xFFFF
        for vfo, base_m, base_h, base_l in (
                ("A", self.IDS.get("EEPROM_BAND0_MODE_A"),
                 self.IDS.get("EEPROM_BAND0_FREQ_HIGH_A"),
                 self.IDS.get("EEPROM_BAND0_FREQ_LOW_A")),
                ("B", self.IDS.get("EEPROM_BAND0_MODE_B"),
                 self.IDS.get("EEPROM_BAND0_FREQ_HIGH_B"),
                 self.IDS.get("EEPROM_BAND0_FREQ_LOW_B"))):
            if base_m is not None and base_m <= var_id < base_m + self.NUM_BANDS:
                self.mode[vfo][var_id - base_m] = value
                return True
            if base_h is not None and base_h <= var_id < base_h + self.NUM_BANDS:
                i = var_id - base_h
                self.dial[vfo][i] = (self.dial[vfo][i] & 0xFFFF) | (value << 16)
                return True
            if base_l is not None and base_l <= var_id < base_l + self.NUM_BANDS:
                i = var_id - base_l
                self.dial[vfo][i] = (self.dial[vfo][i] & ~0xFFFF) | value
                return True
        return False

    def to_dict(self) -> dict:
        return {"dial": self.dial, "mode": self.mode}

    def from_dict(self, d: dict) -> None:
        for v in ("A", "B"):
            if v in d.get("dial", {}):
                vals = d["dial"][v][: self.NUM_BANDS]
                self.dial[v][: len(vals)] = [int(x) for x in vals]
            if v in d.get("mode", {}):
                vals = d["mode"][v][: self.NUM_BANDS]
                self.mode[v][: len(vals)] = [int(x) for x in vals]


def entry_by_id(eeprom_id: int) -> ConfigEntry | None:
    return _BY_ID.get(eeprom_id)


def entry_by_name(name: str) -> ConfigEntry | None:
    return _BY_NAME.get(name)


class Config:
    """Runtime config store with registry semantics."""

    def __init__(self, **overrides):
        self._values = {e.name: e.default for e in REGISTRY}
        self.band_memory = BandMemories()
        for k, v in overrides.items():
            self.set(k, v)

    def get(self, name: str):
        return self._values[name]

    def set(self, name: str, value):
        entry = _BY_NAME.get(name)
        if entry is None:
            raise KeyError(f"unknown config entry: {name}")
        self._values[name] = entry.clamp(value)

    def __getitem__(self, name):
        return self.get(name)

    def __setitem__(self, name, value):
        self.set(name, value)

    def to_dict(self) -> dict:
        return dict(self._values)

    # --- persistence (EEPROM analog) ---
    def save(self, path: str) -> None:
        blob = {"version": CONFIG_VERSION, "values": self._values,
                "band_memory": self.band_memory.to_dict()}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(blob, f, indent=2, sort_keys=True)
        os.replace(tmp, path)   # atomic, the analog of wear-leveled paging

    @classmethod
    def load(cls, path: str) -> "Config":
        cfg = cls()
        with open(path) as f:
            blob = json.load(f)
        for k, v in blob.get("values", {}).items():
            if k in _BY_NAME:          # unknown rows ignored (fw-compat)
                cfg.set(k, v)
        if "band_memory" in blob:
            cfg.band_memory.from_dict(blob["band_memory"])
        return cfg

    def load_defaults(self) -> None:
        self._values = {e.name: e.default for e in REGISTRY}

    @property
    def translate_hz(self) -> float:
        return {0: 0.0, 1: 6000.0, 2: -6000.0,
                3: 12000.0, 4: -12000.0}[self.get("iq_freq_mode")] * -1.0


# ---------------------------------------------------------------------------
# Streaming-state checkpointing (new capability vs. reference)
# ---------------------------------------------------------------------------

# The JAX package's RxState fields in its order, the order its pytree
# flattens them in; the port's RxState orders them otherwise.  The nested
# states (AGC, SAM, FM, the options') and TxState, ScopeState keep the
# JAX package's field order.
_JAX_RX_FIELDS = ("iqcorr", "nco_phase", "front_carry", "audio_sos_state",
                  "agc", "fade", "sam", "fm", "nr", "nb", "notch", "leaky",
                  "interp_carry", "eq1", "eq2", "front2_carry", "aa")


def _leaves(state, cfg=None) -> list[tuple[str, np.ndarray]]:
    """(dotted name, NumPy array) of every leaf of a port state in the
    JAX package's flatten order and layout: None leaves left out, the NCO
    phases as uint32, the two-channel RX modes' histories as the JAX
    chain's (which needs their `cfg`)."""
    from ..chain import rx, tx
    from ..spectrum import scope

    if isinstance(state, rx.RxState):
        flat, order = rx.state_to_numpy(state, cfg), _JAX_RX_FIELDS
    elif isinstance(state, tx.TxState):
        flat, order = tx.state_to_numpy(state), tx.TxState._fields
    elif isinstance(state, scope.ScopeState):
        flat, order = scope.state_to_numpy(state), scope.ScopeState._fields
    else:
        flat, order = rx.leaves_to_numpy(state), state._fields
    return [(k, v) for f in order for k, v in flat.items()
            if k == f or k.startswith(f + ".")]


def nest_leaves(like, flat: dict, fn=None, prefix: str = ""):
    """`like`'s NamedTuple structure with each leaf replaced by its array
    in `flat`, through `fn` where given (None where `flat` has no such
    leaf)."""
    if like is None or not hasattr(like, "_fields"):
        v = flat.get(prefix)
        return v if v is None or fn is None else fn(v)
    return type(like)(**{
        f: nest_leaves(getattr(like, f), flat, fn,
                       f"{prefix}.{f}" if prefix else f)
        for f in like._fields})


def _device(state):
    """The device of a state's first tensor leaf."""
    import torch
    for v in state:
        if isinstance(v, torch.Tensor):
            return v.device
        if v is not None and hasattr(v, "_fields"):
            dev = _device(v)
            if dev is not None:
                return dev
    return None


def save_state(path: str, state, cfg=None) -> None:
    """Checkpoint a chain's state (RxState, TxState, ScopeState or another
    NamedTuple of tensors) to .npz in the JAX package's layout: ``n_leaves``
    and ``leaf_i`` in its pytree's flatten order.  The two-channel RX modes
    need their RxConfig `cfg`."""
    leaves = _leaves(state, cfg)
    arrays = {f"leaf_{i}": v for i, (_, v) in enumerate(leaves)}
    np.savez(path, n_leaves=len(leaves), **arrays)


def load_state(path: str, like, cfg=None):
    """Restore a checkpoint (of either package) into the structure of
    `like`, a state of the port, on `like`'s device."""
    from ..chain import rx, tx
    from ..spectrum import scope

    data = np.load(path)
    names = [k for k, _ in _leaves(like, cfg)]
    n = int(data["n_leaves"])
    if n != len(names):
        raise ValueError(f"checkpoint has {n} leaves, the state "
                         f"{len(names)}" + ("" if cfg is not None else
                                            " (two-channel modes need cfg)"))
    flat = {k: data[f"leaf_{i}"] for i, k in enumerate(names)}
    dev = _device(like)
    if isinstance(like, rx.RxState):
        return rx.state_from_numpy(nest_leaves(like, flat), device=dev,
                                   cfg=cfg)
    if isinstance(like, tx.TxState):
        return tx.state_from_numpy(nest_leaves(like, flat), device=dev)
    if isinstance(like, scope.ScopeState):
        return scope.state_from_numpy(flat, device=dev)
    import torch

    def t(a):
        a = np.array(a)
        return torch.as_tensor(a.astype(np.int64) if a.dtype == np.uint32
                               else a, device=dev)
    return nest_leaves(like, flat, t)
