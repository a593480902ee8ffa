"""Radio control plane — frequency/band/mode management.

Reference: `drivers/ui/radio_management.c` —
  * ham band tables (`:88-115` BandInfo rows, IARU region variants),
  * dial->tune translation (`RadioManagement_Dial2TuneFrequency:606`):
    tune = dial + translate offset (+-6/12 kHz) + CW sidetone offset
    (sideband-dependent) + RIT + transverter offset,
  * demod-mode applicability per band/config
    (`RadioManagement_SetDemodMode:1257`, `:1510-1642`),
  * CW sideband rules (`:1125`: auto LSB below 10 MHz, USB above),
  * TX/RX sequencing (`RadioManagement_SwitchTxRx:910`) — here a pure
    state transition emitting the actions the firmware performs against
    hardware (mute, retune, chain swap).

A copy of the JAX package's module of the same name (the port
imports nothing of that package): the same classes and decisions,
its imports re-pointed at the port's own modules.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from enum import Enum

# (name, lower edge Hz, width Hz) — IARU region 2-ish; region variants of
# the reference differ only in width
BANDS = [
    ("2200m", 135_700, 2_100), ("630m", 472_000, 7_000),
    ("160m", 1_810_000, 190_000), ("80m", 3_500_000, 500_000),
    ("60m", 5_250_000, 200_000), ("40m", 7_000_000, 300_000),
    ("30m", 10_100_000, 50_000), ("20m", 14_000_000, 350_000),
    ("17m", 18_068_000, 100_000), ("15m", 21_000_000, 450_000),
    ("12m", 24_890_000, 100_000), ("10m", 28_000_000, 1_700_000),
    ("6m", 50_000_000, 4_000_000), ("4m", 70_000_000, 500_000),
    ("2m", 144_000_000, 4_000_000), ("70cm", 430_000_000, 10_000_000),
    ("23cm", 1_240_000_000, 60_000_000),
]

MODES = ("usb", "lsb", "cw", "am", "sam", "fm", "digi")

TRANSLATE_OFFSETS = {0: 0, 1: 6000, 2: -6000, 3: 12000, 4: -12000}


def band_for_freq(freq_hz: float):
    for name, lo, width in BANDS:
        if lo <= freq_hz <= lo + width:
            return name
    return "Gen"


def default_sideband_for_freq(freq_hz: float) -> str:
    """Ham convention the reference applies: LSB below 10 MHz, USB above."""
    return "lsb" if freq_hz < 10_000_000 else "usb"


def cw_is_lsb(freq_hz: float, cw_offset_mode: str = "auto") -> bool:
    """CW sideband rules (`RadioManagement_CalculateCWSidebandMode:1125`)."""
    if cw_offset_mode == "usb":
        return False
    if cw_offset_mode == "lsb":
        return True
    return freq_hz < 10_000_000


def mode_applicable(mode: str, freq_hz: float,
                    fm_enabled: bool = True) -> bool:
    """Demod-mode applicability (`radio_management.c:1510-1642`): FM only
    makes sense with translate (handled by chain) and is typically
    restricted to 10 m/VHF in the reference's UI."""
    if mode == "fm":
        return fm_enabled and freq_hz >= 28_000_000
    return mode in MODES


@dataclass(frozen=True)
class TuneState:
    dial_hz: float
    mode: str = "usb"
    iq_freq_mode: int = 2          # translate setting (config registry)
    cw_sidetone_hz: float = 700.0
    cw_offset_mode: str = "auto"   # auto|usb|lsb (reference cw_offset_mode)
    rit_hz: float = 0.0
    transverter_offset_hz: float = 0.0
    transverter_mult: int = 1


def dial_to_tune(ts: TuneState) -> float:
    """The reference's Dial2TuneFrequency: where the hardware LO actually
    sits so the wanted signal lands at the translate offset."""
    tune = ts.dial_hz * ts.transverter_mult + ts.transverter_offset_hz
    tune += ts.rit_hz
    if ts.mode == "cw":
        # shift so the carrier produces the sidetone pitch
        tune += (ts.cw_sidetone_hz if cw_is_lsb(tune, ts.cw_offset_mode)
                 else -ts.cw_sidetone_hz)
    tune -= TRANSLATE_OFFSETS[ts.iq_freq_mode]
    return tune


@dataclass(frozen=True)
class TrxState:
    """TX/RX sequencing as a pure state machine.

    The reference's SwitchTxRx (`radio_management.c:910`) performs: audio
    mute -> PA bias/codec switch -> LO retune (TX freq may differ: split,
    XIT) -> band/LPF switch -> chain reconfig -> unmute.  Here the same
    ordering is emitted as an action list for the runtime to execute
    against its I/O (useful for full-duplex simulation and conformance).
    """
    mode: str = "rx"       # rx | tx | tune
    muted: bool = False


def switch_txrx(state: TrxState, to_tx: bool,
                split_tx_dial: float | None = None) -> tuple[TrxState, list[str]]:
    actions = ["mute_audio"]
    if to_tx:
        actions += ["stop_rx_chain", "retune_lo_tx" if split_tx_dial else
                    "keep_lo", "enable_tx_chain"]
        new = TrxState(mode="tx", muted=False)
    else:
        actions += ["stop_tx_chain", "retune_lo_rx", "enable_rx_chain"]
        new = TrxState(mode="rx", muted=False)
    actions.append("unmute_audio")
    return new, actions


@dataclass
class SnapTuner:
    """SNAP auto-retune state machine — `UiSpectrum_CalculateSnap`
    (`ui_spectrum.c:1876-1989`): the scope supplies a Jacobsen-Kootsookos
    carrier-offset estimate (already 0.2/0.8 low-pass smoothed per block);
    this machine requires several consecutive *consistent* measurements
    before correcting the dial (reference: 6 measurements when manually
    triggered, 10 in continuous/auto mode), and is gated by signal
    activity (the reference uses the CW decoder's `ads.CW_signal` flag or
    AM/SAM/BPSK mode).
    """
    meas_needed: int = 6          # 6 manual / 10 continuous
    consistency_hz: float = 10.0  # measurements must agree this closely
    min_offset_hz: float = 1.0    # dead zone: don't chase sub-Hz noise
    count: int = 0
    acc: float = 0.0
    last: float = 0.0

    def reset(self) -> None:
        self.count = 0
        self.acc = 0.0

    def update(self, snap_offset_hz: float, active: bool = True):
        """Feed one per-block estimate.  Returns the dial correction (Hz)
        once `meas_needed` consecutive consistent measurements accumulate,
        else None."""
        if not active:
            self.reset()
            return None
        est = float(snap_offset_hz)
        if self.count > 0 and abs(est - self.last) > self.consistency_hz:
            self.reset()
        self.last = est
        self.count += 1
        self.acc += est
        if self.count < self.meas_needed:
            return None
        correction = self.acc / self.count
        self.reset()
        if abs(correction) < self.min_offset_hz:
            return None
        return correction
