"""Frequency/temperature calibration — IQ balance anchors + soft TCXO.

1. IQ gain/phase calibration interpolated over frequency anchor points:
   reference `AudioManagement_CalcIqPhaseGainAdjust` /
   `AudioManagement_CalcAdjustInFreqRangeHelperNew`
   (`audio_management.c:150-240`): per-band anchor points hold user
   calibration values for RX/TX gain and phase; the applied adjustment is
   the piecewise-linear interpolation between the surrounding anchors,
   with "OFF" anchors borrowing their neighbor's value.  Gain is applied
   as i *= 1+adj, q *= 1-adj; phase by mixing a little of one rail into
   the other (`audio_driver.c:1776`).

2. Soft TCXO: reference `soft_tcxo.c` reads an MCP9801 temperature
   sensor near the Si570 crystal and corrects the LO by a per-degree
   ppb table (an AT-cut crystal drift curve peaking near 55 degC, range
   0..99 degC, applied with hysteresis).  Here the sensor becomes a
   caller-supplied temperature reading and the table a caller-supplied
   (or default cubic) drift curve; the correction returns the Hz shift
   to add to the tuned frequency.

A copy of the JAX package's module of the same name (the port
imports nothing of that package): the same classes and decisions,
its imports re-pointed at the port's own modules.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

IQ_BALANCE_OFF = None     # unset anchor (reference IQ_BALANCE_OFF sentinel)

SCALING_FACTOR_IQ_PHASE_ADJUST = 2000.0       # reference scalings
SCALING_FACTOR_IQ_AMPLITUDE_ADJUST = 4000.0


@dataclass
class IqAnchor:
    freq_hz: float
    rx_gain: float | None = IQ_BALANCE_OFF     # raw user units (+-500)
    rx_phase: float | None = IQ_BALANCE_OFF
    tx_gain: float | None = IQ_BALANCE_OFF
    tx_phase: float | None = IQ_BALANCE_OFF


@dataclass
class IqCalibration:
    """Anchor-point store + interpolation (one per radio/channel-group)."""
    anchors: list[IqAnchor] = field(default_factory=list)

    def set_anchor(self, freq_hz: float, **values) -> None:
        for a in self.anchors:
            if abs(a.freq_hz - freq_hz) < 1.0:
                for k, v in values.items():
                    setattr(a, k, v)
                return
        self.anchors.append(IqAnchor(freq_hz=freq_hz, **values))
        self.anchors.sort(key=lambda a: a.freq_hz)

    def _interp(self, freq_hz: float, what: str, scaling: float) -> float:
        """Piecewise-linear between surrounding anchors; OFF anchors
        borrow the neighbor (audio_management.c:158-178)."""
        lows = [a for a in self.anchors if a.freq_hz <= freq_hz]
        highs = [a for a in self.anchors if a.freq_hz > freq_hz]
        a_lo = lows[-1] if lows else None
        a_hi = highs[0] if highs else None
        v_lo = getattr(a_lo, what) if a_lo else IQ_BALANCE_OFF
        v_hi = getattr(a_hi, what) if a_hi else IQ_BALANCE_OFF
        if v_hi is IQ_BALANCE_OFF and v_lo is IQ_BALANCE_OFF:
            return 0.0
        if v_hi is IQ_BALANCE_OFF:
            v_hi = v_lo
            a_hi = a_lo
        elif v_lo is IQ_BALANCE_OFF:
            v_lo = v_hi
            a_lo = a_hi
        f_lo, f_hi = a_lo.freq_hz, a_hi.freq_hz
        delta = ((v_hi - v_lo) / (f_hi - f_lo) * (freq_hz - f_lo)
                 if f_hi != f_lo else 0.0)
        return (v_lo + delta) / scaling

    def rx_adjustments(self, freq_hz: float) -> tuple[float, float, float]:
        """-> (i_gain_mult, q_gain_mult, phase_balance).  RX gain sign is
        negative (audio_management.c:203)."""
        adj = -self._interp(freq_hz, "rx_gain",
                            SCALING_FACTOR_IQ_AMPLITUDE_ADJUST)
        phase = self._interp(freq_hz, "rx_phase",
                             SCALING_FACTOR_IQ_PHASE_ADJUST)
        return 1.0 + adj, 1.0 - adj, phase

    def tx_adjustments(self, freq_hz: float) -> tuple[float, float, float]:
        adj = self._interp(freq_hz, "tx_gain",
                           SCALING_FACTOR_IQ_AMPLITUDE_ADJUST)
        phase = self._interp(freq_hz, "tx_phase",
                             SCALING_FACTOR_IQ_PHASE_ADJUST)
        return 1.0 + adj, 1.0 - adj, phase


# ---------------------------------------------------------------------------
# Soft TCXO
# ---------------------------------------------------------------------------

def default_drift_curve(temp_c: np.ndarray) -> np.ndarray:
    """AT-cut-crystal-shaped drift in ppb vs temperature: inverted cubic
    with the characteristic inflection, ~0 ppb near 45-55 degC and
    falling off toward both temperature extremes (the shape of the
    reference's measured Si570 table, `soft_tcxo.c:139-240`)."""
    t = np.asarray(temp_c, float)
    x = (t - 50.0) / 25.0
    return -90.0 * x ** 2 - 35.0 * x ** 3 + 20.0


@dataclass
class SoftTcxo:
    """Temperature-drift LO correction with hysteresis.

    The reference re-tunes only when the temperature index changes
    (1 degC steps, `SoftTcxo_HandleLoTemperatureDrift`), avoiding
    constant retuning from sensor noise."""
    curve=staticmethod(default_drift_curve)
    step_c: float = 1.0
    _last_index: int | None = None

    def __init__(self, curve=None, step_c: float = 1.0):
        self.curve = curve or default_drift_curve
        self.step_c = step_c
        self._last_index = None

    def update(self, temp_c: float) -> tuple[bool, float]:
        """-> (retune_needed, correction_ppb).  Clips to the table range
        like the reference (0..99 degC)."""
        t = float(np.clip(temp_c, 0.0, 99.0))
        idx = int(t / self.step_c)
        changed = idx != self._last_index
        self._last_index = idx
        ppb = float(self.curve(idx * self.step_c))
        return changed, ppb

    @staticmethod
    def apply(freq_hz: float, ppb: float) -> float:
        return freq_hz * (1.0 + ppb * 1e-9)
