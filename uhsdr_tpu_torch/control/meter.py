"""TX power / SWR metering and per-band TX power factor.

Re-implements the measurement and calibration math of the reference's
power/SWR subsystem (`drivers/ui/radio_management.c`):

  * sensor-voltage -> RF power polynomial law and dBm conversion
    (`RadioManagement_PowerFromADCValue` `radio_management.c:1698-1723`),
  * the averaging SWR meter with FWD/REV swap, VSWR computation and
    high-VSWR protection (`RadioManagement_UpdatePowerAndVSWR`
    `radio_management.c:1729-1797`, threshold init `src/uhsdr_main.c:360`),
  * per-band TX power factor with coarse/fine bias-reduce scaling,
    out-of-band interpolation between the 80 m and 10 m anchors, power
    rescaling below reference power, and the hard PA-drive limit
    (`RadioManagement_SetBandPowerFactor` `radio_management.c:394-443`,
    `RadioManagement_CalculatePowerFactorScale` `:376-385`,
    `TX_POWER_FACTOR_MAX_INTERNAL` `hardware/uhsdr_board.h:146`),
  * the PA power-level policy (full/5W/2W/1W/0.5W, AM limit, generic-band
    fallback — `RadioManagement_SetPowerLevel` `radio_management.c:459-520`).

In the reference these run in the 100 Hz main-loop cadence on ADC readings
from the directional-coupler detectors; here the same math is a pure
control-plane module fed by telemetry samples (and, in simulation, by the
TX chain's own output power), publishing into the CAT `Radio` state.

A copy of the JAX package's module of the same name (the port
imports nothing of that package): the same classes and decisions,
its imports re-pointed at the port's own modules.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

# --- constants (radio_management.c:56-73) -------------------------------
SWR_SAMPLES_CNT = 5
SWR_ADC_FULL_SCALE = 4095.0
SWR_ADC_VOLT_REFERENCE = 3.3
LOW_POWER_CALC_THRESHOLD = 0.05
# low-power cubic (p = a + bx + cx^2 + dx^3), power in watts
LOW_RF_PWR_COEFF = (-0.0338205168744131, 5.02584652062682,
                    -106.610490958242, 853.156505329744)
# high-power quadratic
HIGH_RF_PWR_COEFF = (0.01209, 0.8334, 1.569)
SWR_MIN_CALC_POWER = 0.25          # W (ui_driver.h:137)
TX_POWER_FACTOR_MAX_INTERNAL = 0.55  # uhsdr_board.h:146
PA_REFERENCE_POWER_MW = 5000.0     # mchf_pa.reference_power (radio_management.c:292)
PA_MAX_AM_POWER_MW = 2000          # mchf_pa.max_am_power (:295)

# PA level id -> mW (0 = full power; radio_management.c:274-278)
PA_LEVELS_MW = {"full": 0, "high": 5000, "medium": 2000,
                "low": 1000, "minimal": 500}


def power_from_sensor(adc_value: float, sensor_null_cfg: int = 100,
                      coupling_cfg: int = 100) -> tuple[float, float]:
    """Detector ADC count -> (power_watts, dbm).

    Exact math of `RadioManagement_PowerFromADCValue`
    (`radio_management.c:1698-1723`): ADC count scaled by the 3.3 V /
    4095-count reference, offset by the sensor-null calibration
    (config units, 100 = 0, 1 unit = 1 mV), run through the low-power
    cubic or high-power quadratic detector law, then dBm with the
    per-band coupling calibration (config units, 100 = 0, 0.1 dB/unit).
    """
    sensor_null = (sensor_null_cfg - 100.0) / 1000.0
    coupling_db = (coupling_cfg - 100.0) / 10.0
    val = sensor_null + adc_value * SWR_ADC_VOLT_REFERENCE / SWR_ADC_FULL_SCALE
    if val <= LOW_POWER_CALC_THRESHOLD:
        a, b, c, d = LOW_RF_PWR_COEFF
        pwr = a + b * val + c * val * val + d * val ** 3
    else:
        a, b, c = HIGH_RF_PWR_COEFF
        pwr = a + b * val + c * val * val
    pwr = max(pwr, 0.0)
    dbm = (10.0 * math.log10(pwr) if pwr > 0 else -120.0) + 30.0 + coupling_db
    watts = 10.0 ** (dbm / 10.0) / 1000.0
    return watts, dbm


@dataclass
class SwrMeter:
    """Averaging forward/reflected power meter + VSWR protection.

    Mirrors `RadioManagement_UpdatePowerAndVSWR`
    (`radio_management.c:1729-1797`): accumulate `SWR_SAMPLES_CNT` ADC
    sample pairs, then convert to fwd/rev W and dBm, compute
    VSWR = (1+rho)/(1-rho) with rho = sqrt(Prev/Pfwd), and latch the
    protection action when the threshold (default 1 = OFF,
    `uhsdr_main.c:360`) is exceeded at >= 0.25 W forward.
    """
    sensor_null_cfg: int = 100
    coupling_cfg: int = 100
    swap_fwd_rev: bool = False          # FLAGS1_SWAP_FWDREV_SENSE
    vswr_protection_threshold: float = 1.0  # <=1 = OFF

    fwd_pwr: float = 0.0
    rev_pwr: float = 0.0
    fwd_dbm: float = -120.0
    rev_dbm: float = -120.0
    vswr: float = 1.0
    high_vswr_detected: bool = False

    _fwd_acc: float = field(default=0.0, repr=False)
    _rev_acc: float = field(default=0.0, repr=False)
    _n: int = field(default=0, repr=False)

    def update(self, adc_fwd: float, adc_rev: float) -> bool:
        """Feed one ADC sample pair; returns True when a new measurement
        was produced (every SWR_SAMPLES_CNT calls)."""
        if self.swap_fwd_rev:
            adc_fwd, adc_rev = adc_rev, adc_fwd
        if self._n < SWR_SAMPLES_CNT:
            self._fwd_acc += adc_fwd
            self._rev_acc += adc_rev
            self._n += 1
            return False
        self.fwd_pwr, self.fwd_dbm = power_from_sensor(
            self._fwd_acc / SWR_SAMPLES_CNT, self.sensor_null_cfg,
            self.coupling_cfg)
        self.rev_pwr, self.rev_dbm = power_from_sensor(
            self._rev_acc / SWR_SAMPLES_CNT, self.sensor_null_cfg,
            self.coupling_cfg)
        self._fwd_acc = self._rev_acc = 0.0
        self._n = 0
        if self.fwd_pwr > 0:
            rho = math.sqrt(self.rev_pwr / self.fwd_pwr)
            self.vswr = (1.0 + rho) / (1.0 - rho) if rho < 1.0 else math.inf
        if (self.vswr_protection_threshold > 1
                and self.fwd_pwr >= SWR_MIN_CALC_POWER
                and self.vswr > self.vswr_protection_threshold):
            self.high_vswr_detected = True
        return True


def power_factor_scale(power_mw: float) -> float:
    """Gain scaling to reach `power_mw` from the reference-power drive
    (`RadioManagement_CalculatePowerFactorScale` `:376-385`)."""
    if power_mw > 0:
        return math.sqrt(power_mw / PA_REFERENCE_POWER_MW)
    return 1.0


def band_power_factor(pwr_adj_cfg: float, power_mw: float,
                      reduce_flag: bool = False) -> float:
    """In-band TX power factor (`RadioManagement_SetBandPowerFactor`
    `:417-441`): stored config value interpreted fine (/400, when the
    band's bias-reduce flag is set) or coarse (/100), rescaled for
    sub-reference power requests, clamped at the PA-drive hard limit."""
    pf = pwr_adj_cfg / (400.0 if reduce_flag else 100.0)
    if power_mw != 0:
        pf *= power_factor_scale(power_mw)
    return min(pf, TX_POWER_FACTOR_MAX_INTERNAL)


def generic_band_power_factor(freq_hz: float, adj_80m_cfg: float,
                              adj_10m_cfg: float,
                              reduce_80m: bool = False,
                              reduce_10m: bool = False,
                              freq_80m_hz: float = 3_500_000.0,
                              freq_10m_hz: float = 28_000_000.0) -> float:
    """Out-of-band power factor: linear inter-/extrapolation between the
    80 m and 10 m reference-power anchors (`radio_management.c:400-415`)."""
    adj_min = adj_80m_cfg / (400.0 if reduce_80m else 100.0)
    adj_max = adj_10m_cfg / (400.0 if reduce_10m else 100.0)
    t = (freq_hz - freq_80m_hz) / (freq_10m_hz - freq_80m_hz)
    return min(t * (adj_max - adj_min) + adj_min,
               TX_POWER_FACTOR_MAX_INTERNAL)


def resolve_power_level(level: str, mode: str = "usb",
                        in_band: bool = True,
                        tx_outside_bands: bool = False) -> tuple[int, str]:
    """PA power-level policy (`RadioManagement_SetPowerLevel`
    `:459-520`): returns (power_mw, effective_level).  0 mW means full
    power.  AM is capped at `PA_MAX_AM_POWER_MW`; outside ham bands the
    power drops to 50 mW (if out-of-band TX is enabled) or 5 mW."""
    power = PA_LEVELS_MW[level]
    if not in_band:
        power = 50 if tx_outside_bands else 5
    if mode in ("am", "sam"):
        if power > PA_MAX_AM_POWER_MW or power == 0:
            power = PA_MAX_AM_POWER_MW
    elif power > PA_REFERENCE_POWER_MW:
        power, level = 0, "full"
    return power, level
