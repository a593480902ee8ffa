"""Local-oscillator frequency planning (Si570 / Si5351A register math).

Re-implements the pure math of the reference's oscillator layer
(`drivers/ui/oscillator/`) behind the same split interface
(`osc_interface.h:39-61`): `prepare_next_frequency` does all planning /
register computation out of the hot path, `change_to_next_frequency`
commits it (here: to a pluggable register-write transport instead of an
I2C bus — the planning math is identical and drives real hardware when a
bus transport is supplied).

* Si570 (`osc_si570.c`): DCO divider search over HS_DIV {11,9,7,6,5,4} and
  N1 in {1, even 2..128} keeping fDCO in [4.85, 5.67] GHz (`:304-351`),
  38-bit RFREQ register packing (`Si570_ConfigToRegs:352-400`),
  smooth-tune small steps within +/-3500 ppm of fDCO (SMOOTH_DELTA=0.0035,
  `:104,270-301`), crystal calibration from startup registers
  (`:592`) and ppm correction (`Si570_SetPPM:519-523`), temperature
  scaling referenced to 14 MHz (`Si570_PrepareNextFrequency:608+`).
* Si5351A (`osc_si5351a.c`): PLL multiplier 15..90 + 20-bit fractional
  (denominator fixed at 2^20-1, `Si5351a_CalculateConfigForDivider`),
  even-integer MultiSynth divider selection with divider reuse
  (`Si5351a_CalculateConfig`), quadrature (90 deg) output planning with
  divider <= 126 and CLK1 phase offset = divider, or 4x clock for a
  Johnson counter below the quadrature limit, P1/P2/P3 register packing
  (`Si5351a_SetupPLL:125-153`, `Si5351a_SetupMultisynthInteger:156-185`).

The QSD/QSE mixers need a 4x LO (two flip-flops make the 0/90 deg pair),
so the planned oscillator frequency is 4x the tune frequency unless the
Si5351 drives true quadrature outputs directly.

A copy of the JAX package's module of the same name (the port
imports nothing of that package): the same classes and decisions,
its imports re-pointed at the port's own modules.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Callable

RegWriter = Callable[[int, bytes], None]


class OscResult(enum.Enum):
    """`Oscillator_ResultCodes_t` (`osc_interface.h:21-28`)."""
    OK = 0
    TUNE_LIMITED = 1        # outside official spec but known to work
    TUNE_IMPOSSIBLE = 2
    COMM_ERROR = 3
    LARGE_STEP = 4          # informational in this implementation


# ---------------------------------------------------------------- Si570

SI570_FACTORY_FXTAL_MHZ = 114.285
SI570_FDCO_MIN_MHZ = 4850.0
SI570_FDCO_MAX_MHZ = 5670.0
SI570_HS_DIV = (11, 9, 7, 6, 5, 4)
SI570_SMOOTH_DELTA = 0.0035     # +/-3500 ppm datasheet, kept conservative
POW_2_28 = 268435456.0
# hard/soft oscillator limits, Hz (C-grade part, osc_si570.c:43-53)
SI570_MIN_FREQ = 10_000_000.0
SI570_HARD_MIN_FREQ = 3_500_000.0
SI570_MAX_FREQ = 280_000_000.0
SI570_HARD_MAX_FREQ = 280_000_000.0


@dataclass(frozen=True)
class Si570Config:
    """One frequency plan: output freq (MHz) + divider/RFREQ solution."""
    freq_mhz: float
    hsdiv: int
    n1: int
    fdco_mhz: float
    rfreq: float


def si570_find_config(freq_mhz: float,
                      fxtal_mhz: float = SI570_FACTORY_FXTAL_MHZ
                      ) -> Si570Config | None:
    """Divider search (`Si570_FindConfigForFreq` `osc_si570.c:304-351`):
    first (largest) HS_DIV with an admissible N1 (1 or even <=128) keeping
    fDCO = freq*N1*HS_DIV within [4850, 5670] MHz."""
    divider_max = math.floor(SI570_FDCO_MAX_MHZ / freq_mhz)
    curr_div = math.ceil(SI570_FDCO_MIN_MHZ / freq_mhz)
    for hsdiv in SI570_HS_DIV:
        n1_min = math.ceil(curr_div / hsdiv)
        n1_max = math.floor(divider_max / hsdiv)
        if n1_max >= 1 and n1_min <= 128:
            n1 = 1 if n1_min <= 1 else (n1_min + 1) & ~1
            if n1 == 1 or n1 <= n1_max:
                fdco = freq_mhz * n1 * hsdiv
                if SI570_FDCO_MIN_MHZ <= fdco <= SI570_FDCO_MAX_MHZ:
                    return Si570Config(freq_mhz, hsdiv, n1, fdco,
                                       fdco / fxtal_mhz)
                return None
    return None


def _si570_smooth(cur: Si570Config, freq_mhz: float,
                  fxtal_mhz: float) -> Si570Config | None:
    """Smooth-tune: if the new fDCO with the current dividers stays within
    SMOOTH_DELTA of the *anchor* fDCO, only RFREQ changes (no DCO freeze,
    no output glitch) — `Si570_FindSmoothRFreqForFreq`
    (`osc_si570.c:277-301`).  The anchor fdco is kept so successive small
    steps cannot creep past the +/-3500 ppm rule."""
    fdco = freq_mhz * cur.n1 * cur.hsdiv
    if (abs(fdco - cur.fdco_mhz) / cur.fdco_mhz <= SI570_SMOOTH_DELTA
            and SI570_FDCO_MIN_MHZ <= fdco <= SI570_FDCO_MAX_MHZ):
        return Si570Config(freq_mhz, cur.hsdiv, cur.n1, cur.fdco_mhz,
                           fdco / fxtal_mhz)
    return None


def si570_config_to_regs(cfg: Si570Config) -> bytes:
    """Pack (HS_DIV-4, N1-1, 38-bit RFREQ) into registers 7..12
    (`Si570_ConfigToRegs` `osc_si570.c:352-400`)."""
    n1_reg = cfg.n1 - 1
    hs_reg = cfg.hsdiv - 4
    regs = bytearray(6)
    regs[0] = ((hs_reg << 5) & 0xE0) | (n1_reg >> 2)
    regs[1] = (n1_reg & 3) << 6
    whole = math.floor(cfg.rfreq)
    frac = math.floor((cfg.rfreq - whole) * POW_2_28)
    for i in (5, 4, 3):
        regs[i] = frac & 0xFF
        frac >>= 8
    regs[2] = ((frac & 0xF)) | ((whole & 0xF) << 4)
    regs[1] |= (whole >> 4) & 0x3F
    return bytes(regs)


def si570_regs_to_config(regs: bytes, fout_mhz: float) -> Si570Config:
    """Inverse packing, used at startup to derive the true crystal
    frequency from the factory-calibrated registers and the known startup
    output frequency (`osc_si570.c:592`)."""
    hsdiv = (regs[0] >> 5) + 4
    n1 = (((regs[0] & 0x1F) << 2) | (regs[1] >> 6)) + 1
    whole = ((regs[1] & 0x3F) << 4) | (regs[2] >> 4)
    frac = ((regs[2] & 0xF) << 24) | (regs[3] << 16) | (regs[4] << 8) | regs[5]
    rfreq = whole + frac / POW_2_28
    fdco = fout_mhz * n1 * hsdiv
    return Si570Config(fout_mhz, hsdiv, n1, fdco, rfreq)


class Si570:
    """Si570 planning front-end with the reference's two-phase interface.

    `reg_writer(base_reg, payload)` stands in for the I2C transaction of
    `Si570_LargeFrequencyChange`/`Si570_SmallFrequencyChange`; tests use a
    recorder, hardware deployments a real bus binding.
    """

    def __init__(self, reg_writer: RegWriter | None = None,
                 startup_regs: bytes | None = None,
                 startup_fout_mhz: float = 56.32,
                 quadrature_mult: int = 4):
        self.write = reg_writer or (lambda reg, data: None)
        self.quadrature_mult = quadrature_mult
        if startup_regs is not None:
            cfg = si570_regs_to_config(startup_regs, startup_fout_mhz)
            # fxtal = fout * n1 * hsdiv / rfreq (osc_si570.c:592)
            self.fxtal_mhz = cfg.fdco_mhz / cfg.rfreq
            self.cur = cfg
        else:
            self.fxtal_mhz = SI570_FACTORY_FXTAL_MHZ
            self.cur = si570_find_config(startup_fout_mhz, self.fxtal_mhz)
        self.ppm = 0.0
        self.fxtal_calc = self.fxtal_mhz
        self.next: Si570Config | None = None
        self.next_is_small = False

    name = "Si570"

    def set_ppm(self, ppm: float) -> None:
        """`Si570_SetPPM` (`osc_si570.c:519-523`)."""
        self.ppm = ppm
        self.fxtal_calc = self.fxtal_mhz * (1.0 + ppm / 1e6)

    def min_frequency_hz(self) -> float:
        return SI570_HARD_MIN_FREQ / self.quadrature_mult

    def max_frequency_hz(self) -> float:
        return SI570_HARD_MAX_FREQ / self.quadrature_mult

    def prepare_next_frequency(self, freq_hz: float,
                               temp_factor_hz: float = 0.0) -> OscResult:
        """Plan the LO at quadrature_mult x tune frequency with soft-TCXO
        temperature correction scaled from its 14 MHz reference
        (`Si570_PrepareNextFrequency`)."""
        f = freq_hz * self.quadrature_mult
        f *= 1.0 + temp_factor_hz / 14_000_000.0
        if not (SI570_HARD_MIN_FREQ <= f <= SI570_HARD_MAX_FREQ):
            return OscResult.TUNE_IMPOSSIBLE
        f_mhz = f / 1e6
        nxt = _si570_smooth(self.cur, f_mhz, self.fxtal_calc) \
            if self.cur else None
        self.next_is_small = nxt is not None
        if nxt is None:
            nxt = si570_find_config(f_mhz, self.fxtal_calc)
        if nxt is None:
            return OscResult.TUNE_IMPOSSIBLE
        self.next = nxt
        if not (SI570_MIN_FREQ <= f <= SI570_MAX_FREQ):
            return OscResult.TUNE_LIMITED
        return OscResult.OK

    def is_next_step_large(self) -> bool:
        return not self.next_is_small

    def change_to_next_frequency(self) -> OscResult:
        if self.next is None:
            return OscResult.COMM_ERROR
        self.write(7, si570_config_to_regs(self.next))
        self.cur, self.next = self.next, None
        return OscResult.OK


# --------------------------------------------------------------- Si5351A

SI5351_XTAL_FREQ = 27_000_000
SI5351_MIN_PLL = 405_000_000
SI5351_MAX_PLL = 900_000_000
SI5351_MAX_DIVIDER = 900
SI5351_MAX_DIVIDER_PHASE90 = 126
SI5351_MIN_FREQ_PHASE90 = SI5351_MIN_PLL // SI5351_MAX_DIVIDER_PHASE90 + 1
MAX_UINT20 = 1048575
SI5351_SYNTH_PLL_A = 26
SI5351_SYNTH_MS_0, SI5351_SYNTH_MS_1, SI5351_SYNTH_MS_2 = 42, 50, 58
SI5351_CLK1_PHASE_OFFSET = 166
SI5351_DIV_BY_4 = 0b00001100


@dataclass
class Si5351Config:
    frequency: int = 0              # oscillator output frequency, Hz
    pll_mult: int = 0
    pll_num: int = 0
    pll_denom: int = MAX_UINT20
    multisynth_divider: int = 0
    multisynth_rdiv: int = 0
    phased_output: bool = False
    pllreset: bool = True


def si5351_config_for_divider(freq_hz: int, divider: int,
                              phased: bool,
                              xtal: int = SI5351_XTAL_FREQ
                              ) -> Si5351Config | None:
    """PLL fraction for a fixed divider
    (`Si5351a_CalculateConfigForDivider`): pll = divider*freq,
    mult = pll // xtal, num/denom = 20-bit fraction with denom pinned at
    2^20-1."""
    pll = divider * freq_hz
    mult = pll // xtal
    num = int((pll % xtal) * MAX_UINT20 / xtal)
    cfg = Si5351Config(frequency=freq_hz, pll_mult=mult, pll_num=num,
                       multisynth_divider=divider, phased_output=phased)
    return cfg if si5351_validate(cfg) else None


def si5351_validate(cfg: Si5351Config) -> bool:
    """`Si5351a_ValidateConfig`: divider 4, 6 or 8..900 (<=126 when
    phased), rdiv well-formed, PLL mult 15..90, 20-bit fraction."""
    ok = (cfg.multisynth_divider in (4, 6)
          or 8 <= cfg.multisynth_divider <= SI5351_MAX_DIVIDER)
    if ok and cfg.phased_output:
        ok = cfg.multisynth_divider <= SI5351_MAX_DIVIDER_PHASE90
    if ok:
        ok = (cfg.multisynth_rdiv & ~0b01110000) == 0
    if ok:
        ok = (15 <= cfg.pll_mult <= 90 and cfg.pll_num <= MAX_UINT20
              and cfg.pll_denom <= MAX_UINT20)
    return ok


def si5351_calculate_config(freq_hz: int, cur: Si5351Config,
                            phased: bool) -> Si5351Config | None:
    """Divider selection (`Si5351a_CalculateConfig`): prefer reusing the
    current divider (no PLL reset glitch), else the largest admissible
    divider (best jitter), else the smallest; even dividers whenever
    phased or small."""
    divider_max = SI5351_MAX_PLL // freq_hz
    if (phased or divider_max < 8) and divider_max % 2:
        divider_max -= 1
    divider_min = SI5351_MIN_PLL // freq_hz
    if SI5351_MIN_PLL % freq_hz:
        divider_min += 1
    if (phased or divider_min < 8) and divider_min % 2:
        divider_min += 1
    limit = SI5351_MAX_DIVIDER_PHASE90 if phased else SI5351_MAX_DIVIDER

    cfg = None
    if (cur.phased_output == phased
            and divider_min <= cur.multisynth_divider <= divider_max):
        cfg = si5351_config_for_divider(freq_hz, cur.multisynth_divider,
                                        phased)
    if cfg is None and divider_max <= limit:
        cfg = si5351_config_for_divider(freq_hz, divider_max, phased)
    if cfg is None and divider_min >= 4:
        cfg = si5351_config_for_divider(freq_hz, divider_min, phased)
    if cfg is not None:
        cfg.pllreset = cur.multisynth_divider != cfg.multisynth_divider
    return cfg


def si5351_pll_regs(mult: int, num: int, denom: int) -> bytes:
    """`Si5351a_SetupPLL` P1/P2/P3 packing (`osc_si5351a.c:125-153`)."""
    fract = int(128.0 * (num / denom))
    p1 = 128 * mult + fract - 512
    p2 = 128 * num - denom * fract
    p3 = denom
    return bytes([
        (p3 >> 8) & 0xFF, p3 & 0xFF,
        (p1 >> 16) & 0x03, (p1 >> 8) & 0xFF, p1 & 0xFF,
        ((p3 >> 12) & 0xF0) | ((p2 >> 16) & 0x0F),
        (p2 >> 8) & 0xFF, p2 & 0xFF,
    ])


def si5351_multisynth_regs(divider: int, rdiv: int) -> bytes:
    """`Si5351a_SetupMultisynthInteger` (`osc_si5351a.c:156-185`)."""
    p1 = 128 * divider - 512
    return bytes([
        0, 1,
        ((p1 >> 16) & 0x03) | rdiv | (SI5351_DIV_BY_4 if divider == 4 else 0),
        (p1 >> 8) & 0xFF, p1 & 0xFF,
        0, 0, 0,
    ])


class Si5351:
    """Si5351A planning front-end (two-phase interface like Si570)."""

    def __init__(self, reg_writer: RegWriter | None = None,
                 quadrature: bool = True):
        self.write = reg_writer or (lambda reg, data: None)
        self.quadrature = quadrature    # TEST_QUADRATURE capability
        self.cur = Si5351Config()
        self.next: Si5351Config | None = None

    name = "Si5351A"

    def min_frequency_hz(self) -> float:
        # 4x Johnson-counter mode bottoms out at MIN_PLL/MAX_DIVIDER/4
        return SI5351_MIN_PLL / SI5351_MAX_DIVIDER / 4

    def max_frequency_hz(self) -> float:
        return SI5351_MAX_PLL / 4 / 4   # divider >= 4, 4x clock

    def prepare_next_frequency(self, freq_hz: float,
                               temp_factor_hz: float = 0.0) -> OscResult:
        freq = int(round(freq_hz * (1.0 + temp_factor_hz / 14_000_000.0)))
        phased = self.quadrature and freq > SI5351_MIN_FREQ_PHASE90
        if not phased:
            freq *= 4   # Johnson counter wants 4x (osc_si5351a.c Prepare)
        cfg = si5351_calculate_config(freq, self.cur, phased)
        if cfg is None:
            return OscResult.TUNE_IMPOSSIBLE
        self.next = cfg
        return OscResult.OK

    def is_next_step_large(self) -> bool:
        return False    # reference: Si5351a_IsNextStepLarge always false

    def change_to_next_frequency(self) -> OscResult:
        if self.next is None:
            return OscResult.COMM_ERROR
        cfg = self.next
        self.write(SI5351_SYNTH_PLL_A,
                   si5351_pll_regs(cfg.pll_mult, cfg.pll_num, cfg.pll_denom))
        if cfg.phased_output:
            self.write(SI5351_SYNTH_MS_0, si5351_multisynth_regs(
                cfg.multisynth_divider, cfg.multisynth_rdiv))
            self.write(SI5351_SYNTH_MS_1, si5351_multisynth_regs(
                cfg.multisynth_divider, cfg.multisynth_rdiv))
            # CLK1 phase offset = divider -> 90 degrees (ApplyConfig)
            self.write(SI5351_CLK1_PHASE_OFFSET,
                       bytes([cfg.multisynth_divider]))
        else:
            self.write(SI5351_SYNTH_MS_2, si5351_multisynth_regs(
                cfg.multisynth_divider, cfg.multisynth_rdiv))
        self.cur, self.next = cfg, None
        return OscResult.OK


def planned_output_hz(osc, tune_hz: float, temp_factor_hz: float = 0.0
                      ) -> float:
    """Actual synthesized LO frequency for a planned tune — the residual
    vs. the request is the synthesis error (sub-Hz for Si570; up to the
    20-bit fraction granularity for Si5351)."""
    r = osc.prepare_next_frequency(tune_hz, temp_factor_hz)
    if r not in (OscResult.OK, OscResult.TUNE_LIMITED):
        raise ValueError(f"tune impossible: {tune_hz}")
    cfg = osc.next
    if isinstance(cfg, Si570Config):
        fdco = cfg.rfreq * osc.fxtal_calc
        return fdco / (cfg.n1 * cfg.hsdiv) * 1e6 / osc.quadrature_mult
    pll = (cfg.pll_mult + cfg.pll_num / cfg.pll_denom) * SI5351_XTAL_FREQ
    out = pll / cfg.multisynth_divider
    return out if cfg.phased_output else out / 4
