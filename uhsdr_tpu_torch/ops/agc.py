"""WDSP AGC (Warren Pratt) — look-ahead AGC with a 5-state gain machine.

Reference: `AudioAgc_RunAgcWdsp` (`audio_agc.c:349-595`) and its setup
(`audio_agc.c:126-347`), as `uhsdr_tpu.ops.agc` models it:

* a delay line of ``attack_buffsize`` samples (48 at 12 kHz, 96 at 24);
* ``ring_max`` = max |x| over the samples ahead of the delayed output;
* two one-pole back-averages of the delayed |x| (fast + hang);
* the 5-state machine (0 attack / 1 fast decay / 2 hang-active /
  3 long decay / 4 hang decay) on the detector voltage ``volts``;
* the log-domain gain
  ``mult = (out_target - slope_constant*min(0, log10(volts/max_input))) / volts``.

`make_params` is a NumPy copy of the reference's.  `run` hands the whole
stage to the K3 kernel wrapper (`uhsdr_tpu_torch.cuda.agc`), which runs
the plain torch version for CPU tensors; with ``remove_dc`` (AM/SAM) the
DC blocker `ops.iir.dc_blocker_block` follows the gain.  `run_stereo` is
the linked two-channel AGC of the iq, ssbstereo and SAM stereo modes: the
delay line, the linked detector, its look-ahead max, the machine and the
gain law in one launch (`cuda.agc.agc_stereo`; its plain version is the
reference's torch route around the machine, which the reference runs on
the TPU kernel K13).  The reference's pad to 1024 channels
(ops/agc.py:452-466) is a TPU tiling rule and is not ported.

Per-channel settings: `make_params` takes (C,) ``thresh_db``,
``slope_db`` or ``hang_thresh_db``, and the gain-law fields it derives
(min_volts, slope_constant, hang_level, fixed_gain) are then (C,)
arrays.  `kernel_params` turns them into the kernels' rows, as the
reference's `_chan_rows` (ops/agc.py:240-246) does, and K3 and K13 take
them in place of the scalars.  `make_setup` copies the rows to the
device once; a stream passes its result to every block's `run` or
`run_stereo`.  With the AGC off a (C,) fixed gain multiplies channel
by channel, in `run_stereo` too (the reference's `run_stereo` cannot
broadcast it there).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cuda import agc as agc_kernel
from . import iir

ADC_CLIP_WARN_THRESHOLD = 4096.0   # reference max_input/out_targ
DC_BLOCKER_R = 0.9999              # audio_agc.c:577-594


class AgcParams(NamedTuple):
    attack_buffsize: int
    attack_mult: np.ndarray
    decay_mult: np.ndarray
    fast_decay_mult: np.ndarray
    hang_decay_mult: np.ndarray
    fast_backmult: np.ndarray
    hang_backmult: np.ndarray
    out_target: np.ndarray
    min_volts: np.ndarray
    slope_constant: np.ndarray
    inv_max_input: np.ndarray
    hang_level: np.ndarray
    hang_time_samples: np.ndarray   # int32
    hang_enable: bool
    pop_ratio: np.ndarray
    fixed_gain: np.ndarray
    remove_dc: bool
    agc_off: bool


# mode presets: hangtime seconds (reference `audio_agc.c:240-280`) and
# tau_decay ms (config table defaults)
MODE_PRESETS = {
    "very_long": dict(hangtime=3.000, tau_decay=4.000, tau_fast_decay=0.05),
    "long": dict(hangtime=2.000, tau_decay=2.000, tau_fast_decay=0.005),
    "slow": dict(hangtime=1.000, tau_decay=0.500, tau_fast_decay=0.005),
    "med": dict(hangtime=0.250, tau_decay=0.250, tau_fast_decay=0.005),
    "fast": dict(hangtime=0.100, tau_decay=0.050, tau_fast_decay=0.005),
    "off": dict(hangtime=0.250, tau_decay=0.250, tau_fast_decay=0.005),
}


def make_params(fs: float, mode: str = "med", thresh_db: float = 60.0,
                slope_db: float = 6.0, hang_thresh_db: float = -30.0,
                tau_hang_decay: float = 0.100, hang_enable: bool = False,
                remove_dc: bool = False) -> AgcParams:
    """The reference's AGC setup (a copy of uhsdr_tpu/ops/agc.py:71-142).
    thresh_db / slope_db / hang_thresh_db may be (C,) arrays for
    per-channel settings, which the kernels take as rows."""
    thresh_db = np.asarray(thresh_db, np.float64)
    slope_db = np.asarray(slope_db, np.float64)
    hang_thresh_db = np.asarray(hang_thresh_db, np.float64)
    p = MODE_PRESETS[mode]
    tau_attack = 0.001
    n_tau = 4
    max_input = ADC_CLIP_WARN_THRESHOLD
    out_targ = ADC_CLIP_WARN_THRESHOLD
    tau_fast_backaverage = 0.250
    tau_hang_backmult = 0.500
    pop_ratio = 5.0
    var_gain = 10.0 ** (slope_db / 20.0 / 10.0)
    max_gain = 10.0 ** (thresh_db / 20.0)
    fixed_gain = max_gain / 10.0

    attack_buffsize = int(np.ceil(fs * n_tau * tau_attack))
    attack_mult = 1.0 - np.exp(-1.0 / (fs * tau_attack))
    decay_mult = 1.0 - np.exp(-1.0 / (fs * p["tau_decay"]))
    fast_decay_mult = 1.0 - np.exp(-1.0 / (fs * p["tau_fast_decay"]))
    fast_backmult = 1.0 - np.exp(-1.0 / (fs * tau_fast_backaverage))
    hang_backmult = 1.0 - np.exp(-1.0 / (fs * tau_hang_backmult))
    hang_decay_mult = 1.0 - np.exp(-1.0 / (fs * tau_hang_decay))

    out_target = out_targ * (1.0 - np.exp(-float(n_tau))) * 0.9999
    min_volts = out_target / (var_gain * max_gain)
    tmpA = np.log10(out_target / (max_input * var_gain * max_gain))
    tmpA = np.where(tmpA == 0.0, 1e-16, tmpA)
    slope_constant = (out_target * (1.0 - 1.0 / var_gain)) / tmpA

    convert = 10.0 ** (hang_thresh_db / 20.0)
    tmpB = np.maximum((convert - min_volts) / (max_input - min_volts),
                      1e-8)
    hang_thresh = np.where(max_input > min_volts,
                           1.0 + 0.125 * np.log10(tmpB), 1.0)
    tmpC = 10.0 ** ((hang_thresh - 1.0) / 0.125)
    hang_level = (max_input * tmpC + (out_target / (var_gain * max_gain))
                  * (1.0 - tmpC)) * 0.637

    def f32c(v):
        return (np.asarray(v, np.float32) if np.ndim(v) > 0
                else np.float32(v))

    return AgcParams(
        attack_buffsize=attack_buffsize,
        attack_mult=np.float32(attack_mult),
        decay_mult=np.float32(decay_mult),
        fast_decay_mult=np.float32(fast_decay_mult),
        hang_decay_mult=np.float32(hang_decay_mult),
        fast_backmult=np.float32(fast_backmult),
        hang_backmult=np.float32(hang_backmult),
        out_target=np.float32(out_target),
        min_volts=f32c(min_volts),
        slope_constant=f32c(slope_constant),
        inv_max_input=np.float32(1.0 / max_input),
        hang_level=f32c(hang_level),
        hang_time_samples=np.int32(int(p["hangtime"] * fs)),
        hang_enable=hang_enable,
        pop_ratio=np.float32(pop_ratio),
        fixed_gain=f32c(fixed_gain),
        remove_dc=remove_dc,
        agc_off=(mode == "off"),
    )


class AgcState(NamedTuple):
    delay: torch.Tensor           # (..., attack_buffsize) delayed input
    volts: torch.Tensor           # (...,)
    save_volts: torch.Tensor
    fast_backaverage: torch.Tensor
    hang_backaverage: torch.Tensor
    hang_counter: torch.Tensor    # integer-valued, carried as f32
    decay_type: torch.Tensor      # integer-valued, carried as f32
    state: torch.Tensor           # 0..4, carried as f32
    dc: torch.Tensor              # (..., 2) DC blocker state


# the machine carry order of the reference (ops/agc.py:197-201, :491-495)
CARRY_FIELDS = ("volts", "save_volts", "hang_counter", "decay_type",
                "state", "fast_backaverage", "hang_backaverage")


def init_state(batch_shape, params: AgcParams, device=None) -> AgcState:
    bs = tuple(batch_shape)
    z = torch.zeros(bs, dtype=torch.float32, device=device)
    return AgcState(
        delay=torch.zeros(bs + (params.attack_buffsize,),
                          dtype=torch.float32, device=device),
        volts=z, save_volts=z.clone(), fast_backaverage=z.clone(),
        hang_backaverage=z.clone(), hang_counter=z.clone(),
        decay_type=z.clone(), state=z.clone(),
        dc=torch.zeros(bs + (2,), dtype=torch.float32, device=device))


class KernelParams(NamedTuple):
    """What the kernels take: the scalar settings and, where any gain-law
    field is per channel, the rows (each None otherwise)."""
    scalars: agc_kernel.AgcScalars
    rows: np.ndarray | None        # (3, C) f32 [min_volts, slope_constant,
    #                                hang_level]: K3's
    scan_rows: np.ndarray | None   # (2, C) f32 [min_volts, hang_level]: K13's


def per_channel(params: AgcParams) -> bool:
    """Whether a gain-law field is a (C,) array (the reference's `not
    _scalar_params`)."""
    return any(np.ndim(v) > 0 for v in (params.min_volts,
                                         params.slope_constant,
                                         params.hang_level,
                                         params.fixed_gain))


def kernel_params(params: AgcParams, C: int | None = None) -> KernelParams:
    """AgcParams -> the scalar set the K3 and K13 kernels and their plain
    versions take (the reference's `_pallas_params`), plus the rows of
    the per-channel fields broadcast to C channels and cast to f32 once
    (the reference's `_chan_rows`).  With rows the scalar slots of
    min_volts, slope_constant and hang_level hold NaN: the kernels read
    the rows there."""
    rows = scan_rows = None
    if per_channel(params):
        if C is None:
            raise ValueError("per-channel AGC settings: pass the channel "
                             "count C")

        def row(v):
            return np.broadcast_to(np.asarray(v, np.float32), (C,))

        mv, sc, hl = (row(params.min_volts), row(params.slope_constant),
                      row(params.hang_level))
        rows = np.ascontiguousarray(np.stack([mv, sc, hl]))
        scan_rows = np.ascontiguousarray(np.stack([mv, hl]))
    nan = float("nan")

    def scalar(v):
        return nan if rows is not None else float(v)

    return KernelParams(agc_kernel.AgcScalars(
        attack_mult=float(params.attack_mult),
        fast_decay_mult=float(params.fast_decay_mult),
        decay_mult=float(params.decay_mult),
        hang_decay_mult=float(params.hang_decay_mult),
        fast_backmult=float(params.fast_backmult),
        hang_backmult=float(params.hang_backmult),
        pop_ratio=float(params.pop_ratio),
        hang_level=scalar(params.hang_level),
        hang_time=float(params.hang_time_samples),
        hang_enable=bool(params.hang_enable),
        min_volts=scalar(params.min_volts),
        out_target=float(params.out_target),
        slope_constant=scalar(params.slope_constant),
        inv_max_input=float(params.inv_max_input)), rows, scan_rows)


class AgcSetup(NamedTuple):
    """The operands of one AgcParams at C channels on one device, as every
    block's `run` or `run_stereo` hands them to K3 or the linked stereo
    stage: made once by `make_setup` and passed in, so that a stream's
    blocks pay no host-to-device copy of the per-channel tables."""
    scalars: agc_kernel.AgcScalars
    rows: torch.Tensor | None         # (3, C) K3's and the stage's rows
    gain: torch.Tensor | float        # the AGC-off gain: (C,) or a scalar


def make_setup(params: AgcParams, C: int, device=None) -> AgcSetup:
    """`kernel_params` of `params` at C channels, its rows (and a (C,)
    fixed gain) copied to `device` once."""
    kp = kernel_params(params, C)

    def on(a):
        return None if a is None else torch.as_tensor(a, device=device)

    g = params.fixed_gain
    gain = (float(g) if np.ndim(g) == 0 else
            on(np.broadcast_to(np.asarray(g, np.float32), (C,)).copy()))
    return AgcSetup(kp.scalars, on(kp.rows), gain)


def _fixed_gain(setup: AgcSetup, x: torch.Tensor):
    """x ((C, T) or (C, 2, T)) times the fixed gain of the AGC off, per
    channel where it is a (C,) array."""
    g = setup.gain
    if isinstance(g, float):
        return x * g
    return x * g.reshape((-1,) + (1,) * (x.ndim - 1))


def _setup_for(params, setup, x) -> AgcSetup:
    return make_setup(params, x.shape[0], x.device) if setup is None \
        else setup


def run(params: AgcParams, state: AgcState, x: torch.Tensor,
        setup: AgcSetup | None = None):
    """x: (C, T) audio at the decimated rate.  Returns (y, new_state).
    setup: `make_setup(params, C, x.device)`, made once for a stream;
    None makes it here, for this call."""
    setup = _setup_for(params, setup, x)
    if params.agc_off:
        return _fixed_gain(setup, x), state
    if x.ndim != 2:
        raise ValueError("run: AGC over a (C, T) batch; two-channel "
                         "(C, 2, T) audio takes the linked `run_stereo`")
    carry = torch.stack([getattr(state, f) for f in CARRY_FIELDS], dim=0)
    y, carry_out, new_delay = agc_kernel.agc(
        setup.scalars, carry, state.delay, x, setup.rows)
    dc_state = state.dc
    if params.remove_dc:        # AM/SAM: after the gain (ops/agc.py:487-490)
        y, dc_state = iir.dc_blocker_block(DC_BLOCKER_R, dc_state, y)
    new_state = state._replace(
        delay=new_delay, dc=dc_state,
        **{f: carry_out[i] for i, f in enumerate(CARRY_FIELDS)})
    return y, new_state


def init_state_stereo(batch_shape, params: AgcParams,
                      device=None) -> AgcState:
    """Linked two-channel AGC state (the reference's use_stereo path,
    audio_agc.c:349-595; ops/agc.py:273-284 of the JAX package): the
    delay line carries both channels (..., 2, w) and the DC blocker is per
    channel (..., 2, 2), but the detector and machine state is shared
    (one gain for both channels)."""
    bs = tuple(batch_shape)
    st = init_state(bs, params, device)
    return st._replace(
        delay=torch.zeros(bs + (2, params.attack_buffsize),
                          dtype=torch.float32, device=device),
        dc=torch.zeros(bs + (2, 2), dtype=torch.float32, device=device))


def run_stereo(params: AgcParams, state: AgcState, x: torch.Tensor,
               setup: AgcSetup | None = None):
    """Linked stereo AGC: x (C, 2, T) -> (y (C, 2, T), new_state), the
    reference's use_stereo semantics (AudioAgc_RunAgcWdsp,
    audio_agc.c:383-394, 571-576): the look-ahead detector takes
    max(|L|, |R|), one 5-state machine runs, and the same log-domain gain
    multiplies both delayed channels.  State from `init_state_stereo`;
    setup as for `run`."""
    setup = _setup_for(params, setup, x)
    if params.agc_off:
        return _fixed_gain(setup, x), state
    if x.ndim != 3 or x.shape[-2] != 2:
        raise ValueError("run_stereo: x must be (C, 2, T)")
    carry = torch.stack([getattr(state, f) for f in CARRY_FIELDS], dim=0)
    y, carry_out, new_delay = agc_kernel.agc_stereo(
        setup.scalars, carry, state.delay, x.contiguous(), setup.rows)
    dc_state = state.dc
    if params.remove_dc:        # SAM stereo: per channel, after the gain
        y, dc_state = iir.dc_blocker_block(DC_BLOCKER_R, dc_state, y)
    new_state = state._replace(
        delay=new_delay, dc=dc_state,
        **{f: carry_out[i] for i, f in enumerate(CARRY_FIELDS)})
    return y, new_state
