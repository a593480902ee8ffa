"""Normalized-LMS adaptive filters: the automatic notch, the NLMS NR and
WDSP's variable-leak ("leaky") LMS.

The torch counterpart of `uhsdr_tpu.ops.lms`.  Reference:
`AudioDriver_NotchFilter` (`audio_driver.c:1746-1774`) wraps CMSIS
`arm_lms_norm_f32` with a decorrelation delay (the auto-notch predicts
the tonal component from delayed input and outputs the error, which
keeps speech and drops carriers); `AudioDriver_LeakyLmsNr`
(`audio_driver.c:521-577`) is the same structure with a leakage that a
comparison walk of lidx drives, and outputs the prediction (or the error
in notch mode).  The weight adaptation is sequential per sample; each
block is one kernel launch (`cuda.lms.nlms` / `cuda.lms.leaky`; their
plain versions on the CPU), at the decimated rate, batched over rows.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cuda import lms as lms_kernel


def _f32(v) -> float:
    return float(np.float32(v))


class LmsParams(NamedTuple):
    num_taps: int
    delay: int
    mu: float              # f32 value
    leak: float            # weight leakage (1.0 = none), f32 value
    output_error: bool     # True = notch (error out), False = NR (pred out)


def notch_params(num_taps: int = 96, delay: int = 8,
                 mu: float = 0.01) -> LmsParams:
    return LmsParams(num_taps, delay, _f32(mu), 1.0, True)


def nr_params(num_taps: int = 64, delay: int = 4, mu: float = 0.02,
              leak: float = 0.9999) -> LmsParams:
    return LmsParams(num_taps, delay, _f32(mu), _f32(leak), False)


class LmsState(NamedTuple):
    weights: torch.Tensor   # (C, num_taps)
    history: torch.Tensor   # (C, num_taps + delay) recent inputs


def init_state(batch_shape, params: LmsParams, device=None) -> LmsState:
    bs = tuple(batch_shape)
    return LmsState(
        weights=torch.zeros(bs + (params.num_taps,), dtype=torch.float32,
                            device=device),
        history=torch.zeros(bs + (params.num_taps + params.delay,),
                            dtype=torch.float32, device=device))


class LeakyLmsParams(NamedTuple):
    num_taps: int          # 64
    delay: int             # 16
    two_mu: float          # 0.0001 ("gain"); every float an f32 value
    gamma: float           # 0.1 ("leakage")
    lidx_min: float
    lidx_max: float
    den_mult: float        # 6.25e-10
    lincr: float
    ldecr: float
    output_error: bool     # True = notch (error out), False = NR (pred out)


def leaky_lms_params(notch: bool = False, num_taps: int = 64,
                     delay: int = 16, two_mu: float = 1e-4,
                     gamma: float = 0.1) -> LeakyLmsParams:
    """Defaults from AudioDriver_Dsp_Init (audio_driver.c:490-514)."""
    return LeakyLmsParams(
        num_taps=num_taps, delay=delay, two_mu=_f32(two_mu),
        gamma=_f32(gamma), lidx_min=0.0, lidx_max=200.0,
        den_mult=_f32(6.25e-10), lincr=1.0, ldecr=3.0, output_error=notch)


def params_from_numpy(p):
    """The reference's LmsParams or LeakyLmsParams (NumPy scalars) -> the
    port's."""
    if hasattr(p, "two_mu"):
        return LeakyLmsParams(int(p.num_taps), int(p.delay),
                              *(_f32(getattr(p, f)) for f in (
                                  "two_mu", "gamma", "lidx_min", "lidx_max",
                                  "den_mult", "lincr", "ldecr")),
                              bool(p.output_error))
    return LmsParams(int(p.num_taps), int(p.delay), _f32(p.mu), _f32(p.leak),
                     bool(p.output_error))


class LeakyLmsState(NamedTuple):
    weights: torch.Tensor   # (C, num_taps)
    history: torch.Tensor   # (C, num_taps + delay)
    lidx: torch.Tensor      # (C,) leakage index walk
    ngamma: torch.Tensor    # (C,) current leakage


def leaky_lms_init(batch_shape, params: LeakyLmsParams,
                   device=None) -> LeakyLmsState:
    bs = tuple(batch_shape)
    return LeakyLmsState(
        weights=torch.zeros(bs + (params.num_taps,), dtype=torch.float32,
                            device=device),
        history=torch.zeros(bs + (params.num_taps + params.delay,),
                            dtype=torch.float32, device=device),
        lidx=torch.full(bs, 120.0, dtype=torch.float32, device=device),
        ngamma=torch.full(bs, 0.001, dtype=torch.float32, device=device))


def _rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) -> contiguous (rows, n)."""
    return t.reshape(-1, n).contiguous()


def run(params: LmsParams, state: LmsState, x: torch.Tensor):
    """x: (..., T), state leaves (..., L) and (..., L + D).  Returns (y,
    new_state)."""
    L, D = params.num_taps, params.delay
    y, w, h = lms_kernel.nlms(params, _rows(state.weights, L),
                              _rows(state.history, L + D),
                              _rows(x, x.shape[-1]))
    lead = x.shape[:-1]
    return y.reshape(x.shape), LmsState(w.reshape(lead + (L,)),
                                        h.reshape(lead + (L + D,)))


def leaky_lms_run(params: LeakyLmsParams, state: LeakyLmsState,
                  x: torch.Tensor):
    """The WDSP leaky LMS (`AudioDriver_LeakyLmsNr`, audio_driver.c:
    521-577) over one block.  x: (..., T).  Returns (y, new_state)."""
    L, D = params.num_taps, params.delay
    lead = x.shape[:-1]
    y, w, h, lidx, ngamma = lms_kernel.leaky(
        params, _rows(state.weights, L), _rows(state.history, L + D),
        state.lidx.reshape(-1).contiguous(),
        state.ngamma.reshape(-1).contiguous(), _rows(x, x.shape[-1]))
    return y.reshape(x.shape), LeakyLmsState(
        w.reshape(lead + (L,)), h.reshape(lead + (L + D,)),
        lidx.reshape(lead), ngamma.reshape(lead))
