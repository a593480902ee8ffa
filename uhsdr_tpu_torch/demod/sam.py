"""Synchronous-AM (SAM) demodulation: Wheatley/cuteSDR + WDSP PLL.

The torch counterpart of `uhsdr_tpu.demod.sam`.  Reference:
`AudioDriver_DemodSAM` (`audio_driver.c:2022-2166`) and its parameter
setup `AudioDriver_SetSamPllParameters` (`audio_driver.c:709-746`).

Per sample:
  1. NCO mix by the PLL phase: ``corr = (i + jq) * exp(-j*phs)``.
  2. Phase detector ``atan2(Im corr, Re corr)``; 2nd-order loop
     ``omega2 += g2*err`` (clamped to ±2π·pll_fmax/fs),
     ``fil_out = g1*err + omega2``, ``phs += fil_out_prev``.
  3. Sideband separation: 4 paths (delayed(ai), bi, delayed(bq), aq) each
     through a 7-stage cascade of 2nd-order allpasses
     ``y[n] = c*x[n] + x[n-2] - c*y[n-2]`` (coefficient sets C0/C1,
     `audio_driver.c:1932-1953`), combined to USB or LSB, or to both as
     two-channel audio (stereo: LSB left, USB right).
  4. Fade leveler (see demod.am).

Three routes, as the reference's (demod/sam.py:154-236): sideband 'both'
with the fade leveler runs the fused K9 kernel (`cuda.pll.pll_audio`);
everything else runs K10 (`cuda.pll.pll`, cos/sin of the loop phase);
'both' without the fade leveler then mixes in plain torch, and a single
sideband or 'stereo' runs the whole sideband stage (the products and
delays, the four allpass chains the reference runs through K11, the
combine and the fade leveler) as one fused launch
(`cuda.sam.sam_sideband`); 'stereo' keeps both sidebands, (C, 2, T),
with the fade leveler per audio channel against the one carrier
estimate.  On CPU tensors the stage runs its plain version, whose fade
leveler is the sequential one-pole K9 runs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cuda import pll as pll_kernel
from ..cuda import sam as sam_kernel
from . import am

# sideband-separation allpass coefficients (values from the public
# WDSP/cuteSDR phase-splitter design, as used by the reference)
C0 = np.array([
    -0.328201924180698, -0.744171491539427, -0.923022915444215,
    -0.978490468768238, -0.994128272402075, -0.998458978159551,
    -0.999790306259206], np.float32)
C1 = np.array([
    -0.0991227952747244, -0.565619728761389, -0.857467122550052,
    -0.959123933111275, -0.988739372718090, -0.996959189310611,
    -0.999282492800792], np.float32)

N_STAGES = 7


def allpass_sos(c: np.ndarray) -> np.ndarray:
    """(N_STAGES, 5) biquad rows [b0, b1, b2, a1, a2] = [c, 0, 1, 0, c] of
    the z^-2 allpasses y[n] = c*x[n] + x[n-2] - c*y[n-2]."""
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack([c, z, o, z, c], axis=-1)


class SamParams(NamedTuple):
    g1: float            # f32 values as Python floats
    g2: float
    omega_min: float
    omega_max: float
    fade: am.FadeLevelerParams
    ap_sos: tuple        # (C0 rows, C1 rows): two (N_STAGES, 5) f32 tensors


def params_from_numpy(p, device=None) -> SamParams:
    """SamParams on `device` from anything with the reference's SamParams
    fields (g1, g2, omega_min, omega_max, fade) as f32 scalars."""
    def f32(v):
        return float(np.float32(v))

    return SamParams(
        g1=f32(p.g1), g2=f32(p.g2), omega_min=f32(p.omega_min),
        omega_max=f32(p.omega_max),
        fade=am.FadeLevelerParams(f32(p.fade.mtauR), f32(p.fade.mtauI)),
        ap_sos=tuple(torch.as_tensor(allpass_sos(c), device=device)
                     for c in (C0, C1)))


def make_params(fs: float, zeta: float = 0.6, omegaN: float = 200.0,
                pll_fmax: float = 500.0, device=None) -> SamParams:
    """PLL presets (reference comments): DX 0.2/70, medium 0.6/200, fast
    1.0/500."""
    g1 = 1.0 - np.exp(-2.0 * omegaN * zeta / fs)
    g2 = -g1 + 2.0 * (1 - np.exp(-omegaN * zeta / fs)
                      * np.cos(omegaN / fs * np.sqrt(1.0 - zeta * zeta)))
    om = 2.0 * np.pi * pll_fmax / fs
    return params_from_numpy(
        SamParams(g1, g2, -om, om, am.fade_leveler_params(fs), ()), device)


class SamState(NamedTuple):
    phs: torch.Tensor       # (C,) PLL phase
    fil_out: torch.Tensor   # (C,) loop filter output (applied next sample)
    omega2: torch.Tensor    # (C,) frequency estimate
    ap_state: torch.Tensor  # (4, N_STAGES, C, 2) allpass states per path
    ds: torch.Tensor        # (C, 2) one-sample delays [ai, bq]
    fade: am.FadeLevelerState


def init_state(batch_shape, device=None, n_audio: int = 1) -> SamState:
    """n_audio=2 for the stereo sideband (two-channel audio out,
    `audio_driver.c:2092-2095`): the fade leveler then runs per audio
    channel (`audio_driver.c:2108`)."""
    bs = tuple(batch_shape)
    fade_shape = bs + ((n_audio,) if n_audio > 1 else ())

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return SamState(
        phs=zeros(bs), fil_out=zeros(bs), omega2=zeros(bs),
        ap_state=zeros((4, N_STAGES) + bs + (2,)), ds=zeros(bs + (2,)),
        fade=am.fade_leveler_init(fade_shape, device=device))


def demod(params: SamParams, state: SamState, iq: torch.Tensor,
          sideband: str = "usb", fade_leveler_on: bool = True):
    """iq (C, T) complex64 at the decimated rate -> (audio (C, T), the
    carrier-offset estimate omega2 (C,) in rad/sample, new_state).
    sideband: 'usb' | 'lsb' | 'both' (both = plain product detector) |
    'stereo' (audio (C, 2, T), LSB left and USB right, state from
    ``init_state(bs, n_audio=2)``)."""
    if sideband not in ("usb", "lsb", "both", "stereo"):
        raise ValueError(f"sam sideband {sideband!r}")
    scalars = pll_kernel.PllScalars(params.g1, params.g2, params.omega_min,
                                    params.omega_max)
    iq = iq.contiguous()
    if sideband == "both" and fade_leveler_on:
        carry = torch.stack([state.phs, state.fil_out, state.omega2,
                             state.fade.dc, state.fade.dc_insert], dim=0)
        audio, co = pll_kernel.pll_audio(
            scalars, params.fade.mtauR, params.fade.mtauI, carry, iq)
        new_state = state._replace(
            phs=co[0], fil_out=co[1], omega2=co[2],
            fade=am.FadeLevelerState(dc=co[3], dc_insert=co[4]))
        return audio, co[2], new_state

    carry = torch.stack([state.phs, state.fil_out, state.omega2], dim=0)
    cos_p, sin_p, co = pll_kernel.pll(scalars, carry, iq)
    if sideband == "both":              # the product detector, no leveler
        audio = iq.real * cos_p + iq.imag * sin_p
        return audio, co[2], state._replace(phs=co[0], fil_out=co[1],
                                            omega2=co[2])
    audio, ap_state, ds_new, fade = sam_kernel.sam_sideband(
        params.ap_sos, params.fade, state.ap_state.contiguous(),
        state.ds.contiguous(), tuple(f.contiguous() for f in state.fade),
        iq, cos_p, sin_p, sideband, fade_leveler_on)
    new_state = SamState(phs=co[0], fil_out=co[1], omega2=co[2],
                         ap_state=ap_state, ds=ds_new,
                         fade=am.FadeLevelerState(*fade))
    return audio, co[2], new_state
