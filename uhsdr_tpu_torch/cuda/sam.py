"""SAM's sideband stage, fused: wrapper around `sam_sideband_kernel` in
`kernels/sam.cu`, beside its plain torch version.

The stage is `demod/sam.py`'s usb, lsb and stereo route after the PLL
(the reference's demod/sam.py:188-236): the four products of the input
with K10's cos and sin, two of them delayed one sample, each through a
7-section z^-2 allpass chain (C0 or C1), the USB and/or LSB combine and
the fade leveler.  The TPU kernel it takes the place of is K11
(uhsdr_tpu/pallas/iir.py::_make_kernel, via `biquad_cascade_pallas`),
which the reference runs on the two stacked allpass pairs; the products,
delays, combine and the fade leveler's blocked one-poles around it were
array operations there and a dozen torch passes here before.  The
kernel walks each channel in four lanes, one a path, on K11's tile ring
(`kernels/ring.cuh`, laid out by `cuda/ring.py`; see the source).

The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it checks its arguments, launches the kernel on the current
stream (building it on first use), raises if the launch failed and adds
one to ``SAM_SIDEBAND.launches``.  There is no fallback.  The launch rule
is `sam_geometry`.

The allpass sections [c, 0, 1, 0, c] run as y = c*x + s1; s1 = s2; s2 =
x - c*y, the DF2T recurrence with its products by 0 and 1 dropped, in
the kernel and in `sam_sideband_plain` alike: on finite inputs the same
values as `cuda.iir.biquad_cascade_plain` on those rows (a zero's sign
aside), so the plain version's allpass outputs and states equal the
composition it replaces bit for bit (tests/test_torch_sam_sideband.py).
The fade leveler runs as the sequential one-pole, as K9 runs it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import ring
from .build import CudaKernel, derived, sm_count, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

SAM_SIDEBAND = CudaKernel("sam_sideband", "sam.cu", {
    "uhsdr_sam_sideband_launch": ([_P] * 7 + [_F] * 4 + [_I] * 6
                                  + [_P] * 5, _I),
    "uhsdr_sam_sideband_smem": ([_I, _I], _I),
    "uhsdr_sam_threads": ([], _I),
    "uhsdr_sam_walkers": ([], _I),
    "uhsdr_sam_tile": ([], _I),
    "uhsdr_sam_stages": ([], _I),
}, extra_flags=("-fmad=false",))

SIDEBANDS = ("usb", "lsb", "stereo")      # the kernel's modes 0, 1, 2
SAM_SECTIONS = 7
SAM_MAX_LANES = 8       # channels of a walker warp (four lanes each)


class SamGeometry(NamedTuple):
    """The fused stage's launch (`kernels/sam.cu::sam_sideband_kernel`)."""
    lanes: int      # channels of each walker warp (four lanes a channel)
    channels: int   # channels a block: walkers * lanes
    blocks: int     # the grid
    smem: int       # dynamic shared memory, bytes


def sam_geometry(C: int, T: int, n_audio: int = 1,
                 sms: int = ring.SMS) -> SamGeometry:
    """The launch rule: the fewest channels a walker warp (up to 8, four
    lanes each) that puts the C channels in at most `sms` blocks, so that
    every SM runs a block and each of its four schedulers one walker;
    past 8 (C > 32 sms) the blocks run several an SM (two at the SAM
    flagship's 8192 channels: 1024 walker warps, about two a scheduler).
    A stage holds each channel's iq (2 TA + 4 floats), cos, sin and
    n_audio audio rows (TA + 4 each).  Raises ValueError for an empty
    launch."""
    if C < 1 or T < 1 or sms < 1 or n_audio not in (1, 2):
        raise ValueError(f"sam_sideband: {C} channels of {T} samples, "
                         f"{n_audio} audio channels, on {sms} SMs")
    lanes = min(SAM_MAX_LANES, -(-C // (ring.WALKERS * sms)))
    cb = ring.WALKERS * lanes
    ta = ring.TILE
    stage = cb * ((2 * ta + 4) + (2 + n_audio) * (ta + 4))
    return SamGeometry(lanes, cb, -(-C // cb), ring.STAGES * stage * 4)


def _lib():
    """The stage's library, its layout checked against `cuda/ring.py`'s."""
    return ring.checked_lib(SAM_SIDEBAND, "sam")


def _allpass_c(sos) -> tuple:
    """The section coefficient c of each allpass row [c, 0, 1, 0, c]
    (raises ValueError for another row)."""
    v = np.asarray(sos, np.float32)
    if v.shape != (SAM_SECTIONS, 5) or not (
            np.all(v[:, 1] == 0) and np.all(v[:, 2] == 1)
            and np.all(v[:, 3] == 0) and np.all(v[:, 4] == v[:, 0])):
        raise ValueError("sam_sideband: allpass rows [c, 0, 1, 0, c] of "
                         f"{SAM_SECTIONS} sections expected")
    return tuple(float(c) for c in v[:, 0])


def allpass_plain(c: torch.Tensor, state: torch.Tensor, x: torch.Tensor):
    """The allpass chains' recurrence as the kernel runs it, per section
    y = c*x + s1; s1 = s2; s2 = x - c*y.  c: (S, ...) per-section
    coefficients broadcasting against x's rows; state (S, ..., 2); x
    (..., T).  Returns (y (..., T), new_state (S, ..., 2))."""
    s1 = list(state[..., 0].unbind(0))
    s2 = list(state[..., 1].unbind(0))
    cs = c.unbind(0)
    ys = []
    for v in x.unbind(-1):
        for k, ck in enumerate(cs):
            out = ck * v + s1[k]
            s1[k] = s2[k]
            s2[k] = v - ck * out
            v = out
        ys.append(v)
    new_state = torch.stack([torch.stack([a, b], dim=-1)
                             for a, b in zip(s1, s2)], dim=0)
    return torch.stack(ys, dim=-1), new_state


def fade_loop(mR: float, mI: float, dc, dci, audio, corr):
    """The fade leveler's sequential one-poles, as K9 and the kernel run
    them: dc = mR*dc + (1-mR)*audio; dci = mI*dci + (1-mI)*corr; out =
    audio + dci - dc.  audio (..., T); corr broadcasts against it.
    Returns (out, dc, dci)."""
    aR = float(np.float32(1.0 - mR))
    aI = float(np.float32(1.0 - mI))
    corr = corr.expand(audio.shape)
    outs = []
    for a, cr in zip(audio.unbind(-1), corr.unbind(-1)):
        dc = mR * dc + aR * a
        dci = mI * dci + aI * cr
        outs.append(a + dci - dc)
    return torch.stack(outs, dim=-1), dc, dci


def sam_sideband_plain(ap_sos, fade, ap_state, ds, fade_state, iq, cos, sin,
                       sideband: str, fade_on: bool):
    """Plain torch version of the fused stage, in the kernel's order: the
    products and the one-sample delays, the four allpass chains
    (`allpass_plain`), the combine, the fade leveler (`fade_loop`).
    Arguments and results as `sam_sideband`'s."""
    if sideband not in SIDEBANDS:
        raise ValueError(f"sam_sideband: sideband {sideband!r}")
    i_t, q_t = iq.real, iq.imag
    ai, bi = cos * i_t, sin * i_t
    aq, bq = cos * q_t, sin * q_t
    # path inputs: a = ai delayed 1, b = bi, c = bq delayed 1, d = aq
    x = torch.stack([torch.cat([ds[:, 0:1], ai[:, :-1]], dim=-1), bi,
                     torch.cat([ds[:, 1:2], bq[:, :-1]], dim=-1), aq])
    cs = [torch.as_tensor(_allpass_c(s.detach().cpu()), device=iq.device)
          for s in ap_sos]
    coef = torch.stack([cs[0], cs[1], cs[0], cs[1]], dim=-1)[..., None]
    # ap_state is (paths, sections, C, 2); the chains take sections first
    y, st = allpass_plain(coef, ap_state.transpose(0, 1), x)
    ap_new = st.transpose(0, 1).contiguous()
    a, b, c, d = y.unbind(0)
    side = {}
    if sideband != "lsb":
        side["usb"] = (a - b) + (d + c)
    if sideband != "usb":
        side["lsb"] = (a + b) - (d - c)
    # stereo: LSB left, USB right (audio_driver.c:2092-2095)
    audio = (torch.stack([side["lsb"], side["usb"]], dim=-2)
             if sideband == "stereo" else side[sideband])
    ds_new = torch.stack([ai[:, -1], bq[:, -1]], dim=-1)
    if not fade_on:
        return audio, ap_new, ds_new, fade_state
    corr = i_t * cos + q_t * sin
    if audio.ndim == 3:                 # stereo: one carrier
        corr = corr[:, None, :]
    out, dc, dci = fade_loop(fade[0], fade[1], fade_state[0], fade_state[1],
                             audio, corr)
    return out, ap_new, ds_new, (dc, dci)


def _coefficients(ap_sos) -> ctypes.Array:
    """C0's and C1's section coefficients as the launch's 14 host floats,
    read once per (tensor, version)."""
    c0 = derived(ap_sos[0], "allpass_c", _allpass_c)
    c1 = derived(ap_sos[1], "allpass_c", _allpass_c)
    return (ctypes.c_float * (2 * SAM_SECTIONS))(*c0, *c1)


def sam_sideband(ap_sos, fade, ap_state, ds, fade_state, iq, cos, sin,
                 sideband: str, fade_on: bool):
    """SAM's sideband stage in one launch.  ap_sos: (C0 rows, C1 rows),
    two (7, 5) f32 allpass tensors [c, 0, 1, 0, c]; fade: (mtauR, mtauI)
    as f32 values; ap_state: (4, 7, C, 2) f32 allpass states of the
    paths a, b, c, d; ds: (C, 2) f32 one-sample delays [ai, bq];
    fade_state: (dc, dc_insert), each (C,), or (C, 2) for stereo; iq:
    (C, T) complex64; cos, sin: (C, T) f32, K10's.  sideband: 'usb',
    'lsb' or 'stereo' (audio (C, 2, T), LSB left).  fade_on: run the
    fade leveler (else fade_state comes back as it went in).  Returns
    (audio, new ap_state, new ds, new fade_state)."""
    if iq.device.type == "cpu":
        return sam_sideband_plain(ap_sos, fade, ap_state, ds, fade_state,
                                  iq, cos, sin, sideband, fade_on)
    if sideband not in SIDEBANDS:
        raise ValueError(f"sam_sideband: sideband {sideband!r}")
    dev = iq.device
    if iq.ndim != 2 or iq.shape[-1] < 1 or iq.dtype != torch.complex64:
        raise ValueError("sam_sideband: iq must be (C, T) complex64, T >= 1")
    C, T = iq.shape
    na = 2 if sideband == "stereo" else 1
    fshape = (C, na) if na == 2 else (C,)
    dc, dci = fade_state
    if (cos.shape != (C, T) or sin.shape != (C, T)
            or ap_state.shape != (4, SAM_SECTIONS, C, 2)
            or ds.shape != (C, 2) or dc.shape != fshape
            or dci.shape != fshape):
        raise ValueError("sam_sideband: cos, sin (C, T); ap_state (4, 7, "
                         f"C, 2); ds (C, 2); fade states {fshape}")
    if any(t.dtype != torch.float32 or t.device != dev
           or not t.is_contiguous()
           for t in (cos, sin, ap_state, ds, dc, dci)) \
            or not iq.is_contiguous():
        raise ValueError("sam_sideband: contiguous f32 tensors (iq "
                         "complex64) on one device")
    coef = _coefficients(ap_sos)
    geo = sam_geometry(C, T, na, sm_count(dev.index))
    audio = torch.empty((C, na, T) if na == 2 else (C, T),
                        dtype=torch.float32, device=dev)
    ap_new = torch.empty_like(ap_state)
    ds_new = torch.empty_like(ds)
    fade_in = torch.stack([dc, dci]) if fade_on else ds
    fade_out = torch.empty_like(fade_in) if fade_on else ds_new
    vec = int(T % 4 == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (iq, cos, sin, audio)))
    err = _lib().uhsdr_sam_sideband_launch(
        iq.data_ptr(), cos.data_ptr(), sin.data_ptr(), ap_state.data_ptr(),
        ds.data_ptr(), fade_in.data_ptr(), coef, fade[0],
        float(np.float32(1.0 - fade[0])), fade[1],
        float(np.float32(1.0 - fade[1])), C, T, geo.lanes, vec,
        SIDEBANDS.index(sideband), int(fade_on), audio.data_ptr(),
        ap_new.data_ptr(), ds_new.data_ptr(), fade_out.data_ptr(),
        stream_ptr(dev))
    SAM_SIDEBAND.check(err)
    SAM_SIDEBAND.launches += 1
    new_fade = (fade_out[0], fade_out[1]) if fade_on else fade_state
    return audio, ap_new, ds_new, new_fade
