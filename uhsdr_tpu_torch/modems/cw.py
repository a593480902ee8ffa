"""CW receive: batched keying detection.

The counterpart of `uhsdr_tpu.modems.cw` (reference `CwDecode_RxProcessor`
/ `CW_Decode_exe`, `cw/cw_decoder.c:383,160-310`): decimated audio is
chopped into frames of ``blocksize`` (default 88) samples at 12 kHz; per
frame a Goertzel magnitude at the sidetone frequency (a projection onto
cos/sin vectors), smoothed against the previous frame's (SIGNAL_TAU =
0.1) and compared with a fixed threshold, or with the fldigi-style
decayavg auto-threshold (`atc`), then debounced (two equal decisions in
a row).  The whole signal-to-keying stage is one launch of the
hand-written kernel `kernels/cw.cu` on the card (`cuda/cw.py`), its plain
version on the CPU.  The keying-to-text stage runs on the host
(`modems/cw_text.py::CwTextDecoder`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..chain.rx import resolve_device
from ..cuda import cw as cw_k

SIGNAL_TAU = 0.1


class CwRxParams(NamedTuple):
    fs: float
    target_freq: float
    blocksize: int          # samples per decision frame (reference 88)
    thresh: float           # fixed threshold on the smoothed magnitude^2
    noisecancel: bool
    atc: bool               # fldigi-style auto-threshold
    cos_v: np.ndarray       # (blocksize,) projection vectors
    sin_v: np.ndarray


def make_params(fs: float = 12000.0, target_freq: float = 700.0,
                blocksize: int = 88, thresh: float = 32000.0,
                noisecancel: bool = True, atc: bool = False) -> CwRxParams:
    n = np.arange(blocksize)
    w = 2 * np.pi * target_freq / fs
    return CwRxParams(fs, target_freq, blocksize, thresh, noisecancel, atc,
                      np.cos(w * n).astype(np.float32),
                      np.sin(w * n).astype(np.float32))


class CwRxState(NamedTuple):
    siglevel: torch.Tensor   # (C,) f32 the previous frame's magnitude or v1
    cw_state: torch.Tensor   # (C,) bool the debounced state
    change: torch.Tensor     # (C,) bool a change pending
    env: torch.Tensor        # (C,) f32 the ATC's signal envelope
    noise: torch.Tensor      # (C,) f32 the ATC's noise floor


def init_state(batch_shape, device=None) -> CwRxState:
    """Zero state on `device` (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    bs = tuple(batch_shape)
    f = torch.zeros(bs, dtype=torch.float32, device=dev)
    b = torch.zeros(bs, dtype=torch.bool, device=dev)
    return CwRxState(f, b, b.clone(), f.clone(), f.clone())


def keying_detect(params: CwRxParams, state: CwRxState, audio: torch.Tensor):
    """audio: (C, T) f32 at the decimated rate, T a positive multiple of
    the frame length.  Returns (keying (C, T // blocksize) bool,
    new_state), on audio's device."""
    keying, new = cw_k.cw_detect(params.cos_v, params.sin_v, params.thresh,
                                 params.atc, params.noisecancel,
                                 cw_k.CwLeaves(*state), audio)
    return keying, CwRxState(*new)


def state_to_numpy(state: CwRxState) -> dict:
    """The JAX package's CwRxState layout as NumPy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def state_from_numpy(s, device=None) -> CwRxState:
    """A CwRxState (or its dict, JAX or NumPy leaves) on `device`."""
    dev = resolve_device(device)
    s = s._asdict() if hasattr(s, "_asdict") else s
    dts = {"cw_state": np.bool_, "change": np.bool_}
    return CwRxState(**{k: torch.from_numpy(np.array(
        s[k], dts.get(k, np.float32))).to(dev) for k in CwRxState._fields})
