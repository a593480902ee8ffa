"""Spectral noise reduction: Ephraim-Malah / Romanin MMSE spectral
subtraction with speech-presence probability.

The torch counterpart of `uhsdr_tpu.nr.spectral`.  Reference:
`spectral_noise_reduction_3` (`audio_nr.c:1841-2180`).  Per 256-point
frame at 50% overlap, windowed by the symmetric sqrt-Hann: X = |FFT|^2,
the noise estimate and speech-presence recurrence (bootstrapped over the
first 20 frames), the MMSE gain, the musical-noise smoothing, the
weighted spectrum's inverse FFT windowed again and overlap-added (one hop
of latency, carried in state).  The FFTs are `torch.fft` (cuFFT on the
card); the gain machine between them is one kernel a block
(`cuda.nr.nr_gains`; its plain version on the CPU).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..cuda import nr as nr_kernel
from ..ops import fftutil

FFT_L = nr_kernel.FFT_L
HOP = FFT_L // 2
NB = nr_kernel.NB
PSINI = nr_kernel.PSINI
PSPRI = 0.5
ASNR_DB = 30.0


class NrParams(NamedTuple):
    alpha: float                # SNR-prio smoothing (0.799 + strength/1000)
    power_threshold: float
    vad_low: int                # first bin of the filter passband
    vad_high: int               # one past the last
    xih1: float
    xih1r: float
    pfac: float


def make_params(fs: float, f_low: float, f_high: float,
                alpha: float = 0.94, power_threshold: float = 0.4
                ) -> NrParams:
    bin_bw = fs / FFT_L
    vad_low = int(np.clip(int(f_low / bin_bw), 1, FFT_L // 2 - 2))
    vad_high = int(np.clip(int(f_high / bin_bw), vad_low + 1, FFT_L // 2))
    xih1 = 10.0 ** (ASNR_DB / 10.0)
    xih1r = 1.0 / (1.0 + xih1) - 1.0
    pfac = (1.0 / PSPRI - 1.0) * (1.0 + xih1)
    return NrParams(alpha=float(np.float32(alpha)),
                    power_threshold=float(np.float32(power_threshold)),
                    vad_low=vad_low, vad_high=vad_high,
                    xih1=xih1, xih1r=xih1r, pfac=pfac)


def params_from_numpy(p) -> NrParams:
    return NrParams(float(np.float32(p.alpha)),
                    float(np.float32(p.power_threshold)), int(p.vad_low),
                    int(p.vad_high), float(p.xih1), float(p.xih1r),
                    float(p.pfac))


class NrState(NamedTuple):
    last_half: torch.Tensor   # (..., HOP) previous input half-frame
    ola_tail: torch.Tensor    # (..., HOP) pending overlap-add tail
    xt: torch.Tensor          # (..., NB) noise estimate
    pslp: torch.Tensor        # (..., NB)
    hk_old: torch.Tensor      # (..., NB)
    init_count: torch.Tensor  # (...,) int32 bootstrap frame counter
    nest_acc: torch.Tensor    # (..., NB) bootstrap accumulator


def init_state(batch_shape, device=None) -> NrState:
    bs = tuple(batch_shape)

    def full(shape, v):
        return torch.full(bs + shape, v, dtype=torch.float32, device=device)

    return NrState(
        last_half=full((HOP,), 0.0), ola_tail=full((HOP,), 0.0),
        xt=full((NB,), PSINI), pslp=full((NB,), 0.5),
        hk_old=full((NB,), 1.0),
        init_count=torch.zeros(bs, dtype=torch.int32, device=device),
        nest_acc=full((NB,), 0.0))


@functools.lru_cache(maxsize=None)
def _window(device: torch.device) -> torch.Tensor:
    """The firmware's SYMMETRIC sqrt-Hann (audio_nr.c:76) on `device`, made
    once: a copy from the host each block would hold the host until the
    card had caught up."""
    return torch.as_tensor(fftutil.sqrt_hann_sym(FFT_L), device=device)


def process_block(params: NrParams, state: NrState, x: torch.Tensor):
    """x: (..., T) audio at the NR rate, T % HOP == 0.  Returns (y (...,
    T), new_state), one HOP (128 samples) late."""
    T = x.shape[-1]
    if T % HOP:
        raise ValueError(f"NR: block length {T} is not a multiple of {HOP}")
    lead = x.shape[:-1]

    def rows(t, n):
        return t.reshape(-1, n).contiguous()

    xfull = torch.cat([rows(state.last_half, HOP), rows(x, T)], dim=-1)
    frames = fftutil.frame_overlap(xfull, FFT_L, HOP)     # (R, F, 256)
    win = _window(x.device)
    F = torch.fft.rfft(frames * win, dim=-1)               # (R, F, 129)
    G, xt, pslp, hk_old, cnt, acc = nr_kernel.nr_gains(
        nr_kernel.gain_params(params), F, rows(state.xt, NB),
        rows(state.pslp, NB), rows(state.hk_old, NB),
        state.init_count.reshape(-1).contiguous(), rows(state.nest_acc, NB))
    ys = torch.fft.irfft(G, n=FFT_L, dim=-1) * win
    ola = fftutil.overlap_add(ys, HOP)                     # (R, T + HOP)
    y = torch.cat([ola[:, :HOP] + rows(state.ola_tail, HOP),
                   ola[:, HOP:T]], dim=-1)
    return y.reshape(x.shape), NrState(
        last_half=xfull[:, T:].reshape(lead + (HOP,)).clone(),
        ola_tail=ola[:, T:].reshape(lead + (HOP,)).clone(),
        xt=xt.reshape(lead + (NB,)), pslp=pslp.reshape(lead + (NB,)),
        hk_old=hk_old.reshape(lead + (NB,)), init_count=cnt.reshape(lead),
        nest_acc=acc.reshape(lead + (NB,)))
