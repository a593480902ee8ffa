"""The spectral NR's gain machine: wrapper around the hand-written kernel
`kernels/nr.cu`, beside its plain torch version.

A helper kernel with no TPU counterpart: the JAX package walks the frames
of a block as a `lax.scan` of elementwise operations and smooths and
applies the gains as array operations (uhsdr_tpu/nr/spectral.py:148-256);
the FFTs stay outside (`torch.fft`, cuFFT on the card, as `jnp.fft` is
XLA's there).  On the card a torch loop would cost about 40 launches a
frame, 16 frames a block, so everything between the forward and the
inverse FFT is one kernel: X = |F|^2, the noise-estimate and
speech-presence recurrence with the 20-frame bootstrap, the band power
sums before and after the gain, the musical-noise smoothing width and
moving average, the bootstrap bypass and the spectrum times the gains
(the Nyquist bin times 1), in place.  The wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it checks its
arguments, launches the kernel on the current stream (building it on
first use), raises if the launch failed and adds one to
``NR.launches``.  There is no fallback.

The band sums are pairwise trees over the 128 bins (`trees.pair_tree`:
the kernel's warp butterflies, then the four warps' sums in pairs) and
the moving averages left folds from the lowest bin, so kernel and plain
version agree bit for bit where the card's exp and hypot agree with
torch's; the kernel is built with -fmad=false.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .build import CudaKernel, stream_ptr
from .trees import pair_tree

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

NR = CudaKernel("nr", "nr.cu", {
    "uhsdr_nr_launch": ([_P, _I, _I, _P, _P, _P, _P, _P, _I, _I]
                        + [_F] * 9 + [_P] * 6, _I),
}, extra_flags=("-fmad=false",))

FFT_L = 256
NB = FFT_L // 2            # the bins the recurrence runs on
PSTHR = 0.99
PNSAF = 0.01
PSINI = 0.5
SNR_PRIO_MIN = 0.001
AX = 0.7405
AP = 0.8691
MN_WIDTH = 4
INIT_FRAMES = 20


def _f32(v) -> float:
    return float(np.float32(v))


class GainParams(NamedTuple):
    """The f32 constants of the gain machine (`nr.spectral.NrParams`
    reduced to what the kernel reads)."""
    alpha: float
    one_m_alpha: float
    power_threshold: float
    vad_low: int
    vad_high: int
    xih1r: float
    pfac: float
    inv_nn: tuple           # 1 / (2 w + 1), w = 1..MN_WIDTH


def gain_params(p) -> GainParams:
    """From `nr.spectral.NrParams` (or the reference's)."""
    return GainParams(
        _f32(p.alpha), _f32(np.float32(1.0) - np.float32(p.alpha)),
        _f32(p.power_threshold), int(p.vad_low), int(p.vad_high),
        _f32(p.xih1r), _f32(p.pfac),
        tuple(_f32(1.0 / (2 * w + 1)) for w in range(1, MN_WIDTH + 1)))


def _smooth(g: GainParams, hk, X):
    """The musical-noise smoothing of one frame's gains hk (C, NB)
    (`audio_nr.c:2077-2140`): where the in-band power ratio after the
    gain is at most the threshold, the bins in [lo + w, hi - w) take the
    mean of hk over [b - w, b + w], w = (int)(0.5 + 4 (1 - ratio/thr))."""
    band = torch.zeros(NB, dtype=torch.bool, device=hk.device)
    band[g.vad_low:g.vad_high] = True
    pre = pair_tree(torch.where(band, X, 0.0))
    post = pair_tree(torch.where(band, hk * hk * X, 0.0))
    ratio = post / torch.clamp_min(pre, 1e-20)
    thr = torch.full_like(ratio, g.power_threshold)
    nn = torch.where(ratio <= thr,
                     (0.5 + MN_WIDTH * (1.0 - ratio / thr)).to(torch.int32),
                     0)
    b = torch.arange(NB, device=hk.device)
    out = hk
    for w in range(1, MN_WIDTH + 1):
        pad = torch.zeros((hk.shape[0], w), device=hk.device)
        hp = torch.cat([pad, hk, pad], dim=-1)
        avg = hp[:, 0:NB] * g.inv_nn[w - 1]
        for j in range(1, 2 * w + 1):
            avg = avg + hp[:, j:j + NB] * g.inv_nn[w - 1]
        sel = ((nn == w)[:, None] & (b >= g.vad_low + w)
               & (b < g.vad_high - w))
        out = torch.where(sel, avg, out)
    return out


def nr_gains_plain(g: GainParams, F, xt, pslp, hk_old, init_count,
                   nest_acc):
    """Plain torch version of the kernel.  F: (C, nF, 129) complex64, the
    frames' spectra; xt, pslp, hk_old, nest_acc: (C, 128) f32;
    init_count: (C,) int32.  Returns (F times the gains (C, nF, 129), xt,
    pslp, hk_old, init_count, nest_acc)."""
    b = torch.arange(NB, device=F.device)
    band = (b >= g.vad_low) & (b < g.vad_high)
    ones = torch.ones((F.shape[0], 1), device=F.device)
    out = []
    for f in range(F.shape[1]):
        a = F[:, f, :NB].abs()
        X = a * a
        booting = (init_count < INIT_FRAMES)[:, None]
        not_boot = ~booting
        nest_acc = torch.where(booting, nest_acc + 0.05 * X, nest_acc)
        xt = torch.where(booting, PSINI * nest_acc, xt)
        ph1y = 1.0 / (1.0 + g.pfac * torch.exp(
            g.xih1r * X / torch.clamp_min(xt, 1e-20)))
        pslp = torch.where(not_boot, _f32(AP) * pslp
                           + _f32(1.0 - AP) * ph1y, pslp)
        ph1y = torch.where(pslp > PSTHR, _f32(1.0 - PNSAF),
                           torch.clamp_max(ph1y, 1.0))
        xtr = (1.0 - ph1y) * X + ph1y * xt
        xt_new = _f32(AX) * xt + _f32(1.0 - AX) * xtr
        xt = torch.where(booting, xt, xt_new)
        snr_post = torch.clamp(X / torch.clamp_min(xt, 1e-20),
                               SNR_PRIO_MIN, 1000.0)
        snr_prio = torch.clamp_min(
            g.alpha * hk_old
            + g.one_m_alpha * torch.clamp_min(snr_post - 1.0, 0.0), 0.0)
        v = snr_prio * snr_post / (1.0 + snr_prio)
        hk_band = torch.clamp_min(torch.sqrt(_f32(0.7212) * v + v * v)
                                  / snr_post, 0.001)
        hk = torch.where(band, hk_band, 1.0)
        hk_old = torch.where(not_boot & band, snr_post * hk * hk, hk_old)
        init_count = init_count + 1
        hk = torch.where(booting, 1.0, _smooth(g, hk, X))
        out.append(F[:, f, :] * torch.cat([hk, ones], dim=-1))
    return (torch.stack(out, dim=1), xt, pslp, hk_old, init_count,
            nest_acc)


def nr_gains(g: GainParams, F, xt, pslp, hk_old, init_count, nest_acc):
    """The gain machine over one block's spectra (the kernel on CUDA
    tensors, in place on F; the plain version on CPU ones).  Arguments
    and results as `nr_gains_plain`'s."""
    if F.device.type == "cpu":
        return nr_gains_plain(g, F, xt, pslp, hk_old, init_count, nest_acc)
    dev = F.device
    if F.ndim != 3 or F.shape[-1] != NB + 1 or F.dtype != torch.complex64:
        raise ValueError(f"nr_gains: F must be (C, nF, {NB + 1}) complex64")
    C, nF = F.shape[:2]
    fs = (xt, pslp, hk_old, nest_acc)
    if any(t.dtype != torch.float32 or t.shape != (C, NB) for t in fs):
        raise ValueError(f"nr_gains: state planes (C, {NB}) f32")
    if init_count.dtype != torch.int32 or init_count.shape != (C,):
        raise ValueError("nr_gains: init_count (C,) int32")
    if any(t.device != dev or not t.is_contiguous()
           for t in fs + (init_count, F)):
        raise ValueError("nr_gains: contiguous tensors on one device")
    outs = [torch.empty_like(t) for t in fs]
    cnt = torch.empty_like(init_count)
    err = NR.lib().uhsdr_nr_launch(
        F.data_ptr(), C, nF, xt.data_ptr(), pslp.data_ptr(),
        hk_old.data_ptr(), nest_acc.data_ptr(), init_count.data_ptr(),
        g.vad_low, g.vad_high, g.alpha, g.one_m_alpha, g.power_threshold,
        g.xih1r, g.pfac, *g.inv_nn,
        *(o.data_ptr() for o in outs), cnt.data_ptr(), stream_ptr(dev))
    NR.check(err)
    NR.launches += 1
    xt2, pslp2, hk2, acc2 = outs
    return F, xt2, pslp2, hk2, cnt, acc2
