"""Wideband polyphase channelizer: the critically sampled M-channel DFT
analysis and synthesis filterbanks, the counterpart of
`uhsdr_tpu.ops.channelizer`.

Analysis.  With a prototype h of K*M taps (K a branch), channel m's
output is the direct chain "mix by -2 pi m / M, lowpass by h, decimate
by M" at input indices n*M:

    y_m[n] = M * IDFT_M{ u_p[n] }[m],
    u_p[n] = sum_k h[kM+p] x[(n-k)M - p]      (branch FIR, K taps)

so a block is reshaped into M-sample frames, runs K shifted products
(the branch FIRs, over all branches at once) and one length-M inverse
DFT per output sample.  Synthesis is its transpose: per-channel streams,
the inverse DFT, the K-tap branch FIRs, interleaved to the wide rate.
State is the last frames (carry style, as `ops.fir`); channel m is
centred at +m * fs_wide / M (m > M/2 wraps negative).

None of this is a Pallas kernel in the JAX package: the branch FIR is K
torch products and sums, and the inverse DFT is a dense FP32 product
("matmul", M <= 512: it needs TF32 off on the card, as the port's other
products) or a library FFT (`ops.fftutil.icfft`) above.  State is
complex64 on the bank's device (CUDA unless the caller names another).
"""
from __future__ import annotations

from typing import Literal

import numpy as np
import torch
from scipy import signal as sps

from ..chain.rx import resolve_device
from . import fftutil
from .iir import need_fp32_matmul


def design_prototype(n_channels: int, taps_per_branch: int = 12,
                     cutoff_scale: float = 1.0, beta: float = 9.0
                     ) -> np.ndarray:
    """Kaiser-window lowpass prototype for an M-channel bank (a copy of
    the JAX package's): cutoff = cutoff_scale / M in Nyquist units, unit
    DC gain, (K*M,) float32."""
    M, K = n_channels, taps_per_branch
    h = sps.firwin(K * M, cutoff_scale / M, window=("kaiser", beta))
    return (h / h.sum()).astype(np.float32)


def _idft_tables(M: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    k = np.arange(M)
    W = np.exp(2j * np.pi * np.outer(k, k) / M).astype(np.complex64)
    return (torch.as_tensor(np.ascontiguousarray(W.real.T), device=device),
            torch.as_tensor(np.ascontiguousarray(W.imag.T), device=device))


def _ifft_m(u: torch.Tensor, M: int, impl: str, W) -> torch.Tensor:
    """M * IDFT along the last axis (size M): the dense product with the
    IDFT matrix W (as its transposed real and imaginary parts), or the
    library FFT."""
    if impl == "matmul":
        need_fp32_matmul(u, "the channelizer's IDFT product")
        wr, wi = W
        ur, ui = u.real, u.imag
        return torch.complex(ur @ wr - ui @ wi, ur @ wi + ui @ wr)
    return fftutil.icfft(u) * M


def _pick_impl(M: int, impl: Literal["auto", "fft", "matmul"]) -> str:
    """The reference's choice (ops/channelizer.py:90-99 there): the dense
    IDFT up to a few hundred channels, the FFT above."""
    if impl != "auto":
        return impl
    return "matmul" if M <= 512 else "fft"


class AnalysisPfb:
    """Critically sampled M-channel analysis filterbank (streaming).

    Input blocks (..., B) complex64 at the wide rate, B % M == 0; output
    (..., M, B // M) complex64 at fs_wide / M, channel-major.  Frame n of
    channel m equals ``decimate_M(lowpass_h(x * exp(-j 2 pi m i / M)))``
    at input index n*M (the phase convention of `ops.fir`)."""

    def __init__(self, n_channels: int, prototype: np.ndarray | None = None,
                 taps_per_branch: int = 12,
                 dft_impl: Literal["auto", "fft", "matmul"] = "auto",
                 device=None):
        M = int(n_channels)
        if prototype is None:
            prototype = design_prototype(M, taps_per_branch)
        h = np.asarray(prototype, np.float32)
        if h.size % M:
            raise ValueError(f"prototype of {h.size} taps for {M} channels")
        self.device = resolve_device(device)
        self.n_channels = M
        self.taps_per_branch = h.size // M
        self.prototype = h
        # hpoly[k, p] = h[k*M + p]
        self.hpoly = torch.as_tensor(h.reshape(-1, M), device=self.device)
        self.dft_impl = _pick_impl(M, dft_impl)
        self._W = (_idft_tables(M, self.device) if self.dft_impl == "matmul"
                   else None)

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> torch.Tensor:
        """Carry: the last K*M wide-rate samples (one more than the filter
        needs, so it is a whole number of frames)."""
        KM = self.taps_per_branch * self.n_channels
        return torch.zeros(tuple(batch_shape) + (KM,), dtype=torch.complex64,
                           device=self.device)

    def __call__(self, state: torch.Tensor, x: torch.Tensor):
        """x: (..., B) complex64, B % M == 0.  Returns (y (..., M, B // M),
        new_state)."""
        M, K = self.n_channels, self.taps_per_branch
        B = x.shape[-1]
        if B % M:
            raise ValueError(f"block of {B} samples for {M} channels")
        T = B // M
        xfull = torch.cat([state.to(x.dtype), x], dim=-1)
        lead = xfull.shape[:-1]
        # R[j, p'] = xfull[j*M + p']; the branch streams V[j', p] =
        # z[j'*M - p] (z the new samples) for j' = -(K-1) .. T-1:
        # p = 0 is R[j' + K, 0], p >= 1 is R[j' + K - 1, M - p]
        R = xfull.reshape(lead + (K + T, M))
        V = torch.cat([R[..., 1:, :1], torch.flip(R[..., :-1, 1:], (-1,))],
                      dim=-1)
        # branch FIRs: u[n, p] = sum_k hpoly[k, p] * V[n + (K-1) - k, p]
        u = torch.zeros(lead + (T, M), dtype=x.dtype, device=x.device)
        for k in range(K):
            u = u + self.hpoly[k] * V[..., K - 1 - k:K - 1 - k + T, :]
        y = _ifft_m(u, M, self.dft_impl, self._W)              # (..., T, M)
        # the carry gets storage of its own: a view would hold the whole
        # wideband block until the next one
        return (y.transpose(-1, -2),
                xfull[..., xfull.shape[-1] - K * M:].clone())


class SynthesisPfb:
    """Critically sampled M-channel synthesis filterbank (streaming).

    Input (..., M, T) complex64 channel streams at fs_wide / M; output
    (..., T*M) complex64 at the wide rate, equal to the direct form
    ``sum_m upsample_M(y_m) conv g * exp(+j 2 pi m i / M)``.  The default
    prototype is M * design_prototype(M) (the interpolator's gain)."""

    def __init__(self, n_channels: int, prototype: np.ndarray | None = None,
                 taps_per_branch: int = 12,
                 dft_impl: Literal["auto", "fft", "matmul"] = "auto",
                 device=None):
        M = int(n_channels)
        if prototype is None:
            prototype = M * design_prototype(M, taps_per_branch)
        g = np.asarray(prototype, np.float32)
        if g.size % M:
            raise ValueError(f"prototype of {g.size} taps for {M} channels")
        self.device = resolve_device(device)
        self.n_channels = M
        self.taps_per_branch = g.size // M
        self.prototype = g
        self.gpoly = torch.as_tensor(g.reshape(-1, M), device=self.device)
        self.dft_impl = _pick_impl(M, dft_impl)
        self._W = (_idft_tables(M, self.device) if self.dft_impl == "matmul"
                   else None)

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> torch.Tensor:
        """Carry: the last K-1 branch frames, (..., K-1, M) complex64."""
        K, M = self.taps_per_branch, self.n_channels
        return torch.zeros(tuple(batch_shape) + (K - 1, M),
                           dtype=torch.complex64, device=self.device)

    def __call__(self, state: torch.Tensor, y: torch.Tensor):
        """y: (..., M, T) complex64.  Returns (x (..., T*M), new_state)."""
        M, K = self.n_channels, self.taps_per_branch
        T = y.shape[-1]
        t = _ifft_m(y.transpose(-1, -2), M, self.dft_impl, self._W)
        tfull = torch.cat([state.to(t.dtype), t], dim=-2)
        # x[nM + p] = sum_k g[kM+p] * t[n-k, p]
        xf = torch.zeros(y.shape[:-2] + (T, M), dtype=t.dtype,
                         device=t.device)
        for k in range(K):
            xf = xf + self.gpoly[k] * tfull[..., K - 1 - k:K - 1 - k + T, :]
        new_state = (tfull[..., tfull.shape[-2] - (K - 1):, :].clone()
                     if K > 1 else state)
        return xf.reshape(y.shape[:-2] + (T * M,)), new_state


def channel_center_hz(m, n_channels: int, fs_wide: float) -> np.ndarray:
    """Centre frequency of channel m (wrapped to (-fs/2, fs/2])."""
    f = np.asarray(m) * fs_wide / n_channels
    return np.where(f > fs_wide / 2, f - fs_wide, f)
