"""The complex FFTs of the wideband channelizer, as `torch.fft` calls.

The counterpart of `uhsdr_tpu.ops.fftutil.cfft` / `icfft`.  The JAX
package composes them from real FFTs because its TPU backend has no
complex-input FFT (ops/fftutil.py:18-26 there); the card has one, so
here each is one library call.  The windows and framing helpers of that
module serve the spectral NR and the scope, which the port does not run
yet (ROADMAP queue A items 7 and 9).
"""
from __future__ import annotations

import torch


def cfft(x: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Complex FFT along the last axis (a real input is taken as complex
    with zero imaginary part), zero-padded or cut to n points."""
    if not x.is_complex():
        x = x.to(torch.float32)
    return torch.fft.fft(x, n=n, dim=-1)


def icfft(F: torch.Tensor) -> torch.Tensor:
    """Inverse of `cfft`: complex output, 1/n normalised."""
    return torch.fft.ifft(F, dim=-1)
