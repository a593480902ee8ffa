"""FFT helpers: the complex FFTs of the wideband channelizer, the analysis
windows and the 50%-overlap framing of the spectral NR.

The counterpart of `uhsdr_tpu.ops.fftutil`.  The JAX package composes
`cfft` / `icfft` from real FFTs because its TPU backend has no
complex-input FFT (ops/fftutil.py:18-26 there); the card has one, so
here each is one library call.  The windows are NumPy tables (the same
f32 values as the reference's); `frame_overlap` and `overlap_add` are
its gather- and scatter-free forms for a frame length that is a multiple
of the hop, and index forms otherwise.
"""
from __future__ import annotations

import functools

import numpy as np
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


@functools.lru_cache(maxsize=None)
def hann(n: int) -> np.ndarray:
    """Periodic Hann (DFT-even), suited to overlap-add."""
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def sqrt_hann(n: int) -> np.ndarray:
    return np.sqrt(hann(n)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def sqrt_hann_sym(n: int) -> np.ndarray:
    """Symmetric sqrt-Hann, sin(pi i / (n - 1)), zero at both ends: the
    firmware's `SQRT_von_Hann_256` table (audio_nr.c:76) that the spectral
    NR uses.  Not exactly COLA at 50% overlap (the firmware lives with the
    ~0.8% ripple)."""
    return np.sin(np.pi * np.arange(n) / (n - 1)).astype(np.float32)


def frame_overlap(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """Frame (..., T) into (..., n_frames, frame_len) with the given hop;
    (T - frame_len) % hop == 0.  With frame_len % hop == 0 each frame is
    frame_len // hop consecutive hop-chunks: a reshape and r slices."""
    T = x.shape[-1]
    n_frames = (T - frame_len) // hop + 1
    if frame_len % hop == 0:
        r = frame_len // hop
        n_chunks = T // hop
        chunks = x[..., :n_chunks * hop].reshape(x.shape[:-1]
                                                 + (n_chunks, hop))
        return torch.cat([chunks[..., k:k + n_frames, :] for k in range(r)],
                         dim=-1)
    idx = (torch.arange(n_frames, device=x.device)[:, None] * hop
           + torch.arange(frame_len, device=x.device)[None, :])
    return x[..., idx]


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Inverse of `frame_overlap` for windowed frames: (..., n_frames,
    frame_len) -> (..., (n_frames - 1) * hop + frame_len), the frames
    summed at hop offsets (with frame_len % hop == 0: the r hop-chunk
    streams added at staggered offsets, in the reference's order)."""
    n_frames, frame_len = frames.shape[-2], frames.shape[-1]
    lead = frames.shape[:-2]
    T = (n_frames - 1) * hop + frame_len
    if frame_len % hop == 0:
        r = frame_len // hop
        n_out = T // hop
        chunks = frames.reshape(lead + (n_frames, r, hop))
        out = torch.zeros(lead + (n_out, hop), dtype=frames.dtype,
                          device=frames.device)
        for k in range(r):
            pad = torch.zeros_like(out)
            pad[..., k:k + n_frames, :] = chunks[..., :, k, :]
            out = out + pad
        return out.reshape(lead + (T,))
    out = torch.zeros(lead + (T,), dtype=frames.dtype, device=frames.device)
    for f in range(n_frames):
        out[..., f * hop:f * hop + frame_len] += frames[..., f, :]
    return out
