"""Numerically-controlled oscillator (frequency translation).

The uint32 phase accumulator of `uhsdr_tpu.ops.nco`:
``phase[n] = phase0 + n * delta (mod 2^32)``, exact and drift-free for
unbounded streams.  Torch has no general uint32 arithmetic, so phases are
int64 tensors holding values in [0, 2^32), masked after every operation;
deltas are Python ints (or int64 tensors) in the same range.
"""
from __future__ import annotations

import math

import numpy as np
import torch

TWO32 = 1 << 32
MASK32 = TWO32 - 1
# the JAX package's f32 angle scale (uhsdr_tpu/ops/nco.py:21)
PHASE_SCALE_F32 = np.float32(2.0 * np.pi / TWO32)


def freq_to_delta(freq_hz, fs) -> np.ndarray:
    """Frequency (Hz, may be negative) -> uint32 phase increment per
    sample, computed host-side in float64."""
    cycles = np.asarray(freq_hz, np.float64) / float(fs)
    d = np.round(np.mod(cycles, 1.0) * float(TWO32))
    return d.astype(np.int64).astype(np.uint32)


def _mul_mod32(delta, n: int):
    """(delta * n) mod 2^32 without int64 overflow (delta < 2^32, n >= 0):
    n is split into 16-bit halves so every partial product stays < 2^63."""
    n = int(n) % TWO32
    lo = (delta * (n & 0xFFFF)) & MASK32
    hi = ((delta * (n >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def advance(phase0: torch.Tensor, delta, n: int) -> torch.Tensor:
    """Phase accumulator state after n samples (int64 in [0, 2^32))."""
    return (phase0 + _mul_mod32(delta, n)) & MASK32


def phase_ramp(phase0: torch.Tensor, delta, n: int,
               start: int = 0) -> torch.Tensor:
    """Exact phases (int64 in [0, 2^32)) for sample indices
    start .. start+n-1 (start may be negative: the modular arithmetic
    makes history samples' phases exact too).  Shape (..., n)."""
    k = torch.arange(n, dtype=torch.int64, device=phase0.device)
    # delta * k: k < 2^31 and delta < 2^32 stay below 2^63.  A scalar
    # delta stays a Python integer, so no host-to-device copy is made;
    # a per-channel delta is an int64 tensor.
    d = delta if isinstance(delta, torch.Tensor) else int(delta)
    p0 = (phase0 + _mul_mod32(d, start % TWO32))[..., None]
    if isinstance(d, torch.Tensor) and d.ndim:
        d = d[..., None]
    return (p0 + ((k * d) & MASK32)) & MASK32


def angle_f32(phases: torch.Tensor) -> torch.Tensor:
    """The JAX package's f32 angle of a uint32 phase
    (uhsdr_tpu/ops/nco.py:36-43): the phase rounded to f32, times
    f32(2 pi / 2^32).  The digital modems and the Goertzel projection
    take their sines of it."""
    return phases.to(torch.float32) * float(PHASE_SCALE_F32)


def rotor(phases: torch.Tensor) -> torch.Tensor:
    """exp(j * 2pi * phase / 2^32) as complex64, with the angle taken in
    float64 so the only error is the final f32 rounding."""
    ang = phases.to(torch.float64) * (2.0 * math.pi / TWO32)
    return torch.polar(torch.ones_like(ang), ang).to(torch.complex64)


def mix(iq: torch.Tensor, phase0: torch.Tensor, delta):
    """Complex mix ``iq * exp(j*phase[n])`` — the RX frequency translation
    (reference `FreqShift`).  iq: (..., n) complex64; phase0: (...,) int64.
    Returns (shifted_iq, new_phase0)."""
    n = iq.shape[-1]
    return iq * rotor(phase_ramp(phase0, delta, n)), advance(phase0, delta, n)


def tone_iq(phase0: torch.Tensor, delta, n: int):
    """Complex exponential block exp(j*phase[n]) (the reference's
    `tone_iq`, softdds_genIQSingleTone).  Returns (osc (..., n) complex64,
    new_phase0)."""
    return rotor(phase_ramp(phase0, delta, n)), advance(phase0, delta, n)


def tone(phase0: torch.Tensor, delta, n: int):
    """Real sine block sin(phase[n]) (the reference's `tone`,
    softdds_runIQ single-tone), the angle taken in float64 as `rotor`'s.
    Returns (sin_block (..., n) f32, new_phase0)."""
    ang = phase_ramp(phase0, delta, n).to(torch.float64) * (
        2.0 * math.pi / TWO32)
    return torch.sin(ang).to(torch.float32), advance(phase0, delta, n)
