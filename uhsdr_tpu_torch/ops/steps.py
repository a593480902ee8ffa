"""Time loops of the plain versions: one step function, one driver.

A recurrence kernel's plain version is a step over time, written once
and run by `scan`.  On the card it steps on (C,) tensors, so each f32
operation is one torch launch over all channels.  On the CPU, where the
tests run a few channels, it steps channel by channel on NumPy f32
scalars: each operation correctly rounded, so the same bits as torch's,
and a few times faster than stepping (C,) NumPy arrays at the tests'
two to five channels (PERF.md section 6, PR 20).  `sel` and `pred`
stand in for `torch.where` and the mask casts.
"""
from __future__ import annotations

import numpy as np
import torch

ZERO = np.float32(0.0)
ONE = np.float32(1.0)


def sel(cond, a, b):
    """`where` for a tensor condition or a NumPy scalar one."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return a if cond else b


def pred(cond):
    """A predicate as 0/1 f32 (the JAX package's blend masks)."""
    if isinstance(cond, torch.Tensor):
        return cond.to(torch.float32)
    return ONE if cond else ZERO


def consts(values, cpu: bool):
    """Step constants: NumPy f32 scalars on the CPU, Python floats (each
    exactly its f32 value) for torch."""
    return [np.float32(v) if cpu else float(np.float32(v)) for v in values]


def scan(step, carry: tuple, xs: tuple):
    """Run ``carry, ys = step(carry, x_n)`` over the samples n of xs, a
    tuple of (C, T) tensors; carry is a tuple of (C,) tensors, ys a tuple
    of per-sample f32 outputs.  Returns (carry, ys as (C, T) f32
    tensors).  CUDA tensors step on (C,) vectors; CPU ones channel by
    channel on NumPy scalars."""
    C, T = xs[0].shape
    if xs[0].device.type != "cpu":
        cols = [x.unbind(1) for x in xs]
        outs = []
        for n in range(T):
            carry, ys = step(carry, tuple(c[n] for c in cols))
            outs.append(ys)
        return carry, tuple(torch.stack(o, 1) for o in zip(*outs))
    xs_np = [x.detach().numpy() for x in xs]
    carry_np = [c.detach().numpy() for c in carry]
    new_carry = [np.empty_like(c) for c in carry_np]
    outs = None
    with np.errstate(all="ignore"):       # NaN and inf propagate
        for ch in range(C):
            cr = tuple(c[ch] for c in carry_np)
            rows = [x[ch] for x in xs_np]
            ys_ch = []
            for n in range(T):
                cr, ys = step(cr, tuple(r[n] for r in rows))
                ys_ch.append(ys)
            for i, v in enumerate(cr):
                new_carry[i][ch] = v
            got = np.array(ys_ch, dtype=np.float32).reshape(T, -1)
            if outs is None:
                outs = np.empty((got.shape[1], C, T), np.float32)
            outs[:, ch] = got.T
    return (tuple(torch.from_numpy(c) for c in new_carry),
            tuple(torch.from_numpy(np.ascontiguousarray(o)) for o in outs))
