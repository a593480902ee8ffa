"""Block-streaming runner: a chain step over many blocks.

The counterpart of `uhsdr_tpu.core.stream`.  The reference's streaming
contract is "the ISR calls the processor once per block forever"
(`uhsdr_hw_i2s.c:126-160`); the JAX package runs the composed step
``(state, block) -> (out, state)`` as one `lax.scan` under `jit`.  PyTorch
runs eagerly, so here the blocks axis is a Python loop: each block's
launches are queued behind the last one's, nothing synchronises between
blocks, and the outputs are stacked at the end.  (Capturing the step in
a CUDA graph is a matter for the port's performance work.)
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..chain.rx import resolve_device


def _leaves(blocks, k: int):
    """Block k of a tensor, an array, or a tuple / list of them."""
    if isinstance(blocks, (tuple, list)):
        return type(blocks)(_leaves(b, k) for b in blocks)
    return blocks[k]


def _n_blocks(blocks) -> int:
    if isinstance(blocks, (tuple, list)):
        return _n_blocks(blocks[0])
    return blocks.shape[0]


def _stack(outs: list):
    """Stack the step's outputs (tensors, or tuples / dicts of them) along
    a new leading blocks axis."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([o[i] for o in outs])
                           for i in range(len(first)))
    return torch.stack(outs)


def scan_blocks(step: Callable, state: Any, blocks, *extra):
    """Run `step(state, block, *extra) -> (out, new_state)` over a leading
    blocks axis.  blocks: (n_blocks, ..., block_len) tensors or arrays,
    or a tuple of such.  Returns (outs stacked (n_blocks, ...),
    final_state)."""
    outs = []
    for k in range(_n_blocks(blocks)):
        out, state = step(state, _leaves(blocks, k), *extra)
        outs.append(out)
    return _stack(outs), state


class StreamRunner:
    """Multi-block runner around an RxChain-style step on one device
    (CUDA unless ``device`` names another).

    Usage:
        runner = StreamRunner(lambda st, i, q: chain_step(st, i, q))
        audio, state = runner.run(state, i_blocks, q_blocks)
    where i_blocks/q_blocks are (n_blocks, channels, block_len) int16 or
    f32 planes; NumPy planes are copied to the device once, whole."""

    def __init__(self, step: Callable, device=None):
        self._step = step
        self.device = resolve_device(device)

    def _tensor(self, a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device)

    def run(self, state, i_blocks, q_blocks):
        return scan_blocks(lambda st, iq: self._step(st, *iq), state,
                           (self._tensor(i_blocks), self._tensor(q_blocks)))


def chunk_capture(i_plane: np.ndarray, q_plane: np.ndarray,
                  block_len: int):
    """Split (..., T) planes into (n_blocks, ..., block_len), dropping the
    partial tail (block lengths must divide the decimation chain)."""
    T = i_plane.shape[-1]
    n = T // block_len
    shp = i_plane.shape[:-1] + (n, block_len)
    i_b = i_plane[..., : n * block_len].reshape(shp)
    q_b = q_plane[..., : n * block_len].reshape(shp)
    # blocks axis to the front
    return (np.moveaxis(i_b, -2, 0), np.moveaxis(q_b, -2, 0))
