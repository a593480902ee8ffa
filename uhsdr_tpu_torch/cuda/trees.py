"""Sums in a fixed order, shared by the helper kernels' plain versions.

A kernel that must hold its plain version bit for bit cannot leave the
order of a sum to `torch.sum`.  These spell out the order the kernels
use: a pairwise tree level by level, as a warp's xor-butterfly of
shuffles forms it (lane l adds lane l ^ 1, then l ^ 2, ...: each level
adds neighbouring pairs), and before it a left fold of the terms each
lane holds.
"""
from __future__ import annotations

import torch


def pair_tree(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two long) as a pairwise tree:
    x[..., 0::2] + x[..., 1::2], level by level."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"pair_tree: {n} terms, not a power of two")
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def fold(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Left fold of a sum along `dim`: ((x0 + x1) + x2) + ..."""
    x = x.movedim(dim, -1)
    s = x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k]
    return s


def lane_sum(x: torch.Tensor, lanes: int) -> torch.Tensor:
    """Sum over the last axis of P * lanes terms as a warp of `lanes`
    lanes forms it: term j sits in lane j % lanes, each lane folds its P
    terms in order of j, then the lanes' partial sums meet in a pairwise
    tree."""
    n = x.shape[-1]
    if n % lanes:
        raise ValueError(f"lane_sum: {n} terms over {lanes} lanes")
    part = fold(x.reshape(x.shape[:-1] + (n // lanes, lanes)), dim=-2)
    return pair_tree(part)
