"""Sharded wideband channelizer: ONE wideband IQ stream, time-sharded over
every rank of the mesh, split into M channel streams that come out
channel-sharded; the scale-out form of `parallel/fleet.WidebandFleet` and
the counterpart of `uhsdr_tpu.parallel.wideband_sharded`.

The seam is the sharded RX front's (`rx_sharded.py`, SURVEY §2.6): the
analysis bank's streaming history, its last K*M wideband samples, becomes
a halo from the rank to the left, and rank 0 takes the carried block
boundary.  One cyclic shift over the world carries both, the last rank's
tail being the next block's carry.  After the bank the (M, B_local / M)
output reshards to channels over ranks by an all-to-all, so the
per-channel chains run channel-parallel.  The bank on each rank is
`ops/channelizer.AnalysisPfb.__call__` with the halo as its carry: its
torch products and FFT, as `WidebandFleet` runs them (the bank has no
Pallas kernel in the JAX package).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import channelizer as chz
from . import mesh as mesh_mod


def make_sharded_channelizer(n_channels: int, mesh: mesh_mod.Mesh,
                             taps_per_branch: int = 12, prototype=None,
                             device=None):
    """Returns (step, init_carry, bank):
      step(carry, i_wide, q_wide) -> (i_ch, q_ch, new_carry)
    with i/q_wide this rank's (B / P,) f32 time shard of the block (rank
    order, P = mesh.size; B % (P M) == 0 and B / P >= K M, so the halo is
    one whole left neighbour's tail) and i/q_ch its (M / P, B / M) f32
    channels.  The carry, (2, K M) f32 re/im, lives on rank 0 (None on
    the others); init_carry() gives this rank's zero carry."""
    bank = chz.AnalysisPfb(n_channels, prototype=prototype,
                           taps_per_branch=taps_per_branch, device=device)
    M, KM = bank.n_channels, bank.taps_per_branch * bank.n_channels
    P = mesh.size
    ranks = list(range(P))

    def step(carry, i_wide, q_wide):
        b = i_wide.shape[-1]
        if b % M or b < KM or M % P:
            raise ValueError(
                f"a shard of {b} samples: a multiple of the {M} channels "
                f"(themselves a multiple of the {P} ranks) and at least "
                f"the halo {KM} (= taps_per_branch * n_channels)")
        tail = torch.stack([i_wide[b - KM:], q_wide[b - KM:]])
        if P > 1:
            recv = torch.empty_like(tail)
            for r in mesh_mod.ring_shift(tail, recv, ranks, None):
                r.wait()
            hist, carry = (carry, recv) if dist.get_rank() == 0 else (recv,
                                                                       None)
        else:
            hist, carry = carry, tail
        y, _ = bank(torch.complex(hist[0], hist[1]),
                    torch.complex(i_wide, q_wide))
        y = mesh_mod.reshard_rows(None, P, y)
        return y.real.contiguous(), y.imag.contiguous(), carry

    def init_carry():
        if P > 1 and dist.get_rank() != 0:
            return None
        return torch.zeros((2, KM), dtype=torch.float32, device=bank.device)

    return step, init_carry, bank
