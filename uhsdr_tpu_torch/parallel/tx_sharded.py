"""Sharded TX: channel parallelism over the whole mesh, the counterpart of
`uhsdr_tpu.parallel.tx_sharded`.

The TX chain starts with IIR voice filters and the ALC's look-ahead
recurrence, whose state has infinite memory: a time shard would need the
exact filter state at its left edge, which depends on every earlier
sample.  So TX is sharded over channels alone: each rank runs the port's
`TxChain` on its C / (n_dp n_sp) channels (`mesh.channel_slice`), with no
collective (SURVEY §2.6 "channel batching").
"""
from __future__ import annotations

import numpy as np

from ..chain import tx
from ..core.config import nest_leaves
from . import mesh as mesh_mod


def make_sharded_tx(cfg: tx.TxConfig, mesh: mesh_mod.Mesh, device=None):
    """Returns (step, init_state):
      step(state, audio) -> (i_plane, q_plane, new_state)
    with audio the rank's (C / mesh.size, T) channels, on `device` (CUDA
    unless the caller names the CPU); init_state(n_channels) the rank's
    zero state."""
    chain = tx.TxChain(cfg, device)

    def init_state(n_channels: int) -> tx.TxState:
        sl = mesh_mod.channel_slice(mesh, n_channels)
        return chain.init_state((sl.stop - sl.start,))

    return chain, init_state


def _axes(cfg: tx.TxConfig, params: tx.TxParams) -> dict:
    return mesh_mod.channel_axes(lambda n: tx.state_to_numpy(
        tx.init_state(cfg, params, (n,))))


def gather_state(cfg: tx.TxConfig, mesh: mesh_mod.Mesh,
                 state: tx.TxState) -> dict:
    """Every rank's state joined into the global one, {dotted leaf: NumPy
    array} in the JAX package's layout (every rank calls it and gets the
    whole)."""
    return mesh_mod.gather_channels(tx.state_to_numpy(state),
                                    _axes(cfg, tx.make_params(cfg, "cpu")))


def scatter_state(cfg: tx.TxConfig, mesh: mesh_mod.Mesh, global_state,
                  device=None) -> tx.TxState:
    """This rank's part of a global state: a {dotted leaf: array} dict as
    `gather_state` gives, or the JAX package's TxState."""
    params = tx.make_params(cfg, "cpu")
    axes = _axes(cfg, params)
    flat = mesh_mod.flatten(global_state)
    C = next(np.shape(flat[f])[ax] for f, ax in axes.items()
             if ax is not None)
    mine = mesh_mod.take_channels({f: flat[f] for f in axes}, axes,
                                  mesh_mod.channel_slice(mesh, C))
    like = tx.init_state(cfg, params, (1,))
    return tx.state_from_numpy(nest_leaves(like, mine), device=device)
