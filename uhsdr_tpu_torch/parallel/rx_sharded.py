"""Sharded RX over a (dp, sp) mesh on `torch.distributed`: the counterpart
of `uhsdr_tpu.parallel.rx_sharded`.

Design (SURVEY §2.6):

  * The front end (NCO translation and the decimating FIR) is parallel in
    time, so each rank runs it on its (C / n_dp, T / n_sp) tile of the
    (channels, time) grid.  The streaming FIR's history becomes a halo:
    each time shard needs the last L = taps - 1 RAW samples of the shard
    to its left, passed to the right within the dp row; sp rank 0 takes
    the carried block boundary instead.

  * The shard's front is one launch of the chain's own kernel (K5 for
    real stage-A taps; K7, or K6 untranslated, for complex ones) with the
    halo as its carry.  The exchange is waited for before that launch.

  * The NCO phase of a sample is taken from its GLOBAL index (the shard's
    base plus the local index, uint32 wrap-exact), so a raw halo is
    rotated by the rank that uses it exactly as its owner would have,
    by the kernel's own carry rotation.

  * Everything after the front is sequential in time per channel (the
    AGC and PLL recurrences), so the output reshards: channels over every
    rank, time whole, by an all-to-all within the dp row.  There the
    unfused stage B (K6 at decimation 1, `chain/rx.py::stage_b`) and
    `chain/rx.py::demod_and_post` run on the rank's channels: every mode
    and option of the single-device chain but the IQ auto-correction and
    the two-channel filter pair.

  * The next block's carry is the global raw tail, which sits on the
    row's last rank.  The halo exchange is a cyclic shift, so that tail
    reaches sp rank 0 in the same exchange: one exchange a block.

At n_sp = 1 there is no exchange and no reshard: the step runs on one
rank without a collective, as the card runs it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..chain import rx
from ..core.config import nest_leaves
from ..cuda import fir as fir_kernels
from ..ops import nco
from . import mesh as mesh_mod


class ShardedRxState(NamedTuple):
    """A rank's part of the sharded RX state."""
    phase: torch.Tensor           # (C / n_dp,) int64: the dp row's NCO
    #                               phase at the block's start
    carry: torch.Tensor | None    # (C / n_dp, 2, L) f32: the last L raw
    #                               samples of the previous block, on sp
    #                               rank 0 (None on the others)
    post: rx.RxState              # the rank's C / (n_dp n_sp) channels;
    #                               nco_phase and front_carry None (they
    #                               are the two leaves above)


def check_config(cfg: rx.RxConfig):
    """The configurations the sharded front takes (the JAX package's
    asserts, and its one stage-A filter)."""
    rx.check_slice(cfg)
    if cfg.iq_auto_correction:
        raise ValueError(
            "the Moseley-Slump estimator is a sequential recurrence over "
            "sub-blocks and cannot be time-sharded; apply manual IQ "
            "calibration in sharded mode")
    if cfg.mode == "ssbstereo" or cfg.front_pair:
        raise ValueError(
            "the two-channel filter pair expands a sideband axis inside "
            "the chain; run it on the single-device chain")


def shard_phase(params: rx.RxParams, phase0: torch.Tensor, sp_idx: int,
                t_local: int) -> torch.Tensor:
    """The NCO phase of the shard's first sample: phase0 + delta sp_idx
    t_local (mod 2^32), (C,) int64."""
    return nco.advance(phase0, params.nco_delta, sp_idx * t_local)


def front_end_local(params: rx.RxParams, cfg: rx.RxConfig, sp_idx: int,
                    phase0, hist, i_plane, q_plane):
    """One time shard's front end, the counterpart of the JAX package's
    `_front_end_local` without its collective: sp_idx the shard's place
    in its row, phase0 (C,) int64 the phase of the block's first sample,
    hist (C, 2, L) f32 the raw samples before the shard (the halo, or the
    carried boundary at sp_idx 0), i/q (C, t_local) f32.

    One launch of the front's kernel with the halo as its carry at the
    shard's phase (the kernel rotates the raw carry as its owner would
    have): K5 for real stage-A taps, as its (re, im) planes where a stage
    B follows; for complex taps (no stage B) K7 with the NCO, K6 without,
    real out for usb/lsb/cw.  Returns the decimated front output: real
    f32, the (re, im) f32 planes, or complex64."""
    h = params.front_fir
    t_local = i_plane.shape[-1]
    carry = torch.complex(hist[:, 0], hist[:, 1])
    nco_arg = ((shard_phase(params, phase0, sp_idx, t_local),
                params.nco_delta) if params.nco_delta != 0 else None)
    if h.is_complex():
        return fir_kernels.fir_cx(
            h, carry, i_plane, q_plane, cfg.front_decim, nco=nco_arg,
            real_out=cfg.mode in ("usb", "lsb", "cw"))[0]
    return fir_kernels.fir_rt(h, carry, i_plane, q_plane, cfg.front_decim,
                              nco=nco_arg,
                              planes_out=params.front2 is not None)[0]


def _reshard(mesh: mesh_mod.Mesh, zf):
    if isinstance(zf, tuple):
        return tuple(_reshard(mesh, z) for z in zf)
    return mesh_mod.reshard_rows(mesh.sp_group, mesh.n_sp, zf)


def make_sharded_rx(cfg: rx.RxConfig, mesh: mesh_mod.Mesh, device=None):
    """Build the sharded RX step of `cfg` on `mesh`, on `device` (CUDA
    unless the caller names the CPU).  Returns (step, init_state):
      step(state, i_tile, q_tile) -> (audio, new_state)
    with i/q_tile the rank's (C / n_dp, T / n_sp) f32 tile of the global
    planes (`mesh.grid_slice`) and audio the rank's C / (n_dp n_sp)
    channels (`mesh.channel_slice`) at full T (FM: T / front_decim, as
    the chain gives); init_state(n_channels) the rank's zero state."""
    check_config(cfg)
    dev = rx.resolve_device(device)
    params = rx.make_params(cfg, dev)
    L = params.front_fir.shape[-1] - 1
    decim = cfg.front_decim
    n_sp, sp_idx = mesh.n_sp, mesh.sp_idx

    def step(state: ShardedRxState, i_tile, q_tile):
        C, t = i_tile.shape
        if not (i_tile.dtype == q_tile.dtype == torch.float32
                and q_tile.shape == (C, t)):
            raise ValueError("i/q tiles: (C, t) f32 planes of one shape")
        if t % decim or t < L or C % n_sp:
            raise ValueError(
                f"a ({C}, {t}) tile: its samples a multiple of the "
                f"decimation {decim} and at least the history {L}, its "
                f"channels a multiple of n_sp {n_sp}")
        tail = torch.stack([i_tile[:, t - L:], q_tile[:, t - L:]], dim=1)
        if n_sp > 1:
            recv = torch.empty_like(tail)
            for r in mesh_mod.ring_shift(tail, recv, mesh.sp_ranks,
                                         mesh.sp_group):
                r.wait()
            hist, carry = ((state.carry, recv) if sp_idx == 0
                           else (recv, None))
        else:
            hist, carry = state.carry, tail
        zf = front_end_local(params, cfg, sp_idx, state.phase, hist, i_tile,
                             q_tile)
        zf = _reshard(mesh, zf)
        audio, post, _ = rx.demod_and_post(cfg, params, state.post, zf)
        phase = nco.advance(state.phase, params.nco_delta, t * n_sp)
        return audio, ShardedRxState(phase, carry, post)

    def init_state(n_channels: int) -> ShardedRxState:
        c_row = n_channels // mesh.n_dp
        mesh_mod.channel_slice(mesh, n_channels)     # checks the split
        post = rx.init_state(cfg, params, (n_channels // mesh.size,))
        return ShardedRxState(
            phase=torch.zeros((c_row,), dtype=torch.int64, device=dev),
            carry=(torch.zeros((c_row, 2, L), dtype=torch.float32,
                               device=dev) if sp_idx == 0 else None),
            post=post._replace(nco_phase=None, front_carry=None))

    return step, init_state


# ---------------------------------------------------------------------------
# the global state, in the JAX sharded state's layout: the RxState leaves
# of `rx.state_to_numpy` over all C channels, front_carry (C, 2, L) raw f32
# and nco_phase (C,) uint32
# ---------------------------------------------------------------------------

_FRONT = ("nco_phase", "front_carry")


def _post_axes(cfg: rx.RxConfig, params: rx.RxParams) -> dict:
    axes = mesh_mod.channel_axes(lambda n: rx.state_to_numpy(
        rx.init_state(cfg, params, (n,))._replace(nco_phase=None,
                                                  front_carry=None)))
    return dict(axes, nco_phase=0, front_carry=0)


def gather_state(cfg: rx.RxConfig, mesh: mesh_mod.Mesh,
                 state: ShardedRxState) -> dict:
    """Every rank's state joined into the global one (every rank calls it
    and gets the whole), as {dotted leaf: NumPy array}."""
    params = rx.make_params(cfg, "cpu")
    c_rank = state.phase.shape[0] // mesh.n_sp
    chunk = slice(mesh.sp_idx * c_rank, (mesh.sp_idx + 1) * c_rank)
    L = params.front_fir.shape[-1] - 1
    local = rx.state_to_numpy(state.post)
    local["nco_phase"] = state.phase[chunk].cpu().numpy().astype(np.uint32)
    local["front_carry"] = (np.zeros((0, 2, L), np.float32)
                            if state.carry is None
                            else state.carry.cpu().numpy())
    return mesh_mod.gather_channels(local, _post_axes(cfg, params))


def scatter_state(cfg: rx.RxConfig, mesh: mesh_mod.Mesh, global_state,
                  device=None) -> ShardedRxState:
    """This rank's part of a global state: a {dotted leaf: array} dict as
    `gather_state` gives, or the JAX package's sharded RxState (its
    leaves as arrays)."""
    dev = rx.resolve_device(device)
    params = rx.make_params(cfg, "cpu")
    flat = mesh_mod.flatten(global_state)
    C = flat["nco_phase"].shape[0]
    axes = _post_axes(cfg, params)
    like = rx.init_state(cfg, params, (1,))._replace(nco_phase=None,
                                                      front_carry=None)
    post = mesh_mod.take_channels(
        {f: v for f, v in flat.items() if f in axes and f not in _FRONT},
        axes, mesh_mod.channel_slice(mesh, C))
    row = mesh_mod.row_slice(mesh, C)
    phase = np.asarray(flat["nco_phase"])[row].astype(np.int64)
    carry = np.array(flat["front_carry"], np.float32)[row]
    return ShardedRxState(
        phase=torch.as_tensor(phase, device=dev),
        carry=(torch.as_tensor(carry, device=dev).contiguous()
               if mesh.sp_idx == 0 else None),
        post=rx.state_from_numpy(nest_leaves(like, post), device=dev))
