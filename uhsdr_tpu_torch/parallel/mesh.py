"""The (dp, sp) process mesh of the sharded paths, on `torch.distributed`:
the counterpart of `uhsdr_tpu.parallel.mesh`.

Axes:
  * ``dp``: channel parallelism.  Receiver channels are independent, so
    this is the main scaling axis (SURVEY §2.6 "channel batching").
  * ``sp``: sequence (time) parallelism.  The IQ time axis is split, and
    the streaming FIR's history crosses shard boundaries as a halo passed
    to the right neighbour within a dp row (SURVEY §2.6: the overlap-save
    seam).

A mesh is laid over the initialized default process group, one rank a
device, as the JAX package reshapes its devices: rank = dp_idx * n_sp +
sp_idx, so a dp row is n_sp consecutive ranks.  Each row gets a process
group of its own (the sp group), which carries the halo and the reshard.
The arrays a rank holds are slices of the global ones, given here as
functions: `channel_slice` for channels split over every rank
(``P(("dp", "sp"))``), `grid_slice` for (channels, time) split over (dp,
sp) (``P("dp", "sp")``).  The state helpers at the end move a sharded
state to one global state in the JAX package's layout and back.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, sp) mesh over the default group."""
    n_dp: int
    n_sp: int
    rank: int
    sp_group: object          # this rank's dp row as a process group
    sp_ranks: tuple           # global ranks of the row, in sp order

    @property
    def size(self) -> int:
        return self.n_dp * self.n_sp

    @property
    def dp_idx(self) -> int:
        return self.rank // self.n_sp

    @property
    def sp_idx(self) -> int:
        return self.rank % self.n_sp


def make_mesh(n_dp: int | None = None, n_sp: int = 1) -> Mesh:
    """The (dp, sp) mesh over the initialized default process group (all
    ranks call it, as `new_group` needs).  Raises RuntimeError where no
    group is initialized: nothing here runs single-process silently."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed process group "
            "(parallel.multihost.initialize, or init_process_group)")
    n = dist.get_world_size()
    if n_dp is None:
        n_dp = n // n_sp
    if n_dp < 1 or n_sp < 1 or n_dp * n_sp != n:
        raise ValueError(f"mesh {n_dp} x {n_sp} over {n} ranks")
    rank = dist.get_rank()
    mine = None
    for d in range(n_dp):
        ranks = tuple(range(d * n_sp, (d + 1) * n_sp))
        group = dist.new_group(list(ranks))
        if rank in ranks:
            mine = (group, ranks)
    return Mesh(n_dp, n_sp, rank, *mine)


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} {n} not a multiple of {parts}")
    return n // parts


def channel_slice(mesh: Mesh, C: int) -> slice:
    """This rank's channels of C split over every rank (dp x sp
    collapsed, ``P(("dp", "sp"))``): block dp_idx * n_sp + sp_idx."""
    n = _split(C, mesh.size, "channels")
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def row_slice(mesh: Mesh, C: int) -> slice:
    """The channels of this rank's dp row: C split over dp (``P("dp")``)."""
    c = _split(C, mesh.n_dp, "channels")
    return slice(mesh.dp_idx * c, (mesh.dp_idx + 1) * c)


def grid_slice(mesh: Mesh, C: int, T: int) -> tuple[slice, slice]:
    """This rank's (C / n_dp, T / n_sp) tile of a (channels, time) grid
    split over (dp, sp) (``P("dp", "sp")``)."""
    t = _split(T, mesh.n_sp, "samples")
    return row_slice(mesh, C), slice(mesh.sp_idx * t, (mesh.sp_idx + 1) * t)


def ring_shift(x: torch.Tensor, recv: torch.Tensor, ranks, group) -> list:
    """Start the cyclic right shift of `x` over `ranks` (global ranks in
    ring order, `group` theirs): it goes to the next rank, the last
    rank's to the first, and `recv` takes the previous rank's.  Returns
    the requests to wait on."""
    i = list(ranks).index(dist.get_rank())
    n = len(ranks)
    return dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, ranks[(i + 1) % n], group),
        dist.P2POp(dist.irecv, recv, ranks[(i - 1) % n], group)])


def reshard_rows(group, n: int, x: torch.Tensor) -> torch.Tensor:
    """Time-sharded to channel-sharded within a group of n ranks: x is
    this rank's (C, t) tile of time shard `rank in group`; chunk j of its
    C channels goes to the group's rank j, and the (C / n, n * t) rows of
    this rank's chunk come back in time order.  Real or complex x (the
    collective moves it as f32 pairs); at n = 1 the identity."""
    if n == 1:
        return x
    cx = x.is_complex()
    flat = (torch.view_as_real(x) if cx else x).contiguous()
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat, group=group)
    C, t = x.shape[0] // n, x.shape[1]
    out = out.reshape((n, C, t) + flat.shape[2:]).transpose(0, 1)
    out = out.reshape((C, n * t) + flat.shape[2:])
    return torch.view_as_complex(out.contiguous()) if cx else out


# ---------------------------------------------------------------------------
# the state helpers: dotted {leaf: NumPy array} dicts, a leaf's channel
# axis found from states of 1 and 2 channels
# ---------------------------------------------------------------------------

def flatten(s, prefix: str = "") -> dict:
    """{dotted name: NumPy array} of a NamedTuple state whose leaves are
    arrays or tensors (the JAX package's state, or the port's), None
    leaves left out; a dict passes through."""
    if isinstance(s, dict):
        return s
    out = {}
    for f in s._fields:
        v = getattr(s, f)
        name = f"{prefix}.{f}" if prefix else f
        if v is None:
            continue
        if hasattr(v, "_fields"):
            out.update(flatten(v, name))
        else:
            out[name] = (v.detach().cpu().numpy()
                         if isinstance(v, torch.Tensor) else np.asarray(v))
    return out


def channel_axes(leaves) -> dict:
    """{leaf: its channel axis}, from `leaves(n)`, the dotted leaves of a
    state of n channels, at n = 1 and 2; None for a leaf without one."""
    a, b = leaves(1), leaves(2)
    out = {}
    for f, v in a.items():
        diff = [k for k, (x, y) in enumerate(zip(v.shape, b[f].shape))
                if x != y]
        out[f] = diff[0] if diff else None
    return out


def take_channels(flat: dict, axes: dict, sl: slice) -> dict:
    """Each leaf's channels `sl` (a leaf without a channel axis whole)."""
    out = {}
    for f, v in flat.items():
        ax = axes.get(f)
        out[f] = v if ax is None else np.take(
            v, range(sl.start, sl.stop), axis=ax)
    return out


def gather_channels(local: dict, axes: dict, group=None) -> dict:
    """Every rank's leaves (`local`, this rank's) joined on their channel
    axes in rank order; a leaf without one is rank 0's.  Every rank of
    `group` calls it and gets the whole."""
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, local, group=group)
    return {f: (parts[0][f] if axes.get(f) is None else np.concatenate(
        [p[f] for p in parts], axis=axes[f])) for f in local}
