"""K11 and K14 (the biquad cascade, sequential and by a two-level scan)
and K2 (the fused blocked SOS cascade): wrappers around the hand-written
kernels `kernels/biquad.cu` and `kernels/blocked.cu`, each beside its
plain torch version.

A wrapper takes the plain version only for tensors on the CPU.  For CUDA
tensors it checks device, dtype, shape and contiguity, launches its
kernel on the current stream (building it on first use), raises if the
launch failed, and adds one to the kernel's ``launches`` count.  There is
no fallback.

K11 replaces uhsdr_tpu/pallas/iir.py::_make_kernel (:44), entered from
`biquad_cascade_pallas` (:336), which the reference runs on SAM's two
stacked 7-section z^-2 allpass chains (demod/sam.py:213-216); the port
runs SAM's whole sideband stage as one launch of its own kernel on K11's
tile ring (`cuda/sam.py`, `kernels/sam.cu`), and K11 runs the cascade
blocks the blocked form cannot chunk (`cascade_dispatch`) and the
`biquad_cascade` entry.  Its launch rule is `biquad_geometry`.  K14
replaces ::_make_kernel_grouped (:112), `biquad_cascade_pallas(impl=
"grouped")`: the same function by a two-level scan, tiled as the TPU
kernel is at t_tile = 32 L (a warp a row, a lane a group); its launch
rule is `grouped_geometry`.  K2 replaces
::_make_blocked_kernel (:224), `biquad_cascade_blocked_pallas` (:263):
the whole cascade in 128-sample chunks with the exact chunk carry, the
chains' PreFilter, FM squelch HPF and TX voice bandpass.  What bounds
each on the card is noted in its source.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops import iir as iir_ops
from . import ring
from .build import (CudaKernel, derived, resource_usage, sm_count,
                    stream_ptr)

_P = ctypes.c_void_p
_I = ctypes.c_int

BIQUAD = CudaKernel("biquad", "biquad.cu", {
    "uhsdr_biquad_launch": ([_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
                            _I),
    "uhsdr_biquad_max_sections": ([], _I),
    "uhsdr_biquad_threads": ([], _I),
    "uhsdr_biquad_walkers": ([], _I),
    "uhsdr_biquad_tile": ([], _I),
    "uhsdr_biquad_stages": ([], _I),
    "uhsdr_biquad_smem": ([_I], _I),
    "uhsdr_biquad_grouped_launch": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                                     _P, _P], _I),
    "uhsdr_biquad_grouped_levels": ([], _I),
    "uhsdr_biquad_grouped_head": ([], _I),
    "uhsdr_biquad_grouped_warps": ([], _I),
    "uhsdr_biquad_grouped_stages": ([], _I),
    "uhsdr_biquad_grouped_blocks_per_sm": ([_I], _I),
    "uhsdr_biquad_grouped_smem": ([_I, _I, _I], _I),
}, extra_flags=("-fmad=false",))
# one source and library, counted apart: K14, the grouped scan
BIQUAD_GROUPED = CudaKernel("biquad_grouped", "biquad.cu", lib_of=BIQUAD)

BLOCKED = CudaKernel("blocked", "blocked.cu", {
    "uhsdr_blocked_launch": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                              _P], _I),
    "uhsdr_blocked_chunk": ([], _I),
    "uhsdr_blocked_max_sections": ([], _I),
    "uhsdr_blocked_outputs_per_lane": ([], _I),
    "uhsdr_blocked_warps": ([], _I),
    "uhsdr_blocked_slots": ([], _I),
    "uhsdr_blocked_row_stride": ([], _I),
    "uhsdr_blocked_smem": ([_I], _I),
})

# K14's layout, as `kernels/biquad.cu` defines it (checked against the
# library's getters when it is first loaded): the group lengths it is
# built for, groups a tile (a lane each), levels of (A^L)^(2^j) (log2 of
# the groups), a section record's head (5 coefficients, 3 pad floats),
# most warps (rows) a block, tiles in a warp's ring, blocks an SM by
# group length (its __launch_bounds__), the most sections
GROUP_LENS = (16, 32, 64)
GROUPED_TILE_GROUPS = 32
GROUPED_LEVELS = 5
GROUPED_HEAD = 8
GROUPED_WARPS = 4
GROUPED_STAGES = 2
GROUPED_BLOCKS_PER_SM = {16: 8, 32: 5, 64: 2}
GROUPED_MAX_SECTIONS = 8


def _need(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _f32_on(ts, dev, name: str):
    _need(all(t.dtype == torch.float32 and t.device == dev
              and t.is_contiguous() for t in ts),
          f"{name}: contiguous f32 tensors on one device")


# ---------------------------------------------------------------------------
# K11 and K14: the biquad cascade
# ---------------------------------------------------------------------------

# the most row lanes of a K11 walker warp (the rest of the layout is
# `kernels/ring.cuh`'s, `cuda/ring.py`)
BIQUAD_MAX_LANES = 32


class BiquadGeometry(NamedTuple):
    """K11's launch (`kernels/biquad.cu::biquad_kernel`)."""
    lanes: int      # row lanes of each walker warp
    walkers: int    # walker warps a block
    rows: int       # rows a block: walkers * lanes
    stages: int     # tiles in the ring
    blocks: int     # the grid
    smem: int       # dynamic shared memory, bytes


def biquad_geometry(C: int, T: int, sms: int = ring.SMS) -> BiquadGeometry:
    """K11's launch rule for C rows of T samples: the fewest row lanes a
    walker warp that puts the rows in at most `sms` blocks, so that every
    SM runs a block and each of its four schedulers one walker (a warp's
    time a sample is its S sections' issue, whatever its lanes); past 32
    lanes (C > 128 sms) the blocks run several an SM.  The ring holds
    ring.STAGES tiles of (TA + 4)-float rows.  Raises ValueError for an
    empty launch."""
    _need(C >= 1 and T >= 1 and sms >= 1,
          f"biquad_cascade: {C} rows of {T} samples on {sms} SMs")
    lanes = min(BIQUAD_MAX_LANES, -(-C // (ring.WALKERS * sms)))
    rows = ring.WALKERS * lanes
    smem = ring.STAGES * rows * (ring.TILE + 4) * 4
    return BiquadGeometry(lanes, ring.WALKERS, rows, ring.STAGES,
                          -(-C // rows), smem)


def _biquad_lib():
    """K11's library, its layout checked against `cuda/ring.py`'s."""
    return ring.checked_lib(BIQUAD, "biquad")


def biquad_cascade_plain(sos, state, x):
    """Plain torch version of K11: the sequential DF2T recurrence
    (`ops.iir.biquad_cascade_block`)."""
    return iir_ops.biquad_cascade_block(sos, state, x)


class GroupedGeometry(NamedTuple):
    """K14's launch (`kernels/biquad.cu::biquad_grouped_kernel`)."""
    warps: int      # warps a block: one row each
    resident: int   # blocks an SM holds (the kernel's launch bounds)
    tile: int       # samples a tile: 32 groups of L
    tiles: int      # tiles a row, the last ragged where T % tile
    blocks: int     # the grid
    smem: int       # dynamic shared memory a block, bytes


def grouped_smem(L: int, S: int, warps: int) -> int:
    """K14's dynamic shared memory a block: S section records (the head,
    A^1..A^L, the levels) and each warp's ring of GROUPED_STAGES tiles of
    32 rows of L + 4 floats and its two carry buffers of 2 x 8 floats."""
    rec = GROUPED_HEAD + 4 * L + 4 * GROUPED_LEVELS
    per_warp = (GROUPED_STAGES * GROUPED_TILE_GROUPS * (L + 4)
                + 4 * GROUPED_MAX_SECTIONS)
    return 4 * (S * rec + warps * per_warp)


def grouped_geometry(C: int, T: int, L: int, S: int,
                     sms: int = ring.SMS) -> GroupedGeometry:
    """K14's launch rule for C rows of T samples through S sections in
    groups of L: one warp a row, as many warps a block (up to
    GROUPED_WARPS, one per scheduler) as spread the rows over at most
    `sms` blocks, so a narrow launch still reaches every SM; at 16384
    rows 4096 blocks of four warps, GROUPED_BLOCKS_PER_SM[L] of them an
    SM (by registers: 2 L floats a lane; and by shared memory).  Raises
    ValueError for a launch the kernel does not take."""
    _need(L in GROUP_LENS, f"biquad_cascade: group_len {L} not in "
                           f"{GROUP_LENS}")
    _need(1 <= S <= GROUPED_MAX_SECTIONS and C >= 1 and T >= 1 and sms >= 1,
          f"biquad_cascade: {S} sections, {C} rows of {T} samples, "
          f"{sms} SMs")
    warps = min(GROUPED_WARPS, -(-C // sms))
    tile = GROUPED_TILE_GROUPS * L
    return GroupedGeometry(warps, GROUPED_BLOCKS_PER_SM[L], tile,
                           -(-T // tile), -(-C // warps),
                           grouped_smem(L, S, warps))


def grouped_resources(lib) -> dict:
    """{L: registers, stack and local (spill) bytes of K14's instance} in
    a built biquad.cu library (`build.resource_usage`); None for an
    instance it lacks."""
    use = resource_usage(lib)
    return {L: next((u for f, u in use.items()
                     if f"biquad_grouped_kernelILi{L}E" in f), None)
            for L in GROUP_LENS}


def _grouped_lib():
    """K14's library (K11's), its layout checked against this module's
    when it is first used (the mark lives on the library)."""
    lib = _biquad_lib()
    if not getattr(lib, "grouped_checked", False):
        got = (lib.uhsdr_biquad_grouped_levels(),
               lib.uhsdr_biquad_grouped_head(),
               lib.uhsdr_biquad_grouped_warps(),
               lib.uhsdr_biquad_grouped_stages(),
               lib.uhsdr_biquad_max_sections(),
               {L: lib.uhsdr_biquad_grouped_blocks_per_sm(L)
                for L in GROUP_LENS})
        want = (GROUPED_LEVELS, GROUPED_HEAD, GROUPED_WARPS, GROUPED_STAGES,
                GROUPED_MAX_SECTIONS, GROUPED_BLOCKS_PER_SM)
        if got != want:
            raise RuntimeError(f"biquad.cu's K14 layout {got} differs from "
                               f"cuda/iir.py's {want}")
        lib.grouped_checked = True
    return lib


def grouped_powers(sos_key: tuple, L: int, levels: int):
    """Per section of the flat (S x 5) `sos_key`, from float64 as the TPU
    kernel builds them (pallas/iir.py:133-144): the head [b0, b1 - a1 b0,
    b2 - a2 b0, -a1, -a2], A^1 .. A^L and (A^L)^(2^j) for j < `levels`,
    A = [[-a1, 1], [-a2, 0]]."""
    sos = np.asarray(sos_key, np.float64).reshape(-1, 5)
    out = []
    for b0, b1, b2, a1, a2 in sos:
        A = np.array([[-a1, 1.0], [-a2, 0.0]])
        powers = [A]
        for _ in range(L - 1):
            powers.append(powers[-1] @ A)
        lv, M = [], powers[-1]
        for _ in range(levels):
            lv.append(M)
            M = M @ M
        out.append(([b0, b1 - a1 * b0, b2 - a2 * b0, -a1, -a2], powers, lv))
    return out


@functools.lru_cache(maxsize=64)
def _grouped_table_np(sos_key: tuple, L: int) -> np.ndarray:
    """K14's per-section records (`grouped_powers`), rounded to f32 once:
    the head padded with zeros to GROUPED_HEAD floats, then A^1 .. A^L
    and the GROUPED_LEVELS levels, 2 x 2 row-major each."""
    recs = [np.concatenate([head, np.zeros(GROUPED_HEAD - 5)]
                           + [M.reshape(-1) for M in powers + lv])
            for head, powers, lv in grouped_powers(sos_key, L,
                                                   GROUPED_LEVELS)]
    return np.concatenate(recs).astype(np.float32)


def grouped_table(sos: torch.Tensor, L: int) -> torch.Tensor:
    """K14's table for `sos` on its device, built once per (tensor,
    group length)."""
    return derived(sos, ("grouped", L), lambda v: torch.as_tensor(
        _grouped_table_np(tuple(np.asarray(v, np.float64).reshape(-1)
                                .tolist()), L), device=sos.device))


def _grouped_tile_section(rec, s1, s2, xg, t_last: int, g_last: int):
    """One section of K14's plain version on one tile: xg (C, G, L) in,
    y (C, G, L) out; (s1, s2) (C,) the carried state, folded into the
    tile's sample 0.  Returns (y, (C, 2) end state at group g_last,
    sample t_last)."""
    h = GROUPED_HEAD
    L = xg.shape[-1]
    f32 = functools.partial(torch.tensor, dtype=torch.float32)
    b0, g1, g2, a11, a21 = (f32(float(v)) for v in rec[:5])
    P = rec[h:h + 4 * L].reshape(L, 4).tolist()    # A^(l+1), row-major
    Q = rec[h + 4 * L:].reshape(-1, 4)
    C, G = xg.shape[:2]
    # phase 1: the local scans of all groups at once
    c1 = g1 * xg
    c2 = g2 * xg
    c1[:, 0, 0] = c1[:, 0, 0] + (a11 * s1 + s2)
    c2[:, 0, 0] = c2[:, 0, 0] + a21 * s1
    v1p = torch.zeros((C, G), dtype=xg.dtype, device=xg.device)
    v2p = torch.zeros_like(v1p)
    v1 = []
    for l in range(L):
        n1 = c1[..., l] + a11 * v1p + v2p
        n2 = c2[..., l] + a21 * v1p
        v1.append(n1)
        v1p, v2p = n1, n2
        if l == t_last:
            v2end = n2[:, g_last]
    # phase 2: the scan over the group ends
    e1, e2 = v1p.clone(), v2p.clone()
    for j, q in enumerate(Q):
        d = 1 << j
        p1, p2 = e1[:, :-d], e2[:, :-d]
        e1[:, d:], e2[:, d:] = (e1[:, d:] + float(q[0]) * p1
                                + float(q[1]) * p2,
                                e2[:, d:] + float(q[2]) * p1
                                + float(q[3]) * p2)
    # phase 3: the correction and the output
    zero = torch.zeros((C, 1), dtype=xg.dtype, device=xg.device)
    q1 = torch.cat([zero, e1[:, :-1]], dim=-1)
    q2 = torch.cat([zero, e2[:, :-1]], dim=-1)
    prev = torch.cat([s1[:, None], q1[:, 1:]], dim=-1)
    ys = []
    for l in range(L):
        u1 = v1[l] + P[l][0] * q1 + P[l][1] * q2
        ys.append(b0 * xg[..., l] + prev)
        prev = u1
        if l == t_last:
            s1_end = u1[:, g_last]
    s2_end = (v2end + P[t_last][2] * q1[:, g_last]
              + P[t_last][3] * q2[:, g_last])
    return torch.stack(ys, dim=-1), torch.stack([s1_end, s2_end], dim=-1)


def biquad_grouped_plain(sos, state, x, group_len: int = 32):
    """Plain torch version of K14, the TPU kernel's tiling at t_tile = 32
    group_len: tile by tile, the state carried between tiles, each
    section's local scans of the tile's 32 groups at once (a loop over a
    group's samples), the scan over the group ends with (A^L)^(2^j) (a
    loop over the five levels), the correction by A^(l+1) and the output;
    the operations and their order are the kernel's.  A ragged last tile
    is padded with zeros and its end state read at T-1.  sos (S, 5);
    state (S, C, 2); x (C, T).  Returns (y (C, T), new_state (S, C,
    2))."""
    L = group_len
    S = sos.shape[0]
    C, T = x.shape
    TL = GROUPED_TILE_GROUPS * L
    n_tiles = -(-T // TL)
    tab = grouped_table(sos, L).reshape(S, -1).cpu().numpy()
    xt = torch.nn.functional.pad(x, (0, n_tiles * TL - T)).reshape(
        C, n_tiles, GROUPED_TILE_GROUPS, L)
    carry = [(state[k, :, 0], state[k, :, 1]) for k in range(S)]
    ys = []
    for j in range(n_tiles):
        n = min(TL, T - j * TL)
        xg = xt[:, j]
        for k in range(S):
            xg, end = _grouped_tile_section(tab[k], *carry[k], xg,
                                            (n - 1) % L, (n - 1) // L)
            carry[k] = (end[:, 0], end[:, 1])
        ys.append(xg.reshape(C, TL))
    y = torch.cat(ys, dim=-1)[:, :T].contiguous()
    return y, torch.stack([torch.stack(c, dim=-1) for c in carry], dim=0)


def biquad_cascade(sos, state, x, impl: str = "sequential",
                   group_len: int = 32):
    """S-section biquad cascade.  sos: (S, 5) f32 rows [b0, b1, b2, a1,
    a2]; state: (S, C, 2) f32 DF2T states; x: (C, T) f32.  impl
    "sequential" is K11 (the recurrence, one lane a channel, launched by
    `biquad_geometry`); "grouped" is K14 (the two-level scan in groups
    of `group_len` samples, tiles of 32 groups, any T, launched by
    `grouped_geometry`: the counterpart of `biquad_cascade_pallas(impl=
    "grouped", t_tile=32 * group_len)`).  Returns (y (C, T), new_state
    (S, C, 2))."""
    _need(impl in ("sequential", "grouped"),
          f"biquad_cascade: impl {impl!r} is not sequential or grouped")
    grouped = impl == "grouped"
    if x.device.type == "cpu":
        return (biquad_grouped_plain(sos, state, x, group_len) if grouped
                else biquad_cascade_plain(sos, state, x))
    dev = x.device
    _need(x.ndim == 2 and x.shape[-1] >= 1,
          "biquad_cascade: x must be (C, T), T >= 1")
    C, T = x.shape
    lib = _biquad_lib()
    S = sos.shape[0]
    _need(sos.shape == (S, 5)
          and 1 <= S <= lib.uhsdr_biquad_max_sections(),
          f"biquad_cascade: sos must be (S, 5) with 1 <= S <= "
          f"{lib.uhsdr_biquad_max_sections()}, got {tuple(sos.shape)}")
    _need(state.shape == (S, C, 2), "biquad_cascade: state must be (S, C, 2)")
    _f32_on((sos, state, x), dev, "biquad_cascade")
    y = torch.empty_like(x)
    new_state = torch.empty_like(state)
    vec = int(T % 4 == 0 and x.data_ptr() % 16 == 0
              and y.data_ptr() % 16 == 0)
    if grouped:
        geo = grouped_geometry(C, T, group_len, S, sm_count(dev.index))
        tab = grouped_table(sos, group_len)
        err = _grouped_lib().uhsdr_biquad_grouped_launch(
            x.data_ptr(), state.data_ptr(), tab.data_ptr(), S, C, T,
            group_len, geo.warps, vec, y.data_ptr(), new_state.data_ptr(),
            stream_ptr(dev))
        counter = BIQUAD_GROUPED
    else:
        geo = biquad_geometry(C, T, sm_count(dev.index))
        err = lib.uhsdr_biquad_launch(
            x.data_ptr(), state.data_ptr(), sos.data_ptr(), S, C, T,
            geo.lanes, vec, y.data_ptr(), new_state.data_ptr(),
            stream_ptr(dev))
        counter = BIQUAD
    counter.check(err)
    counter.launches += 1
    return y, new_state


# ---------------------------------------------------------------------------
# K2: the fused blocked cascade
# ---------------------------------------------------------------------------

# K2's geometry constants, as `kernels/blocked.cu` defines them (the
# wrapper checks them against the library's getters when it first loads
# it): the chunk, the most sections, outputs a lane holds, warps a block,
# rows a round (one a lane), tiles in the ring and the tile row stride
# (floats).
BLOCKED_R = 128
BLOCKED_MAX_SECTIONS = 8
BLOCKED_RO = 16
BLOCKED_WARPS = 4
BLOCKED_LANES = 32
BLOCKED_SLOTS = 3
BLOCKED_ROW_STRIDE = BLOCKED_R + 4
# the card the rule fills: an H100 SXM's SMs, an SM's shared memory (228
# KB) and what each resident block reserves besides its own (1 KB); the
# most chunks of one channel a round holds (the in-order carry runs them
# one after another)
BLOCKED_SMS = 132
SM_SMEM = 228 * 1024
BLOCK_RESERVED = 1024
BLOCKED_MAX_TR = 8


class BlockedGeometry(NamedTuple):
    """K2's launch for one shape (`kernels/blocked.cu`)."""
    cpw: int          # channels a block (a power of two up to 32)
    tr: int           # chunks of a channel a round (32 / cpw)
    rounds: int       # rounds a block walks
    blocks: int       # thread blocks
    smem: int         # dynamic shared memory a block, bytes
    resident: int     # blocks an SM can hold (by shared memory)


def _round_up4(n: int) -> int:
    return -(-n // 4) * 4


def blocked_smem(S: int) -> int:
    """K2's dynamic shared memory for S sections, bytes
    (`kernels/blocked.cu::layout`): h, HS and G^T (R floats each a state
    row), F^T, the x G partial sums of two rounds and u_{c-1} of two
    rounds (rows of 2S + 1 floats), and the ring of tiles."""
    R, U, L = BLOCKED_R, 2 * S, BLOCKED_LANES
    floats = (R + 2 * U * R + _round_up4(U * U)
              + _round_up4(2 * BLOCKED_WARPS * L * (U + 1))
              + _round_up4(2 * L * (U + 1))
              + BLOCKED_SLOTS * L * BLOCKED_ROW_STRIDE)
    return 4 * floats


@functools.lru_cache(maxsize=256)
def blocked_geometry(C: int, T: int, S: int,
                     sms: int = BLOCKED_SMS) -> BlockedGeometry:
    """K2's launch for C channels of T samples through S sections on a
    card of `sms` SMs.  A block of BLOCKED_WARPS warps walks all the
    rounds of its cpw channels, a round 32 rows: cpw channels x tr = 32 /
    cpw consecutive chunks.  Every block does the same work and an SM
    holds `resident`, so the hardware deals the blocks out in waves and a
    block slot walks ceil(blocks / slots) x cpw rows: of cpw = 32 down to
    32 / BLOCKED_MAX_TR (and no more chunks a round than a channel has),
    the rule takes the largest cpw within a tenth of the fewest rows (a
    chain of 8 chunks a round measured about a tenth slower than one of
    4, trace_blocked.py).  Raises ValueError for a shape the kernel does
    not take: S outside 1..BLOCKED_MAX_SECTIONS (the states live in
    registers and the tables in shared memory), T not a positive multiple
    of 128, or buffers past an SM's shared memory."""
    R = BLOCKED_R
    _need(1 <= S <= BLOCKED_MAX_SECTIONS,
          f"blocked_cascade: {S} sections outside 1..{BLOCKED_MAX_SECTIONS}"
          f" (the kernel's state registers and shared tables)")
    _need(T >= R and T % R == 0,
          f"blocked_cascade: T={T} is not a positive multiple of {R}")
    _need(C >= 0 and sms >= 1, f"blocked_cascade: {C} channels, {sms} SMs")
    smem = blocked_smem(S)
    _need(smem + BLOCK_RESERVED <= SM_SMEM,
          f"blocked_cascade: {S} sections need {smem} bytes of shared "
          f"memory, past {SM_SMEM - BLOCK_RESERVED}")
    n = T // R
    resident = SM_SMEM // (smem + BLOCK_RESERVED)
    tr_max = min(BLOCKED_MAX_TR, 1 << (n.bit_length() - 1))

    def rows(c):                       # waves of blocks x a block's rows
        return -(-(-(-C // c)) // (resident * sms)) * c
    allowed = [c for c in (32, 16, 8, 4, 2, 1) if c * tr_max >= BLOCKED_LANES]
    fewest = min(rows(c) for c in allowed)
    cpw = max(c for c in allowed if 10 * rows(c) <= 11 * fewest)
    tr = BLOCKED_LANES // cpw
    return BlockedGeometry(cpw, tr, -(-n // tr), -(-C // cpw), smem,
                           resident)


def _blocked_lib():
    """K2's library, its geometry constants checked against this module's
    when it is first used (the mark lives on the library)."""
    lib = BLOCKED.lib()
    if not getattr(lib, "geometry_checked", False):
        got = (lib.uhsdr_blocked_chunk(), lib.uhsdr_blocked_max_sections(),
               lib.uhsdr_blocked_outputs_per_lane(),
               lib.uhsdr_blocked_warps(), lib.uhsdr_blocked_slots(),
               lib.uhsdr_blocked_row_stride())
        want = (BLOCKED_R, BLOCKED_MAX_SECTIONS, BLOCKED_RO, BLOCKED_WARPS,
                BLOCKED_SLOTS, BLOCKED_ROW_STRIDE)
        if got != want:
            raise RuntimeError(f"blocked.cu's geometry {got} differs from "
                               f"cuda/iir.py's {want}")
        lib.geometry_checked = True
    return lib


def blocked_cascade_plain(c: iir_ops.Cascade, state, x):
    """Plain torch version of K2: the blocked matmuls with the exact
    sequential chunk carry (`ops.iir.biquad_cascade_blocked`), the form
    the chains ran on the card through cuBLAS before K2."""
    return iir_ops.biquad_cascade_blocked(c, state, x)


def blocked_cascade(c: iir_ops.Cascade, state, x):
    """The whole SOS cascade `c` in 128-sample chunks with the exact chunk
    carry (K2).  state: (S, ..., 2) f32 DF2T states; x: (..., T) f32, T a
    multiple of 128; the batch dims flatten to one channel axis (the
    stereo PreFilter's (C, 2, T) runs as 2C rows).  The launch is
    `blocked_geometry`'s for the card's SMs; it raises ValueError before
    any launch for a shape the rule refuses.  Returns (y (..., T),
    new_state (S, ..., 2))."""
    if x.device.type == "cpu":
        return blocked_cascade_plain(c, state, x)
    dev = x.device
    S = c.sections
    _need(x.ndim >= 1, "blocked_cascade: x must be (..., T)")
    T = x.shape[-1]
    R = BLOCKED_R
    _need(tuple(c.M.shape) == (R, R),
          f"blocked_cascade: tables for {R}-sample chunks, got "
          f"{tuple(c.M.shape)}")
    _need(tuple(state.shape) == (S,) + tuple(x.shape[:-1]) + (2,),
          "blocked_cascade: state must be (S, ..., 2) for x (..., T)")
    _f32_on((x, state, c.M, c.HS, c.G, c.Ft), dev, "blocked_cascade")
    _need(x.data_ptr() % 16 == 0, "blocked_cascade: x must be 16-byte "
          "aligned")
    C = x.numel() // T
    sms = sm_count(dev.index) if dev.type == "cuda" else BLOCKED_SMS
    geo = blocked_geometry(C, T, S, sms)
    lib = _blocked_lib()
    y = torch.empty_like(x)
    new_state = torch.empty_like(state)
    err = lib.uhsdr_blocked_launch(
        x.data_ptr(), state.data_ptr(), c.M.data_ptr(), c.HS.data_ptr(),
        c.G.data_ptr(), c.Ft.data_ptr(), S, C, T, geo.cpw, y.data_ptr(),
        new_state.data_ptr(), stream_ptr(dev))
    BLOCKED.check(err)
    BLOCKED.launches += 1
    return y, new_state


def cascade_dispatch(c: iir_ops.Cascade, state, x):
    """The chains' cascade stage: empty cascades pass through; blocks that
    chunk (T % 128 == 0, at least two chunks: the reference's
    `blocked_ok`) take K2; any other block takes K11, the same DF2T
    function, its batch dims flattened to channels (the reference falls to
    its Pallas cascade off the CPU, ops/iir.py:241-252).  On CPU tensors
    both run their plain versions."""
    if c.sections == 0:
        return x, state
    T = x.shape[-1]
    R = c.M.shape[0]
    if T % R == 0 and T >= 2 * R:
        return blocked_cascade(c, state, x)
    S = c.sections
    y, st = biquad_cascade(c.sos, state.reshape(S, -1, 2).contiguous(),
                           x.reshape(-1, T).contiguous())
    return y.reshape(x.shape), st.reshape(state.shape)
