"""Automatic IQ imbalance correction: wrapper around the hand-written
kernel `kernels/iqcorr.cu`, beside its plain torch version.

A helper kernel with no TPU counterpart: the JAX package forms the
sub-block sums as array reductions and walks the block-cadence one-poles
as a `lax.scan` (uhsdr_tpu/ops/iqcorr.py:56-101).  On the card a torch
loop over a block's 512 sub-blocks would cost thousands of launches, so
the whole of `correct` is one kernel: the int16 scaling, the three
sub-block sums, the one-pole walk, c1 and c2, the corrected planes, the
new state and the twin-peaks flag.  The wrapper takes the plain version
only for tensors on the CPU; for CUDA tensors it checks its arguments,
launches the kernel on the current stream (building it on first use),
raises if the launch failed and adds one to ``IQCORR.launches``.  There
is no fallback.

The sums are pairwise trees over a sub-block's 32 samples, the order of
the kernel's lanes and shuffles (`trees.pair_tree`: 8 samples a lane,
three levels in the lane, two across a sub-block's 4 lanes), so the two
agree bit for bit; the kernel is built with -fmad=false.  The kernel's
layout (a block a channel, a ring of 8 KB stages that each input byte
passes through once, worker warps and a walker warp) is mirrored here by
`iqcorr_geometry`, and the built library's exports are checked against
it on first use.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .build import CudaKernel, stream_ptr
from .trees import pair_tree

_P = ctypes.c_void_p
_I = ctypes.c_int

IQCORR = CudaKernel("iqcorr", "iqcorr.cu", {
    "uhsdr_iqcorr_launch": ([_I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                             _P, _P, _P, _P, _P, _P, _P], _I),
    "uhsdr_iqcorr_threads": ([], _I),
    "uhsdr_iqcorr_chunk": ([_I], _I),
    "uhsdr_iqcorr_stages": ([], _I),
    "uhsdr_iqcorr_ahead": ([], _I),
    "uhsdr_iqcorr_stage_bytes": ([], _I),
    "uhsdr_iqcorr_smem": ([], _I),
    "uhsdr_iqcorr_min_blocks": ([], _I),
    "uhsdr_iqcorr_occupancy": ([_I], _I),
}, extra_flags=("-fmad=false",))

SUBBLOCK = 32           # the reference's IQ_BLOCK_SIZE
LP_A = 0.997            # the block-cadence one-pole (audio_driver.c:2254-2316)
LP_B = 0.003
INT16_SCALE = 1.0 / 32768.0

# the kernel's layout (`kernels/iqcorr.cu`): worker warps and the walker
# warp, a stage's bytes (a chunk of both planes as they come), the stages
# of the ring and the chunks in flight past the one being summed, and the
# blocks an SM the kernel is built for (its launch bounds): AHEAD stages
# of copies in flight a block, 64 KB an SM
WORKERS = 4
THREADS = 32 * (WORKERS + 1)
STAGE_BYTES = 8192
STAGES = 4
AHEAD = 2
MIN_BLOCKS = 4


class IqcorrGeometry(NamedTuple):
    """The IQ correction's launch (`kernels/iqcorr.cu::iqcorr_kernel`)."""
    chunk: int          # sub-blocks a stage holds (64 int16, 32 f32)
    chunks: int         # chunks a channel
    blocks: int         # the grid: a block a channel


def iqcorr_smem() -> int:
    """A block's shared memory: the stages and two chunks' sums (three
    float arrays of an int16 chunk's sub-blocks each)."""
    chunk16 = STAGE_BYTES // (2 * SUBBLOCK * 2)
    return STAGES * STAGE_BYTES + 2 * 3 * chunk16 * 4


def iqcorr_geometry(C: int, T: int, int16: bool = True) -> IqcorrGeometry:
    """The kernel's launch for C channels of T samples (int16 or f32
    planes): a block a channel, in chunks of a stage's 8 KB of both
    planes, so an int16 chunk is twice an f32 one.  Its blocks an SM are
    MIN_BLOCKS, of `iqcorr_smem()` bytes each (the card tests hold the
    runtime's occupancy to at least as many).  Raises ValueError for what
    the kernel does not take."""
    if C < 1 or T < SUBBLOCK or T % SUBBLOCK:
        raise ValueError(f"iqcorr: {C} channels of {T} samples; T must be "
                         f"a positive multiple of {SUBBLOCK}")
    chunk = STAGE_BYTES // (2 * SUBBLOCK * (2 if int16 else 4))
    return IqcorrGeometry(chunk, -(-(T // SUBBLOCK) // chunk), C)


def _lib():
    """The library, its layout checked against this module's once."""
    lib = IQCORR.lib()
    if not getattr(lib, "layout_checked", False):
        got = (lib.uhsdr_iqcorr_threads(), lib.uhsdr_iqcorr_chunk(1),
               lib.uhsdr_iqcorr_chunk(0), lib.uhsdr_iqcorr_stages(),
               lib.uhsdr_iqcorr_ahead(), lib.uhsdr_iqcorr_stage_bytes(),
               lib.uhsdr_iqcorr_smem(), lib.uhsdr_iqcorr_min_blocks())
        g16, g32 = iqcorr_geometry(1, SUBBLOCK), iqcorr_geometry(
            1, SUBBLOCK, False)
        want = (THREADS, g16.chunk, g32.chunk, STAGES, AHEAD, STAGE_BYTES,
                iqcorr_smem(), MIN_BLOCKS)
        if got != want:
            raise RuntimeError(f"iqcorr.cu's layout {got} differs from "
                               f"cuda/iqcorr.py's {want}")
        lib.layout_checked = True
    return lib


def _f32_planes(i: torch.Tensor, q: torch.Tensor):
    if i.dtype == torch.int16:
        return (i.to(torch.float32) * INT16_SCALE,
                q.to(torch.float32) * INT16_SCALE)
    return i, q


def iqcorr_plain(t1, t2, t3, i, q):
    """Plain torch version of the kernel: `ops.iqcorr.correct` on state
    leaves t1, t2, t3 (C,) and (C, T) int16 (scaled by 1/32768) or f32
    planes, T % 32 == 0.  Returns (i_c, q_c, t1, t2, t3, c1, c2, twinpeak),
    the planes (C, T) f32, the rest (C,) (twinpeak bool)."""
    x, y = _f32_planes(i, q)
    C, T = x.shape
    ib = x.reshape(C, T // SUBBLOCK, SUBBLOCK)
    qb = y.reshape(C, T // SUBBLOCK, SUBBLOCK)
    sgn = torch.where(ib > 0, 1.0, torch.where(ib < 0, -1.0, 0.0))
    a1 = pair_tree(sgn * qb) * (1.0 / SUBBLOCK)
    a2 = pair_tree(ib.abs()) * (1.0 / SUBBLOCK)
    a3 = pair_tree(qb.abs()) * (1.0 / SUBBLOCK)
    ts = []
    for k in range(a1.shape[-1]):
        t1 = -LP_B * a1[:, k] + LP_A * t1
        t2 = LP_B * a2[:, k] + LP_A * t2
        t3 = LP_B * a3[:, k] + LP_A * t3
        ts.append((t1, t2, t3))
    s1, s2, s3 = (torch.stack(v, dim=-1) for v in zip(*ts))
    # the reference's arithmetic blends, kept as blends (they differ from
    # selects on NaN and inf)
    nz = (s2.abs() > 1e-20).to(torch.float32)
    den = s2 * s2 + 1e-20
    c1 = nz * s1 * s2 / den
    h = (s3 * s3 - s1 * s1) / den
    hp = (h > 0).to(torch.float32) * nz
    c2 = hp * torch.sqrt(torch.clamp_min(h, 1e-20)) + (1.0 - hp)
    q_c = qb + c1[..., None] * ib
    i_c = ib * c2[..., None]
    phase_err = t1.abs() / torch.clamp_min(t2, 1e-12)
    twin = (t2 > 1e-6) & (phase_err > 0.45)
    return (i_c.reshape(C, T), q_c.reshape(C, T), t1, t2, t3,
            c1[:, -1].contiguous(), c2[:, -1].contiguous(), twin)


def iqcorr(t1, t2, t3, i, q):
    """The IQ correction of one block (the kernel on CUDA tensors, the
    plain version on CPU ones); arguments and results as
    `iqcorr_plain`'s."""
    if i.device.type == "cpu":
        return iqcorr_plain(t1, t2, t3, i, q)
    dev = i.device
    if i.ndim != 2 or q.shape != i.shape:
        raise ValueError("iqcorr: i and q must be (C, T) planes")
    C, T = i.shape
    if i.dtype not in (torch.int16, torch.float32) or q.dtype != i.dtype:
        raise ValueError("iqcorr: two int16 or two f32 planes")
    iqcorr_geometry(C, T, i.dtype == torch.int16)
    ts = (t1, t2, t3)
    if any(t.dtype != torch.float32 or t.shape != (C,) for t in ts):
        raise ValueError("iqcorr: state leaves (C,) f32")
    if any(t.device != dev or not t.is_contiguous() for t in ts + (i, q)):
        raise ValueError("iqcorr: contiguous tensors on one device")
    i_c = torch.empty((C, T), dtype=torch.float32, device=dev)
    q_c = torch.empty_like(i_c)
    out = [torch.empty((C,), dtype=torch.float32, device=dev)
           for _ in range(5)]
    twin = torch.empty((C,), dtype=torch.bool, device=dev)
    vec = int(i.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    err = _lib().uhsdr_iqcorr_launch(
        1 if i.dtype == torch.int16 else 0, i.data_ptr(), q.data_ptr(),
        t1.data_ptr(), t2.data_ptr(), t3.data_ptr(), C, T, vec,
        i_c.data_ptr(), q_c.data_ptr(), *(o.data_ptr() for o in out),
        twin.data_ptr(), stream_ptr(dev))
    IQCORR.check(err)
    IQCORR.launches += 1
    return (i_c, q_c, *out, twin)
