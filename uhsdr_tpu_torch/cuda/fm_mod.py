"""The reference-table FM modulator: wrapper around the hand-written kernel
`kernels/fm_mod.cu`, beside its plain torch version.

A helper kernel with no TPU counterpart: the JAX package runs the
firmware's sequential pre-emphasis and its truncating 16-bit phase
accumulator as two `lax.scan`s (uhsdr_tpu/mod/modulators.py:244-340),
then indexes the 10-bit DDS grid.  On the card a torch loop over a
block's samples would cost some ten launches a sample, so the whole of
the table-mode modulator is one kernel on the tile ring of
`kernels/ring.cuh`: walker warps run the two recurrences a lane a
channel and write the table index, output warps look it up and store i
and q; its launch rule is `fm_mod_geometry`.  The wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
checks its arguments, launches the kernel on the current stream (building
it on first use), raises if the launch failed and adds one to
``FM_MOD.launches``.  There is no fallback.  The kernel is built with
-fmad=false and repeats the plain version's operations in its order, and
both read the one DDS table `fm_table` makes: bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import steps
from . import ring
from .build import CudaKernel, sm_count, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

FM_MOD = CudaKernel("fm_mod", "fm_mod.cu", {
    "uhsdr_fm_mod_launch": ([_P] * 6 + [_I] * 4 + [_F] * 4 + [_I]
                            + [_P] * 6, _I),
    "uhsdr_fm_mod_smem": ([_I, _I], _I),
    "uhsdr_fm_mod_walkers": ([], _I),
    "uhsdr_fm_mod_tile": ([], _I),
    "uhsdr_fm_mod_stages": ([], _I),
    "uhsdr_fm_mod_threads": ([], _I),
    "uhsdr_fm_mod_table": ([], _I),
    "uhsdr_fm_mod_max_lanes": ([], _I),
}, extra_flags=("-fmad=false",))

# as `kernels/fm_mod.cu` defines them: the DDS table's entries (acc >> 6
# of a 16-bit accumulator) and the most channel lanes of a walker warp;
# the ring's layout is `cuda/ring.py`'s
TABLE = 1024
MAX_LANES = 32
# the accumulator's loop-carried chain a sample, in dependent FP32
# operations: acc + r, floor, s / 65536, floor, 65536 x, s - 65536 x
FM_MOD_STEP_CHAIN = 6


class FmModGeometry(NamedTuple):
    """The kernel's launch (`kernels/fm_mod.cu`)."""
    lanes: int       # channel lanes of each walker warp
    channels: int    # channels a block: ring.WALKERS * lanes
    blocks: int      # the grid
    tiles: int       # tiles of ring.TILE samples a block walks
    smem: int        # dynamic shared memory, bytes


def fm_mod_geometry(C: int, T: int, add: bool = False,
                    sms: int = ring.SMS) -> FmModGeometry:
    """The launch for C channels of T samples (`add`: with the subtone
    plane): the fewest channel lanes a walker warp that puts the channels
    in at most `sms` blocks, so that every SM runs a block and each of its
    four schedulers one walker; past MAX_LANES (C > 128 sms) the blocks
    run several an SM.  A stage of the ring holds a (TILE + 4)-float row
    of x a channel (and one of the subtone plane); the (sin, -cos) table,
    TABLE float2, follows the ring.  Raises ValueError for an empty
    launch."""
    if C < 1 or T < 1 or sms < 1:
        raise ValueError(f"fm_mod: {C} channels of {T} samples on {sms} "
                         "SMs")
    lanes = min(MAX_LANES, -(-C // (ring.WALKERS * sms)))
    cb = ring.WALKERS * lanes
    stage = (2 if add else 1) * cb * (ring.TILE + 4)
    smem = (ring.STAGES * stage + 2 * TABLE) * 4
    return FmModGeometry(lanes, cb, -(-C // cb), -(-T // ring.TILE), smem)


def _lib():
    """The kernel's library, its layout checked against `cuda/ring.py`'s
    and its table and lanes against this module's."""
    lib = ring.checked_lib(FM_MOD, "fm_mod")
    got = (lib.uhsdr_fm_mod_table(), lib.uhsdr_fm_mod_max_lanes())
    if got != (TABLE, MAX_LANES):
        raise RuntimeError(f"fm_mod.cu's table and lanes {got} differ "
                           f"from {(TABLE, MAX_LANES)}")
    return lib


_PH_STEP = np.float32(2.0 * np.pi / 65536.0)


@functools.lru_cache(maxsize=None)
def _table(device: str) -> torch.Tensor:
    k64 = torch.arange(TABLE, dtype=torch.float32, device=device) * 64.0
    ph = k64 * float(_PH_STEP)
    return torch.stack([torch.sin(ph), -torch.cos(ph)]).contiguous()


def fm_table(device) -> torch.Tensor:
    """(2, 1024) f32 [sin; -cos] of the 10-bit grid, made on `device` from
    the JAX package's f32 expressions (ph = (k 64) f32(2 pi / 65536)):
    the firmware's DDS table, i = DDS[idx], q = DDS[idx + 3N/4]."""
    return _table(str(torch.device(device)))


def fm_mod_plain(x, add, a, b, acc, alpha: float, word: float, scale: float,
                 amp: float, swap: bool):
    """Plain torch version of the kernel.  x: (C, T) f32 audio; add: (C,
    T) f32 added to the pre-emphasized audio, or None; a, b: (C,) f32 the
    pre-emphasis state; acc: (C,) int32 the accumulator.  Returns (i, q,
    a, b, acc), i and q (C, T) f32."""
    table = fm_table(x.device)
    cpu = x.device.type == "cpu"
    alpha, word, scale, inv, two16 = steps.consts(
        (alpha, word, scale, 1.0 / 65536.0, 65536.0), cpu)
    floor = np.floor if cpu else torch.floor

    def pre_step(carry, xs):
        bv, av = carry
        (xn,) = xs
        bv = alpha * ((bv + xn) - av)
        return (bv, xn), (bv,)

    def acc_step(carry, xs):
        (av,) = carry
        (rn,) = xs
        s = floor(av + rn)
        av = s - two16 * floor(s * inv)
        return (av,), (av,)

    (bv, _), (pre,) = steps.scan(pre_step, (b, a), (x,))
    if add is not None:
        pre = pre + add
    _, (accs,) = steps.scan(acc_step, (acc.to(torch.float32),),
                            (word + pre * scale,))
    nan = torch.isnan(accs)
    k = torch.floor(torch.where(nan, 0.0, accs) * (1.0 / 64.0)).long()
    i_s = torch.where(nan, math.nan, table[0][k])
    q_s = torch.where(nan, math.nan, table[1][k])
    if swap:
        i_s, q_s = q_s, i_s
    last = accs[:, -1]
    acc_out = torch.where(torch.isnan(last), 0.0, last).to(torch.int32)
    return (i_s * amp, q_s * amp, x[:, -1].clone(), bv, acc_out)


def fm_mod(x, add, a, b, acc, alpha: float, word: float, scale: float,
           amp: float, swap: bool):
    """The table-mode modulator over one block (the kernel on CUDA tensors,
    the plain version on CPU ones); arguments and results as
    `fm_mod_plain`'s."""
    if x.device.type == "cpu":
        return fm_mod_plain(x, add, a, b, acc, alpha, word, scale, amp, swap)
    dev = x.device
    if x.ndim != 2 or x.shape[-1] < 1:
        raise ValueError("fm_mod: x must be (C, T), T >= 1")
    C, T = x.shape
    if add is not None and (add.shape != x.shape
                            or add.dtype != torch.float32):
        raise ValueError("fm_mod: add must be (C, T) f32 like x")
    if (x.dtype != torch.float32 or a.dtype != torch.float32
            or b.dtype != torch.float32 or acc.dtype != torch.int32):
        raise ValueError("fm_mod: f32 audio and state, an int32 "
                         "accumulator")
    if any(t.shape != (C,) for t in (a, b, acc)):
        raise ValueError("fm_mod: state leaves (C,)")
    ts = [x, a, b, acc] + ([] if add is None else [add])
    if any(t.device != dev or not t.is_contiguous() for t in ts):
        raise ValueError("fm_mod: contiguous tensors on one device")
    geo = fm_mod_geometry(C, T, add is not None, sm_count(dev.index))
    table = fm_table(dev)
    i = torch.empty_like(x)
    q = torch.empty_like(x)
    a_out, b_out = torch.empty_like(a), torch.empty_like(b)
    acc_out = torch.empty_like(acc)
    vec = int(T % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ts))
    err = _lib().uhsdr_fm_mod_launch(
        x.data_ptr(), None if add is None else add.data_ptr(), a.data_ptr(),
        b.data_ptr(), acc.data_ptr(), table.data_ptr(), C, T, geo.lanes, vec,
        alpha, word, scale, amp, 1 if swap else 0, i.data_ptr(),
        q.data_ptr(), a_out.data_ptr(), b_out.data_ptr(), acc_out.data_ptr(),
        stream_ptr(dev))
    FM_MOD.check(err)
    FM_MOD.launches += 1
    return i, q, a_out, b_out, acc_out
