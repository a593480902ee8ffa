"""IIR lattice ARMA filter: wrapper around the hand-written kernel
`kernels/lattice.cu`, beside its plain torch version.

A helper kernel with no TPU counterpart: the JAX package runs the CMSIS
`arm_iir_lattice_f32` recurrence as a `lax.scan` over time
(uhsdr_tpu/ops/lattice.py:33-72), and on the card a torch loop over a
block's samples would cost some sixty launches a sample.  The kernel
walks a row a lane with the N-stage state in registers, on the tile ring
of `kernels/ring.cuh` (front, walker and output warps); its launch rule
is `lattice_geometry`.  The wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it checks its arguments, launches the
kernel on the current stream (building it on first use), raises if the
launch failed and adds one to ``LATTICE.launches``.  There is no
fallback.  The kernel is built with -fmad=false and repeats the plain
version's operations on every element, in a wavefront order over blocks
of eight samples that keeps each operation's operands: bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..ops import steps
from . import ring
from .build import CudaKernel, sm_count, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int

LATTICE = CudaKernel("lattice", "lattice.cu", {
    "uhsdr_lattice_launch": ([_P, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P,
                              _P], _I),
    "uhsdr_lattice_max_stages": ([], _I),
    "uhsdr_lattice_max_lanes": ([], _I),
    "uhsdr_lattice_smem": ([_I], _I),
    "uhsdr_lattice_walkers": ([], _I),
    "uhsdr_lattice_tile": ([], _I),
    "uhsdr_lattice_stages": ([], _I),
    "uhsdr_lattice_threads": ([], _I),
}, extra_flags=("-fmad=false",))

# as `kernels/lattice.cu` defines them: the most stages a launch takes
# (the imported tables have 6, 8, 10 or 11) and the most row lanes of a
# walker warp; the ring's layout is `cuda/ring.py`'s
MAX_STAGES = 12
MAX_LANES = 32
# the loop-carried chain of a sample, in dependent FP32 operations: stage
# m's f -> gn[m] (a multiply, an add) -> the next sample's pk[m-1] * g
# (a multiply) -> its f of stage m-1 (an add) -> its f of stage m (an add)
LATTICE_STEP_CHAIN = 5


class LatticeGeometry(NamedTuple):
    """The kernel's launch (`kernels/lattice.cu`)."""
    lanes: int       # row lanes of each walker warp
    rows: int        # rows a block: ring.WALKERS * lanes
    blocks: int      # the grid
    tiles: int       # tiles of ring.TILE samples a block walks
    smem: int        # dynamic shared memory, bytes


def lattice_geometry(C: int, T: int, N: int,
                     sms: int = ring.SMS) -> LatticeGeometry:
    """The launch for C rows of T samples through N stages: the fewest row
    lanes a walker warp that puts the C rows in at most `sms` blocks, so
    that every SM runs a block and each of its four schedulers one walker
    (a walker's time a sample is its issue, whatever its lanes); past
    MAX_LANES (C > 128 sms) the blocks run several an SM.  A stage of the
    ring holds a (TILE + 4)-float row a row.  Raises ValueError for what
    the kernel does not take."""
    if not (1 <= N <= MAX_STAGES):
        raise ValueError(f"lattice: {N} stages, the kernel takes 1 to "
                         f"{MAX_STAGES}")
    if C < 1 or T < 1 or sms < 1:
        raise ValueError(f"lattice: {C} rows of {T} samples on {sms} SMs")
    lanes = min(MAX_LANES, -(-C // (ring.WALKERS * sms)))
    rows = ring.WALKERS * lanes
    smem = ring.STAGES * rows * (ring.TILE + 4) * 4
    return LatticeGeometry(lanes, rows, -(-C // rows),
                           -(-T // ring.TILE), smem)


def _lib():
    """The kernel's library, its layout checked against `cuda/ring.py`'s
    and its limits against this module's."""
    lib = ring.checked_lib(LATTICE, "lattice")
    got = (lib.uhsdr_lattice_max_stages(), lib.uhsdr_lattice_max_lanes())
    if got != (MAX_STAGES, MAX_LANES):
        raise RuntimeError(f"lattice.cu's limits {got} differ from "
                           f"{(MAX_STAGES, MAX_LANES)}")
    return lib


def coefs(pk, pv) -> tuple[np.ndarray, np.ndarray]:
    """pk (N,) and pv (N+1,) as contiguous f32 arrays."""
    pk = np.ascontiguousarray(np.asarray(pk, np.float32).reshape(-1))
    pv = np.ascontiguousarray(np.asarray(pv, np.float32).reshape(-1))
    if pv.shape[0] != pk.shape[0] + 1:
        raise ValueError(f"lattice: pk {pk.shape}, pv {pv.shape}")
    return pk, pv


def lattice_plain(pk, pv, state: torch.Tensor, x: torch.Tensor):
    """Plain torch version of the kernel: x (C, T) f32, state (C, N) f32
    -> (y (C, T), new state (C, N)), stepping over time
    (`ops/steps.py::scan`) with the stages unrolled in the reference's
    order."""
    pk, pv = coefs(pk, pv)
    N = pk.shape[0]
    cpu = x.device.type == "cpu"
    k, v = steps.consts(pk, cpu), steps.consts(pv, cpu)
    zero = steps.consts((0.0,), cpu)[0]

    def step(g, xs):
        (xn,) = xs
        f = xn
        acc = xn * v[N] * zero
        new = []
        for m in range(N):
            f = f - k[m] * g[m]
            gn = f * k[m] + g[m]
            acc = acc + gn * v[m]
            new.append(gn)
        return (*new[1:], f), (acc + f * v[N],)

    g, (y,) = steps.scan(step, tuple(state.unbind(-1)), (x,))
    return y, torch.stack(g, 1)


def lattice(pk, pv, state: torch.Tensor, x: torch.Tensor):
    """The lattice over one block (the kernel on CUDA tensors, the plain
    version on CPU ones).  x: (C, T) f32; state: (C, N) f32; pk (N,) and
    pv (N+1,) (NumPy or sequences).  Returns (y, new_state)."""
    if x.device.type == "cpu":
        return lattice_plain(pk, pv, state, x)
    pk, pv = coefs(pk, pv)
    N = pk.shape[0]
    if x.ndim != 2:
        raise ValueError("lattice: x must be (C, T)")
    C, T = x.shape
    if x.dtype != torch.float32 or state.dtype != torch.float32:
        raise ValueError("lattice: f32 tensors")
    if state.shape != (C, N):
        raise ValueError(f"lattice: state {tuple(state.shape)}, not "
                         f"{(C, N)}")
    if state.device != x.device or not (x.is_contiguous()
                                        and state.is_contiguous()):
        raise ValueError("lattice: contiguous tensors on one device")
    geo = lattice_geometry(C, T, N, sm_count(x.device.index))
    y = torch.empty_like(x)
    new_state = torch.empty_like(state)
    vec = int(T % 4 == 0 and x.data_ptr() % 16 == 0
              and y.data_ptr() % 16 == 0)
    err = _lib().uhsdr_lattice_launch(
        x.data_ptr(), state.data_ptr(), C, T, pk.ctypes.data, pv.ctypes.data,
        N, geo.lanes, vec, y.data_ptr(), new_state.data_ptr(),
        stream_ptr(x.device))
    LATTICE.check(err)
    LATTICE.launches += 1
    return y, new_state
