"""The NLMS and leaky-LMS adaptive filters: wrappers around the
hand-written kernels of `kernels/lms.cu`, beside their plain torch
versions.

Helper kernels with no TPU counterpart: the JAX package runs both as a
`lax.scan` over time (uhsdr_tpu/ops/lms.py:103-151).  On the card a torch
time loop would cost about eight launches a sample, 2048 samples a block,
so each filter is one launch: `nlms` (the auto-notch and the NLMS NR) and
`leaky` (WDSP's variable-leak LMS with its lidx walk), either giving the
error (notch) or the prediction (NR).  The wrappers take the plain
version only for tensors on the CPU; for CUDA tensors they check their
arguments, launch the kernel on the current stream (building it on first
use), raise if the launch failed and add one to ``LMS.launches`` or
``LMS_LEAKY.launches``.  There is no fallback.

The two dot products of a step (w . ref and ref . ref) are the plain
versions' `trees.lane_sum` over LANES virtual lanes: tap j in virtual
lane j % LANES, each virtual lane's left fold of its taps, then a
pairwise tree.  Both filters run on one body (`kernels/lms.cu::
lms_kernel`), which gives a channel 2 or 4 lanes of 8 / lanes virtual
lanes each, folds them in the lane and takes the tree's last levels by
shuffles, and forms ref . ref ahead of the walk: the leaky filter at
LEAKY_LANES lanes from squares staged once a sample (launch rule
`leaky_geometry`), the NLMS filter at NLMS_LANES from the squares of its
window in registers (rule `nlms_geometry`).  Either way the order is the
plain versions', and the kernels are built with -fmad=false: bit for
bit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .build import SMEM_OPT_IN, CudaKernel, sm_count, stream_ptr
from .trees import lane_sum

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

LMS = CudaKernel("lms", "lms.cu", {
    "uhsdr_lms_nlms_launch": ([_I] * 7 + [_P] * 3 + [_F] * 2 + [_P] * 4,
                              _I),
    "uhsdr_lms_leaky_launch": ([_I] * 7 + [_P] * 5 + [_F] * 7 + [_P] * 6,
                               _I),
    "uhsdr_lms_leaky_lanes": ([], _I),
    "uhsdr_lms_leaky_warps": ([], _I),
    "uhsdr_lms_leaky_max_cpw": ([], _I),
    "uhsdr_lms_leaky_group": ([], _I),
    "uhsdr_lms_nlms_lanes": ([], _I),
    "uhsdr_lms_nlms_warps": ([], _I),
    "uhsdr_lms_nlms_group": ([], _I),
    "uhsdr_lms_leaky_tile": ([_I, _I], _I),
    "uhsdr_lms_smem": ([_I] * 4, _I),
    "uhsdr_lms_occupancy": ([_I] * 4, _I),
    "uhsdr_lms_rcp_check": ([_P, _P], _I),
}, extra_flags=("-fmad=false",))
# the leaky kernel's launches, counted apart (one library)
LMS_LEAKY = CudaKernel("lms_leaky", "lms.cu", lib_of=LMS)

# the plain versions' lanes (`trees.lane_sum`; `kernels/lms.cu`'s
# LK_VL) and the taps a virtual lane the kernels are built for
LANES = 8
TAPS_PER_LANE = (8, 12)

# the leaky kernel's layout (`kernels/lms.cu`'s LK_*): lanes a channel,
# warps a block (one a scheduler), channels a warp at most, steps a group
# (one float4 of the window), the tile's unit; and the taps a lane it is
# built for (64 and 96 taps)
LEAKY_LANES = 2
LEAKY_WARPS = 4
LEAKY_MAX_CPW = 32 // LEAKY_LANES
LEAKY_GROUP = 4
LEAKY_TILE = 128
LEAKY_TAPS_PER_LANE = (32, 48)
# the NLMS filter's (`kernels/lms.cu`'s NL_*): lanes a channel, warps a
# block (two a scheduler), channels a warp at most, steps a group (its
# float2 windows are read once a group)
NLMS_LANES = 4
NLMS_WARPS = 8
NLMS_MAX_CPW = 32 // NLMS_LANES
NLMS_GROUP = 8
# the SMs of an H100 SXM, the rule's default
SMS = 132


class LeakyGeometry(NamedTuple):
    """The leaky kernel's launch (`kernels/lms.cu::lms_kernel<P, 2,
    LEAKY>`)."""
    cpw: int         # channels a warp (two lanes each)
    channels: int    # channels a block: LEAKY_WARPS * cpw
    blocks: int      # the grid
    tile: int        # samples a stage holds
    stride: int      # a window row's stride, floats
    smem: int        # dynamic shared memory, bytes


def leaky_tile(L: int, D: int) -> int:
    """The time tile (both filters'): a multiple of 128 that holds the L
    + D - 1 samples a window carries."""
    H = L + D - 1
    return LEAKY_TILE * max(1, -(-H // LEAKY_TILE))


def _smem(L: int, D: int, cpw: int, warps: int, windows: int) -> int:
    """A block's dynamic shared memory: for each of its warps * cpw
    channels `windows` windows (a row of H + tile and 8 more floats,
    rounded to 8 mod 32), the stage (tile) and the outputs (tile + 1)."""
    H, tile = L + D - 1, leaky_tile(L, D)
    stride = -(-(H + tile) // 32) * 32 + 8
    return warps * cpw * (windows * stride + 2 * tile + 1) * 4


def leaky_smem(L: int, D: int, cpw: int) -> int:
    """The leaky kernel's block: the windows of x and of x^2."""
    return _smem(L, D, cpw, LEAKY_WARPS, 2)


def nlms_smem(L: int, D: int, cpw: int) -> int:
    """The NLMS kernel's block: the window of x alone."""
    return _smem(L, D, cpw, NLMS_WARPS, 1)


def leaky_geometry(C: int, T: int, L: int, D: int,
                   sms: int = SMS) -> LeakyGeometry:
    """The leaky kernel's launch for C channels of T samples, L taps and
    delay D: the fewest channels a warp that puts the C channels in at
    most `sms` blocks of LEAKY_WARPS warps, so that every scheduler walks
    a warp before any walks two (a warp's time a step is its issue,
    whatever its channels); past LEAKY_MAX_CPW (C > 64 sms) the blocks
    run in waves.  Raises ValueError for what the kernel does not take."""
    if L % LEAKY_LANES or L // LEAKY_LANES not in LEAKY_TAPS_PER_LANE:
        raise ValueError(f"lms_leaky: {L} taps; the kernel takes "
                         f"{[LEAKY_LANES * p for p in LEAKY_TAPS_PER_LANE]}")
    if D < 1:
        raise ValueError(f"lms_leaky: delay {D}, the kernel takes >= 1")
    if C < 1 or T < 1 or sms < 1:
        raise ValueError(f"lms_leaky: {C} channels of {T} samples on "
                         f"{sms} SMs")
    cpw = min(LEAKY_MAX_CPW, -(-C // (LEAKY_WARPS * sms)))
    while cpw > 1 and leaky_smem(L, D, cpw) > SMEM_OPT_IN:
        cpw -= 1
    smem = leaky_smem(L, D, cpw)
    if smem > SMEM_OPT_IN:
        raise ValueError(f"lms_leaky: delay {D} needs {smem} bytes of "
                         f"shared memory a warp")
    tile = leaky_tile(L, D)
    H = L + D - 1
    ch = LEAKY_WARPS * cpw
    return LeakyGeometry(cpw, ch, -(-C // ch), tile,
                         -(-(H + tile) // 32) * 32 + 8, smem)


class NlmsGeometry(NamedTuple):
    """The NLMS kernel's launch (`kernels/lms.cu::lms_kernel<P, 4, NLMS
    or NLMS_UNIT>`)."""
    cpw: int            # channels a warp (four lanes each)
    channels: int       # channels a block: NLMS_WARPS * cpw
    blocks: int         # the grid, one block an SM at a time
    tile: int           # samples a stage holds
    stride: int         # a window row's stride, floats
    smem: int           # dynamic shared memory, bytes


def nlms_geometry(C: int, T: int, L: int, D: int,
                  sms: int = SMS) -> NlmsGeometry:
    """The NLMS kernel's launch for C channels of T samples, L taps and
    delay D: the fewest channels a warp (at most NLMS_MAX_CPW) that puts
    the C channels in at most `sms` blocks of NLMS_WARPS warps, so that
    every scheduler walks its two warps before any walks more; past that
    the blocks run in waves.  Raises ValueError for what the kernel does
    not take."""
    _check_taps(L)
    if D < 0 or C < 1 or T < 1 or sms < 1:
        raise ValueError(f"lms: {C} channels of {T} samples, delay {D}, "
                         f"on {sms} SMs")
    cpw = min(NLMS_MAX_CPW, -(-C // (NLMS_WARPS * sms)))
    while cpw > 1 and nlms_smem(L, D, cpw) > SMEM_OPT_IN:
        cpw -= 1
    smem = nlms_smem(L, D, cpw)
    if smem > SMEM_OPT_IN:
        raise ValueError(f"lms: delay {D} needs {smem} bytes of shared "
                         f"memory a warp")
    tile = leaky_tile(L, D)
    ch = NLMS_WARPS * cpw
    return NlmsGeometry(cpw, ch, -(-C // ch), tile,
                        -(-(L + D - 1 + tile) // 32) * 32 + 8, smem)


def nlms_ops(L: int, leak: float) -> float:
    """FP32 operations a channel-sample that the NLMS function needs (its
    bound): the dot product's L products and L - 1 sums, err, mu err and
    the division, the norm's one new square a sample, its L - 1 sums and +
    1e-9, the update's L products and L sums, and for a leak other than 1
    its L products: 5L + 3 (6L + 3)."""
    return 5.0 * L + 3.0 + (0.0 if leak == 1.0 else L)


def nlms_issued_ops(L: int, leak: float) -> float:
    """FP32 operations a channel-sample that the NLMS kernel issues: as
    `nlms_ops`, with the norm's new square replaced by the squares of the
    distinct samples of each lane's window a group (NLMS_LANES lanes of
    NLMS_GROUP + 8 / NLMS_LANES - 1 samples a tap row)."""
    hv = LANES // NLMS_LANES
    squares = NLMS_LANES * (NLMS_GROUP + hv - 1) * (L // LANES) / NLMS_GROUP
    return nlms_ops(L, leak) - 1.0 + squares


def leaky_ops(L: int) -> float:
    """FP32 operations a channel-sample that the leaky function needs
    (its bound): the dot product's 2L - 1, sigma's one new square and L -
    1 sums, the update's 3L (two products and a sum a tap) and about 30
    for the step's scalars (the reciprocal, nel, nev, the lidx walk and
    ngamma): 6L + 29."""
    return 6.0 * L + 29.0


def _lib(L: int, D: int, cpw: int, leaky: bool):
    """The library, the kernels' layout checked against this module's
    once, and a filter's tile and shared memory for (L, D, cpw) once
    each."""
    lib = LMS.lib()
    checked = lib.__dict__.setdefault("checked", set())
    if "layout" not in checked:
        got = (lib.uhsdr_lms_leaky_lanes(), lib.uhsdr_lms_leaky_warps(),
               lib.uhsdr_lms_leaky_max_cpw(), lib.uhsdr_lms_leaky_group(),
               lib.uhsdr_lms_nlms_lanes(), lib.uhsdr_lms_nlms_warps(),
               lib.uhsdr_lms_nlms_group())
        want = (LEAKY_LANES, LEAKY_WARPS, LEAKY_MAX_CPW, LEAKY_GROUP,
                NLMS_LANES, NLMS_WARPS, NLMS_GROUP)
        if got != want:
            raise RuntimeError(f"lms.cu's layout {got} differs from "
                               f"cuda/lms.py's {want}")
        checked.add("layout")
    key = (L, D, cpw, leaky)
    if key not in checked:
        got = (lib.uhsdr_lms_leaky_tile(L, D),
               lib.uhsdr_lms_smem(L, D, cpw, int(leaky)))
        want = (leaky_tile(L, D),
                (leaky_smem if leaky else nlms_smem)(L, D, cpw))
        if got != want:
            raise RuntimeError(f"lms.cu's tile and shared memory {got} "
                               f"differ from cuda/lms.py's {want}")
        checked.add(key)
    return lib


def _check_taps(L: int):
    """The NLMS kernel's tap counts (8 virtual lanes of 8 or 12)."""
    if L % LANES or L // LANES not in TAPS_PER_LANE:
        raise ValueError(f"lms: {L} taps; the kernel takes "
                         f"{[LANES * p for p in TAPS_PER_LANE]}")


def nlms_plain(params, w, hist, x):
    """Plain torch version of the NLMS instance (`ops.lms.run`): per
    sample, ref = the delayed window, pred = w . ref, err = x - pred,
    norm = ref . ref + 1e-9, w = leak w + (mu err / norm) ref.  params:
    `ops.lms.LmsParams`; w (C, L); hist (C, L + D); x (C, T).  Returns
    (y (C, T): err or pred, w, hist), the new history its own storage."""
    L, D = params.num_taps, params.delay
    win = torch.cat([hist, x], dim=-1)
    out = []
    for n in range(x.shape[-1]):
        ref = win[:, n + 1:n + 1 + L]
        xn = win[:, n + L + D]
        pred = lane_sum(w * ref, LANES)
        err = xn - pred
        norm = lane_sum(ref * ref, LANES) + 1e-9
        w = params.leak * w + (params.mu * err / norm)[:, None] * ref
        out.append(err if params.output_error else pred)
    return (torch.stack(out, dim=-1), w,
            win[:, win.shape[-1] - (L + D):].clone())


def leaky_plain(params, w, hist, lidx, ngamma, x):
    """Plain torch version of the leaky instance (`ops.lms.leaky_lms_run`,
    audio_driver.c:521-577): the NLMS step with the leakage ngamma driven
    by the nel/nev walk of lidx.  params: `ops.lms.LeakyLmsParams`; w (C,
    L); hist (C, L + D); lidx, ngamma (C,); x (C, T).  Returns (y, w,
    hist, lidx, ngamma)."""
    L, D = params.num_taps, params.delay
    tmu = params.two_mu
    win = torch.cat([hist, x], dim=-1)
    out = []
    for n in range(x.shape[-1]):
        ref = win[:, n + 1:n + 1 + L]
        xn = win[:, n + L + D]
        y = lane_sum(w * ref, LANES)
        sigma = lane_sum(ref * ref, LANES)
        inv_sigp = 1.0 / (sigma + 1e-10)
        err = xn - y
        out.append(err if params.output_error else y)
        nel = (err * (1.0 - tmu * sigma * inv_sigp)).abs()
        nev = (xn - (1.0 - tmu * ngamma) * y
               - tmu * err * sigma * inv_sigp).abs()
        lidx = torch.where(
            nev < nel, torch.clamp_max(lidx + params.lincr, params.lidx_max),
            torch.clamp_min(lidx - params.ldecr, params.lidx_min))
        ngamma = params.gamma * (lidx * lidx) * (lidx * lidx) \
            * params.den_mult
        c0 = 1.0 - tmu * ngamma
        c1 = tmu * err * inv_sigp
        w = c0[:, None] * w + c1[:, None] * ref
    return (torch.stack(out, dim=-1), w,
            win[:, win.shape[-1] - (L + D):].clone(), lidx, ngamma)


def rcp_check(device) -> tuple[int, int]:
    """The leaky kernel's branch-free reciprocal (`kernels/lms.cu::
    rcp_fast`) against div.rn, both on the card, over every f32 of biased
    exponent 1..252 and either sign (one launch, not counted as a leaky
    launch).  Returns (inputs that differ, inputs checked); the first must
    be 0."""
    bad = torch.zeros(2, dtype=torch.int64, device=device)
    LMS.check(LMS.lib().uhsdr_lms_rcp_check(bad.data_ptr(),
                                            stream_ptr(bad.device)))
    return tuple(int(v) for v in bad.cpu())


def _launch(kernel, leaky: bool, params, w, hist, x, lidx=None,
            ngamma=None):
    dev = x.device
    L, D = params.num_taps, params.delay
    if x.ndim != 2 or x.shape[-1] < 1:
        raise ValueError("lms: x must be (C, T), T >= 1")
    C, T = x.shape
    if leaky:
        geo = leaky_geometry(C, T, L, D, sm_count(dev.index))
    else:
        geo = nlms_geometry(C, T, L, D, sm_count(dev.index))
    ts = [w, hist, x] + ([lidx, ngamma] if leaky else [])
    if (w.shape != (C, L) or hist.shape != (C, L + D)
            or (leaky and (lidx.shape != (C,) or ngamma.shape != (C,)))):
        raise ValueError(f"lms: w (C, {L}), hist (C, {L + D})"
                         + (", lidx and ngamma (C,)" if leaky else ""))
    if any(t.dtype != torch.float32 or t.device != dev
           or not t.is_contiguous() for t in ts):
        raise ValueError("lms: contiguous f32 tensors on one device")
    y = torch.empty_like(x)
    w_out = torch.empty_like(w)
    h_out = torch.empty_like(hist)
    oe = int(bool(params.output_error))
    vec = int(T % 4 == 0 and x.data_ptr() % 16 == 0)
    if leaky:
        l_out = torch.empty_like(lidx)
        g_out = torch.empty_like(ngamma)
        err = _lib(L, D, geo.cpw, True).uhsdr_lms_leaky_launch(
            oe, L, D, C, T, geo.cpw, vec, w.data_ptr(), hist.data_ptr(),
            x.data_ptr(), lidx.data_ptr(), ngamma.data_ptr(), params.two_mu,
            params.gamma, params.lidx_min, params.lidx_max, params.den_mult,
            params.lincr, params.ldecr, y.data_ptr(), w_out.data_ptr(),
            h_out.data_ptr(), l_out.data_ptr(), g_out.data_ptr(),
            stream_ptr(dev))
        out = (y, w_out, h_out, l_out, g_out)
    else:
        err = _lib(L, D, geo.cpw, False).uhsdr_lms_nlms_launch(
            oe, L, D, C, T, geo.cpw, vec, w.data_ptr(), hist.data_ptr(),
            x.data_ptr(), params.mu, params.leak,
            y.data_ptr(), w_out.data_ptr(), h_out.data_ptr(),
            stream_ptr(dev))
        out = (y, w_out, h_out)
    LMS.check(err)
    kernel.launches += 1
    return out


def nlms(params, w, hist, x):
    """The NLMS filter over one block (the kernel on CUDA tensors, the
    plain version on CPU ones); arguments and results as
    `nlms_plain`'s."""
    if x.device.type == "cpu":
        return nlms_plain(params, w, hist, x)
    return _launch(LMS, False, params, w, hist, x)


def leaky(params, w, hist, lidx, ngamma, x):
    """The leaky LMS over one block; arguments and results as
    `leaky_plain`'s."""
    if x.device.type == "cpu":
        return leaky_plain(params, w, hist, lidx, ngamma, x)
    return _launch(LMS_LEAKY, True, params, w, hist, x, lidx, ngamma)
