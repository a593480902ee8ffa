"""The LPC impulse noise blanker: wrapper around the hand-written kernel
`kernels/blanker.cu`, beside its plain torch version.

A helper kernel with no TPU counterpart: the JAX package runs the frames
of a block as a `lax.scan` of array operations (uhsdr_tpu/nr/
blanker.py:229-255).  On the card a torch loop would cost hundreds of
small launches a frame, 16 frames a block, so the whole of
`nr.blanker.process_block` is one kernel, two lanes a channel; its
launch rule is `blanker_geometry`.  The wrapper takes the plain version
only for tensors on the CPU; for CUDA tensors it checks its arguments,
launches the kernel on the current stream (building it on first use),
raises if the launch failed and adds one to ``BLANKER.launches``.  There
is no fallback.

The sums over a frame (the autocorrelation, the mean and the variance)
are each virtual lane's left fold of four terms and a pairwise tree over
32 virtual lanes (`trees.lane_sum`); the short dot products (the LPC
power, Levinson's sums, the whitening filters and the repair
predictions) are left folds in the reference's index order.  The plain
version spells these out, so kernel and plain version agree bit for bit;
the kernel is built with -fmad=false.  The reference's arithmetic blends
are kept as blends (a repair slot with no impulse still forms its
prediction at position 10 and adds 0 times it, which is NaN where the
prediction is not finite).  The kernel runs only the slots whose blends
can change a bit: the found ones and two empty ones (`kernels/
blanker.cu` says why the rest change nothing).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .build import CudaKernel, sm_count, stream_ptr
from .trees import fold, lane_sum

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

BLANKER = CudaKernel("blanker", "blanker.cu", {
    "uhsdr_blanker_launch": ([_P, _P, _I, _I, _I, _F, _P, _P, _P], _I),
    "uhsdr_blanker_lanes": ([], _I),
    "uhsdr_blanker_warps": ([], _I),
    "uhsdr_blanker_max_cpw": ([], _I),
    "uhsdr_blanker_smem": ([_I], _I),
}, extra_flags=("-fmad=false",))

FRAME = 128          # the reference's NR_FFT_SIZE
ORDER = 10           # LPC order
IMPULSE_LEN = 7      # repaired samples per impulse (odd)
PL = (IMPULSE_LEN - 1) // 2
MAX_IMPULSES = 5
CONTEXT = 2 * ORDER + 2 * PL   # carried history (26)
WB = CONTEXT + FRAME           # working-buffer length (154)
DELAY = ORDER + PL             # output delay in samples (13)
LANES = 32                     # the sums' virtual lanes (`lane_sum`)

# the kernel's layout (`kernels/blanker.cu`): lanes a channel, warps a
# block (one a scheduler), channels a warp at most, and a channel's
# shared-memory rows (strides 1 mod 32): two working buffers (this frame's
# and the next's), the whitened frame and |d| with PL zeros each side
KERNEL_LANES = 2
WARPS = 4
MAX_CPW = 32 // KERNEL_LANES
ROW_FLOATS = 2 * 161 + 129 + 161
# the SMs of an H100 SXM, the rule's default
SMS = 132


class BlankerGeometry(NamedTuple):
    """The kernel's launch (`kernels/blanker.cu`)."""
    cpw: int         # channels a warp (two lanes each)
    channels: int    # channels a block: WARPS * cpw
    blocks: int      # the grid
    frames: int      # frames a channel
    smem: int        # dynamic shared memory, bytes


def blanker_geometry(C: int, T: int, sms: int = SMS) -> BlankerGeometry:
    """The launch for C channels of T samples: the fewest channels a warp
    that puts the C channels in at most `sms` blocks of WARPS warps, so
    that every scheduler runs a warp before any runs two; past MAX_CPW (C
    > 64 sms) the blocks run in waves.  Raises ValueError for what the
    kernel does not take (T a positive multiple of FRAME)."""
    if C < 1 or sms < 1:
        raise ValueError(f"blanker: {C} channels on {sms} SMs")
    if T < FRAME or T % FRAME:
        raise ValueError(f"blanker: T = {T} must be a positive multiple of "
                         f"{FRAME}")
    cpw = min(MAX_CPW, -(-C // (WARPS * sms)))
    ch = WARPS * cpw
    return BlankerGeometry(cpw, ch, -(-C // ch), T // FRAME,
                           ch * ROW_FLOATS * 4)


def _lib(cpw: int):
    """The library, its layout checked against this module's once, and
    its shared memory for `cpw` once each."""
    lib = BLANKER.lib()
    if not getattr(lib, "layout_checked", False):
        got = (lib.uhsdr_blanker_lanes(), lib.uhsdr_blanker_warps(),
               lib.uhsdr_blanker_max_cpw())
        want = (KERNEL_LANES, WARPS, MAX_CPW)
        if got != want:
            raise RuntimeError(f"blanker.cu's layout {got} differs from "
                               f"cuda/blanker.py's {want}")
        lib.layout_checked = set()
    if cpw not in lib.layout_checked:
        got, want = lib.uhsdr_blanker_smem(cpw), WARPS * cpw * ROW_FLOATS * 4
        if got != want:
            raise RuntimeError(f"blanker.cu's shared memory {got} differs "
                               f"from cuda/blanker.py's {want}")
        lib.layout_checked.add(cpw)
    return lib


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """x delayed by k samples along the last axis, zeros shifted in."""
    if k == 0:
        return x
    z = torch.zeros(x.shape[:-1] + (k,), dtype=x.dtype, device=x.device)
    return torch.cat([z, x[..., :x.shape[-1] - k]], dim=-1)


def _fir(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """y[n] = sum_k h[:, k] x[n - k], zero history, from a zero sum."""
    y = torch.zeros_like(x)
    for k in range(h.shape[-1]):
        y = y + h[:, k:k + 1] * _shift(x, k)
    return y


def _levinson(R: torch.Tensor) -> torch.Tensor:
    """Levinson-Durbin (audio_nr.c:2393-2421) on R (C, ORDER + 1) ->
    the prediction-error filter (C, ORDER + 1), e[:, 0] == 1."""
    a = [torch.ones_like(R[:, 0])] + [torch.zeros_like(R[:, 0])
                                      for _ in range(ORDER)]
    # the reference's 1e-9 loading of R[0]: 1 + 1e-9 is 1.0 in f32
    alfa = R[:, 0] * (1.0 + 1e-9)
    for m in range(1, ORDER + 1):
        s = R[:, m]
        for i in range(1, m):
            s = s + a[i] * R[:, m - i]
        k = -s / torch.clamp_min(alfa, 1e-30)
        a = ([a[0]] + [a[i] + k * a[m - i] for i in range(1, m)] + [k]
             + a[m + 1:])
        alfa = alfa * (1.0 - k * k)
    return torch.stack(a, dim=-1)


def _predict(ctx: torch.Tensor, af: torch.Tensor, backward: bool):
    """The 7-step forward (from the 10 samples before) or backward (from
    the 10 after) order-10 prediction of a repair window."""
    out = []
    for _ in range(IMPULSE_LEN):
        c = ctx if backward else ctx.flip(-1)
        nxt = fold(c * af)
        ctx = (torch.cat([nxt[:, None], ctx[:, :-1]], dim=-1) if backward
               else torch.cat([ctx[:, 1:], nxt[:, None]], dim=-1))
        out.append(nxt)
    if backward:
        out = out[::-1]
    return torch.stack(out, dim=-1)


def _process_frame(mult: float, buf: torch.Tensor) -> torch.Tensor:
    """One frame of the blanker on the working buffer (C, WB): the
    carried context ++ the new frame.  Returns the repaired buffer."""
    C, dev = buf.shape[0], buf.device
    seg = buf[:, DELAY:DELAY + FRAME]
    R = []
    for i in range(ORDER + 1):
        # R[i] = sum_n seg[n] seg[n + i], the 128 - i terms and i zeros
        p = torch.cat([seg[:, :FRAME - i] * seg[:, i:],
                       torch.zeros((C, i), device=dev)], dim=-1)
        R.append(lane_sum(p, LANES))
    e = _levinson(torch.stack(R, dim=-1))
    # whiten, then the matched filter: the detection signal
    x = buf[:, DELAY:DELAY + FRAME]
    tmp = _fir(_fir(x, e.flip(-1)), e)
    mean = lane_sum(tmp, LANES) * (1.0 / FRAME)
    dev_ = tmp - mean[:, None]
    sigma2 = lane_sum(dev_ * dev_, LANES) / torch.full_like(mean, FRAME - 1)
    lpc_power = fold(e[:, :ORDER] * e[:, :ORDER])
    thr = mult * torch.sqrt(torch.clamp_min(sigma2 * lpc_power, 1e-30))
    a = tmp.abs()
    m = a
    for s in range(1, PL + 1):
        left = _shift(a, s)
        right = torch.cat([a[:, s:], torch.zeros((C, s), device=dev)], -1)
        m = torch.maximum(m, torch.maximum(left, right))
    pos = torch.arange(FRAME, device=dev)
    cand = (a > thr[:, None]) & (a >= m) & (pos >= DELAY)
    rank = torch.cumsum(cand.to(torch.int32), dim=-1) - 1
    af = -e[:, 1:]
    w_bwd = (torch.arange(IMPULSE_LEN, dtype=torch.float32, device=dev)
             / torch.full((), float(IMPULSE_LEN - 1), device=dev))
    wpos = torch.arange(WB, device=dev)
    out = buf
    for k in range(MAX_IMPULSES):
        hit = cand & (rank == k)
        ok = hit.any(dim=-1)
        st = torch.where(ok, hit.to(torch.int32).argmax(dim=-1), ORDER)
        idx = st[:, None] + torch.arange(ORDER, device=dev)
        fwd = _predict(torch.gather(out, 1, idx - ORDER), af, False)
        bwd = _predict(torch.gather(out, 1, idx + IMPULSE_LEN), af, True)
        rep = (1.0 - w_bwd) * fwd + w_bwd * bwd
        win = (wpos >= st[:, None]) & (wpos < st[:, None] + IMPULSE_LEN)
        okf = ok.to(torch.float32)[:, None]
        rep_at = torch.gather(rep, 1, (wpos - st[:, None]).clamp(
            0, IMPULSE_LEN - 1))
        mask = torch.where(win, okf, 0.0)
        vals = torch.where(win, okf * rep_at, 0.0)
        out = out * (1.0 - mask) + vals
    return out


def blanker_plain(mult: float, ctx: torch.Tensor, x: torch.Tensor):
    """Plain torch version of the kernel: `nr.blanker.process_block`.
    mult: the threshold multiple (16 - nb_setting) / 2, an f32 value;
    ctx: (C, CONTEXT) the repaired tail carried from the last frame; x:
    (C, T), T % 128 == 0.  Returns (y (C, T), delayed 13 samples; the new
    context (C, CONTEXT))."""
    outs = []
    for f in range(x.shape[-1] // FRAME):
        buf = torch.cat([ctx, x[:, f * FRAME:(f + 1) * FRAME]], dim=-1)
        fixed = _process_frame(mult, buf)
        outs.append(fixed[:, DELAY:DELAY + FRAME])
        ctx = fixed[:, FRAME:]
    return torch.cat(outs, dim=-1), ctx.contiguous()


def _candidates(mult: float, buf: torch.Tensor) -> torch.Tensor:
    """The candidate positions (C, FRAME) bool of one frame of the plain
    version on its working buffer (C, WB): `_process_frame`'s detection,
    step for step."""
    C, dev = buf.shape[0], buf.device
    seg = buf[:, DELAY:DELAY + FRAME]
    R = []
    for i in range(ORDER + 1):
        p = torch.cat([seg[:, :FRAME - i] * seg[:, i:],
                       torch.zeros((C, i), device=dev)], dim=-1)
        R.append(lane_sum(p, LANES))
    e = _levinson(torch.stack(R, dim=-1))
    tmp = _fir(_fir(seg, e.flip(-1)), e)
    mean = lane_sum(tmp, LANES) * (1.0 / FRAME)
    dev_ = tmp - mean[:, None]
    sigma2 = lane_sum(dev_ * dev_, LANES) / torch.full_like(mean, FRAME - 1)
    lpc_power = fold(e[:, :ORDER] * e[:, :ORDER])
    thr = mult * torch.sqrt(torch.clamp_min(sigma2 * lpc_power, 1e-30))
    a = tmp.abs()
    m = a
    for s in range(1, PL + 1):
        right = torch.cat([a[:, s:], torch.zeros((C, s), device=dev)], -1)
        m = torch.maximum(m, torch.maximum(_shift(a, s), right))
    pos = torch.arange(FRAME, device=dev)
    return (a > thr[:, None]) & (a >= m) & (pos >= DELAY)


def candidates(mult: float, ctx: torch.Tensor, x: torch.Tensor):
    """The impulse candidates of each frame (C, T // FRAME) int64, before
    the cap of MAX_IMPULSES, as the plain version finds them (its contexts
    carried).  A frame's slots the kernel runs: min(found + 2, 5)."""
    counts = []
    for f in range(x.shape[-1] // FRAME):
        buf = torch.cat([ctx, x[:, f * FRAME:(f + 1) * FRAME]], dim=-1)
        counts.append(_candidates(mult, buf).sum(-1))
        ctx = _process_frame(mult, buf)[:, FRAME:]
    return torch.stack(counts, dim=-1)


def blanker(mult: float, ctx: torch.Tensor, x: torch.Tensor):
    """The noise blanker over one block (the kernel on CUDA tensors, the
    plain version on CPU ones); arguments and results as
    `blanker_plain`'s."""
    if x.device.type == "cpu":
        return blanker_plain(mult, ctx, x)
    dev = x.device
    if x.ndim != 2:
        raise ValueError("blanker: x must be (C, T)")
    C, T = x.shape
    geo = blanker_geometry(C, T, sm_count(dev.index))
    if ctx.shape != (C, CONTEXT):
        raise ValueError(f"blanker: the context must be (C, {CONTEXT})")
    if any(t.dtype != torch.float32 or t.device != dev
           or not t.is_contiguous() for t in (ctx, x)):
        raise ValueError("blanker: contiguous f32 tensors on one device")
    y = torch.empty_like(x)
    ctx_out = torch.empty_like(ctx)
    err = _lib(geo.cpw).uhsdr_blanker_launch(
        x.data_ptr(), ctx.data_ptr(), C, T, geo.cpw, mult, y.data_ptr(),
        ctx_out.data_ptr(), stream_ptr(dev))
    BLANKER.check(err)
    BLANKER.launches += 1
    return y, ctx_out
