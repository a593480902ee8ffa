"""K3 (the WDSP look-ahead AGC), K13 (its 5-state machine alone) and the
linked stereo AGC stage (K13 with the linked detector, the look-ahead
max, the gain law and the delay line in one launch): wrappers around the
hand-written kernels of `kernels/agc.cu`, each beside its plain torch
version.

The wrapper takes the plain version only for tensors on the CPU.  For
CUDA tensors it checks device, dtype, shape and contiguity, launches the
kernel on the current stream (building it on first use), raises if the
launch failed, and adds one to its kernel's ``launches``.  There is no
fallback.

Replaces uhsdr_tpu/pallas/agc.py::_make_fused_kernel (:159) with
_make_machine_step (:36), entered from ops/agc.py:481; K13 replaces
::_make_kernel (:126), entered through agc_scan_pallas (:376) from
ops/agc.py::_run_machine (the linked stereo AGC), whose whole stage the
port runs as `agc_stereo`.  On this card all three are bound by their
recurrence (T dependent steps per channel), not by their bytes; see the
note in the source.

K3's design has a torch mirror here, run by the CPU tests against the
plain versions: `agc_geometry` (the launcher's tile rule),
`look_ahead_ring` (the front warp's van Herk / Gil-Werman sliding max
over its sample ring), `machine_step_select` (the select-form step K3 and
K13 share) and `agc_design` (the three together with the gain law).

Per-channel gain-law rows (the TPU kernels' `chan` operand): `agc` and
`agc_scan` take ``rows=None`` (the scalar settings of `AgcScalars`) or
an f32 table, (3, C) [min_volts, slope_constant, hang_level] for K3 and
(2, C) [min_volts, hang_level] for K13, whose values replace those
scalars channel by channel.  The row launches are counted apart, as
``AGC_ROWS`` and ``AGC_SCAN_ROWS``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .build import CudaKernel, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

AGC = CudaKernel("agc", "agc.cu", {
    "uhsdr_agc_launch": ([_P, _P, _P, _P, _I, _I, _I] + [_F] * 14
                         + [_P, _P, _P, _P], _I),
    "uhsdr_agc_max_window": ([], _I),
    "uhsdr_agc_smem": ([_I], _I),
    "uhsdr_agc_scan_launch": ([_P, _P, _P, _P, _I, _I] + [_F] * 11
                              + [_P, _P, _P], _I),
    "uhsdr_agc_scan_smem": ([], _I),
    "uhsdr_agc_stereo_launch": ([_P, _P, _P, _P, _I, _I, _I] + [_F] * 14
                                + [_P, _P, _P, _P], _I),
    "uhsdr_agc_stereo_smem": ([_I], _I),
}, extra_flags=("-fmad=false",))
# one source and library, six kernels: K3 (the whole AGC), K13 (the
# machine alone) and the linked stereo stage, each with scalar settings
# and with per-channel rows
AGC_SCAN = CudaKernel("agc_scan", "agc.cu", lib_of=AGC)
AGC_ROWS = CudaKernel("agc_rows", "agc.cu", lib_of=AGC)
AGC_SCAN_ROWS = CudaKernel("agc_scan_rows", "agc.cu", lib_of=AGC)
AGC_STEREO = CudaKernel("agc_stereo", "agc.cu", lib_of=AGC)
AGC_STEREO_ROWS = CudaKernel("agc_stereo_rows", "agc.cu", lib_of=AGC)

N_CARRY = 7   # volts, save_volts, hang_counter, decay_type, state, fba, hba

# K3's tiles (`kernels/agc.cu`): 32 channels a block, time tiles of 32
# steps through 4 stage buffers, a walker warp, a front warp and 4 gain-law
# warps; named barriers 1-12 hand the stages on
AGC_CB = 32
AGC_MAXW = 256
AGC_TILE = 32
AGC_STAGES = 4
AGC_THREADS = 64 + 32 * 4
AGC_BARRIERS = 3 * AGC_STAGES
# K13's and the linked stage's stage planes (K13: rm -> volts, ax; the
# stage: rm -> volts, the delayed L and R), each AGC_CB rows of
# AGC_TILE + 1 floats
AGC_SCAN_PLANES = 2
AGC_STEREO_PLANES = 3
# an SM's shared memory, and what the card reserves of it for each block
SM_SMEM = 228 * 1024
BLOCK_RESERVED = 1024


class AgcScalars(NamedTuple):
    """The AGC's scalar parameters (f32 values as Python floats)."""
    attack_mult: float
    fast_decay_mult: float
    decay_mult: float
    hang_decay_mult: float
    fast_backmult: float
    hang_backmult: float
    pop_ratio: float
    hang_level: float
    hang_time: float
    hang_enable: bool
    min_volts: float
    out_target: float
    slope_constant: float
    inv_max_input: float


N_ROWS_AGC = 3    # K3's rows: min_volts, slope_constant, hang_level
N_ROWS_SCAN = 2   # K13's rows: min_volts, hang_level


def _f32(v: float) -> float:
    return float(np.float32(v))


def machine_step(p: AgcScalars, carry, rm, fb, hb, chan=None):
    """One step of the 5-state machine on (C,) tensors, as the reference's
    masked-arithmetic scan body `_make_xla_step` (ops/agc.py:362-427):
    every branch is a 0/1 mask and the outcomes are blended.  carry =
    (volts, save_volts, hang_counter, decay_type, state).  chan: None, or
    the (C,) tensors (min_volts, hang_level) in place of the scalars."""
    volts, save_volts, hang_counter, decay_type, st = carry
    min_volts, hang_level = ((p.min_volts, p.hang_level) if chan is None
                             else chan)
    hang_en = 1.0 if p.hang_enable else 0.0
    hang_counter = torch.clamp_min(hang_counter - 1.0, 0.0)

    attack_v = volts + (rm - volts) * p.attack_mult
    fast_v = volts + (rm - volts) * p.fast_decay_mult
    long_v = volts + (rm - volts) * p.decay_mult
    hangd_v = volts + (rm - volts) * p.hang_decay_mult

    f = torch.float32
    att = (rm >= volts).to(f)
    natt = 1.0 - att
    is0 = (st < 0.5).to(f)
    is1 = ((st > 0.5) & (st < 1.5)).to(f)
    is2 = ((st > 1.5) & (st < 2.5)).to(f)
    is3 = ((st > 2.5) & (st < 3.5)).to(f)
    is4 = (st > 3.5).to(f)

    ht = hang_en * (hb > hang_level).to(f)
    s0_fast = (volts > p.pop_ratio * fb).to(f)
    s1_fastc = (volts > save_volts).to(f)
    hc_wait = (hang_counter > 0.5).to(f)
    hc_zero = 1.0 - hc_wait
    dt1 = decay_type
    dt0 = 1.0 - dt1

    m0a = is0 * att
    m0f = is0 * natt * s0_fast
    m0h = is0 * natt * (1 - s0_fast) * ht
    m0l = is0 * natt * (1 - s0_fast) * (1 - ht)
    m1a = is1 * att
    m1f = is1 * natt * s1_fastc
    m1w = is1 * natt * (1 - s1_fastc) * hc_wait
    m1l = is1 * natt * (1 - s1_fastc) * hc_zero * dt0
    m1h = is1 * natt * (1 - s1_fastc) * hc_zero * dt1
    m2a = is2 * att
    m2d = is2 * natt * hc_zero
    m2s = is2 * natt * hc_wait
    m3a = is3 * att
    m3d = is3 * natt
    m4a = is4 * att
    m4d = is4 * natt

    new_volts = ((m0a + m1a + m2a + m3a + m4a) * attack_v
                 + (m0f + m1f) * fast_v
                 + (m0l + m1l + m3d) * long_v
                 + (m1h + m2d + m4d) * hangd_v
                 + (m0h + m1w + m2s) * volts)
    new_state = ((m0f + m1f) * 1.0 + (m0h + m1w + m2s) * 2.0
                 + (m0l + m1l + m3d) * 3.0 + (m1h + m2d + m4d) * 4.0)
    save_upd = m2a + m3a + m4a
    new_save = save_upd * volts + (1.0 - save_upd) * save_volts
    new_hang = m0h * p.hang_time + (1.0 - m0h) * hang_counter
    new_decay = m0h * 1.0 + (1.0 - (m0h + m0l)) * decay_type
    new_volts = (torch.clamp_min(new_volts, min_volts) if chan is None
                 else torch.maximum(new_volts, min_volts))
    return new_volts, new_save, new_hang, new_decay, new_state


def look_ahead_max(a: torch.Tensor, w: int, T: int) -> torch.Tensor:
    """rm[..., n] = max a[..., n+1 .. n+w] for n < T, over a (..., w+T)
    detector series (|x| of the delay line and the block)."""
    return a[..., 1:].unfold(-1, w, 1).amax(-1)[..., :T]


def agc_scan_plain(p: AgcScalars, carry, rm, ax, rows=None):
    """Plain torch version of K13: per step the back-averages of `ax`
    update, then `machine_step` on `rm`, in a time loop.  carry (7, C);
    rm, ax (C, T); rows None or (2, C) [min_volts, hang_level].  Returns
    (volts (C, T), new_carry (7, C))."""
    a_f = _f32(np.float32(1.0) - np.float32(p.fast_backmult))
    a_h = _f32(np.float32(1.0) - np.float32(p.hang_backmult))
    volts, save, hang, decay, st, fba, hba = carry.unbind(0)
    chan = None if rows is None else (rows[0], rows[1])
    mc = (volts, save, hang, decay, st)
    vs = []
    for n in range(rm.shape[-1]):
        fba = a_f * fba + p.fast_backmult * ax[:, n]
        hba = a_h * hba + p.hang_backmult * ax[:, n]
        mc = machine_step(p, mc, rm[:, n], fba, hba, chan)
        vs.append(mc[0])
    return torch.stack(vs, dim=-1), torch.stack(list(mc) + [fba, hba], dim=0)


def gain_law(p: AgcScalars, v: torch.Tensor, slope=None) -> torch.Tensor:
    """The log-domain gain (out_target - slope*min(log10(v/max_in), 0))
    / v of the (C, T) volts series; slope None (the scalar) or a (C,)
    tensor."""
    vo = torch.clamp_max(torch.log10(p.inv_max_input * v), 0.0)
    slope = p.slope_constant if slope is None else slope[:, None]
    return (p.out_target - slope * vo) / v


def agc_stereo_plain(p: AgcScalars, carry, delay, x, rows=None):
    """Plain torch version of the linked stereo AGC stage: the route the
    reference runs around K13 (ops/agc.py::run_stereo): the delay line,
    the linked detector max(|L|, |R|), its look-ahead max, the machine
    walk of `agc_scan_plain`, the gain law on both delayed planes.  carry
    (7, C); delay (C, 2, w); x (C, 2, T); rows None or (3, C) [min_volts,
    slope_constant, hang_level].  Returns (y (C, 2, T), new_carry (7, C),
    new_delay (C, 2, w), a tensor of its own)."""
    T = x.shape[-1]
    w = delay.shape[-1]
    xfull = torch.cat([delay, x], dim=-1)               # (C, 2, w+T)
    a = xfull.abs().amax(dim=-2)                        # linked detector
    v, new_carry = agc_scan_plain(
        p, carry, look_ahead_max(a, w, T).contiguous(),
        a[:, :T].contiguous(), None if rows is None else rows[0::2])
    gain = gain_law(p, v, None if rows is None else rows[1])
    y = xfull[..., :T] * gain[:, None, :]
    return y, new_carry, xfull[..., xfull.shape[-1] - w:].clone()


def agc_plain(p: AgcScalars, carry, delay, x, rows=None):
    """Plain torch version of K3: the delay line, the look-ahead max, the
    machine walk of `agc_scan_plain`, then the gain law.  carry (7, C);
    delay (C, w); x (C, T); rows None or (3, C) [min_volts,
    slope_constant, hang_level].  Returns (y (C, T), new_carry (7, C),
    new_delay (C, w))."""
    T = x.shape[-1]
    w = delay.shape[-1]
    xfull = torch.cat([delay, x], dim=-1)
    a = xfull.abs()
    v, new_carry = agc_scan_plain(
        p, carry, look_ahead_max(a, w, T), a[:, :T],
        None if rows is None else rows[0::2])
    y = xfull[:, :T] * gain_law(p, v, None if rows is None else rows[1])
    return y, new_carry, xfull[:, xfull.shape[-1] - w:].clone()


class AgcGeometry(NamedTuple):
    """K3's, K13's or the linked stage's tiles for one launch
    (`kernels/agc.cu::geometry`, `scan_smem`, `stereo_geometry`)."""
    tile: int         # time steps a stage buffer holds
    stages: int       # stage buffers in the ring
    threads: int      # a block's: walker, front and gain-law warps
    ring: int         # slots of a channel's sample ring (w rounded up to
                      # the tile, and 3 tiles)
    ring_stride: int  # its row stride, floats (odd)
    h_stride: int     # the segment-suffix maxima's row stride (odd)
    smem: int         # dynamic shared memory, bytes
    grid: int         # blocks of AGC_CB channels
    tiles: int        # time tiles a block walks
    sm_blocks: int    # blocks an SM's shared memory holds (the kernels'
                      # launch bound asks the registers for two)


def agc_geometry(C: int, T: int, w: int, rows: bool = False) -> AgcGeometry:
    """K3's geometry for C channels of T steps at look-ahead w (the
    launcher's rule; rows change nothing: a gain-law thread keeps its
    slopes in registers).  Raises ValueError outside 1 <= w <= 256."""
    if not (1 <= w <= AGC_MAXW and T >= 1 and C >= 1):
        raise ValueError(f"agc: look-ahead {w} outside the kernel's "
                         f"1..{AGC_MAXW}, or an empty block")
    ring = -(-w // AGC_TILE) * AGC_TILE + 3 * AGC_TILE
    rs, hs = ring | 1, w | 1
    smem = 4 * (AGC_STAGES * AGC_CB * (AGC_TILE + 1) * 2 + AGC_CB * rs
                + AGC_CB * hs)
    return _geometry(C, T, ring, rs, hs, smem)


def _geometry(C, T, ring, rs, hs, smem) -> AgcGeometry:
    return AgcGeometry(AGC_TILE, AGC_STAGES, AGC_THREADS, ring, rs, hs, smem,
                       -(-C // AGC_CB), -(-T // AGC_TILE),
                       SM_SMEM // (smem + BLOCK_RESERVED))


def agc_scan_geometry(C: int, T: int) -> AgcGeometry:
    """K13's geometry for C channels of T steps: K3's warps and stage
    ring, the stage two planes (rm, then the volts over it, and ax) and
    no sample ring.  Raises ValueError for an empty block."""
    if not (T >= 1 and C >= 1):
        raise ValueError(f"agc_scan: {C} x {T}, an empty block")
    smem = 4 * AGC_STAGES * AGC_SCAN_PLANES * AGC_CB * (AGC_TILE + 1)
    return _geometry(C, T, 0, 0, 0, smem)


def agc_stereo_geometry(C: int, T: int, w: int,
                        rows: bool = False) -> AgcGeometry:
    """The linked stage's geometry for C channels of T steps at look-ahead
    w: K3's, with the stage three planes (rm then volts, the delayed L and
    R) and the sample ring two (L and R); two blocks an SM up to w = 96
    (98,176 B at 48, 112,512 B at 96), one at 192.  Rows change nothing.
    Raises ValueError outside 1 <= w <= 256."""
    g = agc_geometry(C, T, w, rows)
    smem = 4 * (AGC_STAGES * AGC_STEREO_PLANES * AGC_CB * (AGC_TILE + 1)
                + 2 * AGC_CB * g.ring_stride + AGC_CB * g.h_stride)
    return _geometry(C, T, g.ring, g.ring_stride, g.h_stride, smem)


def look_ahead_ring(delay: torch.Tensor, x: torch.Tensor,
                    tile: int = AGC_TILE):
    """K3's front warp in torch, tile for tile: a ring of R = w rounded up
    to the tile and 3 tiles more, xfull[m] in slot (m - w) mod R, tiles 0
    and 1 in it before the first, tile j+2 as tile j starts; xfull is cut into segments of w samples (the delay line is the
    first); G, the max from the segment's start, runs along; when a
    segment is complete, a backward pass writes H, the max to its end,
    into w slots; rm[n] = max(H[n+1], G[n+w]).  For w >= tile, where a
    tile holds at most one segment end, each tile first reads its samples
    and the H its outputs need, and the outputs after the segment's end
    read the new H; for w < tile, one output at a time.  delay (C, w), x
    (C, T).  Returns (rm, xs = xfull[:, :T], the new delay line), each
    equal to what the plain version computes: max is exact."""
    C, w = delay.shape
    T = x.shape[-1]
    R = -(-w // tile) * tile + 3 * tile
    ring = torch.zeros((C, R), dtype=x.dtype)
    hmax = torch.zeros((C, w), dtype=x.dtype)
    ring[:, R - w:] = delay

    def put(t):
        for i in range(t * tile, min((t + 1) * tile, T)):
            ring[:, i % R] = x[:, i]

    def suffix(last):
        h = torch.zeros(C, dtype=x.dtype)
        sl = last
        for k in range(w - 1, -1, -1):
            h = torch.maximum(h, ring[:, sl].abs())
            hmax[:, k] = h
            sl = sl - 1 if sl else R - 1

    put(0)
    put(1)
    suffix(R - 1)
    rm, xs = torch.empty_like(x), torch.empty_like(x)
    gm = torch.zeros(C, dtype=x.dtype)
    ph, ia, ib = 0, 0, R - w  # m mod w, the slots of xfull[m], xfull[m - w]
    for j in range(-(-T // tile)):
        put(j + 2)
        n0, cnt = j * tile, min(tile, T - j * tile)
        if w >= tile:
            gv = ring[:, [(ia + i) % R for i in range(tile)]].abs()
            hn = hmax[:, [(ph + 1 + i) % w for i in range(tile)]].clone()
            rs = 0 if ph == 0 else w - ph
            for i in range(tile):
                gm = gv[:, i] if i == rs else torch.maximum(gm, gv[:, i])
                gv[:, i] = gm
            ie = w - 1 - ph
            if ie < cnt:
                suffix((ia + ie) % R)
                hn[:, ie:] = hmax[:, :tile - ie]
            rm[:, n0:n0 + cnt] = torch.maximum(hn, gv)[:, :cnt]
            xs[:, n0:n0 + cnt] = ring[:, [(ib + i) % R for i in range(cnt)]]
            gm = gv[:, tile - 1].clone()
        else:
            for i in range(cnt):
                a = ring[:, (ia + i) % R].abs()
                p = (ph + i) % w
                gm = a if p == 0 else torch.maximum(gm, a)
                if p == w - 1:
                    suffix((ia + i) % R)
                rm[:, n0 + i] = torch.maximum(
                    hmax[:, 0 if p == w - 1 else p + 1], gm)
                xs[:, n0 + i] = ring[:, (ib + i) % R]
        ph, ia, ib = (ph + cnt) % w, (ia + cnt) % R, (ib + cnt) % R
    return rm, xs, ring[:, [(T + d - w) % R for d in range(w)]]


def machine_step_select(p: AgcScalars, carry, rm, fb, hb, chan=None):
    """The machine step in select form (`kernels/agc.cu::machine_step`,
    K3's and K13's) on (C,) tensors, with `machine_step`'s arguments and
    results: three compares of volts pick the new volts among the
    candidates volts + (rm - volts) * k for the attack, fast-decay and the
    state's own multiplier (0 holds), and the state, save, hang and decay
    are chosen by the same predicates.  A non-finite rm enters the
    candidates as NaN, as the blended form's products by 0 make its volts
    NaN there, and a NaN volts is saved (the blended save's 0 x NaN): the
    blended step's bits on every state reached from finite carries.
    State and decay_type are whole numbers in the carry."""
    volts, save, hang, decay, st = carry
    min_volts, hang_level = ((p.min_volts, p.hang_level) if chan is None
                             else chan)
    f = torch.float32

    def k(v):
        return torch.tensor(v, dtype=f)
    hc = torch.clamp_min(hang - 1.0, 0.0)
    s = ((st > 0.5).int() + (st > 1.5).int() + (st > 2.5).int()
         + (st > 3.5).int())
    ht = (hb > hang_level) & p.hang_enable
    wait = hc > 0.5
    hold = ((s == 0) & ht) | (((s == 1) | (s == 2)) & wait)
    hangd = (s == 4) | ((s == 2) & ~wait) | ((s == 1) & ~wait & (decay > 0.5))
    st_slow = torch.where(hold, 2, torch.where(hangd, 4, 3))
    k_slow = torch.where(hold, k(0.0), torch.where(
        hangd, k(p.hang_decay_mult), k(p.decay_mult)))

    d = torch.where(torch.isfinite(rm), rm, k(float("nan"))) - volts
    v_slow = volts + d * k_slow
    v_fast = volts + d * p.fast_decay_mult
    v_att = volts + d * p.attack_mult
    att = rm >= volts
    f0 = volts > p.pop_ratio * fb
    f1 = volts > save
    fast = ((s == 0) & f0) | ((s == 1) & f1)
    new_volts = torch.where(att, v_att, torch.where(fast, v_fast, v_slow))
    new_volts = (torch.clamp_min(new_volts, min_volts) if chan is None
                 else torch.maximum(new_volts, min_volts))
    new_state = torch.where(att, 0, torch.where(fast, 1, st_slow)).to(f)
    new_save = torch.where((att & (s >= 2)) | torch.isnan(volts), volts,
                           save)
    s0_slow = ~att & (s == 0) & ~f0
    new_hang = torch.where(s0_slow & ht, k(p.hang_time), hc)
    new_decay = torch.where(s0_slow, ht, decay > 0.5).to(f)
    return new_volts, new_save, new_hang, new_decay, new_state


def agc_design(p: AgcScalars, carry, delay, x, rows=None,
               tile: int = AGC_TILE):
    """K3's algorithm in torch: the front warp's ring max
    (`look_ahead_ring`), the walker's select-form steps
    (`machine_step_select`) and the gain law, with `agc_plain`'s
    arguments and results, bit for bit."""
    rm, xs, new_delay = look_ahead_ring(delay, x, tile)
    a_f = _f32(np.float32(1.0) - np.float32(p.fast_backmult))
    a_h = _f32(np.float32(1.0) - np.float32(p.hang_backmult))
    volts, save, hang, decay, st, fba, hba = carry.unbind(0)
    chan = None if rows is None else (rows[0], rows[2])
    mc = (volts, save, hang, decay, st)
    ax = xs.abs()
    vs = []
    for n in range(x.shape[-1]):
        fba = a_f * fba + p.fast_backmult * ax[:, n]
        hba = a_h * hba + p.hang_backmult * ax[:, n]
        mc = machine_step_select(p, mc, rm[:, n], fba, hba, chan)
        vs.append(mc[0])
    v = torch.stack(vs, dim=-1)
    y = xs * gain_law(p, v, None if rows is None else rows[1])
    return y, torch.stack(list(mc) + [fba, hba], dim=0), new_delay


def _check_rows(rows, n: int, C: int, dev, what: str):
    if rows is not None and (
            rows.shape != (n, C) or rows.dtype != torch.float32
            or rows.device != dev or not rows.is_contiguous()):
        raise ValueError(f"{what}: rows must be a contiguous ({n}, C) f32 "
                         f"tensor on the input's device")


def agc(p: AgcScalars, carry, delay, x, rows=None):
    """The whole AGC stage (K3).  carry: (7, C) f32 in the order
    [volts, save, hang, decay, state, fba, hba]; delay: (C, w) f32;
    x: (C, T) f32; rows: None or (3, C) f32 [min_volts, slope_constant,
    hang_level].  Returns (y, new_carry, new_delay)."""
    if x.device.type == "cpu":
        return agc_plain(p, carry, delay, x, rows)
    dev = x.device
    if x.ndim != 2:
        raise ValueError("agc: x must be (C, T)")
    C, T = x.shape
    w = delay.shape[-1]
    agc_geometry(C, T, w, rows is not None)     # raises outside the tiles
    if carry.shape != (N_CARRY, C) or delay.shape != (C, w):
        raise ValueError("agc: carry must be (7, C) and delay (C, w)")
    ts = (carry, delay, x)
    if any(t.dtype != torch.float32 or t.device != dev
           or not t.is_contiguous() for t in ts):
        raise ValueError("agc: contiguous f32 tensors on one device")
    _check_rows(rows, N_ROWS_AGC, C, dev, "agc")
    y = torch.empty_like(x)
    new_carry = torch.empty_like(carry)
    new_delay = torch.empty_like(delay)
    err = AGC.lib().uhsdr_agc_launch(
        x.data_ptr(), delay.data_ptr(), carry.data_ptr(),
        None if rows is None else rows.data_ptr(), C, T, w,
        p.attack_mult, p.fast_decay_mult, p.decay_mult, p.hang_decay_mult,
        p.fast_backmult, p.hang_backmult, p.pop_ratio, p.hang_level,
        p.hang_time, 1.0 if p.hang_enable else 0.0, p.min_volts,
        p.out_target, p.slope_constant, p.inv_max_input,
        y.data_ptr(), new_carry.data_ptr(), new_delay.data_ptr(),
        stream_ptr(dev))
    AGC.check(err)
    (AGC if rows is None else AGC_ROWS).launches += 1
    return y, new_carry, new_delay


def agc_stereo(p: AgcScalars, carry, delay, x, rows=None):
    """The linked stereo AGC stage in one launch (the port's route for
    the iq, ssbstereo and SAM stereo modes).  carry: (7, C) f32 in the
    order [volts, save, hang, decay, state, fba, hba]; delay: (C, 2, w)
    f32; x: (C, 2, T) f32; rows: None or (3, C) f32 [min_volts,
    slope_constant, hang_level].  Returns (y (C, 2, T), new_carry,
    new_delay) as `agc_stereo_plain`."""
    if x.device.type == "cpu":
        return agc_stereo_plain(p, carry, delay, x, rows)
    dev = x.device
    if x.ndim != 3 or x.shape[1] != 2:
        raise ValueError("agc_stereo: x must be (C, 2, T)")
    C, _, T = x.shape
    w = delay.shape[-1]
    agc_stereo_geometry(C, T, w, rows is not None)   # raises outside it
    if carry.shape != (N_CARRY, C) or delay.shape != (C, 2, w):
        raise ValueError("agc_stereo: carry must be (7, C) and delay "
                         "(C, 2, w)")
    ts = (carry, delay, x)
    if any(t.dtype != torch.float32 or t.device != dev
           or not t.is_contiguous() for t in ts):
        raise ValueError("agc_stereo: contiguous f32 tensors on one device")
    _check_rows(rows, N_ROWS_AGC, C, dev, "agc_stereo")
    y = torch.empty_like(x)
    new_carry = torch.empty_like(carry)
    new_delay = torch.empty_like(delay)
    err = AGC_STEREO.lib().uhsdr_agc_stereo_launch(
        x.data_ptr(), delay.data_ptr(), carry.data_ptr(),
        None if rows is None else rows.data_ptr(), C, T, w,
        p.attack_mult, p.fast_decay_mult, p.decay_mult, p.hang_decay_mult,
        p.fast_backmult, p.hang_backmult, p.pop_ratio, p.hang_level,
        p.hang_time, 1.0 if p.hang_enable else 0.0, p.min_volts,
        p.out_target, p.slope_constant, p.inv_max_input,
        y.data_ptr(), new_carry.data_ptr(), new_delay.data_ptr(),
        stream_ptr(dev))
    AGC_STEREO.check(err)
    (AGC_STEREO if rows is None else AGC_STEREO_ROWS).launches += 1
    return y, new_carry, new_delay


def agc_scan(p: AgcScalars, carry, rm, ax, rows=None):
    """The AGC machine alone (K13).  carry: (7, C) f32 in the order
    [volts, save, hang, decay, state, fba, hba]; rm (the look-ahead max)
    and ax (the delayed |x|): (C, T) f32; rows: None or (2, C) f32
    [min_volts, hang_level].  Returns (volts (C, T), new_carry (7, C))."""
    if rm.device.type == "cpu":
        return agc_scan_plain(p, carry, rm, ax, rows)
    dev = rm.device
    if rm.ndim != 2 or ax.shape != rm.shape:
        raise ValueError("agc_scan: rm and ax must be (C, T) of one shape")
    C, T = rm.shape
    agc_scan_geometry(C, T)                 # raises for an empty block
    if carry.shape != (N_CARRY, C):
        raise ValueError("agc_scan: carry must be (7, C)")
    ts = (carry, rm, ax)
    if any(t.dtype != torch.float32 or t.device != dev
           or not t.is_contiguous() for t in ts):
        raise ValueError("agc_scan: contiguous f32 tensors on one device")
    _check_rows(rows, N_ROWS_SCAN, C, dev, "agc_scan")
    volts = torch.empty_like(rm)
    new_carry = torch.empty_like(carry)
    lib = AGC_SCAN.lib()
    err = lib.uhsdr_agc_scan_launch(
        rm.data_ptr(), ax.data_ptr(), carry.data_ptr(),
        None if rows is None else rows.data_ptr(), C, T,
        p.attack_mult, p.fast_decay_mult, p.decay_mult, p.hang_decay_mult,
        p.fast_backmult, p.hang_backmult, p.pop_ratio, p.hang_level,
        p.hang_time, 1.0 if p.hang_enable else 0.0, p.min_volts,
        volts.data_ptr(), new_carry.data_ptr(), stream_ptr(dev))
    AGC_SCAN.check(err)
    (AGC_SCAN if rows is None else AGC_SCAN_ROWS).launches += 1
    return volts, new_carry
