"""RTTY demodulation: wrapper around the hand-written kernel
`kernels/rtty.cu`, beside its plain torch version.

A helper kernel with no TPU counterpart: the JAX package runs the mark,
space and low-pass biquads as dilated scans, and the ATC envelopes and
the DPLL/UART framing as `lax.scan`s over samples, then compacts the
emitted codes by a scatter (uhsdr_tpu/modems/rtty.py:100-247); on the
card a torch loop over samples costs some eighty launches a sample.  The
kernel walks a channel a lane with the three filters, the four envelopes
and the eight DPLL/UART registers in registers, and writes each code as
it is framed.  The wrapper takes the plain version only for tensors on
the CPU; for CUDA tensors it checks its arguments, launches the kernel on
the current stream (building it on first use), raises if the launch
failed and adds one to ``RTTY.launches``.  There is no fallback.  The
kernel is built with -fmad=false and repeats the plain version's
operations in its order: bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..ops import steps
from .build import CudaKernel, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int

RTTY = CudaKernel("rtty", "rtty.cu", {
    "uhsdr_rtty_launch": ([_P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _P, _P], _I),
}, extra_flags=("-fmad=false",))

LANES = 32
TILE = 32
# the loop-carried chain of a sample: the low-pass biquad's (s1 -> y ->
# a1 * y -> the subtraction -> the s2 add), behind which the DPLL's
# registers run on exact small integers
RTTY_SAMPLE_CHAIN = 4
DPLL_LEAVES = ("dpll_phase", "dpll_oldval", "dpll_changed", "run_state",
               "wait_state", "wait_half", "byte_acc", "byte_pos")
NBITS = 5.0


class RttyConsts(NamedTuple):
    """The kernel's scalars, as the JAX package rounds them
    (uhsdr_tpu/modems/rtty.py:106-108, 161-163): the ATC's weights and
    the bit timer's length, half length and nudge."""
    w_fast: np.float32
    w_slow16: np.float32
    w_slow48: np.float32
    ob: np.float32
    ob_half: np.float32
    ob_nudge: np.float32


def consts(one_bit: int) -> RttyConsts:
    return RttyConsts(np.float32(4.0 / one_bit),
                      np.float32(1.0 / (one_bit * 16)),
                      np.float32(1.0 / (one_bit * 48)),
                      np.float32(one_bit), np.float32(one_bit // 2),
                      np.float32(max(one_bit // 32, 1)))


def max_bytes(T: int, fs: float, baud: float) -> int:
    """Code slots a block of T samples returns (rtty.py:233)."""
    return max(int(T / fs * baud / 6) + 4, 8)


class RttyLeaves(NamedTuple):
    """The demodulator's state: mark_bq, space_bq, lpf_bq (C, 2), atc_env
    (C, 4) [mark env, space env, mark noise, space noise] and the eight
    DPLL/UART registers (C,), all f32 (the JAX package's layout)."""
    mark_bq: torch.Tensor
    space_bq: torch.Tensor
    lpf_bq: torch.Tensor
    atc_env: torch.Tensor
    dpll_phase: torch.Tensor
    dpll_oldval: torch.Tensor
    dpll_changed: torch.Tensor
    run_state: torch.Tensor
    wait_state: torch.Tensor
    wait_half: torch.Tensor
    byte_acc: torch.Tensor
    byte_pos: torch.Tensor


def _step(k: RttyConsts, mk, sp, lp, atc: bool, cpu: bool):
    """The demodulator's step over one sample, as the kernel's: the mark
    and space biquads, the squares, the ATC (each decayavg steps (x -
    avg) * w + avg, w the fast weight where x attacks; min and max as
    selects) or space^2 - mark^2, the low-pass biquad, the comparator (1
    = mark) and the DPLL bit sync with the async UART (rtty.py:170-227)
    in the JAX package's f32 blend form, every register an exact small
    integer.  Its one output is the framed code, -1 where none."""
    (m0, m1, m2, m3, m4), (q0, q1, q2, q3, q4), (l0, l1, l2, l3, l4) = (
        steps.consts(c, cpu) for c in (mk, sp, lp))
    wf, w16, w48, ob, ob_half, ob_nudge = steps.consts(k, cpu)
    f = steps.consts((0.0, 0.25, 0.5, 1.0, 1.5, 2.0, 2.5, NBITS - 0.5,
                      NBITS + 0.5, -1.0), cpu)
    zero, quarter, half, one, one5, two, two5, in5, done5, neg = f
    sel, pred = steps.sel, steps.pred

    def pow2(pos):
        if isinstance(pos, torch.Tensor):
            return _POW2.to(pos.device)[pos.long()]
        return np.float32(2.0 ** int(pos))

    def step(carry, xs):
        (ms1, ms2, qs1, qs2, ls1, ls2, me, se, mn, sn, phase, oldval,
         changed, run, wstate, whalf, acc, pos) = carry
        (xn,) = xs
        ym = m0 * xn + ms1
        ms1, ms2 = m1 * xn - m3 * ym + ms2, m2 * xn - m4 * ym
        ys = q0 * xn + qs1
        qs1, qs2 = q1 * xn - q3 * ys + qs2, q2 * xn - q4 * ys
        mk2, sk2 = ym * ym, ys * ys
        if atc:
            me = (mk2 - me) * sel(mk2 > me, wf, w16) + me
            se = (sk2 - se) * sel(sk2 > se, wf, w16) + se
            mn = (mk2 - mn) * sel(mk2 < mn, wf, w48) + mn
            sn = (sk2 - sn) * sel(sk2 < sn, wf, w48) + sn
            nf = sel(mn < sn, mn, sn)
            mc = sel(mk2 < me, mk2, me)
            mc = sel(mc > nf, mc, nf)
            sc = sel(sk2 < se, sk2, se)
            sc = sel(sc > nf, sc, nf)
            dm, ds = me - nf, se - nf
            v1 = (mc - nf) * dm - (sc - nf) * ds - quarter * (dm * dm
                                                             - ds * ds)
        else:
            v1 = sk2 - mk2
        yl = l0 * v1 + ls1
        ls1, ls2 = l1 * v1 - l3 * yl + ls2, l2 * v1 - l4 * yl
        b = pred(yl > zero) if atc else pred(yl <= zero)
        bsp = one - b
        # the start-bit waiter (rtty.c:594-632)
        is_w = pred(run < half)
        w0 = pred(wstate < half)
        w1 = pred((wstate > half) & (wstate < one5))
        wstate_n = wstate + w0 * b + w1 * bsp
        start_half = pred((wstate_n > one5) & (wstate_n < two5))
        whalf_n = start_half * ob_half + (one - start_half) * whalf
        wstate_n = wstate_n + start_half
        in_conf = pred(wstate_n > two5)
        whalf_n = whalf_n - in_conf
        confirmed = in_conf * pred(whalf_n < half)
        got_start = is_w * confirmed * bsp
        wstate_n = wstate_n * (one - confirmed)
        run_n = run + got_start * (one - run)
        phase = phase * (one - got_start)
        acc = acc * (one - got_start)
        pos = pos * (one - got_start)
        # the DPLL
        active = pred(run > half)
        edge = active * pred(b != oldval) * (one - changed)
        early = pred(phase < ob_half)
        phase = phase + edge * (two * early - one) * ob_nudge
        changed_n = changed + edge
        changed_n = sel(changed_n < one, changed_n, one)
        phase_n = phase + active
        bit_ready = active * pred(phase_n > ob - half)
        phase_n = phase_n - bit_ready * ob
        changed_n = changed_n * (one - bit_ready)
        # the UART: 5 data bits, LSB first, then the stop bit
        in_data = pred(pos < in5)
        acc_n = acc + bit_ready * in_data * b * pow2(pos)
        pos_n = pos + bit_ready
        done = bit_ready * pred(pos_n > done5)
        emit = done * acc_n + (one - done) * neg
        run_n = run_n * (one - done)
        return (ms1, ms2, qs1, qs2, ls1, ls2, me, se, mn, sn, phase_n, b,
                changed_n, run_n, wstate_n * (one - active), whalf_n,
                acc_n * (one - done), pos_n * (one - done)), (emit,)

    return step


_POW2 = 2.0 ** torch.arange(8, dtype=torch.float32)


def compact(emits: torch.Tensor, n_slots: int):
    """Emitted codes (C, T) f32, -1 where none, into (C, n_slots) int32 in
    arrival order with -1 fill, and their count (C,) int32.  A code past
    the last slot overwrites it (the JAX package scatters overflowing
    codes to the last slot, rtty.py:236; `max_bytes` leaves room for
    every code at the allowed baud rates, so it is never reached)."""
    C, T = emits.shape
    valid = emits >= 0
    idx = torch.cumsum(valid.to(torch.int64), dim=-1) - 1
    keep = valid & (idx < n_slots - 1)
    buf = torch.full((C, n_slots + 1), -1, dtype=torch.int32,
                     device=emits.device)
    codes = emits.to(torch.int32)
    buf.scatter_(1, torch.where(keep, idx, n_slots), torch.where(keep, codes,
                                                                -1))
    late = valid & (idx >= n_slots - 1)
    pos = torch.where(late, torch.arange(T, device=emits.device), -1)
    last = pos.amax(-1) if T else torch.full((C,), -1, device=emits.device)
    buf[:, n_slots - 1] = torch.where(
        last >= 0, codes.gather(1, last.clamp(min=0)[:, None])[:, 0],
        buf[:, n_slots - 1])
    return buf[:, :n_slots].contiguous(), valid.sum(-1).to(torch.int32)


def rtty_plain(mark_bp, space_bp, lpf, one_bit: int, atc: bool,
               n_slots: int, state: RttyLeaves, audio: torch.Tensor):
    """Plain torch version of the kernel: `_step` over the block's
    samples (`ops/steps.py::scan`), then the compaction (`compact`).
    audio (C, T) f32, T >= 1.  Returns (codes (C, n_slots) int32, nbytes
    (C,) int32, new state)."""
    cpu = audio.device.type == "cpu"
    step = _step(consts(one_bit), *(np.asarray(c, np.float32).reshape(5)
                                    for c in (mark_bp, space_bp, lpf)),
                 atc, cpu)
    carry = tuple(t.contiguous() for t in (
        *state.mark_bq.unbind(-1), *state.space_bq.unbind(-1),
        *state.lpf_bq.unbind(-1), *state.atc_env.unbind(-1), *state[4:]))
    carry, (emits,) = steps.scan(step, carry, (audio,))
    codes, nbytes = compact(emits, n_slots)
    env = torch.stack(carry[6:10], -1) if atc else state.atc_env
    return codes, nbytes, RttyLeaves(
        torch.stack(carry[0:2], -1), torch.stack(carry[2:4], -1),
        torch.stack(carry[4:6], -1), env, *carry[10:])


def rtty(mark_bp, space_bp, lpf, one_bit: int, atc: bool, n_slots: int,
         state: RttyLeaves, audio: torch.Tensor):
    """RTTY demodulation over one block (the kernel on CUDA tensors, the
    plain version on CPU ones).  audio: (C, T) f32, T >= 1; the three
    biquads (5,) each; one_bit the samples of a bit; n_slots the code
    slots a block returns; state a `RttyLeaves`.  Returns (codes (C,
    n_slots) int32, nbytes (C,) int32, new_state)."""
    if audio.device.type == "cpu":
        return rtty_plain(mark_bp, space_bp, lpf, one_bit, atc, n_slots,
                          state, audio)
    if audio.ndim != 2 or audio.dtype != torch.float32:
        raise ValueError("rtty: audio must be (C, T) f32")
    C, T = audio.shape
    if C < 1 or T < 1 or n_slots < 1 or one_bit < 2:
        raise ValueError(f"rtty: {C} x {T}, {n_slots} slots, one_bit "
                         f"{one_bit}")
    shapes = [(C, 2)] * 3 + [(C, 4)] + [(C,)] * 8
    for leaf, shp in zip(state, shapes):
        if tuple(leaf.shape) != shp or leaf.dtype != torch.float32:
            raise ValueError(f"rtty: state leaves must be f32 of {shapes}")
    ts = (audio,) + tuple(state)
    if any(t.device != audio.device or not t.is_contiguous() for t in ts):
        raise ValueError("rtty: contiguous tensors on one device")
    co = np.ascontiguousarray(np.concatenate([
        np.asarray(c, np.float32).reshape(5)
        for c in (mark_bp, space_bp, lpf)] + [np.asarray(consts(one_bit),
                                                         np.float32)]))
    codes = torch.empty((C, n_slots), dtype=torch.int32, device=audio.device)
    nbytes = torch.empty((C,), dtype=torch.int32, device=audio.device)
    new = RttyLeaves(*(torch.empty_like(t) for t in state))
    regs = (ctypes.c_void_p * 16)(*(t.data_ptr() for t in state[4:]),
                                  *(t.data_ptr() for t in new[4:]))
    err = RTTY.lib().uhsdr_rtty_launch(
        audio.data_ptr(), C, T, co.ctypes.data, ctypes.addressof(regs),
        int(atc), n_slots,
        *(t.data_ptr() for t in state[:4]), *(t.data_ptr() for t in new[:4]),
        codes.data_ptr(), nbytes.data_ptr(), stream_ptr(audio.device))
    RTTY.check(err)
    RTTY.launches += 1
    return codes, nbytes, new
