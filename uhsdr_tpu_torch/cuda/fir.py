"""K1 (the fused RX front, with one stage-B filter or the two-channel
modes' two), K15 (K1 with the translation in modulated stage-A taps), K5
(the real-tap decimating front, K1's stage A alone), K6/K7 (the
complex-tap decimating front, without and with the NCO: K5 with complex
taps), K4 (the polyphase interpolator) and K8 (the TX analytic FIR):
wrappers around the hand-written kernels `kernels/front.cu` (K1, K15, K5,
K6, K7), `kernels/interp.cu` and `kernels/fir_real.cu`, each beside its
plain torch version.

A wrapper takes the plain version only for tensors on the CPU.  For CUDA
tensors it checks device, dtype, shape and contiguity, launches its
kernel on the current stream (building it on first use), raises if the
launch failed, and adds one to the kernel's ``launches`` count.  There is
no fallback.

K1 replaces uhsdr_tpu/pallas/fir.py::_fir_kernel_rt_s2 (:179); K15
::_fir_kernel_rt_s2_mt (:287), which the reference selects for a static
NCO delta under UHSDR_FRONT_MT=1 and runs in one bf16 pass on the TPU
(the port computes it in FP32 like every kernel, as K1's kernel with
K6's complex stage-A taps and the rotor on the stage-A outputs); K5
replaces ::_fir_kernel_rt_s (:82); K6 ::_fir_kernel (:47); K7
::_fir_nco_kernel (:370); K4 ::_interp_kernel (:1003); K8
::_fir_real_kernel (:911).
What bounds each on the card is noted in its source.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..ops import fir as fir_ops
from ..ops import nco as nco_ops
from .build import SMEM_OPT_IN, CudaKernel, derived, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

FRONT = CudaKernel("front", "front.cu", {
    "uhsdr_front_launch": ([_I, _P, _P, _F, _I, _I, _I, _P, _P, _P,
                            ctypes.c_uint32, _P, _I, _I, _P, _P, _I, _I,
                            _P, _P, _P, _P, _P], _I),
    "uhsdr_front_mt_launch": ([_I, _P, _P, _F, _I, _I, _I, _P, _P, _P,
                               ctypes.c_uint32, _P, _I, _I, _P, _P, _I,
                               _P, _P, _P, _P, _P], _I),
    "uhsdr_front_mt_smem": ([_I, _I, _I, _I], _I),
    "uhsdr_front_threads": ([], _I),
    "uhsdr_front_outputs_per_thread": ([], _I),
    "uhsdr_front_tile_bytes": ([], _I),
    "uhsdr_front_smem_max": ([], _I),
    "uhsdr_front_smem": ([_I, _I, _I, _I, _I], _I),
    "uhsdr_fir_rt_launch": ([_I, _P, _P, _F, _I, _I, _P, _I, _P,
                             ctypes.c_uint32, _P, _I, _I, _I, _P, _P, _P, _P,
                             _P], _I),
    "uhsdr_fir_rt_rows_launch": ([_I, _P, _P, _F, _I, _I, _P, _P, _P, _P,
                                  _I, _I, _I, _P, _P, _P, _P, _P], _I),
    "uhsdr_front_smem_aim": ([], _I),
    "uhsdr_fir_cx_launch": ([_I, _P, _P, _F, _I, _I, _P, _I, _P,
                             ctypes.c_uint32, _P, _I, _I, _I, _P, _P, _P, _P,
                             _P], _I),
    "uhsdr_fir_cx_smem": ([_I, _I, _I], _I),
})
# one source and library, counted apart: K1 with the two-channel modes'
# two stage-B filters
FRONT_PAIR = CudaKernel("front_pair", "front.cu", lib_of=FRONT)
# K15, the modulated-taps front
FRONT_MT = CudaKernel("front_mt", "front.cu", lib_of=FRONT)
# K5, the real-tap decimating front (K1 with no stage B)
FIR_RT = CudaKernel("fir_rt", "front.cu", lib_of=FRONT)
# and K6 (no NCO) and K7 (NCO fused), the complex-tap decimating front
# (K5 with complex taps)
FIR_CX = CudaKernel("fir_cx", "front.cu", lib_of=FRONT)
FIR_CX_NCO = CudaKernel("fir_cx_nco", "front.cu", lib_of=FRONT)

INTERP = CudaKernel("interp", "interp.cu", {
    "uhsdr_interp_launch": ([_P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P],
                            _I),
    "uhsdr_interp_geometry": ([_I, _I, _P], _I),
    "uhsdr_interp_threads": ([], _I),
    "uhsdr_interp_max_taps": ([], _I),
    "uhsdr_interp_n_fixed": ([], _I),
    "uhsdr_interp_fixed": ([_I, _P], _I),
})

FIR_REAL = CudaKernel("fir_real", "fir_real.cu", {
    "uhsdr_fir_real_launch": ([_P, _I, _I, _P, _P, _I, _I, _I, _P,
                               ctypes.c_uint32, _P, _P, _P], _I),
    "uhsdr_fir_real_threads": ([], _I),
    "uhsdr_fir_real_outputs_per_thread": ([], _I),
    "uhsdr_fir_real_tile_bytes": ([], _I),
    "uhsdr_fir_real_smem_max": ([], _I),
    "uhsdr_fir_real_smem": ([_I, _I], _I),
})

INT16_SCALE = 1.0 / 32768.0


def _need(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def scale_planes(xi: torch.Tensor, xq: torch.Tensor):
    """IQ planes -> (f32 i, f32 q): int16 is normalized to full scale 1.0
    (32768 counts), f32 passes as it is."""
    sc = INT16_SCALE if xi.dtype == torch.int16 else 1.0
    return xi.to(torch.float32) * sc, xq.to(torch.float32) * sc


# ---------------------------------------------------------------------------
# K5: the real-tap decimating front; K6/K7: the complex-tap one
# ---------------------------------------------------------------------------

def fir_rt_plain(h, carry, xi, xq, decim: int, nco=None,
                 real_out: bool = False, planes_out: bool = False):
    """Plain torch version of K5: scale, peaks, NCO rotation of the block
    and of the raw history (when `nco` is given), the FIR h on both
    planes, decimation.  Returns (y (C, B//decim), new raw carry, peaks
    (C,)) with y as `fir_rt` describes."""
    a, b = scale_planes(xi, xq)
    peaks = torch.maximum(a.abs().amax(-1), b.abs().amax(-1))
    z = torch.complex(a, b)
    zr, cr = z, carry
    if nco is not None:
        phase, delta = nco
        n_hist = carry.shape[-1]
        zr = z * nco_ops.rotor(nco_ops.phase_ramp(phase, delta, z.shape[-1]))
        cr = carry * nco_ops.rotor(nco_ops.phase_ramp(phase, delta, n_hist,
                                                      start=-n_hist))
    y, _ = fir_ops.fir_decimate_block(h, cr, zr, decim)
    new_carry = torch.cat([carry, z], dim=-1)[..., z.shape[-1]:]
    if real_out:
        y = y.real.contiguous()
    elif planes_out:
        y = (y.real.contiguous(), y.imag.contiguous())
    return y, new_carry, peaks


def fir_cx_plain(h, carry, xi, xq, decim: int, nco=None,
                 real_out: bool = False, planes_out: bool = False):
    """Plain torch version of K6 (no `nco`) and K7: `fir_rt_plain` with
    complex taps h, so y = sum_k h[k] z[m*decim - k] is complex before
    `real_out` takes its real part."""
    return fir_rt_plain(h, carry, xi, xq, decim, nco, real_out, planes_out)


def _decimate(name: str, kernel: CudaKernel, geometry, h_dtype, h, carry,
              xi, xq, decim: int, nco, real_out: bool, planes_out: bool):
    """Check the arguments of a decimating-front kernel (K5, K6, K7: one
    C interface in front.cu), launch it and count the launch on `kernel`.
    `geometry(taps, decim, in_bytes)` is its tile rule, which raises where
    the kernel's buffers do not take the shape."""
    dev = xi.device
    _need(xi.ndim == 2, f"{name}: xi/xq must be (C, B)")
    C, B = xi.shape
    taps = h.shape[-1]
    _need(xi.dtype in (torch.int16, torch.float32) and xq.dtype == xi.dtype
          and xq.shape == xi.shape, f"{name}: xi/xq must be int16 or f32 "
          "planes of one shape")
    _need(decim >= 1 and B % decim == 0,
          f"{name}: decimation {decim} < 1, or block {B} not a multiple "
          f"of it")
    _need(h.dtype == h_dtype and h.ndim == 1 and taps >= 2,
          f"{name}: h must be (taps,) {h_dtype}")
    _need(carry.shape == (C, taps - 1) and carry.dtype == torch.complex64,
          f"{name}: carry must be (C, taps-1) complex64")
    ts = [h, carry, xi, xq]
    phase, delta = (None, 0) if nco is None else nco
    rows = isinstance(delta, torch.Tensor)
    if phase is not None:
        _need(phase.shape == (C,) and phase.dtype == torch.int64,
              f"{name}: phase must be (C,) int64")
        ts.append(phase)
    if rows:
        _need(name == "fir_rt", f"{name}: one delta for every channel")
        _need(delta.shape == (C,) and delta.dtype == torch.int64,
              f"{name}: a delta a channel must be (C,) int64")
        ts.append(delta)
    _need(all(t.device == dev for t in ts), f"{name}: tensors on one device")
    _need(all(t.is_contiguous() for t in ts), f"{name}: contiguous tensors")
    geometry(taps, decim, xi.element_size())
    lib = _front_lib()
    T_out = B // decim
    f32 = dict(dtype=torch.float32, device=dev)
    if real_out or planes_out:
        out_kind = 2 if real_out else 0
        out_a = torch.empty((C, T_out), **f32)
        out_b = None if real_out else torch.empty((C, T_out), **f32)
        y = out_a if real_out else (out_a, out_b)
    else:
        out_kind, out_b = 1, None
        y = torch.empty((C, T_out), dtype=torch.complex64, device=dev)
        out_a = y
    new_carry = torch.empty_like(carry)
    peaks = torch.empty((C,), **f32)
    in_kind = 0 if xi.dtype == torch.int16 else 1
    head = (in_kind, xi.data_ptr(), xq.data_ptr(),
            INT16_SCALE if in_kind == 0 else 1.0, C, B, carry.data_ptr())
    tail = (out_kind, out_a.data_ptr(),
            None if out_b is None else out_b.data_ptr(),
            new_carry.data_ptr(), peaks.data_ptr(), stream_ptr(dev))
    if rows:
        err = lib.uhsdr_fir_rt_rows_launch(
            *head, phase.data_ptr(), delta.data_ptr(), h.data_ptr(), taps,
            decim, *tail)
    else:
        err = getattr(lib, f"uhsdr_{name}_launch")(
            *head, 0 if phase is None else 1,
            None if phase is None else phase.data_ptr(),
            int(delta) & nco_ops.MASK32, h.data_ptr(), taps, decim, *tail)
    kernel.check(err)
    kernel.launches += 1
    return y, new_carry, peaks


def fir_rt(h, carry, xi, xq, decim: int, nco=None, real_out: bool = False,
           planes_out: bool = False):
    """The real-tap decimating front (K5).  h: (taps,) f32 real taps;
    carry: (C, taps-1) complex64 RAW pre-mix history; xi, xq: (C, B) int16
    or f32 planes; nco: None, or (phase (C,) int64 in [0, 2^32), the
    uint32 phase increment) to rotate the input before the filter; the
    increment is one int, or a (C,) int64 tensor of one a channel on the
    planes' device (the kernel's DROW instance, counted as K5).
    Returns (y, new_carry, peaks): y is the decimated complex64 (C,
    B//decim) signal, or its (real, imag) f32 planes with `planes_out`,
    or its real plane alone with `real_out`."""
    if xi.device.type == "cpu":
        return fir_rt_plain(h, carry, xi, xq, decim, nco, real_out,
                            planes_out)
    return _decimate("fir_rt", FIR_RT, fir_rt_geometry, torch.float32, h,
                     carry, xi, xq, decim, nco, real_out, planes_out)


def fir_cx(h, carry, xi, xq, decim: int, nco=None, real_out: bool = False,
           planes_out: bool = False):
    """The complex-tap decimating front: K6 without `nco`, K7 with it
    (each counts its own launches).  h: (taps,) complex64 taps; the other
    arguments and the result as `fir_rt`'s.  The taps and the decimation
    are limited only by the kernel's shared memory
    (`fir_cx_geometry`)."""
    if xi.device.type == "cpu":
        return fir_cx_plain(h, carry, xi, xq, decim, nco, real_out,
                            planes_out)
    return _decimate("fir_cx", FIR_CX if nco is None else FIR_CX_NCO,
                     fir_cx_geometry, torch.complex64, h, carry, xi, xq, decim,
                     nco, real_out, planes_out)


# ---------------------------------------------------------------------------
# K1: the fused front
# ---------------------------------------------------------------------------

# K1's geometry constants, as `kernels/front.cu` defines them (the wrapper
# checks them against the library's getters when it first loads it):
# threads a block, outputs a thread holds in registers, bytes of a plane
# a tile aims at, the dynamic shared memory a block may take (bytes).
FRONT_THREADS = 128
FRONT_R = 8
FRONT_TILE_BYTES = 8192
FRONT_SMEM_MAX = 225 * 1024
FRONT_ROTOR_GROUP = 8          # samples a thread rotates from one sincospif
# K5's shared memory aim, bytes: three blocks of FRONT_THREADS an SM
# (3 x (72 KB + the 1 KB a block reserves) within the SM's 228 KB)
FIR_RT_SMEM_AIM = 72 * 1024


class FrontGeometry(NamedTuple):
    """K1's, K15's, K5's or K6/K7's tiles for one shape
    (`kernels/front.cu::geometry`)."""
    e: int           # column of a polyphase row's sample 0 (R | e)
    ze: int          # index of stage-A output 0 in its buffer (R | ze; K5 0)
    ap: int          # polyphase tap row length (R | ap)
    t_tile: int      # outputs a tile (R | t_tile)
    p: int           # polyphase-row groups of stage A
    pb: int          # tap groups of stage B (K5 0)
    smem: int        # dynamic shared memory, bytes


def _pad(i: int) -> int:
    return i + i // FRONT_R


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def front_geometry(taps: int, taps2: int, decim: int, nb: int,
                   in_bytes: int = 2, n_keep: int | None = None,
                   cx: bool = False) -> FrontGeometry:
    """K1's tile geometry for stage-A `taps` at `decim`, `nb` stage-B
    filters of `taps2`, planes of `in_bytes` a sample (2: int16, 4: f32)
    and a raw carry of `n_keep` (default taps - 1); nb = 0 is K5's
    (`fir_rt_geometry`), and with complex stage-A taps (`cx`, two floats a
    tap) K6/K7's (`fir_cx_geometry`) or, with nb = 1, K15's
    (`front_mt_geometry`).  A tile holds t_tile outputs, about
    FRONT_TILE_BYTES of each plane and more than either halo, so a halo
    copy never overlaps its source; K5 halves it (down to its halo) until
    the buffers are within FIR_RT_SMEM_AIM.  Raises ValueError for a shape
    the kernel does not take: nb outside 0..2 (2 with cx), n_keep <
    taps - 1, or buffers past FRONT_SMEM_MAX."""
    n_keep = taps - 1 if n_keep is None else n_keep
    _need(taps >= 1 and decim >= 1 and nb in (0, 1, 2)
          and (nb == 0 or taps2 >= 1) and in_bytes in (2, 4)
          and not (cx and nb > 1),
          f"front: taps {taps}, taps2 {taps2}, decim {decim}, nb {nb}, "
          f"{in_bytes}-byte samples{', complex taps' if cx else ''}")
    _need(n_keep >= taps - 1,
          f"front: raw carry of {n_keep} < taps - 1 = {taps - 1}")
    R = FRONT_R
    a0 = -(-taps // decim)                 # taps of polyphase row 0
    ap = _round_up(a0, R)
    e, ze = ap, (_round_up(taps2, R) if nb else 0)
    lo = -(-max(taps2 - 1 if nb else 0, e + 1) // R)
    nob = max(FRONT_TILE_BYTES // in_bytes // (decim * R), lo)
    while True:
        t_tile = nob * R
        share = max(FRONT_THREADS // nob, 1)
        p, pb = min(share, decim), (min(share, taps2) if nb else 0)
        rs = _pad(e + t_tile) + 1
        zs = _pad(ze + t_tile - 1) + 1 if nb else 0
        pt = _pad(t_tile - 1) + 1
        st = _round_up(t_tile * decim * in_bytes, 16) // 4
        part = (pt * max(2 * p, nb * pb) if nb
                else pt * 2 * p if p > 1 else 0)
        floats = (2 * st + _round_up(2 * decim * rs, 4) + _round_up(2 * zs, 4)
                  + _round_up((2 if cx else 1) * decim * ap, 4) + 2 * nb * ze
                  + _round_up(part, 4) + 2 * FRONT_ROTOR_GROUP)
        if nb or 4 * floats <= FIR_RT_SMEM_AIM or nob == lo:
            break
        nob = max(nob // 2, lo)
    _need(4 * floats <= FRONT_SMEM_MAX,
          f"front: {taps}{' complex' if cx else ''} + {taps2 if nb else 0} "
          f"taps at decim {decim} need {4 * floats} bytes of shared "
          f"memory, past {FRONT_SMEM_MAX}")
    return FrontGeometry(e, ze, ap, t_tile, p, pb, 4 * floats)


def fir_rt_geometry(taps: int, decim: int, in_bytes: int = 2
                    ) -> FrontGeometry:
    """K5's tile geometry: `front_geometry` with no stage B (no stage-B
    buffers; with one row group no partial-sum buffer: the outputs go
    straight out).  Raises ValueError where it does not fit."""
    return front_geometry(taps, 1, decim, 0, in_bytes)


def fir_cx_geometry(taps: int, decim: int, in_bytes: int = 2
                    ) -> FrontGeometry:
    """K6/K7's tile geometry: `fir_rt_geometry` with the stage-A tap
    buffer doubled ((hr, -hi) pairs).  Raises ValueError where it does
    not fit shared memory."""
    return front_geometry(taps, 1, decim, 0, in_bytes, cx=True)


def front_mt_geometry(taps: int, taps2: int, decim: int,
                      in_bytes: int = 2, n_keep: int | None = None
                      ) -> FrontGeometry:
    """K15's tile geometry: K1's (`front_geometry`, one stage-B filter)
    with the stage-A tap buffer doubled ((hr, -hi) pairs of the modulated
    taps).  Raises ValueError where it does not fit shared memory."""
    return front_geometry(taps, taps2, decim, 1, in_bytes, n_keep, cx=True)


def _front_lib():
    """The front library, its geometry constants checked against this
    module's when it is first used (the mark lives on the library)."""
    lib = FRONT.lib()
    if not getattr(lib, "geometry_checked", False):
        got = (lib.uhsdr_front_threads(), lib.uhsdr_front_outputs_per_thread(),
               lib.uhsdr_front_tile_bytes(), lib.uhsdr_front_smem_max(),
               lib.uhsdr_front_smem_aim())
        want = (FRONT_THREADS, FRONT_R, FRONT_TILE_BYTES, FRONT_SMEM_MAX,
                FIR_RT_SMEM_AIM)
        if got != want:
            raise RuntimeError(f"front.cu's geometry {got} differs from "
                               f"cuda/fir.py's {want}")
        lib.geometry_checked = True
    return lib


def front_plain(h, g, carry, carry2, xi, xq, phase, delta: int, decim: int):
    """Plain torch version of the K1 front: stage A as `fir_rt_plain`
    (scale, peaks, NCO rotation of the block and of the raw history's last
    taps-1 samples, real taps h, decimate), then stage B (complex taps g,
    real output) for each row of g.  Returns (audio (C, B//decim), or (C,
    nb, B//decim) for g of nb rows, the new raw carry (as long as
    `carry`), the new stage-B carry, peaks (C,))."""
    n_hist = h.shape[-1] - 1
    za, _, peaks = fir_rt_plain(h, carry[..., carry.shape[-1] - n_hist:],
                                xi, xq, decim, nco=(phase, delta))
    a, b = scale_planes(xi, xq)
    new_carry = torch.cat([carry, torch.complex(a, b)],
                          dim=-1)[..., xi.shape[-1]:]
    if g.ndim == 1:
        y, new_carry2 = fir_ops.fir_block(g, carry2, za)
        return y.real.contiguous(), new_carry, new_carry2, peaks
    ys = []
    for gb in g:
        y, new_carry2 = fir_ops.fir_block(gb, carry2, za)
        ys.append(y.real)
    return torch.stack(ys, dim=1), new_carry, new_carry2, peaks


def front(h, g, carry, carry2, xi, xq, phase, delta: int, decim: int):
    """The fused front (K1).  h: (taps,) f32 real stage-A taps; g:
    (taps2,) complex64 stage-B taps, or (2, taps2) for the two-channel
    modes (counted as `front_pair`); carry: (C, n_keep) complex64 RAW
    pre-mix history, n_keep >= taps-1 (the last taps-1 feed stage A);
    carry2: (C, taps2-1) complex64 stage-A history; xi, xq: (C, B) int16
    or f32 planes; phase: (C,) int64 NCO phases in [0, 2^32); delta: the
    uint32 phase increment.  Returns (audio, new_carry, new_carry2, peaks)
    as `front_plain`."""
    if xi.device.type == "cpu":
        return front_plain(h, g, carry, carry2, xi, xq, phase, delta, decim)
    return _launch_front(FRONT_PAIR if g.ndim == 2 else FRONT, h, g,
                         carry, carry2, xi, xq, phase, delta, decim)


def modulated_taps(h: torch.Tensor, delta: int) -> torch.Tensor:
    """K15's stage-A taps h[k] e^{-j delta k}, complex64 on h's device:
    real part hc = h cos(delta k), imaginary part hs = -h sin(delta k),
    from the exact uint32 phase delta k mod 2^32 in float64 (the
    reference's, pallas/fir.py:603-612), each rounded once to f32; built
    once per (h, delta)."""
    d = int(delta) & nco_ops.MASK32

    def make(v):
        h64 = np.asarray(v, np.float64)
        ang = np.array([(d * k) % nco_ops.TWO32 for k in range(h64.size)],
                       np.float64) * (2.0 * np.pi / nco_ops.TWO32)
        hm = np.empty(h64.size, np.complex64)
        hm.real = h64 * np.cos(ang)
        hm.imag = -h64 * np.sin(ang)
        return torch.as_tensor(hm, device=h.device)
    return derived(h, ("modulated", d), make)


def front_mt_plain(h, g, carry, carry2, xi, xq, phase, delta: int,
                   decim: int):
    """Plain torch version of K15: stage A with the modulated complex taps
    on the raw, unrotated block and raw history (its last taps-1
    samples), the absolute rotor e^{j(phase + delta decim m)} on the
    decimated output, then K1's stage B (one filter).  Returns (audio
    (C, B//decim), the new raw carry, the new stage-B carry, peaks (C,))
    as `front_plain`."""
    n_hist = h.shape[-1] - 1
    a, b = scale_planes(xi, xq)
    peaks = torch.maximum(a.abs().amax(-1), b.abs().amax(-1))
    z = torch.complex(a, b)
    w, _ = fir_ops.fir_decimate_block(
        modulated_taps(h, delta), carry[..., carry.shape[-1] - n_hist:], z,
        decim)
    za = w * nco_ops.rotor(nco_ops.phase_ramp(
        phase, (int(delta) * decim) & nco_ops.MASK32, w.shape[-1]))
    new_carry = torch.cat([carry, z], dim=-1)[..., xi.shape[-1]:]
    y, new_carry2 = fir_ops.fir_block(g, carry2, za)
    return y.real.contiguous(), new_carry, new_carry2, peaks


def front_mt(h, g, carry, carry2, xi, xq, phase, delta: int, decim: int):
    """The modulated-taps front (K15): `front` with one stage-B filter,
    the translation folded into the stage-A taps (`modulated_taps`, for
    the static `delta`) and applied at the decimated rate.  Arguments and
    result as `front`'s."""
    if xi.device.type == "cpu":
        return front_mt_plain(h, g, carry, carry2, xi, xq, phase, delta,
                              decim)
    _need(g.ndim == 1, "front_mt: one stage-B filter, g (taps2,)")
    _need(h.dtype == torch.float32, "front_mt: h f32")
    return _launch_front(FRONT_MT, modulated_taps(h, delta), g, carry,
                         carry2, xi, xq, phase, delta, decim)


def _launch_front(counter: CudaKernel, h, g, carry, carry2, xi, xq, phase,
                  delta: int, decim: int):
    """Check a front's arguments, launch K1 (h f32) or K15 (h complex64,
    the modulated taps) and count the launch on `counter`."""
    dev = xi.device
    C, B = xi.shape
    taps, taps2 = h.shape[-1], g.shape[-1]
    nb = 1 if g.ndim == 1 else g.shape[0]
    n_keep = carry.shape[-1]
    mt = h.is_complex()
    _need(xi.dtype in (torch.int16, torch.float32) and xq.dtype == xi.dtype
          and xq.shape == xi.shape, "front: xi/xq must be int16 or f32 "
          "planes of one shape")
    _need(B % decim == 0, f"front: block {B} not a multiple of {decim}")
    _need(h.dtype in (torch.float32, torch.complex64)
          and g.dtype == torch.complex64, "front: h f32 (K15: complex64), "
          "g complex64")
    _need(g.ndim in (1, 2) and nb in (1, 2),
          "front: g must be (taps2,) or (2, taps2)")
    _need(carry.ndim == 2 and carry.shape[0] == C and n_keep >= taps - 1
          and carry.dtype == torch.complex64,
          "front: carry must be (C, n_keep >= taps-1) complex64")
    _need(carry2.shape == (C, taps2 - 1) and carry2.dtype == torch.complex64,
          "front: carry2 must be (C, taps2-1) complex64")
    _need(phase.shape == (C,) and phase.dtype == torch.int64,
          "front: phase must be (C,) int64")
    ts = (h, g, carry, carry2, xi, xq, phase)
    _need(all(t.device == dev for t in ts), "front: tensors on one device")
    _need(all(t.is_contiguous() for t in ts), "front: contiguous tensors")
    front_geometry(taps, taps2, decim, nb, xi.element_size(), n_keep, cx=mt)
    lib = _front_lib()
    g_re = g.real.contiguous()
    g_im = g.imag.contiguous()
    T_out = B // decim
    out = torch.empty((C, nb, T_out) if g.ndim == 2 else (C, T_out),
                      dtype=torch.float32, device=dev)
    new_carry = torch.empty_like(carry)
    new_carry2 = torch.empty_like(carry2)
    peaks = torch.empty((C,), dtype=torch.float32, device=dev)
    in_kind = 0 if xi.dtype == torch.int16 else 1
    scale = INT16_SCALE if in_kind == 0 else 1.0
    args = (in_kind, xi.data_ptr(), xq.data_ptr(), scale, C, B, n_keep,
            carry.data_ptr(), carry2.data_ptr(), phase.data_ptr(),
            int(delta) & nco_ops.MASK32, h.data_ptr(), taps, decim,
            g_re.data_ptr(), g_im.data_ptr(), taps2)
    tail = (out.data_ptr(), new_carry.data_ptr(), new_carry2.data_ptr(),
            peaks.data_ptr(), stream_ptr(dev))
    err = (lib.uhsdr_front_mt_launch(*args, *tail) if mt
           else lib.uhsdr_front_launch(*args, nb, *tail))
    counter.check(err)
    counter.launches += 1
    return out, new_carry, new_carry2, peaks


# ---------------------------------------------------------------------------
# K4: the polyphase interpolator
# ---------------------------------------------------------------------------

# K4's launch constants, as `kernels/interp.cu` defines them (the wrapper
# checks them against the library's getters, its table FIXED among them,
# when it first loads it): threads a block; the (L, S) pairs with an
# instance of their own (the chains' factors: x2 and x4 at 48 kHz, x4 and
# x8 at 96, x8 and x16 at 192); the largest padded tap table the generic
# instance takes in its launch parameters (past it, it reads the taps
# from the card).
INTERP_THREADS = 128
INTERP_FIXED = frozenset({(2, 2), (2, 8), (4, 1), (4, 4), (4, 24), (8, 12),
                          (8, 24), (16, 12)})
INTERP_MAX_TAPS = 960


class InterpGeometry(NamedTuple):
    """K4's launch for one shape (`kernels/interp.cu::geometry`)."""
    fixed: bool      # an instance of its own (else the generic one)
    sub_len: int     # S = ceil(taps / L)
    R: int           # low-rate samples a thread (R*L outputs)
    H: int           # the window's halo: S - 1 rounded up to 4
    tile: int        # low-rate samples a block: INTERP_THREADS * R
    tiles: int       # blocks a channel
    blocks: int      # the grid: C * tiles
    smem: int        # dynamic shared memory, bytes
    param_taps: bool  # taps in the launch's parameters (else on the card)


def interp_geometry(L: int, taps: int, B: int, C: int = 1) -> InterpGeometry:
    """K4's launch for C channels of B low-rate samples, interpolated by L
    with `taps` taps.  A thread owns R consecutive samples (32 / L for
    the chains' factors below 8, else 4; 4 on the generic instance) and
    slides a window of H + R of them; a block stages one tile of
    INTERP_THREADS * R samples with its halo and, on the fixed instances,
    its warps' outputs (rows of R*L + 4 floats).  The taps travel in the
    launch's parameters, but for a generic instance past INTERP_MAX_TAPS
    padded taps, which reads them from the card.  Raises ValueError for a
    shape the kernel does not take: L < 1, taps < 1, B < 1, or a halo of
    S - 1 samples past the card's shared memory (some 57k taps a
    phase)."""
    _need(L >= 1 and taps >= 1 and B >= 1 and C >= 1,
          f"interpolate: x{L}, {taps} taps, {C} x {B} samples")
    S = -(-taps // L)
    fixed = (L, S) in INTERP_FIXED
    R = (4 if L >= 8 else 32 // L) if fixed else 4
    H = _round_up(S - 1, 4)
    tile = INTERP_THREADS * R
    smem = 4 * (H + tile)
    if fixed:
        smem += 4 * INTERP_THREADS * (R * L + 4)
    _need(smem <= SMEM_OPT_IN, f"interpolate: x{L} with {taps} taps stages "
          f"{smem} bytes, past the card's {SMEM_OPT_IN}")
    tiles = -(-B // tile)
    return InterpGeometry(fixed, S, R, H, tile, tiles, C * tiles, smem,
                          fixed or L * S <= INTERP_MAX_TAPS)


def interp_plain(h, carry, x, interp: int):
    """Plain torch version of K4 (`ops.fir.fir_interpolate_block`)."""
    return fir_ops.fir_interpolate_block(h, carry, x, interp)


def _interp_lib():
    """K4's library, its constants checked against this module's when it
    is first used (the mark lives on the library)."""
    lib = INTERP.lib()
    if not getattr(lib, "geometry_checked", False):
        pair = (ctypes.c_int * 2)()
        fixed = {tuple(pair) for i in range(lib.uhsdr_interp_n_fixed())
                 if lib.uhsdr_interp_fixed(i, pair) == 0}
        got = (lib.uhsdr_interp_threads(), lib.uhsdr_interp_max_taps(),
               fixed)
        want = (INTERP_THREADS, INTERP_MAX_TAPS, set(INTERP_FIXED))
        if got != want:
            raise RuntimeError(f"interp.cu's constants {got} differ from "
                               f"cuda/fir.py's {want}")
        lib.geometry_checked = True
    return lib


def interpolate(h, carry, x, interp: int):
    """Polyphase interpolation by `interp` (K4).  h: (taps,) f32; carry:
    (C, sub_len-1) f32; x: (C, B) f32.  Returns (y (C, B*interp),
    new_carry).  The taps go to the kernel in its launch parameters: the
    wrapper keeps a host copy of them (`build.derived`)."""
    if x.device.type == "cpu":
        return interp_plain(h, carry, x, interp)
    dev = x.device
    _need(x.ndim == 2 and h.ndim == 1, "interpolate: x must be (C, B) and "
          "h (taps,)")
    C, B = x.shape
    taps = h.shape[-1]
    sub_len = -(-taps // interp)
    _need(interp >= 1 and B >= 1, "interpolate: interp >= 1 and a "
          "non-empty block")
    _need(x.dtype == torch.float32 and h.dtype == torch.float32
          and carry.dtype == torch.float32, "interpolate: f32 tensors")
    _need(carry.shape == (C, sub_len - 1),
          "interpolate: carry must be (C, sub_len-1)")
    _need(all(t.device == dev for t in (h, carry)),
          "interpolate: tensors on one device")
    _need(all(t.is_contiguous() for t in (h, carry, x)),
          "interpolate: contiguous tensors")
    interp_geometry(interp, taps, B, C)
    h_host = derived(h, "interp",
                     lambda v: np.ascontiguousarray(v, dtype=np.float32))
    y = torch.empty((C, B * interp), dtype=torch.float32, device=dev)
    new_carry = torch.empty_like(carry)
    err = _interp_lib().uhsdr_interp_launch(
        x.data_ptr(), carry.data_ptr(), C, B, h_host.ctypes.data,
        h.data_ptr(), taps, interp, y.data_ptr(), new_carry.data_ptr(),
        stream_ptr(dev))
    INTERP.check(err)
    INTERP.launches += 1
    return y, new_carry


# ---------------------------------------------------------------------------
# K8: the TX analytic FIR
# ---------------------------------------------------------------------------

# K8's geometry constants, as `kernels/fir_real.cu` defines them (the
# wrapper checks them against the library's getters when it first loads
# it): threads a block, outputs a thread holds in registers, bytes of audio
# a tile aims at, the dynamic shared memory a block may take (bytes).
FIR_REAL_THREADS = 128
FIR_REAL_R = 8
FIR_REAL_TILE_BYTES = 8192
FIR_REAL_SMEM_MAX = 225 * 1024


class FirRealGeometry(NamedTuple):
    """K8's tiles for one shape (`kernels/fir_real.cu::geometry`)."""
    e: int           # column of a tile's sample 0: the halo (R | e)
    ap: int          # taps zero-padded to whole chunks of R (R | ap)
    t_tile: int      # outputs a tile (R | t_tile)
    p: int           # tap groups (each a whole number of chunks)
    smem: int        # dynamic shared memory, bytes


def fir_real_geometry(taps: int, B: int) -> FirRealGeometry:
    """K8's tile geometry for `taps` complex taps and blocks of `B`
    samples.  A tile holds t_tile outputs: FIR_REAL_TILE_BYTES of audio
    and no fewer than the halo of e >= taps - 1 columns, so the halo's
    copy to the next tile never overlaps its source; a block shorter than
    that is one tile of B rounded up to R.  Where a tile has fewer than
    one item of R outputs a thread, the taps' chunks are split over p
    groups.  Raises ValueError for a shape the kernel does not take:
    buffers past FIR_REAL_SMEM_MAX."""
    _need(taps >= 1 and B >= 0, f"fir_real: {taps} taps, block {B}")
    R = FIR_REAL_R

    def pad(i):
        return i + i // R

    ap = _round_up(taps, R)
    e = ap
    t = max(FIR_REAL_TILE_BYTES // 4, e)
    if B < t:
        t = _round_up(B, R) if B > R else R
    share = max(FIR_REAL_THREADS // (t // R), 1)
    p = min(share, ap // R)
    xs = pad(e + t - 1) + 1
    pt = pad(t - 1) + 1
    floats = (t + _round_up(xs, 4) + 2 * ap + 2 * R
              + (2 * p * pt if p > 1 else 0))
    _need(4 * floats <= FIR_REAL_SMEM_MAX,
          f"fir_real: {taps} taps need {4 * floats} bytes of shared "
          f"memory, past {FIR_REAL_SMEM_MAX}")
    return FirRealGeometry(e, ap, t, p, 4 * floats)


def _fir_real_lib():
    """K8's library, its geometry constants checked against this module's
    when it is first used (the mark lives on the library)."""
    lib = FIR_REAL.lib()
    if not getattr(lib, "geometry_checked", False):
        got = (lib.uhsdr_fir_real_threads(),
               lib.uhsdr_fir_real_outputs_per_thread(),
               lib.uhsdr_fir_real_tile_bytes(), lib.uhsdr_fir_real_smem_max())
        want = (FIR_REAL_THREADS, FIR_REAL_R, FIR_REAL_TILE_BYTES,
                FIR_REAL_SMEM_MAX)
        if got != want:
            raise RuntimeError(f"fir_real.cu's geometry {got} differs from "
                               f"cuda/fir.py's {want}")
        lib.geometry_checked = True
    return lib


def fir_real_plain(h, carry, x, nco=None, conj: bool = False):
    """Plain torch version of K8: y = x (*) h for real x and complex h at
    decimation 1 over the carried real history, conjugated with `conj`,
    then rotated by the NCO ramp where `nco` = (phase (C,) int64, delta)
    is given.  Returns (y (C, B) complex64, new carry (C, taps-1) f32)."""
    y, new_carry = fir_ops.fir_block(h, carry, x)
    if conj:
        y = y.conj().resolve_conj()
    if nco is not None:
        phase, delta = nco
        y = y * nco_ops.rotor(nco_ops.phase_ramp(phase, delta, x.shape[-1]))
    return y, new_carry


def fir_real(h, carry, x, nco=None, conj: bool = False):
    """The TX analytic FIR (K8).  h: (taps,) complex64; carry: (C,
    taps-1) f32 real history; x: (C, B) f32 audio; nco: None, or (phase
    (C,) int64 in [0, 2^32), the uint32 phase increment) to rotate the
    output; conj: conjugate before the rotation (LSB).  Returns (y (C, B)
    complex64, new_carry).  The taps are limited only by the kernel's
    shared memory (`fir_real_geometry`)."""
    if x.device.type == "cpu":
        return fir_real_plain(h, carry, x, nco, conj)
    dev = x.device
    _need(x.ndim == 2 and x.dtype == torch.float32,
          "fir_real: x must be (C, B) f32")
    C, B = x.shape
    taps = h.shape[-1]
    _need(h.dtype == torch.complex64 and h.ndim == 1 and taps >= 2,
          "fir_real: h must be (taps,) complex64")
    _need(carry.shape == (C, taps - 1) and carry.dtype == torch.float32,
          "fir_real: carry must be (C, taps-1) f32")
    ts = [h, carry, x]
    phase, delta = (None, 0) if nco is None else nco
    if phase is not None:
        _need(phase.shape == (C,) and phase.dtype == torch.int64,
              "fir_real: phase must be (C,) int64")
        ts.append(phase)
    _need(all(t.device == dev for t in ts), "fir_real: tensors on one device")
    _need(all(t.is_contiguous() for t in ts), "fir_real: contiguous tensors")
    fir_real_geometry(taps, B)
    lib = _fir_real_lib()
    y = torch.empty((C, B), dtype=torch.complex64, device=dev)
    new_carry = torch.empty_like(carry)
    err = lib.uhsdr_fir_real_launch(
        x.data_ptr(), C, B, carry.data_ptr(), h.data_ptr(), taps,
        1 if conj else 0, 0 if phase is None else 1,
        None if phase is None else phase.data_ptr(),
        int(delta) & nco_ops.MASK32, y.data_ptr(), new_carry.data_ptr(),
        stream_ptr(dev))
    FIR_REAL.check(err)
    FIR_REAL.launches += 1
    return y, new_carry
