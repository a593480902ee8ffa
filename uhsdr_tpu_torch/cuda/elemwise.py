"""K12 (the FM discriminator): wrapper around the hand-written kernel
`kernels/fm_disc.cu`, beside its plain torch version.

The wrapper takes the plain version only for tensors on the CPU.  For
CUDA tensors it checks device, dtype, shape and contiguity, launches the
kernel on the current stream (building it on first use), raises if the
launch failed, and adds one to ``FM_DISC.launches``.  There is no
fallback.

Replaces uhsdr_tpu/pallas/elemwise.py::_disc_kernel (:25), entered from
`fm_disc_pallas` (:41) at demod/fm.py:155.  The angle is ``atan2``, not
the polynomial the TPU kernel carries for want of an atan2 primitive: the
plain version is then the CPU reference's arithmetic, and the kernel's
`atan2f` is within a few ulp of it (an angle at the branch cut may come
out as +pi on one side and -pi on the other).  On the card the kernel is
bound by its bytes; see the note in the source.
"""
from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int

FM_DISC = CudaKernel("fm_disc", "fm_disc.cu", {
    "uhsdr_fm_disc_launch": ([_I, _P, _P, _P, _I, _I, _P, _P], _I),
}, extra_flags=("-fmad=false",))


def fm_disc_plain(z_prev, z):
    """Plain torch version of K12: ``atan2(Im, Re)`` of conj(z[n-1]) z[n]
    with z[-1] = z_prev, the product formed on the planes."""
    zr, zi = z if isinstance(z, tuple) else (z.real, z.imag)
    dr = torch.cat([z_prev.real[..., None], zr[..., :-1]], dim=-1)
    di = torch.cat([z_prev.imag[..., None], zi[..., :-1]], dim=-1)
    return torch.atan2(dr * zi - di * zr, dr * zr + di * zi)


def fm_disc(z_prev, z):
    """The FM discriminator (K12).  z_prev: (C,) complex64, the sample
    before the block; z: the (C, T) complex64 block or its (real, imag)
    f32 planes.  Returns the angle (C, T) f32 in [-pi, pi]."""
    zr = z[0] if isinstance(z, tuple) else z
    if zr.device.type == "cpu":
        return fm_disc_plain(z_prev, z)
    dev = zr.device
    if zr.ndim != 2 or zr.shape[-1] < 1:
        raise ValueError("fm_disc: z must be (C, T), T >= 1")
    C, T = zr.shape
    if isinstance(z, tuple):
        ts = z
        ok = all(t.dtype == torch.float32 and t.shape == (C, T) for t in z)
    else:
        ts = (z,)
        ok = z.dtype == torch.complex64
    if not ok or z_prev.dtype != torch.complex64 or z_prev.shape != (C,):
        raise ValueError("fm_disc: z complex64 (C, T) or two f32 planes, "
                         "z_prev (C,) complex64")
    if any(t.device != dev or not t.is_contiguous() for t in ts + (z_prev,)):
        raise ValueError("fm_disc: contiguous tensors on one device")
    out = torch.empty((C, T), dtype=torch.float32, device=dev)
    err = FM_DISC.lib().uhsdr_fm_disc_launch(
        1 if isinstance(z, tuple) else 0, ts[0].data_ptr(),
        ts[1].data_ptr() if len(ts) > 1 else None, z_prev.data_ptr(), C, T,
        out.data_ptr(), stream_ptr(dev))
    FM_DISC.check(err)
    FM_DISC.launches += 1
    return out
