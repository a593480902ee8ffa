"""IIR lattice ARMA filter — the `arm_iir_lattice_f32` analog, the torch
counterpart of `uhsdr_tpu.ops.lattice`.

The reference chain's PreFilter and anti-alias lattices and the FM TX
voice bandpass run the exact recurrence (`iir_lattice_block`, on the card
the hand-written kernel `cuda.lattice.lattice`); the scalar NumPy port
`iir_lattice_ref` is what `ops.latconv` identifies transfer functions
from.  The CMSIS-DSP recurrence (arm_iir_lattice_f32.c scalar path):

    f = x[n]
    for m in 0..N-1:            # pk stored stage-reversed (k_N first)
        g_old    = state[m]
        f        = f - pk[m] * g_old
        g_new[m] = f * pk[m] + g_old
        acc     += g_new[m] * pv[m]
    y[n]  = acc + f * pv[N]
    state = [g_new[1], ..., g_new[N-1], f]      # one-slot shift
"""
from __future__ import annotations

import numpy as np
import torch

from ..cuda import lattice as lattice_k


def init_state(batch_shape, num_stages: int, device=None) -> torch.Tensor:
    return torch.zeros(tuple(batch_shape) + (num_stages,),
                       dtype=torch.float32, device=device)


def iir_lattice_block(pk: np.ndarray, pv: np.ndarray, state: torch.Tensor,
                      x: torch.Tensor):
    """x: (..., B) f32; state: (..., N) f32.  Returns (y, new_state).
    pk (N,) / pv (N+1,) in CMSIS storage order, as `data.lattice` gives
    them; N = 0 passes x through.  The leading axes run as rows of one
    launch."""
    if np.asarray(pk).shape[0] == 0:
        return x, state
    lead = x.shape[:-1]
    N = state.shape[-1]
    y, s = lattice_k.lattice(pk, pv, state.reshape(-1, N).contiguous(),
                             x.reshape(-1, x.shape[-1]).contiguous())
    return y.reshape(x.shape), s.reshape(lead + (N,))


def iir_lattice_ref(pk, pv, x, state=None, dtype=np.float64):
    """Scalar NumPy lattice.  Returns (y, final_state)."""
    pk = np.asarray(pk, dtype)
    pv = np.asarray(pv, dtype)
    N = len(pk)
    g = np.zeros(N, dtype) if state is None \
        else np.asarray(state, dtype).copy()
    y = np.empty(len(x), dtype)
    for n, xn in enumerate(np.asarray(x, dtype)):
        f = xn
        acc = 0.0
        new_g = np.empty(N + 1, dtype)
        for m in range(N):
            g_old = g[m]
            f = f - pk[m] * g_old
            gn = f * pk[m] + g_old
            acc += gn * pv[m]
            new_g[m] = gn
        acc += f * pv[N]
        new_g[N] = f
        g = new_g[1:]
        y[n] = acc
    return y, g
