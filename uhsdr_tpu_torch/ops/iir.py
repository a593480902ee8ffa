"""Biquad cascades (the PreFilter lattice as SOS, the EQ shelves) and the
first-order smoothers (fade leveler, AGC DC blocker) in plain torch.

Two cascade forms of `uhsdr_tpu.ops.iir`:

* `biquad_cascade_block`: the DF2T recurrence sample by sample — the
  sequential definition, for blocks the blocked form cannot chunk;
* `biquad_cascade_blocked`: the whole cascade as one LTI system in
  R-sample chunks — two (..., n, R) @ (R, ·) matmuls plus the exact
  sequential chunk carry u[c] = F u[c-1] + s_in[c] over n (2S, 2S)
  matvecs (the reference's ``exact_carry=True``; ~129 dB on the high-Q
  lattice SOS where the dilated F-power pass holds ~52 dB).

`one_pole_block` (and `dc_blocker_block` on top of it) computes the
recurrence as two Toeplitz matmuls: within R-sample chunks, and across
the chunk ends (see `one_pole_block`).

The JAX package runs all of these in XLA outside any Pallas kernel
(ops/iir.py:232-239, :255-343).  On the card the chains' cascades run on
kernels (`cuda/iir.py::cascade_dispatch`: K2, whose plain version is
`biquad_cascade_blocked`, and K11); the smoothers' matmuls go to
`torch.matmul` (float32).  On the card the matmuls refuse to run with
TF32 on: the high-Q lattice SOS and the r = 0.9999 DC blocker would lose
their exactness silently.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import steps

R_CHUNK = 128


@functools.lru_cache(maxsize=None)
def _cascade_blocked_tables(sos_key: tuple, R: int):
    """Whole-CASCADE chunk tables (f64 host simulation; a copy of
    uhsdr_tpu/ops/iir.py:89-126).  Basis = R input impulses + 2S unit
    section-states; record the cascade output y and every section's end
    state.

      M  (R, R):   zero-state Toeplitz of the cascade impulse response
      HS (2S, R):  y response to each unit section-state
      G  (R, 2S):  all end states from an impulse at position r
      F  (2S, 2S): all end states from each unit section-state
    """
    sos = np.asarray(sos_key, np.float64).reshape(-1, 5)
    S = sos.shape[0]
    B = R + 2 * S
    xb = np.zeros((B, R))
    xb[:R] = np.eye(R)
    st = np.zeros((B, S, 2))
    for j in range(2 * S):
        st[R + j, j // 2, j % 2] = 1.0
    ys = np.empty((B, R))
    for n in range(R):
        sig = xb[:, n].copy()
        for k in range(S):
            b0, b1, b2, a1, a2 = sos[k]
            y = b0 * sig + st[:, k, 0]
            st[:, k, 0] = b1 * sig - a1 * y + st[:, k, 1]
            st[:, k, 1] = b2 * sig - a2 * y
            sig = y
        ys[:, n] = sig
    ends = st.reshape(B, 2 * S)
    h = ys[0]
    idx = np.arange(R)
    M = np.where(idx[None, :] >= idx[:, None],
                 h[np.clip(idx[None, :] - idx[:, None], 0, R - 1)], 0.0)
    return (M.astype(np.float32), ys[R:].astype(np.float32),
            ends[:R].astype(np.float32), ends[R:].T.astype(np.float32))


class Cascade(NamedTuple):
    """A static SOS cascade with its blocked-form tables, resident on one
    device (built once per chain by `cascade`)."""
    sos: torch.Tensor      # (S, 5) f32 [b0 b1 b2 a1 a2]
    M: torch.Tensor        # (R, R)
    HS: torch.Tensor       # (2S, R)
    G: torch.Tensor        # (R, 2S)
    Ft: torch.Tensor       # (2S, 2S), F transposed

    @property
    def sections(self) -> int:
        return self.sos.shape[0]


def cascade(sos: np.ndarray, device, R: int = R_CHUNK) -> Cascade:
    """(S, 5) numpy SOS -> `Cascade` on `device`.  The tables are built
    from the f32-rounded coefficients, as the reference builds them from
    its f32 RxParams arrays."""
    sos_np = np.asarray(sos, np.float32).reshape(-1, 5)
    dev = torch.device(device)
    t = functools.partial(torch.as_tensor, device=dev)
    if sos_np.shape[0] == 0:
        z = torch.zeros((0, 0), dtype=torch.float32, device=dev)
        return Cascade(t(sos_np), z, z, z, z)
    M, HS, G, F = _cascade_blocked_tables(
        tuple(np.asarray(sos_np, np.float64).reshape(-1).tolist()), R)
    return Cascade(t(sos_np), t(M), t(HS), t(G),
                   t(np.ascontiguousarray(F.T)))


def need_fp32_matmul(x: torch.Tensor, what: str):
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"{what} needs FP32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")


def biquad_cascade_blocked(c: Cascade, state: torch.Tensor, x: torch.Tensor):
    """Blocked-matmul cascade with the exact sequential chunk carry.
    state (S, ..., 2) per-section DF2T states; x (..., T), T % R == 0.
    Returns (y, new_state)."""
    S = c.sections
    R = c.M.shape[0]
    T = x.shape[-1]
    n = T // R
    if T % R:
        raise ValueError(f"T={T} is not a multiple of the chunk {R}")
    need_fp32_matmul(x, "biquad_cascade_blocked")
    lead = x.shape[:-1]
    s_vec = torch.movedim(state, 0, -2).reshape(lead + (2 * S,)).to(x.dtype)
    xc = x.reshape(lead + (n, R))
    y_loc = xc @ c.M                                  # (..., n, R)
    s_in = xc @ c.G                                   # (..., n, 2S)
    u = []
    prev = s_vec
    for i in range(n):
        prev = s_in[..., i, :] + prev @ c.Ft
        u.append(prev)
    u = torch.stack(u, dim=-2)                        # (..., n, 2S)
    prevs = torch.cat([s_vec[..., None, :], u[..., :-1, :]], dim=-2)
    y = y_loc + prevs @ c.HS
    new_state = torch.movedim(u[..., -1, :].reshape(lead + (S, 2)), -2, 0)
    return y.reshape(x.shape), new_state.contiguous()


def biquad_cascade_block(sos: torch.Tensor, state: torch.Tensor,
                         x: torch.Tensor):
    """Sequential DF2T cascade, sample by sample.  sos (S, 5);
    state (S, ..., 2).  y = b0 x + s1; s1' = b1 x - a1 y + s2;
    s2' = b2 x - a2 y."""
    S = sos.shape[0]
    if S == 0:
        return x, state
    ys = x.unbind(-1)
    new_states = []
    for k in range(S):
        b0, b1, b2, a1, a2 = sos[k].unbind(-1)
        s1, s2 = state[k, ..., 0], state[k, ..., 1]
        out = []
        for xn in ys:
            y = b0 * xn + s1
            s1, s2 = b1 * xn - a1 * y + s2, b2 * xn - a2 * y
            out.append(y)
        ys = out
        new_states.append(torch.stack([s1, s2], dim=-1))
    return torch.stack(ys, dim=-1), torch.stack(new_states, dim=0)


def biquad_block(coeffs, state: torch.Tensor, x: torch.Tensor):
    """One DF2T biquad over a block, sample by sample: the plain version
    of the digital modems' filters (`cuda/psk.py`, `cuda/rtty.py`), not
    the JAX package's dilated scan (uhsdr_tpu/ops/iir.py:31-80), from
    which it parts at f32 rounding.  coeffs (5,) [b0 b1 b2 a1 a2]
    (NumPy, a sequence or a tensor); state (..., 2) [s1, s2]; x (..., T)
    f32, T >= 1.  y = b0 x + s1; s1' = b1 x - a1 y + s2; s2' = b2 x - a2 y
    (`ops/steps.py::scan`).  Returns (y (..., T), new_state (..., 2))."""
    if isinstance(coeffs, torch.Tensor):
        coeffs = coeffs.detach().cpu().numpy()
    b0, b1, b2, a1, a2 = steps.consts(
        np.asarray(coeffs, np.float32).reshape(5), x.device.type == "cpu")

    def step(carry, xs):
        s1, s2 = carry
        (xn,) = xs
        y = b0 * xn + s1
        return (b1 * xn - a1 * y + s2, b2 * xn - a2 * y), (y,)

    T = x.shape[-1]
    st = state.reshape(-1, 2)
    (s1, s2), (y,) = steps.scan(step, (st[:, 0].contiguous(),
                                       st[:, 1].contiguous()),
                                (x.reshape(-1, T),))
    return y.reshape(x.shape), torch.stack([s1, s2], -1).reshape(state.shape)


@functools.lru_cache(maxsize=64)
def _one_pole_tables(a: float, b: float, R: int, n: int, device: str):
    """Tables of the two-level one-pole, from float64 powers of a:
      M  (R, R):   b * a^(s-r) for s >= r, the zero-state response inside
                   a chunk (input r along rows, output s along columns)
      L  (n, n):   (a^R)^(c-k) for c >= k, the same across chunk ends
      ap (R,):     a^(s+1), what a carried value adds inside a chunk
      aq (n,):     (a^R)^(c+1), what the incoming state adds to chunk ends
    """
    def lower(q, m, gain):
        idx = np.arange(m)
        e = idx[None, :] - idx[:, None]
        return np.where(e >= 0, gain * np.power(q, np.clip(e, 0, None)), 0.0)

    a64 = np.float64(a)
    aR = a64 ** R
    t = functools.partial(torch.as_tensor, device=torch.device(device))
    return (t(lower(a64, R, np.float64(b)).astype(np.float32)),
            t(lower(aR, n, 1.0).astype(np.float32)),
            t(np.power(a64, np.arange(1, R + 1)).astype(np.float32)),
            t(np.power(aR, np.arange(1, n + 1)).astype(np.float32)))


@functools.lru_cache(maxsize=64)
def decay_table(a: float, T: int, device: str) -> torch.Tensor:
    """(T,) f32 powers a^1 .. a^T on `device`, taken in float64 and rounded
    once; cached, so a stream's blocks cost no host-to-device copy."""
    return torch.as_tensor(
        np.power(np.float64(a), np.arange(1, T + 1)).astype(np.float32),
        device=torch.device(device))


def one_pole_block(a: float, b: float, state: torch.Tensor, x: torch.Tensor,
                   R: int = R_CHUNK):
    """First-order recurrence y[n] = a*y[n-1] + b*x[n] with scalar a, b
    (the reference's `one_pole_block`, ops/iir.py:302).  state (...,) is
    y[-1]; x (..., T) real.  Returns (y (..., T), y[..., -1]).

    Computed as a blocked matmul on two levels, with no loop over time:
    inside R-sample chunks the zero-state response is one lower-triangular
    Toeplitz product x @ M; the chunk-end values u[c] = a^R u[c-1] +
    y_loc[c, -1] are a second Toeplitz product over the n = T/R chunk
    ends; each chunk then adds a^(s+1) times the value carried into it.
    All powers of a are taken in float64 and rounded once.  T need not
    be a multiple of R: the block is zero-padded on the right and the
    state read at T-1."""
    if np.ndim(a) or np.ndim(b):
        raise ValueError("one_pole_block takes scalar coefficients")
    if x.is_complex():
        raise ValueError("one_pole_block takes real input")
    need_fp32_matmul(x, "one_pole_block")
    T = x.shape[-1]
    n = -(-T // R)
    M, L, ap, aq = _one_pole_tables(float(a), float(b), R, n, str(x.device))
    lead = x.shape[:-1]
    xp = torch.nn.functional.pad(x, (0, n * R - T)) if n * R != T else x
    y_loc = xp.reshape(lead + (n, R)) @ M                    # (..., n, R)
    s0 = state.to(x.dtype)[..., None]                        # (..., 1)
    u = y_loc[..., -1] @ L + s0 * aq                         # (..., n)
    prev = torch.cat([s0, u[..., :-1]], dim=-1)              # carried in
    y = (y_loc + prev[..., None] * ap).reshape(lead + (n * R,))[..., :T]
    return y, y[..., -1].contiguous()


def dc_blocker_block(r: float, state: torch.Tensor, x: torch.Tensor):
    """One-pole DC removal y[n] = x[n] - x[n-1] + r*y[n-1] (the AGC's
    AM/SAM DC blocker, `audio_agc.c:577-594`, r = 0.9999; the reference's
    `dc_blocker_block`, ops/iir.py:333).  state: (..., 2) = [x_prev,
    y_prev].  Returns (y, new_state)."""
    xd = torch.cat([state[..., 0:1].to(x.dtype), x], dim=-1)
    diff = xd[..., 1:] - xd[..., :-1]
    y, y_last = one_pole_block(float(r), 1.0, state[..., 1], diff)
    return y, torch.stack([x[..., -1], y_last], dim=-1)
