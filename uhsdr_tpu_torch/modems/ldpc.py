"""LDPC (224,112) — the reference's HRA_112_112 code, bit-interoperable.

Role in the reference: `drivers/freedv/mpdecode_core.c` decodes the
HRA_112_112 LDPC code protecting FreeDV 700D frames; `HRA_112_112.c`
carries the generated code tables.  This module builds the SAME parity
check matrix from those tables (imported as data by
`tools/parse_ldpc_ref.py` into `uhsdr_tpu_torch/data/ldpc_ref.npz`):

  * H = [A | S]: A (112 x 112) from `H_rows` — laid out column-major as
    (max_row_weight=3, 112), 1-based data-bit indices per parity check;
    S = dual-diagonal "staircase" (each parity bit also checks the
    previous one), which is exactly what the reference's accumulator
    encoder produces (`mpdecode_core.c:72-93`):
        pbits[p] = (sum_i ibits[H_rows[p + i*112] - 1] + pbits[p-1]) & 1
  * codeword = [data(112) | parity(112)];
  * decoding: normalized min-sum belief propagation on H (the reference
    runs full sum-product; min-sum with alpha=0.8 decodes its built-in
    test vector `HRA_112_112_input` to `HRA_112_112_detected_data`
    exactly — see test_freedv_interop.py).

LLR convention: positive = bit 0 more likely (matches the reference's
sign handling in mpdecode).

A copy of the JAX package's NumPy module of the same name (the port
imports nothing of that package): the same arrays and decisions,
its data read from the port's own `data` package.
"""
from __future__ import annotations

import numpy as np

from .. import data as refdata

N = 224
K = 112
M = N - K


def _build_h():
    d = refdata.ldpc()
    H_rows = np.asarray(d["H_rows"]).reshape(3, K)   # H_rows[p + i*112]
    H = np.zeros((M, N), np.uint8)
    for p in range(M):
        for i in range(3):
            H[p, int(H_rows[i, p]) - 1] = 1
        H[p, K + p] = 1
        if p > 0:
            H[p, K + p - 1] = 1
    return H, H_rows


_H, _H_ROWS = _build_h()
_DATA_COLS = np.arange(K)
_CHECK_BITS = [np.nonzero(_H[m])[0] for m in range(M)]


def encode(data_bits: np.ndarray) -> np.ndarray:
    """data_bits: (K,) 0/1 -> (N,) codeword [data | parity] via the
    reference's accumulator encoder (mpdecode_core.c:72-93)."""
    d = np.asarray(data_bits, np.uint8).reshape(K)
    par = (d[_H_ROWS - 1].sum(axis=0)) & 1           # (112,) A @ d mod 2
    pbits = np.bitwise_xor.accumulate(par.astype(np.uint8))
    return np.concatenate([d, pbits])


def extract_data(codeword_bits: np.ndarray) -> np.ndarray:
    return np.asarray(codeword_bits)[..., :K]


def decode(llr: np.ndarray, max_iter: int = 50,
           alpha: float = 0.8) -> tuple[np.ndarray, bool]:
    """Normalized min-sum BP.  llr: (N,) log-likelihood ratios (positive
    = bit 0 more likely).  Returns (data_bits (K,), converged)."""
    llr = np.asarray(llr, np.float64)
    msg = [np.zeros(len(_CHECK_BITS[m])) for m in range(M)]
    total = llr.copy()
    for _ in range(max_iter):
        total = llr.copy()
        for m in range(M):
            total[_CHECK_BITS[m]] += msg[m]
        hard = (total < 0).astype(np.uint8)
        if not (_H @ hard % 2).any():
            return hard[_DATA_COLS], True
        for m in range(M):
            bits = _CHECK_BITS[m]
            ext = total[bits] - msg[m]          # bit->check messages
            sgn = np.where(ext >= 0, 1.0, -1.0)
            mag = np.abs(ext)
            prod_sgn = np.prod(sgn)
            order = np.argsort(mag)
            min1 = mag[order[0]]
            min2 = mag[order[1]] if len(mag) > 1 else min1
            newmsg = np.empty_like(ext)
            for j in range(len(bits)):
                other_min = min2 if j == order[0] else min1
                newmsg[j] = alpha * prod_sgn * sgn[j] * other_min
            msg[m] = newmsg
    hard = (total < 0).astype(np.uint8)
    return hard[_DATA_COLS], False
