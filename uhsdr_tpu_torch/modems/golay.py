"""Golay (23,12) perfect error-correcting code.

Role in the reference: `drivers/freedv/golay23.c` protects the scalar
(non-LSP-VQ) bits of the Codec2 1300/1600 frame in FreeDV mode 1600.
This is an independent implementation: systematic encoding with the
standard generator polynomial x^11+x^10+x^6+x^5+x^4+x^2+1 (0xC75) and
table-free syndrome decoding via the perfect-code property (every
syndrome corresponds to a unique error pattern of weight <= 3).

Vectorized over codeword batches with numpy (bit-twiddling is host-side
work; the modem soft bits come off-device as f32).

A copy of the JAX package's NumPy module of the same name (the port
imports nothing of that package): the same arrays and decisions,
its data read from the port's own `data` package.
"""
from __future__ import annotations

import numpy as np

N = 23
K = 12
POLY = 0xC75          # degree-11 generator polynomial


def _mod_poly(v: int) -> int:
    """Residue of v modulo POLY over GF(2)."""
    for bit in range(22, 10, -1):
        if v & (1 << bit):
            v ^= POLY << (bit - 11)
    return v


# --- precomputed tables (cheap: 4096-entry parity, 2048-entry syndrome) ---

_PARITY = np.array([_mod_poly(d << 11) for d in range(1 << K)],
                   dtype=np.int64)

# syndrome -> error pattern (perfect code: all 2^11 syndromes are covered
# by error patterns of weight <= 3)
_ERR_FOR_SYNDROME = np.zeros(1 << 11, dtype=np.int64)
_seen = np.zeros(1 << 11, dtype=bool)
_patterns = [0]
for i in range(N):
    _patterns.append(1 << i)
for i in range(N):
    for j in range(i + 1, N):
        _patterns.append((1 << i) | (1 << j))
for i in range(N):
    for j in range(i + 1, N):
        for k in range(j + 1, N):
            _patterns.append((1 << i) | (1 << j) | (1 << k))
for e in _patterns:
    s = _mod_poly(e)
    if not _seen[s]:
        _seen[s] = True
        _ERR_FOR_SYNDROME[s] = e
assert _seen.all(), "Golay syndrome table incomplete"
del _seen, _patterns


def encode(data: np.ndarray) -> np.ndarray:
    """data: (...,) ints in [0, 4096) -> (...,) 23-bit codewords
    (data in bits 22..11, parity in bits 10..0, systematic)."""
    d = np.asarray(data, dtype=np.int64)
    return (d << 11) | _PARITY[d]


def decode(received: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """received: (...,) 23-bit words -> (data, n_corrected)."""
    r = np.asarray(received, dtype=np.int64)
    # syndrome of r: since code = {v : v mod POLY == 0} for systematic
    # encoding v = (d<<11) ^ parity(d), syndrome = r mod POLY
    syn = np.zeros_like(r)
    v = r.copy()
    for bit in range(22, 10, -1):
        mask = (v >> bit) & 1
        v ^= (mask * (POLY << (bit - 11)))
    syn = v
    err = _ERR_FOR_SYNDROME[syn]
    corrected = r ^ err
    ncorr = np.zeros_like(r)
    e = err.copy()
    for _ in range(N):
        ncorr += e & 1
        e >>= 1
    return corrected >> 11, ncorr


def encode_bits(bits: np.ndarray) -> np.ndarray:
    """bits: (..., 12) 0/1 -> (..., 23) 0/1 (MSB-first)."""
    b = np.asarray(bits)
    weights = 1 << np.arange(K - 1, -1, -1)
    words = encode((b * weights).sum(axis=-1))
    out_w = 1 << np.arange(N - 1, -1, -1)
    return ((words[..., None] & out_w) > 0).astype(b.dtype)


def decode_bits(bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """bits: (..., 23) 0/1 -> ((..., 12) 0/1, n_corrected)."""
    b = np.asarray(bits)
    weights = 1 << np.arange(N - 1, -1, -1)
    data, ncorr = decode((b * weights).sum(axis=-1))
    out_w = 1 << np.arange(K - 1, -1, -1)
    return ((data[..., None] & out_w) > 0).astype(b.dtype), ncorr
