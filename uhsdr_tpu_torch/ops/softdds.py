"""Vectorized soft-DDS synthesis (the firmware's `softdds/softdds.c`).

The reference synthesizes every TX tone (CW sidetone, RTTY AFSK pair,
PSK carrier and envelope, FM subtone/beeps) from ONE 10-bit int16 sine
table driven by a 32-bit phase accumulator:

    step = (uint64)(freq * 1024) << 22 / samp_rate
    k    = (acc >> 22) % 1024;  acc += step          (uint32 wrap)

`ops/nco.py` is the clean float NCO used by the compute chains; this
module reproduces the table-DDS *bit-exactly* but vectorized (the whole
index sequence as one modular-arithmetic array op), so text-mode TX
paths emit waveforms identical to the firmware's — including its phase-
truncation spurs, which the TX conformance oracle
(tests/golden/ref_tx.py `SoftDds`) replicates scalar-for-scalar.

A copy of the JAX package's NumPy module of the same name (the port
imports nothing of that package); the table is the port's copy, `data.array("dds_table")`.
"""
from __future__ import annotations

import numpy as np

from .. import data

DDS_TBL_SIZE = 1024
ACC_SHIFT = 22                       # 32 - DDS_TBL_BITS
_U32 = np.uint64(0xFFFFFFFF)


def table() -> np.ndarray:
    """The imported DDS_TABLE (1024,) int16 sine."""
    return np.asarray(data.array("dds_table"), np.int64)


def step_for(freq: float, samp_rate: int) -> int:
    """softdds_stepForSampleRate: note the float product truncates to an
    integer BEFORE the 22-bit shift."""
    return (int(freq * DDS_TBL_SIZE) << ACC_SHIFT) // int(samp_rate)


def indices(acc0: int, step: int, n: int) -> np.ndarray:
    """Table indices for n successive samples from accumulator acc0.
    Returns (idx (n,), acc_after)."""
    accs = (np.uint64(acc0) + np.uint64(step) * np.arange(n, dtype=np.uint64)
            ) & _U32
    acc_after = int((np.uint64(acc0) + np.uint64(step) * np.uint64(n)) & _U32)
    return (accs >> np.uint64(ACC_SHIFT)).astype(np.int64) % DDS_TBL_SIZE, \
        acc_after


def samples(acc0: int, step: int, n: int):
    """(sine (n,) int64, acc_after) — softdds_nextSample vectorized."""
    idx, acc = indices(acc0, step, n)
    return table()[idx], acc


def samples_iq(acc0: int, step: int, n: int):
    """(i, q, acc_after): i = sin, q = cos (index + 3N/4) —
    softdds_genIQSingleTone vectorized."""
    idx, acc = indices(acc0, step, n)
    t = table()
    return t[idx], t[(idx + 3 * DDS_TBL_SIZE // 4) % DDS_TBL_SIZE], acc
