"""The port's IIR lattice (`uhsdr_tpu_torch.ops.lattice.iir_lattice_block`,
on the CPU the plain version of `kernels/lattice.cu`) against the JAX
package's `iir_lattice_block` (a `lax.scan`), on the same seeded inputs:

* over three streamed blocks (the middle one ragged), state handed on,
  for the imported tables of 6, 8 and 10 stages and a made-up stable
  11-stage lattice (the imported tables have no 11);
* the reference's start value acc = x * pv[N] * 0, so that a NaN or an
  infinity in x comes out as NaN where the JAX scan has one;
* N = 0 passes x through; leading axes run as rows;
* `lattice_geometry`, the kernel's launch rule.

Tolerance: 95 dB on the outputs and 85 dB on the states.  Both sides run
the same f32 recurrence in the same order; XLA's CPU code fuses some of
its multiply-adds, which the plain version (like the kernel, built with
-fmad=false) does not, and the lattice's internal states are large sums
that carry that rounding, the most in IIR_TX_2k7_FM, whose poles sit
nearest the unit circle (measured on these inputs: outputs 101.3-132.6
dB, states 90.5-132.1 dB, IIR_TX_2k7_FM the low end of both).
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uhsdr_tpu.ops import lattice as jlat
from uhsdr_tpu_torch import data
from uhsdr_tpu_torch.cuda import lattice as lat_k
from uhsdr_tpu_torch.cuda import ring
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.ops import lattice as tlat

OUT_DB = 95.0
STATE_DB = 85.0
C = 5


def _made_up(n: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.8, 0.8, n).astype(np.float32),
            rng.uniform(-1.0, 1.0, n + 1).astype(np.float32))


TABLES = {"IIR_aa_10k": data.lattice("IIR_aa_10k"),          # 6 stages
          "IIR_8k_LPF": data.lattice("IIR_8k_LPF"),          # 8
          "IIR_2k3_1k412": data.lattice("IIR_2k3_1k412"),    # 10
          "IIR_TX_2k7_FM": data.lattice("IIR_TX_2k7_FM"),    # 10
          "made_up_11": _made_up(11)}


def _blocks(seed, lengths, scale=1000.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((C, n)) * scale).astype(np.float32)
            for n in lengths]


@pytest.mark.parametrize("name", sorted(TABLES))
def test_lattice_matches_jax_streamed(name):
    pk, pv = TABLES[name]
    N = len(pk)
    assert N in (6, 8, 10, 11)
    js = jnp.zeros((C, N), jnp.float32)
    ts = tlat.init_state((C,), N)
    for k, x in enumerate(_blocks(1, (600, 333, 600))):
        yj, js = jlat.iir_lattice_block(pk, pv, js, jnp.asarray(x))
        yt, ts = tlat.iir_lattice_block(pk, pv, ts, torch.from_numpy(x))
        s_out, s_state = snr_db(np.asarray(yj), yt), snr_db(np.asarray(js),
                                                             ts)
        print(f"\n{name} (N={N}) block {k}: y {s_out:.1f} dB, state "
              f"{s_state:.1f} dB")
        assert yt.shape == x.shape and ts.shape == (C, N)
        assert s_out >= OUT_DB and s_state >= STATE_DB, (k, s_out, s_state)


def test_nan_and_inf_start_value():
    """acc starts at x * pv[N] * 0: a NaN or an infinity in x gives NaN in
    the output where the JAX scan gives one, and the rest of the rows are
    untouched."""
    pk, pv = TABLES["IIR_2k3_1k412"]
    x = _blocks(2, (64,))[0]
    x[1, 5] = math.nan
    x[2, 7] = math.inf
    x[3, 9] = -math.inf
    s0 = np.zeros((C, len(pk)), np.float32)
    yj, sj = jlat.iir_lattice_block(pk, pv, jnp.asarray(s0), jnp.asarray(x))
    yt, st = tlat.iir_lattice_block(pk, pv, torch.from_numpy(s0),
                                    torch.from_numpy(x))
    yj = np.asarray(yj)
    np.testing.assert_array_equal(np.isnan(yj), np.isnan(yt.numpy()))
    np.testing.assert_array_equal(np.isnan(np.asarray(sj)),
                                  np.isnan(st.numpy()))
    assert np.isnan(yt.numpy()[1:4]).any(axis=-1).all()
    assert snr_db(yj[[0, 4]], yt.numpy()[[0, 4]]) >= OUT_DB


def test_zero_stages_and_leading_axes():
    x = torch.from_numpy(_blocks(3, (50,))[0])
    s = torch.zeros((C, 0))
    y, s2 = tlat.iir_lattice_block(np.zeros(0), np.zeros(1), s, x)
    assert y is x and s2 is s
    pk, pv = TABLES["IIR_aa_10k"]
    x3 = x.reshape(C, 1, 50).expand(C, 2, 50).contiguous()
    y3, s3 = tlat.iir_lattice_block(pk, pv, tlat.init_state((C, 2), 6), x3)
    y2, s2 = tlat.iir_lattice_block(pk, pv, tlat.init_state((C,), 6), x)
    assert y3.shape == (C, 2, 50) and s3.shape == (C, 2, 6)
    assert torch.equal(y3[:, 1], y2) and torch.equal(s3[:, 0], s2)


@pytest.mark.parametrize("C_,T,N", [(1, 1, 1), (32, 32, 6), (33, 31, 10),
                                    (8192, 4096, 10), (8192, 16384, 10),
                                    (5, 1000, 12)])
def test_lattice_geometry(C_, T, N):
    """Four walker warps a block on the tile ring, a row a lane: the
    blocks cover every row once and the tiles every sample once
    (tests/test_torch_lattice_geometry.py checks the rule itself)."""
    g = lat_k.lattice_geometry(C_, T, N)
    assert g.rows == ring.WALKERS * g.lanes
    assert (g.blocks - 1) * g.rows < C_ <= g.blocks * g.rows
    assert (g.tiles - 1) * ring.TILE < T <= g.tiles * ring.TILE
    assert g.smem == ring.STAGES * g.rows * (ring.TILE + 4) * 4 <= 227 * 1024


@pytest.mark.parametrize("C_,T,N", [(4, 10, 0), (4, 10, 13), (0, 10, 6),
                                    (4, 0, 6)])
def test_lattice_geometry_refuses(C_, T, N):
    with pytest.raises(ValueError, match="lattice"):
        lat_k.lattice_geometry(C_, T, N)
