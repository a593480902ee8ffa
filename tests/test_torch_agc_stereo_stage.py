"""The linked stereo AGC stage (`cuda/agc.py::agc_stereo`, one launch on
the card for the iq, ssbstereo and SAM stereo modes) on the CPU, where it
runs its plain version `agc_stereo_plain`:

* against the JAX package's `run_stereo` (`uhsdr_tpu/ops/agc.py:287`)
  over three streamed blocks with the state carried, at 12 kHz (w 48)
  and 24 kHz (w 96), with scalar settings and with a threshold per
  channel (the (3, C) rows), output and every leaf at
  tests/test_torch_stereo.py's bound (85 dB: the back-averages drift
  apart, ROADMAP section C);
* bit for bit against the torch route `ops/agc.py::run_stereo` ran
  before the stage (the concatenation, abs().amax(), the look-ahead max,
  K13's plain walk with its (2, C) rows, the gain law, the product), on
  random input and on an edge stream (+-0, +-inf, a NaN in one plane of
  a channel, subnormals), the new delay line a tensor of its own;
* `run_stereo` on CPU tensors is the plain stage, its state's delay line
  a tensor of its own;
* the launch rules of the stage (`agc_stereo_geometry`) and of K13
  (`agc_scan_geometry`): shared memory within an H100's 227 KB a block,
  blocks an SM at w 48, 96 and 192, and what they refuse.
The card holds the kernels to these plain versions bit for bit
(tests/test_torch_cuda.py, chip_smoke.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uhsdr_tpu.ops import agc as jagc
from uhsdr_tpu_torch import trace_agc
from uhsdr_tpu_torch.cuda import agc as agc_k
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.ops import agc as tagc

AGC_DB = 85.0
C, T = 16, 1024
SMEM_BLOCK = 227 * 1024


def _gated(rng, blk: int, fs: float, n_ch: int = C) -> np.ndarray:
    """(n_ch, 2, T): 700 Hz and 1100 Hz bursts at -20 ... +80 dB re 1,
    gated on and off with periods across channels, plus noise, so that
    the machine walks its states."""
    c = np.arange(n_ch)[:, None]
    n = np.arange(blk * T, (blk + 1) * T)
    gate = (n[None, :] // (64 + 48 * (c % 16))) % 3 == 0
    lv = np.logspace(-1, 4, n_ch)[:, None]
    x = np.stack([lv * np.sin(2 * np.pi * 700 * n / fs) * gate,
                  0.5 * lv * np.cos(2 * np.pi * 1100 * n / fs)
                  * gate[:, ::-1]], axis=1)
    return (x + rng.standard_normal(x.shape) * 0.5).astype(np.float32)


def _edges(rng, blk: int, fs: float) -> np.ndarray:
    """_gated with edges on some channels: +-0 runs, +-inf, a NaN in one
    plane of a channel, subnormals (IEEE in both versions here)."""
    x = _gated(rng, blk, fs)
    x[1, 0, 100:140] = 0.0
    x[1, 1, 100:140] = -0.0
    x[3, 1, 200] = np.inf
    x[5, 0, 300] = -np.inf
    x[7, 1, 400] = np.nan
    x[9, :, 500:600] = np.float32(1e-42) * rng.standard_normal((2, 100))
    x[11, 0, 10:20] = np.float32(-2e-45)
    return x


def _params(mod, fs: float, rows: bool):
    th = np.linspace(40.0, 80.0, C) if rows else 60.0
    return mod.make_params(fs, mode="med", hang_enable=True, thresh_db=th)


def _rows(tp, rows: bool):
    kp = tagc.kernel_params(tp, C)
    return kp, (torch.from_numpy(kp.rows) if rows else None)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bits, a NaN matching a NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return (a.shape == b.shape and torch.equal(na, nb)
            and torch.equal(a[~na].view(torch.int32),
                            b[~nb].view(torch.int32)))


@pytest.mark.parametrize("fs", [12000.0, 24000.0])
@pytest.mark.parametrize("rows", [False, True])
def test_plain_stage_matches_jax_run_stereo(fs, rows):
    jp, tp = _params(jagc, fs, rows), _params(tagc, fs, rows)
    kp, rt = _rows(tp, rows)
    assert tp.attack_buffsize == {12000.0: 48, 24000.0: 96}[fs]
    js = jagc.init_state_stereo((C,), jp)
    run = jax.jit(lambda s, x: jagc.run_stereo(jp, s, x))
    carry = torch.zeros((agc_k.N_CARRY, C))
    delay = torch.zeros((C, 2, tp.attack_buffsize))
    rng = np.random.default_rng(int(fs) + rows)
    for blk in range(3):
        x = _gated(rng, blk, fs)
        yj, js = run(js, jnp.asarray(x))
        y, carry, delay = agc_k.agc_stereo(kp.scalars, carry, delay,
                                           torch.from_numpy(x), rt)
        leaves = {f: snr_db(np.asarray(getattr(js, f)), carry[i])
                  for i, f in enumerate(tagc.CARRY_FIELDS)}
        leaves["delay"] = snr_db(np.asarray(js.delay), delay)
        leaves["audio"] = snr_db(np.asarray(yj), y)
        low = min(leaves, key=leaves.get)
        print(f"\nstage fs {fs:.0f} rows {rows} block {blk}: audio "
              f"{leaves['audio']:.1f} dB, worst {low} {leaves[low]:.1f}")
        assert leaves[low] >= AGC_DB, leaves
        assert delay.untyped_storage().nbytes() == 4 * delay.numel()


@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("edges", [False, True])
def test_plain_stage_is_the_route_it_replaces(rows, edges):
    tp = _params(tagc, 12000.0, rows)
    kp, rt = _rows(tp, rows)
    r2 = None if rt is None else torch.from_numpy(kp.scan_rows)
    rng = np.random.default_rng(40 + 2 * rows + edges)
    c_s = c_r = torch.zeros((agc_k.N_CARRY, C))
    d_s = d_r = torch.zeros((C, 2, tp.attack_buffsize))
    for blk, n in enumerate((T, 33, T)):
        x = (_edges if edges else _gated)(rng, blk, 12000.0)[..., :n]
        x = torch.from_numpy(np.ascontiguousarray(x))
        y_s, c_s, d_s = agc_k.agc_stereo_plain(kp.scalars, c_s, d_s, x, rt)
        # the route run_stereo ran around K13 before the stage (on CPU
        # tensors K13's plain walk)
        y_r, c_r, d_r = trace_agc.replaced_route(kp.scalars, c_r, d_r, x,
                                                 rt, r2)
        assert _same(y_r, y_s) and _same(c_r, c_s) and _same(d_r, d_s)
        assert d_s.untyped_storage().nbytes() == 4 * d_s.numel()
    if edges:
        assert torch.isnan(y_s[7]).all() and torch.isfinite(y_s[0]).all()


def test_run_stereo_on_cpu_is_the_plain_stage():
    tp = _params(tagc, 24000.0, True)
    kp, rt = _rows(tp, True)
    s = tagc.init_state_stereo((C,), tp)
    carry = torch.zeros((agc_k.N_CARRY, C))
    delay = s.delay
    rng = np.random.default_rng(41)
    for blk in range(2):
        x = torch.from_numpy(_gated(rng, blk, 24000.0))
        y, s = tagc.run_stereo(tp, s, x)
        yp, carry, delay = agc_k.agc_stereo_plain(kp.scalars, carry, delay,
                                                  x, rt)
        assert torch.equal(y, yp) and torch.equal(s.delay, delay)
        for i, f in enumerate(tagc.CARRY_FIELDS):
            assert torch.equal(getattr(s, f), carry[i]), f
        assert s.delay.untyped_storage().nbytes() == 4 * C * 2 * 96


@pytest.mark.parametrize("w,blocks", [(48, 2), (96, 2), (192, 1)])
def test_stereo_launch_rule(w, blocks):
    """Blocks an SM at the chains' look-aheads: 12 kHz, 24 kHz, 48 kHz."""
    g = agc_k.agc_stereo_geometry(8192, 2048, w)
    k3 = agc_k.agc_geometry(8192, 2048, w)
    assert g.sm_blocks == blocks and g.smem <= SMEM_BLOCK
    assert (g.ring, g.ring_stride, g.h_stride) == (k3.ring, k3.ring_stride,
                                                    k3.h_stride)
    # the stage's planes (3 of CB rows) and the ring's second plane are
    # what it adds to K3's buffers
    row = 4 * agc_k.AGC_CB * (agc_k.AGC_TILE + 1)
    assert g.smem - k3.smem == (agc_k.AGC_STAGES * row
                                + 4 * agc_k.AGC_CB * k3.ring_stride)
    assert (g.grid, g.tiles, g.threads) == (256, 64, agc_k.AGC_THREADS)
    assert agc_k.agc_stereo_geometry(8192, 2048, w, rows=True) == g


def test_stereo_launch_rule_over_every_window():
    for w in range(1, agc_k.AGC_MAXW + 1):
        g = agc_k.agc_stereo_geometry(33, 100, w)
        assert g.smem <= SMEM_BLOCK and g.sm_blocks >= 1
        assert g.sm_blocks == (2 if w <= 96 else 1), w
        assert g.grid == 2 and g.tiles == 4
    for bad in ((33, 100, 0), (33, 100, agc_k.AGC_MAXW + 1), (33, 0, 48)):
        with pytest.raises(ValueError):
            agc_k.agc_stereo_geometry(*bad)


def test_scan_launch_rule():
    """K13: the stage ring of two planes alone, six blocks an SM by
    shared memory (the launch bound asks for two)."""
    g = agc_k.agc_scan_geometry(8192, 2048)
    assert g.smem == 4 * agc_k.AGC_STAGES * 2 * agc_k.AGC_CB * 33 == 33792
    assert (g.sm_blocks, g.grid, g.tiles) == (6, 256, 64)
    assert agc_k.agc_scan_geometry(1, 1).tiles == 1
    with pytest.raises(ValueError):
        agc_k.agc_scan_geometry(8, 0)
