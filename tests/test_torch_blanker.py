"""The port's LPC impulse noise blanker (`uhsdr_tpu_torch.nr.blanker`, the
kernel's plain version on the CPU) against the JAX package's
`nr.blanker` and the scalar oracle `tests/golden/ref_nr.py`, and the
chains with `nb_enable` against the JAX chains.

* `process_block` on the impulse signal of tests/test_golden_nr.py:67-90
  (two tones, noise, 25 impulses of 4000-9000, two more within a repair
  window of the block boundary, so a repair reads the carried context),
  three channels in two blocks: output and context >= 130 dB against the
  JAX package (measured 148.2-inf dB; the sums are lane folds and pairwise
  trees in the port, XLA's in the JAX package) and, like the JAX
  package's own test, every frame > 110 dB against the float64 oracle;
* `RxChain` with the blanker (am, usb at three settings, ssbstereo), 3
  channels with 12 full-scale impulses each (after the front and the AGC
  the usb chain repairs 221 samples at nb_setting 15 and none at 0 or
  8), the JAX chain's state after one block handed over, two blocks at
  the bounds written beside each case.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden import ref_nr
from tests.test_golden_nr import _frame_snrs
from tests.test_torch_iqcorr import chain_vs_jax
from uhsdr_tpu.nr import blanker as jnb
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.nr import blanker as tnb

MODULE_DB = 130.0
FS = 12000.0
T = 128 * 40


def _impulse_signal(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / FS
    x = (800.0 * np.sin(2 * np.pi * 550 * t)
         + 300.0 * np.sin(2 * np.pi * 1230 * t + 0.7)
         + 60.0 * rng.standard_normal(T)).astype(np.float64)
    imp = list(rng.choice(np.arange(200, T - 200), 25, replace=False))
    imp += [T // 2 - 2, T // 2 + 130]
    for p in imp:
        x[p] += rng.choice([-1, 1]) * rng.uniform(4000, 9000)
    return x


def test_blanker_matches_jax_and_the_oracle():
    x = np.stack([_impulse_signal(s) for s in (5, 6, 7)])
    jp, tp = jnb.make_params(8), tnb.make_params(8)
    assert tnb.params_from_numpy(jp) == tp
    js, ts = jnb.init_state((3,)), tnb.init_state((3,))
    ys = []
    for h in (slice(0, T // 2), slice(T // 2, T)):
        xb = x[:, h].astype(np.float32)
        yj, js = jnb.process_block(jp, js, jnp.asarray(xb))
        yt, ts = tnb.process_block(tp, ts, torch.from_numpy(xb))
        assert snr_db(np.asarray(yj), yt) >= MODULE_DB
        assert snr_db(np.asarray(js.context), ts.context) >= MODULE_DB
        ys.append(yt.numpy())
    y = np.concatenate(ys, axis=-1)
    for c in range(3):
        y_ref, pos = ref_nr.alt_noise_blanking_ref(
            x[c], nb_setting=8, collect_positions=True)
        assert sum(len(p) for p in pos) >= 20      # the oracle fired
        fsnr = _frame_snrs(y[c], y_ref)
        assert fsnr.min() > 110.0, (c, fsnr.min(), int(fsnr.argmin()))


def test_blanker_repairs_across_the_block_boundary():
    """The impulse two samples before the boundary is repaired from the
    carried context: the output there is far from the impulse and equal
    to the one-block run's."""
    x = _impulse_signal(5).astype(np.float32)[None]
    p = tnb.make_params(8)
    y1, _ = tnb.process_block(p, tnb.init_state((1,)), torch.from_numpy(x))
    s = tnb.init_state((1,))
    a, s = tnb.process_block(p, s, torch.from_numpy(x[:, :T // 2]))
    b, s = tnb.process_block(p, s, torch.from_numpy(x[:, T // 2:]))
    y2 = torch.cat([a, b], dim=-1)
    assert torch.equal(y1, y2)
    k = T // 2 - 2 + tnb.DELAY
    assert abs(float(y2[0, k])) < 2000.0 < abs(float(x[0, T // 2 - 2]))


def test_blanker_refuses_a_ragged_block():
    with pytest.raises(ValueError):
        tnb.process_block(tnb.make_params(), tnb.init_state((1,)),
                          torch.zeros((1, 200)))


# (RxConfig fields, audio bound, leaf bound) after the hand-over; measured
# audio / worst leaf over the two blocks: am 119.9 / 111.1 dB, usb (each
# setting) 115.1 / 108.2, ssbstereo 113.0 / 108.6
@pytest.mark.parametrize("kw,audio_db,leaf_db", [
    (dict(mode="am", bw_key="2P5KHZ", nb_enable=True), 110.0, 105.0),
    (dict(mode="usb", bw_key="2P3KHZ", nb_enable=True), 110.0, 105.0),
    (dict(mode="usb", bw_key="2P3KHZ", nb_enable=True, nb_setting=15),
     110.0, 105.0),
    (dict(mode="usb", bw_key="2P3KHZ", nb_enable=True, nb_setting=0),
     110.0, 105.0),
    (dict(mode="ssbstereo", bw_key="2P3KHZ", nb_enable=True), 110.0, 100.0)],
    ids=["am", "usb", "usb_nb15", "usb_nb0", "ssbstereo"])
def test_chain_with_blanker_matches_jax(kw, audio_db, leaf_db):
    audio, leaves, ts, _ = chain_vs_jax(kw)
    assert min(audio) >= audio_db, audio
    assert min(leaves) >= leaf_db, leaves
