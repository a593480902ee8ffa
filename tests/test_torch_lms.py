"""The port's NLMS and leaky LMS (`uhsdr_tpu_torch.ops.lms`, the kernel's
plain versions on the CPU) against the JAX package's `ops.lms`, against
the scalar oracles of `tests/golden/ref_dsp.py`, and the chains with the
notch or the leaky LMS against the JAX chains.

* `run` (the 96-tap notch, error out; the 64-tap NLMS NR, prediction
  out) and `leaky_lms_run` (NR and notch mode) from the same input, three
  streamed blocks, output and every state leaf >= 110 dB (measured: the
  outputs 132.1-158.8 dB, the weights 116.6-143.7, the NLMS NR's the
  lowest): the port's dot products are a lane fold and a pairwise
  tree, XLA's sums another order, and the adaptation carries the parting
  on (tests/test_conformance_ref.py:255-262 calls the trajectory
  chaotic);
* the reference's same-input rows: the notch against `ref_dsp.nlms_notch`
  at >= 100 dB and the leaky NR against `ref_dsp.leaky_lms` within 5e-4
  of full scale (tests/test_conformance_ref.py:304-325,
  tests/test_leaky_lms.py:13-31);
* `RxChain` with each LMS option, 3 channels, the JAX chain's state after
  one block handed over, two blocks at the bounds written beside each
  case.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden import ref_dsp
from tests.test_torch_iqcorr import chain_vs_jax
from uhsdr_tpu.ops import lms as jlms
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.ops import lms as tlms

MODULE_DB = 110.0
FS = 12000.0


def _params(kind):
    return {"notch": (jlms.notch_params(), tlms.notch_params()),
            "nr": (jlms.nr_params(), tlms.nr_params()),
            "leaky": (jlms.leaky_lms_params(), tlms.leaky_lms_params()),
            "leaky_notch": (jlms.leaky_lms_params(notch=True),
                            tlms.leaky_lms_params(notch=True))}[kind]


@pytest.mark.parametrize("kind", ["notch", "nr", "leaky", "leaky_notch"])
def test_lms_matches_jax_streamed(kind):
    jp, tp = _params(kind)
    C, T = 3, 1024
    rng = np.random.default_rng(0)
    n = np.arange(3 * T)
    x = (0.5 * np.sin(2 * np.pi * 800 / FS * n)
         + 0.1 * rng.standard_normal((C, 3 * T))).astype(np.float32)
    if kind.startswith("leaky"):
        js = jlms.leaky_lms_init((C,), jp)
        ts = tlms.leaky_lms_init((C,), tp)
        jrun, trun = jlms.leaky_lms_run, tlms.leaky_lms_run
    else:
        js, ts = jlms.init_state((C,), jp), tlms.init_state((C,), tp)
        jrun, trun = jlms.run, tlms.run
    assert tlms.params_from_numpy(jp) == tp
    for b in range(3):
        xb = x[:, b * T:(b + 1) * T]
        yj, js = jrun(jp, js, jnp.asarray(xb))
        yt, ts = trun(tp, ts, torch.from_numpy(xb))
        assert snr_db(np.asarray(yj), yt) >= MODULE_DB, b
        for f, a, v in zip(ts._fields, js, ts):
            assert snr_db(np.asarray(a), v) >= MODULE_DB, (b, f)
    if kind == "notch":          # the carrier went: error << input
        assert float(yt.square().mean()) < 0.1 * float(
            torch.from_numpy(xb).square().mean())


def test_notch_matches_the_scalar_oracle():
    rng = np.random.default_rng(0)
    t = np.arange(6000) / FS
    x = (np.sin(2 * np.pi * 800 * t) * 0.5
         + 0.1 * rng.standard_normal(len(t))).astype(np.float32)
    p = tlms.notch_params()
    st = tlms.init_state((1,), p)
    y1, st = tlms.run(p, st, torch.from_numpy(x[None, :3000]))
    y2, st = tlms.run(p, st, torch.from_numpy(x[None, 3000:]))
    y = torch.cat([y1, y2], dim=-1)[0].numpy()
    assert snr_db(ref_dsp.nlms_notch(x), y) >= 100.0


def test_leaky_nr_matches_the_scalar_oracle():
    rng = np.random.default_rng(7)
    t = np.arange(3000) / FS
    x = (200.0 * np.sin(2 * np.pi * 600 * t)
         + 50.0 * rng.standard_normal(3000)).astype(np.float32)
    ref = ref_dsp.leaky_lms(x, notch=False)
    p = tlms.leaky_lms_params(notch=False)
    st = tlms.leaky_lms_init((), p)
    y1, st = tlms.leaky_lms_run(p, st, torch.from_numpy(x[:1500]))
    y2, st = tlms.leaky_lms_run(p, st, torch.from_numpy(x[1500:]))
    y = torch.cat([y1, y2]).numpy()
    assert np.abs(y - ref).max() / (np.abs(ref).max() + 1e-9) < 5e-4


# (RxConfig fields, audio bound, leaf bound) after the hand-over; measured
# audio / worst leaf over the two blocks: usb notch 105.5 / 95.4 dB (the
# PreFilter state behind the NLMS), usb leaky 116.2 / 108.7, usb leaky
# notch 114.8 / 105.1, ssbstereo notch and leaky 92.5 / 88.6, am notch and
# leaky 114.3 / 109.4
@pytest.mark.parametrize("kw,audio_db,leaf_db", [
    (dict(mode="usb", bw_key="2P3KHZ", notch_enable=True), 100.0, 90.0),
    (dict(mode="usb", bw_key="2P3KHZ", leaky_nr_enable=True), 105.0, 100.0),
    (dict(mode="usb", bw_key="2P3KHZ", notch_enable=True, leaky_notch=True),
     105.0, 100.0),
    (dict(mode="ssbstereo", bw_key="2P3KHZ", notch_enable=True,
          leaky_nr_enable=True), 88.0, 83.0),
    (dict(mode="am", bw_key="2P5KHZ", notch_enable=True,
          leaky_nr_enable=True), 105.0, 100.0)],
    ids=["usb_notch", "usb_leaky", "usb_leaky_notch", "ssbstereo",
         "am"])
def test_chain_with_lms_matches_jax(kw, audio_db, leaf_db):
    audio, leaves, ts, _ = chain_vs_jax(kw)
    assert min(audio) >= audio_db, audio
    assert min(leaves) >= leaf_db, leaves
