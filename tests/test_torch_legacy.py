"""The port's legacy redesigned RX front (`RxConfig(front="scipy")`, and the
two-channel modes on the wide rows, which run it on the default front) on
the CPU, where K7/K6 and K5 run their plain versions, against the JAX
package's chain on the same int16 captures (tests/test_torch_rx.py's
AM capture, tests/test_torch_fm.py's FM capture):

* every mode (usb, lsb, cw, am, sam, fm, iq, ssbstereo), both filter
  lengths (`high_taps`: 199 or 89 taps), 48 and 96 kHz, the blanker and
  the NR, and the wide rows' iq and
  ssbstereo on the default front: four streamed blocks from zero state,
  the audio and every state leaf at 80 dB after each block, and the
  stream handed over after block 2 in both directions, its blocks 3-4
  at 80 dB (tests/test_torch_rx.py::run_streamed_both_ways);
* SAM and FM from the hand-over only: at zero state the JAX CPU chain's
  FFT front rounds the first samples' near-silence apart from the port's
  direct FIR, and the PLL and the discriminator turn that into full-scale
  angles (ROADMAP queue C; measured from zero state: SAM 52.8-60.6 dB
  and FM 16.3-33.7 dB in block 0, after the hand-over SAM 108.4-117.3
  and FM 130.6-132.0 dB);
* the live retune (`tune_offset_hz`, a new offset each block) on usb and
  on the legacy ssbstereo pair, against the JAX chain at 80 dB.

The other options on this front run from the JAX chain's state in
tests/test_torch_rx.py::test_former_roadmap_configs_run: the LMS
stages adapt chaotically (a last-bit difference upstream decorrelates
their weights: the leaky LMS read 67.0 dB in block 0 from zero state
here), and the IQ correction's planes round apart in the two packages,
so the ADC peaks this test holds equal are not.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_rx as common
from tests.test_torch_fm import fm_capture
from uhsdr_tpu.chain import rx as jrx
from uhsdr_tpu_torch.chain import rx as trx
from uhsdr_tpu_torch.metrics import snr_db

CHAIN_DB = 80.0

CASES = [
    dict(mode="usb", bw_key="2P3KHZ", iq_rate=96000.0),
    dict(mode="lsb", bw_key="2P3KHZ", iq_rate=48000.0, high_taps=False),
    dict(mode="cw", bw_key="500HZ", iq_rate=48000.0),
    dict(mode="usb", bw_key="5P0KHZ", iq_rate=96000.0, high_taps=False),
    dict(mode="am", bw_key="5P0KHZ", iq_rate=96000.0),
    dict(mode="am", bw_key="3P6KHZ", iq_rate=48000.0, high_taps=False,
         fade_leveler=False),
    dict(mode="sam", bw_key="5P0KHZ", iq_rate=48000.0),
    dict(mode="sam", bw_key="2P3KHZ", iq_rate=96000.0,
         sam_sideband="stereo"),
    dict(mode="fm", bw_key="5P0KHZ", iq_rate=48000.0),
    dict(mode="fm", bw_key="5P0KHZ", iq_rate=96000.0, sql_threshold=10,
         high_taps=False),
    dict(mode="iq", bw_key="2P3KHZ", iq_rate=96000.0),
    dict(mode="ssbstereo", bw_key="2P3KHZ", iq_rate=48000.0,
         high_taps=False),
    dict(mode="usb", bw_key="2P3KHZ", iq_rate=96000.0, nb_enable=True,
         nr_enable=True),
]
WIDE_DEFAULT_FRONT = [dict(mode="iq", bw_key="10P0KHZ", iq_rate=48000.0),
                      dict(mode="ssbstereo", bw_key="5P0KHZ",
                           iq_rate=96000.0)]


def _id(kw):
    return "-".join(str(v) for v in kw.values())


@pytest.mark.parametrize("kw", CASES, ids=[_id(k) for k in CASES])
def test_legacy_chain_matches_jax_streamed(kw):
    kw = dict(kw, front="scipy")
    cfg = trx.RxConfig(**kw)
    assert not cfg.use_ref_front
    chaotic = kw["mode"] in ("sam", "fm")
    common.run_streamed_both_ways(
        kw, -math.inf if chaotic else CHAIN_DB,
        capture=fm_capture if kw["mode"] == "fm" else None)


@pytest.mark.parametrize("kw", WIDE_DEFAULT_FRONT,
                         ids=[_id(k) for k in WIDE_DEFAULT_FRONT])
def test_wide_two_channel_rows_run_the_legacy_front(kw):
    cfg = trx.RxConfig(**kw)
    assert cfg.front == "ref" and not cfg.use_ref_front
    assert cfg.front_pair == (kw["mode"] == "ssbstereo")
    assert not cfg.stage_b_pair
    common.run_streamed_both_ways(kw, CHAIN_DB)


@pytest.mark.parametrize("kw", [
    dict(mode="usb", bw_key="2P3KHZ", iq_rate=48000.0, front="scipy"),
    dict(mode="ssbstereo", bw_key="5P0KHZ", iq_rate=96000.0)])
def test_legacy_retune_matches_jax(kw):
    """A new tune offset each block, through both chains' tuned paths."""
    kw = {"translate_hz": 12000.0, "block_len": common.AM_B, **kw}
    jcfg, tcfg = jrx.RxConfig(**kw), trx.RxConfig(**kw)
    jp = jrx.make_params(jcfg)
    tp = trx.params_from_numpy(jp, device="cpu", cfg=tcfg)
    step = jax.jit(lambda s, i, q, off: jrx.process_block(
        jcfg, jp, s, (i, q), tune_offset_hz=off))
    js = jrx.init_state(jcfg, jp, (common.C,))
    ts = trx.init_state(tcfg, tp, (common.C,))
    blocks = common.am_capture(3, kw["iq_rate"])
    for k, (blk, off) in enumerate(zip(blocks, (250.0, -1300.5, 40.25))):
        yj, js, _ = step(js, jnp.asarray(blk[0]), jnp.asarray(blk[1]),
                         jnp.float32(off))
        yt, ts, _ = trx.process_block(
            tcfg, tp, ts, (torch.from_numpy(blk[0]),
                           torch.from_numpy(blk[1])), tune_offset_hz=off)
        s = snr_db(np.asarray(yj), yt)
        leaves = common.state_snrs(js, ts, tcfg)
        low = min(leaves, key=leaves.get)
        print(f"\nretune {kw['mode']} block {k} ({off} Hz): audio {s:.1f} "
              f"dB, worst leaf {low} {leaves[low]:.1f} dB")
        assert s >= CHAIN_DB and leaves[low] >= CHAIN_DB


def test_legacy_params_match_jax():
    """The port's own NumPy design copy gives the JAX package's legacy
    tables, and its post-AGC scale, at both filter lengths."""
    for kw in (dict(mode="usb"), dict(mode="cw", bw_key="500HZ"),
               dict(mode="am", bw_key="5P0KHZ", high_taps=False),
               dict(mode="ssbstereo", iq_rate=96000.0),
               dict(mode="fm", bw_key="6P0KHZ", iq_rate=96000.0)):
        kw = dict(kw, front="scipy")
        tcfg = trx.RxConfig(**kw)
        mine = trx.make_params(tcfg, device="cpu")
        theirs = trx.params_from_numpy(jrx.make_params(jrx.RxConfig(**kw)),
                                       device="cpu", cfg=tcfg)
        for name, a, b in zip(mine._fields, mine, theirs):
            assert common._same(a, b), (kw, name)
        assert tcfg.decim == jrx.RxConfig(**kw).decim
