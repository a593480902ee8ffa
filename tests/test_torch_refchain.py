"""The port's reference-exact RX chain (`uhsdr_tpu_torch.chain.refchain`)
on the CPU, where its stages run their kernels' plain versions (K5, K6,
the lattice, K3, K4, the demodulators), against the JAX package's
`RefRxChain` and the float64 firmware oracle `tests/golden/ref_chain.py`,
on the captures of tests/test_conformance_ref.py:

* the seven CASES through both chains from the same tables
  (`params_from_numpy`; the port's own design copy gives the same
  tables), two channels (the capture, and the capture with the noise of
  seed 1), 36864 samples in 4096-sample blocks (the last ragged): the
  audio at 80 dB, every state leaf after the last block at 80 dB but
  SAM's PLL frequency estimate `sam.omega2`, which sits near zero (the
  carrier is on the translate frequency: |omega2| <= 2e-5 rad a sample)
  and is held to 1e-6 of its range omega_max (measured: 5e-9 apart);
* the state layouts: the JAX chain's state after block 4 through
  `state_from_numpy` and back through `state_to_numpy` unchanged, and
  block 5 from it through the port against the JAX chain's at 80 dB;
* channel 0 against the float64 oracle at each CASE's bound (50, 45 and
  40 dB), over what follows the conformance test's half-second skip
  (the JAX package's tests run two seconds; the port's plain AGC loop,
  ~0.6 ms a step, keeps these to 0.77 s: measured 78.1-114.9 dB);
* block invariance: 4096- against 2048-sample blocks at 80 dB, as the
  JAX package's test does (tests/test_conformance_ref.py:169-170).
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from tests import test_conformance_ref as conf
from tests.golden import ref_chain as gold
from uhsdr_tpu.chain import refchain as jref
from uhsdr_tpu_torch.chain import refchain as tref
from uhsdr_tpu_torch.metrics import snr_db

CHAIN_DB = 80.0
T_REF = 9 * 4096
BLOCK = 4096
HAND_OVER = 4


def _iq(mode: str, n: int = T_REF) -> np.ndarray:
    return np.stack([conf.make_iq(mode)[:n], conf.make_iq(mode, seed=1)[:n]])


def _leaf(state, dotted):
    for part in dotted.split("."):
        state = getattr(state, part)
    return np.asarray(state)


@functools.lru_cache(maxsize=None)
def _runs(mode, bw, sel):
    """Both chains over the capture: (JAX audio, JAX states after each
    block, port audio, port state, port block HAND_OVER + 1 from the JAX
    state)."""
    kw = dict(mode=mode, bw_key=bw, select_id=sel, block_len=BLOCK)
    jch = jref.RefRxChain(jref.RefRxConfig(**kw))
    cfg = tref.RefRxConfig(**kw)
    tp = tref.params_from_numpy(jch.params, cfg, device="cpu")
    iq = _iq(mode)
    js, ts = jch.init_state((2,)), tref.init_state(cfg, tp, (2,))
    yj, yt, jstates, hand = [], [], [], None
    for k, s in enumerate(range(0, iq.shape[-1], BLOCK)):
        blk = iq[:, s:s + BLOCK]
        a, js = jch(js, iq=blk)
        planes = (torch.from_numpy(blk.real.astype(np.float32)),
                  torch.from_numpy(blk.imag.astype(np.float32)))
        b, ts = tref.process_block(cfg, tp, ts, planes)
        yj.append(np.asarray(a))
        yt.append(b.numpy())
        jstates.append(js)
        if k == HAND_OVER + 1:
            ts2 = tref.state_from_numpy(jax.tree_util.tree_map(
                np.asarray, jstates[HAND_OVER]), cfg, device="cpu")
            hand, _ = tref.process_block(cfg, tp, ts2, planes)
    return (np.concatenate(yj, -1), jstates, np.concatenate(yt, -1), ts,
            hand.numpy())


CASE_IDS = [f"{m}-{b}" for m, b, _, _ in conf.CASES]


@pytest.mark.parametrize("mode,bw,sel,bound", conf.CASES, ids=CASE_IDS)
def test_refchain_matches_jax(mode, bw, sel, bound):
    cfg = tref.RefRxConfig(mode=mode, bw_key=bw, select_id=sel)
    mine = tref.make_params(cfg, device="cpu")
    jch_params = jref.make_params(jref.RefRxConfig(mode=mode, bw_key=bw,
                                                   select_id=sel))
    theirs = tref.params_from_numpy(jch_params, cfg, device="cpu")
    for name, a, b in zip(mine._fields, mine, theirs):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif name not in ("sam", "fm"):
            assert a == b, name
    yj, jstates, yt, ts, hand = _runs(mode, bw, sel)
    s_audio = snr_db(yj, yt)
    leaves = {}
    for f, v in tref.state_to_numpy(ts, cfg).items():
        ref = _leaf(jstates[-1], f)
        assert ref.shape == v.shape, f
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(ref, v, err_msg=f)
        elif f == "sam.omega2":
            err = float(np.abs(ref - v).max())
            assert err <= 1e-6 * mine.sam.omega_max, err
        else:
            leaves[f] = snr_db(ref, v)
    low = min(leaves, key=leaves.get)
    print(f"\nrefchain {mode} {bw}: audio {s_audio:.1f} dB, worst leaf {low} "
          f"{leaves[low]:.1f} dB of {len(leaves)}")
    assert s_audio >= CHAIN_DB and leaves[low] >= CHAIN_DB
    # the layouts: the JAX state through the port's converters unchanged,
    # and the block after it from the JAX state
    js = jax.tree_util.tree_map(np.asarray, jstates[HAND_OVER])
    back = tref.state_to_numpy(tref.state_from_numpy(js, cfg, device="cpu"),
                               cfg)
    for f, v in back.items():
        np.testing.assert_array_equal(v, _leaf(js, f), err_msg=f)
    sl = slice((HAND_OVER + 1) * BLOCK, (HAND_OVER + 2) * BLOCK)
    assert snr_db(yj[:, sl], hand) >= CHAIN_DB


@pytest.mark.parametrize("mode,bw,sel,bound", conf.CASES, ids=CASE_IDS)
def test_refchain_matches_reference_math(mode, bw, sel, bound):
    ref, _ = gold.ref_rx_chain(_iq(mode)[0], mode, bw, select_id=sel)
    s = conf.snr_db(ref, _runs(mode, bw, sel)[2][0])
    print(f"\nrefchain {mode} {bw} vs the float64 oracle: {s:.1f} dB")
    assert s >= bound, f"{mode}/{bw}: SNR {s:.1f} dB < {bound}"


def test_refchain_block_size_invariance():
    """Streaming state hand-off: 4096- and 2048-sample blocks, the same
    output."""
    iq = conf.make_iq("usb")[:6 * 4096]

    def run(blk):
        chain = tref.RefRxChain(tref.RefRxConfig(mode="usb", block_len=blk),
                                device="cpu")
        state = chain.init_state((1,))
        outs = []
        for s in range(0, len(iq), blk):
            audio, state = chain(state, iq=iq[None, s:s + blk])
            outs.append(audio[0].numpy())
        return np.concatenate(outs)

    a, b = run(4096), run(2048)
    assert snr_db(a, b) > CHAIN_DB


def test_refchain_needs_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tref.RefRxChain(tref.RefRxConfig())
    assert tref.RefRxChain(tref.RefRxConfig(), device="cpu").device.type \
        == "cpu"
