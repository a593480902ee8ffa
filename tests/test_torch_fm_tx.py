"""FM TX in the port (`uhsdr_tpu_torch.mod.modulators` FM and
`chain.tx.TxChain(mode="fm")`) on the CPU, where the lattice and the
table-mode modulator run their kernels' plain versions, against the JAX
package on the same seeded inputs:

* `fm_mod_params` in both modes (the ref front's count domain and DDS
  grid, the legacy front's unit domain), with a subtone, 5 kHz
  deviation and a negative translate (the I/Q swap);
* the modulator alone on the same audio in both packages: its
  accumulator takes the same value at every sample (checked through the
  IQ: one accumulator step apart moves an IQ sample by >= 9e-5, and no
  sample moves by 1e-5), its IQ within 1e-5 (the JAX sine is XLA's, the
  port's table torch's), its final accumulator and pre-emphasis state
  equal or at 120 dB;
* the tone burst;
* `TxChain(mode="fm")` on both fronts over four streamed blocks, in two
  halves as the accumulator asks: the audio into the modulator
  (`taps["processed"]`) and the state leaves upstream of it at their
  bounds, and the modulator of each block run from the JAX chain's own
  modulator input and state, whose IQ must match the JAX chain's; the
  whole chain's IQ is printed and held to the bound its accumulator
  leaves it (below); the hand-over from the JAX chain mid-stream;
* the TX fm conformance row (tests/test_tx_conformance.py) against the
  float64 oracle tests/golden/ref_tx.py at its bound of 50 dB (the JAX
  chain reads 53.9 dB there; the port 92.3).

Why the halves.  The accumulator floors (the ref front) or rounds (the
legacy one) every sample, so a last-bit difference in its input flips a
step now and then, and the phase walks: after 8192 samples the two
packages' accumulators stand 0-12 steps apart (2 pi / 65536 each), and
the IQ reads 54.2-60.5 dB (ref) and 72.4-86.9 dB (legacy) against the
JAX chain.  The difference comes from the voice lattice's f32 rounding
(XLA's CPU code fuses multiply-adds that the port, like its kernel, does
not) and, on the legacy front, the blocked one-poles; fed the same input
the two modulators agree at every sample.  Bounds: the modulator input
100 dB (measured 110.8-122.1), the ALC and pre-emphasis input 95 dB, the
pre-emphasis output hpf_b 70 dB (a first difference of the modulator
input: measured 77.3-119.7), the voice lattice's internal state 55 dB
(large sums near cancelling: measured 58.0-86.9; its output, the
modulator input, holds), the whole IQ 50 dB (ref) and 65 dB (legacy).
ROADMAP.md queue C records these.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_tx as ttt
from tests.golden import ref_tx as gold
from tests.test_tx_conformance import make_voice
from tests.test_tx_conformance import snr_db as conf_snr_db
from uhsdr_tpu.chain import tx as jtx
from uhsdr_tpu.mod import modulators as jmods
from uhsdr_tpu_torch.chain import tx as ttx
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.mod import modulators as tmods

C, B = ttt.C, ttt.B
INPUT_DB = 100.0
UPSTREAM_DB = 95.0
HPF_B_DB = 70.0
LATTICE_STATE_DB = 55.0
IQ_DB = {"ref": 50.0, "scipy": 65.0}
MOD_ABS = 1e-5


PARAM_CASES = [dict(translate_hz=6000.0), dict(translate_hz=-6000.0),
               dict(translate_hz=12000.0, dev_5khz=True, subtone_hz=88.5),
               dict(translate_hz=-9000.0, subtone_hz=67.0)]


@pytest.mark.parametrize("count_domain", [True, False])
@pytest.mark.parametrize("kw", PARAM_CASES, ids=range(len(PARAM_CASES)))
def test_fm_mod_params_match_jax(kw, count_domain):
    jp = jmods.fm_mod_params(**kw, count_domain=count_domain)
    assert tmods.fm_mod_params(**kw, count_domain=count_domain) == \
        tmods.fm_params_from_numpy(jp)


def _modulate_both(jp, tp, blocks):
    """The same blocks through both modulators from zero state; returns
    [(iq_jax, iq_port)] and the final states."""
    js, ts = jmods.fm_mod_init((C,)), tmods.fm_mod_init((C,))
    out = []
    for a in blocks:
        iqj, js = jmods.fm_modulate(jp, js, jnp.asarray(a))
        iqt, ts = tmods.fm_modulate(tp, ts, torch.from_numpy(a))
        out.append((np.asarray(iqj), iqt.numpy()))
    return out, js, ts


@pytest.mark.parametrize("count_domain", [True, False])
@pytest.mark.parametrize("kw", PARAM_CASES, ids=range(len(PARAM_CASES)))
def test_fm_modulator_matches_jax(kw, count_domain):
    """Audio at the chain's level of each domain (count units on the ref
    front), three blocks with the middle one shorter: ragged (777) for
    the table mode, whose pre-emphasis both packages run sequentially;
    896 samples for the legacy mode, whose blocked one-pole the JAX
    package runs as the port does on multiples of 128 samples only (on
    another length it takes a dilated scan, whose rounding moved one
    accumulator step in 777 samples here)."""
    jp = jmods.fm_mod_params(**kw, count_domain=count_domain)
    tp = tmods.fm_params_from_numpy(jp)
    rng = np.random.default_rng(5)
    scale = 8000.0 if count_domain else 0.3
    mid = 777 if count_domain else 896
    blocks = [(rng.standard_normal((C, n)) * scale).astype(np.float32)
              for n in (B, mid, B)]
    out, js, ts = _modulate_both(jp, tp, blocks)
    for k, (a, b) in enumerate(out):
        err = float(np.abs(a - b).max())
        print(f"\nFM mod {kw} count_domain={count_domain} block {k}: "
              f"max|err| {err:.2e}, {snr_db(a, b):.1f} dB")
        assert err <= MOD_ABS, (k, err)
    np.testing.assert_array_equal(np.asarray(js.accum), ts.accum.numpy())
    np.testing.assert_array_equal(np.asarray(js.sub_phase),
                                  ts.sub_phase.numpy().astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(js.hpf_a), ts.hpf_a.numpy())
    assert snr_db(np.asarray(js.hpf_b), ts.hpf_b) >= 120.0


def test_fm_modulator_nan_input():
    """The plain version defines the result for a NaN input: NaN IQ for
    the rest of the block, a zero accumulator carried on."""
    tp = tmods.fm_mod_params(count_domain=True)
    a = np.zeros((2, 64), np.float32)
    a[1, 10] = np.nan
    iq, st = tmods.fm_modulate(tp, tmods.fm_mod_init((2,)),
                               torch.from_numpy(a))
    assert not torch.isnan(iq[0]).any()
    assert torch.isnan(iq[1, 10:]).all() and not torch.isnan(iq[1, :10]).any()
    assert int(st.accum[1]) == 0


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_fm_tone_burst_matches_jax(mode):
    pj = jnp.asarray(np.array([0, 123456789], np.uint32))
    pt = torch.tensor([0, 123456789], dtype=torch.int64)
    for n in (480, 333):
        yj, pj = jmods.fm_tone_burst(pj, mode, n)
        yt, pt = tmods.fm_tone_burst(pt, mode, n)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-6)
        np.testing.assert_array_equal(pt.numpy().astype(np.uint32),
                                      np.asarray(pj))


def _leaf(state, dotted):
    for part in dotted.split("."):
        state = getattr(state, part)
    return np.asarray(state)


@pytest.mark.parametrize("front", ["ref", "scipy"])
def test_fm_tx_chain_matches_jax_streamed(front, monkeypatch):
    """Four blocks of the conformance voice at four levels; the legacy
    front with a subtone.  The JAX voice bandpass on its off-CPU route,
    as tests/test_torch_tx.py runs it."""
    monkeypatch.setattr(jtx, "_voice_sos", ttt._exact_voice_sos)
    kw = dict(mode="fm", front=front, block_len=B,
              fm_subtone_hz=88.5 if front == "scipy" else 0.0)
    jcfg, tcfg = jtx.TxConfig(**kw), ttx.TxConfig(**kw)
    jp = jtx.make_params(jcfg)
    tp = ttx.params_from_numpy(jp, device="cpu")
    mine = ttx.make_params(tcfg, device="cpu")
    assert tp.fm == mine.fm and (tp.voice_lat is None) == (
        mine.voice_lat is None)
    if front == "ref":
        assert all(np.array_equal(a, b) for a, b in zip(tp.voice_lat,
                                                        mine.voice_lat))
    assert (tp.in_scale, tp.out_scale) == (mine.in_scale, mine.out_scale)
    js, ts = jtx.init_state(jcfg, jp, (C,)), ttx.init_state(tcfg, tp, (C,))
    blocks = ttt._blocks("fm")
    mid = None
    for k, blk in enumerate(blocks):
        js_prev = js
        iqj, js, tj = jtx.process_block(jcfg, jp, js, jnp.asarray(blk))
        iqt, ts, tt = ttx.process_block(tcfg, tp, ts, torch.from_numpy(blk))
        s_in = snr_db(np.asarray(tj["processed"]), tt["processed"])
        leaves = {f: snr_db(_leaf(js, f), v)
                  for f, v in ttx.state_to_numpy(ts).items()
                  if v.dtype.kind == "f"}
        steps = np.abs(_leaf(js, "mod.accum").astype(np.int64)
                       - ts.mod.accum.numpy())
        steps = np.minimum(steps, 65536 - steps)
        # the second half: the port's modulator from the JAX chain's own
        # input and state
        mod_state = ttx.state_from_numpy(
            jax.tree_util.tree_map(np.asarray, js_prev), device="cpu").mod
        iq_mod, _ = tmods.fm_modulate(
            tp.fm, mod_state, torch.tensor(np.asarray(tj["processed"])))
        iq_mod = (iq_mod * tp.out_scale * tp.iq_gain).numpy()
        s_iq = snr_db(np.asarray(iqj), iqt)
        print(f"\nTX fm {front} block {k}: modulator input {s_in:.1f} dB, "
              f"IQ {s_iq:.1f} dB, accumulators {steps.tolist()} steps "
              f"apart; leaves " + ", ".join(f"{f} {v:.1f}"
                                            for f, v in leaves.items()))
        assert s_in >= INPUT_DB
        assert float(np.abs(iq_mod - np.asarray(iqj)).max()) <= MOD_ABS
        assert s_iq >= IQ_DB[front]
        for f, v in leaves.items():
            bound = (LATTICE_STATE_DB if f == "voice_sos_state"
                     and front == "ref" else HPF_B_DB if f == "mod.hpf_b"
                     else UPSTREAM_DB)
            assert v >= bound, (f, v)
        if k == 1:
            mid = js
    # the hand-over: the JAX chain's state after block 1 into the port;
    # the modulator input of blocks 2-3 against the JAX chain's
    ts2 = ttx.state_from_numpy(jax.tree_util.tree_map(np.asarray, mid),
                               device="cpu")
    js2 = mid
    for blk in blocks[2:]:
        _, js2, tj = jtx.process_block(jcfg, jp, js2, jnp.asarray(blk))
        _, ts2, tt = ttx.process_block(tcfg, tp, ts2, torch.from_numpy(blk))
        assert snr_db(np.asarray(tj["processed"]), tt["processed"]) >= \
            INPUT_DB


def test_fm_tx_conformance_vs_float64_oracle():
    """The TX fm row of tests/test_tx_conformance.py: two seconds of the
    conformance voice through the port's ref-front FM chain against the
    firmware's math in float64, at the row's bound."""
    audio = make_voice()
    ref = gold.ref_tx_chain(audio.astype(np.float64) * 32767.0, "fm")
    chain = ttx.TxChain(ttx.TxConfig(mode="fm", translate_hz=6000.0,
                                     block_len=4096), device="cpu")
    state = chain.init_state((1,))
    outs = []
    for s in range(0, len(audio), 4096):
        i, q, state = chain(state, audio[None, s:s + 4096])
        outs.append(i[0].numpy() + 1j * q[0].numpy())
    s_db = conf_snr_db(ref, np.concatenate(outs) * 32767.0)
    print(f"\nTX fm vs the float64 oracle: {s_db:.1f} dB")
    assert s_db >= 50.0
