"""The port's sharded SAM and FM RX, sharded TX and the sharded wideband
bank in a 2 x 2 gloo world of four CPU processes, against the JAX
package's sharded steps on a 2 x 2 submesh of the conftest's virtual
devices and against the port's single-device chains (the helpers and the
world are tests/test_torch_sharded.py's):

* SAM 5P0KHZ and FM 5P0KHZ @ 48 kHz, 8 channels x 4096, 2 blocks: from
  zero state against the port's `RxChain`, audio and every gathered state
  leaf at >= 80 dB (integer and boolean leaves equal); against the JAX
  sharded step after the state hand-over that ROADMAP queue C's standing
  divergences name (the JAX CPU FFT front's rounding of the first
  samples becomes PLL and discriminator angles from zero state): the JAX
  state after block 0 through `scatter_state`, block 1's audio and its
  state back through `gather_state` at >= 80 dB;
* TX usb (reference front), 2 blocks: bit for bit against the port's
  `TxChain` on the same channels; against the JAX sharded TX with its
  voice bandpass on the JAX package's off-CPU route at >= 80 dB, as
  tests/test_torch_tx.py holds the chains (its CPU route sits 77 dB from
  float64);
* the wideband bank (M = 16, K = 6, 4 ranks, 2 blocks, the halo and the
  carry across them) against JAX `make_sharded_channelizer` and the
  port's unsharded `AnalysisPfb` at >= 100 dB.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sharded import (C, CHAIN_DB, FIR_DB, T, assert_close,
                                      capture, jax_sharded, joined,
                                      port_single, spawn_world)
from tests.test_torch_tx import _exact_voice_sos
from uhsdr_tpu.chain import tx as jtx
from uhsdr_tpu.parallel import mesh as jmesh
from uhsdr_tpu.parallel import tx_sharded as jts
from uhsdr_tpu.parallel import wideband_sharded as jws
from uhsdr_tpu_torch.chain import tx as ttx
from uhsdr_tpu_torch.ops import channelizer as chz
from uhsdr_tpu_torch.parallel import mesh as tmesh

MODES = {
    "sam": dict(mode="sam", bw_key="5P0KHZ", path_name="AM/SAM",
                translate_hz=6000.0, block_len=T),
    "fm": dict(mode="fm", bw_key="5P0KHZ", path_name="FM",
               translate_hz=6000.0, block_len=T)}
TX = dict(mode="usb", translate_hz=6000.0, block_len=T)
M, K = 16, 6
WB_B = 8 * M * 16                     # 512 wideband samples a rank


def _voice(n_blocks: int):
    """(C, T) f32 audio blocks: a 700 + 100 c Hz tone at -10 to -20 dBFS on
    channel c."""
    t = np.arange(n_blocks * T) / 48000.0
    c = np.arange(C)[:, None]
    a = (10.0 ** (-(10.0 + 10.0 * c / C) / 20.0)
         * np.sin(2 * np.pi * (700.0 + 100.0 * c) * t)).astype(np.float32)
    return [a[:, k * T:(k + 1) * T] for k in range(n_blocks)]


@pytest.fixture(scope="module")
def modes_world(tmp_path_factory):
    """The JAX sharded SAM and FM runs (their block-0 states are handed
    to the world), then the world."""
    caps = {m: capture(2, m, seed=2 + k) for k, m in enumerate(MODES)}
    jax_runs = {m: jax_sharded(MODES[m], caps[m]) for m in MODES}
    rng = np.random.default_rng(11)
    wide = (rng.standard_normal(2 * WB_B)
            + 1j * rng.standard_normal(2 * WB_B)).astype(np.complex64)
    cases = {}
    for m in MODES:
        cases[m] = dict(kind="rx", cfg=MODES[m], blocks=caps[m])
        cases[f"{m}_handover"] = dict(
            kind="rx", cfg=MODES[m], blocks=caps[m][1:],
            state=tmesh.flatten(jax_runs[m][1][0]))
    cases["tx"] = dict(kind="tx", cfg=TX, blocks=_voice(2))
    cases["wideband"] = dict(kind="wideband", M=M, K=K,
                             prototype=chz.design_prototype(M, K),
                             blocks=[wide[:WB_B], wide[WB_B:]])
    ranks = spawn_world(str(tmp_path_factory.mktemp("modes_world")), cases)
    return dict(ranks=ranks, caps=caps, jax=jax_runs, wide=wide)


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_mode_matches_the_chain_and_jax(modes_world, mode):
    ranks = modes_world["ranks"]
    audio = joined(ranks, mode, "audio")
    want, flat = port_single(MODES[mode], modes_world["caps"][mode])
    assert_close(f"{mode} vs RxChain", want, audio, CHAIN_DB)
    assert_close(f"{mode} state vs RxChain", flat, ranks[0][mode]["state"],
                 CHAIN_DB)
    ja, jstates = modes_world["jax"][mode]
    assert_close(f"{mode} block 1 from the JAX state",
                 ja[:, ja.shape[1] // 2:],
                 joined(ranks, f"{mode}_handover", "audio"), CHAIN_DB)
    assert_close(f"{mode} state back to JAX", tmesh.flatten(jstates[1]),
                 ranks[0][f"{mode}_handover"]["state"], CHAIN_DB)


def test_sharded_tx_matches_the_chain_and_jax(modes_world, monkeypatch):
    ranks = modes_world["ranks"]
    blocks = _voice(2)
    iq = joined(ranks, "tx", "iq")
    state = ranks[0]["tx"]["state"]
    chain = ttx.TxChain(ttx.TxConfig(**TX), device="cpu")
    s = chain.init_state((C,))
    want = []
    for a in blocks:
        i, q, s = chain(s, a)
        want.append(torch.complex(i, q).numpy())
    assert np.array_equal(np.concatenate(want, -1), iq)
    flat = ttx.state_to_numpy(s)
    assert all(np.array_equal(flat[f], v) for f, v in state.items())
    assert set(flat) == set(state)

    monkeypatch.setattr(jtx, "_voice_sos", _exact_voice_sos)
    mesh = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    step, init_state = jts.make_sharded_tx(jtx.TxConfig(**TX), mesh)
    js, ys = init_state(C), []
    for a in blocks:
        i, q, js = step(js, jnp.asarray(a))
        ys.append(np.asarray(i) + 1j * np.asarray(q))
    assert_close("tx vs JAX sharded", np.concatenate(ys, -1), iq, CHAIN_DB)
    assert_close("tx state vs JAX sharded", tmesh.flatten(js), state,
                 CHAIN_DB)


def test_sharded_wideband_matches_the_bank_and_jax(modes_world):
    ranks = modes_world["ranks"]
    got = joined(ranks, "wideband", "y")
    wide = modes_world["wide"]
    bank = chz.AnalysisPfb(M, prototype=chz.design_prototype(M, K),
                           device="cpu")
    y, _ = bank(bank.init_state(), torch.from_numpy(wide))
    assert_close("wideband vs AnalysisPfb", y.numpy(), got, FIR_DB)

    mesh = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    step, init_carry, _ = jws.make_sharded_channelizer(
        M, mesh, taps_per_branch=K, prototype=chz.design_prototype(M, K))
    carry, ys = init_carry(), []
    for blk in (wide[:WB_B], wide[WB_B:]):
        i, q, carry = step(carry, jnp.asarray(blk.real),
                           jnp.asarray(blk.imag))
        ys.append(np.asarray(i) + 1j * np.asarray(q))
    assert_close("wideband vs JAX sharded", np.concatenate(ys, -1), got,
                 FIR_DB)
