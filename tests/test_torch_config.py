"""The port's configuration registry and checkpoints
(`uhsdr_tpu_torch.core.config`) against the JAX package's, on the CPU.

* The registry, `Config` (defaults, `to_dict`, clamping, the JSON file
  it saves and loads) and `BandMemories` (every 16-bit word id) are
  copies: held equal, files byte-equal.
* `save_state` / `load_state` write the JAX package's `.npz` layout: the
  same leaf count, shapes and dtypes, in its pytree's flatten order, for
  usb, am, fm and ssbstereo chains at two channels.  A checkpoint of
  one package taken after one block is restored into the other, and one
  more block runs in both: the audio is held at >= 90 dB (the bound
  tests/test_torch_agc.py holds the AGC's back-averages to over a block;
  the two packages' CPU chains part by rounding alone).
"""
from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from uhsdr_tpu.chain import rx as jrx
from uhsdr_tpu.core import config as jcfg
from uhsdr_tpu.spectrum import scope as jscope
from uhsdr_tpu_torch.chain import rx as trx
from uhsdr_tpu_torch.core import config as tcfg
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.spectrum import scope as tscope

CKPT_DB = 90.0
C, B = 2, 2048


def test_registry_rows_equal():
    assert len(tcfg.REGISTRY) == len(jcfg.REGISTRY)
    for a, b in zip(jcfg.REGISTRY, tcfg.REGISTRY):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da == db, (da, db)
        assert a.eeprom_id == b.eeprom_id
        assert tcfg.entry_by_id(a.eeprom_id).name == a.name
        assert tcfg.entry_by_name(a.name).eeprom_id == a.eeprom_id
    assert tcfg.entry_by_name("no_such_entry") is None
    assert tcfg.CONFIG_VERSION == jcfg.CONFIG_VERSION


@pytest.mark.parametrize("entry", ["agc_mode", "filter_bw_key",
                                   "rtty_baud", "cw_speed_wpm",
                                   "iq_phase_balance_x1000"])
def test_cat_codec_equal(entry):
    a, b = jcfg.entry_by_name(entry), tcfg.entry_by_name(entry)
    values = list(a.choices) if a.typ is str else [
        a.min, a.max, a.default, (a.min + a.max) / 2]
    for v in values:
        raw = a.cat_encode(v)
        assert b.cat_encode(v) == raw
        assert b.cat_decode(raw) == a.cat_decode(raw)
        assert b.clamp(v) == a.clamp(v)


def test_config_defaults_set_save_load(tmp_path):
    ja, ta = jcfg.Config(), tcfg.Config()
    assert ta.to_dict() == ja.to_dict()
    sets = {"cw_speed_wpm": 99, "agc_mode": "fast", "rtty_shift_hz": 10.0,
            "iq_freq_mode": 3, "dbm_constant": -250}
    for k, v in sets.items():
        ja.set(k, v)
        ta[k] = v
    assert ta.to_dict() == ja.to_dict()
    assert ta.translate_hz == ja.translate_hz
    ja.band_memory.write_word(ja.band_memory.IDS["EEPROM_BAND0_MODE_A"], 3)
    ta.band_memory.write_word(ta.band_memory.IDS["EEPROM_BAND0_MODE_A"], 3)
    pj, pt = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    ja.save(pj)
    ta.save(pt)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    assert tcfg.Config.load(pj).to_dict() == jcfg.Config.load(pt).to_dict()
    assert (tcfg.Config.load(pj).band_memory.to_dict()
            == ja.band_memory.to_dict())
    with pytest.raises(KeyError):
        ta.set("no_such_entry", 1)
    ta.load_defaults()
    assert ta.to_dict() == jcfg.Config().to_dict()


def test_band_memories_equal():
    jb, tb = jcfg.BandMemories(), tcfg.BandMemories()
    assert tb.IDS == jb.IDS and tb.NUM_BANDS == jb.NUM_BANDS
    assert tb.to_dict() == jb.to_dict()
    ids = [base + i for base in jb.IDS.values() for i in range(jb.NUM_BANDS)]
    rng = np.random.default_rng(7)
    for vid in ids:
        w = int(rng.integers(0, 1 << 16))
        assert tb.write_word(vid, w) == jb.write_word(vid, w)
    for vid in ids + [0, 0x7FFF]:
        assert tb.read_word(vid) == jb.read_word(vid)
    assert tb.write_word(0x7FFF, 1) == jb.write_word(0x7FFF, 1)
    assert tb.to_dict() == jb.to_dict()
    d = json.loads(json.dumps(jb.to_dict()))
    tb2 = tcfg.BandMemories()
    tb2.from_dict(d)
    assert tb2.to_dict() == jb.to_dict()


MODES = {
    "usb": dict(mode="usb", bw_key="2P3KHZ"),
    "am": dict(mode="am", bw_key="5P0KHZ"),
    "fm": dict(mode="fm", bw_key="5P0KHZ"),
    "ssbstereo": dict(mode="ssbstereo", bw_key="2P3KHZ"),
}


def _blocks(seed: int, n_blocks: int = 2):
    rng = np.random.default_rng(seed)
    n = np.arange(n_blocks * B)
    f = 6000.0 + 700.0 + 400.0 * np.arange(C)[:, None]
    z = 0.3 * np.exp(2j * np.pi * f * n / 48000.0) + 0.01 * (
        rng.standard_normal((C, n.size))
        + 1j * rng.standard_normal((C, n.size)))
    i, q = z.real.astype(np.float32), z.imag.astype(np.float32)
    return [(i[:, k * B:(k + 1) * B], q[:, k * B:(k + 1) * B])
            for k in range(n_blocks)]


def _leaves(path) -> list:
    d = np.load(path)
    return [d[f"leaf_{i}"] for i in range(int(d["n_leaves"]))]


@pytest.mark.parametrize("mode", list(MODES))
def test_checkpoints_restore_across_packages(mode, tmp_path):
    kw = dict(MODES[mode], block_len=B)
    jcfg_rx, tcfg_rx = jrx.RxConfig(**kw), trx.RxConfig(**kw)
    jparams = jrx.make_params(jcfg_rx)
    step = jax.jit(lambda s, i, q: jrx.process_block(jcfg_rx, jparams, s,
                                                     (i, q)))
    tchain = trx.RxChain(tcfg_rx, device="cpu")
    blk0, blk1 = _blocks(5)
    _, js, _ = step(jrx.init_state(jcfg_rx, jparams, (C,)), *blk0)
    _, ts, _ = tchain(tchain.init_state((C,)), i=blk0[0], q=blk0[1])

    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jcfg.save_state(pj, js)
    tcfg.save_state(pt, ts, tcfg_rx)
    lj, lt = _leaves(pj), _leaves(pt)
    assert len(lt) == len(lj) == len(jax.tree.leaves(js))
    for a, b in zip(lj, lt):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)

    # the JAX checkpoint in the port, one more block in both
    yj, _, _ = step(js, *blk1)
    ts_j = tcfg.load_state(pj, tchain.init_state((C,)), tcfg_rx)
    yt, _, _ = tchain(ts_j, i=blk1[0], q=blk1[1])
    s = snr_db(np.asarray(yj), yt)
    assert s >= CKPT_DB, ("jax -> port", s)

    # the port's checkpoint in the JAX chain, one more block in both
    js_t = jcfg.load_state(pt, jrx.init_state(jcfg_rx, jparams, (C,)))
    yj, _, _ = step(js_t, *blk1)
    yt, _, _ = tchain(ts, i=blk1[0], q=blk1[1])
    s = snr_db(np.asarray(yj), yt)
    assert s >= CKPT_DB, ("port -> jax", s)


def test_two_channel_checkpoint_needs_cfg(tmp_path):
    cfg = trx.RxConfig(**MODES["ssbstereo"], block_len=B)
    chain = trx.RxChain(cfg, device="cpu")
    path = str(tmp_path / "s.npz")
    tcfg.save_state(path, chain.init_state((C,)), cfg)
    with pytest.raises(ValueError, match="need cfg"):
        tcfg.load_state(path, chain.init_state((C,)))


def test_scope_checkpoint_across_packages(tmp_path):
    jp = jscope.make_params(magnify=2)
    tp = tscope.make_params(magnify=2)
    z = _blocks(9, 1)[0]
    _, js = jscope.process(jp, jscope.init_state((C,), jp),
                           (z[0] + 1j * z[1]).astype(np.complex64))
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jcfg.save_state(pj, js)
    ts = tcfg.load_state(pj, tscope.init_state((C,), tp, device="cpu"))
    for f, v in tscope.state_to_numpy(ts).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(js, f)))
    tcfg.save_state(pt, ts)
    for a, b in zip(_leaves(pj), _leaves(pt)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    back = jcfg.load_state(pt, jscope.init_state((C,), jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert isinstance(ts.avg_mag, torch.Tensor)
