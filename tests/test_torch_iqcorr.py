"""The port's IQ auto-correction (`uhsdr_tpu_torch.ops.iqcorr`, its kernel's
plain version on the CPU) against the JAX package's `ops.iqcorr`, and the
chains with `iq_auto_correction` against the JAX chains.

* `correct` on a deliberately imbalanced tone (gain 1.07, phase 0.06),
  three streamed blocks, f32 and int16 planes, every state leaf (the
  twin-peaks flag equal): the sub-block sums are pairwise trees in the
  port and XLA's sums in the JAX package, so they part at f32 rounding,
  >= 120 dB (measured 127.7-148.3 dB);
* `RxChain` with the option, usb, am and ssbstereo at 48 kHz and FM at 96
  kHz, 3 channels: the JAX chain runs the first block and hands its state
  to the port, then both run two blocks; audio and every state leaf at
  the bounds written beside each case (measured values in the comments).

`chain_vs_jax` and `capture` serve the other option files too.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_rx as common
from uhsdr_tpu.chain import rx as jrx
from uhsdr_tpu.ops import iqcorr as jiq
from uhsdr_tpu_torch.chain import rx as trx
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.ops import iqcorr as tiq

MODULE_DB = 120.0
B = 4096


def capture(n_blocks, C=3, seed=3, fs=48000.0, translate=6000.0,
            imbalance=True, impulses=12):
    """int16 IQ blocks (C, B): a USB tone 700 Hz above the translate
    frequency, an AM carrier on it 50% modulated at 400 Hz (for FM a
    carrier deviated 2 kHz by a 1 kHz tone), levels falling across the
    channels, noise of 300 counts; with `imbalance` a gain error of 1.1
    and a phase error of 0.05 on Q, and `impulses` full-scale impulses a
    channel at random samples."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * B) / fs
    lvl = np.linspace(1.0, 0.3, C)[:, None]
    z = lvl * (8000.0 * np.exp(2j * np.pi * (translate + 700.0) * t)
               + 4000.0 * (1 + 0.5 * np.sin(2 * np.pi * 400.0 * t))
               * np.exp(1j + 2j * np.pi * translate * t))
    z = z + (rng.standard_normal(z.shape)
             + 1j * rng.standard_normal(z.shape)) * 300.0
    if imbalance:
        z = z.real * 1.1 + 1j * (z.imag + 0.05 * z.real)
    for c in range(C):
        for p in rng.choice(z.shape[-1], impulses, replace=False):
            z[c, p] += 30000.0
    i = np.clip(np.round(z.real), -32768, 32767).astype(np.int16)
    q = np.clip(np.round(z.imag), -32768, 32767).astype(np.int16)
    return [(i[:, k * B:(k + 1) * B], q[:, k * B:(k + 1) * B])
            for k in range(n_blocks)]


def chain_vs_jax(kw, n_blocks=2, C=3, seed=3, **cap):
    """The JAX chain runs a block and hands its state over; then both
    chains run `n_blocks` more.  Returns ([audio SNR a block], [worst
    leaf SNR a block], the port's last state, the JAX chain's)."""
    kw = dict(kw, block_len=B)
    jcfg, tcfg = jrx.RxConfig(**kw), trx.RxConfig(**kw)
    jp = jrx.make_params(jcfg)
    tp = trx.params_from_numpy(jp, device="cpu", cfg=tcfg)
    for name, a, b in zip(tp._fields, tp,
                          trx.make_params(tcfg, device="cpu")):
        assert common._same(a, b), name
    step = jax.jit(lambda s, i, q: jrx.process_block(jcfg, jp, s, (i, q)))
    blocks = capture(n_blocks + 1, C=C, seed=seed,
                     fs=kw.get("iq_rate", 48000.0), **cap)
    js = jrx.init_state(jcfg, jp, (C,))
    _, js, _ = step(js, jnp.asarray(blocks[0][0]), jnp.asarray(blocks[0][1]))
    pair = tcfg if tcfg.front_pair else None
    ts = trx.state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                              device="cpu", cfg=pair)
    audio, leaves = [], []
    for i, q in blocks[1:]:
        yj, js, _ = step(js, jnp.asarray(i), jnp.asarray(q))
        yt, ts, _ = trx.process_block(
            tcfg, tp, ts, (torch.from_numpy(i), torch.from_numpy(q)))
        audio.append(snr_db(np.asarray(yj), yt))
        ss = common.state_snrs(js, ts, pair)
        low = min(ss, key=ss.get)
        leaves.append(ss[low])
        print(f"\n{kw}: audio {audio[-1]:.1f} dB, worst leaf {low} "
              f"{ss[low]:.1f} dB")
    return audio, leaves, ts, js


def _imbalanced(C, T, blk, dtype):
    rng = np.random.default_rng(40 + blk)
    n = np.arange(blk * T, (blk + 1) * T)
    z = (0.4 * np.exp(2j * np.pi * 0.0123 * n)
         * np.linspace(0.3, 1.0, C)[:, None]
         + 0.01 * (rng.standard_normal((C, T))
                   + 1j * rng.standard_normal((C, T))))
    i, q = z.real * 1.07, z.imag + 0.06 * z.real
    if dtype == "int16":
        return (np.round(i * 32767).astype(np.int16),
                np.round(q * 32767).astype(np.int16))
    return i.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "int16"])
def test_correct_matches_jax_streamed(dtype):
    C, T = 3, 2048
    js, ts = jiq.init_state((C,)), tiq.init_state((C,))
    for blk in range(3):
        i, q = _imbalanced(C, T, blk, dtype)
        if dtype == "int16":
            sc = np.float32(1.0 / 32768.0)
            ji, jq = (jnp.asarray(i.astype(np.float32) * sc),
                      jnp.asarray(q.astype(np.float32) * sc))
        else:
            ji, jq = jnp.asarray(i), jnp.asarray(q)
        yi, yq, js = jiq.correct(js, ji, jq)
        ti, tq, ts = tiq.correct(ts, torch.from_numpy(i), torch.from_numpy(q))
        assert ti.dtype == tq.dtype == torch.float32
        assert snr_db(np.asarray(yi), ti) >= MODULE_DB
        assert snr_db(np.asarray(yq), tq) >= MODULE_DB
        for f in tiq.IqCorrState._fields:
            a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
            if f == "twinpeak":
                np.testing.assert_array_equal(a, b)
            else:
                assert snr_db(a, b) >= MODULE_DB, (blk, f)
    # the estimate settled on the imbalance: c2 ~ 1 / 1.07, c1 ~ -0.06 /
    # 1.07 (q' = q + c1 i, i' = c2 i), and no twin-peaks suspicion
    assert np.allclose(ts.c2.numpy(), 1 / 1.07, atol=0.01)
    assert np.allclose(ts.c1.numpy(), -0.06 / 1.07, atol=0.01)
    assert not ts.twinpeak.any()


def test_twinpeaks_flag_matches_jax():
    """A phase error past ~24 degrees raises the flag in both packages."""
    C, T = 2, 4096
    n = np.arange(T)
    z = 0.4 * np.exp(2j * np.pi * 0.01 * n)
    i = np.stack([z.real, z.real]).astype(np.float32)
    q = np.stack([z.imag, z.imag + 0.9 * z.real]).astype(np.float32)
    _, _, js = jiq.correct(jiq.init_state((C,)), jnp.asarray(i),
                           jnp.asarray(q))
    _, _, ts = tiq.correct(tiq.init_state((C,)), torch.from_numpy(i),
                           torch.from_numpy(q))
    np.testing.assert_array_equal(np.asarray(js.twinpeak), ts.twinpeak)
    assert ts.twinpeak.tolist() == [False, True]


def test_correct_refuses_a_ragged_block():
    with pytest.raises(ValueError):
        tiq.correct(tiq.init_state((2,)), torch.zeros((2, 100)),
                    torch.zeros((2, 100)))


# (RxConfig fields, audio bound, leaf bound) after the hand-over; measured
# audio / worst leaf over the two blocks: usb 115.5 / 108.2 dB, am 113.5 /
# 109.9, ssbstereo 113.5 / 105.2, FM at 96 kHz 98.6 / 96.6 (its lifted
# front's ~1e-9 taps turn the corrected planes' last bits into
# discriminator angles; the uncorrected FM reads 130.8-133.4 there)
@pytest.mark.parametrize("kw,audio_db,leaf_db", [
    (dict(mode="usb", bw_key="2P3KHZ", iq_auto_correction=True), 105.0,
     100.0),
    (dict(mode="am", bw_key="2P5KHZ", iq_auto_correction=True), 105.0,
     100.0),
    (dict(mode="ssbstereo", bw_key="2P3KHZ", iq_auto_correction=True),
     105.0, 100.0),
    (dict(mode="fm", bw_key="5P0KHZ", path_name="FM", translate_hz=12000.0,
          iq_rate=96000.0, iq_auto_correction=True), 95.0, 90.0)],
    ids=["usb", "am", "ssbstereo", "fm96"])
def test_chain_with_iq_correction_matches_jax(kw, audio_db, leaf_db):
    audio, leaves, ts, _ = chain_vs_jax(kw)
    assert min(audio) >= audio_db, audio
    assert min(leaves) >= leaf_db, leaves
    assert ts.iqcorr is not None and ts.iqcorr.teta2.shape == (3,)
