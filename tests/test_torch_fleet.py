"""The port's mixed-mode fleet (`uhsdr_tpu_torch.parallel.fleet`) on the
CPU, where the kernels' wrappers run their plain torch versions.

* `ChannelFleet.process_block_device` (the fused step with cross-group
  stage batching) against the JAX package's, four groups at 48 kHz:
  usb 2P3KHZ (AGC threshold 60 dB), cw 500HZ (70 dB), am 2P5KHZ (55 dB)
  and fm 5P0KHZ, 2-3 channels each, 2048-sample blocks.  The JAX fleet
  runs one block first and every group's state goes to the port
  (`state_from_numpy`): from zero state the JAX CPU front's FFT rounding
  noise turns into FM discriminator angles (ROADMAP section C; the FM
  group read 88.0 dB in block 0 of this capture, the others >= 106).
  Then three streamed blocks on both: each group's audio >= 90 dB,
  every state leaf >= 85 dB (the
  AGC back-averages' f32 drift, ROADMAP section C; the PreFilter states
  carry the JAX CPU route's dilated-scan error, 87.9 dB from float64
  there).  The three 12 kHz groups share their AGC time constants, so
  their AGC runs as ONE K3 call over 7 channels with per-channel
  gain-law rows: all three rows differ (thresholds 60, 70, 55 dB);
* `process_block` (host NumPy in and out, each group's own chain) the
  same against the JAX package's;
* a two-channel group (ssbstereo) beside a mono one: the JAX fleet's
  fused step sends its (C, 2, T) audio to the mono AGC and fails
  (ROADMAP section C), so the port, which runs the group's linked
  `run_stereo` as its chain does, is held against the JAX chains run
  one by one;
* in the port, the fused step against `step_separate` (each group's own
  chain) on the same blocks: audio and every state leaf bit for bit, or
  >= 130 dB.  usb 2P3KHZ and cw 500HZ share both front stages (CW's
  narrow filter is its PreFilter), so their fronts run as one call over
  5 channels, and the 12 kHz groups' interpolations as one over 7.  On
  the card each kernel computes a channel on its own and the fleet is
  bit-equal (tests/test_torch_cuda.py, chip_smoke.py); on the CPU the
  plain versions of both stages are BLAS products (`ops.fir`'s unfolded
  frames times the taps), whose rounding may depend on the number of
  rows, so a merged group may differ in the last bits there.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_rx as common
from uhsdr_tpu.chain import rx as jrx
from uhsdr_tpu.parallel import fleet as jfleet
from uhsdr_tpu_torch.chain import rx as trx
from uhsdr_tpu_torch.cuda import agc as agc_k
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.parallel import fleet as tfleet

AUDIO_DB = 90.0
LEAF_DB = 85.0
T, FS, TRANSLATE = 2048, 48000.0, 6000.0
GROUPS = [
    dict(mode="usb", bw_key="2P3KHZ", path_name="LPF", agc_thresh_db=60.0),
    dict(mode="cw", bw_key="500HZ", path_name="750Hz", agc_thresh_db=70.0),
    dict(mode="am", bw_key="2P5KHZ", path_name="AM/SAM",
         agc_thresh_db=55.0),
    dict(mode="fm", bw_key="5P0KHZ", path_name="FM"),
]
ASSIGN = [0, 1, 2, 0, 1, 2, 3, 1, 3]       # 2, 3, 2 and 2 channels


def _kw(g):
    return dict(g, translate_hz=TRANSLATE, block_len=T)


def group_planes(mode: str, n: int, blk: int, rng):
    """f32 IQ planes of one group's n channels: SSB/CW a tone in the
    passband, AM a carrier 50% modulated, FM a carrier deviated 2 kHz by
    a tone; levels -6 ... -40 dBFS across the channels, plus noise."""
    t = np.arange(blk * T, (blk + 1) * T) / FS
    c = np.arange(n)[:, None]
    amp = 0.5 * 10.0 ** (-np.linspace(6, 40, n) / 20.0)[:, None]
    if mode in ("usb", "cw"):
        off = (700.0 if mode == "usb" else 750.0) + 37.0 * c
        z = amp * np.exp(2j * np.pi * (TRANSLATE + off) * t)
    elif mode == "am":
        z = (amp * (1 + 0.5 * np.sin(2 * np.pi * (400 + 50 * c) * t))
             * np.exp(1j + 2j * np.pi * (TRANSLATE + 3 * c) * t))
    else:
        f_mod = 1000.0 + 100.0 * c
        z = amp * np.exp(1j * (2 * np.pi * (TRANSLATE + 50.0 * c) * t
                               + (2000.0 / f_mod)
                               * np.sin(2 * np.pi * f_mod * t)))
    z = z + 1e-3 * (rng.standard_normal(z.shape)
                    + 1j * rng.standard_normal(z.shape))
    return z.real.astype(np.float32), z.imag.astype(np.float32)


def _blocks(groups, n_blocks, seed=5):
    rng = np.random.default_rng(seed)
    return [[group_planes(g.cfg.mode, g.channel_idx.size, b, rng)
             for g in groups] for b in range(n_blocks)]


@pytest.fixture
def agc_calls(monkeypatch):
    """(channels, rows given) of every K3 call the port makes."""
    calls = []
    real = agc_k.agc

    def spy(p, carry, delay, x, rows=None):
        calls.append((x.shape[0], rows is not None))
        return real(p, carry, delay, x, rows)

    monkeypatch.setattr(agc_k, "agc", spy)
    return calls


def _hold(jgroups, tgroups, outs_j, outs_t, k):
    for gj, gt, yj, yt in zip(jgroups, tgroups, outs_j, outs_t):
        leaves = common.state_snrs(gj.state, gt.state, gt.cfg)
        worst = min(leaves, key=leaves.get)
        audio = snr_db(np.asarray(yj), yt)
        print(f"\nblock {k} {gt.cfg.mode}: audio {audio:.1f} dB, worst "
              f"leaf {worst} {leaves[worst]:.1f} dB")
        assert audio >= AUDIO_DB, (k, gt.cfg.mode, audio)
        assert leaves[worst] >= LEAF_DB, (k, gt.cfg.mode, worst,
                                          leaves[worst])


def test_fleet_matches_jax_streamed(agc_calls):
    jf = jfleet.ChannelFleet([jrx.RxConfig(**_kw(g)) for g in GROUPS],
                             ASSIGN)
    tf = tfleet.ChannelFleet([trx.RxConfig(**_kw(g)) for g in GROUPS],
                             ASSIGN, device="cpu")
    assert tf.group_sizes == jf.group_sizes
    blocks = _blocks(tf.groups, 4)
    jf.process_block_device([(jnp.asarray(i), jnp.asarray(q))
                             for i, q in blocks.pop(0)])
    for gj, gt in zip(jf.groups, tf.groups):
        gt.state = trx.state_from_numpy(
            jax.tree_util.tree_map(np.asarray, gj.state), device="cpu")
    for k, planes in enumerate(blocks):
        outs_j = jf.process_block_device(
            [(jnp.asarray(i), jnp.asarray(q)) for i, q in planes])
        del agc_calls[:]
        outs_t = tf.process_block_device(
            [(torch.from_numpy(i), torch.from_numpy(q)) for i, q in planes])
        # the 12 kHz groups' AGC: one call over 7 channels with rows; FM
        # (48 kHz) on its own, with scalars
        assert sorted(agc_calls) == [(2, False), (7, True)], agc_calls
        _hold(jf.groups, tf.groups, outs_j, outs_t, k)
        assert [tuple(y.shape) for y in outs_t] == [(2, T), (3, T), (2, T),
                                                    (2, T)]


def test_fleet_process_block_matches_jax():
    jf = jfleet.ChannelFleet([jrx.RxConfig(**_kw(g)) for g in GROUPS[:3]],
                             ASSIGN[:6])
    tf = tfleet.ChannelFleet([trx.RxConfig(**_kw(g)) for g in GROUPS[:3]],
                             ASSIGN[:6], device="cpu")
    for k, planes in enumerate(_blocks(tf.groups, 3, seed=6)):
        i = np.empty((6, T), np.float32)
        q = np.empty((6, T), np.float32)
        for g, (gi, gq) in zip(tf.groups, planes):
            i[g.channel_idx], q[g.channel_idx] = gi, gq
        yj = jf.process_block(i, q)
        yt = tf.process_block(i, q)
        assert yt.shape == (6, T) and yt.dtype == np.float32
        for g in tf.groups:
            idx = g.channel_idx
            assert snr_db(yj[idx], yt[idx]) >= AUDIO_DB, (k, g.cfg.mode)
        _hold(jf.groups, tf.groups, [yj[g.channel_idx] for g in tf.groups],
              [torch.from_numpy(yt[g.channel_idx]) for g in tf.groups], k)


def test_two_channel_group_against_jax_chains():
    kws = [_kw(GROUPS[0]),
           _kw(dict(GROUPS[0], mode="ssbstereo", agc_thresh_db=50.0))]
    jf = jfleet.ChannelFleet([jrx.RxConfig(**kw) for kw in kws],
                             [0, 1, 0, 1])
    tf = tfleet.ChannelFleet([trx.RxConfig(**kw) for kw in kws],
                             [0, 1, 0, 1], device="cpu")
    blocks = _blocks(tf.groups, 3, seed=7)
    with pytest.raises(TypeError):     # the reference's fused step
        jf.process_block_device([(jnp.asarray(i), jnp.asarray(q))
                                 for i, q in blocks[0]])
    for k, planes in enumerate(blocks):
        outs_j = []
        for g, (i, q) in zip(jf.groups, planes):
            y, g.state, _ = g.chain(g.state, i=jnp.asarray(i),
                                    q=jnp.asarray(q))
            outs_j.append(y)
        outs_t = tf.step_fused([(torch.from_numpy(i), torch.from_numpy(q))
                                for i, q in planes])
        assert tuple(outs_t[1].shape) == (2, 2, T)
        _hold(jf.groups, tf.groups, outs_j, outs_t, k)


def test_fused_step_equals_separate_chains(monkeypatch):
    fronts = []
    real = trx.process_front

    def spy(cfg, params, state, iq, tune_offset_hz=None):
        fronts.append((cfg.mode, iq[0].shape[0]))
        return real(cfg, params, state, iq, tune_offset_hz)

    monkeypatch.setattr(trx, "process_front", spy)
    cfgs = [trx.RxConfig(**_kw(g)) for g in GROUPS]
    fused = tfleet.ChannelFleet(cfgs, ASSIGN, device="cpu")
    separate = tfleet.ChannelFleet(cfgs, ASSIGN, device="cpu")
    n_equal = n_all = 0
    for k, planes in enumerate(_blocks(fused.groups, 2, seed=8)):
        tp = [(torch.from_numpy(i), torch.from_numpy(q)) for i, q in planes]
        del fronts[:]
        pairs = {f"{g.cfg.mode} audio": (b.numpy(), a.numpy()) for g, a, b
                 in zip(fused.groups, fused.step_fused(tp),
                        separate.step_separate(tp))}
        assert fronts[:3] == [("usb", 5), ("am", 2), ("fm", 2)], fronts
        for gf, gs in zip(fused.groups, separate.groups):
            lf = trx.state_to_numpy(gf.state)
            ls = trx.state_to_numpy(gs.state)
            assert lf.keys() == ls.keys()
            pairs.update({f"{gf.cfg.mode} {f}": (ls[f], lf[f]) for f in lf})
        for what, (ref, got) in pairs.items():
            n_all += 1
            if np.array_equal(ref, got):
                n_equal += 1
                continue
            db = snr_db(ref, got) if ref.dtype.kind in "fc" else -np.inf
            print(f"\nblock {k}: {what} not bit-equal, {db:.1f} dB")
            assert db >= 130.0, (k, what, db)
    print(f"\n{n_equal} of {n_all} outputs and leaves bit-equal")


def test_iq_corrected_groups_run_their_own_fronts(monkeypatch):
    """A usb group with IQ auto-correction and the NR, another with IQ
    auto-correction alone and a plain usb group, all three on the same
    front: each IQ-corrected group carries its own correction state, so
    the fused step runs three fronts (the reference's fleet never merges
    such a group, uhsdr_tpu/parallel/fleet.py:134-136), and every group
    matches the JAX chain run on its own over three blocks from zero
    state (audio >= 90 dB, every leaf >= 85 dB)."""
    fronts = []
    real = trx.process_front

    def spy(cfg, params, state, iq, tune_offset_hz=None):
        fronts.append((cfg.iq_auto_correction, iq[0].shape[0]))
        return real(cfg, params, state, iq, tune_offset_hz)

    monkeypatch.setattr(trx, "process_front", spy)
    kws = [_kw(dict(GROUPS[0], iq_auto_correction=True, nr_enable=True)),
           _kw(GROUPS[0]), _kw(dict(GROUPS[0], iq_auto_correction=True))]
    tf = tfleet.ChannelFleet([trx.RxConfig(**kw) for kw in kws],
                             [0, 1, 2, 0, 1, 2], device="cpu")
    jchains = [jrx.RxChain(jrx.RxConfig(**kw)) for kw in kws]
    jstates = [c.init_state((2,)) for c in jchains]
    for k, planes in enumerate(_blocks(tf.groups, 3, seed=9)):
        # an imbalance for the correction to take out
        planes = [(i * np.float32(1.1), q + np.float32(0.05) * i)
                  for i, q in planes]
        outs_j = []
        for j, (i, q) in enumerate(planes):
            y, jstates[j], _ = jchains[j](jstates[j], i=jnp.asarray(i),
                                          q=jnp.asarray(q))
            outs_j.append(y)
        del fronts[:]
        outs_t = tf.step_fused([(torch.from_numpy(i), torch.from_numpy(q))
                                for i, q in planes])
        assert sorted(fronts) == [(False, 2), (True, 2), (True, 2)], fronts
        for g, js in zip(tf.groups, jstates):
            g_j = type("G", (), {"state": js})
            _hold([g_j], [g], [outs_j[tf.groups.index(g)]],
                  [outs_t[tf.groups.index(g)]], k)
    assert tf.groups[0].state.nr is not None
    assert bool((tf.groups[0].state.iqcorr.c2 != 1.0).all())
