"""The port's two-channel RX modes on the CPU (the kernels' plain torch
versions) against the JAX package:

* K13's plain version (`cuda/agc.py::agc_scan_plain`) against the TPU
  kernel `agc_scan_pallas` in interpret mode (its own CPU route) and
  against `_run_machine`'s XLA scan, over streamed blocks;
* `ops/agc.py::run_stereo` against the JAX linked stereo AGC over three
  blocks, every leaf, with and without the DC blocker;
* the two-filter front (K1's plain version with two stage-B filters)
  against the JAX package's fused input-rate pair filter;
* SAM's stereo sideband against the JAX demodulator;
* the ssbstereo and iq chains at 48 and 96 kHz and SAM stereo at 48 kHz
  against `rx.process_block` over four streamed int16 blocks from zero
  state, with the hand-over after block 2 in both directions; SAM stereo
  at 96 kHz through the hand-over only.

Tolerances.  K13's plain version repeats the Pallas kernel's operations,
but XLA's CPU code for the interpret-mode kernel fuses the back-averages'
multiply-add (a*fba + b*ax) into one FMA: emulating that fusion in the
plain walk makes the back-averages equal and volts agree to 1e-7 of
their peak.  So volts and the machine leaves are held to max |err| <=
1e-6 of the value's peak (measured <= 4e-10), the integer-valued ones
(state, hang counter, decay type) equal, and the two back-averages, whose
rounding differences accumulate over the stream, to 100 dB (`-s` prints
them).  Against the XLA scan, whose
back-averages are blocked matmuls, the back-averages drift (ROADMAP
section C): 85 dB over three blocks, as for every linked-AGC leaf.  SAM
stereo's demodulator: 75 dB, the mono test's bound
(tests/test_torch_sam.py).  Chains: 80 dB on audio and every float leaf
(`-s` prints them); SAM stereo at 96 kHz from zero state only 10 dB, as
SAM mono (tests/test_torch_rx_sam.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_rx as common
from uhsdr_tpu.chain import rx as jrx
from uhsdr_tpu.demod import sam as jsam
from uhsdr_tpu.ops import agc as jagc
from uhsdr_tpu.ops import fir as jfir
from uhsdr_tpu.pallas import agc as pagc
from uhsdr_tpu_torch.chain import rx as trx
from uhsdr_tpu_torch.cuda import agc as agc_k
from uhsdr_tpu_torch.cuda import fir as fir_k
from uhsdr_tpu_torch.demod import sam as tsam
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.ops import agc as tagc
from uhsdr_tpu_torch.ops import nco

AGC_DB = 85.0
PALLAS_REL = 1e-6
BACKAVG_DB = 100.0
SAM_DB = 75.0


def _gated_detector(rng, C, T, t0, fs, w):
    """|x| for the AGC machine, (C, T + w): 700 Hz bursts at -20 ... +80 dB
    re 1, gated on and off with periods of 64 ... 784 samples across
    channels, plus noise, so that the machine walks its states (0-3 seen
    on this input)."""
    c = np.arange(C)[:, None]
    n = np.arange(t0, t0 + T + w)
    gate = (n[None, :] // (64 + 48 * (c % 16))) % 3 == 0
    x = (np.logspace(-1, 4, C)[:, None] * np.sin(2 * np.pi * 700 * n / fs)
         * gate + rng.standard_normal((C, T + w)) * 0.5)
    return torch.from_numpy(np.abs(x).astype(np.float32))


def test_agc_scan_plain_matches_pallas_and_xla_scan():
    """agc_scan_pallas asserts C % 1024 == 0 and T % 256 == 0."""
    fs, C, T = 12000.0, 1024, 256
    jp = jagc.make_params(fs, hang_enable=True)
    tp = tagc.make_params(fs, hang_enable=True)
    p = tagc.kernel_params(tp).scalars
    pp = jagc._pallas_params(jp, np.float32(jp.hang_time_samples),
                             fused=False, scalar=True)
    w = tp.attack_buffsize
    rng = np.random.default_rng(31)
    # from a mid-stream carry (volts and the back-averages at each
    # channel's level), so that the machine leaves its fast decay
    lv = np.logspace(-1, 4, C).astype(np.float32)
    c0 = np.zeros((7, C), np.float32)
    c0[0] = c0[1] = lv
    c0[5] = c0[6] = 0.5 * lv
    carry_p, carry_t = jnp.asarray(c0), torch.from_numpy(c0.copy())
    js = jagc.init_state((C,), jp)._replace(
        volts=jnp.asarray(lv), save_volts=jnp.asarray(lv),
        fast_backaverage=jnp.asarray(0.5 * lv),
        hang_backaverage=jnp.asarray(0.5 * lv))
    states = set()
    for blk in range(3):
        a = _gated_detector(rng, C, T, blk * T, fs, w)
        rm = agc_k.look_ahead_max(a, w, T).contiguous()
        ax = a[:, :T].contiguous()
        vp, carry_p = pagc.agc_scan_pallas(pp, carry_p, jnp.asarray(rm),
                                           jnp.asarray(ax))
        # the port walks the block in 32-step pieces, carry handed on (the
        # same arithmetic as one call), recording the machine's states
        vts = []
        for t in range(0, T, 32):
            v, carry_t = agc_k.agc_scan_plain(p, carry_t, rm[:, t:t + 32],
                                              ax[:, t:t + 32])
            vts.append(v)
            states |= set(np.unique(carry_t[4].numpy()).tolist())
        vt = torch.cat(vts, dim=-1)
        vx, mach = jagc._run_machine(jp, js, jnp.asarray(rm), jnp.asarray(ax))
        js = js._replace(**dict(zip(
            ("volts", "save_volts", "hang_counter", "decay_type", "state",
             "fast_backaverage", "hang_backaverage"), mach)))
        cp, ct = np.asarray(carry_p), carry_t.numpy()
        rel = {f: float(np.abs(r - t).max() / max(1.0, np.abs(r).max()))
               for f, r, t in zip(("volts series",) + tagc.CARRY_FIELDS,
                                  [np.asarray(vp)] + list(cp),
                                  [vt.numpy()] + list(ct))}
        xla = {f: snr_db(np.asarray(mach[i]), carry_t[i])
               for i, f in enumerate(tagc.CARRY_FIELDS)}
        xla["volts series"] = snr_db(np.asarray(vx), vt)
        print(f"\nK13 plain block {blk}: vs the TPU kernel, max|err| of "
              f"the peak: " + ", ".join(f"{f} {e:.1e}" for f, e in
                                        rel.items())
              + f"; vs the XLA scan worst {min(xla.values()):.1f} dB")
        avg = ("fast_backaverage", "hang_backaverage")
        assert max(e for f, e in rel.items() if f not in avg) <= PALLAS_REL
        avg_db = min(snr_db(cp[i], ct[i]) for i in (5, 6))
        print(f"  back-averages vs the TPU kernel: {avg_db:.1f} dB")
        assert avg_db >= BACKAVG_DB, avg_db
        np.testing.assert_array_equal(cp[2:5], ct[2:5])
        assert min(xla.values()) >= AGC_DB, xla
        states |= set(np.unique(carry_t[4].numpy()).tolist())
    assert len(states) >= 3, states


@pytest.mark.parametrize("fs,remove_dc", [(12000.0, False), (24000.0, True)])
def test_run_stereo_matches_jax(fs, remove_dc):
    jp = jagc.make_params(fs, hang_enable=True, remove_dc=remove_dc)
    tp = tagc.make_params(fs, hang_enable=True, remove_dc=remove_dc)
    C, T = 64, 2048
    rng = np.random.default_rng(32)
    js = jagc.init_state_stereo((C,), jp)
    ts = tagc.init_state_stereo((C,), tp)
    run = jax.jit(lambda s, x: jagc.run_stereo(jp, s, x))
    c = np.arange(C)[:, None]
    for blk in range(3):
        n = np.arange(blk * T, (blk + 1) * T)
        gate = (n[None, :] // (64 + 48 * (c % 16))) % 3 == 0
        lv = np.logspace(-1, 4, C)[:, None]
        x = np.stack([lv * np.sin(2 * np.pi * 700 * n / fs) * gate,
                      0.5 * lv * np.cos(2 * np.pi * 1100 * n / fs)
                      * gate[:, ::-1]], axis=1)
        x = (x + rng.standard_normal(x.shape) * 0.5).astype(np.float32)
        yj, js = run(js, jnp.asarray(x))
        yt, ts = tagc.run_stereo(tp, ts, torch.from_numpy(x))
        assert tuple(yt.shape) == (C, 2, T)
        # the delay line holds storage of its own size, not a view of the
        # block's concatenation
        assert (ts.delay.untyped_storage().nbytes()
                == 4 * C * 2 * tp.attack_buffsize)
        leaves = {f: snr_db(np.asarray(getattr(js, f)), getattr(ts, f))
                  for f in tagc.AgcState._fields}
        leaves["audio"] = snr_db(np.asarray(yj), yt)
        low = min(leaves, key=leaves.get)
        print(f"\nrun_stereo fs {fs:.0f} dc {remove_dc} block {blk}: audio "
              f"{leaves['audio']:.1f} dB, worst leaf {low} {leaves[low]:.1f}")
        assert leaves[low] >= AGC_DB, leaves
    assert tuple(ts.delay.shape) == (C, 2, tp.attack_buffsize)
    assert tuple(ts.dc.shape) == (C, 2, 2) and ts.volts.shape == (C,)


@pytest.mark.parametrize("mode,iq_rate", [("ssbstereo", 96000.0),
                                          ("iq", 48000.0)])
def test_front_pair_plain_matches_jax_pair_filter(mode, iq_rate):
    """The port's factored front (stage A, then g0 and g1 at fs_dec)
    against the JAX package's (2, taps) input-rate pair (its CPU route,
    `fir_decimate_block` on the NCO-mixed signal), over three streamed
    blocks from a random NCO phase; and the factors convolved back
    (upsampled by the decimation) against the pair's taps."""
    kw = dict(mode=mode, bw_key="2P3KHZ", translate_hz=12000.0,
              iq_rate=iq_rate)
    jcfg, tcfg = jrx.RxConfig(**kw), trx.RxConfig(**kw)
    jp, tp = jrx.make_params(jcfg), trx.make_params(tcfg, device="cpu")
    pair = np.asarray(jp.front_fir_re) + 1j * np.asarray(jp.front_fir_im)
    h = tp.front_fir.numpy().astype(np.float64)
    g = tp.front2.numpy().astype(np.complex128)
    D = tcfg.decim
    for k in range(2):
        up = np.zeros(D * (g.shape[-1] - 1) + 1, complex)
        up[::D] = g[k]
        assert snr_db(pair[k], np.convolve(h, up)) >= 130.0
    C, B = 4, 1024
    n_keep = trx._raw_history_len(tcfg, tp)
    assert pair.shape == (2, n_keep + 1)
    rng = np.random.default_rng(33)
    phase = torch.from_numpy(rng.integers(0, 2**32, C))
    delta = tp.nco_delta
    carry = torch.zeros((C, n_keep), dtype=torch.complex64)
    carry2 = torch.zeros((C, tp.front2.shape[-1] - 1),
                         dtype=torch.complex64)
    jcarry = jnp.zeros((C, 2, n_keep), jnp.complex64)
    for blk in range(3):
        i16 = rng.integers(-3000, 3000, (C, B)).astype(np.int16)
        q16 = rng.integers(-3000, 3000, (C, B)).astype(np.int16)
        y, carry, carry2, _ = fir_k.front_plain(
            tp.front_fir, tp.front2, carry, carry2, torch.from_numpy(i16),
            torch.from_numpy(q16), phase, delta, D)
        # the JAX CPU route: mix the block and the raw history, filter
        z = (i16 + 1j * q16).astype(np.complex64) / np.float32(32768.0)
        rot = nco.rotor(nco.phase_ramp(phase, delta, B)).numpy()
        hrot = nco.rotor(nco.phase_ramp(phase, delta, n_keep,
                                        start=-n_keep)).numpy()
        zm = jnp.asarray(np.broadcast_to((z * rot)[:, None], (C, 2, B)))
        yj, _ = jfir.fir_decimate_block(jnp.asarray(pair.astype(np.complex64)),
                                        jcarry * hrot[:, None, :], zm, D)
        jcarry = jnp.concatenate([jcarry, jnp.broadcast_to(
            jnp.asarray(z)[:, None], (C, 2, B))], axis=-1)[..., B:]
        s = snr_db(np.real(np.asarray(yj)), y)
        print(f"\n{mode} @ {iq_rate:.0f}: factored front vs the JAX pair "
              f"filter, block {blk}: {s:.1f} dB")
        assert s >= 100.0
        np.testing.assert_array_equal(carry.numpy(),
                                      np.asarray(jcarry)[:, 0])
        phase = nco.advance(phase, delta, B)


def test_sam_stereo_demod_matches_jax():
    from tests.test_torch_sam import _carrier, _state_snrs
    fs = 24000.0
    jp, tp = jsam.make_params(fs), tsam.make_params(fs)
    C, T = 8, 1024
    rng = np.random.default_rng(34)
    js = jsam.init_state((C,), n_audio=2)
    ts = tsam.init_state((C,), n_audio=2)
    x = _carrier(rng, C, 3 * T, f_off=21.0, am=0.5, noise=0.01, fs=fs)
    for k in range(3):
        blk = x[:, k * T:(k + 1) * T]
        yj, oj, js = jsam.demod(jp, js, jnp.asarray(blk), "stereo", True)
        yt, ot, ts = tsam.demod(tp, ts, torch.from_numpy(blk), "stereo",
                                True)
        assert tuple(yt.shape) == (C, 2, T)
        leaves = _state_snrs(js, ts)
        leaves["audio"] = snr_db(np.asarray(yj), yt)
        low = min(leaves, key=leaves.get)
        print(f"\nSAM stereo block {k}: audio {leaves['audio']:.1f} dB, "
              f"worst {low} {leaves[low]:.1f} dB")
        assert leaves[low] >= SAM_DB, leaves
    assert tuple(ts.fade.dc.shape) == (C, 2)


@pytest.mark.parametrize("mode,iq_rate", [
    ("ssbstereo", 48000.0), ("ssbstereo", 96000.0), ("iq", 48000.0),
    ("iq", 96000.0)])
def test_two_channel_chain_matches_jax_streamed(mode, iq_rate):
    common.run_streamed_both_ways(
        dict(mode=mode, bw_key="2P3KHZ", iq_rate=iq_rate), common.CHAIN_DB)


def test_sam_stereo_chain_matches_jax_streamed_48k():
    common.run_streamed_both_ways(
        dict(mode="sam", bw_key="3P6KHZ", iq_rate=48000.0,
             sam_sideband="stereo"), common.CHAIN_DB)


def test_sam_stereo_chain_hands_over_96k():
    """From zero state the 96 kHz SAM loops pull in along different paths
    (tests/test_torch_rx_sam.py); through the hand-over, 80 dB."""
    common.run_streamed_both_ways(
        dict(mode="sam", bw_key="5P0KHZ", iq_rate=96000.0,
             sam_sideband="stereo"), 10.0)


def test_two_channel_params_and_state_layout():
    """The port's params equal the JAX ones but for the factored front;
    the state carries the audio-channel axis after C, the pair's raw
    history once and the stage-A history."""
    cfg = trx.RxConfig(mode="ssbstereo", bw_key="2P3KHZ", path_name="LPF",
                       translate_hz=12000.0, iq_rate=96000.0)
    assert cfg.n_audio == 2 and cfg.front_pair
    assert trx.RxConfig(mode="sam", sam_sideband="stereo").n_audio == 2
    p = trx.make_params(cfg, device="cpu")
    assert (p.front_fir.shape[-1], tuple(p.front2.shape)) == (227, (2, 199))
    s = trx.init_state(cfg, p, (3,))
    assert tuple(s.front_carry.shape) == (3, 1810)
    assert tuple(s.front2_carry.shape) == (3, 198)
    assert tuple(s.agc.delay.shape) == (3, 2, 48)
    assert tuple(s.interp_carry.shape)[:2] == (3, 2)
    assert tuple(s.audio_sos_state.shape) == (5, 3, 2, 2)
    n = trx.state_to_numpy(s, cfg)
    assert n["front_carry"].shape == (3, 2, 1810) and "front2_carry" not in n


@pytest.mark.parametrize("mode", ["ssbstereo", "iq"])
def test_two_channel_retune_matches_jax(mode):
    """The dial moved between blocks 1 and 2 (+350 Hz twice, then
    -1234.5 Hz twice) on a two-channel front at 48 kHz.  The reference
    mixes its pair's whole raw history with the block's delta
    (chain/rx.py:742-755 of the JAX package), so the port rebuilds the
    stage-A history from the carried raw history on every retuned block:
    audio and every state leaf >= 80 dB in every block (`-s` prints
    them)."""
    kw = dict(mode=mode, bw_key="2P3KHZ", translate_hz=12000.0,
              iq_rate=48000.0, block_len=common.AM_B)
    jcfg = jrx.RxConfig(**kw)
    jp = jrx.make_params(jcfg)
    tuned = jax.jit(lambda s, i, q, t: jrx.process_block(
        jcfg, jp, s, (i, q), tune_offset_hz=t))
    tcfg = trx.RxConfig(**kw)
    chain = trx.RxChain(tcfg, device="cpu")
    js = jrx.init_state(jcfg, jp, (common.C,))
    ts = chain.init_state((common.C,))
    blocks = common.am_capture(4, jcfg.iq_rate)
    for k, (blk, off) in enumerate(zip(blocks, (350.0, 350.0, -1234.5,
                                                -1234.5))):
        yj, js, _ = tuned(js, jnp.asarray(blk[0]), jnp.asarray(blk[1]),
                          jnp.float32(off))
        yt, ts, _ = chain(ts, i=blk[0], q=blk[1], tune_offset_hz=off)
        leaves = common.state_snrs(js, ts, tcfg)
        leaves["audio"] = snr_db(np.asarray(yj), yt)
        low = min(leaves, key=leaves.get)
        print(f"\n{mode} retune, block {k} (offset {off} Hz): audio "
              f"{leaves['audio']:.1f} dB, worst {low} {leaves[low]:.1f} dB")
        assert leaves[low] >= common.CHAIN_DB, (k, low, leaves[low])
