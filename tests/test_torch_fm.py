"""The port's FM receiver on the CPU against the JAX package:

* the plain K12 (`cuda.elemwise.fm_disc` on CPU tensors) against the TPU
  kernel `pallas.elemwise.fm_disc_pallas` in interpret mode (its
  polynomial atan2) and against NumPy's `arctan2` of the same complex64
  product, two streamed blocks with the carried sample, at max |err| <=
  2e-6 modulo 2 pi (the bound tests/test_pallas_fir.py holds the TPU
  kernel to; an angle at the branch cut may read +pi or -pi);
* `_squelch_scan` (segments between evaluations, no loop over
  sub-blocks) against the reference's sub-block scan from several
  carried counters: the squelch sequence equal, the average at >= 90 dB;
* `demod.fm.demod` against `uhsdr_tpu.demod.fm.demod` over 8 streamed
  blocks of 4096 samples (two squelch evaluations, two subtone windows),
  squelch threshold 0 or 10, subtone detection off or at 88.5 Hz, on
  channels with and without the subtone: squelch and tone decisions
  equal, audio and every float leaf >= 90 dB;
* `RxChain` FM (3P6KHZ and 5P0KHZ at 48 kHz, 5P0KHZ at 96 kHz) against
  the JAX chain over four streamed int16 blocks with the hand-over in
  both directions (tests/test_torch_rx.py::run_streamed_both_ways).

Tolerances of the chains.  From zero state the JAX CPU chain's front (an
FFT convolution) returns rounding noise of ~3e-8 on the first outputs
while the FIR ramps up from an empty history, where the port's dot
products return the exact small values; the discriminator turns that
into angle errors, and the AGC and the squelch average remember them.
At 48 kHz (89 taps, first tap ~5e-5) the errors stay small on this
capture: the 48 kHz chains are held to 80 dB from zero state (`-s`
prints: audio 91.2-97.6 dB in block 0, >= 130.8 from block 1, every
leaf >= 103.7 dB; a capture with its carrier on the translate frequency
at phase 0 read 32 dB in block 0).  At 96 kHz the lifted 239-tap
front's first taps are ~1e-9, the first angles are noise on one side,
and from zero state the two chains meet again only as the AGC and the
squelch average forget (audio 6.5, 23.5, 59.0, 124.8 dB in blocks 0-3,
leaves 12.7-25.2 dB): that chain is held on the last block's audio and
through the hand-over, which holds every chain at 80 dB on audio and
every leaf in either direction (measured >= 130.8 dB).
The conformance row fm 3P6KHZ is in tests/test_torch_conformance.py.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_rx as common
from uhsdr_tpu.demod import fm as jfm
from uhsdr_tpu.pallas import elemwise as pallas_ew
from uhsdr_tpu_torch.cuda import elemwise as ew_k
from uhsdr_tpu_torch.demod import fm as tfm
from uhsdr_tpu_torch.metrics import snr_db

DISC_ABS = 2e-6
DEMOD_DB = 90.0
FS = 48000.0


def wrapped_err(ref, got) -> float:
    d = np.asarray(ref, np.float64) - np.asarray(got, np.float64)
    return float(np.abs((d + np.pi) % (2 * np.pi) - np.pi).max())


def test_fm_disc_plain_matches_pallas_and_numpy():
    rng = np.random.default_rng(0)
    C, T = 8, 1024
    z = (rng.standard_normal((C, 2 * T)) + 1j * rng.standard_normal(
        (C, 2 * T))).astype(np.complex64)
    prev = (rng.standard_normal(C) + 1j * rng.standard_normal(C)).astype(
        np.complex64)
    worst = []
    for k in range(2):
        x = z[:, k * T:(k + 1) * T]
        z_d = np.concatenate([prev[:, None], x[:, :-1]], axis=-1)
        prod = np.conj(z_d) * x
        ref = np.arctan2(prod.imag, prod.real)
        pk = pallas_ew.fm_disc_pallas(
            jnp.stack([jnp.asarray(prev.real), jnp.asarray(prev.imag)], -1),
            jnp.asarray(x.real), jnp.asarray(x.imag), tile_c=8, tile_t=512,
            interpret=True)
        got = ew_k.fm_disc(torch.from_numpy(prev), torch.from_numpy(x))
        planes = ew_k.fm_disc(torch.from_numpy(prev),
                              (torch.from_numpy(x.real.copy()),
                               torch.from_numpy(x.imag.copy())))
        assert got.shape == (C, T) and got.dtype == torch.float32
        assert torch.equal(got, planes)
        worst.append((wrapped_err(ref, got), wrapped_err(pk, got)))
        prev = x[:, -1]
    print(f"\nK12 plain vs arctan2 / vs the TPU kernel: max|err| "
          f"{max(w[0] for w in worst):.2e} / {max(w[1] for w in worst):.2e}")
    assert max(max(w) for w in worst) <= DISC_ABS


@pytest.mark.parametrize("count0,n_sub,thr", [
    (0.0, 256, 10), (150.0, 256, 10), (199.0, 401, 4), (37.0, 64, 0)])
def test_squelch_scan_matches_reference_scan(count0, n_sub, thr):
    """The segment form against the reference's per-sub-block scan, three
    blocks streamed, noise levels that cross the thresholds both ways."""
    rng = np.random.default_rng(int(count0) + n_sub)
    C = 16
    jp = jfm.make_params(FS, thr, 0.0)
    tp = tfm.params_from_numpy(jp, "cpu")
    js = jfm.init_state((C,), jp)._replace(
        sql_count=jnp.full((C,), count0, jnp.float32))
    ts = tfm.init_state((C,), tp)._replace(
        sql_count=torch.full((C,), count0))
    level = np.linspace(0.0, 0.2, C)[:, None]
    flips = 0
    for blk in range(3):
        ns = np.abs(level * (1.0 + 0.5 * np.sin(blk + np.arange(n_sub) / 40)
                             + 0.2 * rng.standard_normal((C, n_sub))))
        ns = ns.astype(np.float32) * (2.0 if blk == 1 else 0.5)
        ja, jc, jsq, jseq = jfm._squelch_scan(jp, js, jnp.asarray(ns))
        ta, tc, tsq, tseq = tfm._squelch_scan(tp, ts, torch.from_numpy(ns))
        np.testing.assert_array_equal(np.asarray(jseq), tseq.numpy())
        np.testing.assert_array_equal(np.asarray(jsq), tsq.numpy())
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
        assert snr_db(np.asarray(ja), ta) >= DEMOD_DB
        flips += int(np.sum(np.asarray(jseq)[:, 1:] != np.asarray(jseq)[:, :-1]))
        js = js._replace(sql_avg=ja, sql_count=jc, squelched=jsq)
        ts = ts._replace(sql_avg=ta, sql_count=tc, squelched=tsq)
    if thr:
        assert flips > 0                  # the hysteresis did switch


def _fm_iq(C, n, fs=FS, subtone=88.5, seed=1):
    """Complex baseband FM: per channel a carrier 100 c Hz off, a 1 kHz
    tone at 2 kHz deviation, on even channels a subtone at 300 Hz
    deviation, amplitudes 1 ... 0.003, complex noise 0.003 rms."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    c = np.arange(C)[:, None]
    amp = np.array([1.0, 0.1, 0.01, 0.003])[c % 4]
    ph = (2 * np.pi * 100 * c * t + 2.0 * np.sin(2 * np.pi * 1000 * t)
          + (c % 2 == 0) * (300.0 / subtone) * np.sin(2 * np.pi * subtone * t))
    z = amp * np.exp(1j * ph) + 0.003 * (rng.standard_normal((C, n))
                                        + 1j * rng.standard_normal((C, n)))
    return z.astype(np.complex64)


@pytest.mark.parametrize("thr,subtone", [(0, 0.0), (10, 0.0), (0, 88.5),
                                         (10, 88.5)])
def test_fm_demod_matches_jax(thr, subtone):
    C, T, n_blocks = 4, 4096, 8
    jp = jfm.make_params(FS, thr, subtone)
    tp = tfm.params_from_numpy(jp, "cpu")
    ref_p = tfm.make_params(FS, thr, subtone, device="cpu")
    assert torch.equal(ref_p.squelch_sos.sos, tp.squelch_sos.sos)
    assert (ref_p.deltas is None) == (tp.deltas is None)
    if tp.deltas is not None:
        assert torch.equal(ref_p.deltas, tp.deltas)
    z = _fm_iq(C, n_blocks * T, subtone=subtone or 88.5)
    js, ts = jfm.init_state((C,), jp), tfm.init_state((C,), tp)
    step = jax.jit(lambda s, x: jfm.demod(jp, s, x))
    audio_db, worst = [], math.inf
    for k in range(n_blocks):
        x = z[:, k * T:(k + 1) * T]
        yj, js = step(js, jnp.asarray(x))
        yt, ts = tfm.demod(tp, ts, torch.from_numpy(x))
        audio_db.append(snr_db(np.asarray(yj), yt))
        for f in tfm.FmState._fields:
            a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
            if a.dtype == bool or a.dtype.kind in "iu":
                np.testing.assert_array_equal(a.astype(np.int64),
                                              b.astype(np.int64), f)
            else:
                s = snr_db(a, b)
                worst = min(worst, s)
                assert s >= DEMOD_DB, (k, f, s)
        # the gate: zeros exactly where the reference's are
        np.testing.assert_array_equal(np.asarray(yj) == 0, yt.numpy() == 0)
    print(f"\nfm demod thr={thr} subtone={subtone}: audio "
          f"{min(audio_db):.1f}-{max(audio_db):.1f} dB, worst float leaf "
          f"{worst:.1f} dB, squelched {ts.squelched.tolist()}, tone "
          f"{ts.tone_detected.tolist()}")
    assert min(audio_db) >= DEMOD_DB
    if thr:
        assert ts.squelched.any() and not ts.squelched.all()
    if subtone:
        # two windows: the tone channels (even) detected, the clean one
        # without it (1) not; channel 3 sits at 0 dB SNR
        assert ts.tone_detected[:3].tolist() == [True, False, True]


def fm_capture(n_blocks, iq_rate, seed=31, translate=12000.0):
    """int16 IQ blocks for the FM chains: per channel a carrier 50 c Hz
    above the translate frequency at -6 ... -40 dBFS, FM by a (1000 +
    100 c) Hz tone at 2 kHz deviation, plus noise of 30 counts rms."""
    rng = np.random.default_rng(seed)
    B, C = common.AM_B, common.C
    n = np.arange(n_blocks * B)
    c = np.arange(C)[:, None]
    amp = 0.5 * 32767.0 * 10.0 ** (-np.linspace(6, 40, C) / 20.0)[:, None]
    f_mod = 1000.0 + 100.0 * c
    ph = (2 * np.pi * (translate + 50.0 * c) * n / iq_rate
          + (2000.0 / f_mod) * np.sin(2 * np.pi * f_mod * n / iq_rate))
    z = amp * np.exp(1j * ph) + (rng.standard_normal((C, n.size))
                                 + 1j * rng.standard_normal((C, n.size))) * 30
    i16 = np.clip(np.round(z.real), -32768, 32767).astype(np.int16)
    q16 = np.clip(np.round(z.imag), -32768, 32767).astype(np.int16)
    return [(i16[:, k * B:(k + 1) * B], q16[:, k * B:(k + 1) * B])
            for k in range(n_blocks)]


@pytest.mark.parametrize("bw,iq_rate,sql", [("3P6KHZ", 48000.0, 0),
                                            ("5P0KHZ", 48000.0, 10),
                                            ("5P0KHZ", 96000.0, 0)])
def test_fm_chain_matches_jax_streamed(bw, iq_rate, sql):
    """FM at 48 kHz (decimation 1, 89 taps) and 96 kHz (decimation 2, the
    239-tap lifted front): audio at 48 kHz, AGC look-ahead 192."""
    kw = dict(mode="fm", bw_key=bw, iq_rate=iq_rate, sql_threshold=sql)
    zero_db = common.CHAIN_DB if iq_rate == 48000.0 else -math.inf
    common.run_streamed_both_ways(kw, zero_db, capture=fm_capture,
                                  last_audio_db=common.CHAIN_DB)
