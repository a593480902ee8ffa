"""The port's spectral NR (`uhsdr_tpu_torch.nr.spectral`, the gain
machine's plain version on the CPU) and the framing and windows of
`ops.fftutil` against the JAX package's, against the float64 oracle
`tests/golden/ref_nr.py`, and the chains with `nr_enable` against the JAX
chains.

* the windows bit-equal; `frame_overlap` / `overlap_add` equal to the JAX
  package's at hops that divide the frame and that do not;
* `process_block` through the 20-frame bootstrap and 28 frames past it
  (six blocks of 1024 at 12 kHz, three channels): output and every state
  leaf >= 110 dB, the frame counter equal (measured 118.6-inf dB).  Both
  packages run pocketfft on the CPU, not the same build; the band sums
  are a pairwise tree in the port, XLA's order in the JAX package, so a
  smoothing width can flip where the ratio sits on a boundary: none did
  here;
* the bootstrap freezes pslp and hk_old, as the JAX package's test holds
  (tests/test_golden_nr.py:52-64);
* every frame past the bootstrap > 100 dB against the float64 oracle, as
  the JAX package's own test (tests/test_golden_nr.py:26-49);
* `RxChain` with the NR (usb at three strengths, am, ssbstereo), 3
  channels, the JAX chain's state after one block handed over, two
  blocks at the bounds written beside each case.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden import ref_nr
from tests.test_golden_nr import _frame_snrs
from tests.test_torch_iqcorr import chain_vs_jax
from uhsdr_tpu.nr import spectral as jnr
from uhsdr_tpu.ops import fftutil as jfft
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.nr import spectral as tnr
from uhsdr_tpu_torch.ops import fftutil as tfft

MODULE_DB = 110.0
FS = 12000.0


def test_windows_and_framing_match_jax():
    for n in (16, 256):
        for name in ("hann", "sqrt_hann", "sqrt_hann_sym"):
            np.testing.assert_array_equal(getattr(tfft, name)(n),
                                          getattr(jfft, name)(n))
    rng = np.random.default_rng(1)
    for frame, hop, T in ((256, 128, 1024 + 128), (8, 3, 8 + 3 * 9)):
        x = rng.standard_normal((2, T)).astype(np.float32)
        fj = np.asarray(jfft.frame_overlap(jnp.asarray(x), frame, hop))
        ft = tfft.frame_overlap(torch.from_numpy(x), frame, hop)
        np.testing.assert_array_equal(fj, ft.numpy())
        oj = np.asarray(jfft.overlap_add(jnp.asarray(fj), hop))
        ot = tfft.overlap_add(torch.from_numpy(fj.copy()), hop)
        assert ot.shape == oj.shape
        np.testing.assert_allclose(ot.numpy(), oj, rtol=1e-6, atol=1e-6)


def _speech_like(C, T, seed=2):
    rng = np.random.default_rng(seed)
    n = np.arange(T)
    return (0.3 * np.sin(2 * np.pi * 700 / FS * n)
            * (np.sin(2 * np.pi * 0.7 / FS * n) > 0)
            + 0.05 * rng.standard_normal((C, T))).astype(np.float32)


def test_nr_matches_jax_through_the_bootstrap():
    C, T, nb = 3, 1024, 6
    x = _speech_like(C, nb * T)
    jp = jnr.make_params(FS, 300.0, 2600.0, alpha=0.799 + 141 / 1000)
    tp = tnr.make_params(FS, 300.0, 2600.0, alpha=0.799 + 141 / 1000)
    assert tnr.params_from_numpy(jp) == tp
    js, ts = jnr.init_state((C,)), tnr.init_state((C,))
    for b in range(nb):
        xb = x[:, b * T:(b + 1) * T]
        yj, js = jnr.process_block(jp, js, jnp.asarray(xb))
        yt, ts = tnr.process_block(tp, ts, torch.from_numpy(xb))
        assert snr_db(np.asarray(yj), yt) >= MODULE_DB, b
        for f, a, v in zip(ts._fields, js, ts):
            if f == "init_count":
                np.testing.assert_array_equal(np.asarray(a), v.numpy())
            else:
                assert snr_db(np.asarray(a), v) >= MODULE_DB, (b, f)
    assert ts.init_count.tolist() == [48] * C


def test_nr_bootstrap_freezes_pslp_and_hk_old():
    x = np.random.default_rng(0).standard_normal(128 * 10).astype(
        np.float32) * 0.1
    p = tnr.make_params(FS, 275.0, 2625.0)
    st = tnr.init_state(())
    _, st2 = tnr.process_block(p, st, torch.from_numpy(x))
    assert torch.equal(st2.pslp, st.pslp)
    assert torch.equal(st2.hk_old, st.hk_old)
    assert int(st2.init_count) == 10


def test_nr_matches_the_float64_oracle():
    rng = np.random.default_rng(42)
    T = 128 * 60
    t = np.arange(T) / FS
    x = (0.3 * np.sin(2 * np.pi * 800 * t) * (1 + 0.5 * np.sin(
        2 * np.pi * 3 * t)) + 0.15 * rng.standard_normal(T)).astype(
        np.float32)
    p = tnr.make_params(FS, 275.0, 2625.0, alpha=0.94, power_threshold=0.40)
    y_ref = ref_nr.spectral_nr_ref(np.asarray(x, np.float64), p.vad_low,
                                   p.vad_high)
    st = tnr.init_state(())
    y1, st = tnr.process_block(p, st, torch.from_numpy(x[:T // 2]))
    y2, st = tnr.process_block(p, st, torch.from_numpy(x[T // 2:]))
    y = torch.cat([y1, y2]).numpy()
    skip = 128 * 25
    fsnr = _frame_snrs(y[skip:], y_ref[skip:])
    assert fsnr.min() > 100.0, (fsnr.min(), int(fsnr.argmin()))


# RxConfig fields after the hand-over, three blocks (frames 8-31 of 8 a
# block: the bootstrap ends in the second).  Measured audio 102.3-119.0 dB
# (usb at the three strengths 103.8-117.1, am 103.5, ssbstereo 102.3); the
# other leaves >= 101.9 dB; the NR's state leaves 65.7-140.7 dB: pslp
# 65.7 (usb), 67.2 (ssbstereo), 86.1 (am), its bins outside the band
# (where X is the filters' rounding floor and ph1y's exp amplifies the
# last bits) 62.7-83.1, in the band 89.8-108.3; hk_old 82.2-115.5 (in the
# band 72.4-111.2: snr_post up to 1000 times the gain squared)
@pytest.mark.parametrize("kw", [
    dict(mode="usb", bw_key="2P3KHZ", nr_enable=True),
    dict(mode="usb", bw_key="2P3KHZ", nr_enable=True, nr_strength=60,
         nr_prec_escalate=False),
    dict(mode="usb", bw_key="2P3KHZ", nr_enable=True, nr_strength=200),
    dict(mode="am", bw_key="2P5KHZ", nr_enable=True),
    dict(mode="ssbstereo", bw_key="2P3KHZ", nr_enable=True)],
    ids=["usb", "usb_60", "usb_200", "am", "ssbstereo"])
def test_chain_with_nr_matches_jax(kw):
    from tests import test_torch_rx as common
    from uhsdr_tpu_torch.chain import rx as trx
    audio, _, ts, js = chain_vs_jax(kw, n_blocks=3)
    assert min(audio) >= 98.0, audio
    pair = trx.RxConfig(**kw) if kw["mode"] == "ssbstereo" else None
    for f, s in common.state_snrs(js, ts, pair).items():
        assert s >= (60.0 if f.startswith("nr.") else 98.0), (f, s)
