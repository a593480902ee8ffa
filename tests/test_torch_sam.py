"""The port's AM and synchronous-AM demodulators and the plain versions of
their kernels (K9, K10: the PLL; K11: the biquad cascade) on the CPU
against the JAX package:

* the plain K10 and K9 (`cuda.pll.pll`, `pll_audio` on CPU tensors)
  against the TPU kernels `pallas.pll.pll_pallas` / `pll_audio_pallas`
  in interpret mode at C = 1024 (as tests/test_demod.py:140-223 runs
  them) and against the XLA scan `demod.sam._pll_scan`, two streamed
  blocks.  The port's phase detector is atan2, the scan's too; the TPU
  kernel carries a 9-term polynomial for it.  Bounds are max |err|:
  3e-4 against the TPU kernels (the bound tests/test_demod.py holds them
  to against the scan; measured 1.4e-6) and 2e-5 against the scan
  (measured 1.3e-6);
* the plain K11 (`cuda.iir.biquad_cascade`) on SAM's 7-section allpass
  chains against `pallas.iir.biquad_cascade_pallas` (interpret mode) and
  a float64 `scipy.signal.sosfilt` with carried state, three blocks.  The
  allpass poles sit at radius sqrt(0.99979), where an f32 recurrence
  amplifies its own rounding by about 37 dB: the sequential form sits
  118.9-124.3 dB from float64, the TPU kernel's dilated scan (log-depth
  sums) 139.1-139.8 dB, so the port is held to 115 dB against float64
  and against the TPU kernel (`-s` prints all three);
* `demod.am.demod` and `demod.sam.demod` for every sideband and fade
  setting against the JAX functions over three streamed blocks, audio
  and every state leaf: AM at 110 dB (measured >= 145 dB), SAM at 75 dB
  (the PLL's phase through its cosine and sine; measured: audio >=
  102.4 dB, the worst leaf, the fade leveler's fast dc after block 2 of
  a sideband route, 82.0 dB).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from uhsdr_tpu.demod import am as jam
from uhsdr_tpu.demod import sam as jsam
from uhsdr_tpu.pallas import iir as pallas_iir
from uhsdr_tpu.pallas import pll as pallas_pll
from uhsdr_tpu_torch.cuda import iir as iir_k
from uhsdr_tpu_torch.cuda import pll as pll_k
from uhsdr_tpu_torch.demod import am as tam
from uhsdr_tpu_torch.demod import sam as tsam
from uhsdr_tpu_torch.metrics import snr_db

FS = 12000.0
PLL_VS_PALLAS = 3e-4
PLL_VS_SCAN = 2e-5
K11_F64_DB = 115.0
K11_PALLAS_DB = 115.0
AM_DB = 110.0
SAM_DB = 75.0


def _carrier(rng, C, T, f_off=37.0, am=0.0, noise=0.05, fs=FS):
    t = np.arange(T) / fs
    x = (0.8 * (1 + am * np.sin(2 * np.pi * 300 * t))
         * np.exp(1j + 2j * np.pi * f_off * t))[None] * np.ones((C, 1))
    return (x + noise * (rng.standard_normal((C, T))
                         + 1j * rng.standard_normal((C, T)))
            ).astype(np.complex64)


def _scalars(jp):
    return pll_k.PllScalars(float(jp.g1), float(jp.g2), float(jp.omega_min),
                            float(jp.omega_max))


def _maxabs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def test_pll_plain_matches_pallas_and_scan():
    jp = jsam.make_params(FS)
    C, T = 1024, 512
    x = _carrier(np.random.default_rng(9), C, 2 * T)
    st = jsam.init_state((C,))
    cj = jnp.zeros((3, C), jnp.float32)
    ct = torch.zeros((3, C))
    for blk in (x[:, :T], x[:, T:]):
        phases, _, phs_f, fil_f, om_f = jsam._pll_scan(jp, st,
                                                       jnp.asarray(blk))
        st = st._replace(phs=phs_f, fil_out=fil_f, omega2=om_f)
        ck, sk, cj = pallas_pll.pll_pallas(
            float(jp.g1), float(jp.g2), float(jp.omega_min),
            float(jp.omega_max), cj, jnp.asarray(blk), t_tile=256)
        c, s, ct = pll_k.pll(_scalars(jp), ct, torch.from_numpy(blk))
        vs_scan = max(_maxabs(np.cos(phases), c), _maxabs(np.sin(phases), s),
                      _maxabs(fil_f, ct[1]), _maxabs(om_f, ct[2]),
                      _maxabs(np.cos(phs_f), ct[0].cos()),
                      _maxabs(np.sin(phs_f), ct[0].sin()))
        vs_pallas = max(_maxabs(ck, c), _maxabs(sk, s),
                        _maxabs(cj[1:], ct[1:]))
        print(f"\nK10 plain: max|err| vs scan {vs_scan:.2e}, vs the TPU "
              f"kernel {vs_pallas:.2e}")
        assert vs_scan <= PLL_VS_SCAN and vs_pallas <= PLL_VS_PALLAS
    assert float(ct[2].abs().min()) > 0.0       # locked onto the offset


def test_pll_audio_plain_matches_pallas_and_scan():
    jp = jsam.make_params(FS)
    C, T = 1024, 512
    x = _carrier(np.random.default_rng(11), C, 2 * T, f_off=25.0, am=0.4,
                 noise=0.03)
    st = jsam.init_state((C,))
    fade = st.fade
    cj = jnp.zeros((5, C), jnp.float32)
    ct = torch.zeros((5, C))
    for blk in (x[:, :T], x[:, T:]):
        phases, _, phs_f, fil_f, om_f = jsam._pll_scan(jp, st,
                                                       jnp.asarray(blk))
        st = st._replace(phs=phs_f, fil_out=fil_f, omega2=om_f)
        corr = blk.real * np.cos(phases) + blk.imag * np.sin(phases)
        ref, fade = jam.fade_leveler(jp.fade, fade, jnp.asarray(corr),
                                     jnp.asarray(corr))
        ak, cj = pallas_pll.pll_audio_pallas(
            float(jp.g1), float(jp.g2), float(jp.omega_min),
            float(jp.omega_max), float(jp.fade.mtauR), float(jp.fade.mtauI),
            cj, jnp.asarray(blk), t_tile=256)
        a, ct = pll_k.pll_audio(_scalars(jp), float(jp.fade.mtauR),
                                float(jp.fade.mtauI), ct,
                                torch.from_numpy(blk))
        vs_scan = max(_maxabs(ref, a), _maxabs(fade.dc, ct[3]),
                      _maxabs(fade.dc_insert, ct[4]), _maxabs(om_f, ct[2]))
        vs_pallas = max(_maxabs(ak, a), _maxabs(cj[1:], ct[1:]))
        print(f"\nK9 plain: max|err| vs scan + fade leveler {vs_scan:.2e}, "
              f"vs the TPU kernel {vs_pallas:.2e}")
        assert vs_scan <= PLL_VS_SCAN and vs_pallas <= PLL_VS_PALLAS


@pytest.mark.parametrize("coeff_set", [0, 1])
def test_biquad_plain_matches_pallas_and_float64(coeff_set):
    c = (tsam.C0, tsam.C1)[coeff_set]
    sos5 = tsam.allpass_sos(c)
    np.testing.assert_array_equal(sos5, jsam._AP_COEFFS[coeff_set])
    sos6 = np.concatenate([sos5[:, :3], np.ones((len(c), 1)), sos5[:, 3:]],
                          axis=1).astype(np.float64)
    C, T, S = 16, 512, len(c)
    rng = np.random.default_rng(12)
    sj = jnp.zeros((S, C, 2), jnp.float32)
    st = torch.zeros((S, C, 2))
    zi = np.zeros((S, C, 2))
    for blk in range(3):
        x = rng.standard_normal((C, T)).astype(np.float32)
        yj, sj = pallas_iir.biquad_cascade_pallas(sos5, sj, jnp.asarray(x),
                                                  t_tile=128)
        yt, st = iir_k.biquad_cascade(torch.from_numpy(sos5), st,
                                      torch.from_numpy(x))
        y64, zi = scipy.signal.sosfilt(sos6, x.astype(np.float64), axis=-1,
                                       zi=zi)
        vals = (snr_db(y64, yt), snr_db(zi, st), snr_db(y64, np.asarray(yj)),
                snr_db(np.asarray(yj), yt), snr_db(np.asarray(sj), st))
        print(f"\nK11 plain, C{coeff_set} block {blk}: vs float64 "
              f"{vals[0]:.1f} dB (state {vals[1]:.1f}), the TPU kernel vs "
              f"float64 {vals[2]:.1f} dB, plain vs the TPU kernel "
              f"{vals[3]:.1f} dB (state {vals[4]:.1f})")
        assert vals[0] >= K11_F64_DB and vals[1] >= K11_F64_DB
        assert vals[3] >= K11_PALLAS_DB and vals[4] >= K11_PALLAS_DB


def _state_snrs(jstate, tstate, prefix=""):
    out = {}
    for f in tstate._fields:
        a, b = getattr(jstate, f), getattr(tstate, f)
        if isinstance(b, tuple):
            out.update(_state_snrs(a, b, f"{prefix}{f}."))
        elif f == "phs":
            a = np.asarray(a)
            out[prefix + f] = snr_db(np.stack([np.cos(a), np.sin(a)]),
                                     torch.stack([b.cos(), b.sin()]))
        else:
            out[prefix + f] = snr_db(np.asarray(a), b)
    return out


@pytest.mark.parametrize("fade", [True, False], ids=["fade", "nofade"])
def test_am_demod_matches_jax(fade):
    fs = 24000.0
    jp, tp = jam.fade_leveler_params(fs), tam.fade_leveler_params(fs)
    assert (float(jp.mtauR), float(jp.mtauI)) == tuple(tp)
    C, T = 8, 1024
    rng = np.random.default_rng(13)
    js, ts = jam.fade_leveler_init((C,)), tam.fade_leveler_init((C,))
    x = _carrier(rng, C, 3 * T, f_off=5.0, am=0.5, noise=0.01, fs=fs)
    for k in range(3):
        blk = x[:, k * T:(k + 1) * T]
        yj, js = jam.demod(jnp.asarray(blk), jp, js, fade)
        yt, ts = tam.demod(torch.from_numpy(blk), tp, ts, fade)
        leaves = _state_snrs(js, ts)
        leaves["audio"] = snr_db(np.asarray(yj), yt)
        print(f"\nAM fade={fade} block {k}: "
              + ", ".join(f"{f} {v:.1f}" for f, v in leaves.items()))
        assert min(leaves.values()) >= AM_DB, leaves
    assert bool((ts.dc != 0).all()) == fade


@pytest.mark.parametrize("fade", [True, False], ids=["fade", "nofade"])
@pytest.mark.parametrize("sideband", ["both", "usb", "lsb"])
def test_sam_demod_matches_jax(sideband, fade):
    fs = 24000.0
    jp = jsam.make_params(fs)
    tp = tsam.make_params(fs)
    fp = tsam.params_from_numpy(jp)
    assert tp[:5] == fp[:5]
    assert all(torch.equal(a, b) for a, b in zip(tp.ap_sos, fp.ap_sos))
    C, T = 8, 1024
    rng = np.random.default_rng(14)
    js, ts = jsam.init_state((C,)), tsam.init_state((C,))
    x = _carrier(rng, C, 3 * T, f_off=21.0, am=0.5, noise=0.01, fs=fs)
    for k in range(3):
        blk = x[:, k * T:(k + 1) * T]
        yj, oj, js = jsam.demod(jp, js, jnp.asarray(blk), sideband, fade)
        yt, ot, ts = tsam.demod(tp, ts, torch.from_numpy(blk), sideband,
                                fade)
        leaves = _state_snrs(js, ts)
        leaves["audio"] = snr_db(np.asarray(yj), yt)
        leaves["omega"] = snr_db(np.asarray(oj), ot)
        low = min(leaves, key=leaves.get)
        print(f"\nSAM {sideband} fade={fade} block {k}: audio "
              f"{leaves['audio']:.1f} dB, worst {low} {leaves[low]:.1f} dB")
        assert leaves[low] >= SAM_DB, leaves
    assert bool((ts.ap_state != 0).any()) == (sideband != "both")
    with pytest.raises(ValueError, match="sideband"):
        tsam.demod(tp, ts, torch.from_numpy(blk), "dsb", fade)
