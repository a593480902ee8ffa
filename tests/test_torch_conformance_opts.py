"""Conformance rows of the port's RX options: `RxChain` on the CPU (the
kernels' plain torch versions) against the float64 firmware oracle
`tests/golden/ref_chain.py`, on the captures and with the metric of
tests/test_conformance_ref.py (two seconds at 48 kHz in 4096-sample
blocks, the first half second skipped), as that file states each row:

* usb + spectral NR and am + LPC blanker at >= 45 dB (the JAX package's
  CPU rows read 79.0 and 111.8 dB, CONFORMANCE_r05.json);
* usb + NLMS notch and usb + leaky LMS functionally (the adaptation is
  chaotic, so the chain row scores the function): the notch takes a
  steady in-band carrier down >= 15 dB in the port and in the oracle,
  the two within 6 dB; the leaky NR passes a tone within 1.5 dB in both,
  the two within 1.5 dB (tests/test_conformance_ref.py:255-301,
  :373-421);

and FM: the reference's FM branches skip the decimated-rate options, so
an FM chain with them on gives plain FM's audio bit for bit and hands
their state leaves on untouched.  `-s` prints the values.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy import signal as sp

from tests import test_conformance_ref as conf
from tests.golden import ref_chain as gold
from uhsdr_tpu_torch.chain import rx as trx

FS = conf.FS


def run_port_chain(cfg, iq: np.ndarray) -> np.ndarray:
    chain = trx.RxChain(cfg, device="cpu")
    state = chain.init_state((1,))
    outs = []
    for s in range(0, len(iq), cfg.block_len):
        audio, state, _ = chain(state, iq=iq[s:s + cfg.block_len][None])
        outs.append(audio[0].numpy())
    return np.concatenate(outs)


def test_usb_with_nr_vs_float64_oracle():
    iq = conf._trim(conf.make_iq("usb"), 4096)
    cfg = trx.RxConfig(mode="usb", bw_key="2P3KHZ", ref_select_id=2,
                       block_len=4096, nr_enable=True)
    ref, _ = gold.ref_rx_chain(iq, "usb", "2P3KHZ", select_id=2,
                               nr_enable=True, nr_band=cfg.path.audio_band)
    s = conf.snr_db(ref, run_port_chain(cfg, iq))
    print(f"\nusb+NR vs the float64 oracle: {s:.1f} dB")
    assert s >= 45.0, s


def test_am_with_blanker_vs_float64_oracle():
    iq = conf._trim(conf.make_iq("am"), 4096)
    cfg = trx.RxConfig(mode="am", bw_key="2P5KHZ", block_len=4096,
                       nb_enable=True)
    ref, _ = gold.ref_rx_chain(iq, "am", "2P5KHZ", nb_enable=True)
    s = conf.snr_db(ref, run_port_chain(cfg, iq))
    print(f"\nam+blanker vs the float64 oracle: {s:.1f} dB")
    assert s >= 45.0, s


def _band(x, lo, hi, power):
    X = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    fr = np.fft.rfftfreq(len(x), 1.0 / FS)
    sel = X[(fr > lo) & (fr < hi)]
    return (sel ** 2).sum() if power else sel.max()


def test_usb_with_notch_functional():
    rng = np.random.default_rng(3)
    t = np.arange(conf.T_TOTAL) / FS
    tr = 6000.0
    v = sp.lfilter(*sp.butter(4, [300 / 24000, 2300 / 24000], "bandpass"),
                   rng.standard_normal(conf.T_TOTAL))
    v = v / np.sqrt(np.mean(v ** 2))
    base = (5000.0 * sp.hilbert(v) * np.exp(2j * np.pi * tr * t)
            + 5000.0 * np.exp(2j * np.pi * (tr + 800) * t))
    iq = conf._trim((base + (rng.standard_normal(conf.T_TOTAL)
                             + 1j * rng.standard_normal(conf.T_TOTAL))
                     * 20.0).astype(np.complex128), 4096)
    skip = 48000
    kw = dict(mode="usb", bw_key="2P3KHZ", ref_select_id=2, block_len=4096)
    on = run_port_chain(trx.RxConfig(**kw, notch_enable=True), iq)
    off = run_port_chain(trx.RxConfig(**kw), iq)
    rej = 20 * np.log10(_band(off[skip:], 770, 830, False)
                        / _band(on[skip:], 770, 830, False))
    r_on, _ = gold.ref_rx_chain(iq, "usb", "2P3KHZ", select_id=2,
                                notch_enable=True)
    r_off, _ = gold.ref_rx_chain(iq, "usb", "2P3KHZ", select_id=2)
    rej_ref = 20 * np.log10(_band(r_off[skip:], 770, 830, False)
                            / _band(r_on[skip:], 770, 830, False))
    print(f"\nnotch rejection: port {rej:.1f} dB, oracle {rej_ref:.1f} dB")
    assert rej >= 15.0 and rej_ref >= 15.0, (rej, rej_ref)
    assert abs(rej - rej_ref) <= 6.0, (rej, rej_ref)


def test_usb_with_leaky_lms_functional():
    rng = np.random.default_rng(5)
    t = np.arange(conf.T_TOTAL) / FS
    tr = 6000.0
    base = (6000.0 * np.exp(2j * np.pi * (tr + 800) * t)
            + (rng.standard_normal(conf.T_TOTAL)
               + 1j * rng.standard_normal(conf.T_TOTAL)) * 800.0)
    iq = conf._trim(base.astype(np.complex128), 4096)
    skip = 48000
    kw = dict(mode="usb", bw_key="2P3KHZ", ref_select_id=2, block_len=4096)
    on = run_port_chain(trx.RxConfig(**kw, leaky_nr_enable=True), iq)
    off = run_port_chain(trx.RxConfig(**kw), iq)
    d = 10 * np.log10(_band(on[skip:], 770, 830, True)
                      / _band(off[skip:], 770, 830, True))
    r_on, _ = gold.ref_rx_chain(iq, "usb", "2P3KHZ", select_id=2,
                                leaky_nr_enable=True)
    r_off, _ = gold.ref_rx_chain(iq, "usb", "2P3KHZ", select_id=2)
    d_ref = 10 * np.log10(_band(r_on[skip:], 770, 830, True)
                          / _band(r_off[skip:], 770, 830, True))
    print(f"\nleaky tone change: port {d:.2f} dB, oracle {d_ref:.2f} dB")
    assert abs(d) <= 1.5 and abs(d_ref) <= 1.5, (d, d_ref)
    assert abs(d - d_ref) <= 1.5, (d, d_ref)


@pytest.mark.parametrize("iq_rate", [48000.0, 96000.0])
def test_fm_passes_the_options_by(iq_rate):
    """FM with the blanker, the NR, the notch and the leaky LMS on gives
    plain FM's audio and state bit for bit, the options' leaves as they
    were made."""
    from tests.test_torch_iqcorr import capture
    kw = dict(mode="fm", bw_key="5P0KHZ", path_name="FM", iq_rate=iq_rate,
              translate_hz=12000.0 if iq_rate > FS else 6000.0,
              block_len=4096)
    plain = trx.RxChain(trx.RxConfig(**kw), device="cpu")
    opts = trx.RxChain(trx.RxConfig(**kw, nr_enable=True, nb_enable=True,
                                    notch_enable=True, leaky_nr_enable=True),
                       device="cpu")
    sp_, so = plain.init_state((2,)), opts.init_state((2,))
    so0 = so
    assert all(getattr(so, f) is not None
               for f in ("nr", "nb", "notch", "leaky"))
    for i, q in capture(2, C=2, fs=iq_rate,
                        translate=kw["translate_hz"]):
        yp, sp_, _ = plain(sp_, i=i, q=q)
        yo, so, _ = opts(so, i=i, q=q)
        assert torch.equal(yp, yo)
    a, b = trx.state_to_numpy(sp_), trx.state_to_numpy(so)
    for f, v in a.items():
        np.testing.assert_array_equal(v, b[f], err_msg=f)
    before = trx.state_to_numpy(so0)
    for f, v in b.items():
        if f.split(".")[0] in ("nr", "nb", "notch", "leaky"):
            np.testing.assert_array_equal(v, before[f], err_msg=f)
