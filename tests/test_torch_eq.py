"""Non-neutral tone settings (`EqSettings`) on the port's RX chains
against the JAX package's, on the CPU: the manual notch, the manual peak
and the bass shelf (EQ biquad1, at the decimated rate) and the treble
shelf (biquad2, at the IQ rate after the interpolation) all on, so every
cascade of the chain's post runs non-empty.

* usb 2P3KHZ LPF at 48 kHz and at 96 kHz (the SSB capture of
  tests/test_torch_rx.py, tones 700 + 150 c Hz above the translate);
* fm 5P0KHZ at 48 kHz (tests/test_torch_fm.py's capture): FM runs
  biquad2 alone on its 48 kHz audio, designed at ``cfg.iq_rate`` (the
  reference's quirk, chain/rx.py:460 there, which the port keeps).

Three streamed int16 blocks; audio and every state leaf are held to
90 dB after every block, the AGC's two back-averages to 85 dB (the f32
drift of ROADMAP section C, tests/test_torch_agc.py).  The SSB chains
start from zero state.  The FM chain starts from the JAX chain's state
after one block of the same capture (`state_from_numpy`): from zero
state the JAX CPU front's FFT rounding noise on the first outputs turns
into discriminator angles (ROADMAP section C), which on this capture
reads 35.7 dB in block 0 with these settings and 35.4 dB at neutral
ones, so it is not the EQ; the hand-over takes that out of the
comparison and leaves the cascades to be compared.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest

from tests import test_torch_fm as fmt
from tests import test_torch_rx as common
from uhsdr_tpu.chain import eq as jeq
from uhsdr_tpu.chain import rx as jrx
from uhsdr_tpu_torch.chain import eq as teq
from uhsdr_tpu_torch.chain import rx as trx
from uhsdr_tpu_torch.metrics import snr_db

RX_DB = 90.0
BACKAVERAGE_DB = 85.0
EQ = dict(manual_notch_hz=1200.0, manual_notch_bw=150.0,
          manual_peak_hz=800.0, manual_peak_bw=120.0, bass_gain_db=6.0,
          treble_gain_db=-8.0)
B = 2048


def ssb_capture(n_blocks, iq_rate, translate=12000.0, seed=41):
    """int16 IQ: per channel a USB tone 700 + 150 c Hz above the translate
    frequency at -6 ... -46 dBFS, plus noise of 30 counts rms."""
    rng = np.random.default_rng(seed)
    C = common.C
    n = np.arange(n_blocks * B)
    f = translate + 700.0 + 150.0 * np.arange(C)[:, None]
    amp = 32767.0 * 10.0 ** (-np.linspace(6, 46, C) / 20.0)[:, None]
    z = amp * np.exp(2j * np.pi * f * n / iq_rate) + (
        rng.standard_normal((C, n.size))
        + 1j * rng.standard_normal((C, n.size))) * 30.0
    i16 = np.clip(np.round(z.real), -32768, 32767).astype(np.int16)
    q16 = np.clip(np.round(z.imag), -32768, 32767).astype(np.int16)
    return [(i16[:, k * B:(k + 1) * B], q16[:, k * B:(k + 1) * B])
            for k in range(n_blocks)]


@pytest.mark.parametrize("mode,bw,path,iq_rate", [
    ("usb", "2P3KHZ", "LPF", 48000.0), ("usb", "2P3KHZ", "LPF", 96000.0),
    ("fm", "5P0KHZ", "FM", 48000.0)])
def test_eq_settings_match_jax(mode, bw, path, iq_rate):
    kw = dict(mode=mode, bw_key=bw, path_name=path, iq_rate=iq_rate,
              translate_hz=12000.0, block_len=B)
    jcfg = jrx.RxConfig(**kw, eq=jeq.EqSettings(**EQ))
    tcfg = trx.RxConfig(**kw, eq=teq.EqSettings(**EQ))
    jp = jrx.make_params(jcfg)
    tp = trx.make_params(tcfg, device="cpu")
    assert (tp.eq1_sos.sections, tp.eq2_sos.sections) == (3, 1)
    for name, a, b in zip(tp._fields, tp,
                          trx.params_from_numpy(jp, device="cpu")):
        assert common._same(a, b), name
    step = jax.jit(lambda s, i, q: jrx.process_block(jcfg, jp, s, (i, q)))
    js = jrx.init_state(jcfg, jp, (common.C,))
    if mode == "fm":
        blocks = fmt.fm_capture(4, iq_rate)
        _, js, _ = common._run_jax(step, js, blocks.pop(0))
        ts = trx.state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                  device="cpu")
    else:
        blocks = ssb_capture(3, iq_rate)
        ts = trx.init_state(tcfg, tp, (common.C,))
    for k, blk in enumerate(blocks):
        yj, js, _ = common._run_jax(step, js, blk)
        yt, ts, _ = common._run_port(tcfg, tp, ts, blk)
        leaves = common.state_snrs(js, ts)
        worst = min(leaves, key=leaves.get)
        audio = snr_db(yj, yt)
        print(f"\n{mode} @ {iq_rate:.0f} block {k}: audio {audio:.1f} dB, "
              f"eq1 {leaves.get('eq1', np.inf):.1f}, eq2 "
              f"{leaves['eq2']:.1f}, worst leaf {worst} "
              f"{leaves[worst]:.1f} dB")
        assert audio >= RX_DB, (k, audio)
        for f, db in leaves.items():
            tol = BACKAVERAGE_DB if "backaverage" in f else RX_DB
            assert db >= tol, (k, f, db)
    assert float(ts.eq2.abs().max()) > 0.0
