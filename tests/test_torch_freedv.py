"""The port's FreeDV (`uhsdr_tpu_torch.modems.freedv`) against the JAX
package's, on the CPU (K5's and K4's plain versions).

The modem tier is a NumPy copy in both packages; the front differs: the
JAX package mixes in XLA and decimates by FFT convolution with a post-mix
history, the port rotates and decimates directly (K5's plain version)
with a raw history it re-rotates on a retune.  So:

* the 8 kHz baseband, the 48 kHz interpolation and the histories are
  held at >= 100 dB (they part by rounding alone, ~130 dB);
* every decision downstream is held equal: frames decoded, Golay
  parity counts, text bits, LDPC failures, and the decoded speech bit
  for bit (Codec2's decoder reads only the bits and the BER estimate);
* on TX the Codec2 encoder quantises the 8 kHz speech, which parts by
  rounding; the frame bits it chose are held equal, and the modem tier
  alone is held bit for bit on the same 8 kHz speech.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal

from uhsdr_tpu import data as jdata
from uhsdr_tpu.modems import freedv as jfdv
from uhsdr_tpu_torch import data as tdata
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.modems import freedv as tfdv

FS = 48000.0
RATIO = 6
TOL_DB = 100.0
BLOCK = 4800
RETUNE_BLOCK = 20        # the capture moves by RETUNE_HZ from this block on
RETUNE_HZ = 300.0


def _snr(ref, got) -> float:
    return snr_db(torch.as_tensor(np.array(ref)), torch.as_tensor(
        np.array(got)))


def embed_48k(iq8: np.ndarray, translate_hz: float, shift_from=None,
              shift_hz: float = 0.0) -> np.ndarray:
    """8 kHz modem IQ -> 48 kHz capture at +translate_hz (as
    tests/test_freedv_mode.py), moved by shift_hz from sample shift_from
    on, phase-continuously."""
    up = np.zeros(len(iq8) * RATIO, np.complex128)
    up[::RATIO] = iq8
    h = signal.firwin(96, 3500.0, fs=FS) * RATIO
    z = signal.lfilter(h, [1.0], up)
    f = np.full(len(z), float(translate_hz))
    if shift_from is not None:
        f[shift_from:] += shift_hz
    ph = 2 * np.pi * np.concatenate([[0.0], np.cumsum(f[:-1])]) / FS
    return (z * np.exp(1j * ph)).astype(np.complex64)


def recorded_iq8() -> np.ndarray:
    iq8 = jdata.freedv("test_iq")
    return iq8 / (np.max(np.abs(iq8)) + 1e-9)


@pytest.mark.parametrize("name", ["test_iq", "gt_alpha5_root",
                                  "pilot_coeff", "test_bits"])
def test_freedv_data_equal(name):
    np.testing.assert_array_equal(tdata.freedv(name), jdata.freedv(name))


@pytest.mark.parametrize("loader", ["ldpc", "_codec2_cb",
                                    "newamp1_codebooks"])
def test_modem_tables_equal(loader):
    want, got = getattr(jdata, loader)(), getattr(tdata, loader)()
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])


def test_rate_converter_matches_jax():
    """down and up over 3 streamed blocks of 4800 on 2 channels: outputs
    and histories >= 100 dB."""
    rng = np.random.default_rng(3)
    jc = jfdv.RateConverter(BLOCK)
    tc = tfdv.RateConverter(BLOCK, device="cpu")
    for _ in range(3):
        z = (rng.standard_normal((2, BLOCK))
             + 1j * rng.standard_normal((2, BLOCK))).astype(np.complex64)
        yj, yt = jc.down(jnp.asarray(z)), tc.down(torch.as_tensor(z))
        assert tuple(yt.shape) == (2, BLOCK // RATIO)
        assert yt.dtype == torch.complex64
        assert _snr(yj, yt) >= TOL_DB
        a = rng.standard_normal((2, BLOCK // RATIO)).astype(np.float32)
        uj, ut = jc.up(jnp.asarray(a)), tc.up(torch.as_tensor(a))
        assert tuple(ut.shape) == (2, BLOCK)
        assert _snr(uj, ut) >= TOL_DB
        carry = np.asarray(jc._dec_carry_i) + 1j * np.asarray(
            jc._dec_carry_q)
        assert _snr(carry, tc._dec_carry) >= TOL_DB
        assert _snr(jc._int_carry, tc._int_carry) >= TOL_DB


def test_rx_block_glue_matches_jax():
    """freedv_rx_block with the plumbing modem (audio = Re(iq)) on a 1-D
    stream, and the empty speech block that leaves the interpolator's
    history as it is."""
    t = np.arange(4 * BLOCK) / FS
    iq = np.sin(2 * np.pi * 400 * t).astype(np.complex64)
    jc, tc = jfdv.RateConverter(BLOCK), tfdv.RateConverter(BLOCK, "cpu")
    modem = jfdv.LoopbackModem()
    for k in range(4):
        blk = iq[k * BLOCK:(k + 1) * BLOCK]
        yj = jfdv.freedv_rx_block(jc, modem, jnp.asarray(blk))
        yt = tfdv.freedv_rx_block(tc, tfdv.LoopbackModem(),
                                  torch.as_tensor(blk))
        assert tuple(yt.shape) == (BLOCK,)
        assert _snr(yj, yt) >= TOL_DB
    before = tc._int_carry.clone()
    assert tuple(tc.up(torch.zeros(0)).shape) == (0,)
    assert torch.equal(tc._int_carry, before)


def test_freedv1600_recorded_iq_matches_jax():
    """The firmware's recorded 1600 IQ through both modems in blocks of
    1000 samples: frames, parity, text bits and speech equal."""
    iq8 = jdata.freedv("test_iq")
    jm, tm = jfdv.FreeDv1600(), tfdv.FreeDv1600()
    sj, st = [], []
    for k in range(0, len(iq8), 1000):
        sj.append(jm.demod(iq8[k:k + 1000]))
        st.append(tm.demod(iq8[k:k + 1000]))
    assert tm.frames_decoded == jm.frames_decoded >= 60
    assert tm.parity_errors == jm.parity_errors
    assert tm.text_bits_rx == jm.text_bits_rx
    assert tm.ber_est == jm.ber_est
    np.testing.assert_array_equal(np.concatenate(st), np.concatenate(sj))


def _speech(seconds: float) -> np.ndarray:
    t8 = np.arange(int(8000 * seconds)) / 8000.0
    f0 = 120 + 25 * np.sin(2 * np.pi * 1.1 * t8)
    return (5000 * np.sin(np.cumsum(2 * np.pi * f0 / 8000.0))).astype(
        np.float32)


def test_freedv1600_mod_bit_equal():
    """The modem tier alone: the same 8 kHz speech gives the same 1600
    modem output, bit for bit."""
    sp = _speech(1.0)
    np.testing.assert_array_equal(tfdv.FreeDv1600().mod(sp),
                                  jfdv.FreeDv1600().mod(sp))


def test_freedv700d_loopback_bit_equal():
    """A 700D mod/demod loopback of a few frames: modem output, frames,
    LDPC failures and speech bit-equal."""
    sp = _speech(1.0)
    jt, tt = jfdv.FreeDv700D(), tfdv.FreeDv700D()
    iq_j, iq_t = jt.mod(sp), tt.mod(sp)
    np.testing.assert_array_equal(iq_t, iq_j)
    jr, tr = jfdv.FreeDv700D(), tfdv.FreeDv700D()
    sj = jr.demod(iq_j, flush=True)
    st = tr.demod(iq_t, flush=True)
    assert tr.frames_decoded == jr.frames_decoded >= 3
    assert tr.fec_failures == jr.fec_failures
    assert tr.snr_db == jr.snr_db
    np.testing.assert_array_equal(st, sj)


@pytest.fixture(scope="module")
def retuned_runs():
    """FreeDvRadioMode RX over the recorded capture at translate 6000 Hz,
    the capture moving by +300 Hz from block RETUNE_BLOCK on and
    `extra_offset_hz` following it, in both packages: per block the
    8 kHz baseband and the 48 kHz speech, and the two radios."""
    cap = embed_48k(recorded_iq8(), 6000.0, RETUNE_BLOCK * BLOCK, RETUNE_HZ)
    n = (len(cap) // BLOCK) * BLOCK
    runs = {}
    for name, mk in (("jax", lambda: jfdv.FreeDvRadioMode(
            "freedv1600", BLOCK, translate_hz=6000.0)),
            ("torch", lambda: tfdv.FreeDvRadioMode(
                "freedv1600", BLOCK, translate_hz=6000.0, device="cpu"))):
        radio = mk()
        base, speech = [], []
        demod = radio.modem.demod

        def spy(iq8, demod=demod, base=base):
            base.append(np.asarray(iq8).copy())
            return demod(iq8)
        radio.modem.demod = spy
        for k in range(0, n, BLOCK):
            blk = cap[k:k + BLOCK]
            extra = RETUNE_HZ if k >= RETUNE_BLOCK * BLOCK else 0.0
            speech.append(radio.rx_block(blk.real[None], blk.imag[None],
                                         extra_offset_hz=extra))
        runs[name] = (base, speech, radio)
    return runs


def test_radio_mode_retune_baseband(retuned_runs):
    """Every block's 8 kHz baseband >= 100 dB, the retune's first blocks
    included (the raw history re-rotated to the new increment)."""
    bj, _, _ = retuned_runs["jax"]
    bt, _, _ = retuned_runs["torch"]
    assert len(bj) == len(bt) > RETUNE_BLOCK + 2
    for k, (a, b) in enumerate(zip(bj, bt)):
        assert b.dtype == a.dtype == np.complex64
        assert _snr(a, b) >= TOL_DB, k


def test_radio_mode_retune_decodes_equal(retuned_runs):
    _, sj, rj = retuned_runs["jax"]
    _, st, rt = retuned_runs["torch"]
    assert rt.stats == rj.stats
    assert rt.stats["frames_decoded"] >= 60
    assert rt.stats["parity_errors"] <= 0.2 * rt.stats["frames_decoded"]
    assert rt.modem.text_bits_rx == rj.modem.text_bits_rx
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(b, a)


def test_radio_mode_zero_translate_matches_jax():
    """At 0 Hz the front runs K5 without the NCO (no rotation, as the JAX
    package mixes nothing); a retune away from 0 Hz and back."""
    rng = np.random.default_rng(5)
    jr = jfdv.FreeDvRadioMode("freedv1600", BLOCK)
    tr = tfdv.FreeDvRadioMode("freedv1600", BLOCK, device="cpu")
    for extra in (0.0, 0.0, 1500.0, 1500.0, 0.0, -700.0):
        z = (rng.standard_normal((1, BLOCK))
             + 1j * rng.standard_normal((1, BLOCK))).astype(np.complex64)
        zj = jr._translate_block(z.real, z.imag, extra)
        yj = jr.conv.down(zj)
        yt = tr.conv.down_planes(torch.as_tensor(z.real),
                                 torch.as_tensor(z.imag), tr._delta(extra))
        assert _snr(yj, yt) >= TOL_DB, extra
    np.testing.assert_array_equal(tr.conv.phase.numpy().astype(np.uint32),
                                  np.asarray(jr._phase))


def test_radio_mode_tx_matches_jax():
    """tx_block: the 8 kHz speech the encoder takes >= 100 dB, the frame
    bits it chose equal, and so the 48 kHz IQ equal."""
    t = np.arange(FS * 1.5) / FS
    speech = (0.3 * np.sin(2 * np.pi * 700 * t)
              + 0.2 * np.sin(2 * np.pi * 1100 * t)).astype(np.float32)
    out = {}
    for name, mk in (("jax", lambda: jfdv.FreeDvRadioMode(
            "freedv1600", BLOCK, translate_hz=6000.0)),
            ("torch", lambda: tfdv.FreeDvRadioMode(
                "freedv1600", BLOCK, translate_hz=6000.0, device="cpu"))):
        radio = mk()
        sp8, frames, iq = [], [], []
        mod, modulate = radio.modem.mod, radio.modem.modulator.modulate_frame

        def mod_spy(s, mod=mod, sp8=sp8):
            sp8.append(np.asarray(s).copy())
            return mod(s)

        def frame_spy(bits, modulate=modulate, frames=frames):
            frames.append(np.asarray(bits).copy())
            return modulate(bits)
        radio.modem.mod = mod_spy
        radio.modem.modulator.modulate_frame = frame_spy
        for k in range(0, (len(speech) // BLOCK) * BLOCK, BLOCK):
            iq.append(radio.tx_block(speech[k:k + BLOCK]))
        out[name] = (sp8, frames, iq)
    (sj, fj, ij), (st, ft, it) = out["jax"], out["torch"]
    for a, b in zip(sj, st):
        assert b.dtype == a.dtype == np.float32
        assert _snr(a, b) >= TOL_DB
    assert len(ft) == len(fj) >= 20
    for a, b in zip(fj, ft):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(ij, it):
        np.testing.assert_array_equal(b, a)


def test_entry_points_need_cuda_unless_told(monkeypatch):
    from uhsdr_tpu_torch.parallel import fleet as tfleet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: tfdv.RateConverter(BLOCK, **kw),
                 lambda **kw: tfdv.FreeDvRadioMode("freedv1600", BLOCK,
                                                   **kw),
                 lambda **kw: tfleet.FreeDvFleetGroup(2, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        assert make(device="cpu").device.type == "cpu"


def test_entry_points_refuse_what_they_do_not_take():
    from uhsdr_tpu_torch.parallel import fleet as tfleet
    for make in (lambda: tfdv.RateConverter(4801, device="cpu"),
                 lambda: tfdv.FreeDvRadioMode("freedv1600", 4801,
                                              device="cpu"),
                 lambda: tfdv.FreeDvRadioMode("freedv2020", BLOCK,
                                              device="cpu"),
                 lambda: tfleet.FreeDvFleetGroup(2, block_len_48k=7681,
                                                 device="cpu")):
        with pytest.raises(ValueError):
            make()
