"""The port's copies of the digital modes' NumPy tiers (text coding, the
reference-exact TX tone generators, the keyer) against the JAX
package's, and the TX conformance rows of the digital modes through the
port's `TxChain` on the CPU.

The tiers are copies, so their arrays and transcripts must be equal.
The TX rows repeat tests/test_tx_conformance.py:115-169 on the port:
the tone generators bit-equal to the float64 oracles of
tests/golden/ref_tx.py, the chain's IQ >= 50 dB against the oracles'
(the conformance bound) past the first half second, and the CW chain's
|IQ| within 2e-3 of the keying envelope.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.golden import ref_tx as gold
from uhsdr_tpu import data as jdata
from uhsdr_tpu.modems import _varicode_table as jvaricode
from uhsdr_tpu.modems import cw_text as jcw_text
from uhsdr_tpu.modems import keyer as jkeyer
from uhsdr_tpu.modems import psk_text as jpsk_text
from uhsdr_tpu.modems import rtty_text as jrtty_text
from uhsdr_tpu.ops import softdds as jsoftdds
from uhsdr_tpu_torch import data
from uhsdr_tpu_torch.chain import tx as ttx
from uhsdr_tpu_torch.modems import _varicode_table as varicode
from uhsdr_tpu_torch.modems import cw_text, keyer, psk_text, rtty_text
from uhsdr_tpu_torch.ops import softdds

BLOCK = 4096
SKIP = 24000
INT16_FS = 32767.0
TEXTS = ["CQ CQ DE UHSDR 599", "ryry the quick brown fox 73!", "K"]


def test_tables_and_dds_are_the_jax_packages():
    assert varicode.VARICODE == jvaricode.VARICODE
    for k in ("ascii2baudot", "psk_varicode", "cw_sm_table"):
        np.testing.assert_array_equal(data.digimode_tables()[k],
                                      jdata.digimode_tables()[k])
    np.testing.assert_array_equal(softdds.table(), jsoftdds.table())
    step = softdds.step_for(915.0, 48000)
    assert step == jsoftdds.step_for(915.0, 48000)
    for a, b in zip(softdds.samples_iq(123456789, step, 1000),
                    jsoftdds.samples_iq(123456789, step, 1000)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("text", TEXTS)
def test_rtty_text_matches_jax(text):
    codes = rtty_text.encode(text)
    assert codes == jrtty_text.encode(text)
    for stop in (1.5, 2.0):
        np.testing.assert_array_equal(
            rtty_text.codes_to_bits(codes, 264, stop),
            jrtty_text.codes_to_bits(codes, 264, stop))
    np.testing.assert_array_equal(rtty_text.gen_tx_tone_ref(text, 20000),
                                  jrtty_text.gen_tx_tone_ref(text, 20000))
    assert rtty_text.BaudotDecoder().push_codes(codes + [-1]) == \
        jrtty_text.BaudotDecoder().push_codes(codes + [-1])


@pytest.mark.parametrize("text", TEXTS)
def test_psk_text_matches_jax(text):
    bits = psk_text.encode_bits(text)
    np.testing.assert_array_equal(bits, jpsk_text.encode_bits(text))
    for rate in (384, 192, 96):
        for a, b in zip(psk_text.bits_to_waveform_params(bits, rate),
                        jpsk_text.bits_to_waveform_params(bits, rate)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(psk_text.gen_tx_tone_ref(text, 30000),
                                  jpsk_text.gen_tx_tone_ref(text, 30000))
    dec, jdec = psk_text.VaricodeDecoder(), jpsk_text.VaricodeDecoder()
    assert dec.push_bits(bits) == jdec.push_bits(bits)


def test_varicode_decoder_drops_unknown_words():
    """Bits from noise form words no character has: the port's decoder
    drops them (the JAX package's raises on them, a None in its test);
    between them the message still decodes."""
    rng = np.random.default_rng(6)
    noise = (rng.random(400) < 0.5).astype(np.int32)
    bits = np.concatenate([noise, psk_text.encode_bits("CQ"), noise])
    dec = psk_text.VaricodeDecoder()
    assert "CQ" in dec.push_bits(bits)
    with pytest.raises(TypeError):
        jpsk_text.VaricodeDecoder().push_bits(np.concatenate([noise] * 4))


@pytest.mark.parametrize("text,wpm", [("CQ TEST", 20), ("K", 35),
                                      ("PARIS 599", 28)])
def test_cw_text_matches_jax(text, wpm):
    for fs in (12000.0, 48000.0):
        np.testing.assert_array_equal(cw_text.text_to_keying(text, wpm, fs),
                                      jcw_text.text_to_keying(text, wpm, fs))
    np.testing.assert_array_equal(
        cw_text.text_to_keying_ref(text, wpm, n_blocks=3000),
        jcw_text.text_to_keying_ref(text, wpm, n_blocks=3000))
    env = cw_text.text_to_keying(text, wpm, 12000.0)
    keying = np.concatenate([env[: len(env) // 88 * 88].reshape(-1, 88)
                             .mean(-1) > 0.5, np.zeros(300, bool)])
    assert cw_text.CwTextDecoder(12000.0 / 88).push_keying(keying) == \
        jcw_text.CwTextDecoder(12000.0 / 88).push_keying(keying)


@pytest.mark.parametrize("mode", list(jkeyer.KeyerMode))
def test_keyer_matches_jax(mode):
    rng = np.random.default_rng(5)
    paddles = rng.random((600, 2)) < 0.3
    k = keyer.Keyer(keyer.KeyerMode[mode.name], wpm=25)
    jk = jkeyer.Keyer(mode, wpm=25)
    a = np.concatenate([k.process(bool(d), bool(h), 480)
                        for d, h in paddles])
    b = np.concatenate([jk.process(bool(d), bool(h), 480)
                        for d, h in paddles])
    np.testing.assert_array_equal(a, b)
    assert a.any()
    buf, jbuf = keyer.DigiTxBuffer(), jkeyer.DigiTxBuffer()
    assert buf.put("CQ DE") == jbuf.put("CQ DE")
    assert [buf.get() for _ in range(7)] == [jbuf.get() for _ in range(7)]


def _digi_chain(tone_48k: np.ndarray) -> np.ndarray:
    """The port's digital TX path as tests/test_tx_conformance.py runs the
    JAX chain's: the generator tone through the USB voice chain with the
    bandpass on, the compressor off and no translation."""
    cfg = ttx.TxConfig(mode="usb", translate_hz=0.0, block_len=BLOCK,
                       compressor=False)
    chain = ttx.TxChain(cfg, device="cpu")
    state = chain.init_state((1,))
    audio = (tone_48k / INT16_FS).astype(np.float32)
    outs = []
    for s in range(0, (len(audio) // BLOCK) * BLOCK, BLOCK):
        i, q, state = chain(state, audio[None, s:s + BLOCK])
        outs.append(i.numpy()[0] + 1j * q.numpy()[0])
    return np.concatenate(outs) * INT16_FS


def _snr(ref: np.ndarray, got: np.ndarray) -> float:
    r, g = ref[SKIP:len(got)], got[SKIP:]
    return 10.0 * np.log10(np.mean(np.abs(r) ** 2)
                           / (np.mean(np.abs(r - g) ** 2) + 1e-30))


def test_rtty_tx_row():
    n, text = 48000 * 2, "CQ CQ DE UHSDR"
    tone = rtty_text.gen_tx_tone_ref(text, n)
    np.testing.assert_array_equal(tone, gold.RttyTxOracle(text).gen(n))
    s = _snr(gold.rtty_tx_oracle(text, n), _digi_chain(tone))
    print(f"TX rtty on the port: {s:.1f} dB")
    assert s >= 50.0


def test_psk_tx_row():
    n, text = 48000 * 3, "cq de uhsdr"
    tone = psk_text.gen_tx_tone_ref(text, n)
    np.testing.assert_array_equal(tone, gold.PskTxOracle(text).gen(n))
    s = _snr(gold.psk_tx_oracle(text, n), _digi_chain(tone))
    print(f"TX psk on the port: {s:.1f} dB")
    assert s >= 50.0


def test_cw_tx_envelope_row():
    """The keying envelope bit-equal to the CwGen_ProcessIambic oracle
    for two texts and speeds, and the port's CW chain keys a unit
    carrier whose |IQ| reproduces it (within 2e-3, as the JAX row)."""
    nb = 1500 * 4
    for text, wpm in [("CQ TEST", 20), ("K", 35)]:
        _, gain = gold.CwTextTxOracle(text, wpm=wpm).process_blocks(nb)
        np.testing.assert_array_equal(
            cw_text.text_to_keying_ref(text, wpm, n_blocks=nb), gain)
    env = cw_text.text_to_keying_ref("CQ", 20, n_blocks=1500)
    cfg = ttx.TxConfig(mode="cw", translate_hz=6000.0, block_len=BLOCK)
    chain = ttx.TxChain(cfg, device="cpu")
    state = chain.init_state((1,))
    n = (len(env) // BLOCK) * BLOCK
    mags = []
    for s in range(0, n, BLOCK):
        i, q, state = chain(state, torch.from_numpy(
            env[None, s:s + BLOCK].astype(np.float32)))
        mags.append(np.abs(i.numpy()[0] + 1j * q.numpy()[0]))
    err = np.concatenate(mags) - env[:n]
    print(f"TX cw envelope on the port: max |err| {np.abs(err).max():.2e}")
    assert np.abs(err).max() < 2e-3
