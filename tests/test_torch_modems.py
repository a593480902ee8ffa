"""The port's digital-mode decoders (CW, PSK, RTTY) against the JAX
package's, on the CPU (the kernels' plain versions), and their loopbacks.

Each comparison feeds both packages the same numpy audio over several
streamed blocks: block 0 from the zero state in each, then the JAX state
handed to the port, then the port's state handed back to the JAX
package, comparing every block's output and every state leaf.  The
loopbacks are the JAX package's own (tests/test_cw.py, test_psk.py,
test_rtty.py), decoded to text through the port.

Tolerances and why:
* CW: the keying equal; siglevel, env and noise >= 100 dB.  The JAX
  package's projection is a matmul, the port's a sum in sample order.
* PSK: the symbols (the last symbol of each one-symbol block) >= 90 dB
  and the bits equal wherever neither symbol of a decision lies within
  1e-4 of the symbols' rms of zero.  The JAX package differences a
  block-long cumsum (psk.py:94-96), which rounds in proportion to the
  block's running sum; the port sums each window directly, the more
  exact of the two.  The filter state >= 90 dB and the product tail
  >= 95 dB: its biquad is a dilated scan, the port's sequential
  (`ops/iir.py::biquad_block`).
* RTTY: codes, nbytes and the eight DPLL/UART registers equal; the mark
  and space filter states >= 85 dB, the ATC envelopes >= 100 dB and the
  50 Hz low-pass state >= 50 dB: the JAX package's dilated scan holds
  that filter (poles near 1) to ~58 dB from float64 where the port's
  sequential biquad holds ~96 dB (test_biquad_block_against_float64).
* TX: `psk.modulate` and `rtty.modulate` >= 80 dB (the JAX package's
  XLA sine parts from torch's by up to ~1e-4 on long blocks), their
  phases equal.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uhsdr_tpu.modems import cw as jcw
from uhsdr_tpu.modems import cw_text as jcw_text
from uhsdr_tpu.modems import psk as jpsk
from uhsdr_tpu.modems import psk_text as jpsk_text
from uhsdr_tpu.modems import rtty as jrtty
from uhsdr_tpu.modems import rtty_text as jrtty_text
from uhsdr_tpu.ops import iir as jiir
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.modems import cw, cw_text, psk, psk_text, rtty, rtty_text
from uhsdr_tpu_torch.ops import iir

FS = 12000.0


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_state(cls, d: dict):
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def _leaves(s) -> dict:
    return {k: np.asarray(v) for k, v in s._asdict().items()}


def _stream(jfn, tfn, j_state, t_state, blocks, t_mod, jcls, after):
    """Run both over the blocks (the JAX step under `jit`): block 0 each
    from its own state, then the JAX state handed to the port, then the
    port's back.  `after(k, jout,
    tout, jstate, tstate)` checks each block.  Returns the port's outputs."""
    jfn = jax.jit(jfn)
    outs = []
    for k, blk in enumerate(blocks):
        if k == 1:
            t_state = t_mod.state_from_numpy(_leaves(j_state), device="cpu")
        if k == 2:
            j_state = _jax_state(jcls, t_mod.state_to_numpy(t_state))
        jo, j_state = jfn(j_state, jnp.asarray(blk))
        to, t_state = tfn(t_state, _t(blk))
        after(k, jo, to, _leaves(j_state), t_mod.state_to_numpy(t_state))
        outs.append(to)
    return outs


def _cw_audio(msg: str, wpm: int, amp: float, noise: float, seed: int = 0):
    env = jcw_text.text_to_keying(msg, wpm, FS)
    env = np.concatenate([env, np.zeros(int(FS), np.float32)])
    t = np.arange(len(env)) / FS
    audio = (amp * env * np.sin(2 * np.pi * 700 * t)).astype(np.float32)
    rng = np.random.default_rng(seed)
    return audio + noise * rng.standard_normal(len(audio)).astype(np.float32)


@pytest.mark.parametrize("atc", [False, True])
@pytest.mark.parametrize("noisecancel", [False, True])
def test_cw_keying_matches_jax(atc, noisecancel):
    """The JAX CW loopback's audio (tests/test_cw.py) and a shifted copy,
    in 20-frame blocks: keying equal, state leaves >= 100 dB, and the
    port's keying decodes the text."""
    audio = _cw_audio("PARIS PARIS PARIS PARIS PARIS", 22, 300.0, 2.0)
    bs = 88
    B = bs * 20
    n = (len(audio) // B) * B
    x = np.stack([audio[:n], np.roll(audio[:n], 777)])
    pj = jcw.make_params(fs=FS, thresh=30000.0, atc=atc,
                         noisecancel=noisecancel)
    pt = cw.make_params(fs=FS, thresh=30000.0, atc=atc,
                        noisecancel=noisecancel)

    def after(k, jo, to, js, ts):
        np.testing.assert_array_equal(np.asarray(jo), to.numpy())
        for f in ("cw_state", "change"):
            np.testing.assert_array_equal(js[f], ts[f])
        for f in ("siglevel", "env", "noise"):
            assert snr_db(js[f], ts[f]) >= 100.0, (k, f)

    outs = _stream(lambda s, a: jcw.keying_detect(pj, s, a),
                   lambda s, a: cw.keying_detect(pt, s, a),
                   jcw.init_state((2,)), cw.init_state((2,), device="cpu"),
                   [x[:, k:k + B] for k in range(0, n, B)], cw, jcw.CwRxState,
                   after)
    dec = cw_text.CwTextDecoder(FS / bs)
    out = dec.push_keying(torch.cat(outs, -1)[0].numpy())
    assert "PARIS" in out.replace(" ", ""), out


def test_cw_keying_detect_on_tone():
    """tests/test_cw.py's tone-burst case through the port."""
    params = cw.make_params(fs=FS, target_freq=700.0, thresh=1000.0)
    bs = params.blocksize
    nblk = 200
    t = np.arange(nblk * bs) / FS
    env = np.zeros(nblk * bs, np.float32)
    env[50 * bs:100 * bs] = 1.0
    audio = (200.0 * env * np.sin(2 * np.pi * 700 * t)).astype(np.float32)
    keying, _ = cw.keying_detect(params, cw.init_state((1,), device="cpu"),
                                 _t(audio[None]))
    k = keying.numpy()[0]
    assert k[55:98].all() and not k[:48].any() and not k[105:].any()


def _psk_audio(speed: int, msg: str, B: int):
    params = jpsk.make_params(fs=FS, speed=speed)
    bits = jpsk_text.encode_bits(msg)
    signs, env = jpsk_text.bits_to_waveform_params(bits, params.rate)
    pad = (-len(signs)) % B + B
    signs = np.concatenate([signs, np.ones(pad, np.float32)])
    env = np.concatenate([env, np.ones(pad, np.float32)])
    audio, _ = jpsk.modulate(params, jnp.zeros((1,), jnp.uint32),
                             jnp.asarray(signs[None]), jnp.asarray(env[None]))
    rng = np.random.default_rng(0)
    return (np.asarray(audio)[0]
            + 0.05 * rng.standard_normal(signs.shape[-1])).astype(np.float32)


@pytest.mark.parametrize("speed", [31, 63])
def test_psk_demodulate_matches_jax(speed):
    """The JAX PSK loopback's audio (tests/test_psk.py) and a shifted
    copy, a symbol a block: symbols >= 90 dB, bits equal away from
    near-zero symbols, the state at its bounds; the port decodes the
    text."""
    pj = jpsk.make_params(fs=FS, speed=speed)
    pt = psk.make_params(fs=FS, speed=speed)
    audio = _psk_audio(speed, "KA7OEI", pj.rate * 16)
    x = np.stack([audio, np.roll(audio, 1000)])
    R = pj.rate
    syms_j, syms_t, bits_j, bits_t = [], [], [], []

    def after(k, jo, to, js, ts):
        bits_j.append(np.asarray(jo))
        bits_t.append(to.numpy())
        syms_j.append(js["last_symbol"])
        syms_t.append(ts["last_symbol"])
        np.testing.assert_array_equal(js["nco_phase"], ts["nco_phase"])
        np.testing.assert_array_equal(js["sample_offset"],
                                      ts["sample_offset"])
        assert snr_db(js["bpf_bq"], ts["bpf_bq"]) >= 90.0, k
        assert snr_db(js["prod_tail"], ts["prod_tail"]) >= 95.0, k

    outs = _stream(lambda s, a: jpsk.demodulate(pj, s, a),
                   lambda s, a: psk.demodulate(pt, s, a),
                   jpsk.init_state((2,), pj),
                   psk.init_state((2,), pt, device="cpu"),
                   [x[:, k:k + R] for k in range(0, x.shape[1], R)], psk,
                   jpsk.PskRxState, after)
    sj, st = np.stack(syms_j, 1), np.stack(syms_t, 1)
    assert snr_db(sj, st) >= 90.0
    bj, bt = np.concatenate(bits_j, 1), np.concatenate(bits_t, 1)
    eps = 1e-4 * np.sqrt(np.mean(sj ** 2))
    clear = np.abs(sj) > eps
    clear[:, 1:] &= clear[:, :-1]
    np.testing.assert_array_equal(bj[clear], bt[clear])
    dec = psk_text.VaricodeDecoder()
    dec.push_bits(torch.cat(outs, -1)[0].numpy())
    assert "KA7OEI" in dec.push_bits([])


def test_psk_demodulate_refuses_a_ragged_block():
    p = psk.make_params(fs=FS, speed=31)
    with pytest.raises(ValueError, match="multiple"):
        psk.demodulate(p, psk.init_state((1,), p, device="cpu"),
                       torch.zeros((1, 500)))


def _rtty_audio(atc: bool, msg: str, B: int):
    params = jrtty.make_params(fs=FS, baud=45.45, shift=170.0, atc=atc)
    bits = jrtty_text.codes_to_bits(jrtty_text.encode(msg), params.one_bit)
    pad = (-len(bits)) % B + B
    bits = np.concatenate([bits, np.ones(pad, bool)])
    audio, _ = jrtty.modulate(params, jnp.zeros((1,), jnp.uint32),
                              jnp.asarray(bits[None]))
    rng = np.random.default_rng(0)
    audio = np.asarray(audio)[0].astype(np.float32)
    return audio + 0.05 * rng.standard_normal(len(audio)).astype(np.float32)


RTTY_DB = {"mark_bq": 85.0, "space_bq": 85.0, "atc_env": 100.0,
           "lpf_bq": 50.0}


@pytest.mark.parametrize("atc", [False, True])
def test_rtty_demodulate_matches_jax(atc):
    """The JAX RTTY loopback's audio (tests/test_rtty.py, 6000-sample
    blocks) and a shifted copy: codes, nbytes and the DPLL/UART registers
    equal, the filter and ATC states at their bounds; the port decodes
    the text."""
    msg = "RYRY CQ DE UHSDR"
    B = 6000
    audio = _rtty_audio(atc, msg, B)
    x = np.stack([audio, np.roll(audio, 2345)])
    pj = jrtty.make_params(fs=FS, baud=45.45, shift=170.0, atc=atc)
    pt = rtty.make_params(fs=FS, baud=45.45, shift=170.0, atc=atc)

    def after(k, jo, to, js, ts):
        for a, b in zip(jo, to):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for f, v in js.items():
            if f in RTTY_DB:
                assert snr_db(v, ts[f]) >= RTTY_DB[f], (k, f)
            else:
                np.testing.assert_array_equal(v, ts[f], err_msg=f)

    def jfn(s, a):
        codes, nb, s = jrtty.demodulate(pj, s, a)
        return (codes, nb), s

    def tfn(s, a):
        codes, nb, s = rtty.demodulate(pt, s, a)
        return (codes, nb), s

    outs = _stream(jfn, tfn, jrtty.init_state((2,)),
                   rtty.init_state((2,), device="cpu"),
                   [x[:, k:k + B] for k in range(0, x.shape[1], B)], rtty,
                   jrtty.RttyRxState, after)
    dec = rtty_text.BaudotDecoder()
    for codes, _ in outs:
        dec.push_codes(codes[0].numpy())
    assert msg in dec.push_codes([])


def test_rtty_codes_fill_their_slots_in_order():
    """Codes framed in a block fill its slots in order, -1 after, and
    nbytes counts them; a code past the last slot overwrites it."""
    emits = torch.full((2, 50), -1.0)
    emits[0, [3, 9, 20]] = torch.tensor([5.0, 0.0, 31.0])
    emits[1, [1, 2, 3, 4]] = torch.tensor([1.0, 2.0, 3.0, 4.0])
    from uhsdr_tpu_torch.cuda import rtty as rtty_k
    codes, nb = rtty_k.compact(emits, 3)
    np.testing.assert_array_equal(codes.numpy(), [[5, 0, 31], [1, 2, 4]])
    np.testing.assert_array_equal(nb.numpy(), [3, 4])


@pytest.mark.parametrize("name", ["lpf", "mark_bp"])
def test_biquad_block_against_float64(name):
    """`ops/iir.py::biquad_block` (sequential) against a float64 DF2T on
    squared noise: >= 90 dB on y and the state.  The JAX package's
    dilated scan on the same input, printed beside, holds the 50 Hz
    low-pass to ~58 dB."""
    c = getattr(rtty.make_params(), name)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 3000)) ** 2).astype(np.float32)
    s0 = rng.standard_normal((3, 2)).astype(np.float32)
    yt, st = iir.biquad_block(c, _t(s0), _t(x))
    b0, b1, b2, a1, a2 = c.astype(np.float64)
    s1, s2 = s0[:, 0].astype(np.float64), s0[:, 1].astype(np.float64)
    y = np.zeros(x.shape)
    for n in range(x.shape[1]):
        xn = x[:, n].astype(np.float64)
        y[:, n] = b0 * xn + s1
        s1, s2 = b1 * xn - a1 * y[:, n] + s2, b2 * xn - a2 * y[:, n]
    yj, _ = jiir.biquad_block(jnp.asarray(c), jnp.asarray(s0), jnp.asarray(x))
    print(f"{name}: port {snr_db(y, yt):.1f} dB, JAX {snr_db(y, yj):.1f} dB")
    assert snr_db(y, yt) >= 90.0
    assert snr_db(np.stack([s1, s2], -1), st) >= 90.0


@pytest.mark.parametrize("speed", [31, 63])
def test_psk_modulate_matches_jax(speed):
    pj = jpsk.make_params(fs=FS, speed=speed)
    pt = psk.make_params(fs=FS, speed=speed)
    signs, env = jpsk_text.bits_to_waveform_params(
        jpsk_text.encode_bits("cq de uhsdr"), pj.rate)
    ph0 = np.array([0, 123456789, 2 ** 32 - 5], np.uint32)
    S = np.stack([signs] * 3)
    E = np.stack([env] * 3)
    aj, phj = jpsk.modulate(pj, jnp.asarray(ph0), jnp.asarray(S),
                            jnp.asarray(E))
    at, pht = psk.modulate(pt, _t(ph0.astype(np.int64)), _t(S), _t(E))
    assert snr_db(np.asarray(aj), at) >= 80.0
    np.testing.assert_array_equal(np.asarray(phj).astype(np.int64),
                                  pht.numpy())


def test_rtty_modulate_matches_jax():
    pj = jrtty.make_params(fs=FS)
    pt = rtty.make_params(fs=FS)
    bits = jrtty_text.codes_to_bits(jrtty_text.encode("RYRY 599"),
                                    pj.one_bit)
    ph0 = np.array([0, 4000000000], np.uint32)
    B = np.stack([bits, ~bits])
    aj, phj = jrtty.modulate(pj, jnp.asarray(ph0), jnp.asarray(B))
    at, pht = rtty.modulate(pt, _t(ph0.astype(np.int64)), _t(B))
    assert snr_db(np.asarray(aj), at) >= 80.0
    np.testing.assert_array_equal(np.asarray(phj).astype(np.int64),
                                  pht.numpy())
