"""The slice end to end on the CPU: the port's RX chain carrying an RTTY
AFSK signal, its ``spectrum_iq`` tap into the scope and its ``audio_dec``
tap into the decoder tap (`modems/tap.py`), against the JAX chain with
the JAX package's scope and `rtty.demodulate` on the same capture; and
the entry points' devices.

The codes must be equal in arrival order and the text the message: the
chains' audio agree to ~80 dB (tests/test_torch_rx.py) and the AFSK's
bit decisions are far from ties (a zero crossing of the comparator may
move by a sample).  The scope's spectrum >= 100 dB and its SNAP within 0.01 Hz
(its input, the tap, is the same in both; tests/test_torch_scope.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uhsdr_tpu.chain import rx as jrx
from uhsdr_tpu.modems import rtty as jrtty
from uhsdr_tpu.spectrum import scope as jscope
from uhsdr_tpu_torch.chain import rx as trx
from uhsdr_tpu_torch.core import stream
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.modems import cw, psk, rtty, rtty_text, tap
from uhsdr_tpu_torch.spectrum import scope

FS = 48000.0
TRANSLATE = 12000.0
CFG = dict(mode="usb", bw_key="2P3KHZ", path_name="LPF",
           translate_hz=TRANSLATE, iq_rate=FS, block_len=4096)
MSG = "RYRY"
HANDOVER = 2       # blocks of idle mark before the message (0.2 s lead)


def afsk_capture(msg: str, seconds: float, seed: int = 3):
    """Two channels of f32 IQ @ 48 kHz: 45.45 Bd / 170 Hz AFSK of `msg`
    (mark 915 Hz, 0.2 s of idle mark first: past HANDOVER blocks) on
    the upper sideband of the translate frequency, at -10 dBFS; channel 1 the same 400 samples
    later.  Plus noise at -60 dBFS."""
    one_bit = 4 * int(round(12000.0 / 45.45))
    bits = rtty_text.codes_to_bits(rtty_text.encode(msg), one_bit)
    n = int(seconds * FS)
    lead = int(0.2 * FS)
    key = np.ones(n, bool)
    key[lead:lead + len(bits)] = bits[: n - lead]
    rng = np.random.default_rng(seed)
    chans = []
    for shift in (0, 400):
        k = np.roll(key, shift)
        f = TRANSLATE + np.where(k, rtty.MARK_FREQ, rtty.MARK_FREQ + 170.0)
        ph = 2 * np.pi * np.cumsum(f) / FS
        z = 0.3 * np.exp(1j * ph) + 1e-3 * (rng.standard_normal(n)
                                            + 1j * rng.standard_normal(n))
        chans.append(z)
    z = np.stack(chans).astype(np.complex64)
    return z.real.copy(), z.imag.copy()


def test_rtty_through_the_chain_matches_jax():
    B = CFG["block_len"]
    i_p, q_p = afsk_capture(MSG, 1.5)
    i_b, q_b = stream.chunk_capture(i_p, q_p, B)
    chain = trx.RxChain(trx.RxConfig(**CFG), device="cpu")
    dec_tap = tap.DecoderTap(2, text_channels=(0, 1), device="cpu")
    sp = scope.make_params(translate_hz=TRANSLATE)
    ss = scope.init_state((2,), sp, device="cpu")
    jcfg = jrx.RxConfig(**CFG)
    jp = jrx.make_params(jcfg)
    jstep = jax.jit(lambda s, i, q: jrx.process_block(jcfg, jp, s, (i, q)))
    rp = jrtty.make_params(fs=12000.0, baud=45.45, shift=170.0)
    jdemod = jax.jit(lambda s, a: jrtty.demodulate(rp, s, a))
    js, jrs = jrx.init_state(jcfg, jp, (2,)), jrtty.init_state((2,))
    jss = jscope.init_state((2,), jscope.make_params(translate_hz=TRANSLATE))
    ts = chain.init_state((2,))
    codes_j, codes_t = [], []
    for k in range(i_b.shape[0]):
        if k == HANDOVER:
            # the chains' start-up (zero states, the AGC's attack) lies
            # within a few dB of a false start bit: both decode on from
            # the JAX package's chain and demodulator state
            ts = trx.state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                      device="cpu")
            dec_tap.state["rtty"] = rtty.state_from_numpy(jrs, device="cpu")
            codes_j, codes_t = [], []
        _, ts, taps = chain(ts, i=i_b[k], q=q_b[k])
        so, ss = scope.process(sp, ss, taps["spectrum_iq"])
        out = dec_tap.push(taps["audio_dec"])
        codes_t.append(out["rtty"].codes.numpy())
        _, js, tj = jstep(js, jnp.asarray(i_b[k]), jnp.asarray(q_b[k]))
        jso, jss = jscope.process(jscope.make_params(translate_hz=TRANSLATE),
                                  jss, tj["spectrum_iq"])
        cj, _, jrs = jdemod(jrs, tj["audio_dec"])
        codes_j.append(np.asarray(cj))
        assert snr_db(np.asarray(jso["spectrum"]), so["spectrum"]) >= 100.0
        np.testing.assert_allclose(so["snap_freq"].numpy(),
                                   np.asarray(jso["snap_freq"]), atol=0.01)
        # 1024 samples a block: whole CW frames and PSK31 symbols in each
        assert out["cw"] is not None and out["psk"] is not None
    # the codes in arrival order: a comparator crossing near a tie can
    # move by a sample, and a code framed on a block's last sample into
    # the next block's slots
    ct, cj = np.concatenate(codes_t, -1), np.concatenate(codes_j, -1)
    for c in range(2):
        np.testing.assert_array_equal(ct[c][ct[c] >= 0], cj[c][cj[c] >= 0])
    texts = dec_tap.flush()
    assert MSG in texts["rtty"][0], texts
    assert MSG in texts["rtty"][1], texts
    assert set(texts) == {"cw", "psk", "rtty"}
    # the mark tone sits 915 Hz above the dial, SNAP's reference
    assert abs(float(so["snap_freq"][0]) - rtty.MARK_FREQ) < 50.0


def test_tap_keeps_remainders_on_the_device():
    """A block of 2048 (neither a multiple of 88 nor of 384) leaves its
    remainders as the next block's head: the tap's outputs over uneven
    blocks equal the demodulators' over the whole stream, for each of
    its three decoders."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((3, 2048 * 3))
                         .astype(np.float32) * 1000.0)
    t = tap.DecoderTap(3, device="cpu")
    got = {"cw": [], "psk": [], "rtty": []}
    for k in range(3):
        out = t.push(x[:, k * 2048:(k + 1) * 2048])
        for m in got:
            got[m].append(out[m])
    assert tuple(t.tail["cw"].shape) == (3, 6144 % 88)
    assert tuple(t.tail["psk"].shape) == (3, 6144 % 384)
    kc, _ = cw.keying_detect(tap.CW_PARAMS, cw.init_state((3,), device="cpu"),
                             x[:, :6144 // 88 * 88])
    assert torch.equal(torch.cat(got["cw"], -1), kc)
    pp = psk.make_params(speed=31)
    bp, _ = psk.demodulate(pp, psk.init_state((3,), pp, device="cpu"),
                           x[:, :6144 // 384 * 384].contiguous())
    assert torch.equal(torch.cat(got["psk"], -1), bp)
    codes, nb, _ = rtty.demodulate(tap.RTTY_PARAMS,
                                   rtty.init_state((3,), device="cpu"), x)
    assert torch.equal(sum(o.nbytes for o in got["rtty"]), nb)
    for c in range(3):
        blocks = [o.codes[c, :int(o.nbytes[c])] for o in got["rtty"]]
        assert torch.equal(torch.cat(blocks), codes[c, :int(nb[c])])


@pytest.mark.parametrize("mode", ["cw", "psk", "rtty"])
def test_tap_runs_the_modes_named(mode):
    """`modes` (the command line's one decoder): the tap runs that mode
    alone, its results and text as the three-mode tap's; a mode it does
    not know is refused."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((2, 2048 * 2))
                         .astype(np.float32) * 1000.0)
    one = tap.DecoderTap(2, text_channels=(1,), device="cpu", modes=(mode,))
    every = tap.DecoderTap(2, text_channels=(1,), device="cpu")
    for k in range(2):
        blk = x[:, k * 2048:(k + 1) * 2048]
        a, b = one.push(blk), every.push(blk)
        assert set(a) == {mode}
        ra, rb = (r.codes if mode == "rtty" else r for r in (a[mode],
                                                            b[mode]))
        assert torch.equal(ra, rb)
    ta, tb = one.flush(), every.flush()
    assert set(ta) == {mode} and ta[mode] == tb[mode]
    with pytest.raises(ValueError, match="modes"):
        tap.DecoderTap(2, device="cpu", modes=(mode, "sstv"))


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert stream.StreamRunner(lambda s, i, q: (i, s)).device.type == "cuda"
    assert trx.resolve_device().type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pp = psk.make_params()
    calls = [lambda: cw.init_state((2,)), lambda: psk.init_state((2,), pp),
             lambda: rtty.init_state((2,)),
             lambda: scope.init_state((2,), scope.make_params()),
             lambda: tap.DecoderTap(2),
             lambda: stream.StreamRunner(lambda s, i, q: (i, s)),
             lambda: cw.state_from_numpy(cw.state_to_numpy(
                 cw.init_state((1,), device="cpu")))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert cw.init_state((2,), device="cpu").siglevel.device.type == "cpu"
