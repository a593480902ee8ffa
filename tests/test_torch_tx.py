"""The port's TX chain (`uhsdr_tpu_torch.chain.tx`) on the CPU, where its
wrappers run the kernels' plain torch versions, against the JAX package:

* K8's plain version (`cuda/fir.py::fir_real_plain`) against the TPU
  kernel `fir_real_analytic_pallas` in interpret mode, NCO and
  conjugation on and off, over two streamed blocks;
* the ALC (`mod/alc.py::run`, the recurrence's plain version) against
  the JAX `mod/alc.py::run`, over three blocks that cross the knee;
* the SSB, AM and CW modulators against the JAX ones;
* the TX chains usb, lsb, am, cw (reference front) and usb, lsb (legacy
  front) against the JAX `TxChain` over four streamed blocks, with the
  hand-over after block 2 in both directions;
* FM TX building on both fronts (its numbers: tests/test_torch_fm_tx.py).

Tolerances.  K8 against the TPU kernel: 100 dB (measured 131 dB: the two
sum 201 products in other orders).  The ALC: 120 dB on audio and gain
state (measured >= 145 dB; XLA's CPU code fuses some of the step's
multiply-adds).  Modulators: 100 dB (the JAX oscillator is a product of
a coarse and a fine rotor, the port's one rotor of the exact phase).
Chains: the reference front's voice bandpass, the SOPRANO lattice as
SOS, runs in the JAX package's CPU route as a dilated scan that sits
77.2-77.8 dB from a float64 `sosfilt` (the port's blocked exact carry:
109-111 dB), and that bounds the port against the JAX CPU chain (usb and
lsb IQ read 77.5 dB).  So the chains are held to 80 dB against the JAX
chain with its voice bandpass on the JAX package's off-CPU route
(`biquad_cascade_blocked(exact_carry=True)`, ops/iir.py:232-239, the
route its TPU runs), and the unpatched CPU chain is printed beside and
held to 75 dB.  The ALC's nonlinear recurrence does not amplify the
difference (alc_val >= 103 dB in every block; `-s` prints them).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_tx_conformance import make_voice
from uhsdr_tpu.chain import tx as jtx
from uhsdr_tpu.mod import alc as jalc
from uhsdr_tpu.mod import modulators as jmods
from uhsdr_tpu.ops import iir as jiir
from uhsdr_tpu.ops import nco as jnco
from uhsdr_tpu.pallas import fir as pfir
from uhsdr_tpu_torch.chain import tx as ttx
from uhsdr_tpu_torch.cuda import fir as fir_k
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.mod import alc as talc
from uhsdr_tpu_torch.mod import modulators as tmods
from uhsdr_tpu_torch.ops import nco

K8_DB = 100.0
ALC_DB = 120.0
MOD_DB = 100.0
CHAIN_DB = 80.0
CPU_CHAIN_DB = 75.0
C, B, N_BLOCKS = 4, 2048, 4


@pytest.mark.parametrize("use_nco,conj", [(False, False), (True, False),
                                          (True, True), (False, True)])
def test_fir_real_plain_matches_pallas(use_nco, conj):
    """fir_real_analytic_pallas needs B % tile_t == 0 and tile_t a multiple
    of 256 for 201 taps: 8 channels x 1024 samples, tile 512."""
    h = tmods.ssb_params_ref(6000.0).fir.numpy()
    delta = int(nco.freq_to_delta(6000.0, 48000.0))
    rng = np.random.default_rng(41)
    Cp, Bp = 8, 1024
    cj, ct = jnp.zeros((Cp, 200), jnp.float32), torch.zeros((Cp, 200))
    ph = 123456789
    for blk in range(2):
        x = rng.standard_normal((Cp, Bp)).astype(np.float32)
        yj, cj = pfir.fir_real_analytic_pallas(
            h, cj, jnp.asarray(x), tile_c=8, tile_t=512,
            nco=(jnp.uint32(ph), jnp.uint32(delta)) if use_nco else None,
            conj=conj, interpret=True)
        pt = torch.full((Cp,), ph, dtype=torch.int64)
        yt, ct = fir_k.fir_real_plain(
            torch.from_numpy(h), ct, torch.from_numpy(x),
            nco=(pt, delta) if use_nco else None, conj=conj)
        s = snr_db(np.asarray(yj), yt)
        print(f"\nK8 plain (nco {use_nco}, conj {conj}) block {blk} vs the "
              f"TPU kernel: {s:.1f} dB")
        assert s >= K8_DB
        np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
        ph = (ph + delta * Bp) % 2**32


@pytest.mark.parametrize("decay,delay,gain_scaling",
                         [(10.0 ** -4.5, 288, 1.0), (0.02, 64, 0.23)])
def test_alc_matches_jax(decay, delay, gain_scaling):
    jp = jalc.make_params(decay=decay, delay=delay, postfilt_gain=4.0,
                          gain_scaling=gain_scaling)
    tp = talc.params_from_numpy(jp)
    assert tp == talc.make_params(decay, delay, 4.0, gain_scaling)
    Ca = 16
    rng = np.random.default_rng(42)
    js, ts = jalc.init_state((Ca,), jp), talc.init_state((Ca,), tp)
    run = jax.jit(lambda s, x: jalc.run(jp, s, x))
    for blk in range(3):
        n = np.arange(blk * B, (blk + 1) * B)
        x = (np.logspace(3, 4.5, Ca)[:, None]
             * np.sin(2 * np.pi * 700 * n / 48000.0) * (n % 3000 < 1500)
             + rng.standard_normal((Ca, B))).astype(np.float32)
        yj, js = run(js, jnp.asarray(x))
        yt, ts = talc.run(tp, ts, torch.from_numpy(x))
        vals = (snr_db(np.asarray(yj), yt),
                snr_db(np.asarray(js.alc_val), ts.alc_val),
                snr_db(np.asarray(js.delay_buf), ts.delay_buf))
        print(f"\nALC block {blk}: audio {vals[0]:.1f} dB, alc_val "
              f"{vals[1]:.1f}, delay {vals[2]:.1f}; gain range "
              f"{float(ts.alc_val.min()):.4f}..{float(ts.alc_val.max()):.4f}")
        assert min(vals) >= ALC_DB
    assert float(ts.alc_val.min()) < 0.9       # the knee was crossed


def test_modulators_match_jax():
    rng = np.random.default_rng(43)
    a = (rng.standard_normal((C, 3 * B)) * 3000.0).astype(np.float32)
    cases = (
        ("ssb ref lsb", jmods.ssb_params_ref(6000.0, lsb=True),
         tmods.ssb_params_ref(6000.0, lsb=True), jmods.ssb_modulate,
         tmods.ssb_modulate),
        ("ssb scipy lsb", jmods.ssb_params(translate_hz=9000.0, lsb=True),
         tmods.ssb_params(translate_hz=9000.0, lsb=True), jmods.ssb_modulate,
         tmods.ssb_modulate),
        ("am ref", jmods.am_params_ref(6000.0), tmods.am_params_ref(6000.0),
         jmods.am_modulate, tmods.am_modulate))
    for name, jp, tp, jfn, tfn in cases:
        fp = tmods.params_from_numpy(jp)
        assert torch.equal(fp.fir, tp.fir) and fp[1:] == tp[1:], name
        js, ts = jmods.ssb_init((C,)), tmods.ssb_init((C,))
        for k in range(3):
            blk = a[:, k * B:(k + 1) * B]
            yj, js = jfn(jp, js, jnp.asarray(blk))
            yt, ts = tfn(tp, ts, torch.from_numpy(blk))
            s = snr_db(np.asarray(yj), yt)
            print(f"\n{name} block {k}: {s:.1f} dB")
            assert s >= MOD_DB
            np.testing.assert_array_equal(np.asarray(js.phase),
                                          ts.phase.numpy().astype(np.uint32))
            np.testing.assert_array_equal(np.asarray(js.carry),
                                          ts.carry.numpy())
    env = (rng.random((C, 3 * B)) > 0.5).astype(np.float32)
    delta = nco.freq_to_delta(6700.0, 48000.0)
    pj = jnp.zeros((C,), jnp.uint32)
    pt = torch.zeros((C,), dtype=torch.int64)
    for k in range(3):
        blk = env[:, k * B:(k + 1) * B]
        yj, pj = jmods.cw_carrier(jnp.asarray(blk), pj, delta)
        yt, pt = tmods.cw_carrier(torch.from_numpy(blk), pt, int(delta))
        assert snr_db(np.asarray(yj), yt) >= MOD_DB
        np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    osc, ph = nco.tone_iq(pt, int(delta), 512)
    oj, phj = jnco.tone_iq(pj, jnp.broadcast_to(jnp.uint32(delta), (C,)), 512)
    assert snr_db(np.asarray(oj), osc) >= MOD_DB
    np.testing.assert_array_equal(np.asarray(phj), ph.numpy())


def _blocks(mode):
    """Four (C, B) audio blocks: the conformance voice at four levels
    (-10 ... 0 dB), or for CW a keyed envelope."""
    v = make_voice()[:N_BLOCKS * B]
    a = np.stack([v * 10.0 ** (-0.5 + c / 6.0) for c in range(C)])
    if mode == "cw":
        a = (np.abs(a) > 0.15).astype(np.float32)
    a = a.astype(np.float32)
    return [a[:, k * B:(k + 1) * B] for k in range(N_BLOCKS)]


def _exact_voice_sos(sos, state, x, precise=False):
    """The JAX package's off-CPU voice-bandpass route."""
    return jiir.biquad_cascade_blocked(np.asarray(sos), state, x,
                                       exact_carry=True)


def _state_snrs(js, ts) -> dict:
    out = {}
    for f, v in ttx.state_to_numpy(ts).items():
        ref = js
        for part in f.split("."):
            ref = getattr(ref, part)
        ref = np.asarray(ref)
        assert ref.shape == v.shape, f
        out[f] = (np.inf if np.array_equal(ref, v) else -np.inf) \
            if v.dtype.kind in "iu" else snr_db(ref, v)
    return out


def _to_jax_state(template, ts):
    out = template
    for f, v in ttx.state_to_numpy(ts).items():
        parts = f.split(".")
        if len(parts) == 1:
            out = out._replace(**{f: jnp.asarray(v)})
        else:
            sub = getattr(out, parts[0])._replace(**{parts[1]:
                                                     jnp.asarray(v)})
            out = out._replace(**{parts[0]: sub})
    return out


def _run_both_ways(mode, front, monkeypatch):
    kw = dict(mode=mode, front=front, translate_hz=6000.0, block_len=B)
    jcfg, tcfg = jtx.TxConfig(**kw), ttx.TxConfig(**kw)
    blocks = _blocks(mode)
    # the unpatched JAX CPU chain, printed and held to CPU_CHAIN_DB
    jcpu = jtx.TxChain(jcfg)
    tch = ttx.TxChain(tcfg, device="cpu")
    s_cpu, s_t = jcpu.init_state((C,)), tch.init_state((C,))
    cpu_db = []
    for blk in blocks:
        ij, qj, s_cpu = jcpu(s_cpu, jnp.asarray(blk))
        it, qt, s_t = tch(s_t, blk)
        cpu_db.append(snr_db(np.asarray(ij) + 1j * np.asarray(qj),
                             torch.complex(it, qt)))
    monkeypatch.setattr(jtx, "_voice_sos", _exact_voice_sos)
    jch = jtx.TxChain(jcfg)
    tp = ttx.params_from_numpy(jch.params, device="cpu")
    mine = ttx.make_params(tcfg, device="cpu")
    for name, a, b in zip(tp._fields, tp, mine):
        if isinstance(a, torch.Tensor) or name in ("voice_sos", "ssb", "am"):
            continue
        assert a == b, name
    for name in ("ssb", "am"):
        a, b = getattr(tp, name), getattr(mine, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a.fir, b.fir) and a[1:] == b[1:], name
    js, ts = jch.init_state((C,)), ttx.init_state(tcfg, tp, (C,))
    mid, ys = None, []
    for k, blk in enumerate(blocks):
        ij, qj, js = jch(js, jnp.asarray(blk))
        yj = np.asarray(ij) + 1j * np.asarray(qj)
        yt, ts, taps = ttx.process_block(tcfg, tp, ts, torch.from_numpy(blk))
        assert set(taps) == {"source", "processed"}
        ys.append((yj, yt))
        leaves = _state_snrs(js, ts)
        leaves["iq"] = snr_db(yj, yt)
        low = min(leaves, key=leaves.get)
        print(f"\nTX {mode} {front} block {k}: iq {leaves['iq']:.1f} dB "
              f"(JAX CPU chain: {cpu_db[k]:.1f} dB), worst leaf {low} "
              f"{leaves[low]:.1f} dB"
              + (f", alc_val {leaves['alc.alc_val']:.1f} dB"
                 if "alc.alc_val" in leaves else ""))
        assert leaves[low] >= CHAIN_DB, leaves
        assert cpu_db[k] >= CPU_CHAIN_DB
        if k == 1:
            mid = (js, ts)
    js_mid, ts_mid = mid
    ts2 = ttx.state_from_numpy(jax.tree_util.tree_map(np.asarray, js_mid),
                               device="cpu")
    assert min(_state_snrs(js_mid, ts2).values()) == np.inf
    js2 = _to_jax_state(js_mid, ts_mid)
    assert min(_state_snrs(js2, ts_mid).values()) == np.inf
    for k in (2, 3):
        yt2, ts2, _ = ttx.process_block(tcfg, tp, ts2,
                                        torch.from_numpy(blocks[k]))
        ij, qj, js2 = jch(js2, jnp.asarray(blocks[k]))
        hand = (snr_db(ys[k][0], yt2),
                snr_db(ys[k][1], np.asarray(ij) + 1j * np.asarray(qj)))
        print(f"  block {k} after hand-over: JAX->port {hand[0]:.1f} dB, "
              f"port->JAX {hand[1]:.1f} dB")
        assert min(hand) >= CHAIN_DB


@pytest.mark.parametrize("mode,front", [
    ("usb", "ref"), ("lsb", "ref"), ("am", "ref"), ("cw", "ref"),
    ("usb", "scipy"), ("lsb", "scipy")])
def test_tx_chain_matches_jax_streamed(mode, front, monkeypatch):
    _run_both_ways(mode, front, monkeypatch)


def test_fm_tx_raises_naming_roadmap():
    """FM TX was outside the port until it was ported (ROADMAP queue A
    item 8): it now builds on both fronts, its modulator functions run,
    and the JAX package's FM params carry over.  Its numbers are
    tests/test_torch_fm_tx.py's."""
    for front in ("ref", "scipy"):
        ch = ttx.TxChain(ttx.TxConfig(mode="fm", front=front), device="cpu")
        i, q, _ = ch(ch.init_state((2,)), np.zeros((2, 256), np.float32))
        assert i.shape == q.shape == (2, 256)
        assert bool(torch.isfinite(i).all() and torch.isfinite(q).all())
    p = tmods.fm_mod_params(count_domain=True)
    iq, _ = tmods.fm_modulate(p, tmods.fm_mod_init((2,)), torch.zeros(2, 64))
    assert iq.shape == (2, 64)
    burst, _ = tmods.fm_tone_burst(torch.zeros(2, dtype=torch.int64), 1, 64)
    assert burst.shape == (2, 64)
    jch = jtx.TxChain(jtx.TxConfig(mode="fm"))
    tp = ttx.params_from_numpy(jch.params, device="cpu")
    assert tp.fm.table_quant and tp.voice_lat is not None


def test_tx_entry_points_need_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttx.TxChain(ttx.TX_FLAGSHIP)
    assert ttx.TxChain(ttx.TX_FLAGSHIP, device="cpu").device.type == "cpu"
