"""The port's RX chains (`uhsdr_tpu_torch.chain.rx`) on the CPU, where its
wrappers run the kernels' plain torch versions:

* the flagship SSB chain against the JAX package's `rx.process_block` on
  the CPU (usb 2P3KHZ LPF, 12 kHz translate, int16 IQ @ 96 kHz) cut to
  8 channels x 4096 samples, over four streamed blocks: audio, ADC peak
  and every state leaf at SNR >= 80 dB;
* a stream handed from the JAX chain to the port mid-sequence through
  `state_from_numpy`, again at 80 dB;
* the AM chains (fade leveler on and off, 48 and 96 kHz, with and without
  the anti-alias lattice) the same way in 2048-sample blocks, with the
  hand-over in both directions; the SAM, FM and wide-SSB chains are in
  tests/test_torch_rx_sam*.py, test_torch_fm.py and test_torch_wide.py,
  which use this module's helpers;
* against the float64 oracle `tests/golden/ref_chain.py` (usb 2P3KHZ
  select 2 @ 48 kHz, as tests/test_conformance_ref.py runs the JAX chain,
  whose CPU rows sit at 79.6-112.6 dB) at the conformance bound, 50 dB
  (the am and sam rows are in tests/test_torch_conformance.py);
* import hygiene: the port and chip_smoke.py import neither jax nor the
  JAX package;
* entry points default to CUDA and raise where it is absent; an unfused
  stage B runs K6's plain version on complex IQ; the configurations
  that were outside the port before the legacy front and FM TX were
  ported run and match the JAX chain from its state;
* `RxConfig` has the JAX package's fields with its defaults, and the
  backend selectors and ``cw_offset_hz`` change nothing.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_conformance_ref as conf
from tests.golden import ref_chain as gold
from uhsdr_tpu.chain import rx as jrx
from uhsdr_tpu_torch.chain import rx as trx
from uhsdr_tpu_torch.cuda import fir as fir_k
from uhsdr_tpu_torch.metrics import snr_db

CHAIN_DB = 80.0
CONFORMANCE_DB = 50.0
FLAGSHIP = dict(mode="usb", bw_key="2P3KHZ", path_name="LPF",
                translate_hz=12000.0, iq_rate=96000.0, block_len=4096)
C, B, N_BLOCKS = 8, 4096, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _capture(n_blocks, seed=11):
    """int16 IQ blocks: per channel a USB tone 700 + 150 c Hz above the
    12 kHz translate at -6 ... -46 dBFS, plus noise."""
    rng = np.random.default_rng(seed)
    n = np.arange(n_blocks * B)
    f = 12000.0 + 700.0 + 150.0 * np.arange(C)[:, None]
    amp = 32767.0 * 10.0 ** (-np.linspace(6, 46, C) / 20.0)[:, None]
    z = amp * np.exp(2j * np.pi * f * n / 96000.0) + (
        rng.standard_normal((C, n.size))
        + 1j * rng.standard_normal((C, n.size))) * 30.0
    i16 = np.clip(np.round(z.real), -32768, 32767).astype(np.int16)
    q16 = np.clip(np.round(z.imag), -32768, 32767).astype(np.int16)
    return [(i16[:, k * B:(k + 1) * B], q16[:, k * B:(k + 1) * B])
            for k in range(n_blocks)]


@pytest.fixture(scope="module")
def jax_chain():
    cfg = jrx.RxConfig(**FLAGSHIP)
    params = jrx.make_params(cfg)
    step = jax.jit(lambda s, i, q: jrx.process_block(cfg, params, s, (i, q)))
    return cfg, params, step


def _run_jax(step, state, blk):
    y, state, taps = step(state, jnp.asarray(blk[0]), jnp.asarray(blk[1]))
    return np.asarray(y), state, taps


def spectrum_iq(taps) -> np.ndarray:
    """The port's ``spectrum_iq`` tap, (i, q) planes (int16 meaning
    counts / 32768), as the JAX chain's complex tap."""
    i, q = (p.to(torch.float32) * (1.0 / 32768.0 if p.dtype == torch.int16
                                   else 1.0) for p in taps["spectrum_iq"])
    return torch.complex(i, q).numpy()


def assert_taps_match(tj, tt):
    """The port's chain taps the JAX chain's names, and its
    ``spectrum_iq`` (chain/rx.py:666 of the JAX package: the IQ after the
    correction, before the translation, in every mode) holds the same
    values (bit-equal but for the IQ auto-correction's, held to the
    chain's bound)."""
    assert set(tt) == set(tj), (sorted(tt), sorted(tj))
    assert snr_db(np.asarray(tj["spectrum_iq"]), spectrum_iq(tt)) >= \
        CHAIN_DB


def _leaf(state, dotted: str):
    for part in dotted.split("."):
        state = getattr(state, part)
    return state


def state_snrs(jstate, tstate, cfg=None) -> dict:
    """{leaf: SNR in dB} of the port's state against the JAX chain's, over
    every leaf `state_to_numpy` gives (with `cfg`, in the reference's
    layout of the two-channel modes).  The PLL phase is compared through
    its cosine and sine (a wrap at 2 pi is not an error); the NCO phase
    must be equal; boolean and integer leaves (the FM squelch and tone
    detector's) read inf where equal and -inf where not."""
    out = {}
    for f, v in trx.state_to_numpy(tstate, cfg).items():
        ref = np.asarray(_leaf(jstate, f))
        assert v.shape == ref.shape, f
        if f == "nco_phase":
            np.testing.assert_array_equal(v, ref)
        elif v.dtype == bool or v.dtype.kind in "iu":
            out[f] = np.inf if np.array_equal(v, ref) else -np.inf
        elif f == "sam.phs":
            out[f] = snr_db(np.stack([np.cos(ref), np.sin(ref)]),
                            np.stack([np.cos(v), np.sin(v)]))
        else:
            out[f] = snr_db(ref, v)
    return out


def _assert_state_close(jstate, tstate, db, cfg=None):
    for f, s in state_snrs(jstate, tstate, cfg).items():
        assert s >= db, (f, s)


def to_jax_state(template, tstate, cfg=None):
    """The port's RxState as the JAX package's: `template` (a JAX RxState
    of the same config) with every leaf the port carries replaced."""
    def put(node, parts, value):
        if len(parts) == 1:
            return node._replace(**{parts[0]: value})
        return node._replace(**{parts[0]: put(getattr(node, parts[0]),
                                              parts[1:], value)})

    for f, v in trx.state_to_numpy(tstate, cfg).items():
        template = put(template, f.split("."), jnp.asarray(v))
    return template


def _same(a, b) -> bool:
    """Equality of two params leaves: tensors, scalars, or (named) tuples
    of them."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return bool(np.all(np.asarray(a) == np.asarray(b)))


def test_port_params_match_jax(jax_chain):
    """The port's own NumPy design copy gives the JAX package's tables."""
    _, jp, _ = jax_chain
    tp = trx.make_params(trx.RxConfig(**FLAGSHIP), device="cpu")
    fp = trx.params_from_numpy(jp, device="cpu")
    for name, a, b in zip(tp._fields, tp, fp):
        assert _same(a, b), name
    assert (tp.front_fir.shape[-1], tp.front2.shape[-1],
            tp.interp_fir.shape[-1], tp.audio_sos.sections) == (227, 199,
                                                                93, 5)
    assert tp.nco_delta == 3758096384 and tp.agc.attack_buffsize == 48
    assert tp.eq1_sos.sections == tp.eq2_sos.sections == 0
    assert tp.aa_sos.sections == 0


def test_chain_matches_jax_streamed(jax_chain):
    jcfg, jp, step = jax_chain
    tcfg = trx.RxConfig(**FLAGSHIP)
    tp = trx.params_from_numpy(jp, device="cpu")
    js = jrx.init_state(jcfg, jp, (C,))
    ts = trx.init_state(tcfg, tp, (C,))
    for blk in _capture(N_BLOCKS):
        yj, js, tj = _run_jax(step, js, blk)
        yt, ts, tt = trx.process_block(
            tcfg, tp, ts, (torch.from_numpy(blk[0]),
                           torch.from_numpy(blk[1])))
        assert tuple(yt.shape) == (C, B)
        print(f"\naudio vs JAX: {snr_db(yj, yt):.1f} dB")
        assert snr_db(yj, yt) >= CHAIN_DB
        np.testing.assert_array_equal(tt["adc_peak"].numpy(),
                                      np.asarray(tj["adc_peak"]))
        np.testing.assert_array_equal(tt["adc_clip"].numpy(),
                                      np.asarray(tj["adc_clip"]))
        assert snr_db(np.asarray(tj["audio_dec"]), tt["audio_dec"]) >= \
            CHAIN_DB
        assert_taps_match(tj, tt)
        np.testing.assert_array_equal(spectrum_iq(tt),
                                      np.asarray(tj["spectrum_iq"]))
        _assert_state_close(js, ts, CHAIN_DB)


def test_handoff_from_jax_mid_stream(jax_chain):
    """JAX runs the first two blocks; its state, as NumPy leaves, goes to
    the port, which runs the rest; the JAX chain runs on for reference."""
    jcfg, jp, step = jax_chain
    tcfg = trx.RxConfig(**FLAGSHIP)
    tp = trx.params_from_numpy(jp, device="cpu")
    js = jrx.init_state(jcfg, jp, (C,))
    blocks = _capture(N_BLOCKS, seed=12)
    for blk in blocks[:2]:
        _, js, _ = _run_jax(step, js, blk)
    ts = trx.state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                              device="cpu")
    _assert_state_close(js, ts, np.inf)
    for blk in blocks[2:]:
        yj, js, _ = _run_jax(step, js, blk)
        yt, ts, _ = trx.process_block(
            tcfg, tp, ts, (torch.from_numpy(blk[0]),
                           torch.from_numpy(blk[1])))
        assert snr_db(yj, yt) >= CHAIN_DB
    _assert_state_close(js, ts, CHAIN_DB)


def test_conformance_vs_float64_oracle():
    iq = conf.make_iq("usb")
    ref, _ = gold.ref_rx_chain(iq, "usb", "2P3KHZ", select_id=2)
    chain = trx.RxChain(trx.RxConfig(mode="usb", bw_key="2P3KHZ",
                                     ref_select_id=2, block_len=4096),
                        device="cpu")
    state = chain.init_state((1,))
    outs = []
    for s in range(0, len(iq), 4096):
        audio, state, _ = chain(state, iq=iq[s:s + 4096][None])
        outs.append(audio[0].numpy())
    s_db = conf.snr_db(ref, np.concatenate(outs))
    print(f"\nusb 2P3KHZ vs the float64 oracle: {s_db:.1f} dB")
    assert s_db >= CONFORMANCE_DB, s_db


# ---------------------------------------------------------------------------
# AM and SAM chains
# ---------------------------------------------------------------------------

AM_B = 2048          # IQ-rate samples per block in the AM/SAM chain tests


def am_capture(n_blocks, iq_rate, seed=21, translate=12000.0):
    """int16 IQ blocks for the AM/SAM chains: per channel a carrier
    3 c Hz above the translate frequency at -6 ... -40 dBFS (starting
    phase 1 rad, clear of the phase detector's branch cut at pi), 50% AM
    by a (400 + 50 c) Hz tone, plus noise of 30 counts rms."""
    rng = np.random.default_rng(seed)
    n = np.arange(n_blocks * AM_B)
    c = np.arange(C)[:, None]
    amp = 0.6 * 32767.0 * 10.0 ** (-np.linspace(6, 40, C) / 20.0)[:, None]
    z = (amp * (1 + 0.5 * np.sin(2 * np.pi * (400 + 50 * c) * n / iq_rate))
         * np.exp(1j + 2j * np.pi * (translate + 3 * c) * n / iq_rate)
         + (rng.standard_normal((C, n.size))
            + 1j * rng.standard_normal((C, n.size))) * 30.0)
    i16 = np.clip(np.round(z.real), -32768, 32767).astype(np.int16)
    q16 = np.clip(np.round(z.imag), -32768, 32767).astype(np.int16)
    return [(i16[:, k * AM_B:(k + 1) * AM_B], q16[:, k * AM_B:(k + 1) * AM_B])
            for k in range(n_blocks)]


def _run_port(tcfg, tp, ts, blk):
    return trx.process_block(tcfg, tp, ts, (torch.from_numpy(blk[0]),
                                            torch.from_numpy(blk[1])))


def run_streamed_both_ways(kw, zero_db, handover_db=CHAIN_DB, capture=None,
                           last_audio_db=None):
    """Four int16 blocks through the JAX chain and the port, both from
    zero state: audio and every state leaf held to `zero_db` after every
    block (and the last block's audio to `last_audio_db` where given).
    After block 2 the stream is also handed over in both directions (JAX
    state -> port through `state_from_numpy`, the port's state -> JAX
    through `state_to_numpy`), and blocks 3-4 of each handed-over stream
    are held to `handover_db` against the chain the state came from.
    `capture(n_blocks, iq_rate)` makes the blocks (default `am_capture`).
    Returns the printed numbers."""
    kw = {"translate_hz": 12000.0, "block_len": AM_B, **kw}
    jcfg = jrx.RxConfig(**kw)
    jp = jrx.make_params(jcfg)
    step = jax.jit(lambda s, i, q: jrx.process_block(jcfg, jp, s, (i, q)))
    tcfg = trx.RxConfig(**kw)
    tp = trx.make_params(tcfg, device="cpu")
    for name, a, b in zip(tp._fields, tp,
                          trx.params_from_numpy(jp, device="cpu", cfg=tcfg)):
        assert _same(a, b), name
    blocks = (capture or am_capture)(N_BLOCKS, jcfg.iq_rate)
    out_len = AM_B // tcfg.front_decim if tcfg.mode == "fm" else AM_B
    out_shape = (C,) + ((2,) if tcfg.n_audio > 1 else ()) + (out_len,)
    js = jrx.init_state(jcfg, jp, (C,))
    ts = trx.init_state(tcfg, tp, (C,))
    audio_db, mid = [], None
    yjs, yts = [], []
    for k, blk in enumerate(blocks):
        yj, js, tj = _run_jax(step, js, blk)
        yt, ts, tt = _run_port(tcfg, tp, ts, blk)
        assert tuple(yt.shape) == out_shape
        assert_taps_match(tj, tt)
        assert ("adc_peak" in tt) == ("adc_peak" in tj)
        if "adc_peak" in tt:
            np.testing.assert_array_equal(tt["adc_peak"].numpy(),
                                          np.asarray(tj["adc_peak"]))
        yjs.append(yj)
        yts.append(yt)
        audio_db.append(snr_db(yj, yt))
        leaves = state_snrs(js, ts, tcfg)
        worst = min(leaves, key=leaves.get)
        print(f"\n{kw['mode']} block {k}: audio {audio_db[-1]:.1f} dB, "
              f"worst state leaf {worst} {leaves[worst]:.1f} dB")
        assert audio_db[-1] >= zero_db, (k, audio_db[-1])
        assert leaves[worst] >= zero_db, (k, worst, leaves[worst])
        if k == 1:
            mid = (js, ts)
    if last_audio_db is not None:
        assert audio_db[-1] >= last_audio_db, audio_db
    js_mid, ts_mid = mid
    # JAX -> port
    ts2 = trx.state_from_numpy(jax.tree_util.tree_map(np.asarray, js_mid),
                               device="cpu", cfg=tcfg)
    _assert_state_close(js_mid, ts2, np.inf, tcfg)
    # port -> JAX
    js2 = to_jax_state(js_mid, ts_mid, tcfg)
    _assert_state_close(js2, ts_mid, np.inf, tcfg)
    hand = []
    for k in (2, 3):
        yt2, ts2, _ = _run_port(tcfg, tp, ts2, blocks[k])
        yj2, js2, _ = _run_jax(step, js2, blocks[k])
        hand.append((snr_db(yjs[k], yt2), snr_db(yts[k], yj2)))
        print(f"  block {k} after hand-over: JAX->port {hand[-1][0]:.1f} dB, "
              f"port->JAX {hand[-1][1]:.1f} dB")
        assert min(hand[-1]) >= handover_db, (k, hand[-1])
    _assert_state_close(js, ts2, handover_db, tcfg)
    _assert_state_close(js2, ts, handover_db, tcfg)
    return audio_db, hand


@pytest.mark.parametrize("fade,iq_rate,bw", [
    (True, 96000.0, "5P0KHZ"), (False, 96000.0, "2P5KHZ"),
    (True, 48000.0, "3P6KHZ"), (False, 48000.0, "5P0KHZ")])
def test_am_chain_matches_jax_streamed(fade, iq_rate, bw):
    """AM at 96 kHz (decimation 4 with AGC look-ahead 96, and 8) and at
    48 kHz (a row with the anti-alias lattice, and a decimation-2 row
    with look-ahead 96 and a x2 interpolator)."""
    run_streamed_both_ways(dict(mode="am", bw_key=bw, iq_rate=iq_rate,
                                fade_leveler=fade), CHAIN_DB)


def test_antialias_rows_raise_above_48k():
    """Rows with a post anti-alias lattice are 48 kHz only, in both
    packages."""
    kw = dict(mode="am", bw_key="3P6KHZ", iq_rate=96000.0)
    with pytest.raises(ValueError, match="48k-rate only"):
        jrx.make_params(jrx.RxConfig(**kw))
    with pytest.raises(ValueError, match="48k-rate only"):
        trx.make_params(trx.RxConfig(**kw), device="cpu")


def test_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import uhsdr_tpu_torch\n"
        "for m in pkgutil.walk_packages(uhsdr_tpu_torch.__path__,\n"
        "                               'uhsdr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'uhsdr_tpu' or m.startswith('uhsdr_tpu.'))\n"
        "n = sum(m.startswith('uhsdr_tpu_torch.') for m in sys.modules)\n"
        "new = {'uhsdr_tpu_torch.demod.fm', 'uhsdr_tpu_torch.cuda.elemwise',\n"
        "       'uhsdr_tpu_torch.cuda.fir', 'uhsdr_tpu_torch.trace_rx',\n"
        "       'uhsdr_tpu_torch.mod.alc', 'uhsdr_tpu_torch.mod.modulators',\n"
        "       'uhsdr_tpu_torch.chain.tx', 'uhsdr_tpu_torch.cuda.alc',\n"
        "       'uhsdr_tpu_torch.cuda.agc', 'uhsdr_tpu_torch.trace_tx',\n"
        "       'uhsdr_tpu_torch.parallel.fleet',\n"
        "       'uhsdr_tpu_torch.ops.channelizer',\n"
        "       'uhsdr_tpu_torch.ops.fftutil',\n"
        "       'uhsdr_tpu_torch.chain.refchain',\n"
        "       'uhsdr_tpu_torch.chain.output',\n"
        "       'uhsdr_tpu_torch.cuda.lattice',\n"
        "       'uhsdr_tpu_torch.cuda.fm_mod',\n"
        "       'uhsdr_tpu_torch.ops.lattice',\n"
        "       'uhsdr_tpu_torch.modems.cw', 'uhsdr_tpu_torch.modems.psk',\n"
        "       'uhsdr_tpu_torch.modems.rtty', 'uhsdr_tpu_torch.modems.tap',\n"
        "       'uhsdr_tpu_torch.modems.cw_text',\n"
        "       'uhsdr_tpu_torch.modems.psk_text',\n"
        "       'uhsdr_tpu_torch.modems.rtty_text',\n"
        "       'uhsdr_tpu_torch.modems.keyer',\n"
        "       'uhsdr_tpu_torch.modems._varicode_table',\n"
        "       'uhsdr_tpu_torch.spectrum.scope',\n"
        "       'uhsdr_tpu_torch.core.stream', 'uhsdr_tpu_torch.ops.goertzel',\n"
        "       'uhsdr_tpu_torch.ops.softdds', 'uhsdr_tpu_torch.ops.steps',\n"
        "       'uhsdr_tpu_torch.cuda.cw', 'uhsdr_tpu_torch.cuda.psk',\n"
        "       'uhsdr_tpu_torch.cuda.rtty',\n"
        "       'uhsdr_tpu_torch.modems.freedv',\n"
        "       'uhsdr_tpu_torch.modems.fdmdv_batch',\n"
        "       'uhsdr_tpu_torch.modems.fdmdv', 'uhsdr_tpu_torch.modems.ofdm',\n"
        "       'uhsdr_tpu_torch.modems.golay', 'uhsdr_tpu_torch.modems.ldpc',\n"
        "       'uhsdr_tpu_torch.modems.vocoder',\n"
        "       'uhsdr_tpu_torch.modems.codec2_1300',\n"
        "       'uhsdr_tpu_torch.modems.codec2_700c',\n"
        "       'uhsdr_tpu_torch.modems.codec2_1300_batch',\n"
        "       'uhsdr_tpu_torch.modems.codec2_700c_batch',\n"
        "       'uhsdr_tpu_torch.cli', 'uhsdr_tpu_torch.control.server',\n"
        "       'uhsdr_tpu_torch.control.cat', 'uhsdr_tpu_torch.control.radio',\n"
        "       'uhsdr_tpu_torch.control.meter', 'uhsdr_tpu_torch.control.osc',\n"
        "       'uhsdr_tpu_torch.control.calibration',\n"
        "       'uhsdr_tpu_torch.control.selftest',\n"
        "       'uhsdr_tpu_torch.core.config', 'uhsdr_tpu_torch.io.ingest',\n"
        "       'uhsdr_tpu_torch.utils.profiling',\n"
        "       'uhsdr_tpu_torch.parallel.mesh',\n"
        "       'uhsdr_tpu_torch.parallel.rx_sharded',\n"
        "       'uhsdr_tpu_torch.parallel.tx_sharded',\n"
        "       'uhsdr_tpu_torch.parallel.wideband_sharded',\n"
        "       'uhsdr_tpu_torch.parallel.multihost'}\n"
        "print(n, bad, sorted(new - set(sys.modules)))\n"
        "sys.exit(1 if bad or n < 30 or new - set(sys.modules) else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_need_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = trx.RxConfig(**FLAGSHIP)
    with pytest.raises(RuntimeError, match="CUDA"):
        trx.RxChain(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        trx.make_params(cfg)
    assert trx.RxChain(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw", [
    dict(tx_mode="fm"),
    dict(mode="fm", notch_enable=True, front="scipy"),
    dict(mode="ssbstereo", front="scipy"),
    dict(mode="ssbstereo", bw_key="5P0KHZ"),
    dict(nr_enable=True, front="scipy"),
    dict(nb_enable=True, front="scipy"),
    dict(notch_enable=True, mode="iq", bw_key="10P0KHZ"),
    dict(leaky_nr_enable=True, mode="iq", bw_key="10P0KHZ"),
    dict(iq_auto_correction=True, front="scipy"),
    dict(mode="iq", bw_key="10P0KHZ"), dict(front="scipy"),
    dict(nr_enable=True, nr_strength=100, front="scipy"),
    dict(nb_enable=True, nb_setting=3, mode="ssbstereo", bw_key="5P0KHZ"),
    dict(notch_enable=True, leaky_notch=True, front="scipy"),
    dict(nr_enable=True, nr_prec_escalate=False, mode="iq",
         bw_key="10P0KHZ"),
    dict(front="scipy", high_taps=False)])
def test_former_roadmap_configs_run(kw):
    """What was outside the port until the legacy front and FM TX were
    ported: the legacy front with or without an RX option, the
    two-channel modes on the wide rows (which the reference runs on that
    front) and FM TX.  Each builds on the CPU and runs a block from zero
    state (finite), and a block from the JAX chain's state after that
    one, held to the JAX chain at 80 dB on the output and every state
    leaf (on the flagship's capture and row, but FM on its own capture
    (tests/test_torch_fm.py) and 5P0KHZ row and iq on the row's first
    path: the row has no FM path and no iq "LPF" sub-path, in either
    package).  The hand-over start: the legacy FM front at 96
    kHz parts from
    the JAX CPU chain's FFT front at zero state (ROADMAP queue C).  FM
    TX: its modulator input and state leaves at 80 dB; its IQ at queue
    C's 50 dB (its accumulator integrates the last bits of its input,
    tests/test_torch_fm_tx.py)."""
    if "tx_mode" in kw:
        from tests import test_torch_tx as ttt
        from uhsdr_tpu.chain import tx as jtx
        from uhsdr_tpu_torch.chain import tx as ttx
        jcfg = jtx.TxConfig(mode=kw["tx_mode"], block_len=B)
        tcfg = ttx.TxConfig(mode=kw["tx_mode"], block_len=B)
        jp = jtx.make_params(jcfg)
        tp = ttx.params_from_numpy(jp, device="cpu")
        blk = np.concatenate(ttt._blocks("fm"), axis=-1)[:, :B]
        iqj, js, tj = jtx.process_block(jcfg, jp, jtx.init_state(
            jcfg, jp, blk.shape[:1]), jnp.asarray(blk))
        iqt, ts, tt = ttx.process_block(
            tcfg, tp, ttx.init_state(tcfg, tp, blk.shape[:1]),
            torch.from_numpy(blk))
        assert bool(torch.isfinite(torch.view_as_real(iqt)).all())
        assert snr_db(np.asarray(tj["processed"]), tt["processed"]) >= \
            CHAIN_DB
        assert snr_db(np.asarray(iqj), iqt) >= 50.0
        for f in ("alc.alc_val", "alc.delay_buf", "mod.hpf_a"):
            assert snr_db(np.asarray(_leaf(js, f)),
                          ttx.state_to_numpy(ts)[f]) >= CHAIN_DB, f
        return
    kw = {**FLAGSHIP, **kw}
    # the flagship's row has no FM path and no iq "LPF" sub-path: FM takes
    # its 5P0KHZ row, iq the row's first path (in both packages)
    if kw["mode"] == "fm":
        kw.update(bw_key="5P0KHZ", path_name=None)
    elif kw["mode"] == "iq":
        kw.update(path_name=None)
    tcfg, jcfg = trx.RxConfig(**kw), jrx.RxConfig(**kw)
    assert not tcfg.use_ref_front and not jcfg.use_ref_front
    chain = trx.RxChain(tcfg, device="cpu")
    jp = jrx.make_params(jcfg)
    step = jax.jit(lambda s, i, q: jrx.process_block(jcfg, jp, s, (i, q)))
    if kw["mode"] == "fm":
        from tests.test_torch_fm import fm_capture
        blocks = fm_capture(2, kw["iq_rate"])
    else:
        blocks = _capture(2)
    y0, _, _ = chain(chain.init_state((C,)), i=blocks[0][0],
                     q=blocks[0][1])
    assert bool(torch.isfinite(y0).all())
    _, js, _ = _run_jax(step, jrx.init_state(jcfg, jp, (C,)), blocks[0])
    ts = trx.state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                              device="cpu", cfg=tcfg)
    yj, js, _ = _run_jax(step, js, blocks[1])
    yt, ts, _ = chain(ts, i=blocks[1][0], q=blocks[1][1])
    n = blocks[1][0].shape[-1]
    out_len = n // tcfg.front_decim if tcfg.mode == "fm" else n
    assert tuple(yt.shape) == (C,) + ((2,) if tcfg.n_audio > 1 else ()) + (
        out_len,)
    s = snr_db(yj, yt)
    leaves = state_snrs(js, ts, tcfg)
    low = min(leaves, key=leaves.get)
    print(f"\n{kw}: audio {s:.1f} dB, worst leaf {low} {leaves[low]:.1f} dB")
    assert s >= CHAIN_DB and leaves[low] >= CHAIN_DB, (s, low, leaves[low])


def test_unfused_stage_b_raises():
    """K1 fuses stage B at every NCO delta, so the chain's stage B passes
    real audio through.  Complex decimated IQ (the sharded front's stage-A
    output) runs the unfused stage B, K6's plain version at decimation 1
    with real output (tests/test_torch_sharded.py holds it to the JAX
    stage B); only the two-channel modes' filter pair, which K1 alone
    runs, raises."""
    cfg = trx.RxConfig(**FLAGSHIP)
    p = trx.make_params(cfg, device="cpu")
    s = trx.init_state(cfg, p, (2,))
    audio = torch.ones((2, 16))
    out, s2 = trx.stage_b(cfg, p, s, audio)
    assert out is audio and s2 is s
    z = torch.ones((2, 16), dtype=torch.complex64)
    y, s2 = trx.stage_b(cfg, p, s, z)
    want, carry, _ = fir_k.fir_cx_plain(p.front2, s.front2_carry, z.real,
                                        z.imag, 1, real_out=True)
    assert torch.equal(y, want) and torch.equal(s2.front2_carry, carry)
    pcfg = trx.RxConfig(**dict(FLAGSHIP, mode="ssbstereo"))
    pp = trx.make_params(pcfg, device="cpu")
    with pytest.raises(ValueError, match="pair"):
        trx.stage_b(pcfg, pp, trx.init_state(pcfg, pp, (2,)), z)


def test_rx_config_fields_match_jax():
    """The port's RxConfig names every field of the JAX package's, with
    equal defaults (the tone settings compared field by field)."""
    def fields(cls):
        out = {}
        for f in dataclasses.fields(cls):
            v = f.default
            out[f.name] = dataclasses.asdict(v) if dataclasses.is_dataclass(
                v) else v
        return out

    assert fields(trx.RxConfig) == fields(jrx.RxConfig)


def test_parity_fields_change_nothing():
    """cw_offset_hz (read by no chain code), the backend selectors and the
    settings of options that are off build the same chain."""
    base = trx.RxConfig(**FLAGSHIP)
    p0 = trx.make_params(base, device="cpu")
    for kw in (dict(cw_offset_hz=500.0), dict(front_impl="pallas"),
               dict(iir_impl="scan"), dict(nr_strength=100),
               dict(nb_setting=3), dict(leaky_notch=True),
               dict(high_taps=False), dict(nr_prec_escalate=False)):
        p = trx.make_params(dataclasses.replace(base, **kw), device="cpu")
        for name, a, b in zip(p._fields, p, p0):
            assert _same(a, b), (kw, name)
