"""The port's wide-SSB receiver and the live retune on the CPU against the
JAX package:

* K6/K7, the complex-tap decimating front: the port's wrapper (its plain
  torch version on CPU tensors) against the TPU kernels it replaces,
  `uhsdr_tpu.pallas.fir.fir_decimate_pallas` with complex taps
  (`_fir_kernel` without the NCO, `_fir_nco_kernel` with it), in
  interpret mode as tests/test_pallas_fir.py runs them: 8 channels, the
  wide-SSB flagship's 245-tap front at decimation 4, three streamed
  blocks of 2048 samples, int16 and f32 input, real, complex and
  two-plane output, at SNR >= 90 dB on output and raw carry (`-s`
  prints the values) and peaks equal to the input's;
* `RxChain` wide SSB at 48 kHz (4P0KHZ LPF with its PreFilter and
  anti-alias lattices; 10P0KHZ; 7P5KHZ as lsb), 96 kHz (5P0KHZ, with
  and without the translation, i.e. K7 and K6) and 192 kHz (5P0KHZ: 491
  taps at decimation 8) against the JAX chain
  over four streamed int16 blocks from zero state and through the
  hand-over in both directions, at 80 dB on audio and every state leaf
  (tests/test_torch_rx.py::run_streamed_both_ways);
* the live retune (`tune_offset_hz`): the NCO delta bit-equal to the JAX
  chain's in-graph one, and the narrow and wide SSB chains retuned
  mid-stream held to the JAX chain's at 80 dB.
The conformance row usb 10P0KHZ is in tests/test_torch_conformance.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_rx as common
from uhsdr_tpu.chain import rx as jrx
from uhsdr_tpu.ops import nco as jnco
from uhsdr_tpu.pallas import fir as pfir
from uhsdr_tpu_torch.chain import rx as trx
from uhsdr_tpu_torch.cuda import fir as fir_k
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.ops import nco as tnco

TOL_DB = 90.0
C, B, DECIM = 8, 2048, 4
PHASE0 = 2**32 - 5000
WIDE96 = dict(mode="usb", bw_key="5P0KHZ", path_name="LPF",
              iq_rate=96000.0)


@pytest.fixture(scope="module")
def wide_front():
    p = jrx.make_params(jrx.RxConfig(translate_hz=12000.0, block_len=B,
                                     **WIDE96))
    assert p.front2_re is None and np.any(p.front_fir_im)
    h = (np.asarray(p.front_fir_re) + 1j * np.asarray(p.front_fir_im)
         ).astype(np.complex64)
    assert h.shape == (245,)
    return h, int(p.nco_delta)


def _blocks(n, seed=18):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((2, C, B)) * 3277.0
        x[:, 0] *= 8.0                         # one channel near full scale
        out.append(np.clip(np.round(x), -32768, 32767).astype(np.int16))
    return out


def _complex(v):
    return (np.asarray(v[0]) + 1j * np.asarray(v[1])
            if isinstance(v, tuple) else np.asarray(v))


@pytest.mark.parametrize("dtype,use_nco,out", [
    ("int16", True, "real"), ("int16", True, "complex"),
    ("float32", True, "planes"), ("int16", False, "real"),
    ("float32", False, "complex"), ("float32", True, "real")])
def test_fir_cx_plain_matches_pallas(wide_front, dtype, use_nco, out):
    h_np, delta = wide_front
    taps = h_np.shape[-1]
    h = torch.from_numpy(h_np)
    cj = jnp.zeros((C, taps - 1), jnp.complex64)
    ct = torch.zeros((C, taps - 1), dtype=torch.complex64)
    ph_j = np.uint32(PHASE0)
    ph_t = torch.full((C,), PHASE0, dtype=torch.int64)
    real_out, planes_out = out == "real", out == "planes"
    vals = []
    for blk in _blocks(3):
        if dtype == "int16":
            xj = (jnp.asarray(blk[0]), jnp.asarray(blk[1]))
            xt = (torch.from_numpy(blk[0]), torch.from_numpy(blk[1]))
        else:
            f = blk.astype(np.float32) / np.float32(32768.0)
            xj = jax.lax.complex(jnp.asarray(f[0]), jnp.asarray(f[1]))
            xt = (torch.from_numpy(f[0]), torch.from_numpy(f[1]))
        kw = dict(nco=(jnp.uint32(ph_j), jnp.uint32(delta))) \
            if use_nco else {}
        yj, cj = pfir.fir_decimate_pallas(
            h_np, cj, xj, DECIM, tile_c=8, tile_t=128, real_out=real_out,
            planes_out=planes_out, interpret=True, **kw)
        cj = jnp.asarray(_complex(cj), jnp.complex64)
        yt, ct, pk = fir_k.fir_cx(
            h, ct, *xt, DECIM, nco=(ph_t, delta) if use_nco else None,
            real_out=real_out, planes_out=planes_out)
        if planes_out:
            yt = torch.complex(*yt)
        assert tuple(yt.shape) == (C, B // DECIM)
        assert yt.is_complex() != real_out
        vals.append((snr_db(_complex(yj), yt), snr_db(np.asarray(cj), ct)))
        assert min(vals[-1]) >= TOL_DB, vals
        scaled = blk.astype(np.float32) / np.float32(32768.0)
        np.testing.assert_array_equal(pk.numpy(),
                                      np.abs(scaled).max(axis=(0, 2)))
        if use_nco:
            ph_j = np.asarray(jnco.advance(jnp.asarray(ph_j),
                                           jnp.uint32(delta), B))
            ph_t = tnco.advance(ph_t, delta, B)
    print(f"\n{dtype} nco={use_nco} {out}: output "
          f"{min(v[0] for v in vals):.1f} dB, raw carry "
          f"{min(v[1] for v in vals):.1f} dB")


def test_fir_cx_short_block_streams_like_one_block():
    """Blocks shorter than the history keep the older history in the
    carry: streamed results equal one long block's."""
    rng = np.random.default_rng(19)
    taps, decim = 131, 4
    h = torch.from_numpy(((rng.standard_normal(taps) + 1j
                           * rng.standard_normal(taps)) * 0.05)
                         .astype(np.complex64))
    delta = int(tnco.freq_to_delta(-6000.0, 48000.0))
    x = [torch.from_numpy(np.clip(np.round(
        rng.standard_normal((C, 1024)) * 3277.0), -32768, 32767)
        .astype(np.int16)) for _ in "iq"]
    ph0 = torch.from_numpy(rng.integers(0, 2**32, C))
    c0 = torch.zeros((C, taps - 1), dtype=torch.complex64)
    y_all, c_all, _ = fir_k.fir_cx(h, c0, *x, decim, nco=(ph0, delta))
    ys, c, ph = [], c0, ph0
    for lo, hi in ((0, 40), (40, 64), (64, 1024)):
        y, c, _ = fir_k.fir_cx(h, c, x[0][:, lo:hi].contiguous(),
                               x[1][:, lo:hi].contiguous(), decim,
                               nco=(ph, delta))
        ph = tnco.advance(ph, delta, hi - lo)
        ys.append(y)
    assert snr_db(y_all, torch.cat(ys, -1)) >= 120.0
    assert torch.equal(c, c_all)


def test_wide_params_match_jax():
    for kw, taps, decim in ((WIDE96, 245, 4),
                            (dict(mode="usb", bw_key="4P0KHZ"), 131, 4),
                            (dict(mode="lsb", bw_key="10P0KHZ"), 92, 2)):
        jp = jrx.make_params(jrx.RxConfig(**kw))
        tp = trx.make_params(trx.RxConfig(**kw), device="cpu")
        for name, a, b in zip(tp._fields, tp,
                              trx.params_from_numpy(jp, device="cpu")):
            assert common._same(a, b), (kw, name)
        assert tp.front_fir.dtype == torch.complex64 and tp.front2 is None
        assert tp.front_fir.shape == (taps,)
        assert trx.RxConfig(**kw).decim == decim


def ssb_capture(n_blocks, iq_rate, seed=41, translate=12000.0, sign=1.0):
    """int16 IQ blocks for the wide-SSB chains: per channel a tone
    (700 + 450 c) Hz above (usb) or below (lsb) the translate frequency at
    -6 ... -46 dBFS, plus noise of 30 counts rms."""
    rng = np.random.default_rng(seed)
    B_, C_ = common.AM_B, common.C
    n = np.arange(n_blocks * B_)
    c = np.arange(C_)[:, None]
    f = translate + sign * (700.0 + 450.0 * c)
    amp = 32767.0 * 10.0 ** (-np.linspace(6, 46, C_) / 20.0)[:, None]
    z = amp * np.exp(2j * np.pi * f * n / iq_rate) + (
        rng.standard_normal((C_, n.size))
        + 1j * rng.standard_normal((C_, n.size))) * 30.0
    i16 = np.clip(np.round(z.real), -32768, 32767).astype(np.int16)
    q16 = np.clip(np.round(z.imag), -32768, 32767).astype(np.int16)
    return [(i16[:, k * B_:(k + 1) * B_], q16[:, k * B_:(k + 1) * B_])
            for k in range(n_blocks)]


@pytest.mark.parametrize("kw", [
    dict(mode="usb", bw_key="4P0KHZ", iq_rate=48000.0),
    dict(mode="usb", bw_key="10P0KHZ", iq_rate=48000.0),
    dict(mode="lsb", bw_key="7P5KHZ", iq_rate=48000.0),
    WIDE96, dict(WIDE96, translate_hz=0.0),
    dict(WIDE96, iq_rate=192000.0)],
    ids=["usb-4P0KHZ-48k", "usb-10P0KHZ-48k", "lsb-7P5KHZ-48k",
         "usb-5P0KHZ-96k", "usb-5P0KHZ-96k-untranslated",
         "usb-5P0KHZ-192k"])
def test_wide_chain_matches_jax_streamed(kw):
    translate = kw.get("translate_hz", 12000.0)
    sign = -1.0 if kw["mode"] == "lsb" else 1.0

    def capture(n_blocks, iq_rate):
        return ssb_capture(n_blocks, iq_rate, translate=translate, sign=sign)
    common.run_streamed_both_ways(kw, common.CHAIN_DB, capture=capture)


@pytest.mark.parametrize("offset", [0.0, 1.5, -250.25, 1234.567, 23999.9,
                                    -47999.0, 3e-6])
def test_tune_offset_delta_is_bit_equal(offset):
    for fs in (48000.0, 96000.0):
        want = int(jrx._tune_offset_delta(jnp.float32(offset), fs))
        assert trx._tune_offset_delta(offset, fs) == want, (offset, fs)


@pytest.mark.parametrize("kw", [common.FLAGSHIP,
                                dict(WIDE96, translate_hz=12000.0,
                                     block_len=common.AM_B)],
                         ids=["narrow-96k", "wide-96k"])
def test_retune_mid_stream_matches_jax(kw):
    """Four blocks with the dial moved between them (no offset, +350 Hz
    twice, -1234.5 Hz), the NCO phase carried through the changes."""
    jcfg = jrx.RxConfig(**kw)
    jp = jrx.make_params(jcfg)
    plain = jax.jit(lambda s, i, q: jrx.process_block(jcfg, jp, s, (i, q)))
    tuned = jax.jit(lambda s, i, q, t: jrx.process_block(
        jcfg, jp, s, (i, q), tune_offset_hz=t))
    chain = trx.RxChain(trx.RxConfig(**kw), device="cpu")
    js = jrx.init_state(jcfg, jp, (common.C,))
    ts = chain.init_state((common.C,))
    blocks = ssb_capture(4, jcfg.iq_rate) if kw is not common.FLAGSHIP \
        else common._capture(4)
    for blk, off in zip(blocks, (None, 350.0, 350.0, -1234.5)):
        i, q = (jnp.asarray(v) for v in blk)
        if off is None:
            yj, js, _ = plain(js, i, q)
        else:
            yj, js, _ = tuned(js, i, q, jnp.float32(off))
        yt, ts, _ = chain(ts, i=blk[0], q=blk[1], tune_offset_hz=off)
        s = snr_db(np.asarray(yj), yt)
        print(f"\n{kw['bw_key']} offset {off}: audio {s:.1f} dB")
        assert s >= common.CHAIN_DB
        common._assert_state_close(js, ts, common.CHAIN_DB)
