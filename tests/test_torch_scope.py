"""The port's spectrum scope, Goertzel projection and stream runner
against the JAX package's on the CPU, the chain's ``spectrum_iq`` tap in
every mode row, and the NCO ramp's scalar form.

Tolerances and why:
* scope: the spectrum and the averaged magnitudes >= 100 dB (the FFTs
  are two libraries'; the zoom decimator's plain version sums its taps
  in another order than the JAX package's FIR), dBm within 1e-3 dB, SNAP
  within 0.01 Hz; the tail and the zoom carry equal (copies of the
  input) or >= 100 dB (the zoom's output);
* Goertzel: >= 100 dB (sums in another order), the phase equal;
* the waterfall row within 1e-4 of a palette step and the S units within
  1e-5 (log10 and the divisions of two libraries);
* the stream runner bit-equal to the port's chain called block by
  block, and >= 80 dB against the JAX package's runner (the chain's
  bound, tests/test_torch_rx.py);
* `phase_ramp` with a scalar delta bit-equal to its former form, which
  made the delta a device tensor.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uhsdr_tpu.chain import rx as jrx
from uhsdr_tpu.core import stream as jstream
from uhsdr_tpu.ops import goertzel as jgoertzel
from uhsdr_tpu.ops import nco as jnco
from uhsdr_tpu.spectrum import scope as jscope
from uhsdr_tpu_torch.chain import rx as trx
from uhsdr_tpu_torch.core import stream
from uhsdr_tpu_torch.cuda import fir as fir_k
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.ops import goertzel, nco
from uhsdr_tpu_torch.spectrum import scope

C = 3


def _iq16(rng, blk: int, T: int, fs: float = 48000.0, f0: float = 6000.0):
    """int16 planes: a carrier per channel 700 + 50 c Hz above f0, plus
    noise."""
    n = np.arange(blk * T, (blk + 1) * T)
    f = f0 + 700.0 + 50.0 * np.arange(C)[:, None]
    z = 0.3 * np.exp(2j * np.pi * f / fs * n) + 0.01 * (
        rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T)))
    i = np.clip(np.round(z.real * 32768), -32768, 32767).astype(np.int16)
    q = np.clip(np.round(z.imag * 32768), -32768, 32767).astype(np.int16)
    return i, q


@pytest.mark.parametrize("magnify,planes,lengths", [
    (0, True, (2048, 2048, 100)), (0, False, (2048, 300)),
    (3, True, (2048, 1024, 2048)), (3, False, (1024, 2048))])
def test_scope_matches_jax(magnify, planes, lengths):
    """Streamed blocks (the last shorter than the FFT where there is no
    zoom), the port fed the chain tap's planes or a complex tensor; the
    state handed from the JAX package to the port after block 0."""
    rng = np.random.default_rng(magnify)
    pj = jscope.make_params(magnify=magnify, translate_hz=6000.0)
    pt = scope.make_params(magnify=magnify, translate_hz=6000.0)
    if magnify:
        np.testing.assert_array_equal(pj.zoom_fir, pt.zoom_fir)
    sj = jscope.init_state((C,), pj)
    st = scope.init_state((C,), pt, device="cpu")
    for blk, T in enumerate(lengths):
        i, q = _iq16(rng, blk, T)
        z = (i.astype(np.float32) / 32768
             + 1j * (q.astype(np.float32) / 32768)).astype(np.complex64)
        if blk == 1:
            st = scope.state_from_numpy(sj, device="cpu")
        oj, sj = jscope.process(pj, sj, jnp.asarray(z))
        x = (torch.from_numpy(i), torch.from_numpy(q)) if planes else \
            torch.from_numpy(z)
        ot, st = scope.process(pt, st, x)
        assert snr_db(np.asarray(oj["spectrum"]), ot["spectrum"]) >= 100.0
        for key, tol in (("dbm", 1e-3), ("dbm_hz", 1e-3),
                         ("snap_freq", 0.01)):
            np.testing.assert_allclose(ot[key].numpy(), np.asarray(oj[key]),
                                       rtol=0, atol=tol, err_msg=key)
        sn = scope.state_to_numpy(st)
        for key, v in sj._asdict().items():
            assert snr_db(np.asarray(v), sn[key]) >= 100.0, (blk, key)
    if magnify == 0:
        np.testing.assert_array_equal(sn["iq_tail"], np.asarray(sj.iq_tail))


@pytest.mark.parametrize("magnify", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("in_bytes", [2, 4])
def test_zoom_decimator_fits_k5(magnify, in_bytes):
    """The zoom's 127 taps at every decimation fit K5's shared memory
    (`fir_rt_geometry`) for int16 and f32 planes."""
    p = scope.make_params(magnify=magnify)
    geo = fir_k.fir_rt_geometry(p.zoom_fir.shape[-1], 1 << magnify, in_bytes)
    assert geo.smem <= fir_k.FRONT_SMEM_MAX


def test_waterfall_and_s_units_match_jax():
    rng = np.random.default_rng(3)
    spec = np.abs(rng.standard_normal((C, 256))).astype(np.float32) * 10.0
    spec[0, :10] = 0.0
    # palette indices 0-255: log10 of two libraries, a few ulp apart
    np.testing.assert_allclose(
        scope.waterfall_row(torch.from_numpy(spec)).numpy(),
        np.asarray(jscope.waterfall_row(jnp.asarray(spec))), rtol=0,
        atol=1e-4)
    dbm = np.linspace(-140.0, -20.0, 61).astype(np.float32)
    np.testing.assert_allclose(
        scope.dbm_to_s_units(torch.from_numpy(dbm)).numpy(),
        np.asarray(jscope.dbm_to_s_units(jnp.asarray(dbm))), rtol=0,
        atol=1e-5)
    wj, wt = jscope.WaterfallImage(256, rows=8), scope.WaterfallImage(
        256, rows=8)
    for k in range(12):
        wj.push(spec[k % C])
        wt.push(torch.from_numpy(spec[k % C]))
    np.testing.assert_array_equal(wt.image, wj.image)
    assert wt.floor_db == wj.floor_db and wt._filled == wj._filled == 8


def test_goertzel_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((C, 3, 700)).astype(np.float32)
    d = jnco.freq_to_delta(np.array([700.0, 88.5, 5999.0]), 12000.0)
    pj = jnp.asarray(np.array([0, 2 ** 31, 2 ** 32 - 1], np.uint32))
    pt = torch.from_numpy(np.array([0, 2 ** 31, 2 ** 32 - 1], np.int64))
    for blk in range(3):
        zj, pj = jgoertzel.goertzel_block(jnp.asarray(x[:, blk]), pj,
                                          jnp.asarray(d))
        zt, pt = goertzel.goertzel_block(torch.from_numpy(x[:, blk]), pt,
                                         torch.from_numpy(d.astype(np.int64)))
        assert snr_db(np.asarray(zj), zt) >= 100.0
        np.testing.assert_array_equal(np.asarray(pj).astype(np.int64),
                                      pt.numpy())
    t = np.arange(1200) / 12000.0
    tone = (0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)
    y = np.stack([tone, tone * 0.1, x[0, 0, :1200 - 500].repeat(2)[:1200]])
    pj_ = np.asarray(jgoertzel.tone_power(jnp.asarray(y), 1000.0, 12000.0))
    pt_ = goertzel.tone_power(torch.from_numpy(y), 1000.0, 12000.0).numpy()
    assert snr_db(pj_, pt_) >= 100.0
    np.testing.assert_allclose(pt_[0], 0.25, rtol=1e-3)


def _old_phase_ramp(phase0, delta, n, start=0):
    """`ops/nco.py::phase_ramp` before the scalar delta stayed a Python
    integer: the delta made a device tensor first."""
    k = torch.arange(n, dtype=torch.int64, device=phase0.device)
    d = delta if isinstance(delta, torch.Tensor) else torch.tensor(
        int(delta), dtype=torch.int64, device=phase0.device)
    p0 = (phase0 + nco._mul_mod32(d, start % nco.TWO32))[..., None]
    d = d[..., None] if d.ndim else d
    return (p0 + ((d * k) & nco.MASK32)) & nco.MASK32


@pytest.mark.parametrize("delta", [0, 1, 12345, 2 ** 31 + 7, 2 ** 32 - 2,
                                   2 ** 32 - 1])
@pytest.mark.parametrize("start", [0, -1, -127, -2 ** 20, 5])
def test_phase_ramp_scalar_delta_bit_equal(delta, start):
    rng = np.random.default_rng(delta % 1000 + 7)
    phase = torch.from_numpy(rng.integers(0, 2 ** 32, 6, dtype=np.int64))
    for d in (delta, np.uint32(delta)):
        got = nco.phase_ramp(phase, d, 4099, start=start)
        assert torch.equal(got, _old_phase_ramp(phase, d, 4099, start))
    per = torch.from_numpy(rng.integers(0, 2 ** 32, 6, dtype=np.int64))
    assert torch.equal(nco.phase_ramp(phase, per, 300, start=start),
                       _old_phase_ramp(phase, per, 300, start))


STREAM_CFG = dict(mode="usb", bw_key="2P3KHZ", path_name="LPF",
                  block_len=1024)


def test_stream_runner_matches_sequential_and_jax():
    """tests/test_stream.py's capture (a 6700 Hz tone @ 48 kHz, four
    1024-sample blocks) through the port's StreamRunner: bit-equal to the
    port's chain block by block, >= 80 dB against the JAX StreamRunner."""
    fs, n = 48000.0, 4096
    t = np.arange(n) / fs
    iq = (0.4 * np.exp(2j * np.pi * 6700.0 * t)).astype(np.complex64)
    i_p = np.real(iq)[None].astype(np.float32)
    q_p = np.imag(iq)[None].astype(np.float32)
    tcfg = trx.RxConfig(**STREAM_CFG)
    chain = trx.RxChain(tcfg, device="cpu")

    def step(state, i_b, q_b):
        audio, new_state, _ = chain(state, i=i_b, q=q_b)
        return audio, new_state

    i_blocks, q_blocks = stream.chunk_capture(i_p, q_p, 1024)
    assert i_blocks.shape == (4, 1, 1024)
    runner = stream.StreamRunner(step, device="cpu")
    outs, _ = runner.run(chain.init_state((1,)), i_blocks, q_blocks)
    assert tuple(outs.shape) == (4, 1, 1024)
    st = chain.init_state((1,))
    for k in range(4):
        a, st = step(st, i_p[:, k * 1024:(k + 1) * 1024],
                     q_p[:, k * 1024:(k + 1) * 1024])
        assert torch.equal(a, outs[k])
    # scan_blocks hands the step each block's pytree as one argument
    scanned, _ = stream.scan_blocks(lambda s, b: step(s, *b),
                                    chain.init_state((1,)),
                                    (torch.from_numpy(i_blocks),
                                     torch.from_numpy(q_blocks)))
    assert torch.equal(scanned, outs)

    jcfg = jrx.RxConfig(**STREAM_CFG)
    jp = jrx.make_params(jcfg)

    def jstep(state, i_b, q_b):
        audio, new_state, _ = jrx.process_block(
            jcfg, jp, state, jax.lax.complex(i_b, q_b))
        return audio, new_state

    jouts, _ = jstream.StreamRunner(jstep).run(
        jrx.init_state(jcfg, jp, (1,)), i_blocks, q_blocks)
    assert snr_db(np.asarray(jouts), outs) >= 80.0
