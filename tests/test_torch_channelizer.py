"""The port's polyphase channelizer (`uhsdr_tpu_torch.ops.channelizer`)
and wideband fleets (`uhsdr_tpu_torch.parallel.fleet`) against the JAX
package's, on the CPU:

* `ops.fftutil.cfft` / `icfft` (library FFTs) against the JAX package's
  rfft-composed forms, complex and real input, zero-padded: >= 120 dB;
* `AnalysisPfb` and `SynthesisPfb` for M = 8 and 16 channels with both
  inverse DFTs (the dense product and the FFT), three streamed blocks
  through each: outputs and carries >= 100 dB;
* the analysis bank against the direct per-channel form (mix, filter,
  decimate): the port's copy of it in chip_smoke.py, which checks the
  bank on the card, against tests/test_channelizer.py's;
* `WidebandFleet` at tests/test_channelizer.py's shape (M = 8, 2048
  samples a channel, usb 2P3KHZ on 5 channels and am 2P9KHZ on 3, 6
  taps a branch), two streamed blocks: audio >= 85 dB;
* `WidebandTxFleet` at that file's TX shape (M = 8 CW channels keyed
  down, 4096 samples, 8 taps a branch), two blocks: the wideband IQ
  >= 90 dB, and channels 0, 2 and 5 land at their centre plus the
  translate and the sidetone.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests import test_channelizer as jtests
from uhsdr_tpu.chain import rx as jrx
from uhsdr_tpu.chain import tx as jtx
from uhsdr_tpu.ops import channelizer as jchz
from uhsdr_tpu.ops import fftutil as jfft
from uhsdr_tpu.parallel import fleet as jfleet
from uhsdr_tpu_torch.chain import rx as trx
from uhsdr_tpu_torch.chain import tx as ttx
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.ops import channelizer as tchz
from uhsdr_tpu_torch.ops import fftutil as tfft
from uhsdr_tpu_torch.parallel import fleet as tfleet

BANK_DB = 100.0
WIDEBAND_DB = 85.0
TX_DB = 90.0


def _cplx(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


@pytest.mark.parametrize("real,n", [(False, None), (True, None),
                                    (False, 96)])
def test_fftutil_matches_jax(real, n):
    rng = np.random.default_rng(5)
    x = _cplx(rng, (3, 64))
    if real:
        x = x.real.astype(np.float32)
    Fj = np.asarray(jfft.cfft(jnp.asarray(x), n))
    Ft = tfft.cfft(torch.from_numpy(x), n)
    assert tuple(Ft.shape) == Fj.shape and Ft.dtype == torch.complex64
    assert snr_db(Fj, Ft) >= 120.0
    assert snr_db(np.asarray(jfft.icfft(jnp.asarray(Fj))),
                  tfft.icfft(Ft)) >= 120.0


@pytest.mark.parametrize("kind", ["analysis", "synthesis"])
@pytest.mark.parametrize("M,impl", [(8, "matmul"), (8, "fft"),
                                    (16, "matmul"), (16, "fft")])
def test_bank_matches_jax_streamed(M, impl, kind):
    K, T = 6, 24
    J = jchz.AnalysisPfb if kind == "analysis" else jchz.SynthesisPfb
    P = tchz.AnalysisPfb if kind == "analysis" else tchz.SynthesisPfb
    jb = J(M, taps_per_branch=K, dft_impl=impl)
    tb = P(M, taps_per_branch=K, dft_impl=impl, device="cpu")
    assert tb.dft_impl == jb.dft_impl == impl
    np.testing.assert_array_equal(tb.prototype, jb.prototype)
    js, ts = jb.init_state(), tb.init_state()
    assert tuple(ts.shape) == js.shape and ts.dtype == torch.complex64
    rng = np.random.default_rng(M + (impl == "fft"))
    for blk in range(3):
        x = _cplx(rng, (M * T,) if kind == "analysis" else (M, T))
        yj, js = jb(js, jnp.asarray(x))
        yt, ts = tb(ts, torch.from_numpy(x))
        assert tuple(yt.shape) == yj.shape
        # the carry holds storage of its own size, not a view of the block
        assert ts.untyped_storage().nbytes() == 8 * ts.numel()
        out, carry = snr_db(np.asarray(yj), yt), snr_db(np.asarray(js), ts)
        print(f"\n{kind} M={M} {impl} block {blk}: output {out:.1f} dB, "
              f"carry {carry:.1f} dB")
        assert min(out, carry) >= BANK_DB, (blk, out, carry)


def test_auto_impl_is_the_references():
    for M in (8, 512, 1024, 4096):
        assert (tchz._pick_impl(M, "auto")
                == jchz._pick_impl(M, "auto"))


def test_direct_channel_copy_matches():
    M, K = 8, 4
    x = _cplx(np.random.default_rng(3), (8 * M,))
    h = tchz.design_prototype(M, K)
    bank = tchz.AnalysisPfb(M, taps_per_branch=K, device="cpu")
    y, _ = bank(bank.init_state(), torch.from_numpy(x))
    for m in range(M):
        ref = jtests._direct_channel(h, x, m, M)
        got = chip_smoke.direct_channel(torch.from_numpy(h),
                                        torch.from_numpy(x), m, M)
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-6)
        np.testing.assert_allclose(y[m].numpy(), ref, atol=2e-5)


def test_wideband_fleet_matches_jax():
    M, T = 8, 2048
    kws = [dict(mode="usb", bw_key="2P3KHZ", path_name="LPF", block_len=T),
           dict(mode="am", bw_key="2P9KHZ", block_len=T)]
    jw = jfleet.WidebandFleet([jrx.RxConfig(**kw) for kw in kws], [5, 3],
                              taps_per_branch=6)
    tw = tfleet.WidebandFleet([trx.RxConfig(**kw) for kw in kws], [5, 3],
                              taps_per_branch=6, device="cpu")
    assert tw.wideband_block == jw.wideband_block == M * T
    rng = np.random.default_rng(7)
    for blk in range(2):
        x = _cplx(rng, (M * T,), 0.2)
        i, q = x.real.astype(np.float32), x.imag.astype(np.float32)
        yj, yt = jw.process_block(i, q), tw.process_block(i, q)
        assert yt.shape == (M, T)
        s = snr_db(yj, yt)
        print(f"\nwideband fleet block {blk}: {s:.1f} dB")
        assert s >= WIDEBAND_DB, (blk, s)
    assert snr_db(np.asarray(jw.bank_state), tw.bank_state) >= BANK_DB


def test_wideband_tx_fleet_matches_jax():
    M, T = 8, 4096
    fs_wide = M * 48000.0
    kw = dict(mode="cw", translate_hz=6000.0, block_len=T,
              cw_sidetone_hz=700.0)
    jw = jfleet.WidebandTxFleet([jtx.TxConfig(**kw)], [M],
                                taps_per_branch=8)
    tw = tfleet.WidebandTxFleet([ttx.TxConfig(**kw)], [M],
                                taps_per_branch=8, device="cpu")
    key = np.ones((M, T), np.float32)          # CW key-down everywhere
    for blk in range(2):
        ij, qj = jw.process_block_device([jnp.asarray(key)])
        it, qt = tw.process_block_device([torch.from_numpy(key)])
        zj = np.asarray(ij) + 1j * np.asarray(qj)
        zt = torch.complex(it, qt).numpy()
        s = snr_db(zj, zt)
        print(f"\nwideband TX block {blk}: {s:.1f} dB")
        assert zt.shape == (M * T,) and s >= TX_DB, (blk, s)
    spec = np.abs(np.fft.fft(zt * np.hanning(zt.size)))
    freqs = np.fft.fftfreq(zt.size, 1.0 / fs_wide)
    for m in (0, 2, 5):
        f_c = tchz.channel_center_hz(m, M, fs_wide) + 6000.0 + 700.0
        assert spec[np.abs(freqs - f_c) < 200.0].max() > 0.2 * spec.max(), m
