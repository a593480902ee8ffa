"""K5, the real-tap decimating front: the port's wrapper (its plain torch
version on CPU tensors) against the TPU kernel it replaces,
`uhsdr_tpu.pallas.fir.fir_decimate_pallas` with real taps (the
`_fir_kernel_rt_s` branch the AM/SAM chains take, chain/rx.py:857-867),
run in interpret mode on the CPU as tests/test_pallas_fir.py runs it.

8 channels, the AM/SAM flagship's 239-tap front at decimation 4 (5P0KHZ
lifted to 96 kHz), three streamed blocks of 2048 samples, for int16 and
f32 input, with the NCO fused (from a starting phase just below the 2^32
wrap) and without it, and for the complex, two-plane and real-only
outputs.  Output and raw carry are held to SNR >= 100 dB (the Pallas
kernel sums through tap-matrix matmuls, the plain version through strided
dot products; both in f32; `-s` prints the values) and the peaks must be
equal.  The CUDA kernel against this plain version is
tests/test_torch_cuda.py's, on the card.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uhsdr_tpu.chain import rx as jrx
from uhsdr_tpu.ops import nco as jnco
from uhsdr_tpu.pallas import fir as pfir
from uhsdr_tpu_torch.cuda import fir as fir_k
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.ops import nco as tnco

TOL_DB = 100.0
C, B, DECIM = 8, 2048, 4
PHASE0 = 2**32 - 5000


@pytest.fixture(scope="module")
def sam_front():
    p = jrx.make_params(jrx.RxConfig(
        mode="sam", bw_key="5P0KHZ", path_name="AM/SAM",
        translate_hz=12000.0, iq_rate=96000.0, block_len=B))
    assert p.front2_re is None and not np.any(p.front_fir_im)
    assert p.front_fir_re.shape[-1] == 239
    return np.asarray(p.front_fir_re, np.float32), int(p.nco_delta)


def _blocks(n, seed=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((2, C, B)) * 3277.0
        x[:, 0] *= 8.0                         # one channel near full scale
        out.append(np.clip(np.round(x), -32768, 32767).astype(np.int16))
    return out


@pytest.mark.parametrize("dtype,use_nco,out", [
    ("int16", True, "complex"), ("int16", True, "planes"),
    ("float32", True, "complex"), ("float32", False, "complex"),
    ("int16", False, "real"), ("float32", True, "real")])
def test_fir_rt_plain_matches_pallas(sam_front, dtype, use_nco, out):
    h_np, delta = sam_front
    taps = h_np.shape[-1]
    h = torch.from_numpy(h_np)
    cj = jnp.zeros((C, taps - 1), jnp.complex64)
    ct = torch.zeros((C, taps - 1), dtype=torch.complex64)
    ph_j = np.uint32(PHASE0)
    ph_t = torch.full((C,), PHASE0, dtype=torch.int64)
    real_out, planes_out = out == "real", out == "planes"
    for blk in _blocks(3):
        if dtype == "int16":
            xj = (jnp.asarray(blk[0]), jnp.asarray(blk[1]))
            xt = (torch.from_numpy(blk[0]), torch.from_numpy(blk[1]))
        else:
            f = blk.astype(np.float32) / np.float32(32768.0)
            xj = jax.lax.complex(jnp.asarray(f[0]), jnp.asarray(f[1]))
            xt = (torch.from_numpy(f[0]), torch.from_numpy(f[1]))
        kw = dict(nco=(jnp.uint32(ph_j), jnp.uint32(delta)),
                  nco_static_delta=delta) if use_nco else {}
        res = pfir.fir_decimate_pallas(
            h_np + 0j, cj, xj, DECIM, tile_c=8, tile_t=256,
            real_out=real_out, planes_out=planes_out,
            peaks_out=not real_out, interpret=True, **kw)
        yj, cj = res[0], res[1]
        yt, ct, pk = fir_k.fir_rt(
            h, ct, *xt, DECIM, nco=(ph_t, delta) if use_nco else None,
            real_out=real_out, planes_out=planes_out)
        if planes_out:
            yj = np.asarray(yj[0]) + 1j * np.asarray(yj[1])
            yt = torch.complex(*yt)
        assert tuple(yt.shape) == (C, B // DECIM)
        assert yt.is_complex() != real_out
        vals = snr_db(np.asarray(yj), yt), snr_db(np.asarray(cj), ct)
        print(f"\n{dtype} nco={use_nco} {out}: output {vals[0]:.1f} dB, "
              f"raw carry {vals[1]:.1f} dB")
        assert min(vals) >= TOL_DB, vals
        scaled = blk.astype(np.float32) / np.float32(32768.0)
        want = np.abs(scaled).max(axis=(0, 2))
        np.testing.assert_array_equal(pk.numpy(), want)
        if not real_out:
            np.testing.assert_array_equal(
                pk.numpy(), np.asarray(jnp.max(res[2], axis=-1)))
        if use_nco:
            ph_j = np.asarray(jnco.advance(jnp.asarray(ph_j),
                                           jnp.uint32(delta), B))
            ph_t = tnco.advance(ph_t, delta, B)
            assert int(ph_t[0]) == int(ph_j)


def test_fir_rt_short_block_and_per_channel_phase():
    """A block shorter than the history keeps the older history in the
    carry, and each channel is rotated by its own phase: the streamed
    result equals one long block's."""
    rng = np.random.default_rng(9)
    taps, decim = 89, 4
    h = torch.from_numpy((rng.standard_normal(taps) * 0.05)
                         .astype(np.float32))
    delta = int(tnco.freq_to_delta(-6000.0, 48000.0))
    x = [torch.from_numpy(np.clip(np.round(
        rng.standard_normal((C, 1024)) * 3277.0), -32768, 32767)
        .astype(np.int16)) for _ in "iq"]
    ph0 = torch.from_numpy(rng.integers(0, 2**32, C))
    c0 = torch.zeros((C, taps - 1), dtype=torch.complex64)
    y_all, c_all, p_all = fir_k.fir_rt(h, c0, *x, decim, nco=(ph0, delta))
    ys, c, ph, pk = [], c0, ph0, []
    for lo, hi in ((0, 40), (40, 64), (64, 1024)):     # 40, 24 < taps - 1
        y, c, p = fir_k.fir_rt(h, c, x[0][:, lo:hi].contiguous(),
                               x[1][:, lo:hi].contiguous(), decim,
                               nco=(ph, delta))
        ph = tnco.advance(ph, delta, hi - lo)
        ys.append(y)
        pk.append(p)
    assert snr_db(y_all, torch.cat(ys, -1)) >= 120.0
    assert torch.equal(c, c_all)
    assert torch.equal(torch.stack(pk).amax(0), p_all)
    # channels with different phases differ; equal phases agree
    same = torch.full((C,), int(ph0[0]), dtype=torch.int64)
    xs = [v[:1].expand(C, -1).contiguous() for v in x]
    y_same = fir_k.fir_rt(h, c0, *xs, decim, nco=(same, delta))[0]
    assert torch.equal(y_same[0], y_same[-1])
    y_diff = fir_k.fir_rt(h, c0, *xs, decim, nco=(ph0, delta))[0]
    assert not torch.allclose(y_diff[0], y_diff[-1])
