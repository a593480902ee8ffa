"""The port's plain torch ops against the JAX package on the CPU: the NCO
phase accumulator, the streaming FIRs, the PreFilter SOS cascade and the
first-order smoothers (`one_pole_block`, `dc_blocker_block`).

Inputs come from a numpy seed and go to both packages as numpy arrays.
Tolerances are SNR = 10·log10(Σref²/Σerr²) in dB (`metrics.snr_db`):
100 dB for the FIRs and the cascade, whose f32 sums are taken in other
orders than the JAX side's (FFT overlap-save, dilated scans); the NCO
phase is held exactly.  The exception is the JAX package's sequential
cascade `biquad_cascade_block` (a dilated affine scan): on the high-Q
PreFilter SOS it sits about 92 dB from a float64 `scipy.signal.sosfilt`
of the same input (`-s` prints it), so the port is held to 90 dB against
it, and to 100 dB against float64 and the JAX blocked form (see
CASCADE_REFS).  The one-pole forms are held to 120 dB against a float64
recurrence and to 115 dB against the JAX forms over three blocks (the
JAX blocked form carries its chunk ends through a dilated pass and
drifts from float64 block by block, 137 -> 128 dB at r = 0.9999; the
port's two-level Toeplitz form stays at ~141 dB; `-s` prints both).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal

from uhsdr_tpu.chain import rx as jrx
from uhsdr_tpu.ops import fir as jfir
from uhsdr_tpu.ops import iir as jiir
from uhsdr_tpu.ops import nco as jnco
from uhsdr_tpu_torch.chain import rx as trx
from uhsdr_tpu_torch.cuda import iir as iir_k
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.ops import fir as tfir
from uhsdr_tpu_torch.ops import iir as tiir
from uhsdr_tpu_torch.ops import nco as tnco

FIR_DB = 100.0
IIR_DB = 100.0
JAX_SEQUENTIAL_IIR_DB = 90.0

FLAGSHIP = dict(mode="usb", bw_key="2P3KHZ", path_name="LPF",
                translate_hz=12000.0, iq_rate=96000.0, block_len=4096)


@pytest.fixture(scope="module")
def flagship():
    """The JAX package's flagship design products (NumPy)."""
    return jrx.make_params(jrx.RxConfig(**FLAGSHIP))


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def test_nco_phase_exact_across_wrap():
    """advance/phase_ramp hold the exact uint32 phase across the 2^32
    wrap, as the JAX package's uint32 arithmetic does."""
    delta = jnco.freq_to_delta(-12000.0, 96000.0)
    assert int(tnco.freq_to_delta(-12000.0, 96000.0)) == int(delta)
    p0 = np.array([2**32 - 1000, 5, 2**31 + 7], np.uint32)
    for n in (1, 4096, 16384, 123457):
        j = np.asarray(jnco.advance(jnp.asarray(p0), jnp.asarray(delta), n))
        t = tnco.advance(torch.from_numpy(p0.astype(np.int64)), int(delta), n)
        np.testing.assert_array_equal(t.numpy().astype(np.uint32), j)
    ramp = tnco.phase_ramp(torch.from_numpy(p0.astype(np.int64)), int(delta),
                           300, start=-200).numpy()
    want = np.array([[(int(p) + int(delta) * k) % 2**32
                      for k in range(-200, 100)] for p in p0])
    np.testing.assert_array_equal(ramp, want)


def test_nco_mix_matches_jax():
    rng = np.random.default_rng(1)
    C, n = 3, 4096
    x = _cplx(rng, (C, n))
    p0 = np.array([2**32 - 1000, 5, 2**31 + 7], np.uint32)
    delta = jnco.freq_to_delta(np.array([-12000.0, 700.0, 23456.7]), 96000.0)
    yj, pj = jnco.mix(jnp.asarray(x), jnp.asarray(p0), jnp.asarray(delta))
    yt, pt = tnco.mix(torch.from_numpy(x),
                      torch.from_numpy(p0.astype(np.int64)),
                      torch.from_numpy(delta.astype(np.int64)))
    np.testing.assert_array_equal(pt.numpy().astype(np.uint32),
                                  np.asarray(pj))
    assert snr_db(np.asarray(yj), yt) >= FIR_DB


@pytest.mark.parametrize("kind", ["decimate", "block", "interpolate"])
def test_streaming_fir_matches_jax(flagship, kind):
    """Three streamed blocks with the carry handed on: the stage-A
    decimator (real taps, complex IQ), the stage-B Hilbert FIR (complex
    taps) and the interpolator (real audio)."""
    rng = np.random.default_rng(2)
    C, B, decim = 4, 2048, 8
    if kind == "decimate":
        h = flagship.front_fir_re
    elif kind == "block":
        h = (flagship.front2_re + 1j * flagship.front2_im).astype(np.complex64)
    else:
        h = flagship.interp_fir
    taps = h.shape[-1]
    if kind == "interpolate":
        keep = -(-taps // decim) - 1
        cj = np.zeros((C, keep), np.float32)
    else:
        cj = np.zeros((C, taps - 1), np.complex64)
    ct = torch.from_numpy(cj)
    hj, ht = jnp.asarray(h), torch.from_numpy(np.ascontiguousarray(h))
    for _ in range(3):
        if kind == "interpolate":
            x = rng.standard_normal((C, B)).astype(np.float32)
            yj, cj = jfir.fir_interpolate_block(hj, cj, jnp.asarray(x), decim)
            yt, ct = tfir.fir_interpolate_block(ht, ct, torch.from_numpy(x),
                                                decim)
        elif kind == "decimate":
            x = _cplx(rng, (C, B))
            yj, cj = jfir.fir_decimate_block(hj, cj, jnp.asarray(x), decim)
            yt, ct = tfir.fir_decimate_block(ht, ct, torch.from_numpy(x),
                                             decim)
        else:
            x = _cplx(rng, (C, B))
            yj, cj = jfir.fir_block(hj, cj, jnp.asarray(x))
            yt, ct = tfir.fir_block(ht, ct, torch.from_numpy(x))
        assert tuple(yt.shape) == yj.shape
        assert snr_db(np.asarray(yj), yt) >= FIR_DB
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


# JAX form -> (bound on outputs, bound on section states) in dB.  The JAX
# sequential form's outputs and section states sit closer to 90 dB than
# to 100 dB from float64 on this SOS (`-s` prints both), so its states
# are not a yardstick: the port's states are held to float64 instead.
CASCADE_REFS = {"blocked": (IIR_DB, IIR_DB),
                "sequential": (JAX_SEQUENTIAL_IIR_DB, None)}


@pytest.mark.parametrize("reference", sorted(CASCADE_REFS))
def test_prefilter_cascade_matches_jax(flagship, reference):
    """The PreFilter lattice as a 5-section SOS: the port's blocked form
    with the exact chunk carry against the JAX package's
    `biquad_cascade_blocked(exact_carry=True)` or `biquad_cascade_block`
    over three streamed blocks; and the port's blocked and sequential
    forms against a float64 `scipy.signal.sosfilt` of the whole stream
    (outputs at 100 dB; section states at 100 dB blocked, 95 dB
    sequential)."""
    sos = flagship.audio_sos
    assert sos.shape == (5, 5)
    rng = np.random.default_rng(3)
    C, T = 4, 512
    y_db, s_db = CASCADE_REFS[reference]
    casc = tiir.cascade(sos, "cpu")
    sj = np.zeros((5, C, 2), np.float32)
    st = torch.zeros((5, C, 2))
    ss = torch.zeros((5, C, 2))
    xs, yjs, yts, yss = [], [], [], []
    for _ in range(3):
        x = (rng.standard_normal((C, T)) * 0.1).astype(np.float32)
        xs.append(x)
        if reference == "blocked":
            yj, sj = jiir.biquad_cascade_blocked(sos, jnp.asarray(sj),
                                                 jnp.asarray(x),
                                                 exact_carry=True)
        else:
            yj, sj = jiir.biquad_cascade_block(jnp.asarray(sos),
                                               jnp.asarray(sj),
                                               jnp.asarray(x))
        yt, st = tiir.biquad_cascade_blocked(casc, st, torch.from_numpy(x))
        ys, ss = tiir.biquad_cascade_block(casc.sos, ss, torch.from_numpy(x))
        yjs.append(np.asarray(yj))
        yts.append(yt)
        yss.append(ys)
        assert snr_db(np.asarray(yj), yt) >= y_db
        if s_db is not None:
            assert snr_db(np.asarray(sj), st) >= s_db
    sos6 = np.concatenate([sos[:, :3], np.ones((5, 1)), sos[:, 3:]],
                          axis=1).astype(np.float64)
    ref, zf = signal.sosfilt(sos6, np.concatenate(xs, -1).astype(np.float64),
                             zi=np.zeros((5, C, 2)))
    print(f"\nvs float64 (outputs, end states) in dB: JAX {reference} "
          f"{snr_db(ref, np.concatenate(yjs, -1)):.1f}, {snr_db(zf, sj):.1f};"
          f" port blocked {snr_db(ref, torch.cat(yts, -1)):.1f}, "
          f"{snr_db(zf, st):.1f}; port sequential "
          f"{snr_db(ref, torch.cat(yss, -1)):.1f}, {snr_db(zf, ss):.1f}")
    assert snr_db(ref, torch.cat(yts, -1)) >= IIR_DB
    assert snr_db(zf, st) >= IIR_DB
    assert snr_db(ref, torch.cat(yss, -1)) >= IIR_DB
    assert snr_db(zf, ss) >= IIR_DB - 5.0


def test_cascade_dispatch_forms():
    """The dispatch (`cuda/iir.py::cascade_dispatch`, on CPU tensors the
    kernels' plain versions): empty cascades pass through, chunkable
    blocks take the blocked form (K2), short blocks the sequential one
    (K11; same numbers)."""
    sos = trx._lattice_sos5(trx.RxConfig(**FLAGSHIP).ref_path["pre"])
    casc = tiir.cascade(sos, "cpu")
    empty = tiir.cascade(np.zeros((0, 5), np.float32), "cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 256)).astype(np.float32))
    s0 = torch.zeros((5, 2, 2))
    y, s = iir_k.cascade_dispatch(empty, torch.zeros((0, 2, 2)), x)
    assert y is x and s.shape == (0, 2, 2)
    yb, sb = iir_k.cascade_dispatch(casc, s0, x)
    ys, ss = iir_k.cascade_dispatch(casc, s0, x[:, :200])
    yq, sq = tiir.biquad_cascade_block(casc.sos, s0, x[:, :200])
    assert snr_db(yq, yb[:, :200]) >= IIR_DB
    assert torch.equal(ys, yq) and torch.equal(ss, sq)


ONE_POLE_F64_DB = 120.0
ONE_POLE_JAX_DB = 115.0


def _one_pole_f64(a, b, y0, x):
    y = np.empty(x.shape)
    for n in range(x.shape[-1]):
        y0 = a * y0 + b * x[..., n].astype(np.float64)
        y[..., n] = y0
    return y, y0


@pytest.mark.parametrize("a,T", [
    (0.9999, 2048),                                          # DC blocker's r
    (float(np.float32(np.exp(-1.0 / (24000 * 0.02)))), 2048),  # fade tauR
    (float(np.float32(np.exp(-1.0 / (24000 * 1.4)))), 2048),   # fade tauI
    (0.9, 300)])                            # ragged: JAX's scan, port padded
def test_one_pole_matches_jax_and_float64(a, T):
    b = 1.0 if a == 0.9999 else 1.0 - a
    rng = np.random.default_rng(5)
    C = 8
    sj = np.zeros(C, np.float32)
    st = torch.zeros(C)
    s64 = np.zeros(C)
    for blk in range(3):
        x = (rng.standard_normal((C, T)) + 3.0).astype(np.float32)
        yj, sj = jiir.one_pole_block(a, b, jnp.asarray(sj), jnp.asarray(x))
        yt, st = tiir.one_pole_block(a, b, st, torch.from_numpy(x))
        y64, s64 = _one_pole_f64(a, b, s64, x)
        vals = (snr_db(y64, np.asarray(yj)), snr_db(y64, yt),
                snr_db(np.asarray(yj), yt), snr_db(s64, st))
        print(f"\na={a:.6f} block {blk}: JAX vs f64 {vals[0]:.1f}, port vs "
              f"f64 {vals[1]:.1f}, port vs JAX {vals[2]:.1f}, port state vs "
              f"f64 {vals[3]:.1f} dB")
        assert vals[1] >= ONE_POLE_F64_DB and vals[3] >= ONE_POLE_F64_DB
        assert vals[2] >= ONE_POLE_JAX_DB
        assert snr_db(np.asarray(sj), st) >= ONE_POLE_JAX_DB


def test_dc_blocker_matches_jax_and_float64():
    """y[n] = x[n] - x[n-1] + 0.9999 y[n-1] on audio with a large offset
    (an AM envelope after the AGC), three blocks."""
    rng = np.random.default_rng(6)
    C, T, r = 8, 2048, 0.9999
    sj = np.zeros((C, 2), np.float32)
    st = torch.zeros((C, 2))
    xp, yp = np.zeros(C), np.zeros(C)
    for blk in range(3):
        x = (rng.standard_normal((C, T)) * 100 + 3000.0).astype(np.float32)
        yj, sj = jiir.dc_blocker_block(r, jnp.asarray(sj), jnp.asarray(x))
        yt, st = tiir.dc_blocker_block(r, st, torch.from_numpy(x))
        y64 = np.empty((C, T))
        for n in range(T):
            xn = x[:, n].astype(np.float64)
            yp = xn - xp + r * yp
            xp = xn
            y64[:, n] = yp
        vals = (snr_db(y64, np.asarray(yj)), snr_db(y64, yt),
                snr_db(np.asarray(yj), yt))
        print(f"\ndc blocker block {blk}: JAX vs f64 {vals[0]:.1f}, port vs "
              f"f64 {vals[1]:.1f}, port vs JAX {vals[2]:.1f} dB")
        assert vals[1] >= ONE_POLE_F64_DB
        assert vals[2] >= ONE_POLE_JAX_DB
        assert snr_db(np.stack([xp, yp], -1), st) >= ONE_POLE_F64_DB
        assert snr_db(np.asarray(sj), st) >= ONE_POLE_JAX_DB


def test_one_pole_refuses_what_it_does_not_compute():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="scalar"):
        tiir.one_pole_block(np.array([0.5, 0.6]), 1.0, torch.zeros(2), x)
    with pytest.raises(ValueError, match="real"):
        tiir.one_pole_block(0.5, 1.0, torch.zeros(2),
                            x.to(torch.complex64))
