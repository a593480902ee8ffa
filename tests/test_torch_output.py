"""The port's RX output stage (`uhsdr_tpu_torch.chain.output`) against the
JAX package's (`uhsdr_tpu.chain.output`), mirroring tests/test_output.py:
AF gain and the saturating clamp, the chain-scale default, mute per
channel, the beep's frequency and phase continuity, and the same block
through both packages with mute and beep as per-channel gates over four
streamed blocks.  Tolerance: 1e-6 absolute (outputs within [-1, 1]; the
beep's sine is taken from a float64 angle in the port, from an f32 one in
the JAX package, ~2e-7 apart).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from uhsdr_tpu.chain import output as joutput
from uhsdr_tpu_torch.chain import output

ATOL = 1e-6


def test_params_match_jax():
    for kw in (dict(), dict(af_gain=30, beep_freq_hz=700.0, beep_volume=3,
                            fs=96000.0, input_full_scale=1.0)):
        assert output.params_from_numpy(joutput.make_params(**kw)) == \
            output.make_params(**kw)


def test_gain_and_clip():
    p = output.make_params(af_gain=16, input_full_scale=1.0)
    st = output.init_state((2,))
    x = torch.full((2, 256), 0.5)
    y, st = output.output_block(p, st, x)
    np.testing.assert_allclose(y.numpy(), 0.5, atol=ATOL)
    p2 = output.make_params(af_gain=30, input_full_scale=1.0)
    y2, _ = output.output_block(p2, st, x)
    assert float(y2.max()) == 1.0 and bool((y2 <= 1.0).all())


def test_chain_scale_default_does_not_saturate():
    p = output.make_params(af_gain=16)
    y, _ = output.output_block(p, output.init_state((2,)),
                               torch.full((2, 256), 4096.0))
    np.testing.assert_allclose(y.numpy(), 4096.0 / 32768.0, atol=ATOL)


def test_mute_per_channel():
    p = output.make_params(input_full_scale=1.0)
    y, _ = output.output_block(p, output.init_state((2,)),
                               torch.full((2, 128), 0.3),
                               mute=torch.tensor([1.0, 0.0]))
    assert bool((y[0] == 0.0).all()) and bool((y[1] > 0.0).all())


def test_beep_tone_freq_and_phase_continuity():
    fs = 48000.0
    p = output.make_params(beep_freq_hz=1000.0, beep_volume=10, fs=fs,
                           input_full_scale=1.0)
    st = output.init_state(())
    blocks = []
    for _ in range(4):
        y, st = output.output_block(p, st, torch.zeros(480), beep=True)
        blocks.append(y.numpy())
    y = np.concatenate(blocks)
    t = np.arange(len(y)) / fs
    np.testing.assert_allclose(
        y, p.beep_level * np.sin(2 * np.pi * 1000.0 * t), atol=1e-3)


def test_output_block_matches_jax_streamed():
    """Chain-scale audio (some of it past full scale) with the mute and
    beep gates per channel, changing between blocks, through both
    packages: the outputs and the beep phase."""
    rng = np.random.default_rng(4)
    C, T = 4, 1000
    jp = joutput.make_params(af_gain=20, beep_freq_hz=880.0, beep_volume=12)
    tp = output.params_from_numpy(jp)
    js, ts = joutput.init_state((C,)), output.init_state((C,))
    gates = [(np.array([0, 1, 0, 0], np.float32),
              np.array([1, 1, 0, 0], bool)),
             (np.array([0, 0, 1, 0], np.float32),
              np.array([0, 1, 1, 0], bool)),
             (False, True), (True, False)]
    for mute, beep in gates:
        x = (rng.standard_normal((C, T)) * 12000.0).astype(np.float32)
        yj, js = joutput.output_block(jp, js, jnp.asarray(x),
                                      mute=mute, beep=beep)
        yt, ts = output.output_block(
            tp, ts, torch.from_numpy(x),
            mute=torch.as_tensor(mute) if isinstance(mute, np.ndarray)
            else mute,
            beep=torch.as_tensor(beep) if isinstance(beep, np.ndarray)
            else beep)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL)
        np.testing.assert_array_equal(ts.beep_phase.numpy().astype(np.uint32),
                                      np.asarray(js.beep_phase))
        assert float(np.abs(yt.numpy()).max()) <= 1.0
