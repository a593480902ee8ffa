"""K3, the WDSP look-ahead AGC: the port's `ops.agc.run` (the K3 wrapper's
plain torch version on CPU tensors) against `uhsdr_tpu.ops.agc.run` on
the CPU (its XLA scan path, whose machine step `_make_xla_step` the plain
version repeats), over three streamed blocks of a burst-then-silence
signal that walks attack, fast decay, hang and hang decay (hang enabled)
or long decay (hang disabled).  Output, the seven machine carries and
the delay line are held to SNR >= 90 dB after every block.  The fast
and hang back-averages are the loosest: the JAX side runs them as blocked
one-pole matmuls, the port sample by sample, and both f32 recurrences
drift from a float64 one block by block, which is why the comparison
stops after three blocks (`-s` prints each block's worst leaf).

The AM/SAM form of the stage runs the same comparison at 24 kHz, where
the look-ahead is 96 samples, with `remove_dc=True`: the DC blocker
(`ops.iir.dc_blocker_block`, r = 0.9999) follows the gain and its state
`AgcState.dc` is one more leaf, on an input with the offset of an AM
envelope.  At 24 kHz the back-averages' time constants are twice as many
samples and the two f32 forms drift faster (fast back-average 121.1,
105.9, 89.2 dB after blocks 1-3), so those two leaves are held to 85 dB
there and everything else to 90 dB.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uhsdr_tpu.ops import agc as jagc
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.ops import agc as tagc

TOL_DB = 90.0
BACKAVERAGE_24K_DB = 85.0
FS = 12000.0
C, T = 8, 2048
BURST = 2 * T          # the tone stops after two blocks


def _block(blk: int, rng) -> np.ndarray:
    n = np.arange(blk * T, (blk + 1) * T)
    level = np.logspace(np.log10(30.0), np.log10(20000.0), C)[:, None]
    tone = level * np.sin(2 * np.pi * 700.0 * n / FS) * (n < BURST)
    return (tone + rng.standard_normal((C, T)) * 0.5).astype(np.float32)


# hang_enable -> machine states that must be seen at block ends, across
# the channels (2 = hang, 4 = hang decay, 3 = long decay)
END_STATES = {True: {2.0, 4.0}, False: {3.0}}


@pytest.mark.parametrize("hang", sorted(END_STATES))
def test_agc_plain_matches_jax(hang):
    jp = jagc.make_params(FS, mode="med", hang_enable=hang)
    tp = tagc.make_params(FS, mode="med", hang_enable=hang)
    assert tp.attack_buffsize == jp.attack_buffsize == 48
    js = jagc.init_state((C,), jp)
    ts = tagc.init_state((C,), tp)
    rng = np.random.default_rng(8)
    seen = set()
    for blk in range(3):
        x = _block(blk, rng)
        yj, js = jagc.run(jp, js, jnp.asarray(x))
        yt, ts = tagc.run(tp, ts, torch.from_numpy(x))
        leaves = {f: snr_db(np.asarray(getattr(js, f)), getattr(ts, f))
                  for f in tagc.AgcState._fields}
        leaves["output"] = snr_db(np.asarray(yj), yt)
        worst = min(leaves, key=leaves.get)
        print(f"\nblock {blk}: worst leaf {worst} {leaves[worst]:.1f} dB")
        for f, db in leaves.items():
            assert db >= TOL_DB, (blk, f, db)
        seen |= set(ts.state.tolist())
    assert END_STATES[hang] <= seen, seen
    assert (2.0 in seen) == hang
    assert (ts.volts > float(tp.min_volts)).all()      # still decaying


def test_agc_remove_dc_and_wide_window_match_jax():
    fs = 24000.0
    jp = jagc.make_params(fs, mode="med", remove_dc=True)
    tp = tagc.make_params(fs, mode="med", remove_dc=True)
    assert tp.attack_buffsize == jp.attack_buffsize == 96 and tp.remove_dc
    js = jagc.init_state((C,), jp)
    ts = tagc.init_state((C,), tp)
    tp0 = tp._replace(remove_dc=False)          # the same AGC, no blocker
    ts0 = tagc.init_state((C,), tp0)
    rng = np.random.default_rng(9)
    with_dc, without_dc = [], []
    for blk in range(3):
        x = np.abs(_block(blk, rng)) + 40.0        # an envelope: x >= 0
        yj, js = jagc.run(jp, js, jnp.asarray(x))
        yt, ts = tagc.run(tp, ts, torch.from_numpy(x))
        y0, ts0 = tagc.run(tp0, ts0, torch.from_numpy(x))
        with_dc.append(yt.numpy())
        without_dc.append(y0.numpy())
        leaves = {f: snr_db(np.asarray(getattr(js, f)), getattr(ts, f))
                  for f in tagc.AgcState._fields}
        leaves["output"] = snr_db(np.asarray(yj), yt)
        worst = min(leaves, key=leaves.get)
        print(f"\nblock {blk}: worst leaf {worst} {leaves[worst]:.1f} dB, "
              f"dc {leaves['dc']:.1f} dB")
        for f, db in leaves.items():
            tol = BACKAVERAGE_24K_DB if "backaverage" in f else TOL_DB
            assert db >= tol, (blk, f, db)
    assert float(ts.dc.abs().max()) > 0.0
    # the stage's output is the blocker's float64 recurrence
    # y[n] = x[n] - x[n-1] + r y[n-1] over the AGC's own output
    g = np.concatenate(without_dc, -1).astype(np.float64)
    ref = np.empty_like(g)
    xp = yp = np.zeros(C)
    for n in range(g.shape[-1]):
        yp = g[:, n] - xp + tagc.DC_BLOCKER_R * yp
        xp = g[:, n]
        ref[:, n] = yp
    db = snr_db(ref, np.concatenate(with_dc, -1))
    print(f"output vs float64 blocker on the un-blocked output: {db:.1f} dB")
    assert db >= TOL_DB, db


def test_agc_params_match_jax():
    """The NumPy design copy gives the reference's numbers, per-channel
    settings included."""
    for kw in (dict(mode="fast"), dict(mode="long", thresh_db=40.0),
               dict(thresh_db=np.array([30.0, 60.0, 90.0]))):
        jp, tp = jagc.make_params(FS, **kw), tagc.make_params(FS, **kw)
        for f in jagc.AgcParams._fields:
            np.testing.assert_array_equal(np.asarray(getattr(tp, f)),
                                          np.asarray(getattr(jp, f)))
    with pytest.raises(NotImplementedError, match="per-channel"):
        tagc.kernel_params(tp)
