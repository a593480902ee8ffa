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

Per-channel settings (a (C,) ``thresh_db`` and ``hang_thresh_db``: the
rows of min_volts, slope_constant and hang_level all differ channel by
channel) at C = 1024, T = 256, three streamed blocks: the port's plain
`run` against the TPU kernel itself, JAX `run(..., _force_kernel=True)`,
which reaches `agc_pallas_fused(chan=...)` in interpret mode, and against
JAX `run` on its XLA scan; the port's `run_stereo` against JAX
`run_stereo`, and its machine (`agc_scan_plain` with the (2, C) rows)
against `agc_scan_pallas(chan=...)` in interpret mode on the same
inputs; output and every leaf >= 90 dB.  A channel with rows gives, bit
for bit, what it gives alone with its settings as scalars, in `run` and
`run_stereo`; with the AGC off a (C,) fixed gain multiplies channel by
channel (the reference's `run_stereo` cannot broadcast it).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uhsdr_tpu.ops import agc as jagc
from uhsdr_tpu.pallas import agc as pallas_agc
from uhsdr_tpu_torch.cuda import agc as agc_k
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
        # the delay line holds storage of its own size, not a view of the
        # block's concatenation
        assert ts.delay.untyped_storage().nbytes() == 4 * C * 48
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
    # the per-channel rows are the reference's `_chan_rows`
    kp = tagc.kernel_params(tp, 3)
    for rows, fused in ((kp.rows, True), (kp.scan_rows, False)):
        assert rows.dtype == np.float32 and rows.flags.c_contiguous
        np.testing.assert_array_equal(rows,
                                      np.asarray(jagc._chan_rows(jp, 3,
                                                                 fused)))
    assert tagc.kernel_params(tagc.make_params(FS)).rows is None


# ---------------------------------------------------------------------------
# per-channel settings: the rows of K3 and K13
# ---------------------------------------------------------------------------

RC, RT = 1024, 256           # the TPU kernels' channel tile, 256 steps


def _rows_params(pkg, hang=True, **kw):
    return pkg.make_params(FS, mode="med", hang_enable=hang,
                           thresh_db=np.linspace(40.0, 80.0, RC),
                           hang_thresh_db=np.linspace(-40.0, -20.0, RC),
                           **kw)


LEVEL = np.logspace(np.log10(2.0), np.log10(20000.0), RC)


def _rows_block(blk: int, rng, n_ch: int = 1) -> np.ndarray:
    """(RC, [n_ch,] RT): a 700 Hz tone at -80 ... -4 dBFS across the
    channels that steps down 10 dB after 100 samples and stops after
    500, plus noise 100 dB below full scale."""
    n = np.arange(blk * RT, (blk + 1) * RT)
    env = np.where(n < 100, 1.0, 0.316) * (n < 500)
    tone = LEVEL[:, None] * np.sin(2 * np.pi * 700.0 * n / FS) * env
    out = [tone * (0.5 ** k) + rng.standard_normal((RC, RT)) * 0.2
           for k in range(n_ch)]
    x = out[0] if n_ch == 1 else np.stack(out, axis=1)
    return x.astype(np.float32)


def _warm(pkg, state):
    """The same start for both packages: the machine as after a long tone
    at each channel's level (volts at its peak, both back-averages at its
    mean |x|), so the 10 dB step walks the hang (and long-decay) branch
    inside three short blocks."""
    def t(v):
        v = np.asarray(v, np.float32)
        return jnp.asarray(v) if pkg is jagc else torch.from_numpy(v)
    return state._replace(volts=t(LEVEL), fast_backaverage=t(0.64 * LEVEL),
                          hang_backaverage=t(0.64 * LEVEL))


def _leaves_db(js, ts) -> dict:
    return {f: snr_db(np.asarray(getattr(js, f)), getattr(ts, f))
            for f in tagc.AgcState._fields}


def test_agc_rows_match_pallas_chan_kernel():
    jp, tp = _rows_params(jagc), _rows_params(tagc)
    assert tagc.per_channel(tp) and tp.min_volts.shape == (RC,)
    jk = jx = _warm(jagc, jagc.init_state((RC,), jp))
    ts = _warm(tagc, tagc.init_state((RC,), tp))
    rng = np.random.default_rng(12)
    seen = set()
    for blk in range(3):
        x = _rows_block(blk, rng)
        yk, jk = jagc.run(jp, jk, jnp.asarray(x), _force_kernel=True)
        assert jagc.last_path == "pallas_fused"
        yx, jx = jagc.run(jp, jx, jnp.asarray(x))
        assert jagc.last_path == "xla_scan"
        yt, ts = tagc.run(tp, ts, torch.from_numpy(x))
        for what, yj, js in (("kernel", yk, jk), ("scan", yx, jx)):
            leaves = _leaves_db(js, ts)
            leaves["output"] = snr_db(np.asarray(yj), yt)
            worst = min(leaves, key=leaves.get)
            print(f"\nblock {blk} vs the TPU {what}: worst {worst} "
                  f"{leaves[worst]:.1f} dB")
            for f, db in leaves.items():
                assert db >= TOL_DB, (blk, what, f, db)
        seen |= set(ts.state.tolist())
    assert {2.0, 3.0} <= seen, seen       # hang and long decay


def test_agc_stereo_rows_match_pallas_chan_kernel():
    jp, tp = _rows_params(jagc), _rows_params(tagc)
    js = _warm(jagc, jagc.init_state_stereo((RC,), jp))
    ts = _warm(tagc, tagc.init_state_stereo((RC,), tp))
    carry_t = carry_k = np.stack([getattr(ts, f).numpy()
                                  for f in tagc.CARRY_FIELDS])
    tail = np.zeros((RC, 48), np.float32)
    pp = jagc._pallas_params(jp, np.float32(jp.hang_time_samples),
                             fused=False, scalar=False)
    chan = jagc._chan_rows(jp, RC, False)
    scalars = tagc.kernel_params(tp, RC).scalars
    rows = torch.from_numpy(tagc.kernel_params(tp, RC).scan_rows)
    rng = np.random.default_rng(13)
    for blk in range(3):
        x = _rows_block(blk, rng, n_ch=2)
        yj, js = jagc.run_stereo(jp, js, jnp.asarray(x))
        yt, ts = tagc.run_stereo(tp, ts, torch.from_numpy(x))
        leaves = _leaves_db(js, ts)
        leaves["output"] = snr_db(np.asarray(yj), yt)
        # the machine alone on one set of inputs: K13's plain version with
        # its (2, C) rows against the TPU kernel with `chan`
        a = np.concatenate([tail, np.abs(x).max(axis=1)], axis=-1)
        tail = a[:, RT:]
        rm = np.array(jagc._sliding_max_ahead(jnp.asarray(a), 48))[:, :RT]
        ax = np.ascontiguousarray(a[:, :RT])
        vk, carry_k = pallas_agc.agc_scan_pallas(
            pp, jnp.asarray(carry_k), jnp.asarray(rm), jnp.asarray(ax),
            chan=chan)
        vt, carry_t = agc_k.agc_scan_plain(
            scalars, torch.from_numpy(np.asarray(carry_t)),
            torch.from_numpy(rm), torch.from_numpy(ax), rows)
        leaves["K13 volts"] = snr_db(np.asarray(vk), vt)
        leaves["K13 carry"] = snr_db(np.asarray(carry_k), carry_t)
        carry_k, carry_t = np.asarray(carry_k), carry_t.numpy()
        worst = min(leaves, key=leaves.get)
        print(f"\nstereo block {blk}: worst {worst} {leaves[worst]:.1f} dB")
        for f, db in leaves.items():
            assert db >= TOL_DB, (blk, f, db)


def test_rows_give_each_channel_its_own_bits():
    """Channel c of a run with rows equals channel c run alone with its
    settings as scalars, bit for bit (the plain versions; K3 and K13 on
    the card are held to them in tests/test_torch_cuda.py)."""
    th = np.array([60.0, 50.0, 70.0, 55.0])
    tp = tagc.make_params(FS, thresh_db=th, hang_enable=True)
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((4, 300)).astype(np.float32)
                         * 300.0)
    x2 = torch.from_numpy(rng.standard_normal((4, 2, 300))
                          .astype(np.float32) * 300.0)
    y, s = tagc.run(tp, tagc.init_state((4,), tp), x)
    y2, s2 = tagc.run_stereo(tp, tagc.init_state_stereo((4,), tp), x2)
    for c in range(4):
        p1 = tagc.make_params(FS, thresh_db=float(th[c]), hang_enable=True)
        assert tagc.kernel_params(p1).rows is None
        y1, s1 = tagc.run(p1, tagc.init_state((1,), p1), x[c:c + 1])
        assert torch.equal(y1[0], y[c])
        y21, s21 = tagc.run_stereo(p1, tagc.init_state_stereo((1,), p1),
                                   x2[c:c + 1])
        assert torch.equal(y21[0], y2[c])
        for f in tagc.AgcState._fields:
            assert torch.equal(getattr(s1, f)[0], getattr(s, f)[c]), f
            assert torch.equal(getattr(s21, f)[0], getattr(s2, f)[c]), f


def test_agc_off_fixed_gain_per_channel():
    th = np.array([40.0, 60.0, 80.0])
    jp = jagc.make_params(FS, mode="off", thresh_db=th)
    tp = tagc.make_params(FS, mode="off", thresh_db=th)
    x = np.random.default_rng(15).standard_normal((3, 64)).astype(np.float32)
    yj, _ = jagc.run(jp, jagc.init_state((3,), jp), jnp.asarray(x))
    yt, _ = tagc.run(tp, tagc.init_state((3,), tp), torch.from_numpy(x))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    x2 = np.stack([x, 2 * x], axis=1)
    y2, _ = tagc.run_stereo(tp, tagc.init_state_stereo((3,), tp),
                            torch.from_numpy(x2))
    np.testing.assert_array_equal(
        y2.numpy(), x2 * np.asarray(jp.fixed_gain)[:, None, None])


@pytest.mark.parametrize("mode", ["med", "off"])
def test_setup_made_once_streams_the_same_bits(mode):
    """`make_setup` (the rows and the fixed gain on the device, made once
    for a stream) gives every block the bits of a call that makes its
    own, in `run` and in `run_stereo`."""
    th = np.array([45.0, 60.0, 75.0])
    tp = tagc.make_params(FS, mode=mode, thresh_db=th)
    setup = tagc.make_setup(tp, 3, "cpu")
    kp = tagc.kernel_params(tp, 3)
    if mode == "off":
        np.testing.assert_array_equal(setup.gain.numpy(), tp.fixed_gain)
    else:
        np.testing.assert_array_equal(setup.rows.numpy(), kp.rows)
    rng = np.random.default_rng(16)
    s_a = s_b = tagc.init_state((3,), tp)
    s2_a = s2_b = tagc.init_state_stereo((3,), tp)
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((3, 200)).astype(
            np.float32) * 300.0)
        x2 = torch.stack([x, 0.5 * x], dim=1)
        y_a, s_a = tagc.run(tp, s_a, x, setup)
        y_b, s_b = tagc.run(tp, s_b, x)
        y2_a, s2_a = tagc.run_stereo(tp, s2_a, x2, setup)
        y2_b, s2_b = tagc.run_stereo(tp, s2_b, x2)
        assert torch.equal(y_a, y_b) and torch.equal(y2_a, y2_b)
        for f in tagc.AgcState._fields:
            assert torch.equal(getattr(s_a, f), getattr(s_b, f)), f
            assert torch.equal(getattr(s2_a, f), getattr(s2_b, f)), f
