"""The fused ALC stage (`uhsdr_tpu_torch.cuda.alc.alc_run`, the whole of
`mod/alc.py::run` in one kernel on the card) on the CPU: its plain
version, `alc_run_plain`, against the JAX package's `mod/alc.py::run`,
and its launch rule, `alc_geometry`.

Against JAX: the same seeded audio in the count domain (700 Hz bursts
that cross the knee both ways, plus noise) through both over three
streamed blocks with the state carried: at the TX flagship's D = 288
with T = 4096 and with a ragged middle block, at D > T (D = 288, T =
100), and with AM's gain scaling 0.23.  Audio and alc_val are held to 120
dB (tests/test_torch_tx.py's ALC bound: the two f32 recurrences divide
and round alike), the delay line equal; the new delay line owns exactly C
x D floats (the state does not keep the (C, D + T) concatenation alive).
The card holds the kernel to this plain version bit for bit
(tests/test_torch_cuda.py, chip_smoke.py's ALC phase).

The launch rule: every SM a block while the channels allow, four walker
warps a block with the fewest channel lanes that do so, every channel
walked once, shared memory within the card's opt-in limit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uhsdr_tpu.mod import alc as jalc
from uhsdr_tpu_torch.cuda import alc as alc_k
from uhsdr_tpu_torch.cuda import build
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.mod import alc as talc

ALC_DB = 120.0
C = 16
DECAY = 10.0 ** -4.5          # the ref front's alc_decay_var = 10


def _audio(rng, n0: int, T: int) -> np.ndarray:
    n = np.arange(n0, n0 + T)
    return (np.logspace(3, 4.7, C)[:, None]
            * np.sin(2 * np.pi * 700 * n / 48000.0) * (n % 1500 < 700)
            + rng.standard_normal((C, T))).astype(np.float32)


@pytest.mark.parametrize("lengths,delay,gain_scaling", [
    ((4096, 4096, 4096), 288, 1.0),
    ((4096, 1000, 4096), 288, 1.0),
    ((100, 100, 100), 288, 1.0),
    ((1000, 37, 1000), 288, 0.23),
])
def test_fused_alc_plain_matches_jax(lengths, delay, gain_scaling):
    jp = jalc.make_params(decay=DECAY, delay=delay, postfilt_gain=4.0,
                          gain_scaling=gain_scaling)
    tp = talc.params_from_numpy(jp)
    rng = np.random.default_rng(delay + len(lengths) + lengths[1])
    js = jalc.init_state((C,), jp)
    v = torch.ones(C)
    d = torch.zeros((C, delay))
    run = jax.jit(lambda s, x: jalc.run(jp, s, x))
    n0 = 0
    for T in lengths:
        x = _audio(rng, n0, T)
        n0 += T
        yj, js = run(js, jnp.asarray(x))
        yt, v, d = alc_k.alc_run_plain(tp, v, d, torch.from_numpy(x))
        assert snr_db(np.asarray(yj), yt) >= ALC_DB
        assert snr_db(np.asarray(js.alc_val), v) >= ALC_DB
        np.testing.assert_array_equal(d.numpy(), np.asarray(js.delay_buf))
        assert d.shape == (C, delay)
        assert d.untyped_storage().nbytes() == 4 * C * delay
    assert float(v.min()) < 0.9       # the knee was crossed


def _edge_audio(rng, n0: int, T: int, pg: float) -> np.ndarray:
    """_audio with every 7th sample of the odd channels one of +-0, |xp|
    either side of 2^-80 and of 2^100, 3e38, +-inf, and a NaN on channel
    2 at sample 300.  No subnormals: XLA on the CPU flushes them to zero,
    the port keeps them (the card tests hold the kernel to the plain
    version on them)."""
    x = _audio(rng, n0, T)
    n = np.arange(n0, n0 + T)
    lo, hi = 2.0 ** -80 / pg, 2.0 ** 100 / pg
    special = np.array([0.0, -0.0, lo * (1 - 2 ** -12),
                        -lo * (1 + 2 ** -12), hi * (1 - 2 ** -12),
                        -hi * (1 + 2 ** -12), 3e38, -np.inf, np.inf],
                       np.float32)
    pick = n % 7 == 3
    x[1::2, pick] = special[(n[pick] // 7) % special.size]
    if n0 <= 300 < n0 + T:
        x[2, 300 - n0] = np.nan
    return x


def _held_edge(ref: np.ndarray, got: np.ndarray):
    """NaNs and infinities where the reference has them, the finite rest
    at ALC_DB."""
    got = np.asarray(got)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isinf(got) * np.sign(got),
                                  np.isinf(ref) * np.sign(ref))
    fin = np.isfinite(ref)
    assert snr_db(ref[fin], torch.from_numpy(got[fin])) >= ALC_DB


@pytest.mark.parametrize("decay", [DECAY, -0.02])
def test_fused_alc_plain_matches_jax_on_edge_inputs(decay):
    """Where the card's walker leaves the fast division: zeros, the fast
    range's edges, infinities and a NaN in the input, alc_val starting
    outside [VAL_MIN, 1], a negative decay.  The
    plain version keeps the reference's semantics there (a NaN gain stays
    NaN, as jnp.maximum keeps it)."""
    jp = jalc.make_params(decay=decay, delay=64, postfilt_gain=4.0,
                          gain_scaling=1.0)
    tp = talc.params_from_numpy(jp)
    rng = np.random.default_rng(21)
    v0 = np.ones(C, np.float32)
    v0[-6:] = [2.0, 5e-4, 0.0, 1e-30, -0.5, 0.0009]
    js = jalc.init_state((C,), jp)._replace(alc_val=jnp.asarray(v0))
    v = torch.from_numpy(v0)
    d = torch.zeros((C, 64))
    run = jax.jit(lambda s, x: jalc.run(jp, s, x))
    n0 = 0
    for T in (256, 77, 256):
        x = _edge_audio(rng, n0, T, tp.postfilt_gain)
        n0 += T
        yj, js = run(js, jnp.asarray(x))
        yt, v, d = alc_k.alc_run_plain(tp, v, d, torch.from_numpy(x))
        _held_edge(np.asarray(yj), yt.numpy())
        _held_edge(np.asarray(js.alc_val), v.numpy())
        np.testing.assert_array_equal(d.numpy(), np.asarray(js.delay_buf))
    assert np.isnan(v[2].item())


def test_mod_run_is_the_fused_stage():
    """`mod/alc.py::run` is `alc_run`: on the CPU its plain version, the
    state's delay line a fresh (C, D) tensor."""
    p = talc.make_params(DECAY, 288, 4.0, 1.0)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_audio(rng, 0, 700))
    s = talc.init_state((C,), p)
    y, s2 = talc.run(p, s, x)
    y2, v2, d2 = alc_k.alc_run_plain(p, s.alc_val, s.delay_buf, x)
    assert torch.equal(y, y2) and torch.equal(s2.alc_val, v2)
    assert torch.equal(s2.delay_buf, d2)
    assert s2.delay_buf.untyped_storage().nbytes() == 4 * C * 288


@pytest.mark.parametrize("channels", [1, 7, 16, 527, 528, 529, 1024, 4096,
                                      5000, 8192, 16384, 16896, 16897,
                                      40000])
@pytest.mark.parametrize("T", [1, 31, 32, 100, 4096, 16384])
def test_alc_geometry(channels, T):
    sms = alc_k.ALC_SMS
    g = alc_k.alc_geometry(channels, T, sms)
    W = alc_k.ALC_WALKERS
    assert g.channels == W * g.lanes and 1 <= g.lanes <= alc_k.ALC_MAX_LANES
    # every channel walked once: blocks of `channels`, the last ragged
    assert g.blocks == -(-channels // g.channels)
    walked = np.zeros(g.blocks * g.channels, int)
    for b in range(g.blocks):
        for w in range(W):
            for lane in range(g.lanes):
                walked[b * g.channels + w * g.lanes + lane] += 1
    assert (walked[:channels] == 1).all()
    # every SM a block where the channels allow, and no fewer lanes would
    # do: each of an SM's four schedulers walks one warp
    if channels <= W * alc_k.ALC_MAX_LANES * sms:
        assert g.blocks <= sms
        if g.lanes > 1:
            assert -(-channels // (W * (g.lanes - 1))) > sms
    else:
        assert g.lanes == alc_k.ALC_MAX_LANES
    assert g.tiles == -(-T // alc_k.ALC_TILE)
    assert g.smem == (alc_k.ALC_STAGES * 2 * g.channels
                      * (alc_k.ALC_TILE + 4) * 4) <= build.SMEM_OPT_IN


def test_alc_geometry_at_the_chains_widths():
    """The TX flagship's 8192 channels: 16 lanes a walker, 128 blocks;
    the 1024-channel paths: 2 lanes; `wideband_tx`'s 4096: 8."""
    for channels, lanes, blocks in ((8192, 16, 128), (1024, 2, 128),
                                    (4096, 8, 128)):
        g = alc_k.alc_geometry(channels, 16384)
        assert (g.lanes, g.blocks) == (lanes, blocks)


@pytest.mark.parametrize("C_,T", [(0, 10), (4, 0)])
def test_alc_geometry_refuses_an_empty_block(C_, T):
    with pytest.raises(ValueError):
        alc_k.alc_geometry(C_, T)
