"""K3's Hopper design (`kernels/agc.cu`), held on the CPU through its torch
mirror in `cuda/agc.py` against the plain versions, bit for bit.

(a) `look_ahead_ring`, the front warp's sliding max (van Herk /
Gil-Werman over a ring of w + 96 to 127 samples, segments of w, the
delay line the first), run tile by tile with the delay line handed from block to
block, gives `look_ahead_max`'s bits, the delayed samples and the new
delay line, for w in {1, 2, 47, 48, 96, 128, 192, 255, 256} at T = 1,
T < w, T = the tile, the tile +- 1 and a ragged three-block stream.
(b) `machine_step_select`, the select-form step K3 and K13 share, gives
`machine_step`'s bits on random carries and on the edges of its
compares: rm == volts, volts == pop_ratio * fba, volts == save,
hba == hang_level, the hang counter at 0, 0.5, 1, 1.5 and 2, every state
0-4 with decay 0 and 1, hang on and off, scalars and rows.
Walked from finite carries into non-finite inputs (rm +-inf or NaN, a
NaN or infinite back-average) it gives the blended step's values, a NaN
where that has one (the blended form's products by 0 turn an infinite
candidate into NaN, and a NaN volts into a NaN save).
(c) `agc_geometry` keeps K3's shared memory within an H100's 227 KB a
block and two blocks an SM, for every w in 1..256.
(d) `agc_design`, the three with the gain law, gives `agc_plain`'s bits
over streamed blocks, with scalars and with rows, and on an edge stream
(+-0, +-inf, a NaN, subnormals) with the NaNs where the plain version
has them.
The card holds the kernel itself to the plain version
(tests/test_torch_cuda.py, chip_smoke.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from uhsdr_tpu_torch.cuda import agc as agc_k
from uhsdr_tpu_torch.ops import agc as agc_ops

TILE = agc_k.AGC_TILE
# an H100's shared memory: 227 KB a block, 228 KB an SM, 1 KB of which
# each resident block reserves; 2048 threads an SM; 15 named barriers
# besides __syncthreads'
SMEM_BLOCK = 227 * 1024
SM_SMEM = 228 * 1024
BLOCK_RESERVED = 1024
SM_THREADS = 2048


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _assert_bits(a: torch.Tensor, b: torch.Tensor, what: str):
    assert a.shape == b.shape, what
    assert torch.equal(_bits(a), _bits(b)), what


def _assert_same(a: torch.Tensor, b: torch.Tensor, what: str):
    """Equal bits, a NaN matching a NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    assert a.shape == b.shape and torch.equal(na, nb), what
    assert torch.equal(_bits(a[~na]), _bits(b[~nb])), what


def _signal(rng, C: int, T: int) -> torch.Tensor:
    """Bursts over noise at levels 1e-4 .. 1, ties included (a run of equal
    samples, zeros)."""
    x = rng.standard_normal((C, T)) * np.logspace(-4, 0, C)[:, None]
    x[:, T // 3: T // 3 + 5] = 0.25
    x[:, T // 2: T // 2 + 3] = 0.0
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("w", [1, 2, 47, 48, 96, 128, 192, 255, 256])
def test_ring_sliding_max_is_look_ahead_max(w):
    rng = np.random.default_rng(w)
    C = 3
    lengths = ([1, max(w - 1, 1), TILE, TILE - 1, TILE + 1]
               + [w + 37, 3 * TILE + 5, 64])      # ragged three-block stream
    delay = _signal(rng, C, w)
    for blk, T in enumerate(lengths):
        x = _signal(rng, C, T)
        rm, xs, new_delay = agc_k.look_ahead_ring(delay, x)
        xfull = torch.cat([delay, x], dim=-1)
        what = f"w={w} block {blk} T={T}"
        _assert_bits(agc_k.look_ahead_max(xfull.abs(), w, T), rm, what)
        _assert_bits(xfull[:, :T], xs, what)
        _assert_bits(xfull[:, T:], new_delay, what)
        delay = new_delay


def _params(hang_enable: bool) -> agc_k.AgcScalars:
    return agc_ops.kernel_params(agc_ops.make_params(
        12000.0, mode="med", hang_enable=hang_enable)).scalars


def _carries(p: agc_k.AgcScalars, rng, n: int):
    """n random carries and the edges of every compare of the step, over
    every state 0-4 and decay 0/1."""
    f = np.float32
    volts = rng.uniform(1e-5, 2.0, n).astype(f)
    volts[: n // 8] = 0.0                          # the first step's volts
    save = rng.uniform(0.0, 2.0, n).astype(f)
    rm = rng.uniform(0.0, 2.0, n).astype(f)
    fb = rng.uniform(0.0, 2.0, n).astype(f)
    hb = rng.uniform(0.0, 2.0 * p.hang_level, n).astype(f)
    hang = rng.choice(np.array([0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 37.0], f), n)
    st = rng.integers(0, 5, n).astype(f)
    decay = rng.integers(0, 2, n).astype(f)
    # the edges: a quarter of the entries each meet one compare's equality
    q = rng.integers(0, 5, n)
    rm[q == 0] = volts[q == 0]
    fb_t = torch.from_numpy(fb)
    pv = (p.pop_ratio * fb_t).numpy()              # as the step computes it
    volts[q == 1] = pv[q == 1]
    save[q == 2] = volts[q == 2]
    hb[q == 3] = np.float32(p.hang_level)
    t = {k: torch.from_numpy(v) for k, v in dict(
        volts=volts, save=save, hang=hang, decay=decay, st=st, rm=rm,
        hb=hb).items()}
    # every state with each decay and each hang counter, once at least
    grid = np.array(np.meshgrid(np.arange(5), [0, 1],
                                [0.0, 0.5, 1.0, 1.5, 2.0])).reshape(3, -1)
    k = grid.shape[1]
    t["st"][:k] = torch.from_numpy(grid[0].astype(f))
    t["decay"][:k] = torch.from_numpy(grid[1].astype(f))
    t["hang"][:k] = torch.from_numpy(grid[2].astype(f))
    return t, fb_t


@pytest.mark.parametrize("hang_enable", [True, False])
@pytest.mark.parametrize("rows", [False, True])
def test_select_step_is_blended_step(hang_enable, rows):
    p = _params(hang_enable)
    rng = np.random.default_rng(11 + 2 * hang_enable + rows)
    n = 4096
    t, fb = _carries(p, rng, n)
    chan = None
    if rows:
        mv = torch.from_numpy(rng.uniform(1e-6, 1e-3, n).astype(np.float32))
        hl = torch.from_numpy(
            rng.uniform(0.5, 1.5, n).astype(np.float32)) * p.hang_level
        t["hb"][::7] = hl[::7]                     # hba == its row's level
        chan = (mv, hl)
    carry = (t["volts"], t["save"], t["hang"], t["decay"], t["st"])
    # every step of a short walk from these carries, each step's outputs
    # the next step's carries
    for step in range(6):
        want = agc_k.machine_step(p, carry, t["rm"], fb, t["hb"], chan)
        got = agc_k.machine_step_select(p, carry, t["rm"], fb, t["hb"],
                                        chan)
        for i, name in enumerate(("volts", "save", "hang", "decay",
                                  "state")):
            _assert_bits(want[i], got[i], f"step {step} {name}")
        carry = want
        t["rm"] = t["rm"] * 0.75 if step % 2 else t["rm"] * 1.5


@pytest.mark.parametrize("rows", [False, True])
def test_select_step_off_the_finite_is_blended(rows):
    p = _params(True)
    rng = np.random.default_rng(12 + rows)
    n = 4096
    t, fb = _carries(p, rng, n)
    nan, inf = float("nan"), float("inf")
    edge = np.array([inf, -inf, nan], np.float32)
    rm0 = t["rm"].clone()
    chan = None
    if rows:
        chan = (torch.full((n,), float(p.min_volts)),
                torch.full((n,), float(p.hang_level)))
    carry = (t["volts"], t["save"], t["hang"], t["decay"], t["st"])
    for step in range(6):
        # rm off the finite on a lane in seven, other lanes each step; a
        # back-average NaN or infinite on a few
        rm = rm0 * (0.75 if step % 2 else 1.5)
        pick = torch.arange(n) % 7 == step
        rm[pick] = torch.from_numpy(edge[rng.integers(0, 3, int(pick.sum()))])
        fbs = fb.clone()
        fbs[step::13] = nan if step % 2 else inf
        want = agc_k.machine_step(p, carry, rm, fbs, t["hb"], chan)
        got = agc_k.machine_step_select(p, carry, rm, fbs, t["hb"], chan)
        for i, name in enumerate(("volts", "save", "hang", "decay",
                                  "state")):
            _assert_same(want[i], got[i], f"step {step} {name}")
        assert torch.isnan(want[0][pick]).all()
        carry = want
    assert torch.isnan(carry[1]).sum() > n // 4      # NaN volts saved


@pytest.mark.parametrize("C", [1, 31, 33, 1024, 8192])
def test_geometry_keeps_two_blocks_an_sm(C):
    for w in range(1, agc_k.AGC_MAXW + 1):
        for rows in (False, True):
            g = agc_k.agc_geometry(C, 100, w, rows)
            assert g.smem <= SMEM_BLOCK
            assert 2 * (g.smem + BLOCK_RESERVED) <= SM_SMEM
            assert 2 * g.threads <= SM_THREADS
            assert g.ring % g.tile == 0 and g.ring_stride % 2 == 1
            assert w + 3 * g.tile <= g.ring < w + 4 * g.tile
            assert g.h_stride >= w and g.h_stride % 2 == 1
            assert g.grid * agc_k.AGC_CB >= C > (g.grid - 1) * agc_k.AGC_CB
            assert g.tile % 32 == 0 and g.tiles == -(-100 // g.tile)
    assert agc_k.AGC_BARRIERS <= 15
    with pytest.raises(ValueError):
        agc_k.agc_geometry(C, 100, agc_k.AGC_MAXW + 1)
    with pytest.raises(ValueError):
        agc_k.agc_geometry(C, 0, 48)


@pytest.mark.parametrize("fs,rows", [(12000.0, False), (24000.0, True),
                                     (48000.0, False)])
def test_design_is_plain(fs, rows):
    C = 6
    thresh = np.linspace(40.0, 90.0, C) if rows else 60.0
    params = agc_ops.make_params(fs, mode="med", hang_enable=True,
                                 thresh_db=thresh)
    kp = agc_ops.kernel_params(params, C)
    p = kp.scalars
    rt = None if kp.rows is None else torch.as_tensor(kp.rows)
    w = params.attack_buffsize
    rng = np.random.default_rng(int(fs) + rows)
    cd = cp = torch.zeros((agc_k.N_CARRY, C))
    dd = dp = torch.zeros((C, w))
    level = np.logspace(-1, 4, C)[:, None]
    t0 = 0
    for blk, T in enumerate((150, 41, 97)):
        n = np.arange(t0, t0 + T)
        t0 += T
        x = level * np.sin(2 * np.pi * 700 * n / fs) * (n < 200)
        x = torch.from_numpy((x + rng.standard_normal((C, T)) * 0.5)
                             .astype(np.float32))
        yd, cd, dd = agc_k.agc_design(p, cd, dd, x, rt)
        yp, cp, dp = agc_k.agc_plain(p, cp, dp, x, rt)
        _assert_bits(yp, yd, f"block {blk} audio")
        _assert_bits(cp, cd, f"block {blk} carry")
        _assert_bits(dp, dd, f"block {blk} delay")


@pytest.mark.parametrize("fs", [12000.0, 24000.0])
def test_design_is_plain_on_edges(fs):
    """+-0 runs, +-inf, a NaN, subnormals: the NaNs the plain version
    spreads (through its look-ahead max and its blended step), the same
    bits elsewhere."""
    C = 6
    params = agc_ops.make_params(fs, mode="med", hang_enable=True)
    p = agc_ops.kernel_params(params).scalars
    w = params.attack_buffsize
    rng = np.random.default_rng(int(fs) + 5)
    cd = cp = torch.zeros((agc_k.N_CARRY, C))
    dd = dp = torch.zeros((C, w))
    for blk, T in enumerate((150, 41, 97)):
        x = rng.standard_normal((C, T)).astype(np.float32) * 300.0
        x[1, 10:30] = -0.0
        x[2, 20] = np.inf if blk else -np.inf
        x[3, 5] = np.nan if blk == 1 else x[3, 5]
        x[4, :] = np.float32(1e-42) * rng.standard_normal(T)
        x = torch.from_numpy(x)
        yd, cd, dd = agc_k.agc_design(p, cd, dd, x, None)
        yp, cp, dp = agc_k.agc_plain(p, cp, dp, x, None)
        _assert_same(yp, yd, f"block {blk} audio")
        _assert_same(cp, cd, f"block {blk} carry")
        _assert_same(dp, dd, f"block {blk} delay")
    assert torch.isnan(yp[2]).all() and torch.isnan(yp[3]).all()
    assert torch.isfinite(yp[0]).all() and torch.isfinite(yp[4]).all()
