"""The lattice's and the FM modulator's launch rules and their walkers'
schedules, on the CPU.

* `cuda/lattice.py::lattice_geometry` and `cuda/fm_mod.py::
  fm_mod_geometry`: every row (channel) has exactly one walker lane, the
  grid covers every row and the tiles every sample, the shared memory is
  the sources' layout and stays within 227 KB, and at 8192 rows every SM
  runs its four walkers before any runs two blocks (the card tests hold
  the built libraries to the same numbers).
* The lattice walker's order (`kernels/lattice.cu::lat_walker`): a
  whole tile in straight-line blocks of 8 samples, each in wavefront
  order (stage m of sample u at slot m + 2u, the first stages of a
  sample beside the later stages of the ones before it), through the
  rolling slots that carry g, and a short tile's samples one at a time,
  written out in NumPy f32 and held bit for bit against `lattice_plain`
  on seeded inputs with edge values (+-0, +-inf, NaN, subnormals, 1e30),
  over streamed blocks of whole and short tiles, N in {1, 2, 3, 6, 8,
  10, 11, 12}.
* The FM modulator's split (`kernels/fm_mod.cu`): the walker's two
  recurrences and its table index k (-1 for a NaN accumulator), then the
  output warps' lookup in the swizzled table, the NaN rule, the swap and
  the amplitude, held bit for bit against `fm_mod_plain`, with and
  without the subtone plane and with a negative translate.
* The table's placement is a bijection, and spreads a steady carrier's
  lookups over the banks.
* Both sources walk on `kernels/ring.cuh`: the text a build hashes has the
  header written in once, and the constants the rules size from are the
  sources'.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from uhsdr_tpu_torch import data
from uhsdr_tpu_torch.cuda import fm_mod as fm_k
from uhsdr_tpu_torch.cuda import lattice as lat_k
from uhsdr_tpu_torch.cuda import ring
from uhsdr_tpu_torch.mod import modulators as mods

SMS = 132
SHAPES = (1, 3, 15, 16, 17, 31, 32, 33, 527, 528, 529, 8192, 8193)
SMEM_MAX = 227 * 1024


def _rows_once(C: int, lanes: int, blocks: int):
    """Block b's walker w, lane l < lanes walks row b*4*lanes + w*lanes +
    l (`lat_walker` / `fm_walker`): each row below C exactly once."""
    b, w, lane = np.meshgrid(np.arange(blocks), np.arange(ring.WALKERS),
                             np.arange(lanes), indexing="ij")
    rows = (b * ring.WALKERS * lanes + w * lanes + lane).ravel()
    rows = rows[rows < C]
    assert np.array_equal(np.sort(rows), np.arange(C))


def _fills_every_sm_first(C: int, lanes: int, blocks: int, max_lanes: int):
    if C <= ring.WALKERS * max_lanes * SMS:
        assert blocks <= SMS                      # a block an SM at most
        if lanes > 1:                             # and the fewest lanes
            assert -(-C // (ring.WALKERS * (lanes - 1))) > SMS
    else:
        assert lanes == max_lanes


@pytest.mark.parametrize("N", range(1, 13))
@pytest.mark.parametrize("C", SHAPES)
def test_lattice_geometry_one_lane_a_row(C, N):
    T = 1000
    g = lat_k.lattice_geometry(C, T, N, SMS)
    assert 1 <= g.lanes <= lat_k.MAX_LANES
    assert g.rows == ring.WALKERS * g.lanes
    assert g.blocks == -(-C // g.rows)
    assert (g.tiles - 1) * ring.TILE < T <= g.tiles * ring.TILE
    _rows_once(C, g.lanes, g.blocks)
    _fills_every_sm_first(C, g.lanes, g.blocks, lat_k.MAX_LANES)
    assert g.smem == ring.STAGES * g.rows * (ring.TILE + 4) * 4 <= SMEM_MAX


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("C", SHAPES)
def test_fm_mod_geometry_one_lane_a_channel(C, add):
    T = 777
    g = fm_k.fm_mod_geometry(C, T, add, SMS)
    assert 1 <= g.lanes <= fm_k.MAX_LANES
    assert g.channels == ring.WALKERS * g.lanes
    assert g.blocks == -(-C // g.channels)
    assert (g.tiles - 1) * ring.TILE < T <= g.tiles * ring.TILE
    _rows_once(C, g.lanes, g.blocks)
    _fills_every_sm_first(C, g.lanes, g.blocks, fm_k.MAX_LANES)
    planes = 2 if add else 1
    assert g.smem == (ring.STAGES * planes * g.channels * (ring.TILE + 4)
                      + 2 * fm_k.TABLE) * 4 <= SMEM_MAX


def test_the_flagship_launches():
    """At 8192 channels (the TX flagship, the reference chain): 16 lanes a
    walker, 128 blocks of 64 rows, one an SM, four walkers each."""
    assert lat_k.lattice_geometry(8192, 16384, 10)[:3] == (16, 64, 128)
    assert lat_k.lattice_geometry(8192, 4096, 10).tiles == 128
    assert fm_k.fm_mod_geometry(8192, 16384)[:4] == (16, 64, 128, 512)
    assert fm_k.fm_mod_geometry(16896, 1, True).lanes == 32
    assert fm_k.fm_mod_geometry(16897, 1, True).blocks == 133


@pytest.mark.parametrize("rule", [
    lambda: lat_k.lattice_geometry(4, 10, 0),
    lambda: lat_k.lattice_geometry(4, 10, 13),
    lambda: lat_k.lattice_geometry(0, 10, 6),
    lambda: lat_k.lattice_geometry(4, 0, 6),
    lambda: fm_k.fm_mod_geometry(0, 10),
    lambda: fm_k.fm_mod_geometry(4, 0, True)])
def test_rules_refuse_what_the_kernels_do_not_take(rule):
    with pytest.raises(ValueError):
        rule()


# ---------------------------------------------------------------------------
# the lattice walker's wavefront
# ---------------------------------------------------------------------------

WU = 8          # `kernels/lattice.cu`: samples a straight-line block walks


def _walk(pk, pv, slot, x):
    """`lattice_walk<N, U>`: U = len(x) samples of (C,) f32 rows through
    the N stages in wavefront order, stage m of sample u at slot d = m +
    2u, the samples of one slot in ascending u; `slot` (a list of N (C,)
    arrays) is updated in place.  Returns the U outputs."""
    N, U = len(pk), len(x)
    f, acc, y = [None] * U, [None] * U, [None] * U
    zero = np.float32(0.0)
    for d in range(N + 2 * (U - 1)):
        for u in range(U):
            m = d - 2 * u
            if not 0 <= m < N:
                continue
            if m == 0:
                f[u] = x[u]
                acc[u] = x[u] * pv[N] * zero
            g = slot[m]
            f[u] = f[u] - pk[m] * g
            gn = f[u] * pk[m] + g
            acc[u] = acc[u] + gn * pv[m]
            if m > 0:
                slot[m - 1] = gn
            if m == N - 1:
                slot[N - 1] = f[u]
                y[u] = acc[u] + f[u] * pv[N]
    return y


def _lattice_kernel_order(pk, pv, state: np.ndarray, x: np.ndarray):
    """`lat_walker` over a block: whole tiles of ring.TILE samples in
    straight-line blocks of WU, the short last tile a sample at a time."""
    pk, pv = lat_k.coefs(pk, pv)
    slot = [state[:, m].copy() for m in range(len(pk))]
    cols = [x[:, t] for t in range(x.shape[1])]
    y = []
    for t0 in range(0, len(cols), ring.TILE):
        tile = cols[t0:t0 + ring.TILE]
        if len(tile) == ring.TILE:
            for h in range(0, ring.TILE, WU):
                y += _walk(pk, pv, slot, tile[h:h + WU])
        else:
            for col in tile:
                y += _walk(pk, pv, slot, [col])
    return np.stack(y, 1), np.stack(slot, 1)


def _edges(x: np.ndarray, t0: int) -> np.ndarray:
    """Edge samples by row r % 6: 1 every 7th sample one of +-0,
    subnormals, 1e30, +-inf; 2 zeros; 3 subnormal; 4 a NaN at stream
    sample 40; 5 scaled to 1e30."""
    x = x.copy()
    n = np.arange(t0, t0 + x.shape[1])
    special = np.array([0.0, -0.0, 1e-45, -3e-42, 1e30, np.inf, -np.inf],
                       np.float32)
    r = np.arange(x.shape[0]) % 6
    pick = n % 7 == 3
    x[np.ix_(r == 1, pick)] = special[(n[pick] // 7) % 7]
    x[r == 2] = 0.0
    x[r == 3] *= np.float32(1e-41)
    if t0 <= 40 < t0 + x.shape[1]:
        x[r == 4, 40 - t0] = np.nan
    x[r == 5] *= np.float32(1e30)
    return x


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.all(
        (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))))


def _table(N: int):
    names = {6: "IIR_aa_10k", 8: "IIR_8k_LPF", 10: "IIR_2k3_1k412"}
    if N in names:
        return data.lattice(names[N])
    rng = np.random.default_rng(N)
    return (rng.uniform(-0.8, 0.8, N).astype(np.float32),
            rng.uniform(-1.0, 1.0, N + 1).astype(np.float32))


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("N", [1, 2, 3, 6, 8, 10, 11, 12])
def test_lattice_wavefront_is_the_plain_loop(N, edge):
    pk, pv = _table(N)
    rng = np.random.default_rng(100 + N)
    C = 12
    s_k = np.zeros((C, N), np.float32)
    if edge:
        s_k[C // 2, N // 2] = np.nan
    s_p, t0 = torch.from_numpy(s_k.copy()), 0
    with np.errstate(all="ignore"):
        for T in (2 * ring.TILE + 7, ring.TILE, 5, 3 * ring.TILE):
            x = (rng.standard_normal((C, T)) * 1000.0).astype(np.float32)
            if edge:
                x = _edges(x, t0)
            t0 += T
            y_k, s_k = _lattice_kernel_order(pk, pv, s_k, x)
            y_p, s_p = lat_k.lattice_plain(pk, pv, s_p, torch.from_numpy(x))
            assert _same(y_k, y_p.numpy()), T
            assert _same(s_k, s_p.numpy()), T
    assert edge == bool(np.isnan(s_k).any())


# ---------------------------------------------------------------------------
# the FM modulator's walker and output warps
# ---------------------------------------------------------------------------

def _table_slot(k):
    """Where `kernels/fm_mod.cu` keeps table row k (`fm_swz`): k's low 4
    bits, its bank pair, XORed with bits 4-7 and 6-9."""
    return k ^ (((k >> 4) ^ (k >> 6)) & 15)


def _fm_kernel_order(x, add, a, b, acc, alpha, word, scale, amp, swap):
    """`fm_walker` then `fm_output`: the walker's recurrences a sample at a
    time on (C,) f32 rows, k = floor(acc / 64) or -1 for a NaN
    accumulator; the outputs' lookup of (SIN, NEGCOS) at _table_slot(k) in
    the table as the kernel lays it out, NaN for k < 0, the swap, then
    the amplitude."""
    f32 = np.float32
    alpha, word, scale, amp = f32(alpha), f32(word), f32(scale), f32(amp)
    a, b, acc = a.copy(), b.copy(), acc.astype(np.float32)
    ks = np.empty(x.shape, np.int64)
    for t in range(x.shape[1]):
        b = alpha * ((b + x[:, t]) - a)
        a = x[:, t]
        pre = b if add is None else b + add[:, t]
        r = word + pre * scale
        s = np.floor(acc + r)
        acc = s - f32(65536.0) * np.floor(s * f32(1.0 / 65536.0))
        ks[:, t] = np.where(np.isnan(acc), -1,
                            np.floor(np.where(np.isnan(acc), 0, acc)
                                     * f32(1.0 / 64.0)))
    table = fm_k.fm_table("cpu").numpy()
    laid = np.empty((fm_k.TABLE, 2), np.float32)
    laid[_table_slot(np.arange(fm_k.TABLE))] = table.T
    e = laid[_table_slot(np.maximum(ks, 0))]
    iv = np.where(ks < 0, np.float32(np.nan), e[..., 0])
    qv = np.where(ks < 0, np.float32(np.nan), e[..., 1])
    if swap:
        iv, qv = qv, iv
    acc_out = np.where(np.isnan(acc), 0, acc).astype(np.int32)
    return iv * amp, qv * amp, a, b, acc_out


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("translate,subtone", [(6000.0, 0.0),
                                               (-6000.0, 88.5),
                                               (9000.0, 0.0)])
def test_fm_split_is_the_plain_modulator(translate, subtone, edge):
    p = mods.fm_mod_params(translate, False, subtone, count_domain=True)
    assert p.swap_iq == (translate < 0)
    args = (mods.FM_TX_HPF_ALPHA, float(p.freq_word), p.mod_scale,
            mods.FM_MOD_AMPLITUDE_SCALING, p.swap_iq)
    rng = np.random.default_rng(int(abs(translate)) + edge)
    C = 12
    st_k = [np.zeros(C, np.float32), np.zeros(C, np.float32),
            rng.integers(0, 65536, C).astype(np.int32)]
    if edge:
        st_k[1][C // 2] = np.nan
    st_p = [torch.from_numpy(v.copy()) for v in st_k]
    t0 = 0
    with np.errstate(all="ignore"):
        for T in (2 * ring.TILE + 7, 5):
            x = (rng.standard_normal((C, T)) * 9000.0).astype(np.float32)
            if edge:
                x = _edges(x, t0)
            t0 += T
            add = ((rng.standard_normal((C, T)) * 0.01).astype(np.float32)
                   if subtone else None)
            got = _fm_kernel_order(x, add, *st_k, *args)
            ref = fm_k.fm_mod_plain(
                torch.from_numpy(x),
                None if add is None else torch.from_numpy(add), *st_p, *args)
            for what, g, r in zip(("i", "q", "a", "b", "acc"), got, ref):
                assert _same(g, r.numpy()), (what, T)
            st_k, st_p = list(got[2:]), list(ref[2:])
    assert edge == bool(np.isnan(got[0]).any())


def test_table_slots_spread_a_steady_carrier():
    """The table's placement is a bijection on 0..1023; a carrier advancing k by 64,
    128, 192 or 896 (-128) a sample (1.5, 3, 4.5 kHz and +-6 kHz at 48
    kHz) hits each bank pair (16 of them: a row is 8 bytes) at most once in
    a half-warp's 16 lookups, where the unswizzled rows would share one."""
    k = np.arange(fm_k.TABLE)
    assert np.array_equal(np.sort(_table_slot(k)), k)
    for step in (64, 128, 192, 896):
        for k0 in (0, 5, 517):
            ks = (k0 + step * np.arange(16)) % fm_k.TABLE
            distinct = np.unique(ks)
            banks = _table_slot(distinct) % 16
            assert len(np.unique(banks)) == len(distinct), (step, k0)
            assert len(np.unique(distinct % 16)) == 1


# ---------------------------------------------------------------------------
# the sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["lattice", "fm_mod"])
def test_sources_walk_on_the_ring(kernel):
    k = {"lattice": lat_k.LATTICE, "fm_mod": fm_k.FM_MOD}[kernel]
    text = k.source_text()
    assert '#include "' not in text
    assert text.count("#define UHSDR_RING_CUH") == 1
    assert "-fmad=false" in k.flags
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert int(consts["TA"]) == ring.TILE
    assert int(consts["STAGES"]) == ring.STAGES
    assert int(consts["NWALK"]) == ring.WALKERS
    if kernel == "lattice":
        assert int(consts["MAX_N"]) == lat_k.MAX_STAGES
        assert int(consts["LAT_MAXLW"]) == lat_k.MAX_LANES
    else:
        assert int(consts["TABLE"]) == fm_k.TABLE
        assert int(consts["FM_MAXLW"]) == fm_k.MAX_LANES
        assert "return k ^ (((k >> 4) ^ (k >> 6)) & 15);" in text
