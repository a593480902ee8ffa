"""K8's tile geometry (`cuda/fir.py::fir_real_geometry`, the rule the
`kernels/fir_real.cu` launcher applies) for taps 2-512 and block lengths
1-16384, and its schedule.

The rule is pure Python, so it is checked here on the CPU: the halo fits
(a tile is longer than the halo it hands on, or the block is one tile),
every thread has work at the shapes the TX paths send K8, the zero-padded
taps split into whole chunks over the tap groups, and the shared memory
stays within the limit; a shape past the buffers is refused with a
ValueError before any launch.  A NumPy walk of the kernel's schedule
(tiles, forward-copied halos, padded columns, the sliding register window
and the partial sums of the tap groups) is held against the convolution.
The card checks that the library computes the same shared memory
(tests/test_torch_cuda.py, chip_smoke.py's K8 phase).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from uhsdr_tpu_torch.cuda import fir as fir_k

R = fir_k.FIR_REAL_R
NT = fir_k.FIR_REAL_THREADS
# an H100 SM's shared memory (228 KB) and what each resident block
# reserves besides its own (1 KB)
SM_SMEM = 228 * 1024
BLOCK_RESERVED = 1024
# the TX paths' K8 shapes: (taps, B) of the TX flagship and its 1024-channel
# paths, and of `wideband_tx`
TX_TAPS = 201
TX_SHAPES = ((TX_TAPS, 16384), (TX_TAPS, 4096))
BLOCKS = sorted(set(range(1, 65)) | {2 ** k + d for k in range(6, 15)
                                     for d in (-1, 0, 1)} | {16384})


def _chunks(geo):
    """[k_lo, k_hi) of each tap group, as the kernel splits the chunks."""
    n = geo.ap // R
    return [(R * (pg * n // geo.p), R * ((pg + 1) * n // geo.p))
            for pg in range(geo.p)]


@pytest.mark.parametrize("taps_lo,taps_hi", [(2, 129), (129, 257),
                                             (257, 385), (385, 513)])
def test_halo_fits_and_chunks_are_whole(taps_lo, taps_hi):
    for taps in range(taps_lo, taps_hi):
        for B in BLOCKS:
            geo = fir_k.fir_real_geometry(taps, B)
            # the taps zero-padded to whole chunks; the halo covers them
            assert geo.ap % R == 0 and taps <= geo.ap < taps + R
            assert geo.e % R == 0 and geo.e >= taps - 1
            # a tile of whole items; the halo's copy to the next tile
            # never overlaps its source (or the block is one tile)
            assert geo.t_tile % R == 0
            assert B <= geo.t_tile or geo.t_tile >= geo.e
            # every group takes a whole, non-empty run of chunks, and
            # together they take every chunk once
            ranges = _chunks(geo)
            assert ranges[0][0] == 0 and ranges[-1][1] == geo.ap
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            assert all(hi - lo >= R for lo, hi in ranges)


@pytest.mark.parametrize("taps_lo,taps_hi", [(2, 257), (257, 513)])
def test_shared_memory_within_the_limit(taps_lo, taps_hi):
    for taps in range(taps_lo, taps_hi):
        for B in BLOCKS:
            geo = fir_k.fir_real_geometry(taps, B)
            assert 0 < geo.smem <= fir_k.FIR_REAL_SMEM_MAX


@pytest.mark.parametrize("taps,B", TX_SHAPES)
def test_every_thread_has_work_at_the_tx_shapes(taps, B):
    """At the TX shapes every thread takes whole items of R outputs in
    every tile, no taps split (one group), and eight blocks of 4 warps fit
    an SM's shared memory."""
    geo = fir_k.fir_real_geometry(taps, B)
    assert geo.p == 1
    assert (geo.t_tile // R) % NT == 0 and B % geo.t_tile == 0
    assert 8 * (geo.smem + BLOCK_RESERVED) <= SM_SMEM


@pytest.mark.parametrize("taps", [2, 31, 201, 400, 512])
def test_threads_busy_where_the_tile_is_short(taps):
    """A tile with fewer items of R outputs than threads splits the taps
    over groups, so that items x groups fill more than half the threads
    (or every chunk is its own group), and no thread takes a second item
    where the taps are split."""
    for B in BLOCKS:
        geo = fir_k.fir_real_geometry(taps, B)
        items = geo.t_tile // R
        assert items * geo.p > NT // 2 or geo.p == geo.ap // R
        assert geo.p == 1 or items * geo.p <= NT


@pytest.mark.parametrize("taps,B,want", [
    (201, 16384, (208, 208, 2048, 1)),      # the TX flagship
    (201, 4096, (208, 208, 2048, 1)),       # wideband_tx
    (201, 100, (208, 208, 104, 9)),         # shorter than the history
    (201, 1, (208, 208, 8, 26)),            # one sample: a chunk a group
    (3000, 5000, (3000, 3000, 3000, 1))])   # the tile grows to the halo
def test_geometry_at_named_shapes(taps, B, want):
    geo = fir_k.fir_real_geometry(taps, B)
    assert (geo.e, geo.ap, geo.t_tile, geo.p) == want


@pytest.mark.parametrize("taps,B", [(20000, 64), (12000, 16384), (0, 16),
                                    (201, -1)])
def test_shapes_past_the_buffers_are_refused(taps, B):
    with pytest.raises(ValueError):
        fir_k.fir_real_geometry(taps, B)


def test_wrapper_refuses_before_any_launch():
    """`fir_real` on tensors off the CPU checks the geometry before it
    loads or launches anything: meta tensors stand in for the card's."""
    C, B, taps = 2, 64, 20000
    meta = dict(device="meta")
    h = torch.empty(taps, dtype=torch.complex64, **meta)
    carry = torch.empty((C, taps - 1), **meta)
    x = torch.empty((C, B), **meta)
    with pytest.raises(ValueError, match="shared memory"):
        fir_k.fir_real(h, carry, x)
    with pytest.raises(ValueError, match="taps-1"):
        fir_k.fir_real(h[:201], carry[:, :199], x)


def _pad(i):
    return i + i // R


def _schedule(h, carry, x):
    """K8's schedule in NumPy (float64), one channel: the tiles, the halo
    copied forward, the padded columns, each item's sliding window of R
    samples over its group's chunks, the groups' partial sums added in
    order."""
    taps, B = h.shape[-1], x.shape[-1]
    geo = fir_k.fir_real_geometry(taps, B)
    E, AP, T = geo.e, geo.ap, geo.t_tile
    xbuf = np.full(_pad(E + T - 1) + 1, np.nan)
    ht = np.zeros(AP, np.complex128)
    ht[:taps] = h
    n_hist = taps - 1
    for col in range(E):
        n = col - E
        xbuf[_pad(col)] = carry[n + n_hist] if n >= -n_hist else 0.0
    y = np.full(B, np.nan, np.complex128)
    nob = T // R
    for t0 in range(0, B, T):
        tv = min(T, B - t0)
        for j in range(tv):
            xbuf[_pad(E + j)] = x[t0 + j]
        part = np.zeros((geo.p, nob, R), np.complex128)
        for pg, (k_lo, k_hi) in enumerate(_chunks(geo)):
            for ob in range(nob):
                if ob * R >= tv:
                    continue
                base = (R + 1) * (E // R + ob - k_lo // R)
                w = xbuf[base:base + R].copy()
                acc = np.zeros(R, np.complex128)
                for k0 in range(k_lo, k_hi, R):
                    for i in range(R):
                        slots = (np.arange(R) - i) % R
                        acc += ht[k0 + i] * w[slots]
                        if i < R - 1 or k0 + R < k_hi:
                            w[(R - 1 - i) % R] = xbuf[base - i - 2]
                    base -= R + 1
                part[pg, ob] = acc
        y[t0:t0 + tv] = part.sum(0).reshape(-1)[:tv]
        if t0 + T < B:
            for col in range(E):
                xbuf[_pad(col)] = xbuf[_pad(T + col)]
    return y


@pytest.mark.parametrize("taps,B", [(2, 1), (31, 33), (201, 100),
                                    (201, 1), (9, 2100), (17, 4100)])
def test_schedule_is_the_convolution(taps, B):
    rng = np.random.default_rng(taps * 7 + B)
    h = rng.standard_normal(taps) + 1j * rng.standard_normal(taps)
    carry = rng.standard_normal(taps - 1)
    x = rng.standard_normal(B)
    want = np.convolve(np.concatenate([carry, x]), h)[taps - 1:taps - 1 + B]
    np.testing.assert_allclose(_schedule(h, carry, x), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
