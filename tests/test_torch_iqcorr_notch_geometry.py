"""The IQ correction's and the NLMS filter's launch rules and their
kernels' orders, on the CPU.

* `cuda/iqcorr.py::iqcorr_geometry`: a block a channel, every sample of
  a chunk taken by one lane of one worker warp, stages that fit the SM
  the number of times the kernel's launch bounds ask for, and bytes in
  flight past what the card's memory needs; `cuda/lms.py::nlms_geometry`
  (4 lanes a channel, blocks of 8 warps): every channel gets its lanes
  exactly once, the grid covers every channel, shared memory (the window
  of x alone) stays within 227 KB, and at 8192 channels every scheduler
  has its warps before any has more (the card tests hold the built
  libraries to the same numbers).
* The IQ correction kernel's order (`kernels/iqcorr.cu`): 8 samples a
  lane, the pair tree's first three levels in the lane and the last two
  across a sub-block's 4 lanes, the one-poles walked in chunks with a
  group of 8 steps' products formed ahead; written out in NumPy f32 and
  held bit for bit against the unchanged `iqcorr_plain` on int16 planes
  (full scale and zeros) and f32 planes with edge values (+-0, +-inf,
  NaN, subnormals, 1e30) and a NaN state channel, over streamed blocks
  that are no multiple of the chunk.
* The NLMS kernel's order (`kernels/lms.cu::nlms_group`): the virtual
  lanes split over 4 lanes, their folds in the lane and the tree's last
  levels across them, the norm formed for a group's eight steps ahead
  of the walk from the squares of the window's samples (the plain
  version's products), the division mu err / norm, and the notch's
  update without the leak's products; held bit for
  bit against the unchanged `nlms_plain` for the 96-tap notch and the
  64-tap NR, with edge values and a NaN weight, over streamed blocks that
  are no multiple of the group or the tile.
* The sources' layout constants are the modules' mirrors.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from uhsdr_tpu_torch.cuda import iqcorr as iq_k
from uhsdr_tpu_torch.cuda import lms as lms_k
from uhsdr_tpu_torch.ops import lms as lms_ops

SMS = 132
SHAPES = (1, 3, 15, 16, 17, 511, 512, 513, 8192, 8193)
SMEM_MAX = 227 * 1024
F32 = np.float32
# an H100 SM: its shared memory, what the card reserves of it for each
# block, its threads; the bytes of copies an SM keeps in flight to hold
# 3.35 TB/s over 132 SMs at ~1 us of latency
SMEM_SM = 228 * 1024
SMEM_RESERVED = 1024
MAX_THREADS_SM = 2048
IN_FLIGHT_NEED = 25 * 1024
# the IQ correction's samples a lane (`kernels/iqcorr.cu`'s SPL)
SAMPLES_PER_LANE = 8


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == bool or b.dtype == bool:
        return a.shape == b.shape and bool(np.all(a == b))
    return a.shape == b.shape and bool(np.all(
        (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))))


def _edges(x: np.ndarray, n0: int) -> np.ndarray:
    """Edge samples by channel c % 6: 1 every 11th sample one of +-0,
    subnormals, 3e38, +-inf; 2 exact zeros (-0 at odd samples); 3
    subnormal; 4 a NaN at stream sample 300; 5 scaled to 1e30."""
    x = x.copy()
    C, T = x.shape
    n = np.arange(n0, n0 + T)
    special = np.array([0.0, -0.0, 1e-45, -3e-42, 1e-39, 3e38, -np.inf,
                        np.inf], np.float32)
    cls = np.arange(C) % 6
    pick = n % 11 == 3
    x[np.ix_(cls == 1, pick)] = special[(n[pick] // 11) % special.size]
    x[cls == 2] = np.where(n % 2 == 1, F32(-0.0), F32(0.0))
    x[cls == 3] *= F32(1e-41)
    if n0 <= 300 < n0 + T:
        x[cls == 4, 300 - n0] = np.nan
    x[cls == 5] *= F32(1e30)
    return x


# ---------------------------------------------------------------------------
# the launch rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int16", [True, False])
@pytest.mark.parametrize("C", SHAPES)
def test_iqcorr_geometry_a_block_a_channel(C, int16):
    T = 16384
    g = iq_k.iqcorr_geometry(C, T, int16)
    assert g.blocks == C                          # a block a channel
    esize = 2 if int16 else 4
    assert g.chunk * iq_k.SUBBLOCK * esize * 2 == iq_k.STAGE_BYTES
    assert g.chunks * g.chunk >= T // iq_k.SUBBLOCK > (g.chunks - 1) * g.chunk
    smem = iq_k.iqcorr_smem()
    assert smem <= SMEM_MAX
    # the blocks an SM of the launch bounds fit its shared memory and
    # threads, and keep the copies the card's memory needs in flight
    blocks = iq_k.MIN_BLOCKS
    assert blocks * (smem + SMEM_RESERVED) <= SMEM_SM
    assert blocks * iq_k.THREADS <= MAX_THREADS_SM
    in_flight = blocks * iq_k.AHEAD * iq_k.STAGE_BYTES
    assert in_flight >= IN_FLIGHT_NEED >= 3.35e12 / SMS * 1e-6
    # every sample of a chunk is one lane's: sub-block m + 8 w + l // 4,
    # samples 8 (l % 4) .. + 8, of worker warp w, m = 0, 32, ...
    m, w, lane = np.meshgrid(np.arange(0, g.chunk, 32),
                             np.arange(iq_k.WORKERS), np.arange(32),
                             indexing="ij")
    sb = (m + 8 * w + lane // 4).ravel()
    seg = (lane % 4 * SAMPLES_PER_LANE).ravel()
    got = sorted((s, q + e) for s, q in zip(sb, seg)
                 for e in range(SAMPLES_PER_LANE) if s < g.chunk)
    assert got == [(s, e) for s in range(g.chunk)
                   for e in range(iq_k.SUBBLOCK)]


def _lanes_once(C: int, lanes: int, cpw: int, warps: int, blocks: int):
    """Block b's warp w, lane l walks channel b*warps*cpw + w*cpw +
    l // lanes as part l % lanes where l // lanes < cpw: each channel
    below C gets parts 0 .. lanes - 1 exactly once."""
    b, w, lane = np.meshgrid(np.arange(blocks), np.arange(warps),
                             np.arange(32), indexing="ij")
    slot = lane // lanes
    ch = (b * warps * cpw + w * cpw + slot).ravel()
    keep = (slot.ravel() < cpw) & (ch < C)
    got = sorted(zip(ch[keep], (lane % lanes).ravel()[keep]))
    assert got == [(c, h) for c in range(C) for h in range(lanes)]


@pytest.mark.parametrize("L,D", [(96, 8), (64, 4), (96, 0), (64, 200)])
@pytest.mark.parametrize("C", SHAPES)
def test_nlms_geometry_every_channel_once(C, L, D):
    g = lms_k.nlms_geometry(C, 2048, L, D, SMS)
    lanes, warps = lms_k.NLMS_LANES, lms_k.NLMS_WARPS
    assert 1 <= g.cpw <= lms_k.NLMS_MAX_CPW == 32 // lanes
    assert g.channels == warps * g.cpw
    assert g.blocks == -(-C // g.channels)
    H = L + D - 1
    assert g.tile % 128 == 0 and H <= g.tile < H + 128
    assert g.stride % 32 == 8 and g.stride >= H + g.tile + 8
    _lanes_once(C, lanes, g.cpw, warps, g.blocks)
    # the window of x, the stage and the outputs: no window of squares
    assert g.smem == lms_k.nlms_smem(L, D, g.cpw) == \
        warps * g.cpw * (g.stride + 2 * g.tile + 1) * 4 <= SMEM_MAX
    fit = max(c for c in range(1, lms_k.NLMS_MAX_CPW + 1)
              if lms_k.nlms_smem(L, D, c) <= SMEM_MAX)
    if C <= warps * SMS * fit:
        assert g.blocks <= SMS                  # a block an SM at most
        if g.cpw > 1:                           # and the fewest channels
            assert -(-C // (warps * (g.cpw - 1))) > SMS
    else:
        assert g.cpw == fit


def test_the_flagship_launches():
    """At the SSB flagship: iqcorr a block a channel, 8 chunks of 64
    int16 sub-blocks (4 of 32 f32 at 4096); the notch at 4 lanes a
    channel in 128 blocks of 8 warps of 8 channels, one an SM, in 130 KB
    (the leaky filter's 128 blocks of 4 warps of 16 hold two windows)."""
    assert iq_k.iqcorr_geometry(8192, 16384) == (64, 8, 8192)
    assert iq_k.iqcorr_geometry(8192, 4096, False) == (32, 4, 8192)
    assert iq_k.iqcorr_smem() == 34304
    assert lms_k.nlms_geometry(8192, 2048, 96, 8) == (
        8, 64, 128, 128, 264, 133376)
    assert lms_k.nlms_geometry(8192, 2048, 64, 4)[:3] == (8, 64, 128)
    # the operations a sample the notch's function needs: 5L + 3 (the
    # leak of 1 without products, a new square a sample), the NR's 6L + 3;
    # the kernel issues the squares of its windows (4 lanes of 9 samples
    # a tap row and group of 8: 54 at 96 taps) in place of the one
    assert lms_k.nlms_ops(96, 1.0) == 483
    assert lms_k.nlms_ops(64, 0.9999) == 387
    assert lms_k.nlms_issued_ops(96, 1.0) == 483 - 1 + 54
    assert lms_k.leaky_ops(64) == 6 * 64 + 29


@pytest.mark.parametrize("rule", [
    lambda: iq_k.iqcorr_geometry(4, 100),
    lambda: iq_k.iqcorr_geometry(4, 0),
    lambda: iq_k.iqcorr_geometry(4, -32),
    lambda: iq_k.iqcorr_geometry(0, 32),
    lambda: lms_k.nlms_geometry(4, 10, 80, 8),
    lambda: lms_k.nlms_geometry(4, 10, 128, 8),
    lambda: lms_k.nlms_geometry(4, 10, 96, -1),
    lambda: lms_k.nlms_geometry(4, 10, 96, 8, 0),
    lambda: lms_k.nlms_geometry(0, 10, 96, 8),
    lambda: lms_k.nlms_geometry(4, 0, 96, 8),
    lambda: lms_k.nlms_geometry(4, 10, 96, 8000)])
def test_rules_refuse_what_the_kernels_do_not_take(rule):
    with pytest.raises(ValueError):
        rule()


# ---------------------------------------------------------------------------
# the IQ correction kernel's order
# ---------------------------------------------------------------------------

def _sums(x: np.ndarray) -> np.ndarray:
    """(C, nsub, 32) -> (C, nsub): 8 samples a lane, ((v0 + v1) + (v2 +
    v3)) + ((v4 + v5) + (v6 + v7)) in the lane, then lane l + lane l ^ 1
    and that + lane l ^ 2 (lane 0's result)."""
    v = x.reshape(x.shape[:-1] + (4, 8))
    part = ((v[..., 0] + v[..., 1]) + (v[..., 2] + v[..., 3])) \
        + ((v[..., 4] + v[..., 5]) + (v[..., 6] + v[..., 7]))
    lv4 = part[..., [0, 2]] + part[..., [1, 3]]
    return lv4[..., 0] + lv4[..., 1]


def _sqrt(v: np.ndarray) -> np.ndarray:
    """The square root as torch takes it on the device of the plain
    version it is held to.  On the card the kernel's sqrtf and torch.sqrt
    are both sqrt.rn; on the CPU torch's vectorised sqrt misses the nearest
    float by an ulp for some inputs (np.sqrt does not), so the order here
    takes torch's, on an array of the plain version's shape."""
    return torch.sqrt(torch.from_numpy(np.ascontiguousarray(v))).numpy()


def _iqcorr_kernel_order(t1, t2, t3, i, q):
    """`iqcorr_kernel` over a block: the sums of each chunk's
    sub-blocks, the walk a chunk at a time in groups of 8 steps whose
    products with the sums come first, c1 and c2 a sub-block, the
    corrected planes."""
    if i.dtype == np.int16:
        x = i.astype(F32) * F32(3.0517578125e-05)
        y = q.astype(F32) * F32(3.0517578125e-05)
        chunk = iq_k.iqcorr_geometry(1, 32).chunk
    else:
        x, y, chunk = i, q, iq_k.iqcorr_geometry(1, 32, False).chunk
    C, T = x.shape
    nsub = T // 32
    xb, yb = x.reshape(C, nsub, 32), y.reshape(C, nsub, 32)
    sgn = np.where(xb > 0, F32(1.0), np.where(xb < 0, F32(-1.0), F32(0.0)))
    s1 = _sums(sgn * yb) * F32(0.03125)
    s2 = _sums(np.abs(xb)) * F32(0.03125)
    s3 = _sums(np.abs(yb)) * F32(0.03125)
    u1, u2, u3 = (np.empty_like(s1) for _ in range(3))
    for k0 in range(0, nsub, chunk):
        n = min(chunk, nsub - k0)
        j = 0
        while j < n:
            g = min(8, n - j) if j + 8 <= n else 1
            b = [(F32(-0.003) * s1[:, k0 + j + e], F32(0.003) *
                  s2[:, k0 + j + e], F32(0.003) * s3[:, k0 + j + e])
                 for e in range(g)]
            for e in range(g):
                t1 = b[e][0] + F32(0.997) * t1
                t2 = b[e][1] + F32(0.997) * t2
                t3 = b[e][2] + F32(0.997) * t3
                u1[:, k0 + j + e], u2[:, k0 + j + e], u3[:, k0 + j + e] = (
                    t1, t2, t3)
            j += g
    nz = (np.abs(u2) > F32(1e-20)).astype(F32)
    den = u2 * u2 + F32(1e-20)
    c1 = nz * u1 * u2 / den
    h = (u3 * u3 - u1 * u1) / den
    hp = (h > 0).astype(F32) * nz
    c2 = hp * _sqrt(np.where(np.isnan(h), h, np.fmax(h, F32(1e-20)))) \
        + (F32(1.0) - hp)
    qo = yb + c1[..., None] * xb
    io = xb * c2[..., None]
    pe = np.abs(t1) / np.where(np.isnan(t2), t2, np.fmax(t2, F32(1e-12)))
    twin = (t2 > F32(1e-6)) & (pe > F32(0.45))
    return (io.reshape(C, T), qo.reshape(C, T), t1, t2, t3, c1[:, -1],
            c2[:, -1], twin)


@pytest.mark.parametrize("dtype", ["int16", "f32"])
def test_iqcorr_order_is_the_plain_correction(dtype):
    rng = np.random.default_rng(301 + (dtype == "f32"))
    C = 13
    st = [np.zeros(C, F32) for _ in range(3)]
    if dtype == "f32":
        st[1][C // 2] = np.nan                  # a NaN state channel
    sp = [torch.from_numpy(v.copy()) for v in st]
    n0 = 0
    with np.errstate(all="ignore"):
        for T in (32, 96, 8224):                # no multiple of a chunk
            n = np.arange(n0, n0 + T)
            z = (0.3 * np.exp(2j * np.pi * 0.011 * n)
                 * np.linspace(0.2, 1.0, C)[:, None]
                 + 0.01 * (rng.standard_normal((C, T))
                           + 1j * rng.standard_normal((C, T))))
            i_, q_ = z.real * 1.07, z.imag + 0.06 * z.real
            if dtype == "int16":
                i = np.round(i_ * 32767).astype(np.int16)
                q = np.round(q_ * 32767).astype(np.int16)
                i[1, ::5], q[2, ::7] = -32768, 32767    # full scale
                i[3] = 0                                 # sign 0
            else:
                i = _edges(i_.astype(F32), n0)
                q = _edges(q_.astype(F32), n0 + 5)
            got = _iqcorr_kernel_order(*st, i, q)
            ref = iq_k.iqcorr_plain(*sp, torch.from_numpy(i),
                                    torch.from_numpy(q))
            for what, g, r in zip(("i", "q", "t1", "t2", "t3", "c1", "c2",
                                   "twin"), got, ref):
                assert _same(g, r.numpy()), (what, T)
            st, sp = list(got[2:5]), list(ref[2:5])
            n0 += T
    if dtype == "f32":
        assert np.isnan(st[1][C // 2])


# ---------------------------------------------------------------------------
# the NLMS kernel's order
# ---------------------------------------------------------------------------

def _lanes_tree(terms: np.ndarray, lanes: int) -> np.ndarray:
    """terms (C, L), tap j in virtual lane j % 8, the 8 / lanes virtual
    lanes of lane h being 8 h / lanes ..: each virtual lane's left fold,
    each lane's pair tree over its own, then the lanes' partial sums by
    xor shuffles (lane h + lane h ^ 1, then ^ 2)."""
    C, L = terms.shape
    part = terms.reshape(C, L // 8, 8)
    v = part[:, 0]
    for k in range(1, L // 8):
        v = v + part[:, k]
    hv = 8 // lanes
    own = [v[:, hv * h:hv * h + hv] for h in range(lanes)]
    for h in range(lanes):
        while own[h].shape[1] > 1:
            own[h] = own[h][:, 0::2] + own[h][:, 1::2]
    s = [o[:, 0] for o in own]
    off = 1
    while off < lanes:
        s = [s[h] + s[h ^ off] for h in range(lanes)]
        off <<= 1
    return s[0]


def _nlms_kernel_order(p, w, hist, x):
    """`lms_kernel<P, 4, NLMS or NLMS_UNIT>` over a block: tiles of
    `leaky_tile` samples, groups of NLMS_GROUP steps, each group's norms
    first (from the squares of the window's samples), then its steps; a
    leak of 1 without its products."""
    lanes = lms_k.NLMS_LANES
    L, D = p.num_taps, p.delay
    win = np.concatenate([hist, x], axis=1)
    sq = win * win
    T = x.shape[1]
    tile = lms_k.leaky_tile(L, D)
    w = w.copy()
    mu, leak = F32(p.mu), F32(p.leak)
    y = np.empty_like(x)
    group = lms_k.NLMS_GROUP
    for t0 in range(0, T, tile):
        n = min(tile, T - t0)
        for g0 in range(t0, t0 + n, group):
            steps = range(g0, min(g0 + group, t0 + n))
            nrm = [_lanes_tree(sq[:, t + 1:t + 1 + L], lanes) + F32(1e-9)
                   for t in steps]
            for u, t in enumerate(steps):
                ref, xn = win[:, t + 1:t + 1 + L], win[:, t + L + D]
                pr = _lanes_tree(w * ref, lanes)
                err = xn - pr
                f = mu * err / nrm[u]
                kept = w if leak == F32(1.0) else leak * w
                w = kept + f[:, None] * ref
                y[:, t] = err if p.output_error else pr
    return y, w, win[:, T:T + L + D].copy()


@pytest.mark.parametrize("kind", ["notch", "nr"])
def test_nlms_order_is_the_plain_filter(kind):
    p = lms_ops.notch_params() if kind == "notch" else lms_ops.nr_params()
    assert (p.leak == 1.0) == (kind == "notch")
    L, D = p.num_taps, p.delay
    rng = np.random.default_rng(314 + L)
    C = 13
    st = [np.zeros((C, L), F32), np.zeros((C, L + D), F32)]
    st[0][C // 2, 3] = np.nan                 # a NaN weight
    st[0][1] = (rng.standard_normal(L) * 0.01).astype(F32)
    sp = [torch.from_numpy(v.copy()) for v in st]
    n0 = 0
    with np.errstate(all="ignore"):
        for T in (130, 7, 129, 1, 262):       # no multiple of 4, 8, 128
            n = np.arange(n0, n0 + T)
            x = (0.5 * np.sin(2 * np.pi * 0.067 * n)
                 + 0.1 * rng.standard_normal((C, T))).astype(F32)
            x = _edges(x, n0)
            got = _nlms_kernel_order(p, *st, x)
            ref = lms_k.nlms_plain(p, *sp, torch.from_numpy(x))
            for what, g, r in zip(("y", "w", "hist"), got, ref):
                assert _same(g, r.numpy()), (what, T)
            st, sp = list(got[1:]), list(ref[1:])
            n0 += T
    assert np.isnan(st[0][C // 2]).all()
    assert np.isfinite(st[0][0]).all()


# ---------------------------------------------------------------------------
# the sources
# ---------------------------------------------------------------------------

def test_sources_hold_the_mirrored_layouts():
    text = iq_k.IQCORR.source_text()
    c = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert int(c["SUB"]) == iq_k.SUBBLOCK
    assert int(c["WORKERS"]) == iq_k.WORKERS
    assert int(c["SPL"]) == SAMPLES_PER_LANE
    assert int(c["STAGE_BYTES"]) == iq_k.STAGE_BYTES
    assert int(c["STAGES"]) == iq_k.STAGES
    assert int(c["AHEAD"]) == iq_k.AHEAD
    assert int(c["MIN_BLOCKS"]) == iq_k.MIN_BLOCKS
    assert "__launch_bounds__(THREADS, MIN_BLOCKS)" in text
    assert "-fmad=false" in iq_k.IQCORR.flags
    text = lms_k.LMS.source_text()
    c = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert int(c["NL_LANES"]) == lms_k.NLMS_LANES
    assert int(c["NL_WARPS"]) == lms_k.NLMS_WARPS
    assert int(c["NL_GROUP"]) == lms_k.NLMS_GROUP
    assert int(c["LK_WARPS"]) == lms_k.LEAKY_WARPS
    assert int(c["LK_GROUP"]) == lms_k.LEAKY_GROUP
    assert "MODE == LEAKY ? LK_THREADS : 32 * NL_WARPS" in text
    # one NLMS layout: the NLMS block holds no window of squares
    assert "lk_smem(L, D, cpw, NL_WARPS, 1)" in text
    assert "lk_smem(L, D, cpw, LK_WARPS, 2)" in text
    assert "nlms_kernel" not in text          # the first body is gone
