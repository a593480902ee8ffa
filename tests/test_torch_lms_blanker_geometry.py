"""The leaky LMS's and the noise blanker's launch rules and their kernels'
orders, on the CPU.

* `cuda/lms.py::leaky_geometry` and `cuda/blanker.py::blanker_geometry`:
  every channel has its two lanes exactly once, the grid covers every
  channel, the shared memory is the sources' layout and stays within 227
  KB, and at 8192 channels every scheduler has a warp before any has two
  (the card tests hold the built libraries to the same numbers).
* The leaky kernel's order (`kernels/lms.cu::leaky_kernel`): two lanes a
  channel, four virtual lanes' left folds in each, the tree's first two
  levels in the lane and the third across the pair; the four steps of a
  group take sigma, inv and the nel factor from squares formed once a
  sample and folded ahead of the walk; written out in NumPy f32 and held
  bit for bit against the unchanged `leaky_plain` on seeded inputs with
  edge values (+-0, +-inf, NaN, subnormals, 1e30) and a NaN weight, over
  streamed blocks that are no multiple of the group or the tile, 64 and
  96 taps, the NR and the notch.
* The blanker kernel's order (`kernels/blanker.cu`): the 32 virtual
  lanes' folds and the tree split over the pair, the candidates by a
  NaN-propagating window max, and the repairs in slot rounds: min(found
  + 2, 5) slots, each reading its samples through the blends before it
  (x * 1 + 0 outside the last slot's window), the two lanes' forward and
  backward walks as one form on nearest-first contexts; held bit for bit
  against the unchanged `blanker_plain` on frames with 0, 1, 4, 5 and
  more than 5 candidates, tied neighbours, slots fewer than 17 samples
  apart, and edge values, over streamed blocks.  On the case that one
  empty slot in place of two gets wrong (a -0 context and first sample
  ahead of an AR(10) frame with positive coefficients, at mult 8), the
  kernel's order holds and the one-slot form differs.
* The sources' layout constants are the modules' mirrors.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from uhsdr_tpu_torch.cuda import blanker as nb_k
from uhsdr_tpu_torch.cuda import lms as lms_k
from uhsdr_tpu_torch.ops import lms as lms_ops

SMS = 132
SHAPES = (1, 3, 15, 16, 17, 31, 32, 33, 511, 512, 513, 8192, 8193)
SMEM_MAX = 227 * 1024
F32 = np.float32


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.all(
        (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))))


def _lanes_once(C: int, cpw: int, warps: int, blocks: int):
    """Block b's warp w, lane l walks channel b*warps*cpw + w*cpw + l // 2
    as half l % 2 where l // 2 < cpw: each channel below C gets halves 0
    and 1 exactly once."""
    b, w, lane = np.meshgrid(np.arange(blocks), np.arange(warps),
                             np.arange(32), indexing="ij")
    slot = lane // 2
    ch = (b * warps * cpw + w * cpw + slot).ravel()
    keep = (slot.ravel() < cpw) & (ch < C)
    got = sorted(zip(ch[keep], (lane % 2).ravel()[keep]))
    assert got == [(c, h) for c in range(C) for h in (0, 1)]


def _every_scheduler_first(C: int, cpw: int, warps: int, blocks: int,
                           max_cpw: int):
    if C <= warps * max_cpw * SMS:
        assert blocks <= SMS                 # a block an SM at most
        assert -(-C // cpw) <= warps * SMS   # a warp a scheduler at most
        if cpw > 1:                          # and the fewest channels
            assert -(-C // (warps * (cpw - 1))) > SMS
    else:
        assert cpw == max_cpw


@pytest.mark.parametrize("L,D", [(64, 16), (96, 16), (64, 1), (96, 40)])
@pytest.mark.parametrize("C", SHAPES)
def test_leaky_geometry_two_lanes_a_channel(C, L, D):
    g = lms_k.leaky_geometry(C, 2048, L, D, SMS)
    assert 1 <= g.cpw <= lms_k.LEAKY_MAX_CPW
    assert g.channels == lms_k.LEAKY_WARPS * g.cpw
    assert g.blocks == -(-C // g.channels)
    H = L + D - 1
    assert g.tile % 128 == 0 and H <= g.tile < H + 128
    assert g.stride % 32 == 8 and g.stride >= H + g.tile + 8
    _lanes_once(C, g.cpw, lms_k.LEAKY_WARPS, g.blocks)
    # the most channels a warp whose windows fit (a long delay: fewer)
    fit = max(c for c in range(1, lms_k.LEAKY_MAX_CPW + 1)
              if lms_k.leaky_smem(L, D, c) <= SMEM_MAX)
    _every_scheduler_first(C, g.cpw, lms_k.LEAKY_WARPS, g.blocks, fit)
    assert g.smem == g.channels * (2 * g.stride + 2 * g.tile + 1) * 4
    assert g.smem <= SMEM_MAX


@pytest.mark.parametrize("C", SHAPES)
def test_blanker_geometry_two_lanes_a_channel(C):
    g = nb_k.blanker_geometry(C, 2048, SMS)
    assert 1 <= g.cpw <= nb_k.MAX_CPW
    assert g.channels == nb_k.WARPS * g.cpw
    assert g.blocks == -(-C // g.channels)
    assert g.frames == 16
    _lanes_once(C, g.cpw, nb_k.WARPS, g.blocks)
    _every_scheduler_first(C, g.cpw, nb_k.WARPS, g.blocks, nb_k.MAX_CPW)
    assert g.smem == g.channels * nb_k.ROW_FLOATS * 4 <= SMEM_MAX


def test_the_flagship_launches():
    """At 8192 channels (the SSB flagship's 12 kHz tap): 16 channels a
    warp, 128 blocks of 64 channels, one an SM, a warp a scheduler; at
    1024 (`am_nb`) 2 channels a warp, still 128 blocks."""
    assert lms_k.leaky_geometry(8192, 2048, 64, 16) == (
        16, 64, 128, 128, 232, 184576)
    assert lms_k.leaky_geometry(8192, 2048, 96, 16)[:3] == (16, 64, 128)
    assert nb_k.blanker_geometry(8192, 2048) == (16, 64, 128, 16, 156672)
    assert nb_k.blanker_geometry(1024, 2048)[:3] == (2, 8, 128)
    assert nb_k.blanker_geometry(8449, 128).blocks == 133


@pytest.mark.parametrize("rule", [
    lambda: lms_k.leaky_geometry(4, 10, 80, 16),
    lambda: lms_k.leaky_geometry(4, 10, 64, 0),
    lambda: lms_k.leaky_geometry(0, 10, 64, 16),
    lambda: lms_k.leaky_geometry(4, 0, 64, 16),
    lambda: lms_k.leaky_geometry(4, 10, 64, 4000),
    lambda: nb_k.blanker_geometry(4, 200),
    lambda: nb_k.blanker_geometry(4, 0),
    lambda: nb_k.blanker_geometry(0, 128)])
def test_rules_refuse_what_the_kernels_do_not_take(rule):
    with pytest.raises(ValueError):
        rule()


# ---------------------------------------------------------------------------
# the leaky kernel's order
# ---------------------------------------------------------------------------

def _lane_tree(terms: np.ndarray) -> np.ndarray:
    """terms (C, L), tap j in virtual lane j % 8: each virtual lane's left
    fold, lane h's (v(4h) + v(4h+1)) + (v(4h+2) + v(4h+3)), then lane 0's
    plus lane 1's."""
    C, L = terms.shape
    part = terms.reshape(C, L // 8, 8)
    v = part[:, 0]
    for k in range(1, L // 8):
        v = v + part[:, k]
    half = [(v[:, 4 * h] + v[:, 4 * h + 1])
            + (v[:, 4 * h + 2] + v[:, 4 * h + 3]) for h in (0, 1)]
    return half[0] + half[1]


def _leaky_kernel_order(p, w, hist, lidx, ngamma, x):
    """`leaky_kernel` over a block: tiles of `leaky_tile` samples, groups
    of four steps, each group's sigma, inv and nel factor first (from x^2
    formed once a sample), then its steps."""
    L, D = p.num_taps, p.delay
    tmu = F32(p.two_mu)
    win = np.concatenate([hist, x], axis=1)
    sq = win * win
    T = x.shape[1]
    tile = lms_k.leaky_tile(L, D)
    w, lidx, ngam = w.copy(), lidx.copy(), ngamma.copy()
    c0 = F32(1.0) - tmu * ngam
    y = np.empty_like(x)
    for t0 in range(0, T, tile):
        n = min(tile, T - t0)
        for g0 in range(t0, t0 + n, lms_k.LEAKY_GROUP):
            steps = range(g0, min(g0 + lms_k.LEAKY_GROUP, t0 + n))
            sig = [_lane_tree(sq[:, t + 1:t + 1 + L]) for t in steps]
            inv = [F32(1.0) / (s + F32(1e-10)) for s in sig]
            kel = [F32(1.0) - tmu * s * i for s, i in zip(sig, inv)]
            for u, t in enumerate(steps):
                ref, xn = win[:, t + 1:t + 1 + L], win[:, t + L + D]
                pr = _lane_tree(w * ref)
                err = xn - pr
                nel = np.abs(err * kel[u])
                te = tmu * err
                nev = np.abs(xn - c0 * pr - te * sig[u] * inv[u])
                up = lidx + F32(p.lincr)
                up = np.where(np.isnan(up), up, np.fmin(up, F32(p.lidx_max)))
                dn = lidx - F32(p.ldecr)
                dn = np.where(np.isnan(dn), dn, np.fmax(dn, F32(p.lidx_min)))
                lidx = np.where(nev < nel, up, dn)
                ngam = F32(p.gamma) * (lidx * lidx) * (lidx * lidx) \
                    * F32(p.den_mult)
                c0 = F32(1.0) - tmu * ngam
                c1 = te * inv[u]
                w = c0[:, None] * w + c1[:, None] * ref
                y[:, t] = err if p.output_error else pr
    return y, w, win[:, T:T + L + D].copy(), lidx, ngam


def _lms_edges(rng, x: np.ndarray, n0: int) -> np.ndarray:
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


@pytest.mark.parametrize("L", [64, 96])
@pytest.mark.parametrize("notch", [False, True])
def test_leaky_order_is_the_plain_filter(L, notch):
    p = lms_ops.leaky_lms_params(notch=notch, num_taps=L)
    rng = np.random.default_rng(200 + L + notch)
    C, D = 13, p.delay
    st = [np.zeros((C, L), F32), np.zeros((C, L + D), F32),
          np.full(C, 120.0, F32), np.full(C, 0.001, F32)]
    st[0][C // 2, 3] = np.nan                 # a NaN weight
    st[0][1] = (rng.standard_normal(L) * 0.01).astype(F32)
    sp = [torch.from_numpy(v.copy()) for v in st]
    n0, lengths = 0, (130, 7, 129, 1, 262)    # no multiple of 4 or 128
    with np.errstate(all="ignore"):
        for T in lengths:
            n = np.arange(n0, n0 + T)
            x = (0.5 * np.sin(2 * np.pi * 0.067 * n)
                 + 0.1 * rng.standard_normal((C, T))).astype(F32)
            x = _lms_edges(rng, x, n0)
            got = _leaky_kernel_order(p, *st, x)
            ref = lms_k.leaky_plain(p, *sp, torch.from_numpy(x))
            for what, g, r in zip(("y", "w", "hist", "lidx", "ngamma"), got,
                                  ref):
                assert _same(g, r.numpy()), (what, T)
            st, sp = list(got[1:]), list(ref[1:])
            n0 += T
    assert np.isnan(st[0][C // 2]).all()
    assert np.isfinite(st[0][0]).all()


# ---------------------------------------------------------------------------
# the blanker kernel's order
# ---------------------------------------------------------------------------

def _canon(v):
    """What a blend does to a sample outside its window: x * 1 + 0."""
    return v * F32(1.0) + F32(0.0)


def _pair_sum(x: np.ndarray) -> np.ndarray:
    """(C, 32 virtual lanes, 4 samples): the folds over the samples, the
    tree's four levels in each lane's 16, then lane 0's plus lane 1's."""
    v = x[..., 0]
    for m in range(1, x.shape[-1]):
        v = v + x[..., m]
    half = []
    for h in (0, 1):
        t = v[:, 16 * h:16 * h + 16]
        while t.shape[-1] > 1:
            t = t[:, 0::2] + t[:, 1::2]
        half.append(t[:, 0])
    return half[0] + half[1]


def _lanes(x: np.ndarray) -> np.ndarray:
    """(C, 128) -> (C, 32, 4): sample n = v + 32 m at [v, m]."""
    return x.reshape(x.shape[0], 4, 32).transpose(0, 2, 1)


def _levinson(R: np.ndarray) -> np.ndarray:
    C = R.shape[0]
    e = np.zeros((C, nb_k.ORDER + 1), F32)
    e[:, 0] = 1.0
    alfa = R[:, 0] * F32(1.0)
    for mm in range(1, nb_k.ORDER + 1):
        s = R[:, mm]
        for i in range(1, mm):
            s = s + e[:, i] * R[:, mm - i]
        k = -s / np.where(np.isnan(alfa), alfa, np.fmax(alfa, F32(1e-30)))
        na = e.copy()
        for i in range(1, mm):
            na[:, i] = e[:, i] + k * e[:, mm - i]
        e = na
        e[:, mm] = k
        alfa = alfa * (F32(1.0) - k * k)
    return e


def _fir0(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """y[n] = 0 + sum_k h[:, k] x[n - k], x[<0] = 0, k in order."""
    C, N = x.shape
    y = np.zeros_like(x)
    for n in range(N):
        acc = np.zeros(C, F32)
        for k in range(h.shape[1]):
            v = x[:, n - k] if n - k >= 0 else np.zeros(C, F32)
            acc = acc + h[:, k] * v
        y[:, n] = acc
    return y


def _frame_kernel_order(mult, b, empties=2, stats=None):
    """One frame of `blanker_kernel` on the working buffers b (C, 154),
    in place; `empties`: the empty slots run after the found ones (the
    kernel's 2; 1 is the tempting collapse).  Appends to `stats` each
    channel's (candidates before the cap of 5, whether two of its slots
    are neighbours, whether two are fewer than 17 samples apart)."""
    ORD, IL, D = nb_k.ORDER, nb_k.IMPULSE_LEN, nb_k.DELAY
    C = b.shape[0]
    s = b[:, D:D + nb_k.FRAME]
    R = []
    for i in range(ORD + 1):
        t = np.concatenate([s[:, :128 - i] * s[:, i:], np.zeros((C, i), F32)],
                           axis=1)
        R.append(_pair_sum(_lanes(t)))
    e = _levinson(np.stack(R, 1))
    d = _fir0(_fir0(s, e[:, ::-1]), e)
    mean = _pair_sum(_lanes(d)) * F32(1.0 / 128)
    u = d - mean[:, None]
    sigma2 = _pair_sum(_lanes(u * u)) / F32(127.0)
    lpc = e[:, 0] * e[:, 0]
    for k in range(1, ORD):
        lpc = lpc + e[:, k] * e[:, k]
    v = sigma2 * lpc
    thr = F32(mult) * np.sqrt(np.where(np.isnan(v), v, np.fmax(v, F32(1e-30))))
    a = np.abs(d)
    pad = np.concatenate([np.zeros((C, 3), F32), a, np.zeros((C, 3), F32)], 1)
    win = np.stack([pad[:, q:q + 128] for q in range(7)], -1)
    mx = np.where(np.isnan(win).any(-1), np.nan, win.max(-1))
    cand = (a > thr[:, None]) & (a >= mx) & (np.arange(128) >= D)
    pos = [np.flatnonzero(c)[:nb_k.MAX_IMPULSES] for c in cand]
    if stats is not None:
        stats.extend((int(c.sum()), bool((np.diff(q) == 1).any()),
                      bool((np.diff(q) < 17).any()))
                     for c, q in zip(cand, pos))
    found = np.array([len(q) for q in pos])
    nsl = np.minimum(found + empties, nb_k.MAX_IMPULSES)
    af = -e[:, 1:]
    wb = np.arange(IL, dtype=F32) / F32(6.0)
    wf = F32(1.0) - wb
    rows = np.arange(C)
    pst = np.full(C, -1000)

    def cur(n, k):
        """The samples n (C, m) as slot k reads them."""
        v = b[rows[:, None], n]
        out = (k > 0) & ((n - pst[:, None] < 0) | (n - pst[:, None] >= IL))
        return np.where(out, _canon(v), v)

    for k in range(int(nsl.max())):
        act = k < nsl
        ok = k < found
        st = np.array([q[k] if k < len(q) else ORD for q in pos])
        st = np.where(ok, st, ORD)
        preds = []
        for near in (st[:, None] - 1 - np.arange(ORD),        # forward
                     st[:, None] + IL + np.arange(ORD)):      # backward
            uu = cur(near, k)
            out = []
            for _ in range(IL):
                nxt = uu[:, 0] * af[:, 0]
                for j in range(1, ORD):
                    nxt = nxt + uu[:, j] * af[:, j]
                uu = np.concatenate([nxt[:, None], uu[:, :-1]], 1)
                out.append(nxt)
            preds.append(np.stack(out, 1))
        fw, bw = preds[0], preds[1][:, ::-1]
        rep = wf * fw + wb * bw
        okf = ok.astype(F32)[:, None]
        n = st[:, None] + np.arange(IL)
        new = cur(n, k) * (F32(1.0) - okf) + okf * rep
        b[rows[act][:, None], n[act]] = new[act]
        pst = np.where(act, st, pst)
    allpos = np.broadcast_to(np.arange(nb_k.WB), b.shape)
    outside = (allpos - pst[:, None] < 0) | (allpos - pst[:, None] >= IL)
    b[...] = np.where(outside, _canon(b), b)


def _blanker_kernel_order(mult, ctx, x, empties=2, stats=None):
    outs = []
    for f in range(x.shape[1] // nb_k.FRAME):
        b = np.concatenate([ctx, x[:, f * 128:(f + 1) * 128]], 1)
        _frame_kernel_order(mult, b, empties, stats)
        outs.append(b[:, nb_k.DELAY:nb_k.DELAY + 128])
        ctx = b[:, 128:].copy()
    return np.concatenate(outs, 1), ctx


def _nb_frames(rng, C, n0, T):
    """Impulsive audio by channel class c % 8: 0 two tones and noise with
    impulses every ~97 samples and at the frames' edges; 1 a quiet tone
    (no impulse); 2 one impulse a frame; 3 four a frame, 9 apart (slots
    within 17); 4 five a frame; 5 seven a frame; 6 silence but for
    (A, A) at 60 and (A, -A) at 90, whose lags 1-10 cancel, so that e is
    (1, -0, ...), d the frame itself and each pair two tied candidates;
    7 class 0 with edge values."""
    n = np.arange(n0, n0 + T)
    x = (800.0 * np.sin(2 * np.pi * 550 / 12000 * n)
         + 300.0 * np.sin(2 * np.pi * 1230 / 12000 * n + 0.7)
         + 60.0 * rng.standard_normal((C, T)))
    cls = np.arange(C) % 8
    amp = rng.uniform(4000, 9000, (C, T)) * rng.choice([-1.0, 1.0], (C, T))
    fr = n % 128
    hits = {0: (n % 97 == 5) | (fr == 126) | (fr == 2),
            2: fr == 70,
            3: np.isin(fr, (40, 49, 58, 67)),
            4: np.isin(fr, (20, 40, 60, 80, 100)),
            5: np.isin(fr, (16, 30, 44, 58, 72, 86, 100)),
            7: (n % 97 == 5) | (fr == 126)}
    x[cls == 1] = 0.2 * np.sin(2 * np.pi * 700 / 12000 * n)
    for c in range(C):
        k = cls[c]
        if k in hits:
            x[c, hits[k]] += amp[c, hits[k]] * (8.0 if k in (2, 3, 4, 5) else
                                                1.0)
        if k == 6:
            x[c] = 0.0
            x[c, np.isin(fr, (60, 61, 90))] = 5000.0
            x[c, fr == 91] = -5000.0
    x = x.astype(F32)
    seven = np.flatnonzero(cls == 7)
    x[seven] = _lms_edges(rng, x[seven], n0)
    return x


@pytest.mark.parametrize("setting", [8, 15])
def test_blanker_order_is_the_plain_blanker(setting):
    from uhsdr_tpu_torch.nr import blanker as nb_mod
    mult = nb_mod.make_params(setting).threshold_mult
    rng = np.random.default_rng(300 + setting)
    C = 24
    ctx = np.zeros((C, nb_k.CONTEXT), F32)
    ctx[5, 20] = np.nan                      # a NaN in a carried context
    ctx[13] = F32(-0.0)
    cp, n0, stats = torch.from_numpy(ctx.copy()), 0, []
    with np.errstate(all="ignore"):
        for T in (384, 256):
            x = _nb_frames(rng, C, n0, T)
            y, ctx = _blanker_kernel_order(mult, ctx, x, stats=stats)
            yp, cp = nb_k.blanker_plain(mult, cp, torch.from_numpy(x))
            assert _same(y, yp.numpy()), T
            assert _same(ctx, cp.numpy()), T
            n0 += T
    counts = {n for n, _, _ in stats}
    assert any(t for _, t, _ in stats) and any(c for _, _, c in stats)
    # `candidates`, the count chip_smoke.py reports, is the plain frames'
    x = _nb_frames(np.random.default_rng(301), C, 0, 256)
    got = []
    with np.errstate(all="ignore"):
        _blanker_kernel_order(mult, np.zeros((C, nb_k.CONTEXT), F32), x,
                              stats=got)
    found = nb_k.candidates(mult, torch.zeros((C, nb_k.CONTEXT)),
                            torch.from_numpy(x))
    assert found.T.reshape(-1).tolist() == [n for n, _, _ in got]
    assert {0, 1, 4, 5} <= counts if setting == 8 else 7 in counts, counts


def _ar10_frames(rng, C):
    """One frame a channel of an AR(10) process with positive coefficients
    (the predictor's weights -e[1:] come out positive), its first sample
    and the whole context -0."""
    a = np.array([0.3, 0.2, 0.15, 0.1, 0.08, 0.06, 0.04, 0.03, 0.02, 0.01])
    z = np.zeros((C, 128 + 200))
    nz = rng.standard_normal(z.shape)
    for n in range(10, z.shape[1]):
        z[:, n] = z[:, n - 10:n][:, ::-1] @ a + nz[:, n]
    x = z[:, -128:].astype(F32)
    x[:, 0] = F32(-0.0)
    return np.full((C, nb_k.CONTEXT), F32(-0.0)), x


def test_one_empty_slot_is_not_the_blanker():
    """Where a frame's first empty slot meets a context of -0 and every
    product of its predictions is -0, its blend leaves -0 in b[13..16]
    and turns the contexts to +0; the second empty slot's +0 prediction
    then turns those samples to +0.  The kernel's two empty slots hold
    the plain blanker; one empty slot gives -0 there."""
    from uhsdr_tpu_torch.nr import blanker as nb_mod
    mult = nb_mod.make_params(0).threshold_mult
    assert mult == 8.0
    ctx, x = _ar10_frames(np.random.default_rng(400), 2000)
    with np.errstate(all="ignore"):
        y2, c2 = _blanker_kernel_order(mult, ctx.copy(), x)
        y1, c1 = _blanker_kernel_order(mult, ctx.copy(), x, empties=1)
    yp, cp = nb_k.blanker_plain(mult, torch.from_numpy(ctx),
                                torch.from_numpy(x))
    assert _same(y2, yp.numpy()) and _same(c2, cp.numpy())
    differ = y1.view(np.int32) != yp.numpy().view(np.int32)
    assert differ.any()
    assert not differ[:, 4:].any()           # only b[13..16]
    assert (np.signbit(y1[differ]) & (y1[differ] == 0)).all()


# ---------------------------------------------------------------------------
# the sources
# ---------------------------------------------------------------------------

def test_sources_hold_the_mirrored_layouts():
    text = lms_k.LMS.source_text()
    c = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert int(c["LK_LANES"]) == lms_k.LEAKY_LANES
    assert int(c["LK_VL"]) == lms_k.LANES
    assert int(c["LK_WARPS"]) == lms_k.LEAKY_WARPS
    assert int(c["LK_GROUP"]) == lms_k.LEAKY_GROUP
    assert int(c["LK_TILE"]) == lms_k.LEAKY_TILE
    assert int(c["NL_LANES"]) == lms_k.NLMS_LANES
    assert "-fmad=false" in lms_k.LMS.flags
    assert "lms_launch<8, LANES, MODE>" in text
    assert "lms_launch<12, LANES, MODE>" in text
    assert "lms_launch_taps<LK_LANES, LEAKY>" in text
    text = nb_k.BLANKER.source_text()
    c = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert int(c["LANES"]) == nb_k.KERNEL_LANES
    assert int(c["VL"]) == nb_k.LANES
    assert int(c["WARPS"]) == nb_k.WARPS
    assert (2 * int(c["BS"]) + int(c["TS"]) + int(c["AS"])
            == nb_k.ROW_FLOATS)
    assert "-fmad=false" in nb_k.BLANKER.flags
