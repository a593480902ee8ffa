"""K2's launch geometry (`cuda/iir.py::blocked_geometry`, the rule the
`kernels/blocked.cu` launcher takes its channels a block from) over every
shape the port sends K2, and K2's schedule.

The rule is pure Python, so it is checked here on the CPU: every cascade
shape of the chains and the fleets (the PreFilter at 8192 and 1024
channels, as 2 x C rows for the two-channel modes; FM's squelch HPF at 96
and 48 kHz; the TX voice bandpass; the wideband groups of 2730 and 1366
channels), and S = 1, 2, 5, 8 at T = 256 and 16384, fit an SM's shared
memory, and the grid's waves of resident blocks leave a slot no more
than a tenth above the fewest rows any allowed launch gives (from 1024
channels up, about two blocks of four warps an SM or more); a shape the
kernel does not take is refused with a
ValueError before any launch, through the wrapper on meta tensors too.

A NumPy walk of the kernel's schedule in float32 (FMAs as the card rounds
them: the exact product held in float64, one rounding): the rows of a
round (cpw channels x tr chunks) staged into a tile by each warp's pair of
items, the x G partial sums of each warp over its own columns added in
warp order, the in-order carry u_c = x_c G + u_{c-1} F^T chunk by chunk
across rounds, and the triangles through the 8-slot register window (the
diagonal chunk's 36 products only) plus u_{c-1} HS.  Unstaged tile cells
are NaN, so a read of a column no warp loaded shows.  The walk is held
against `blocked_cascade_plain` and against the TPU kernel
(`uhsdr_tpu.pallas.iir.biquad_cascade_blocked_pallas`, interpret mode)
over three streamed blocks, and two geometries of one shape (and channels
run alone) give the same bits.  The card checks that the library computes
the same shared memory and that the kernel matches its plain version
(tests/test_torch_cuda.py, chip_smoke.py's K2 phase).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal

from uhsdr_tpu.pallas import iir as piir
from uhsdr_tpu_torch.chain import rx, tx
from uhsdr_tpu_torch.cuda import iir as iir_k
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.ops import iir
from uhsdr_tpu_torch.parallel import fleet as pfleet

R = iir_k.BLOCKED_R
NW = iir_k.BLOCKED_WARPS
LANES = iir_k.BLOCKED_LANES
XS = iir_k.BLOCKED_ROW_STRIDE
RO = iir_k.BLOCKED_RO
ITEMS = R // RO
# the walk against the plain version and the TPU kernel (all three sum the
# same f32 products in other orders): the PreFilter as tests/
# test_torch_blocked.py holds the plain version to the TPU kernel; SOPRANO's
# poles at radius 0.998 amplify f32 rounding (the two f32 forms sit 94-110
# dB apart there, ibid.), so 90 dB, K2's card bound
TOL_DB = {"prefilter": 100.0, "squelch": 100.0, "butter1": 100.0,
          "butter8": 100.0, "soprano": 90.0}


# ---------------------------------------------------------------------------
# the shapes
# ---------------------------------------------------------------------------

def _rx_k2(cfg) -> set:
    """{(rows a channel, T, S)} of the cascades `cfg`'s chain sends K2."""
    p = rx.make_params(cfg, "cpu")
    T = cfg.block_len // cfg.decim
    rows = 2 if (cfg.mode in ("iq", "ssbstereo")
                 or cfg.sam_sideband == "stereo") else 1
    out = {(rows, T, c.sections)
           for c in (p.audio_sos, p.eq1_sos, p.aa_sos, p.eq2_sos)
           if c.sections}
    if cfg.mode == "fm":
        out.add((1, T, p.fm.squelch_sos.sections))
    return out


# (label, channels, config(s)) of every path of the port that runs K2
PATHS = (
    ("ssb", 8192, (rx.FLAGSHIP,)),
    ("am_sam", 8192, (rx.SAM_FLAGSHIP,)),
    ("ssbstereo", 8192, (rx.STEREO_FLAGSHIP,)),
    ("fm", 8192, (rx.FM_FLAGSHIP,)),
    ("fm_sql_1024", 1024, (dataclasses.replace(rx.FM_FLAGSHIP,
                                               sql_threshold=10,
                                               subtone_hz=88.5),)),
    ("iq_1024", 1024, (dataclasses.replace(rx.STEREO_FLAGSHIP,
                                           mode="iq"),)),
    ("sam_stereo_1024", 1024, (dataclasses.replace(rx.SAM_FLAGSHIP,
                                                   sam_sideband="stereo"),)),
    ("fleet", pfleet.FLEET_GROUP_CHANNELS, pfleet.FLEET_MIX),
    ("wideband_usb", pfleet.wideband_counts()[0], pfleet.WIDEBAND_MIX[:1]),
    ("wideband_am", pfleet.wideband_counts()[1], pfleet.WIDEBAND_MIX[1:]),
)
# {label: {(C, T, S)}}: what the configurations give (checked below)
WANT = {
    "ssb": {(8192, 2048, 5)},
    "am_sam": {(8192, 4096, 5)},
    "ssbstereo": {(16384, 2048, 5)},
    "fm": {(8192, 8192, 2)},
    "fm_sql_1024": {(1024, 8192, 2)},
    "iq_1024": {(2048, 2048, 5)},
    "sam_stereo_1024": {(2048, 4096, 5)},
    "fleet": {(1024, 4096, 5), (1024, 16384, 2)},
    "wideband_usb": {(2730, 1024, 5)},
    "wideband_am": {(1366, 2048, 5)},
    # the TX voice bandpass, at the flagship and at 1024 channels
    "tx": {(8192, 16384, 5), (1024, 16384, 5)},
}


def _all_shapes() -> set:
    out = set()
    for shapes in WANT.values():
        out |= shapes
    for S in (1, 2, 5, 8):
        for T in (256, 16384):
            for C in (1, 3, 1000, 1024, 8192):
                out.add((C, T, S))
    return out


def test_the_port_sends_these_shapes():
    for label, C, cfgs in PATHS:
        got = {(C * rows, T, S) for cfg in cfgs for rows, T, S in
               _rx_k2(cfg)}
        assert got == WANT[label], label
    p = tx.make_params(tx.TX_FLAGSHIP, "cpu")
    assert {(C, tx.TX_FLAGSHIP.block_len, p.voice_sos.sections)
            for C in (8192, 1024)} == WANT["tx"]


def _rows(C: int, cpw: int, slots: int) -> int:
    """Rows a resident slot walks: the grid's waves x a block's channels."""
    return -(-(-(-C // cpw)) // slots) * cpw


@pytest.mark.parametrize("C,T,S", sorted(_all_shapes()))
def test_every_shape_fits_and_fills_the_card(C, T, S):
    geo = iir_k.blocked_geometry(C, T, S)
    n = T // R
    assert geo.smem == iir_k.blocked_smem(S)
    assert geo.smem + iir_k.BLOCK_RESERVED <= iir_k.SM_SMEM
    assert geo.resident >= 2          # two blocks of 4 warps an SM at least
    # the rows of a round: cpw channels x tr chunks, tr no more than the
    # chunks a channel has (nor BLOCKED_MAX_TR)
    assert geo.cpw * geo.tr == LANES and geo.cpw & (geo.cpw - 1) == 0
    assert geo.tr <= max(1, min(n, iir_k.BLOCKED_MAX_TR))
    assert geo.blocks == -(-C // geo.cpw)
    assert geo.rounds == -(-n // geo.tr)
    # the waves: a slot walks no more than a tenth above the fewest rows
    # any allowed cpw gives, and no larger cpw is within that tenth
    slots = geo.resident * iir_k.BLOCKED_SMS
    tr_max = min(iir_k.BLOCKED_MAX_TR, 1 << (n.bit_length() - 1))
    allowed = [c for c in (32, 16, 8, 4, 2, 1) if c * tr_max >= LANES]
    best = min(_rows(C, c, slots) for c in allowed)
    assert 10 * _rows(C, geo.cpw, slots) <= 11 * best
    assert all(10 * _rows(C, c, slots) > 11 * best
               for c in allowed if c > geo.cpw)
    # from 1024 channels of 8 chunks up, every SM holds about two blocks of
    # four warps or more
    if C >= 1024 and n >= 8:
        assert geo.blocks >= 256
        assert min(geo.blocks / iir_k.BLOCKED_SMS, geo.resident) * NW >= 7.75


@pytest.mark.parametrize("C,T,S,want", [
    (8192, 2048, 5, (8, 4, 4, 1024, 75920, 3)),     # the SSB PreFilter
    (16384, 2048, 5, (16, 2, 8, 1024, 75920, 3)),   # ssbstereo's 2C rows
    (8192, 8192, 2, (8, 4, 16, 1024, 61760, 3)),    # FM's squelch HPF
    (8192, 16384, 5, (8, 4, 32, 1024, 75920, 3)),   # the TX voice SOS
    (1024, 4096, 5, (4, 8, 4, 256, 75920, 3)),      # the fleet's PreFilter
    (1024, 16384, 2, (4, 8, 16, 256, 61760, 3)),    # the fleet's squelch
    (2730, 1024, 5, (8, 4, 2, 342, 75920, 3)),      # wideband usb
    (1366, 2048, 5, (4, 8, 2, 342, 75920, 3)),      # wideband am
    (8, 2048, 5, (4, 8, 2, 2, 75920, 3)),           # channels 0-7 alone
    (3, 256, 8, (16, 2, 1, 1, 90368, 2))])
def test_named_geometries(C, T, S, want):
    """At 8192 channels a block takes 8 channels, 4 chunks a round: 1024
    blocks in waves of 396 (three blocks of 4 warps on each of the 132
    SMs), 24 rows a slot, where 32 channels a block would leave 140 of
    the 396 slots empty (32 rows a slot) and 16 would run a second wave
    29% full (32 rows); at 1024 channels 4 channels and 8 chunks a round:
    256 blocks (32 channels a block would leave 100 SMs idle)."""
    assert tuple(iir_k.blocked_geometry(C, T, S)) == want


@pytest.mark.parametrize("C,T,S", [
    (8, 2048, 9),         # past the state registers and shared tables
    (8, 2048, 0),
    (8, 200, 5),          # not a multiple of the chunk
    (8, 0, 5)])
def test_shapes_the_kernel_does_not_take_are_refused(C, T, S):
    with pytest.raises(ValueError):
        iir_k.blocked_geometry(C, T, S)


def test_wrapper_refuses_before_any_launch():
    """`blocked_cascade` on tensors off the CPU checks the geometry before
    it loads or launches anything: meta tensors stand in for the card's."""
    meta = dict(device="meta")

    def cascade(S):
        return iir.Cascade(torch.empty((S, 5), **meta),
                           torch.empty((R, R), **meta),
                           torch.empty((2 * S, R), **meta),
                           torch.empty((R, 2 * S), **meta),
                           torch.empty((2 * S, 2 * S), **meta))
    x = torch.empty((4, 2048), **meta)
    with pytest.raises(ValueError, match="sections"):
        iir_k.blocked_cascade(cascade(9), torch.empty((9, 4, 2), **meta), x)
    with pytest.raises(ValueError, match="multiple"):
        iir_k.blocked_cascade(cascade(5), torch.empty((5, 4, 2), **meta),
                              torch.empty((4, 200), **meta))
    with pytest.raises(ValueError, match="state"):
        iir_k.blocked_cascade(cascade(5), torch.empty((5, 3, 2), **meta), x)


def test_smem_is_the_layout():
    """The shared memory: the tables (h, HS, G^T, F^T), two rounds of
    partial sums and of u_{c-1} at rows of 2S + 1 floats and three tiles
    of 32 rows of 132 floats."""
    for S in range(1, 9):
        U = 2 * S
        floats = (R + 2 * U * R + -(-U * U // 4) * 4
                  + -(-2 * NW * LANES * (U + 1) // 4) * 4
                  + -(-2 * LANES * (U + 1) // 4) * 4 + 3 * LANES * XS)
        assert iir_k.blocked_smem(S) == 4 * floats


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """fmaf: a * b + c rounded once to float32 (float64 holds the product
    of two floats exactly)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _pair_cols(p: int) -> np.ndarray:
    return np.concatenate([RO * p + np.arange(RO),
                           RO * (ITEMS - 1 - p) + np.arange(RO)])


def _warp_pairs(w: int) -> list:
    return list(range(w, ITEMS // 2, NW))


def _walk(c: iir.Cascade, state: np.ndarray, x: np.ndarray, geo):
    """K2's schedule on one block in NumPy float32: state (S, C, 2), x
    (C, T).  Returns (y (C, T), new state (S, C, 2))."""
    S = c.sections
    U = 2 * S
    C, T = x.shape
    n = T // R
    h = c.M.numpy()[0]
    HS, GT, Ft = c.HS.numpy(), c.G.numpy().T.copy(), c.Ft.numpy()
    cpw, tr = geo.cpw, geo.tr
    u0 = np.moveaxis(state, 0, -2).reshape(C, U).astype(np.float32)
    y = np.full((C, T), np.nan, np.float32)
    new = np.full((C, U), np.nan, np.float32)
    lane = np.arange(LANES)
    for blk in range(geo.blocks):
        c0 = blk * cpw
        chl = np.arange(cpw)
        uend = np.zeros((cpw, U), np.float32)
        ok = c0 + chl < C
        uend[ok] = u0[c0 + chl[ok]]
        for m in range(geo.rounds):
            ch = c0 + lane // tr
            ck = m * tr + lane % tr
            valid = (ch < C) & (ck < n)
            # the tile: each warp stages its pairs' columns of every row
            tile = np.full((LANES, XS), np.nan, np.float32)
            for w in range(NW):
                for p in _warp_pairs(w):
                    cols = _pair_cols(p)
                    for k in np.flatnonzero(valid):
                        tile[k, cols] = x[ch[k], ck[k] * R + cols]
            # each warp's x G partial sums over its own columns
            part = np.zeros((NW, LANES, U), np.float32)
            for w in range(NW):
                g = np.zeros((LANES, U), np.float32)
                for p in _warp_pairs(w):
                    for b in (p, ITEMS - 1 - p):
                        s0 = RO * b
                        for i in range(U):
                            for r in range(RO):
                                g[:, i] = _fma(tile[:, s0 + r],
                                               GT[i, s0 + r], g[:, i])
                part[w] = g
            # the in-order carry, chunk by chunk: every channel of the
            # round at once, its tr rows one after another
            uprev = np.full((LANES, U), np.nan, np.float32)
            tv = min(tr, n - m * tr)
            u = uend.copy()
            for t in range(tv):
                rows = chl * tr + t
                uprev[rows] = u
                acc = part[0, rows]
                for w in range(1, NW):
                    acc = acc + part[w, rows]
                for j in range(U):
                    acc = _fma(u[:, j:j + 1], Ft[j], acc)
                u = acc
            uend = u
            # the triangles, through the register window
            for b in range(ITEMS):
                s0 = RO * b
                a = np.zeros((LANES, RO), np.float32)
                win = tile[:, s0:s0 + RO].copy()
                for k0 in range(0, s0, RO):
                    xw = s0 - k0
                    for j in range(RO):
                        slots = (np.arange(RO) - j) % RO
                        a = _fma(h[k0 + j], win[:, slots], a)
                        win[:, (RO - 1 - j) % RO] = tile[:, xw - j - 1]
                for j in range(RO):                   # the diagonal
                    r = np.arange(j, RO)
                    a[:, r] = _fma(h[s0 + j], win[:, r - j], a[:, r])
                for j in range(U):
                    a = _fma(uprev[:, j:j + 1], HS[j, s0:s0 + RO], a)
                for k in np.flatnonzero(valid):
                    y[ch[k], ck[k] * R + s0:ck[k] * R + s0 + RO] = a[k]
        new[c0 + chl[ok]] = uend[ok]
    return y, np.moveaxis(new.reshape(C, S, 2), -2, 0)


def _sos(name: str) -> np.ndarray:
    if name == "prefilter":
        return rx._lattice_sos5(rx.RxConfig(
            mode="usb", bw_key="2P3KHZ", path_name="LPF",
            translate_hz=12000.0, iq_rate=96000.0).ref_path["pre"])
    if name == "soprano":
        return tx._lattice_sos5("IIR_TX_SOPRANO")
    if name == "squelch":
        return rx.make_params(rx.FM_FLAGSHIP, "cpu").fm.squelch_sos.sos \
            .numpy()
    order = {"butter1": 2, "butter8": 16}[name]
    sos = signal.butter(order, 0.05, output="sos")
    return np.concatenate([sos[:, :3], sos[:, 4:]], axis=1)


@pytest.mark.parametrize("name,C,lengths,sms", [
    # tr = 16 (3 channels a block of 32 rows), a ragged last round
    ("prefilter", 3, (512, 2176, 256), iir_k.BLOCKED_SMS),
    # one chunk a round, 32 channels a block, the last block short
    ("prefilter", 40, (256, 384, 256), 1),
    ("soprano", 5, (1024, 384, 640), iir_k.BLOCKED_SMS),
    ("squelch", 9, (768, 256, 1280), 4),
    ("butter1", 6, (256, 512, 384), iir_k.BLOCKED_SMS),
    ("butter8", 7, (384, 256, 1024), 2)])
def test_schedule_is_the_plain_version_and_the_tpu_kernel(name, C, lengths,
                                                          sms):
    c = iir.cascade(_sos(name), "cpu")
    S = c.sections
    rng = np.random.default_rng(C + S)
    sw = np.zeros((S, C, 2), np.float32)
    sp = torch.zeros((S, C, 2))
    sj = jnp.zeros((S, C, 2), jnp.float32)
    worst = np.inf
    for T in lengths:
        x = (rng.standard_normal((C, T)) * 0.1).astype(np.float32)
        geo = iir_k.blocked_geometry(C, T, S, sms)
        yw, sw = _walk(c, sw, x, geo)
        yp, sp = iir_k.blocked_cascade_plain(c, sp, torch.from_numpy(x))
        yj, sj = piir.biquad_cascade_blocked_pallas(
            np.asarray(c.sos), sj, jnp.asarray(x), interpret=True)
        assert np.isfinite(yw).all() and np.isfinite(sw).all()
        for ref in ((yp, sp), (np.asarray(yj), np.asarray(sj))):
            worst = min(worst, snr_db(ref[0], yw), snr_db(ref[1], sw))
        assert worst >= TOL_DB[name], (T, worst)
    print(f"\n{name}, {C} ch, {lengths}: walk against the plain version "
          f"and the TPU kernel, worst {worst:.1f} dB")


def _launch(C: int, T: int, S: int, cpw: int):
    """The kernel's launch at C, T and S with cpw channels a block (any
    power of two up to 32: the kernel takes what the rule does not
    pick)."""
    geo = iir_k.blocked_geometry(C, T, S)
    n, tr = T // R, LANES // cpw
    return geo._replace(cpw=cpw, tr=tr, rounds=-(-n // tr),
                        blocks=-(-C // cpw))


def test_geometry_changes_no_bit():
    """Three launches of one shape (32 channels a block one chunk at a
    time, 2 channels a block 16 chunks a round, and the rule's), and
    channels 0-7 run alone, give the same bits: no sum's order depends on
    the geometry or on the other channels of the launch."""
    c = iir.cascade(_sos("prefilter"), "cpu")
    S, C, T = c.sections, 40, 2048
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((C, T)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((S, C, 2)) * 1e-3).astype(np.float32)
    ya, sa = _walk(c, s0, x, _launch(C, T, S, 32))
    for geo in (_launch(C, T, S, 2), iir_k.blocked_geometry(C, T, S)):
        yb, sb = _walk(c, s0, x, geo)
        np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(sa, sb)
    yc, sc = _walk(c, s0[:, :8], x[:8], iir_k.blocked_geometry(8, T, S))
    np.testing.assert_array_equal(ya[:8], yc)
    np.testing.assert_array_equal(sa[:, :8], sc)
