"""K14, the grouped biquad scan: its plain version
(`cuda/iir.py::biquad_grouped_plain`, what `biquad_cascade(impl=
"grouped")` runs on CPU tensors) against the TPU kernel it replaces,
`uhsdr_tpu.pallas.iir.biquad_cascade_pallas(impl="grouped")` in interpret
mode, and against the sequential form (K11's plain version), on SAM's
two 7-section z^-2 allpass sets (`uhsdr_tpu.demod.sam._AP_COEFFS`).

The port tiles as the TPU kernel does at t_tile = 32 L: a tile of 32
groups of L samples (a lane each on the card), the state carried from
tile to tile, any T (a ragged last tile padded with zeros; no limit on
the groups a block).  Held to SNR >= 90 dB on output and state: against
the TPU kernel at its default 128-sample tiles over a streamed split
(two blocks of 256, and a ragged split 200 + 312 whose first block ends
inside a group) and at t_tile = 32 L (L = 16 and 32, two tiles, the port
also streamed in a split whose first block ends inside a group and a
tile), and against the sequential recurrence, also past the 512 groups
PR 5's kernel took.  `-s` prints the values: 137-142 dB against the TPU
kernel at either tiling (the interpret mode runs on XLA's CPU backend,
which contracts each product and sum into an FMA, so the two part in
rounding at every step, not only where the tilings differ; the port's
kernel keeps them apart, -fmad=false), 116-125 dB against the
sequential recurrence, which itself sits about 120 dB from float64 on
these poles: ROADMAP section C.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uhsdr_tpu.demod import sam as jsam
from uhsdr_tpu.pallas import iir as piir
from uhsdr_tpu_torch.cuda import iir as iir_k
from uhsdr_tpu_torch.metrics import snr_db

TOL_DB = 90.0
C, T = 16, 512


def _x(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((C, T)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("coeff_set", [0, 1])
def test_grouped_plain_matches_pallas_grouped(coeff_set):
    sos = np.asarray(jsam._AP_COEFFS[coeff_set], np.float32)
    S = sos.shape[0]
    x = _x(20 + coeff_set)
    sj = jnp.zeros((S, C, 2), jnp.float32)
    st = torch.zeros((S, C, 2))
    for a, b in ((0, 256), (256, T)):
        yj, sj = piir.biquad_cascade_pallas(sos, sj, jnp.asarray(x[:, a:b]),
                                            impl="grouped")
        yt, st = iir_k.biquad_cascade(torch.from_numpy(sos), st,
                                      torch.from_numpy(x[:, a:b]),
                                      impl="grouped")
        s_y, s_s = snr_db(np.asarray(yj), yt), snr_db(np.asarray(sj), st)
        print(f"\nallpass set {coeff_set}, samples {a}-{b}: K14 plain vs "
              f"the Pallas grouped kernel: output {s_y:.1f} dB, states "
              f"{s_s:.1f} dB")
        assert min(s_y, s_s) >= TOL_DB
    # a ragged split through the port against the kernel's whole block
    yj, sj = piir.biquad_cascade_pallas(sos, jnp.zeros((S, C, 2)),
                                        jnp.asarray(x), impl="grouped")
    st = torch.zeros((S, C, 2))
    ys = []
    for a, b in ((0, 200), (200, T)):
        y, st = iir_k.biquad_cascade(torch.from_numpy(sos), st,
                                     torch.from_numpy(x[:, a:b]),
                                     impl="grouped")
        ys.append(y)
    s_y, s_s = snr_db(np.asarray(yj), torch.cat(ys, -1)), snr_db(
        np.asarray(sj), st)
    print(f"allpass set {coeff_set}, ragged 200 + 312: output {s_y:.1f} dB, "
          f"states {s_s:.1f} dB")
    assert min(s_y, s_s) >= TOL_DB


@pytest.mark.parametrize("coeff_set,group_len", [(0, 32), (1, 32), (0, 16),
                                                 (1, 64)])
def test_grouped_plain_matches_sequential(coeff_set, group_len):
    """The two-level scan against K11's recurrence, from a nonzero state,
    at each group length K14 is built for."""
    sos = torch.from_numpy(np.asarray(jsam._AP_COEFFS[coeff_set],
                                      np.float32))
    S = sos.shape[0]
    rng = np.random.default_rng(30 + group_len)
    s0 = torch.from_numpy((rng.standard_normal((S, C, 2)) * 1e-2)
                          .astype(np.float32))
    x = torch.from_numpy(_x(40 + coeff_set))
    yg, sg = iir_k.biquad_cascade(sos, s0, x, impl="grouped",
                                  group_len=group_len)
    yq, sq = iir_k.biquad_cascade(sos, s0, x)
    s_y, s_s = snr_db(yq, yg), snr_db(sq, sg)
    print(f"\nallpass set {coeff_set}, L = {group_len}: K14 plain vs the "
          f"sequential recurrence: output {s_y:.1f} dB, states {s_s:.1f} dB")
    assert min(s_y, s_s) >= TOL_DB


def test_grouped_refuses_unknown_impl():
    sos = torch.from_numpy(np.asarray(jsam._AP_COEFFS[0], np.float32))
    with pytest.raises(ValueError, match="impl"):
        iir_k.biquad_cascade(sos, torch.zeros((7, C, 2)),
                             torch.zeros((C, 64)), impl="dilated")


def _pallas_tiled(sos, s0, x, L):
    yj, sj = piir.biquad_cascade_pallas(sos, jnp.asarray(s0), jnp.asarray(x),
                                        t_tile=32 * L, impl="grouped",
                                        group_len=L)
    return np.asarray(yj), np.asarray(sj)


def _streamed(sos, s0, x, splits, **kw):
    st, ys = torch.from_numpy(s0), []
    for a, b in zip((0,) + splits, splits + (x.shape[-1],)):
        y, st = iir_k.biquad_cascade(torch.from_numpy(sos), st,
                                     torch.from_numpy(x[:, a:b]), **kw)
        ys.append(y)
    return torch.cat(ys, -1), st


@pytest.mark.parametrize("coeff_set,group_len,C,T,split", [
    (0, 16, 16, 1024, 700), (1, 32, 8, 2048, 1000)])
def test_grouped_plain_matches_pallas_at_tile_32L(coeff_set, group_len, C, T,
                                                   split):
    """The plain version against the TPU kernel at the port's own tiling,
    t_tile = 32 L (two tiles), from a nonzero state: as one block, and
    streamed in two blocks whose first ends inside a group and inside a
    tile (700 = 43 x 16 + 12, 1000 = 31 x 32 + 8)."""
    sos = np.asarray(jsam._AP_COEFFS[coeff_set], np.float32)
    S = sos.shape[0]
    rng = np.random.default_rng(50 + group_len)
    x = (rng.standard_normal((C, T)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((S, C, 2)) * 1e-2).astype(np.float32)
    yj, sj = _pallas_tiled(sos, s0, x, group_len)
    for label, splits in (("one block", ()), (f"{split} + {T - split}",
                                              (split,))):
        yt, st = _streamed(sos, s0, x, splits, impl="grouped",
                           group_len=group_len)
        s_y, s_s = snr_db(yj, yt), snr_db(sj, st)
        print(f"\nallpass set {coeff_set}, L = {group_len}, {label}: K14 "
              f"plain vs the Pallas grouped kernel at t_tile {32 * group_len}"
              f": output {s_y:.1f} dB, states {s_s:.1f} dB")
        assert yt.shape == (C, T) and st.shape == (S, C, 2)
        assert min(s_y, s_s) >= TOL_DB


def test_grouped_plain_past_512_groups():
    """513 groups of 16 (PR 5's kernel took at most 512) on 4 rows: 17
    tiles, the last of one group, against the sequential recurrence."""
    sos = torch.from_numpy(np.asarray(jsam._AP_COEFFS[0], np.float32))
    S, C, T = sos.shape[0], 4, 513 * 16
    rng = np.random.default_rng(60)
    x = torch.from_numpy((rng.standard_normal((C, T)) * 0.1)
                         .astype(np.float32))
    s0 = torch.from_numpy((rng.standard_normal((S, C, 2)) * 1e-2)
                          .astype(np.float32))
    yg, sg = iir_k.biquad_cascade(sos, s0, x, impl="grouped", group_len=16)
    yq, sq = iir_k.biquad_cascade(sos, s0, x)
    s_y, s_s = snr_db(yq, yg), snr_db(sq, sg)
    print(f"\n513 groups of 16: K14 plain vs the sequential recurrence: "
          f"output {s_y:.1f} dB, states {s_s:.1f} dB")
    assert yg.shape == (C, T) and min(s_y, s_s) >= TOL_DB


@pytest.mark.parametrize("group_len", [16, 32])
def test_grouped_plain_streamed_split_is_the_sequence(group_len):
    """A split whose first block ends inside a group and inside a tile
    (and a one-sample block) against the sequential recurrence over the
    same split."""
    sos_np = np.asarray(jsam._AP_COEFFS[1], np.float32)
    S, C, T = sos_np.shape[0], 6, 1500
    rng = np.random.default_rng(70 + group_len)
    x = (rng.standard_normal((C, T)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((S, C, 2)) * 1e-2).astype(np.float32)
    splits = (32 * group_len - 5, 32 * group_len - 4)
    yg, sg = _streamed(sos_np, s0, x, splits, impl="grouped",
                       group_len=group_len)
    yq, sq = _streamed(sos_np, s0, x, splits)
    s_y, s_s = snr_db(yq, yg), snr_db(sq, sg)
    print(f"\nL = {group_len}, split {splits}: K14 plain vs the sequential "
          f"recurrence: output {s_y:.1f} dB, states {s_s:.1f} dB")
    assert min(s_y, s_s) >= TOL_DB


@pytest.mark.parametrize("L", [16, 32, 64])
def test_grouped_geometry_fills_the_card(L):
    """K14's launch rule: four warps a block at 16384 rows (4096 blocks),
    fewer for a narrow launch so it spreads over the SMs, and the blocks
    an SM is built for fit its shared memory at every section count."""
    geo = iir_k.grouped_geometry(16384, 4096, L, 7)
    assert (geo.warps, geo.blocks, geo.tile) == (4, 4096, 32 * L)
    assert geo.tiles == -(-4096 // (32 * L))
    assert iir_k.grouped_geometry(40, 1000, L, 7, sms=132).warps == 1
    assert iir_k.grouped_geometry(300, 1000, L, 7, sms=132).warps == 3
    for S in range(1, 9):
        smem = iir_k.grouped_smem(L, S, 4)
        assert geo.resident * (smem + iir_k.BLOCK_RESERVED) <= iir_k.SM_SMEM
    with pytest.raises(ValueError):
        iir_k.grouped_geometry(16, 100, 48, 7)
    with pytest.raises(ValueError):
        iir_k.grouped_geometry(16, 100, 32, 9)
