"""K4's launch geometry (`cuda/fir.py::interp_geometry`, the rule the
`kernels/interp.cu` launcher follows) over every shape the port sends K4,
and a NumPy walk of the kernel's schedule.

The rule is pure Python, so it is checked here on the CPU: every (L,
taps) the reference-table chains reach at 48, 96 and 192 kHz has an
instance of its own (x2 and x4 at 48 kHz, x4 and x8 at 96, x8 and x16 at
192; the legacy front's 16 taps a phase take the generic one), at their block
lengths and at ragged ones, the fleet's 5120 rows and the wideband
groups; each fits the card's opt-in shared memory, and the tiles cover
every output once.  Other factors take the generic instance, its taps in
the launch's parameters up to its table and read from the card past it,
so any tap count runs whose halo fits the card's shared memory.

The walk repeats the kernel's schedule in float32: per block one tile of
THREADS * R low-rate samples staged with its halo (the carry for m < 0,
zeros before it and past B), each thread's window of H + R samples, R * L
outputs a thread from S taps each, only those before B stored, the new
carry from the channel's last tile.  It is held against `interp_plain`
over three streamed blocks (the middle one ragged) at 100 dB on output
and bit for bit on the carry.  The card holds the kernel itself to the
plain version (tests/test_torch_cuda.py, chip_smoke.py's K4 phase) and
its library's geometry to this rule.
"""
from __future__ import annotations

import json
import pathlib
import warnings

import numpy as np
import pytest
import torch

from uhsdr_tpu_torch.chain import rx
from uhsdr_tpu_torch.cuda import build
from uhsdr_tpu_torch.cuda import fir as fir_k
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.parallel import fleet as pfleet

THREADS = fir_k.INTERP_THREADS
RATES = (48000.0, 96000.0, 192000.0)
MODES = ("usb", "lsb", "cw", "am", "sam", "iq", "ssbstereo")


def chain_interpolators() -> dict:
    """{(L, taps): (block lengths at the IQ rate, ...)}: every K4 shape
    the reference-table chains reach (every row of ref_paths.json, every
    mode but FM, which runs no K4)."""
    from uhsdr_tpu_torch import data
    paths = json.loads((pathlib.Path(data.__file__).parent
                        / "ref_paths.json").read_text())["paths"]
    out: dict = {}
    for bw in sorted({p["bw_id"] for p in paths}):
        for rate in RATES:
            for mode in MODES:
                try:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        cfg = rx.RxConfig(mode=mode,
                                          bw_key=bw.replace("AUDIO_", ""),
                                          iq_rate=rate)
                        if not cfg.use_ref_front:
                            # iq/ssbstereo on a wide row run the legacy
                            # front (test_interp_geometry_legacy_front)
                            continue
                        taps = rx.make_params(cfg, "cpu").interp_fir.shape[-1]
                except (KeyError, ValueError, NotImplementedError):
                    continue
                out.setdefault((cfg.decim, taps), set()).add(rate)
    return out


CHAIN_SHAPES = chain_interpolators()


def test_the_chains_reach_these_instances():
    """Each (L, S) the chains reach has an instance of its own, and the
    instances are those the chains reach."""
    pairs = {(L, -(-taps // L)) for L, taps in CHAIN_SHAPES}
    assert pairs == set(fir_k.INTERP_FIXED)
    assert {(8, 93), (4, 93), (16, 187), (8, 187), (4, 16), (2, 16),
            (2, 4), (4, 4)} <= set(CHAIN_SHAPES)


def coverage(g: fir_k.InterpGeometry, L: int, B: int) -> np.ndarray:
    """How many times the launch writes each output of a channel."""
    hits = np.zeros(B * L, int)
    for tile in range(g.tiles):
        m0 = tile * g.tile
        for tid in range(THREADS):
            for r in range(g.R):
                m = m0 + g.R * tid + r
                if m < B:
                    hits[m * L:(m + 1) * L] += 1
    return hits


@pytest.mark.parametrize("L,taps", sorted(CHAIN_SHAPES))
@pytest.mark.parametrize("block", [16384, 4096, 4100, 1000])
def test_interp_geometry_at_the_chains_shapes(L, taps, block):
    B = max(1, block // L)
    g = fir_k.interp_geometry(L, taps, B, 8192)
    S = -(-taps // L)
    assert g.fixed and g.param_taps and g.sub_len == S
    assert g.R % 4 == 0 and g.R * L >= 32
    assert g.H == -(-(S - 1) // 4) * 4 >= S - 1
    assert g.tile == THREADS * g.R and g.tiles == -(-B // g.tile)
    assert g.blocks == 8192 * g.tiles
    assert g.smem == 4 * (g.H + g.tile + THREADS * (g.R * L + 4))
    assert g.smem <= build.SMEM_OPT_IN
    assert (coverage(g, L, B) == 1).all()


@pytest.mark.parametrize("rows,B,L,taps", [
    (5120, 4096, 4, 16),      # the fleet's five 12 kHz groups, one launch
    (16384, 2048, 8, 93),     # ssbstereo's 2C rows
    (2730, 1024, 4, 16),      # the wideband usb group
    (1366, 2048, 2, 16),      # the wideband am group
])
def test_interp_geometry_fleet_rows(rows, B, L, taps):
    g = fir_k.interp_geometry(L, taps, B, rows)
    assert g.fixed and g.blocks == rows * g.tiles
    assert g.smem <= build.SMEM_OPT_IN
    assert (coverage(g, L, B) == 1).all()


@pytest.mark.parametrize("L", [2, 4, 8, 16])
@pytest.mark.parametrize("block", [16384, 4100])
def test_interp_geometry_legacy_front(L, block):
    """The legacy front's scipy interpolator, 16 taps a phase at every
    factor (`design.interpolation_fir(16 L)`): the generic instance, its
    taps in the launch's parameters, every output once."""
    bw, rate = {2: ("10P0KHZ", 48000.0), 4: ("2P3KHZ", 48000.0),
                8: ("2P3KHZ", 96000.0), 16: ("2P3KHZ", 192000.0)}[L]
    cfg = rx.RxConfig(mode="usb", bw_key=bw, front="scipy", iq_rate=rate)
    assert cfg.decim == L
    assert rx.make_params(cfg, "cpu").interp_fir.shape[-1] == 16 * L
    B = max(1, block // L)
    g = fir_k.interp_geometry(L, 16 * L, B, 8192)
    assert not g.fixed and g.param_taps and g.sub_len == 16
    assert g.smem <= build.SMEM_OPT_IN
    assert (coverage(g, L, B) == 1).all()


@pytest.mark.parametrize("L,taps,B", [(3, 40, 777), (6, 93, 700),
                                      (5, 93, 1), (1, 7, 513),
                                      (3, 960, 100), (3, 961, 100),
                                      (3, 2000, 10), (7, 12000, 900)])
def test_interp_geometry_generic(L, taps, B):
    """Any other (L, taps) runs on the generic instance: its taps in the
    launch's parameters up to INTERP_MAX_TAPS padded taps, on the card
    past them; no tap count is refused."""
    g = fir_k.interp_geometry(L, taps, B)
    assert not g.fixed and g.R == 4 and g.tile == 4 * THREADS
    assert g.param_taps == (L * g.sub_len <= fir_k.INTERP_MAX_TAPS)
    assert g.smem == 4 * (g.H + g.tile) <= build.SMEM_OPT_IN
    assert (coverage(g, L, B) == 1).all()


@pytest.mark.parametrize("L,taps,B", [(-3, 93, 10), (0, 93, 10),
                                      (8, 0, 10), (8, 93, 0),
                                      (1, 60000, 10)])
def test_interp_geometry_refuses(L, taps, B):
    with pytest.raises(ValueError):
        fir_k.interp_geometry(L, taps, B)


def walk(h: np.ndarray, carry: np.ndarray, x: np.ndarray, L: int):
    """The kernel's schedule in float32, channel by channel."""
    C, B = x.shape
    taps = h.shape[-1]
    g = fir_k.interp_geometry(L, taps, B, C)
    S, H, R = g.sub_len, g.H, g.R
    hp = np.zeros(S * L, np.float32)
    hp[:taps] = h
    y = np.full((C, B * L), np.nan, np.float32)
    full = np.concatenate([carry, x], axis=-1)       # m = -(S-1) ..
    for c in range(C):
        for tile in range(g.tiles):
            m0 = tile * g.tile
            m = m0 - H + np.arange(H + g.tile)
            xs = np.where((m >= -(S - 1)) & (m < B),
                          full[c, np.clip(m + S - 1, 0, S - 2 + B)], 0.0
                          ).astype(np.float32)
            for tid in range(THREADS):
                w = xs[R * tid:R * tid + H + R]
                for r in range(R):
                    mt = m0 + R * tid + r
                    if mt >= B:
                        continue
                    acc = np.zeros(L, np.float32)
                    for k in range(S):
                        acc = (acc + hp[k * L:(k + 1) * L] * w[H + r - k]
                               ).astype(np.float32)
                    y[c, mt * L:(mt + 1) * L] = acc
    return y, full[:, B:B + S - 1].copy() if S > 1 else full[:, :0]


@pytest.mark.parametrize("L,taps", [(8, 93), (4, 93), (2, 16), (4, 4)])
def test_walk_matches_plain(L, taps):
    rng = np.random.default_rng(L * 100 + taps)
    h = rng.standard_normal(taps).astype(np.float32)
    S = -(-taps // L)
    C = 2
    cw = cp = np.zeros((C, S - 1), np.float32)
    for B in (600, 301, 600):
        x = rng.standard_normal((C, B)).astype(np.float32)
        yw, cw = walk(h, cw, x, L)
        yp, cpt = fir_k.interp_plain(torch.from_numpy(h),
                                     torch.from_numpy(cp),
                                     torch.from_numpy(x), L)
        cp = cpt.numpy()
        assert not np.isnan(yw).any()
        assert snr_db(yp, torch.from_numpy(yw)) >= 100.0
        np.testing.assert_array_equal(cw, cp)


def test_fleet_mix_interpolators_have_instances():
    """The fleet's groups at 48 kHz (16384-sample blocks): every non-FM
    group's interpolator is an instance of its own."""
    for cfg in pfleet.FLEET_MIX:
        if cfg.mode == "fm":
            continue
        taps = rx.make_params(cfg, "cpu").interp_fir.shape[-1]
        g = fir_k.interp_geometry(cfg.decim, taps, cfg.block_len // cfg.decim,
                                  pfleet.FLEET_GROUP_CHANNELS)
        assert g.fixed
