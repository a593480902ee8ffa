"""The SAM kernels' launch rules and the PLL walker's schedule, on the CPU.

* `cuda/pll.py::pll_geometry`, `cuda/iir.py::biquad_geometry` and
  `cuda/sam.py::sam_geometry`: every SM runs a block before any runs two,
  each block's walkers are one a scheduler, the lanes are the fewest
  that do that, and the shared memory is the sources' layout (the card
  tests hold the libraries to the same numbers).
* The walker's phase wrap (`cuda/pll.py::wrap_2pi`, the select x >= 2 pi
  ? x - 2 pi : (x < 0 ? x + 2 pi : x) on (-2 pi, 4 pi), torch.remainder
  elsewhere) against torch.remainder(x, 2 pi), bit for bit: on the
  range's edges and on 10^6 seeded values.
* The walker's schedule, software-pipelined over two steps (sincos of
  phs[n+1], known when step n starts, taken in step n; phs[n+2] =
  wrap(phs[n+1] + fil_out[n])), written out in torch with the select
  wrap, against K10's and K9's plain loops bit for bit, from carries
  inside and outside [0, 2 pi] and with a NaN.
* `cuda/ring.py` against `kernels/ring.cuh`, the tile ring K11 and the
  fused stage share: the layout the rules size from is the header's, and
  a build's hash covers the header.
"""
from __future__ import annotations

import math
import re

import numpy as np
import pytest
import torch

from uhsdr_tpu_torch.cuda import build
from uhsdr_tpu_torch.cuda import iir as iir_k
from uhsdr_tpu_torch.cuda import pll as pll_k
from uhsdr_tpu_torch.cuda import ring
from uhsdr_tpu_torch.cuda import sam as sam_k
from uhsdr_tpu_torch.demod import sam as tsam

SMS = 132
SHAPES = (1, 8, 100, 528, 529, 1024, 4096, 4224, 4225, 8192, 16384, 16896,
          16897, 40000)


def _bits(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("C", SHAPES)
def test_pll_geometry_fills_every_scheduler_first(C):
    g = pll_k.pll_geometry(C, 4096, SMS)
    assert g.channels == pll_k.PLL_WALKERS * g.lanes
    assert g.blocks == -(-C // g.channels) and g.tiles == 128
    assert 1 <= g.lanes <= pll_k.PLL_MAX_LANES
    if C <= pll_k.PLL_WALKERS * pll_k.PLL_MAX_LANES * SMS:
        assert g.blocks <= SMS                       # a block an SM at most
        if g.lanes > 1:                               # and the fewest lanes
            assert -(-C // (pll_k.PLL_WALKERS * (g.lanes - 1))) > SMS
    else:
        assert g.lanes == pll_k.PLL_MAX_LANES
    assert g.smem == pll_k.PLL_STAGES * g.channels * (2 * pll_k.PLL_TILE
                                                      + 4) * 4
    assert g.smem <= 227 * 1024


@pytest.mark.parametrize("C", SHAPES)
def test_biquad_geometry_fills_every_scheduler_first(C):
    g = iir_k.biquad_geometry(C, 4096, SMS)
    assert g.walkers == ring.WALKERS
    assert g.rows == g.walkers * g.lanes and g.blocks == -(-C // g.rows)
    if C <= g.walkers * iir_k.BIQUAD_MAX_LANES * SMS:
        assert g.blocks <= SMS
        if g.lanes > 1:
            assert -(-C // (g.walkers * (g.lanes - 1))) > SMS
    assert g.stages == ring.STAGES
    assert g.smem == g.stages * g.rows * (ring.TILE + 4) * 4
    # two blocks an SM fit past one a scheduler
    assert 2 * (g.smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("n_audio", [1, 2])
@pytest.mark.parametrize("C", SHAPES)
def test_sam_geometry_fills_every_scheduler_first(C, n_audio):
    g = sam_k.sam_geometry(C, 4096, n_audio, SMS)
    walkers = ring.WALKERS
    assert 1 <= g.lanes <= sam_k.SAM_MAX_LANES       # four lanes a channel
    assert g.channels == walkers * g.lanes
    assert g.blocks == -(-C // g.channels)
    if C <= walkers * sam_k.SAM_MAX_LANES * SMS:
        assert g.blocks <= SMS
        if g.lanes > 1:
            assert -(-C // (walkers * (g.lanes - 1))) > SMS
    ta = ring.TILE
    assert g.smem == ring.STAGES * g.channels * (
        (2 * ta + 4) + (2 + n_audio) * (ta + 4)) * 4
    assert 2 * (g.smem + 1024) <= 228 * 1024


def test_the_flagship_launches():
    """At the SAM flagship (8192 channels x 4096 at 24 kHz): K10/K9 16
    lanes a walker, 128 blocks; the stacked K11 rows 32 lanes, 128 blocks;
    the fused stage 8 channels a walker (32 lanes), 256 blocks, two an SM."""
    assert pll_k.pll_geometry(8192, 4096)[:3] == (16, 64, 128)
    assert iir_k.biquad_geometry(16384, 4096)[:5] == (32, 4, 128, 4, 128)
    assert sam_k.sam_geometry(8192, 4096)[:3] == (8, 32, 256)


@pytest.mark.parametrize("rule", [
    lambda: pll_k.pll_geometry(0, 10), lambda: pll_k.pll_geometry(10, 0),
    lambda: iir_k.biquad_geometry(0, 10),
    lambda: sam_k.sam_geometry(10, 10, 3), lambda: sam_k.sam_geometry(0, 1)])
def test_rules_refuse_empty_launches(rule):
    with pytest.raises(ValueError):
        rule()


TWO_PI = np.float32(pll_k.TWO_PI)


def _edges() -> torch.Tensor:
    def ulp(x, n):
        return np.nextafter(np.float32(x), np.float32(np.inf if n > 0
                                                      else -np.inf))
    v = [0.0, -0.0, 1e-45, -1e-45, 1e-30, -1e-30, TWO_PI, -TWO_PI,
         ulp(TWO_PI, 1), ulp(TWO_PI, -1), ulp(-TWO_PI, 1), ulp(-TWO_PI, -1),
         2 * TWO_PI, ulp(2 * TWO_PI, -1), ulp(2 * TWO_PI, 1), np.pi, -np.pi,
         3 * np.pi, ulp(0.0, -1), -1e-8, 1e6, -1e6, 3e38, np.inf, -np.inf,
         np.nan]
    return torch.tensor(np.array(v, np.float32))


def test_wrap_equals_remainder_on_the_edges():
    x = _edges()
    want = torch.remainder(x, pll_k.TWO_PI)
    got = pll_k.wrap_2pi(x)
    same = (want.view(torch.int32) == got.view(torch.int32)) | (
        want.isnan() & got.isnan())
    assert bool(same.all()), (x[~same], want[~same], got[~same])
    fast = (x > -pll_k.TWO_PI) & (x < pll_k.FOUR_PI)
    assert _bits(pll_k.wrap_select(x[fast]), want[fast])
    # -2 pi itself is left to remainder: the select would give +0 for -0
    assert math.copysign(1.0, float(torch.remainder(
        torch.tensor(-TWO_PI), pll_k.TWO_PI))) == -1.0


def test_wrap_equals_remainder_on_a_seeded_sample():
    rng = np.random.default_rng(26)
    x = np.concatenate([
        rng.uniform(-2 * np.pi, 4 * np.pi, 900_000),
        rng.uniform(-1e-6, 1e-6, 50_000),
        rng.uniform(2 * np.pi - 1e-5, 2 * np.pi + 1e-5, 40_000),
        rng.uniform(-30.0, 30.0, 10_000)]).astype(np.float32)
    x = torch.from_numpy(x)
    assert x.numel() == 1_000_000
    assert _bits(pll_k.wrap_2pi(x), torch.remainder(x, pll_k.TWO_PI))


def _pipelined(p, carry, iq, fade=None):
    """The kernel's walker schedule in torch: phs[n+1] = wrap(phs[n] +
    fil[n-1]) before step n, sincos of it taken in step n beside the mix,
    atan2 and loop filter of phs[n]'s, phs[n+2] = wrap(phs[n+1] +
    fil[n])."""
    zr, zi = iq.real, iq.imag
    phs, fil, om = carry[0], carry[1], carry[2]
    c, s = torch.cos(phs), torch.sin(phs)
    phs1 = pll_k.wrap_2pi(phs + fil)
    if fade is not None:
        dc, dci = carry[3], carry[4]
        mR, mI = fade
        aR, aI = (float(np.float32(1.0 - m)) for m in fade)
    outs = []
    for n in range(iq.shape[-1]):
        c1, s1 = torch.cos(phs1), torch.sin(phs1)
        re = zr[:, n] * c + zi[:, n] * s
        im = zi[:, n] * c - zr[:, n] * s
        err = torch.atan2(im, re)
        om = torch.clamp(om + p.g2 * err, p.omega_min, p.omega_max)
        fil = p.g1 * err + om
        phs2 = pll_k.wrap_2pi(phs1 + fil)
        if fade is None:
            outs.append(torch.stack([c, s]))
        else:
            dc = mR * dc + aR * re
            dci = mI * dci + aI * re
            outs.append(re + dci - dc)
        c, s, phs, phs1 = c1, s1, phs1, phs2
    out = torch.stack(outs, dim=-1)
    if fade is None:
        return out, torch.stack([phs, fil, om])
    return out, torch.stack([phs, fil, om, dc, dci])


@pytest.mark.parametrize("audio", [False, True], ids=["k10", "k9"])
def test_pipelined_schedule_is_the_plain_loop(audio):
    sp = tsam.make_params(24000.0)
    p = pll_k.PllScalars(sp.g1, sp.g2, sp.omega_min, sp.omega_max)
    rng = np.random.default_rng(27)
    C, T = 12, 300
    n = np.arange(T)
    z = (0.5 * np.exp(1j + 2j * np.pi * (3 + np.arange(C))[:, None] * n
                      / 24000.0)
         + 1e-3 * (rng.standard_normal((C, T))
                   + 1j * rng.standard_normal((C, T)))).astype(np.complex64)
    z[8] = 0                                        # a silent channel
    z[9, 100] = complex(np.nan, 0.0)                # a NaN
    phs0 = np.array([0.0, 1.0, 6.2, 10.0, -3.0, 1e6, -2 * np.pi, 4 * np.pi,
                     0.5, 0.5, 2.0, 3.0], np.float32)
    carry = torch.zeros((5 if audio else 3, C))
    carry[0] = torch.from_numpy(phs0)
    carry[1] = 0.3
    z = torch.from_numpy(z)
    fade = (sp.fade.mtauR, sp.fade.mtauI) if audio else None
    got, gc = _pipelined(p, carry, z, fade)
    if audio:
        want, wc = pll_k.pll_audio_plain(p, fade[0], fade[1], carry, z)
    else:
        c, s, wc = pll_k.pll_plain(p, carry, z)
        want = torch.stack([c, s])
    same = ((want.view(torch.int32) == got.view(torch.int32))
            | (want.isnan() & got.isnan()))
    assert bool(same.all())
    same_c = ((wc.view(torch.int32) == gc.view(torch.int32))
              | (wc.isnan() & gc.isnan()))
    assert bool(same_c.all())
    assert bool(gc[0, 9].isnan()) and not bool(gc[0, :9].isnan().any())


def _ring_constants() -> dict:
    text = (build.KERNEL_DIR / "ring.cuh").read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (TA|STAGES|NWALK) = (\d+);", text)}


def test_ring_layout_is_the_header_s():
    """cuda/ring.py's layout, which biquad_geometry and sam_geometry size
    their launches from, is kernels/ring.cuh's (the card tests hold the
    built libraries to it too)."""
    got = _ring_constants()
    assert got == {"TA": ring.TILE, "STAGES": ring.STAGES,
                   "NWALK": ring.WALKERS}
    assert ring.THREADS == 32 * (2 * ring.WALKERS + 1)


@pytest.mark.parametrize("kernel", ["biquad", "sam_sideband"])
def test_ring_sources_carry_the_header_in_their_hash(kernel, tmp_path,
                                                     monkeypatch):
    """K11's and the stage's sources include ring.cuh: the text a build
    hashes (and a trace variant patches) has the header written in, once,
    so an edited header never loads a stale library."""
    k = {"biquad": iir_k.BIQUAD, "sam_sideband": sam_k.SAM_SIDEBAND}[kernel]
    text = k.source_text()
    assert '#include "' not in text
    assert text.count("#define UHSDR_RING_CUH") == 1
    assert text.count("__device__ __forceinline__ void output(") == 1
    path = k._lib_path()
    for name in (k.source.name, "ring.cuh"):
        (tmp_path / name).write_text((build.KERNEL_DIR / name).read_text())
    monkeypatch.setattr(k, "source", tmp_path / k.source.name)
    assert k._lib_path() == path
    (tmp_path / "ring.cuh").write_text(
        (tmp_path / "ring.cuh").read_text() + "\n// edited\n")
    assert k._lib_path() != path
