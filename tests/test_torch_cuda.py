"""The hand-written kernels against their plain torch versions, on the card.

Every test here needs a CUDA device and skips without one.  On a machine
with a card (and no JAX) run

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py imports JAX).  Shapes are small and
ragged on purpose: channel counts and block lengths that fill no whole
thread block or time tile.  Inputs come from a numpy seed.  Kernels and
plain versions share f32 arithmetic but not the order of their sums, so
FIR outputs are held to SNR >= 100 dB; the biquad-cascade kernels
repeat their plain versions' operations in order and are held to 120 dB
(`AGC_DB`); the AGC kernels K3 and K13, which repeat them too and are
built with -fmad=false, must be bit-exact (K3 at w from 48 to 256, over
one step, a tile less and more one and one tile; its shared memory is
`agc_geometry`'s); the PLL kernels' cos/sin/audio to max |err| <= 2e-5 (they repeat
the plain loop's operations too; tests/test_demod.py holds the TPU
kernels to 3e-4); the FM discriminator to max |err| <= 2e-6 modulo 2 pi
(an angle at the branch cut may come out as +pi or -pi); the chain on
the card against the chain on the CPU to 80 dB.  K3 and K13 with
per-channel rows must be bit-exact with their plain versions, and a
channel with rows must give the bits it gives alone with scalars; the
mixed-mode fleet's stage-batched step must be bit-equal to its groups
run as separate chains.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from uhsdr_tpu_torch.chain import rx
from uhsdr_tpu_torch.cuda import agc as agc_k
from uhsdr_tpu_torch.cuda import build
from uhsdr_tpu_torch.cuda import elemwise as ew_k
from uhsdr_tpu_torch.cuda import fir as fir_k
from uhsdr_tpu_torch.cuda import iir as iir_k
from uhsdr_tpu_torch.cuda import pll as pll_k
from uhsdr_tpu_torch.demod import sam as sam_mod
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.ops import agc as agc_ops
from uhsdr_tpu_torch.ops import iir, nco
from uhsdr_tpu_torch.parallel import fleet as fleet_mod

pytestmark = pytest.mark.cuda

FIR_DB = 100.0
AGC_DB = 120.0
CHAIN_DB = 80.0
PLL_ABS = 2e-5
DISC_ABS = 2e-6
FLAGSHIP = dict(mode="usb", bw_key="2P3KHZ", path_name="LPF",
                translate_hz=12000.0, iq_rate=96000.0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python -m pytest --noconftest "
                    "tests/test_torch_cuda.py on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _k2_per_block(cfg, params) -> int:
    """K2 launches a block: one per non-empty cascade the chain runs (FM:
    the squelch HPF and the treble shelf; the others: the PreFilter, EQ
    biquad1, the anti-alias lattice and the treble shelf).  Every block of
    these tests chunks (T % 128 == 0, T >= 256)."""
    if cfg.mode == "fm":
        cs = (params.fm.squelch_sos, params.eq2_sos)
    else:
        cs = (params.audio_sos, params.eq1_sos, params.aa_sos,
              params.eq2_sos)
    return sum(c.sections > 0 for c in cs)


def _int16(rng, shape, std=3277.0):
    return np.clip(np.round(rng.standard_normal(shape) * std), -32768,
                   32767).astype(np.int16)


@pytest.mark.parametrize("iq_rate,C,B,dtype", [
    (96000.0, 13, 1600, "int16"), (96000.0, 3, 4096, "float32"),
    (48000.0, 5, 2000, "int16"),
    (192000.0, 4, 5008, "int16"),     # decim 16: a tile and a ragged one
    (96000.0, 7, 9000, "int16"),      # two tiles and a ragged one
    (48000.0, 3, 6000, "float32"),    # the fleet's shape, ragged
    (48000.0, 3, 1004, "int16"),      # less than a tile, rows unaligned
    (96000.0, 1, 16384, "int16")])    # one channel, four whole tiles
def test_front_kernel_matches_plain(dev, iq_rate, C, B, dtype):
    """K1 against its plain version from a random NCO phase, three
    streamed blocks."""
    p = rx.make_params(rx.RxConfig(**{**FLAGSHIP, "iq_rate": iq_rate}), dev)
    decim = rx.RxConfig(**{**FLAGSHIP, "iq_rate": iq_rate}).decim
    h, g, delta = p.front_fir, p.front2, p.nco_delta
    rng = np.random.default_rng(1)
    zeros = [torch.zeros((C, n - 1), dtype=torch.complex64, device=dev)
             for n in (h.shape[-1], g.shape[-1])]
    ck, cp = list(zeros), list(zeros)
    ph = torch.from_numpy(rng.integers(0, 2**32, C)).to(dev)
    for _ in range(3):
        x = [torch.from_numpy(_int16(rng, (C, B))).to(dev) for _ in "iq"]
        if dtype == "float32":
            x = [v.to(torch.float32) / 32768.0 for v in x]
        n0 = fir_k.FRONT.launches
        outk = fir_k.front(h, g, *ck, *x, ph, delta, decim)
        assert fir_k.FRONT.launches == n0 + 1
        outp = fir_k.front_plain(h, g, *cp, *x, ph, delta, decim)
        torch.cuda.synchronize()
        for a, b in zip(outp, outk):
            assert snr_db(a, b) >= FIR_DB
        ck, cp = list(outk[1:3]), list(outp[1:3])
        ph = nco.advance(ph, delta, B)


def test_front_geometry_matches_library(dev):
    """K1's shared memory as the library computes it equals cuda/fir.py's
    rule at every rate, filter count and sample size the port sends."""
    lib = fir_k.FRONT.lib()
    for rate in (48000.0, 96000.0, 192000.0):
        for mode in ("usb", "ssbstereo"):
            cfg = rx.RxConfig(**{**FLAGSHIP, "iq_rate": rate, "mode": mode})
            p = rx.make_params(cfg, "cpu")
            taps, taps2 = p.front_fir.shape[-1], p.front2.shape[-1]
            nb = 1 if p.front2.ndim == 1 else 2
            for size in (2, 4):
                assert lib.uhsdr_front_smem(taps, taps2, cfg.decim, nb,
                                            size) == fir_k.front_geometry(
                    taps, taps2, cfg.decim, nb, size).smem


# K3's time tile (32 steps) and look-ahead w = 48 at 12 kHz, 96 at 24,
# 128 at 32, 192 at 48, 256 at 64: every w is longer than the tile
AGC_SHAPES = [(40, 1000, 12000.0),
              (64, 2048, 12000.0),
              (33, 1500, 24000.0),      # w = 96
              (8, 700, 32000.0),        # w = 128
              (20, 1000, 48000.0),      # w = 192
              (5, 300, 64000.0),        # w = 256
              (1, 1, 12000.0),          # one channel, one step
              (31, 31, 12000.0),        # the tile - 1
              (31, 33, 48000.0),        # the tile + 1
              (1, 32, 64000.0)]         # one tile, w = 8 tiles


@pytest.mark.parametrize("C,T,fs", AGC_SHAPES)
def test_agc_kernel_matches_plain(dev, C, T, fs):
    """K3 against its plain version over three streamed blocks, bit for
    bit."""
    params = agc_ops.make_params(fs, mode="med", hang_enable=True)
    p = agc_ops.kernel_params(params).scalars
    w = params.attack_buffsize
    rng = np.random.default_rng(2)
    ck = cp = torch.zeros((agc_k.N_CARRY, C), device=dev)
    dk = dp = torch.zeros((C, w), device=dev)
    level = np.logspace(-1, 4, C)[:, None]
    for blk in range(3):
        n = np.arange(blk * T, (blk + 1) * T)
        x = level * np.sin(2 * np.pi * 700 * n / fs) * (n < 1.5 * T)
        x = torch.from_numpy((x + rng.standard_normal((C, T)) * 0.5)
                             .astype(np.float32)).to(dev)
        n0 = agc_k.AGC.launches
        yk, ck, dk = agc_k.agc(p, ck, dk, x)
        assert agc_k.AGC.launches == n0 + 1
        yp, cp, dp = agc_k.agc_plain(p, cp, dp, x)
        torch.cuda.synchronize()
        for a, b in ((yp, yk), (cp, ck), (dp, dk)):
            assert float((a - b).abs().max()) == 0.0


@pytest.mark.parametrize("C,T,fs", AGC_SHAPES)
def test_agc_smem_matches_geometry(dev, C, T, fs):
    """The library's K3 shared memory is `agc_geometry`'s."""
    w = agc_ops.make_params(fs).attack_buffsize
    lib = agc_k.AGC.lib()
    for rows in (False, True):
        assert lib.uhsdr_agc_smem(w) == agc_k.agc_geometry(C, T, w,
                                                           rows).smem
    assert lib.uhsdr_agc_smem(agc_k.AGC_MAXW + 1) == -1


@pytest.mark.parametrize("w", [1, 2, 5, 31, 32, 33, 63, 255, 256])
def test_agc_kernel_any_window(dev, w):
    """K3 at look-ahead windows no chain sends (below the 32-step tile the
    front warp takes one output at a time), bit for bit over three
    streamed blocks of 1, 37 and 100 steps."""
    p = agc_ops.kernel_params(agc_ops.make_params(
        12000.0, mode="med", hang_enable=True)).scalars
    C = 37
    rng = np.random.default_rng(w)
    ck = cp = torch.zeros((agc_k.N_CARRY, C), device=dev)
    dk = dp = torch.from_numpy(rng.standard_normal((C, w))
                               .astype(np.float32)).to(dev)
    for T in (1, 37, 100):
        x = torch.from_numpy((rng.standard_normal((C, T))
                              * np.logspace(-1, 4, C)[:, None])
                             .astype(np.float32)).to(dev)
        yk, ck, dk = agc_k.agc(p, ck, dk, x)
        yp, cp, dp = agc_k.agc_plain(p, cp, dp, x)
        torch.cuda.synchronize()
        for a, b in ((yp, yk), (cp, ck), (dp, dk)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("C,B,L", [(5, 1500, 8), (9, 4096, 4), (7, 1030, 2),
                                   (3, 700, 6)])
def test_interp_kernel_matches_plain(dev, C, B, L):
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal(93).astype(np.float32)).to(dev)
    sub = -(-93 // L)
    ck = cp = torch.zeros((C, sub - 1), device=dev)
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal((C, B))
                             .astype(np.float32)).to(dev)
        n0 = fir_k.INTERP.launches
        yk, ck = fir_k.interpolate(h, ck, x, L)
        assert fir_k.INTERP.launches == n0 + 1
        yp, cp = fir_k.interp_plain(h, cp, x, L)
        torch.cuda.synchronize()
        assert snr_db(yp, yk) >= FIR_DB
        assert torch.equal(cp, ck)


# (L, taps) the chains send K4: x2 and x4 at 48 kHz (the firmware's 4- and
# 16-tap interpolators), x4 and x8 at 96 kHz (93 taps), x8 and x16 at
# 192 kHz (187 taps); and four the generic instance takes, the last two
# past its parameters' tap table (the taps read from the card)
@pytest.mark.parametrize("L,taps", [(2, 4), (2, 16), (4, 4), (4, 16),
                                    (4, 93), (8, 93), (8, 187), (16, 187),
                                    (3, 40), (5, 93), (3, 2000), (7, 1500)])
def test_interp_kernel_at_the_chains_factors(dev, L, taps):
    """K4 at every factor the chains reach, over three streamed blocks
    (the middle one ragged: no multiple of a tile, odd at x2), held to its
    plain version on output and carry; channels 0-7 alone give the bits
    they give in the batch."""
    rng = np.random.default_rng(L * 1000 + taps)
    h = torch.from_numpy(rng.standard_normal(taps).astype(np.float32)).to(dev)
    sub = -(-taps // L)
    C = 70
    ck = cp = torch.zeros((C, sub - 1), device=dev)
    for B in (1024, 777, 2048):
        x = torch.from_numpy(rng.standard_normal((C, B))
                             .astype(np.float32)).to(dev)
        yk, ck_next = fir_k.interpolate(h, ck, x, L)
        y8, c8 = fir_k.interpolate(h, ck[:8].contiguous(),
                                   x[:8].contiguous(), L)
        yp, cp = fir_k.interp_plain(h, cp, x, L)
        torch.cuda.synchronize()
        assert snr_db(yp, yk) >= FIR_DB
        assert torch.equal(cp, ck_next)
        assert torch.equal(y8, yk[:8]) and torch.equal(c8, ck_next[:8])
        ck = ck_next


def test_interp_geometry_matches_the_library(dev):
    """The library's K4 launch (instance, samples a thread, halo, tile,
    shared memory, where the taps travel) is `interp_geometry`'s, both
    refuse the same shapes, and its table of fixed instances is
    INTERP_FIXED."""
    import ctypes
    lib = fir_k._interp_lib()
    out = (ctypes.c_int * 6)()
    pair = (ctypes.c_int * 2)()
    n = lib.uhsdr_interp_n_fixed()
    assert lib.uhsdr_interp_fixed(n, pair) == -1
    assert {tuple(pair) for i in range(n)
            if lib.uhsdr_interp_fixed(i, pair) == 0} == set(fir_k.INTERP_FIXED)
    for L in (-1, 0, 1, 2, 3, 4, 5, 8, 16, 32):
        for taps in (0, 1, 4, 16, 93, 187, 960, 961, 2000, 12000, 60000):
            try:
                g = fir_k.interp_geometry(L, taps, 4096)
                want = (0, (int(g.fixed), g.R, g.H, g.tile, g.smem,
                            int(g.param_taps)))
            except ValueError:
                want = (-1, None)
            rc = lib.uhsdr_interp_geometry(L, taps, out)
            assert (rc, tuple(out) if rc == 0 else None) == want, (L, taps)
            if rc == 0:
                assert want[1][4] <= build.SMEM_OPT_IN


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 64), device=dev)
    h = torch.zeros(93, device=dev)
    with pytest.raises(ValueError):             # carry of another factor
        fir_k.interpolate(h, torch.zeros((4, 11), device=dev), x, 6)
    with pytest.raises(ValueError):
        fir_k.interpolate(h, torch.zeros((4, 11), device=dev),
                          x.to(torch.float64), 8)
    with pytest.raises(ValueError):
        agc_k.agc(agc_ops.kernel_params(agc_ops.make_params(12000.0)).scalars,
                  torch.zeros((7, 4), device=dev),
                  torch.zeros((4, 48)), x)


@pytest.mark.parametrize("iq_rate,block_len", [(96000.0, 4096),
                                               (48000.0, 4096)])
def test_chain_on_card_matches_cpu(dev, iq_rate, block_len):
    cfg = rx.RxConfig(**{**FLAGSHIP, "iq_rate": iq_rate,
                         "block_len": block_len})
    gpu, cpu = rx.RxChain(cfg, device=dev), rx.RxChain(cfg, device="cpu")
    C = 8
    sg, sc = gpu.init_state((C,)), cpu.init_state((C,))
    rng = np.random.default_rng(4)
    counts = {k: getattr(fir_k, k).launches for k in ("FRONT", "INTERP")}
    n_agc = agc_k.AGC.launches
    for _ in range(3):
        i, q = _int16(rng, (C, block_len)), _int16(rng, (C, block_len))
        yg, sg, _ = gpu(sg, i=i, q=q)
        yc, sc, _ = cpu(sc, i=i, q=q)
        assert snr_db(yc, yg.cpu()) >= CHAIN_DB
    for k, n in counts.items():
        assert getattr(fir_k, k).launches == n + 3
    assert agc_k.AGC.launches == n_agc + 3
    a, b = rx.state_to_numpy(sc), rx.state_to_numpy(sg)
    for f in a:
        assert snr_db(a[f], b[f]) >= CHAIN_DB, f


@pytest.mark.parametrize("C,B,decim,taps,dtype,use_nco", [
    (13, 1600, 4, 239, "int16", True),     # the SAM flagship's front
    (3, 4096, 4, 239, "float32", False),
    (5, 40, 8, 227, "int16", True),        # block shorter than the history
    (7, 1000, 2, 89, "int16", True),
    (4, 999, 1, 89, "float32", True),
    (6, 1536, 6, 120, "int16", False),
    (3, 4208, 16, 479, "int16", True),     # 192 kHz narrow AM/SAM, ragged
    (5, 4200, 1, 89, "float32", True),     # the fleet's FM at 48 kHz
    (1, 1600, 4, 239, "int16", True),      # one channel
    (4, 400, 4, 239, "float32", True),     # shorter than one tile
    (9, 2056, 8, 479, "int16", False)])    # four row groups, ragged
def test_fir_rt_kernel_matches_plain(dev, C, B, decim, taps, dtype, use_nco):
    rng = np.random.default_rng(5)
    h = torch.from_numpy((rng.standard_normal(taps) * 0.05)
                         .astype(np.float32)).to(dev)
    delta = int(nco.freq_to_delta(-12000.0, 96000.0))
    ck = cp = torch.zeros((C, taps - 1), dtype=torch.complex64, device=dev)
    ph = torch.from_numpy(rng.integers(0, 2**32, C)).to(dev)
    for blk in range(3):
        x = [torch.from_numpy(_int16(rng, (C, B))).to(dev) for _ in "iq"]
        if dtype == "float32":
            x = [v.to(torch.float32) / 32768.0 for v in x]
        kw = dict(nco=(ph, delta) if use_nco else None)
        n0 = fir_k.FIR_RT.launches
        yk, ck_new, pk = fir_k.fir_rt(h, ck, *x, decim, **kw)
        assert fir_k.FIR_RT.launches == n0 + 1
        yp, cp, pp = fir_k.fir_rt_plain(h, cp, *x, decim, **kw)
        (ar, ai), c2, _ = fir_k.fir_rt(h, ck, *x, decim, planes_out=True,
                                       **kw)
        yr, c3, _ = fir_k.fir_rt(h, ck, *x, decim, real_out=True, **kw)
        torch.cuda.synchronize()
        assert yk.dtype == torch.complex64 and yk.shape == (C, B // decim)
        for a, b in ((yp, yk), (cp, ck_new), (pp, pk), (yp.real, ar),
                     (yp.imag, ai), (yp.real, yr)):
            assert snr_db(a, b) >= FIR_DB
        assert torch.equal(c2, ck_new) and torch.equal(c3, ck_new)
        ck = ck_new
        if use_nco:
            ph = nco.advance(ph, delta, B)


@pytest.mark.parametrize("B,decim,taps,dtype", [
    (16200, 4, 239, "int16"),               # the SAM flagship's front
    (8208, 16, 479, "int16"),               # 192 kHz narrow AM/SAM
    (4100, 1, 89, "float32")])              # the fleet's FM at 48 kHz
def test_fir_rt_batch_invariant(dev, B, decim, taps, dtype):
    """Channels 0-7 of a 1024-channel K5 launch are bit-equal to the same
    8 channels launched alone: no sum's order depends on the channel
    count or a channel's place in the launch."""
    C = 1024
    rng = np.random.default_rng(11)
    h = torch.from_numpy((rng.standard_normal(taps) * 0.05)
                         .astype(np.float32)).to(dev)
    delta = int(nco.freq_to_delta(12000.0, 96000.0))
    carry = torch.from_numpy((0.1 * (rng.standard_normal((C, taps - 1))
                                     + 1j * rng.standard_normal(
                                         (C, taps - 1))))
                             .astype(np.complex64)).to(dev)
    ph = torch.from_numpy(rng.integers(0, 2**32, C)).to(dev)
    x = [torch.from_numpy(_int16(rng, (C, B))).to(dev) for _ in "iq"]
    if dtype == "float32":
        x = [v.to(torch.float32) / 32768.0 for v in x]
    full = fir_k.fir_rt(h, carry, *x, decim, nco=(ph, delta))
    part = fir_k.fir_rt(h, carry[:8].contiguous(),
                        *(v[:8].contiguous() for v in x), decim,
                        nco=(ph[:8].contiguous(), delta))
    torch.cuda.synchronize()
    for a, b in zip(full, part):
        assert torch.equal(a[:8], b)


def _pll_input(rng, C, T, t0, fs=24000.0):
    n = np.arange(t0, t0 + T)
    c = np.arange(C)[:, None]
    amp = 10.0 ** (-1.5 + 1.2 * c / max(C - 1, 1))
    z = (amp * (1 + 0.4 * np.sin(2 * np.pi * 300 * n / fs))
         * np.exp(1j + 2j * np.pi * (2 + 3 * c) * n / fs)
         + 1.5e-3 * (rng.standard_normal((C, T))
                     + 1j * rng.standard_normal((C, T))))
    return torch.from_numpy(z.astype(np.complex64))


@pytest.mark.parametrize("C,T", [(40, 1000), (64, 512), (5, 130)])
def test_pll_kernels_match_plain(dev, C, T):
    sp = sam_mod.make_params(24000.0)
    p = pll_k.PllScalars(sp.g1, sp.g2, sp.omega_min, sp.omega_max)
    mR, mI = sp.fade.mtauR, sp.fade.mtauI
    rng = np.random.default_rng(6)
    ck = cp = torch.zeros((3, C), device=dev)
    ak = apl = torch.zeros((5, C), device=dev)
    for blk in range(3):
        z = _pll_input(rng, C, T, blk * T).to(dev)
        n0, n1 = pll_k.PLL.launches, pll_k.PLL_AUDIO.launches
        cos_k, sin_k, ck = pll_k.pll(p, ck, z)
        aud_k, ak = pll_k.pll_audio(p, mR, mI, ak, z)
        assert (pll_k.PLL.launches, pll_k.PLL_AUDIO.launches) == (n0 + 1,
                                                                  n1 + 1)
        cos_p, sin_p, cp = pll_k.pll_plain(p, cp, z)
        aud_p, apl = pll_k.pll_audio_plain(p, mR, mI, apl, z)
        torch.cuda.synchronize()
        for a, b in ((cos_p, cos_k), (sin_p, sin_k), (aud_p, aud_k),
                     (cp[1:], ck[1:]), (apl[1:], ak[1:]),
                     (cp[0].cos(), ck[0].cos()), (cp[0].sin(), ck[0].sin()),
                     (apl[0].cos(), ak[0].cos())):
            assert float((a - b).abs().max()) <= PLL_ABS
    assert float(ck[2].abs().max()) > 0.0        # the loop found an offset


@pytest.mark.parametrize("C,T,S", [(40, 1000, 7), (64, 256, 7), (9, 130, 1),
                                   (33, 300, 5), (8, 64, 8)])
def test_biquad_kernel_matches_plain(dev, C, T, S):
    rng = np.random.default_rng(7)
    if S == 7:
        sos = torch.from_numpy(sam_mod.allpass_sos(sam_mod.C1)).to(dev)
    else:                       # general stable sections
        r = rng.uniform(0.5, 0.999, S)
        th = rng.uniform(0.1, 3.0, S)
        sos = torch.from_numpy(np.stack(
            [rng.standard_normal(S), rng.standard_normal(S),
             rng.standard_normal(S), -2 * r * np.cos(th), r * r],
            axis=-1).astype(np.float32)).to(dev)
    sk = sp = torch.zeros((S, C, 2), device=dev)
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal((C, T))
                             .astype(np.float32)).to(dev)
        n0 = iir_k.BIQUAD.launches
        yk, sk = iir_k.biquad_cascade(sos, sk, x)
        assert iir_k.BIQUAD.launches == n0 + 1
        yp, sp = iir_k.biquad_cascade_plain(sos, sp, x)
        torch.cuda.synchronize()
        assert snr_db(yp, yk) >= AGC_DB and snr_db(sp, sk) >= AGC_DB


def test_new_wrappers_refuse_what_the_kernels_do_not_take(dev):
    C, T = 4, 64
    z = torch.zeros((C, T), dtype=torch.complex64, device=dev)
    x = torch.zeros((C, T), device=dev)
    p = pll_k.PllScalars(0.1, 0.01, -0.1, 0.1)
    with pytest.raises(ValueError):                 # carry of K9's size
        pll_k.pll(p, torch.zeros((5, C), device=dev), z)
    with pytest.raises(ValueError):                 # real input
        pll_k.pll(p, torch.zeros((3, C), device=dev), x)
    with pytest.raises(ValueError):                 # carry on the CPU
        pll_k.pll_audio(p, 0.9, 0.99, torch.zeros((5, C)), z)
    sos = torch.from_numpy(sam_mod.allpass_sos(sam_mod.C0)).to(dev)
    with pytest.raises(ValueError):                 # state of 6 sections
        iir_k.biquad_cascade(sos, torch.zeros((6, C, 2), device=dev), x)
    with pytest.raises(ValueError):                 # more sections than MAXS
        iir_k.biquad_cascade(torch.zeros((9, 5), device=dev),
                             torch.zeros((9, C, 2), device=dev), x)
    with pytest.raises(ValueError):                 # float64 input
        iir_k.biquad_cascade(sos, torch.zeros((7, C, 2), device=dev),
                             x.to(torch.float64))
    h = torch.zeros(89, device=dev)
    carry = torch.zeros((C, 88), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError):                 # block not a multiple
        fir_k.fir_rt(h, carry, x[:, :63], x[:, :63], 4)
    with pytest.raises(ValueError):                 # mixed plane dtypes
        fir_k.fir_rt(h, carry, x, x.to(torch.int16), 4)
    with pytest.raises(ValueError):                 # decimation 0
        fir_k.fir_rt(h, carry, x, x, 0)
    with pytest.raises(ValueError):                 # taps past the buffers
        fir_k.fir_rt(torch.zeros(20000, device=dev),
                     torch.zeros((C, 19999), dtype=torch.complex64,
                                 device=dev), x, x, 4)
    with pytest.raises(ValueError):                 # look-ahead beyond MAXW
        agc_k.agc(agc_ops.kernel_params(agc_ops.make_params(12000.0)).scalars,
                  torch.zeros((7, C), device=dev),
                  torch.zeros((C, 300), device=dev), x)


def test_failed_build_raises_and_does_not_fall_back(dev, monkeypatch):
    """A kernel whose build fails raises on a CUDA tensor: the wrapper
    does not give way to the plain version."""
    k = iir_k.BIQUAD
    monkeypatch.setattr(k, "_lib", None)
    monkeypatch.setattr(k, "flags", k.flags + ("-DFORCED_BUILD_FAILURE",))
    monkeypatch.setattr(build, "nvcc_path", lambda: "false")
    sos = torch.from_numpy(sam_mod.allpass_sos(sam_mod.C0)).to(dev)
    n0 = k.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        iir_k.biquad_cascade(sos, torch.zeros((7, 4, 2), device=dev),
                             torch.zeros((4, 64), device=dev))
    assert k.launches == n0


@pytest.mark.parametrize("mode,sideband,fade,iq_rate,bw", [
    ("am", "both", True, 96000.0, "5P0KHZ"),
    ("am", "both", False, 48000.0, "3P6KHZ"),
    ("am", "both", True, 48000.0, "5P0KHZ"),      # decimation 2, x2 K4
    ("sam", "both", True, 96000.0, "5P0KHZ"),
    ("sam", "both", False, 96000.0, "5P0KHZ"),
    ("sam", "usb", True, 96000.0, "5P0KHZ"),
    ("sam", "lsb", False, 48000.0, "3P6KHZ")])
def test_am_sam_chain_on_card_matches_cpu(dev, mode, sideband, fade, iq_rate,
                                          bw):
    from uhsdr_tpu_torch import trace_rx
    cfg = rx.RxConfig(mode=mode, bw_key=bw, sam_sideband=sideband,
                      fade_leveler=fade, translate_hz=12000.0,
                      iq_rate=iq_rate, block_len=2048)
    gpu, cpu = rx.RxChain(cfg, device=dev), rx.RxChain(cfg, device="cpu")
    C = 8
    sg, sc = gpu.init_state((C,)), cpu.init_state((C,))
    expect = {k.name: 0 for k in build.kernels()}
    expect.update({"fir_rt": 3, "agc": 3, "interp": 3,
                   "pll_audio": 3 * (mode == "sam" and sideband == "both"
                                     and fade),
                   "pll": 3 * (mode == "sam" and not (sideband == "both"
                                                      and fade)),
                   "biquad": 6 * (mode == "sam" and sideband != "both"),
                   "blocked": 3 * _k2_per_block(cfg, gpu.params)})
    before = {k.name: k.launches for k in build.kernels()}
    for i, q in trace_rx.capture(3, C, "cpu", 4, cfg):
        yg, sg, _ = gpu(sg, i=i, q=q)
        yc, sc, _ = cpu(sc, i=i, q=q)
        assert snr_db(yc, yg.cpu()) >= CHAIN_DB
    for k in build.kernels():
        assert k.launches - before[k.name] == expect[k.name], k.name
    a, b = rx.state_to_numpy(sc), rx.state_to_numpy(sg)
    for f in a:
        if f == "sam.phs":
            assert snr_db(np.cos(a[f]), np.cos(b[f])) >= CHAIN_DB
            assert snr_db(np.sin(a[f]), np.sin(b[f])) >= CHAIN_DB
        else:
            assert snr_db(a[f], b[f]) >= CHAIN_DB, f


def test_cascade_refuses_tf32(dev):
    c = rx.make_params(rx.RxConfig(**FLAGSHIP), dev).audio_sos
    x = torch.zeros((2, 256), device=dev)
    state = torch.zeros((c.sections, 2, 2), device=dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            iir.biquad_cascade_blocked(c, state, x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("C,B,decim,taps,dtype,use_nco", [
    (13, 1600, 4, 245, "int16", True),     # the wide-SSB flagship's front
    (3, 4096, 4, 245, "float32", False),
    (5, 40, 4, 245, "int16", True),        # block shorter than the history
    (7, 1000, 2, 92, "int16", False),      # 10P0KHZ @ 48 kHz
    (4, 999, 1, 89, "float32", True),
    (6, 1536, 8, 131, "int16", True),
    (3, 4104, 8, 491, "int16", True),      # 192 kHz: two row groups, ragged
    (5, 200, 8, 491, "float32", True),     # 192 kHz, shorter than history
    (2, 2400, 2, 1200, "int16", False),    # taps - 1 > 128 x decim
    (4, 4128, 16, 647, "int16", True),     # decimation 16, four groups
    (1, 16384, 4, 245, "int16", True)])    # one channel, four whole tiles
def test_fir_cx_kernels_match_plain(dev, C, B, decim, taps, dtype, use_nco):
    """K6 (no NCO) and K7 (NCO fused) against their plain version, every
    output form, streamed over three blocks; the raw history and the
    peaks bit-equal."""
    rng = np.random.default_rng(8)
    h = torch.from_numpy(((rng.standard_normal(taps)
                           + 1j * rng.standard_normal(taps)) * 0.05)
                         .astype(np.complex64)).to(dev)
    delta = int(nco.freq_to_delta(-12000.0, 96000.0))
    ck = cp = torch.zeros((C, taps - 1), dtype=torch.complex64, device=dev)
    ph = torch.from_numpy(rng.integers(0, 2**32, C)).to(dev)
    counter = fir_k.FIR_CX_NCO if use_nco else fir_k.FIR_CX
    other = fir_k.FIR_CX if use_nco else fir_k.FIR_CX_NCO
    for blk in range(3):
        x = [torch.from_numpy(_int16(rng, (C, B))).to(dev) for _ in "iq"]
        if dtype == "float32":
            x = [v.to(torch.float32) / 32768.0 for v in x]
        kw = dict(nco=(ph, delta) if use_nco else None)
        n0, n_other = counter.launches, other.launches
        yr, ck_new, pk = fir_k.fir_cx(h, ck, *x, decim, real_out=True, **kw)
        assert (counter.launches, other.launches) == (n0 + 1, n_other)
        yp, cp, pp = fir_k.fir_cx_plain(h, cp, *x, decim, **kw)
        yk, c2, _ = fir_k.fir_cx(h, ck, *x, decim, **kw)
        (ar, ai), c3, _ = fir_k.fir_cx(h, ck, *x, decim, planes_out=True,
                                       **kw)
        torch.cuda.synchronize()
        assert yk.dtype == torch.complex64 and yk.shape == (C, B // decim)
        for a, b in ((yp.real, yr), (yp, yk), (yp.real, ar), (yp.imag, ai)):
            assert snr_db(a, b) >= FIR_DB
        assert torch.equal(cp, ck_new) and torch.equal(pp, pk)
        assert torch.equal(c2, ck_new) and torch.equal(c3, ck_new)
        ck = ck_new
        if use_nco:
            ph = nco.advance(ph, delta, B)


@pytest.mark.parametrize("B,decim,taps,dtype,use_nco,out", [
    (16400, 4, 245, "int16", True, "real"),      # the flagship's, 5 tiles
    (4104, 8, 491, "int16", False, "planes"),    # two row groups
    (200, 8, 491, "float32", True, "complex"),   # shorter than history
    (4128, 16, 647, "int16", True, "real")])     # four row groups
def test_fir_cx_batching_changes_no_bit(dev, B, decim, taps, dtype, use_nco,
                                        out):
    """Channel c of a C-channel K6/K7 launch equals the same channel
    launched alone, bit for bit: no sum's order depends on the channel
    count or a channel's place in the launch."""
    C = 5
    rng = np.random.default_rng(21)
    h = torch.from_numpy(((rng.standard_normal(taps)
                           + 1j * rng.standard_normal(taps)) * 0.05)
                         .astype(np.complex64)).to(dev)
    delta = int(nco.freq_to_delta(12000.0, 96000.0))
    carry = torch.from_numpy((0.1 * (rng.standard_normal((C, taps - 1))
                                     + 1j * rng.standard_normal(
                                         (C, taps - 1))))
                             .astype(np.complex64)).to(dev)
    ph = torch.from_numpy(rng.integers(0, 2**32, C)).to(dev)
    x = [torch.from_numpy(_int16(rng, (C, B))).to(dev) for _ in "iq"]
    if dtype == "float32":
        x = [v.to(torch.float32) / 32768.0 for v in x]
    kw = dict(real_out=out == "real", planes_out=out == "planes")

    def run(sl):
        y, c_new, pk = fir_k.fir_cx(
            h, carry[sl].contiguous(), *(v[sl].contiguous() for v in x),
            decim, nco=(ph[sl].contiguous(), delta) if use_nco else None,
            **kw)
        return (*(y if isinstance(y, tuple) else (y,)), c_new, pk)
    full = run(slice(None))
    for c in range(C):
        for a, b in zip(full, run(slice(c, c + 1))):
            assert torch.equal(a[c], b[0]), c


def test_fir_cx_geometry_matches_library(dev):
    """The library's K6/K7 shared memory is `fir_cx_geometry`'s at every
    shape the wide rows send (48, 96 and 192 kHz) and past them, and both
    refuse the same shapes."""
    lib = fir_k.FRONT.lib()
    shapes = [(92, 2), (131, 4), (245, 4), (491, 8), (323, 8), (647, 16),
              (1200, 2), (89, 1), (245, 16), (5000, 4), (20000, 2),
              (60000, 16)]
    for taps, decim in shapes:
        for size in (2, 4):
            try:
                want = fir_k.fir_cx_geometry(taps, decim, size).smem
            except ValueError:
                want = -1
            assert lib.uhsdr_fir_cx_smem(taps, decim, size) == want, (
                taps, decim, size)


def _wrapped_err(ref, got) -> float:
    """max |ref - got| of two angle tensors, modulo 2 pi."""
    d = torch.remainder(ref.double() - got.double() + np.pi, 2 * np.pi)
    return float((d - np.pi).abs().max())


@pytest.mark.parametrize("C,T,planes", [(40, 1000, False), (7, 4096, True),
                                        (300, 33, False), (3, 1, False)])
def test_fm_disc_kernel_matches_plain(dev, C, T, planes):
    rng = np.random.default_rng(9)
    zp = torch.from_numpy((rng.standard_normal(C) + 1j
                           * rng.standard_normal(C)).astype(np.complex64))
    prev = zp.to(dev)
    for _ in range(3):
        z = torch.from_numpy((rng.standard_normal((C, T)) + 1j
                              * rng.standard_normal((C, T)))
                             .astype(np.complex64)).to(dev)
        arg = (z.real.contiguous(), z.imag.contiguous()) if planes else z
        n0 = ew_k.FM_DISC.launches
        yk = ew_k.fm_disc(prev, arg)
        assert ew_k.FM_DISC.launches == n0 + 1
        yp = ew_k.fm_disc_plain(prev, z)
        torch.cuda.synchronize()
        assert yk.shape == (C, T) and yk.dtype == torch.float32
        assert _wrapped_err(yp, yk) <= DISC_ABS
        prev = z[:, -1].contiguous()


def test_slice3_wrappers_refuse_what_the_kernels_do_not_take(dev):
    C, T = 4, 64
    x = torch.zeros((C, T), device=dev)
    h = torch.zeros(89, dtype=torch.complex64, device=dev)
    carry = torch.zeros((C, 88), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError):                 # real taps
        fir_k.fir_cx(h.real.contiguous(), carry, x, x, 4)
    with pytest.raises(ValueError, match="shared memory"):
        fir_k.fir_cx(torch.zeros(20000, dtype=torch.complex64, device=dev),
                     torch.zeros((C, 19999), dtype=torch.complex64,
                                 device=dev), x, x, 2)
    with pytest.raises(ValueError):                 # carry on the CPU
        fir_k.fir_cx(h, carry.cpu(), x, x, 4)
    z = torch.zeros((C, T), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError):                 # real input
        ew_k.fm_disc(torch.zeros(C, dtype=torch.complex64, device=dev), x)
    with pytest.raises(ValueError):                 # z_prev of another size
        ew_k.fm_disc(torch.zeros(C + 1, dtype=torch.complex64, device=dev), z)


@pytest.mark.parametrize("mode,bw,iq_rate,translate,sql,subtone", [
    ("fm", "3P6KHZ", 48000.0, 12000.0, 0, 0.0),
    ("fm", "5P0KHZ", 96000.0, 12000.0, 10, 88.5),
    ("usb", "5P0KHZ", 96000.0, 12000.0, 0, 0.0),      # K7
    ("usb", "5P0KHZ", 192000.0, 12000.0, 0, 0.0),     # K7, decim 8
    ("usb", "4P0KHZ", 48000.0, 0.0, 0, 0.0),          # K6, both lattices
    ("lsb", "10P0KHZ", 48000.0, 12000.0, 0, 0.0)])
def test_fm_wide_chain_on_card_matches_cpu(dev, mode, bw, iq_rate, translate,
                                           sql, subtone):
    from uhsdr_tpu_torch import trace_rx
    cfg = rx.RxConfig(mode=mode, bw_key=bw, translate_hz=translate,
                      iq_rate=iq_rate, block_len=2048, sql_threshold=sql,
                      subtone_hz=subtone)
    gpu, cpu = rx.RxChain(cfg, device=dev), rx.RxChain(cfg, device="cpu")
    C = 8
    sg, sc = gpu.init_state((C,)), cpu.init_state((C,))
    fm = mode == "fm"
    expect = {k.name: 0 for k in build.kernels()}
    expect.update({"agc": 3} if fm else {"agc": 3, "interp": 3})
    expect["fir_rt" if fm else "fir_cx_nco" if translate else "fir_cx"] = 3
    if fm:
        expect["fm_disc"] = 3
    expect["blocked"] = 3 * _k2_per_block(cfg, gpu.params)
    before = {k.name: k.launches for k in build.kernels()}
    for i, q in trace_rx.capture(3, C, "cpu", 4, cfg):
        yg, sg, _ = gpu(sg, i=i, q=q)
        yc, sc, _ = cpu(sc, i=i, q=q)
        assert snr_db(yc, yg.cpu()) >= CHAIN_DB
    for k in build.kernels():
        assert k.launches - before[k.name] == expect[k.name], k.name
    a, b = rx.state_to_numpy(sc), rx.state_to_numpy(sg)
    for f in a:
        if a[f].dtype == bool or a[f].dtype.kind in "iu":
            assert np.array_equal(a[f], b[f]), f
        else:
            assert snr_db(a[f], b[f]) >= CHAIN_DB, f


@pytest.mark.parametrize("kw", [FLAGSHIP, dict(mode="usb", bw_key="5P0KHZ",
                                               path_name="LPF",
                                               translate_hz=12000.0,
                                               iq_rate=96000.0),
                                dict(FLAGSHIP, mode="ssbstereo")])
def test_retuned_chain_on_card_matches_cpu(dev, kw):
    """tune_offset_hz moved between blocks, on the card and on the CPU."""
    from uhsdr_tpu_torch import trace_rx
    cfg = rx.RxConfig(**kw, block_len=2048)
    gpu, cpu = rx.RxChain(cfg, device=dev), rx.RxChain(cfg, device="cpu")
    C = 8
    sg, sc = gpu.init_state((C,)), cpu.init_state((C,))
    for (i, q), off in zip(trace_rx.capture(3, C, "cpu", 5, cfg),
                           (None, 350.0, -1234.5)):
        yg, sg, _ = gpu(sg, i=i, q=q, tune_offset_hz=off)
        yc, sc, _ = cpu(sc, i=i, q=q, tune_offset_hz=off)
        assert snr_db(yc, yg.cpu()) >= CHAIN_DB
    assert torch.equal(sg.nco_phase.cpu(), sc.nco_phase)


# ---------------------------------------------------------------------------
# the two-channel modes (K13, K1 with two stage-B filters) and TX (K8, the
# ALC recurrence)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,T,fs", [(40, 1000, 12000.0), (64, 2048, 12000.0),
                                    (33, 130, 24000.0), (5, 300, 48000.0)])
def test_agc_scan_kernel_matches_plain(dev, C, T, fs):
    """K13 against its plain version, bit for bit (both repeat the machine
    step's operations in order; the kernel is built with -fmad=false)."""
    params = agc_ops.make_params(fs, mode="med", hang_enable=True)
    p = agc_ops.kernel_params(params).scalars
    w = params.attack_buffsize
    rng = np.random.default_rng(10)
    ck = cp = torch.zeros((agc_k.N_CARRY, C), device=dev)
    level = np.logspace(-1, 4, C)[:, None]
    for blk in range(3):
        n = np.arange(blk * T, (blk + 1) * T + w)
        a = np.abs(level * np.sin(2 * np.pi * 700 * n / fs) * (n < 1.5 * T)
                   + rng.standard_normal((C, T + w)) * 0.5)
        a = torch.from_numpy(a.astype(np.float32)).to(dev)
        rm = agc_k.look_ahead_max(a, w, T).contiguous()
        ax = a[:, :T].contiguous()
        n0 = agc_k.AGC_SCAN.launches
        vk, ck = agc_k.agc_scan(p, ck, rm, ax)
        assert agc_k.AGC_SCAN.launches == n0 + 1
        vp, cp = agc_k.agc_scan_plain(p, cp, rm, ax)
        torch.cuda.synchronize()
        assert torch.equal(vp, vk) and torch.equal(cp, ck)


@pytest.mark.parametrize("iq_rate,C,B,mode,dtype", [
    (96000.0, 13, 1600, "ssbstereo", "int16"),
    (96000.0, 3, 4096, "iq", "float32"),
    (48000.0, 5, 2000, "ssbstereo", "int16"),
    (96000.0, 6, 400, "iq", "int16"),          # block shorter than history
    (192000.0, 3, 1600, "ssbstereo", "float32"),   # shorter than n_keep
    (96000.0, 2, 9000, "ssbstereo", "int16")])     # two tiles, ragged
def test_front_pair_kernel_matches_plain(dev, iq_rate, C, B, mode, dtype):
    """K1 with the two-channel modes' two stage-B filters and the pair's
    long raw history, against its plain version."""
    cfg = rx.RxConfig(**{**FLAGSHIP, "iq_rate": iq_rate, "mode": mode})
    p = rx.make_params(cfg, dev)
    h, g, delta = p.front_fir, p.front2, p.nco_delta
    assert g.shape[0] == 2
    n_keep = rx._raw_history_len(cfg, p)
    rng = np.random.default_rng(11)
    ck = cp = torch.zeros((C, n_keep), dtype=torch.complex64, device=dev)
    c2k = c2p = torch.zeros((C, g.shape[-1] - 1), dtype=torch.complex64,
                            device=dev)
    ph = torch.from_numpy(rng.integers(0, 2**32, C)).to(dev)
    for _ in range(3):
        x = [torch.from_numpy(_int16(rng, (C, B))).to(dev) for _ in "iq"]
        if dtype == "float32":
            x = [v.to(torch.float32) / 32768.0 for v in x]
        n0, n1 = fir_k.FRONT_PAIR.launches, fir_k.FRONT.launches
        yk, ck, c2k, pk = fir_k.front(h, g, ck, c2k, *x, ph, delta,
                                      cfg.decim)
        assert (fir_k.FRONT_PAIR.launches, fir_k.FRONT.launches) == (n0 + 1,
                                                                     n1)
        yp, cp, c2p, pp = fir_k.front_plain(h, g, cp, c2p, *x, ph, delta,
                                            cfg.decim)
        torch.cuda.synchronize()
        assert yk.shape == (C, 2, B // cfg.decim)
        for a, b in ((yp, yk), (c2p, c2k), (pp, pk)):
            assert snr_db(a, b) >= FIR_DB
        assert torch.equal(cp, ck)
        ph = nco.advance(ph, delta, B)


def _fir_real_case(rng, dev, C, taps):
    h = torch.from_numpy(((rng.standard_normal(taps)
                           + 1j * rng.standard_normal(taps)) * 0.05)
                         .astype(np.complex64)).to(dev)
    ph = torch.from_numpy(rng.integers(0, 2**32, C)).to(dev)
    return h, ph, int(nco.freq_to_delta(6000.0, 48000.0))


@pytest.mark.parametrize("C,B,taps,use_nco,conj", [
    (13, 1600, 201, True, False), (3, 4096, 201, True, True),
    (5, 100, 201, False, False),        # blocks shorter than the history
    (7, 999, 201, False, True),
    (1, 16384, 201, True, False),       # one channel, eight whole tiles
    (4, 1, 201, True, True),            # one sample a block
    (6, 31, 31, False, False), (5, 33, 2, True, False),
    (3, 1023, 400, True, True),
    (2, 300, 400, False, True),         # shorter than the history
    (9, 2049, 201, False, False),       # a whole tile and one sample
    (3, 4101, 31, True, False)])        # rows not 16-byte aligned
def test_fir_real_kernel_matches_plain(dev, C, B, taps, use_nco, conj):
    """K8 against its plain version over three streamed blocks, the new
    history bit-equal."""
    rng = np.random.default_rng(12)
    h, ph, delta = _fir_real_case(rng, dev, C, taps)
    ck = cp = torch.zeros((C, taps - 1), device=dev)
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal((C, B))
                             .astype(np.float32)).to(dev)
        kw = dict(nco=(ph, delta) if use_nco else None, conj=conj)
        n0 = fir_k.FIR_REAL.launches
        yk, ck = fir_k.fir_real(h, ck, x, **kw)
        assert fir_k.FIR_REAL.launches == n0 + 1
        yp, cp = fir_k.fir_real_plain(h, cp, x, **kw)
        torch.cuda.synchronize()
        assert yk.dtype == torch.complex64 and yk.shape == (C, B)
        assert snr_db(yp, yk) >= FIR_DB and torch.equal(cp, ck)
        ph = nco.advance(ph, delta, B)


@pytest.mark.parametrize("B,use_nco,conj", [(2049, True, False),
                                            (100, True, True),
                                            (1, False, False)])
def test_fir_real_batching_changes_no_bit(dev, B, use_nco, conj):
    """Channel c of a C-channel K8 launch equals the same channel launched
    alone, bit for bit (one tile and more; the taps split over groups at
    B = 100 and 1)."""
    C, taps = 5, 201
    rng = np.random.default_rng(15)
    h, ph, delta = _fir_real_case(rng, dev, C, taps)
    carry = torch.from_numpy(rng.standard_normal((C, taps - 1))
                             .astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((C, B))
                         .astype(np.float32)).to(dev)
    kw = dict(conj=conj)
    y, c_new = fir_k.fir_real(h, carry, x, nco=(ph, delta) if use_nco
                              else None, **kw)
    for c in range(C):
        yc, cc = fir_k.fir_real(h, carry[c:c + 1].contiguous(),
                                x[c:c + 1].contiguous(),
                                nco=(ph[c:c + 1], delta) if use_nco
                                else None, **kw)
        assert torch.equal(yc[0], y[c]) and torch.equal(cc[0], c_new[c])


def test_fir_real_geometry_matches_library(dev):
    """The library's K8 shared memory is `fir_real_geometry`'s, and both
    refuse the same shapes."""
    lib = fir_k.FIR_REAL.lib()
    for taps in (2, 31, 201, 400, 2000, 20000):
        for B in (0, 1, 31, 100, 1023, 2049, 4096, 16384):
            try:
                want = fir_k.fir_real_geometry(taps, B).smem
            except ValueError:
                want = -1
            assert lib.uhsdr_fir_real_smem(taps, B) == want, (taps, B)


def _alc_audio(rng, C, n0, T):
    """Audio in the count domain across the knee (3e4): 700 Hz bursts at
    1e3 ... 1e5 counts, gated on and off, plus noise."""
    n = np.arange(n0, n0 + T)
    x = (np.logspace(3, 5, C)[:, None] * np.sin(2 * np.pi * 700 * n / 48000.0)
         * (n % 700 < 400) + rng.standard_normal((C, T)))
    return x.astype(np.float32)


# (C, block lengths, delay, decay, gain_scaling): the middle block ragged
# (no multiple of the 32-step tile); the TX flagship's D = 288 and the
# legacy front's 64; D > T; D = 0; rows not 16-byte aligned (T or D no
# multiple of 4: the 4-byte copies); channel counts past 4 x 132 (more
# than one channel lane a walker); AM's gain scaling 0.23
@pytest.mark.parametrize("C,lengths,D,decay,gs", [
    (40, (1000, 1000, 1000), 288, 3.1622776e-05, 1.0),
    (64, (2048, 2048, 2048), 64, 0.02, 1.0),
    (5, (130, 130, 130), 288, 0.02, 1.0),
    (37, (4096, 1000, 4096), 288, 3.1622776e-05, 0.23),
    (9, (100, 37, 100), 288, 0.02, 0.23),
    (600, (256, 70, 256), 288, 3.1622776e-05, 1.0),
    (1100, (96, 33, 96), 0, 0.02, 1.0),
    (70, (512, 201, 512), 290, 0.02, 0.23),
])
def test_alc_kernel_matches_plain(dev, C, lengths, D, decay, gs):
    """The fused ALC stage against its plain version, bit for bit, on y,
    alc_val and the new delay line, over three streamed blocks of audio
    that crosses the knee in both directions; the new delay line is a
    fresh (C, D) tensor."""
    from uhsdr_tpu_torch.cuda import alc as alc_k
    from uhsdr_tpu_torch.mod import alc as alc_mod
    params = alc_mod.make_params(decay, D, 4.0, gs)
    rng = np.random.default_rng(13)
    vk = vp = torch.ones(C, device=dev)
    dk = dp = torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32)
                               * 1e3).to(dev)
    n0 = 0
    for T in lengths:
        x = torch.from_numpy(_alc_audio(rng, C, n0, T)).to(dev)
        n0 += T
        launches = alc_k.ALC.launches
        yk, vk, dk = alc_k.alc_run(params, vk, dk, x)
        assert alc_k.ALC.launches == launches + 1
        yp, vp, dp = alc_k.alc_run_plain(params, vp, dp, x)
        torch.cuda.synchronize()
        assert torch.equal(yp, yk) and torch.equal(vp, vk)
        assert torch.equal(dp, dk) and dk.shape == (C, D)
        assert dk.untyped_storage().nbytes() == 4 * C * D
    if decay < 1e-3:                      # a slow recovery: the gain moved
        assert float(vk.min()) < 0.9


def _alc_edge_audio(rng, C, n0, T, pg):
    """ALC input where the walker's fast division is not div.rn's or is
    not taken, by channel class c % 9: 0, 7, 8 the audio of _alc_audio; 1
    that audio with every 11th sample one of +-0, subnormals, |xp| just
    below, at and just above 2^-80, just below and past 2^100, 3e38 and
    +-inf (pg: the post-filter gain); 2 subnormal audio; 3 exact zeros
    (-0 at odd samples); 4 audio around |xp| = 2^-80; 5 audio past 2^100;
    6 one NaN at sample 1500 of the stream."""
    x = _alc_audio(rng, C, n0, T)
    n = np.arange(n0, n0 + T)
    lo, hi = 2.0 ** -80 / pg, 2.0 ** 100 / pg
    special = np.array(
        [0.0, -0.0, 1e-45, -3e-42, 1e-39, -1.1e-38, lo * (1 - 2 ** -12), lo,
         -lo * (1 + 2 ** -12), hi * (1 - 2 ** -12), -hi * (1 + 2 ** -12),
         3e38, -np.inf, np.inf], np.float32)
    cls = np.arange(C) % 9
    pick = (n % 11 == 3)
    x[np.ix_(cls == 1, pick)] = special[(n[pick] // 11) % special.size]
    x[cls == 2] *= np.float32(1e-43)
    x[cls == 3] = np.where(n % 2 == 1, -0.0, 0.0).astype(np.float32)
    x[cls == 4] = (rng.standard_normal(((cls == 4).sum(), T)) * 2.0
                   * lo).astype(np.float32)
    x[cls == 5] *= np.float32(2.0 ** 90)
    if n0 <= 1500 < n0 + T:
        x[cls == 6, 1500 - n0] = np.nan
    return x


def _alc_bits_equal(a, b):
    """Bit for bit, a NaN matching a NaN."""
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (a.isnan() & b.isnan())).all())


# (C, block lengths, delay, decay, gain_scaling): the middle block ragged;
# D > T; more than one channel lane a walker; a negative decay (the walker
# never takes the fast division then)
@pytest.mark.parametrize("C,lengths,D,decay,gs", [
    (45, (1000, 777, 1000), 288, 3.1622776e-05, 1.0),
    (45, (100, 37, 100), 288, 0.02, 0.23),
    (1100, (512, 201, 1024), 64, 0.02, 1.0),
    (45, (1000, 777, 1000), 288, -0.02, 1.0),
])
def test_alc_kernel_outside_the_fast_division(dev, C, lengths, D, decay, gs):
    """The fused ALC stage against its plain version, bit for bit on y,
    alc_val and the delay line, where the walker takes div.rn: tiles and
    ragged tails holding zeros, subnormals, values either side of the fast
    division's range, infinities and a NaN (_alc_edge_audio); channels
    whose alc_val starts outside [VAL_MIN, 1] (2, 5e-4, 0, a subnormal,
    -0.5, just below VAL_MIN); a negative decay."""
    from uhsdr_tpu_torch.cuda import alc as alc_k
    from uhsdr_tpu_torch.mod import alc as alc_mod
    params = alc_mod.make_params(decay, D, 4.0, gs)
    rng = np.random.default_rng(15)
    v0 = np.ones(C, np.float32)
    outside = np.array([2.0, 5e-4, 0.0, 1e-40, -0.5, 0.0009], np.float32)
    c7 = np.flatnonzero(np.arange(C) % 9 >= 7)
    v0[c7] = outside[np.arange(c7.size) % outside.size]
    vk = vp = torch.from_numpy(v0).to(dev)
    dk = dp = torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32)
                               * 1e3).to(dev)
    n0 = 0
    for T in lengths:
        x = torch.from_numpy(_alc_edge_audio(rng, C, n0, T,
                                             params.postfilt_gain)).to(dev)
        n0 += T
        yk, vk, dk = alc_k.alc_run(params, vk, dk, x)
        yp, vp, dp = alc_k.alc_run_plain(params, vp, dp, x)
        torch.cuda.synchronize()
        assert _alc_bits_equal(yp, yk) and _alc_bits_equal(vp, vk)
        assert _alc_bits_equal(dp, dk)
    assert n0 < 1500 or bool(vk[6::9].isnan().all())


def test_alc_first_channels_alone_match_the_batch(dev):
    """Channels 0-7 alone (one channel lane a walker) give the bits they
    give in a batch of 8192 (sixteen lanes)."""
    from uhsdr_tpu_torch.cuda import alc as alc_k
    from uhsdr_tpu_torch.mod import alc as alc_mod
    params = alc_mod.make_params(3.1622776e-05, 288, 4.0, 1.0)
    rng = np.random.default_rng(14)
    C, T = 8192, 256
    x = torch.from_numpy(_alc_audio(rng, C, 0, T)).to(dev)
    v = torch.ones(C, device=dev)
    d = torch.zeros((C, 288), device=dev)
    assert alc_k.alc_geometry(C, T).lanes == 16
    y, v1, d1 = alc_k.alc_run(params, v, d, x)
    y8, v8, d8 = alc_k.alc_run(params, v[:8], d[:8], x[:8].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(y[:8], y8) and torch.equal(v1[:8], v8)
    assert torch.equal(d1[:8], d8)


def test_alc_fast_division_is_div_rn_where_used(dev):
    """The walker's three-FFMA division is div.rn's, bit for bit, on every
    non-negative f32 where it is used (one launch over all 2^31 - 2^23 + 1
    bit patterns from +0 to +inf)."""
    from uhsdr_tpu_torch.cuda import alc as alc_k
    n_in, n_out, n_all = alc_k.alc_division_check(dev)
    assert n_all == 0x7F800001 and n_in == 0


def test_alc_smem_matches_the_rule(dev):
    """The library's block layout and shared memory are `alc_geometry`'s,
    within the card's opt-in limit."""
    from uhsdr_tpu_torch.cuda import alc as alc_k
    lib = alc_k._lib()
    for C in (1, 8, 528, 529, 1024, 4096, 8192, 16384, 16896, 40000):
        geo = alc_k.alc_geometry(C, 100)
        assert lib.uhsdr_alc_smem(geo.lanes) == geo.smem <= build.SMEM_OPT_IN
    assert lib.uhsdr_alc_smem(0) == lib.uhsdr_alc_smem(33) == -1


def test_slice4_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from uhsdr_tpu_torch.cuda import alc as alc_k
    C, T = 4, 64
    x = torch.zeros((C, T), device=dev)
    p = agc_ops.kernel_params(agc_ops.make_params(12000.0)).scalars
    with pytest.raises(ValueError):                 # carry of 6 rows
        agc_k.agc_scan(p, torch.zeros((6, C), device=dev), x, x)
    with pytest.raises(ValueError):                 # shapes differ
        agc_k.agc_scan(p, torch.zeros((7, C), device=dev), x, x[:, :32])
    h = torch.zeros(201, dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError):                 # complex carry
        fir_k.fir_real(h, torch.zeros((C, 200), dtype=torch.complex64,
                                      device=dev), x)
    with pytest.raises(ValueError, match="shared memory"):  # too many taps
        fir_k.fir_real(torch.zeros(20000, dtype=torch.complex64, device=dev),
                       torch.zeros((C, 19999), device=dev), x)
    from uhsdr_tpu_torch.mod import alc as alc_mod
    ap = alc_mod.make_params(0.02, 64, 4.0, 1.0)
    with pytest.raises(ValueError):                 # alc_val of C + 1
        alc_k.alc_run(ap, torch.ones(C + 1, device=dev),
                      torch.zeros((C, 64), device=dev), x)
    with pytest.raises(ValueError):                 # a delay line of 63
        alc_k.alc_run(ap, torch.ones(C, device=dev),
                      torch.zeros((C, 63), device=dev), x)
    cfg = rx.RxConfig(**{**FLAGSHIP, "mode": "ssbstereo"})
    pp = rx.make_params(cfg, dev)
    xi = torch.zeros((C, 256), dtype=torch.int16, device=dev)
    ph = torch.zeros(C, dtype=torch.int64, device=dev)
    c2 = torch.zeros((C, pp.front2.shape[-1] - 1), dtype=torch.complex64,
                     device=dev)
    with pytest.raises(ValueError):                 # raw history too short
        fir_k.front(pp.front_fir, pp.front2,
                    torch.zeros((C, 100), dtype=torch.complex64, device=dev),
                    c2, xi, xi, ph, pp.nco_delta, cfg.decim)
    with pytest.raises(ValueError):                 # three stage-B filters
        fir_k.front(pp.front_fir, torch.cat([pp.front2, pp.front2[:1]]),
                    torch.zeros((C, 226), dtype=torch.complex64, device=dev),
                    c2, xi, xi, ph, pp.nco_delta, cfg.decim)


def _launch_deltas(before):
    return {k.name: k.launches - before[k.name] for k in build.kernels()}


@pytest.mark.parametrize("mode,sideband,iq_rate,bw", [
    ("ssbstereo", "both", 96000.0, "2P3KHZ"),
    ("iq", "both", 48000.0, "2P3KHZ"),
    ("sam", "stereo", 96000.0, "5P0KHZ"),
    ("sam", "stereo", 48000.0, "3P6KHZ")])
def test_two_channel_chain_on_card_matches_cpu(dev, mode, sideband, iq_rate,
                                               bw):
    from uhsdr_tpu_torch import trace_rx
    cfg = rx.RxConfig(mode=mode, bw_key=bw, sam_sideband=sideband,
                      translate_hz=12000.0, iq_rate=iq_rate, block_len=2048)
    gpu, cpu = rx.RxChain(cfg, device=dev), rx.RxChain(cfg, device="cpu")
    C = 8
    sg, sc = gpu.init_state((C,)), cpu.init_state((C,))
    sam = mode == "sam"
    expect = {k.name: 0 for k in build.kernels()}
    expect.update({"agc_scan": 3, "interp": 3})
    expect.update({"fir_rt": 3, "pll": 3, "biquad": 6} if sam
                  else {"front_pair": 3})
    expect["blocked"] = 3 * _k2_per_block(cfg, gpu.params)
    before = {k.name: k.launches for k in build.kernels()}
    for i, q in trace_rx.capture(3, C, "cpu", 4, cfg):
        yg, sg, _ = gpu(sg, i=i, q=q)
        yc, sc, _ = cpu(sc, i=i, q=q)
        assert yg.shape == (C, 2, 2048)
        assert snr_db(yc, yg.cpu()) >= CHAIN_DB
    assert _launch_deltas(before) == expect
    a, b = rx.state_to_numpy(sc, cfg), rx.state_to_numpy(sg, cfg)
    for f in a:
        if f == "sam.phs":
            assert snr_db(np.cos(a[f]), np.cos(b[f])) >= CHAIN_DB
            assert snr_db(np.sin(a[f]), np.sin(b[f])) >= CHAIN_DB
        elif a[f].dtype.kind in "iu":
            assert np.array_equal(a[f], b[f]), f
        else:
            assert snr_db(a[f], b[f]) >= CHAIN_DB, f


@pytest.mark.parametrize("mode,front", [("usb", "ref"), ("lsb", "ref"),
                                        ("am", "ref"), ("cw", "ref"),
                                        ("lsb", "scipy")])
def test_tx_chain_on_card_matches_cpu(dev, mode, front):
    from uhsdr_tpu_torch.chain import tx
    cfg = tx.TxConfig(mode=mode, front=front, block_len=2048)
    gpu, cpu = tx.TxChain(cfg, device=dev), tx.TxChain(cfg, device="cpu")
    C = 8
    sg, sc = gpu.init_state((C,)), cpu.init_state((C,))
    rng = np.random.default_rng(14)
    before = {k.name: k.launches for k in build.kernels()}
    for blk in range(3):
        n = np.arange(blk * 2048, (blk + 1) * 2048)
        a = (np.logspace(-2, 0, C)[:, None]
             * np.sin(2 * np.pi * 700 * n / 48000.0)
             + 0.01 * rng.standard_normal((C, 2048))).astype(np.float32)
        if mode == "cw":
            a = (np.abs(a) > 0.1).astype(np.float32)
        ig, qg, sg = gpu(sg, a)
        ic, qc, sc = cpu(sc, a)
        assert snr_db(torch.complex(ic, qc),
                      torch.complex(ig, qg).cpu()) >= CHAIN_DB
    voice = mode != "cw"
    expect = {k.name: 0 for k in build.kernels()}
    expect.update({"fir_real": 3 * voice, "alc": 3 * voice,
                   "blocked": 3 * voice})
    assert _launch_deltas(before) == expect
    a, b = tx.state_to_numpy(sc), tx.state_to_numpy(sg)
    for f in a:
        if a[f].dtype.kind in "iu":
            assert np.array_equal(a[f], b[f]), f
        else:
            assert snr_db(a[f], b[f]) >= CHAIN_DB, f


# ---------------------------------------------------------------------------
# K2 (the fused blocked cascade), K14 (the grouped biquad scan), K15 (the
# modulated-taps front)
# ---------------------------------------------------------------------------

# K2 sums the Toeplitz products in another order than cuBLAS does for its
# plain version; on SOPRANO's poles near z = 1 the two f32 forms sit about
# 95-110 dB apart (tests/test_torch_blocked.py), so 90 dB, the bound
# chip_smoke.py holds K2 to
K2_DB = 90.0


def _sos5(name):
    from uhsdr_tpu_torch.chain import tx
    if name == "prefilter":
        return rx._lattice_sos5(rx.RxConfig(**FLAGSHIP).ref_path["pre"])
    if name == "squelch":
        return rx.make_params(rx.FM_FLAGSHIP, "cpu").fm.squelch_sos.sos \
            .numpy()
    if name.startswith("butter"):     # butter1 / butter8: 1 or 8 sections
        from scipy import signal
        sos = signal.butter(2 * int(name[6:]), 0.05, output="sos")
        return np.concatenate([sos[:, :3], sos[:, 4:]], axis=1)
    return tx._lattice_sos5("IIR_TX_SOPRANO")


@pytest.mark.parametrize("name,lead,lengths", [
    ("prefilter", (40,), (1024, 1920, 2176)),
    ("prefilter", (9, 2), (384, 256, 512)),         # the stereo layout
    ("soprano", (13,), (2048, 640, 128 * 17)),
    ("squelch", (8,), (1024, 384, 1024)),
    ("prefilter", (1024,), (4096, 4096, 256)),      # the fleet's shape
    ("squelch", (1024,), (16384, 256)),             # the fleet's squelch
    ("prefilter", (1,), (256, 384, 2048)),          # one channel
    ("soprano", (3,), (256, 16384, 640)),
    ("prefilter", (1000,), (256, 2048, 4096)),      # no whole block
    ("butter1", (37,), (256, 1280, 512)),           # 1 section
    ("butter8", (70,), (512, 256, 2048))])          # 8 sections
def test_blocked_kernel_matches_plain(dev, name, lead, lengths):
    c = iir.cascade(_sos5(name), dev)
    S = c.sections
    rng = np.random.default_rng(21)
    sk = sp = torch.zeros((S,) + lead + (2,), device=dev)
    for T in lengths:
        x = torch.from_numpy((rng.standard_normal(lead + (T,)) * 0.1)
                             .astype(np.float32)).to(dev)
        n0 = iir_k.BLOCKED.launches
        yk, sk = iir_k.blocked_cascade(c, sk, x)
        assert iir_k.BLOCKED.launches == n0 + 1
        yp, sp = iir_k.blocked_cascade_plain(c, sp, x)
        torch.cuda.synchronize()
        assert yk.shape == x.shape and sk.shape == sp.shape
        assert snr_db(yp, yk) >= K2_DB and snr_db(sp, sk) >= K2_DB


@pytest.mark.parametrize("name,C,T", [("prefilter", 8192, 2048),
                                      ("prefilter", 1024, 4096),
                                      ("squelch", 300, 1024)])
def test_blocked_channels_alone_are_bit_equal(dev, name, C, T):
    """Channels 0-7 run alone give the bits they give in the full batch
    (another launch geometry: `blocked_geometry` picks 4 channels a block
    for 8 and 8 or 4 for the batch): no sum's order depends on the
    channel count or a channel's place in the launch."""
    c = iir.cascade(_sos5(name), dev)
    S = c.sections
    rng = np.random.default_rng(25)
    x = torch.from_numpy((rng.standard_normal((C, T)) * 0.1)
                         .astype(np.float32)).to(dev)
    s0 = torch.from_numpy((rng.standard_normal((S, C, 2)) * 1e-3)
                          .astype(np.float32)).to(dev)
    y, st = iir_k.blocked_cascade(c, s0, x)
    ya, sa = iir_k.blocked_cascade(c, s0[:, :8].contiguous(),
                                   x[:8].contiguous())
    torch.cuda.synchronize()
    assert iir_k.blocked_geometry(C, T, S) != iir_k.blocked_geometry(8, T, S)
    assert torch.equal(y[:8], ya) and torch.equal(st[:, :8], sa)


def test_blocked_geometry_matches_library(dev):
    """The library's K2 shared memory is `blocked_geometry`'s for every
    section count, and both refuse 0 and 9 sections."""
    lib = iir_k._blocked_lib()
    for S in range(0, 10):
        try:
            want = iir_k.blocked_geometry(1024, 4096, S).smem
        except ValueError:
            want = -1
        assert lib.uhsdr_blocked_smem(S) == want, S


def test_dispatch_takes_k11_where_blocks_do_not_chunk(dev):
    """T = 200 (and 128, one chunk): the dispatch runs K11 on the
    flattened rows, not K2, and matches the sequential recurrence on the
    CPU."""
    c = iir.cascade(_sos5("prefilter"), dev)
    rng = np.random.default_rng(22)
    for T in (200, 128):
        x = (rng.standard_normal((5, 2, T)) * 0.1).astype(np.float32)
        s0 = torch.zeros((5, 5, 2, 2), device=dev)
        n2, n11 = iir_k.BLOCKED.launches, iir_k.BIQUAD.launches
        yk, sk = iir_k.cascade_dispatch(c, s0, torch.from_numpy(x).to(dev))
        assert (iir_k.BLOCKED.launches, iir_k.BIQUAD.launches) == (n2,
                                                                   n11 + 1)
        yc, sc = iir.biquad_cascade_block(c.sos.cpu(), s0.cpu(),
                                          torch.from_numpy(x))
        assert yk.shape == (5, 2, T) and sk.shape == (5, 5, 2, 2)
        assert snr_db(yc, yk.cpu()) >= AGC_DB
        assert snr_db(sc, sk.cpu()) >= AGC_DB


@pytest.mark.parametrize("C,T,L", [(40, 4096, 32), (9, 1000, 32),
                                   (16, 512, 16), (5, 4000, 64)])
def test_grouped_kernel_matches_plain_and_k11(dev, C, T, L):
    """K14 repeats its plain version's operations in order (120 dB) and
    gives K11's result (90 dB); T = 1000 and 4000 end inside a group."""
    rng = np.random.default_rng(23)
    for cset in (sam_mod.C0, sam_mod.C1):
        sos = torch.from_numpy(sam_mod.allpass_sos(cset)).to(dev)
        S = sos.shape[0]
        sk = sp = sq = torch.zeros((S, C, 2), device=dev)
        for _ in range(2):
            x = torch.from_numpy((rng.standard_normal((C, T)) * 0.1)
                                 .astype(np.float32)).to(dev)
            n0, n11 = iir_k.BIQUAD_GROUPED.launches, iir_k.BIQUAD.launches
            yk, sk = iir_k.biquad_cascade(sos, sk, x, impl="grouped",
                                          group_len=L)
            assert (iir_k.BIQUAD_GROUPED.launches,
                    iir_k.BIQUAD.launches) == (n0 + 1, n11)
            yp, sp = iir_k.biquad_grouped_plain(sos, sp, x, L)
            yq, sq = iir_k.biquad_cascade(sos, sq, x)
            torch.cuda.synchronize()
            assert snr_db(yp, yk) >= AGC_DB and snr_db(sp, sk) >= AGC_DB
            assert snr_db(yq, yk) >= K2_DB and snr_db(sq, sk) >= K2_DB


@pytest.mark.parametrize("iq_rate,C,B,dtype", [
    (96000.0, 13, 1600, "int16"), (96000.0, 3, 4096, "float32"),
    (48000.0, 5, 2000, "int16"), (96000.0, 6, 200, "int16")])
def test_front_mt_kernel_matches_plain(dev, iq_rate, C, B, dtype):
    """K15 against its plain version from a random NCO phase, three
    streamed blocks (B = 200: shorter than the raw history)."""
    cfg = rx.RxConfig(**{**FLAGSHIP, "iq_rate": iq_rate})
    p = rx.make_params(cfg, dev)
    h, g, delta = p.front_fir, p.front2, p.nco_delta
    rng = np.random.default_rng(24)
    ck = cp = torch.zeros((C, h.shape[-1] - 1), dtype=torch.complex64,
                          device=dev)
    c2k = c2p = torch.zeros((C, g.shape[-1] - 1), dtype=torch.complex64,
                            device=dev)
    ph = torch.from_numpy(rng.integers(0, 2**32, C)).to(dev)
    for _ in range(3):
        x = [torch.from_numpy(_int16(rng, (C, B))).to(dev) for _ in "iq"]
        if dtype == "float32":
            x = [v.to(torch.float32) / 32768.0 for v in x]
        n0, n1 = fir_k.FRONT_MT.launches, fir_k.FRONT.launches
        yk, ck, c2k, pk = fir_k.front_mt(h, g, ck, c2k, *x, ph, delta,
                                         cfg.decim)
        assert (fir_k.FRONT_MT.launches, fir_k.FRONT.launches) == (n0 + 1,
                                                                   n1)
        yp, cp, c2p, pp = fir_k.front_mt_plain(h, g, cp, c2p, *x, ph, delta,
                                               cfg.decim)
        torch.cuda.synchronize()
        assert yk.shape == (C, B // cfg.decim)
        for a, b in ((yp, yk), (c2p, c2k), (pp, pk)):
            assert snr_db(a, b) >= FIR_DB
        assert torch.equal(cp, ck)
        ph = nco.advance(ph, delta, B)


def test_mt_chain_on_card_matches_cpu(dev, monkeypatch):
    """The SSB flagship with UHSDR_FRONT_MT=1: K15 in place of K1, on the
    card and on the CPU."""
    from uhsdr_tpu_torch import trace_rx
    monkeypatch.setenv("UHSDR_FRONT_MT", "1")
    cfg = rx.RxConfig(**FLAGSHIP, block_len=2048)
    gpu, cpu = rx.RxChain(cfg, device=dev), rx.RxChain(cfg, device="cpu")
    C = 8
    sg, sc = gpu.init_state((C,)), cpu.init_state((C,))
    before = {k.name: k.launches for k in build.kernels()}
    for i, q in trace_rx.capture(3, C, "cpu", 6, cfg):
        yg, sg, _ = gpu(sg, i=i, q=q)
        yc, sc, _ = cpu(sc, i=i, q=q)
        assert snr_db(yc, yg.cpu()) >= CHAIN_DB
    expect = {k.name: 0 for k in build.kernels()}
    expect.update({"front_mt": 3, "agc": 3, "interp": 3,
                   "blocked": 3 * _k2_per_block(cfg, gpu.params)})
    assert _launch_deltas(before) == expect
    a, b = rx.state_to_numpy(sc), rx.state_to_numpy(sg)
    for f in a:
        assert snr_db(a[f], b[f]) >= CHAIN_DB, f


def test_slice5_wrappers_refuse_what_the_kernels_do_not_take(dev):
    c = iir.cascade(_sos5("prefilter"), dev)
    x = torch.zeros((4, 256), device=dev)
    s = torch.zeros((5, 4, 2), device=dev)
    with pytest.raises(ValueError):                 # T not a multiple of 128
        iir_k.blocked_cascade(c, s, x[:, :200])
    with pytest.raises(ValueError):                 # state of 3 rows
        iir_k.blocked_cascade(c, s[:, :3], x)
    with pytest.raises(ValueError):                 # misaligned rows
        iir_k.blocked_cascade(c, torch.zeros((5, 3, 2), device=dev),
                              torch.zeros(3 * 256 + 1, device=dev)[1:]
                              .reshape(3, 256))
    with pytest.raises(ValueError):                 # tables on the CPU
        iir_k.blocked_cascade(iir.cascade(_sos5("prefilter"), "cpu"), s, x)
    sos = torch.from_numpy(sam_mod.allpass_sos(sam_mod.C0)).to(dev)
    s7 = torch.zeros((7, 4, 2), device=dev)
    with pytest.raises(ValueError):                 # group length 48
        iir_k.biquad_cascade(sos, s7, x, impl="grouped", group_len=48)
    with pytest.raises(ValueError):                 # more than 512 groups
        iir_k.biquad_cascade(sos, s7, torch.zeros((4, 513 * 16),
                                                  device=dev),
                             impl="grouped", group_len=16)
    cfg = rx.RxConfig(**{**FLAGSHIP, "mode": "ssbstereo"})
    pp = rx.make_params(cfg, dev)
    xi = torch.zeros((4, 256), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError):                 # two stage-B filters
        fir_k.front_mt(pp.front_fir, pp.front2,
                       torch.zeros((4, 1810), dtype=torch.complex64,
                                   device=dev),
                       torch.zeros((4, 198), dtype=torch.complex64,
                                   device=dev),
                       xi, xi, torch.zeros(4, dtype=torch.int64, device=dev),
                       pp.nco_delta, cfg.decim)


@pytest.mark.parametrize("C,T,fs", [(40, 1000, 12000.0), (70, 2048, 24000.0),
                                    (5, 300, 48000.0), (1, 1, 12000.0),
                                    (31, 33, 48000.0)])
def test_agc_rows_kernel_bit_exact(dev, C, T, fs):
    """K3 with (3, C) rows: bit-exact with its plain version over three
    streamed blocks, and each channel bit-equal to itself run alone with
    scalar settings."""
    th = np.linspace(40.0, 80.0, C)
    params = agc_ops.make_params(fs, mode="med", hang_enable=True,
                                 thresh_db=th)
    kp = agc_ops.kernel_params(params, C)
    rows = torch.as_tensor(kp.rows, device=dev)
    w = params.attack_buffsize
    rng = np.random.default_rng(21)
    ck = cp = torch.zeros((agc_k.N_CARRY, C), device=dev)
    dk = dp = torch.zeros((C, w), device=dev)
    level = np.logspace(-1, 4, C)[:, None]
    xs = []
    for blk in range(3):
        n = np.arange(blk * T, (blk + 1) * T)
        x = level * np.sin(2 * np.pi * 700 * n / fs) * (n < 1.5 * T)
        x = torch.from_numpy((x + rng.standard_normal((C, T)) * 0.5)
                             .astype(np.float32)).to(dev)
        xs.append(x)
        n0 = agc_k.AGC_ROWS.launches
        yk, ck, dk = agc_k.agc(kp.scalars, ck, dk, x, rows)
        assert agc_k.AGC_ROWS.launches == n0 + 1
        yp, cp, dp = agc_k.agc_plain(kp.scalars, cp, dp, x, rows)
        for a, b in ((yp, yk), (cp, ck), (dp, dk)):
            assert torch.equal(a, b)
    for c in (0, C // 2, C - 1):
        p1 = agc_ops.kernel_params(agc_ops.make_params(
            fs, mode="med", hang_enable=True, thresh_db=float(th[c])))
        c1 = torch.zeros((agc_k.N_CARRY, 1), device=dev)
        d1 = torch.zeros((1, w), device=dev)
        for blk, x in enumerate(xs):
            y1, c1, d1 = agc_k.agc(p1.scalars, c1, d1,
                                   x[c:c + 1].contiguous())
        assert torch.equal(y1[0], yk[c]) and torch.equal(c1[:, 0], ck[:, c])
    with pytest.raises(ValueError, match="rows"):
        agc_k.agc(kp.scalars, ck, dk, xs[0], rows[:2].contiguous())


@pytest.mark.parametrize("C,T", [(40, 1000), (129, 2048)])
def test_agc_scan_rows_kernel_bit_exact(dev, C, T):
    """K13 with (2, C) rows: bit-exact with its plain version over three
    streamed blocks, each channel as alone with scalars."""
    th = np.linspace(40.0, 80.0, C)
    params = agc_ops.make_params(12000.0, mode="med", hang_enable=True,
                                 thresh_db=th)
    kp = agc_ops.kernel_params(params, C)
    rows = torch.as_tensor(kp.scan_rows, device=dev)
    rng = np.random.default_rng(22)
    ck = cp = torch.zeros((agc_k.N_CARRY, C), device=dev)
    ins = []
    for blk in range(3):
        a = torch.from_numpy(np.abs(rng.standard_normal((C, T + 48)))
                             .astype(np.float32) * np.logspace(-1, 4, C)
                             [:, None].astype(np.float32)).to(dev)
        rm = agc_k.look_ahead_max(a, 48, T).contiguous()
        ax = a[:, :T].contiguous()
        ins.append((rm, ax))
        n0 = agc_k.AGC_SCAN_ROWS.launches
        vk, ck = agc_k.agc_scan(kp.scalars, ck, rm, ax, rows)
        assert agc_k.AGC_SCAN_ROWS.launches == n0 + 1
        vp, cp = agc_k.agc_scan_plain(kp.scalars, cp, rm, ax, rows)
        assert torch.equal(vp, vk) and torch.equal(cp, ck)
    for c in (0, C - 1):
        p1 = agc_ops.kernel_params(agc_ops.make_params(
            12000.0, mode="med", hang_enable=True, thresh_db=float(th[c])))
        c1 = torch.zeros((agc_k.N_CARRY, 1), device=dev)
        for rm, ax in ins:
            v1, c1 = agc_k.agc_scan(p1.scalars, c1, rm[c:c + 1].contiguous(),
                                    ax[c:c + 1].contiguous())
        assert torch.equal(v1[0], vk[c]) and torch.equal(c1[:, 0], ck[:, c])


def test_fleet_fused_bit_equal_to_separate_chains(dev):
    """A small fleet on the card (usb 60 dB, cw 70 dB, am 55 dB, fm; 3-9
    channels a group): the stage-batched step (usb and cw in one K1
    launch, the 12 kHz groups in one K3 launch with rows and one K4
    launch) bit-equal to the groups run as separate chains, output and
    every state leaf, over three blocks."""
    kws = [dict(mode="usb", bw_key="2P3KHZ", path_name="LPF",
                agc_thresh_db=60.0),
           dict(mode="cw", bw_key="500HZ", path_name="750Hz",
                agc_thresh_db=70.0),
           dict(mode="am", bw_key="2P5KHZ", path_name="AM/SAM",
                agc_thresh_db=55.0),
           dict(mode="fm", bw_key="5P0KHZ", path_name="FM")]
    cfgs = [rx.RxConfig(**kw, translate_hz=6000.0, block_len=2048)
            for kw in kws]
    assign = [0] * 5 + [1] * 9 + [2] * 3 + [3] * 4
    fused = fleet_mod.ChannelFleet(cfgs, assign, device=dev)
    separate = fleet_mod.ChannelFleet(cfgs, assign, device=dev)
    rng = np.random.default_rng(23)
    for blk in range(3):
        planes = [tuple(torch.from_numpy(
            rng.standard_normal((g.channel_idx.size, 2048)).astype(
                np.float32) * 0.1).to(dev) for _ in range(2))
            for g in fused.groups]
        n_rows = agc_k.AGC_ROWS.launches
        n_front = fir_k.FRONT.launches
        ya = fused.process_block_device(planes)
        assert agc_k.AGC_ROWS.launches == n_rows + 1
        assert fir_k.FRONT.launches == n_front + 1
        yb = separate.step_separate(planes)
        for a, b in zip(ya, yb):
            assert torch.equal(a, b)
        for ga, gb in zip(fused.groups, separate.groups):
            sa, sb = rx.state_to_numpy(ga.state), rx.state_to_numpy(gb.state)
            assert sa.keys() == sb.keys()
            for f in sa:
                np.testing.assert_array_equal(sa[f], sb[f], err_msg=f)
