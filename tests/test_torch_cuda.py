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
(`AGC_DB`), K11, K14 and SAM's fused sideband stage also bit for bit
(every output and state; K14 also on edge streams and past 512 groups a
block); the AGC kernels K3 and K13, which repeat them too and are
built with -fmad=false, must be bit-exact (K3 at w from 48 to 256, over
one step, a tile less and more one and one tile; its shared memory is
`agc_geometry`'s); the PLL kernels' cos/sin/audio to max |err| <= 2e-5 (they repeat
the plain loop's operations too; tests/test_demod.py holds the TPU
kernels to 3e-4), also on edge inputs, with NaNs and infinities where the
plain loop has them, and their walker's fast sincos, atan2 and phase
wrap bit-equal to the exact functions over their ranges; the FM
discriminator to max |err| <= 2e-6 modulo 2 pi
(an angle at the branch cut may come out as +pi or -pi); the chain on
the card against the chain on the CPU to 80 dB.  K3 and K13 with
per-channel rows must be bit-exact with their plain versions, and a
channel with rows must give the bits it gives alone with scalars; the
mixed-mode fleet's stage-batched step must be bit-equal to its groups
run as separate chains.  The linked stereo AGC stage (`agc_stereo`, with
and without rows), K3 and K13 hold their plain versions bit for bit on
edge streams too (+-0, +-inf, a NaN in one plane of a channel,
subnormals), a NaN matching a NaN; every carried state the port hands
from block to block holds storage of its own size.  The command line
and the live server run on the card: the text round trips, the usb
tone, the first blocks against `--device cpu` and a CAT retune of
`RadioServer` (the chain on the card against the CPU at 80 dB).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from uhsdr_tpu_torch.chain import rx
from uhsdr_tpu_torch.cuda import agc as agc_k
from uhsdr_tpu_torch.cuda import build
from uhsdr_tpu_torch.cuda import cw as cw_k
from uhsdr_tpu_torch.cuda import elemwise as ew_k
from uhsdr_tpu_torch.cuda import fir as fir_k
from uhsdr_tpu_torch.cuda import iir as iir_k
from uhsdr_tpu_torch.cuda import pll as pll_k
from uhsdr_tpu_torch.cuda import psk as psk_k
from uhsdr_tpu_torch.cuda import rtty as rtty_k
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


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bits, a NaN matching a NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return (a.shape == b.shape and torch.equal(na, nb)
            and torch.equal(a[~na].view(torch.int32),
                            b[~nb].view(torch.int32)))


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
# 192 kHz (187 taps); and five the generic instance takes, two past its
# parameters' tap table (the taps read from the card), the last FreeDV's
# x6 of 72 taps (12 a phase)
@pytest.mark.parametrize("L,taps", [(2, 4), (2, 16), (4, 4), (4, 16),
                                    (4, 93), (8, 93), (8, 187), (16, 187),
                                    (3, 40), (5, 93), (3, 2000), (7, 1500),
                                    (6, 72)])
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
                   "sam_sideband": 3 * (mode == "sam"
                                        and sideband != "both"),
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


@pytest.mark.parametrize("C,lengths", [
    (13, (2048, 99, 2048)),          # the flagship's stage B, ragged C
    (5, (4100, 1000, 37)),           # ragged tiles, shorter than history
    (1, (16384,))])
def test_fir_cx_stage_b_matches_plain(dev, C, lengths):
    """K6 at decimation 1 on f32 planes of decimated IQ, real out: the
    sharded RX step's unfused stage B (`chain/rx.py::stage_b`, the SSB
    flagship's 199 taps), streamed, against `fir_cx_plain` and through
    `stage_b` on the card against the CPU."""
    cfg = rx.RxConfig(**{**FLAGSHIP, "block_len": 16384})
    pg, pc = rx.make_params(cfg, dev), rx.make_params(cfg, "cpu")
    g = pg.front2
    assert g.shape == (199,) and fir_k.fir_cx_geometry(199, 1, 4)
    rng = np.random.default_rng(21)
    sg = sc = rx.init_state(cfg, pc, (C,))
    sg = sg._replace(front2_carry=sg.front2_carry.to(dev))
    ck = cp = torch.zeros((C, 198), dtype=torch.complex64, device=dev)
    for n in lengths:
        zr, zi = (torch.from_numpy((rng.standard_normal((C, n)) * 0.1)
                                   .astype(np.float32)).to(dev)
                  for _ in "ri")
        n0 = fir_k.FIR_CX.launches
        yk, ck, _ = fir_k.fir_cx(g, ck, zr, zi, 1, real_out=True)
        assert fir_k.FIR_CX.launches == n0 + 1
        yp, cp, _ = fir_k.fir_cx_plain(g, cp, zr, zi, 1, real_out=True)
        assert snr_db(yp, yk) >= FIR_DB and torch.equal(cp, ck)
        yg, sg = rx.stage_b(cfg, pg, sg, torch.complex(zr, zi))
        yc, sc = rx.stage_b(cfg, pc, sc, torch.complex(zr, zi).cpu())
        assert snr_db(yc, yg.cpu()) >= FIR_DB
        assert torch.equal(sc.front2_carry, sg.front2_carry.cpu())


@pytest.mark.parametrize("kw", [
    dict(FLAGSHIP),                                          # K5
    dict(FLAGSHIP, bw_key="5P0KHZ"),                         # K7
    dict(FLAGSHIP, bw_key="5P0KHZ", translate_hz=0.0),       # K6
    dict(FLAGSHIP, mode="sam", bw_key="5P0KHZ", path_name="AM/SAM")])
def test_sharded_front_on_card_matches_unsharded(dev, kw):
    """`parallel/rx_sharded.front_end_local` on the card, a block cut into
    four time shards with the previous shard's raw tail as the halo,
    against the unsharded front kernel over the whole block, across the
    uint32 phase wrap."""
    from uhsdr_tpu_torch.parallel import rx_sharded
    cfg = rx.RxConfig(**{**kw, "block_len": 4096})
    p = rx.make_params(cfg, dev)
    h, d = p.front_fir, cfg.front_decim
    L, C, B, n_sp = h.shape[-1] - 1, 9, 4096, 4
    rng = np.random.default_rng(22)
    i, q = (torch.from_numpy((rng.standard_normal((C, B)) * 0.1).astype(
        np.float32)).to(dev) for _ in "iq")
    carry = torch.complex(*(torch.from_numpy((rng.standard_normal(
        (C, L)) * 0.1).astype(np.float32)).to(dev) for _ in "ri"))
    phase = torch.full((C,), 2**32 - 7 * B, dtype=torch.int64, device=dev)
    nco_arg = (phase, p.nco_delta) if p.nco_delta else None
    if h.is_complex():
        ref = fir_k.fir_cx(h, carry, i, q, d, nco=nco_arg, real_out=True)[0]
    else:
        ref = fir_k.fir_rt(h, carry, i, q, d, nco=nco_arg)[0]
    hist, parts, t = torch.stack([carry.real, carry.imag], 1), [], B // n_sp
    for s in range(n_sp):
        ii, qq = i[:, s * t:(s + 1) * t].contiguous(), \
            q[:, s * t:(s + 1) * t].contiguous()
        z = rx_sharded.front_end_local(p, cfg, s, phase, hist, ii, qq)
        parts.append(torch.complex(*z) if isinstance(z, tuple) else z)
        hist = torch.stack([ii[:, -L:], qq[:, -L:]], 1)
    assert snr_db(ref, torch.cat(parts, -1)) >= FIR_DB


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

def _stereo_block(rng, C, T, t0, fs, edges):
    """(C, 2, T) gated bursts at -20 ... +80 dB over noise; with `edges`,
    +-0 runs, +-inf, a NaN in one plane of a channel and subnormals on
    some channels (one a block)."""
    c = np.arange(C)[:, None]
    n = np.arange(t0, t0 + T)
    gate = (n[None, :] // (64 + 48 * (c % 16))) % 3 == 0
    lv = np.logspace(-1, 4, C)[:, None]
    x = np.stack([lv * np.sin(2 * np.pi * 700 * n / fs) * gate,
                  0.5 * lv * np.cos(2 * np.pi * 1100 * n / fs) * gate],
                 axis=1)
    x = (x + rng.standard_normal(x.shape) * 0.5).astype(np.float32)
    if edges:
        k = T // 2
        x[1 % C, :, :k] = 0.0
        x[1 % C, 1, :k] = -0.0
        x[2 % C, 1, k] = np.inf
        x[3 % C, 0, k] = -np.inf
        x[4 % C, 0, k] = np.nan
        x[5 % C, :, :] = np.float32(1e-42)
        x[6 % C, 1, :k] = np.float32(-3e-45)
    return torch.from_numpy(x)


@pytest.mark.parametrize("C,lengths,fs,rows,edges", [
    (40, (1000, 33, 1000), 12000.0, False, False),
    (64, (2048, 1, 2048), 12000.0, True, False),
    (33, (1500, 95, 100), 24000.0, False, True),
    (5, (300, 31, 64), 48000.0, True, True),     # w = 192
    (70, (40, 20, 200), 12000.0, False, True),   # blocks shorter than w
    (1, (1, 32, 33), 24000.0, True, False)])
def test_agc_stereo_kernel_bit_exact(dev, C, lengths, fs, rows, edges):
    """The linked stereo AGC stage against its plain version (the torch
    route around K13), bit for bit over three streamed blocks, edges
    included; its new delay line a tensor of its own."""
    th = np.linspace(40.0, 80.0, C) if rows else 60.0
    params = agc_ops.make_params(fs, mode="med", hang_enable=True,
                                 thresh_db=th)
    kp = agc_ops.kernel_params(params, C)
    rt = None if kp.rows is None else torch.as_tensor(kp.rows, device=dev)
    w = params.attack_buffsize
    rng = np.random.default_rng(C + w)
    ck = cp = torch.zeros((agc_k.N_CARRY, C), device=dev)
    dk = dp = torch.zeros((C, 2, w), device=dev)
    t0 = 0
    counter = agc_k.AGC_STEREO_ROWS if rows else agc_k.AGC_STEREO
    for T in lengths:
        x = _stereo_block(rng, C, T, t0, fs, edges).to(dev)
        t0 += T
        n0 = counter.launches
        yk, ck, dk = agc_k.agc_stereo(kp.scalars, ck, dk, x, rt)
        assert counter.launches == n0 + 1
        yp, cp, dp = agc_k.agc_stereo_plain(kp.scalars, cp, dp, x, rt)
        torch.cuda.synchronize()
        for a, b in ((yp, yk), (cp, ck), (dp, dk)):
            assert _same(a, b)
        assert dk.untyped_storage().nbytes() == 4 * C * 2 * w
    if edges and C > 4:
        assert torch.isnan(yk[4]).all()


def test_agc_stereo_channels_alone_match_the_batch(dev):
    """A channel with rows gives what it gives alone with its settings as
    scalars, bit for bit."""
    C, T = 37, 700
    th = np.linspace(40.0, 80.0, C)
    params = agc_ops.make_params(12000.0, mode="med", hang_enable=True,
                                 thresh_db=th)
    kp = agc_ops.kernel_params(params, C)
    rt = torch.as_tensor(kp.rows, device=dev)
    rng = np.random.default_rng(43)
    x = _stereo_block(rng, C, T, 0, 12000.0, False).to(dev)
    carry = torch.zeros((agc_k.N_CARRY, C), device=dev)
    delay = torch.zeros((C, 2, 48), device=dev)
    y, c_out, d_out = agc_k.agc_stereo(kp.scalars, carry, delay, x, rt)
    for c in (0, 31, 32, C - 1):
        p1 = agc_ops.kernel_params(agc_ops.make_params(
            12000.0, mode="med", hang_enable=True, thresh_db=float(th[c])))
        y1, c1, d1 = agc_k.agc_stereo(p1.scalars, carry[:, c:c + 1].clone(),
                                      delay[c:c + 1].clone(),
                                      x[c:c + 1].contiguous())
        assert torch.equal(y1[0], y[c]) and torch.equal(c1[:, 0], c_out[:, c])
        assert torch.equal(d1[0], d_out[c])


def test_agc_stereo_and_scan_smem_match_the_rules(dev):
    lib = agc_k.AGC.lib()
    for w in (1, 31, 32, 33, 48, 96, 192, 256):
        assert lib.uhsdr_agc_stereo_smem(w) == agc_k.agc_stereo_geometry(
            8192, 2048, w).smem
    assert lib.uhsdr_agc_stereo_smem(agc_k.AGC_MAXW + 1) == -1
    assert lib.uhsdr_agc_scan_smem() == agc_k.agc_scan_geometry(8192,
                                                                2048).smem


@pytest.mark.parametrize("fs", [12000.0, 24000.0, 48000.0])
def test_agc_kernel_holds_edge_streams(dev, fs):
    """K3 on +-0, +-inf, a NaN and subnormals: its look-ahead max and its
    step keep the NaNs the plain version has (a max that drops a NaN, as
    fmaxf does, parts from it), bit for bit elsewhere."""
    params = agc_ops.make_params(fs, mode="med", hang_enable=True)
    p = agc_ops.kernel_params(params).scalars
    w = params.attack_buffsize
    C = 12
    rng = np.random.default_rng(int(fs) + 1)
    ck = cp = torch.zeros((agc_k.N_CARRY, C), device=dev)
    dk = dp = torch.zeros((C, w), device=dev)
    t0 = 0
    for T in (600, 33, 600):
        x = _stereo_block(rng, C, T, t0, fs, True)[:, 0].contiguous().to(dev)
        t0 += T
        yk, ck, dk = agc_k.agc(p, ck, dk, x)
        yp, cp, dp = agc_k.agc_plain(p, cp, dp, x)
        torch.cuda.synchronize()
        for a, b in ((yp, yk), (cp, ck), (dp, dk)):
            assert _same(a, b)
    assert torch.isnan(yk[4]).all() and torch.isnan(yk[3]).all()
    assert torch.isfinite(yk[0]).all()


def test_agc_scan_kernel_holds_edge_streams(dev):
    """K13 on detector series with +-inf and NaN in rm and in ax, bit for
    bit with its plain (blended) walk, a NaN matching a NaN."""
    params = agc_ops.make_params(12000.0, mode="med", hang_enable=True)
    p = agc_ops.kernel_params(params).scalars
    C, T = 40, 500
    rng = np.random.default_rng(44)
    ck = cp = torch.zeros((agc_k.N_CARRY, C), device=dev)
    for blk in range(3):
        a = np.abs(rng.standard_normal((C, T + 48)) * np.logspace(
            -1, 4, C)[:, None]).astype(np.float32)
        a[3, 100 + blk] = np.inf
        a[5, 200] = np.nan
        a[7, 100:] = 0.0
        a = torch.from_numpy(a).to(dev)
        rm = agc_k.look_ahead_max(a, 48, T).contiguous()
        ax = a[:, :T].contiguous()
        ax[9, 50] = float("nan")
        rm[11, 60] = float("-inf")
        vk, ck = agc_k.agc_scan(p, ck, rm, ax)
        vp, cp = agc_k.agc_scan_plain(p, cp, rm, ax)
        torch.cuda.synchronize()
        assert _same(vp, vk) and _same(cp, ck)
    assert torch.isnan(vk[3]).all() and torch.isfinite(vk[0]).all()


def test_carried_states_own_their_storage(dev):
    """Every state handed from block to block holds storage of its own
    size on the card: the linked AGC's delay line (run_stereo, the
    stage), K3's plain version's, the analysis and synthesis banks'."""
    from uhsdr_tpu_torch.ops import channelizer as chz
    params = agc_ops.make_params(12000.0)
    st = agc_ops.init_state_stereo((8,), params, device=dev)
    x = torch.randn((8, 2, 512), device=dev)
    _, st = agc_ops.run_stereo(params, st, x)
    assert st.delay.untyped_storage().nbytes() == 4 * 8 * 2 * 48
    p = agc_ops.kernel_params(params).scalars
    _, _, d = agc_k.agc_plain(p, torch.zeros((agc_k.N_CARRY, 8), device=dev),
                              torch.zeros((8, 48), device=dev), x[:, 0])
    assert d.untyped_storage().nbytes() == 4 * 8 * 48
    M, K = 16, 6
    ana = chz.AnalysisPfb(M, taps_per_branch=K, device=dev)
    syn = chz.SynthesisPfb(M, taps_per_branch=K, device=dev)
    z = torch.randn((3, M * 40), dtype=torch.complex64, device=dev)
    y, sa = ana(ana.init_state((3,)), z)
    _, ss = syn(syn.init_state((3,)), y)
    assert sa.untyped_storage().nbytes() == 8 * 3 * K * M
    assert ss.untyped_storage().nbytes() == 8 * 3 * (K - 1) * M

@pytest.mark.parametrize("C,T,fs", [(40, 1000, 12000.0), (64, 2048, 12000.0),
                                    (33, 130, 24000.0), (5, 300, 48000.0),
                                    (1, 1, 12000.0), (31, 33, 24000.0),
                                    (97, 96, 12000.0)])
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
    expect.update({"agc_stereo": 3, "interp": 3})
    expect.update({"fir_rt": 3, "pll": 3, "sam_sideband": 3} if sam
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
                                   (16, 512, 16), (5, 4000, 64),
                                   (7, 2051, 32)])
def test_grouped_kernel_matches_plain_and_k11(dev, C, T, L):
    """K14 repeats its plain version's operations in order, bit for bit on
    the output and the state over two streamed blocks, and gives K11's
    result (90 dB); T = 1000 and 4000 end inside a group, 2051 (rows not
    16-byte aligned, 4-byte copies) inside a group of its third tile."""
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
            assert torch.equal(yp, yk) and torch.equal(sp, sk)
            assert snr_db(yq, yk) >= K2_DB and snr_db(sq, sk) >= K2_DB


@pytest.mark.parametrize("L,C,lengths,offset", [
    (32, 40, (1000, 3100, 64), 0), (16, 33, (513 * 16, 700), 1),
    (64, 70, (2048, 1), 0), (32, 600, (4096, 96), 3)])
def test_grouped_kernel_bit_exact_streams(dev, L, C, lengths, offset):
    """K14 bit for bit against its plain version from a random state over
    streamed blocks: blocks that end inside a group and a tile, a block
    past PR 5's 512 groups (513 x 16), one sample, rows not 16-byte
    aligned (x at an offset), a launch of four warps a block."""
    rng = np.random.default_rng(26)
    sos = torch.from_numpy(sam_mod.allpass_sos(sam_mod.C1)).to(dev)
    S = sos.shape[0]
    sk = sp = torch.from_numpy((rng.standard_normal((S, C, 2)) * 1e-2)
                               .astype(np.float32)).to(dev)
    for T in lengths:
        buf = torch.from_numpy(rng.standard_normal(C * T + offset)
                               .astype(np.float32)).to(dev)
        x = buf[offset:].view(C, T)
        yk, sk = iir_k.biquad_cascade(sos, sk, x, impl="grouped",
                                      group_len=L)
        yp, sp = iir_k.biquad_grouped_plain(sos, sp, x, L)
        torch.cuda.synchronize()
        assert torch.equal(yp, yk) and torch.equal(sp, sk)


@pytest.mark.parametrize("L", [16, 32, 64])
def test_grouped_kernel_holds_edge_streams(dev, L):
    """K14 on +-0, +-inf, a NaN and subnormals in x and from a NaN carried
    state: bit-equal to its plain version on output and state, a NaN
    matching a NaN, over two blocks (the second ragged)."""
    C = 24
    rng = np.random.default_rng(27)
    sos = torch.from_numpy(sam_mod.allpass_sos(sam_mod.C0)).to(dev)
    S = sos.shape[0]
    s0 = torch.from_numpy((rng.standard_normal((S, C, 2)) * 1e-2)
                          .astype(np.float32))
    s0[3, 5, 0] = float("nan")                  # channel 5: a NaN state
    s0[:, 6] = -0.0                             # channel 6: -0 states
    sk = sp = s0.to(dev)
    tiny = np.float32(1e-40)                    # subnormal
    for T in (64 * L, 40 * L + 7):
        x = (rng.standard_normal((C, T)) * 0.1).astype(np.float32)
        x[0] = 0.0
        x[1] = -0.0
        x[2, T // 3] = np.inf
        x[3, T // 2] = -np.inf
        x[4, T // 5] = np.nan
        x[6] = -0.0
        x[7, ::3] = tiny
        x[8] = tiny * rng.standard_normal(T).astype(np.float32)
        x[9, 5::7] = -0.0
        xt = torch.from_numpy(x).to(dev)
        yk, sk = iir_k.biquad_cascade(sos, sk, xt, impl="grouped",
                                      group_len=L)
        yp, sp = iir_k.biquad_grouped_plain(sos, sp, xt, L)
        torch.cuda.synchronize()
        assert _same(yp, yk) and _same(sp, sk)
        assert bool(yk[4, T // 5:].isnan().all()) and bool(
            yk[5].isnan().all())
        assert torch.isfinite(yk[10:]).all()


def test_grouped_smem_matches_the_rule(dev):
    """The library's K14 layout and shared memory are `grouped_geometry`'s
    at every group length, section count and block width, within the
    card's opt-in limit; it refuses L = 48, 9 sections and 5 warps."""
    lib = iir_k._grouped_lib()
    for L in iir_k.GROUP_LENS:
        for S in range(1, 9):
            for C in (1, 40, 300, 16384):
                geo = iir_k.grouped_geometry(C, 4096, L, S)
                assert lib.uhsdr_biquad_grouped_smem(L, S, geo.warps) == \
                    geo.smem <= build.SMEM_OPT_IN
    assert lib.uhsdr_biquad_grouped_smem(48, 7, 4) == -1
    assert lib.uhsdr_biquad_grouped_smem(32, 9, 4) == -1
    assert lib.uhsdr_biquad_grouped_smem(32, 7, 5) == -1


@pytest.mark.parametrize("iq_rate,C,B,dtype", [
    (96000.0, 13, 1600, "int16"), (96000.0, 3, 4096, "float32"),
    (48000.0, 5, 2000, "int16"), (96000.0, 6, 200, "int16"),
    (192000.0, 4, 5008, "int16"),     # decim 16: a tile and a ragged one
    (192000.0, 3, 1600, "float32"),
    (48000.0, 3, 6000, "float32"),    # the fleet's planes, ragged
    (48000.0, 3, 1004, "int16"),      # less than a tile, rows unaligned
    (96000.0, 7, 9000, "int16")])     # two tiles and a ragged one
def test_front_mt_kernel_matches_plain(dev, iq_rate, C, B, dtype):
    """K15 against its plain version from a random NCO phase, three
    streamed blocks (B = 200: shorter than the raw history), the raw
    carry bit-equal."""
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


def test_front_mt_geometry_matches_library(dev):
    """K15's shared memory as the library computes it equals
    `front_mt_geometry` at every rate and sample size of the mono rows."""
    lib = fir_k.FRONT.lib()
    for rate in (48000.0, 96000.0, 192000.0):
        for bw in ("2P3KHZ", "1P8KHZ"):
            cfg = rx.RxConfig(**{**FLAGSHIP, "iq_rate": rate,
                                 "bw_key": bw})
            p = rx.make_params(cfg, "cpu")
            taps, taps2 = p.front_fir.shape[-1], p.front2.shape[-1]
            for size in (2, 4):
                assert lib.uhsdr_front_mt_smem(
                    taps, taps2, cfg.decim, size) == fir_k.front_mt_geometry(
                    taps, taps2, cfg.decim, size).smem


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
    # more than 512 groups (PR 5's kernel refused them): runs, and holds
    x513 = torch.randn((4, 513 * 16), device=dev) * 0.1
    yk, sk = iir_k.biquad_cascade(sos, s7, x513, impl="grouped",
                                  group_len=16)
    yp, sp = iir_k.biquad_grouped_plain(sos, s7, x513, 16)
    torch.cuda.synchronize()
    assert torch.equal(yp, yk) and torch.equal(sp, sk)
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


# ---------------------------------------------------------------------------
# The SAM demodulator's redesigned kernels: K9/K10 (the walker pipelined
# over two steps, the phase wrap by a select), K11 (the ring pipeline) and
# the fused sideband stage (cuda/sam.py)
# ---------------------------------------------------------------------------

def _bits_equal(a, b) -> bool:
    """Every element's bits equal, a NaN matching a NaN."""
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (a.isnan() & b.isnan())).all())


def _held_abs(ref, got, tol) -> bool:
    """NaNs and infinities where the reference has them, the finite
    values within tol."""
    if not (torch.equal(ref.isnan(), got.isnan())
            and torch.equal(ref.isinf(), got.isinf())
            and torch.equal(ref[ref.isinf()], got[got.isinf()])):
        return False
    fin = torch.isfinite(ref)
    return not bool(fin.any()) or float((ref[fin] - got[fin]).abs().max()) <= tol


def test_pll_fast_forms_are_the_exact_functions(dev):
    """The walker's select wrap equals its fmodf form bit for bit on every
    f32 in (-2 pi, 4 pi) (none sent to fmodf), its branch-free sincos is
    sincosf's on every f32 below 105615 in magnitude, and its branch-free
    atan2 is atan2f's on every seeded pair it takes (one launch)."""
    ck = pll_k.pll_fast_check(dev)
    two_pi = np.float32(pll_k.TWO_PI)
    want = (int(np.float32(2 * two_pi).view(np.uint32))
            + int(two_pi.view(np.uint32)))
    assert (ck.wrap_differ, ck.wrap_outside, ck.wrap_checked) == (0, 0, want)
    assert ck.sincos_differ == 0
    assert ck.sincos_checked == 2 * int(np.float32(105615).view(np.uint32))
    assert ck.atan2_differ == 0 and ck.atan2_checked == 2**31
    assert ck.atan2_taken > 0.7 * ck.atan2_checked


@pytest.mark.parametrize("C,lengths", [(40, (1000, 33, 512)),
                                       (300, (64, 1001, 96))])
def test_pll_kernels_hold_edge_streams(dev, C, lengths):
    """K10 and K9 from carries outside [0, 2 pi] (the fmodf wrap), with
    zeros, infinities and a NaN in iq: NaNs and infinities where the plain
    version has them, the rest within PLL_ABS, over streamed blocks."""
    sp = sam_mod.make_params(24000.0)
    p = pll_k.PllScalars(sp.g1, sp.g2, sp.omega_min, sp.omega_max)
    mR, mI = sp.fade.mtauR, sp.fade.mtauI
    rng = np.random.default_rng(16)
    phs0 = torch.from_numpy(rng.uniform(0, 6.28, C).astype(np.float32))
    phs0[:8] = torch.tensor([10.0, -3.0, 1e6, -1e6, 4 * np.pi, -2 * np.pi,
                             2 * np.pi, -0.0])
    ck = cp = torch.stack([phs0, torch.full((C,), 0.3), torch.zeros(C)]
                          ).to(dev)
    ak = apl = torch.cat([ck, torch.zeros((2, C), device=dev)])
    t0 = 0
    for T in lengths:
        z = _pll_input(rng, C, T, t0).to(dev)
        t0 += T
        z[8:12] = 0                                  # silent channels
        z[12, T // 2] = complex(np.inf, 0.0)
        z[13, T // 3] = complex(0.0, -np.inf)
        z[14, T // 4] = complex(np.nan, 0.0)
        z[15, :T // 2] = 0
        cos_k, sin_k, ck = pll_k.pll(p, ck, z)
        aud_k, ak = pll_k.pll_audio(p, mR, mI, ak, z)
        cos_p, sin_p, cp = pll_k.pll_plain(p, cp, z)
        aud_p, apl = pll_k.pll_audio_plain(p, mR, mI, apl, z)
        torch.cuda.synchronize()
        # the phase through its cosine and sine: a wrap at 2 pi is no error
        for a, b in ((cos_p, cos_k), (sin_p, sin_k), (aud_p, aud_k),
                     (cp[1:], ck[1:]), (apl[1:], ak[1:]),
                     (cp[0].cos(), ck[0].cos()), (cp[0].sin(), ck[0].sin()),
                     (apl[0].cos(), ak[0].cos())):
            assert _held_abs(a, b, PLL_ABS)
    assert bool(ck[0, 14].isnan() and ak[0, 14].isnan())   # the NaN stays


def test_pll_smem_matches_the_rule(dev):
    """The library's block layout and shared memory are `pll_geometry`'s,
    within the card's opt-in limit."""
    lib = pll_k._lib()
    for C in (1, 8, 528, 529, 1024, 4096, 8192, 16384, 16896, 40000):
        geo = pll_k.pll_geometry(C, 100)
        assert lib.uhsdr_pll_smem(geo.lanes) == geo.smem <= build.SMEM_OPT_IN
    assert lib.uhsdr_pll_smem(0) == lib.uhsdr_pll_smem(33) == -1


@pytest.mark.parametrize("C,lengths,S,offset", [
    (40, (1000, 64, 130), 7, 0), (600, (4096, 1001), 7, 0),
    (9, (130, 31), 1, 0), (33, (300, 32), 5, 1), (3000, (256, 96), 8, 0)])
def test_biquad_kernel_bit_exact(dev, C, lengths, S, offset):
    """K11 bit for bit against its plain version over streamed blocks:
    ragged tiles, rows that are not 16-byte aligned (T % 4, or x at an
    offset), a launch of several blocks an SM."""
    rng = np.random.default_rng(17)
    if S == 7:
        sos = torch.from_numpy(sam_mod.allpass_sos(sam_mod.C0)).to(dev)
    else:
        r = rng.uniform(0.5, 0.999, S)
        th = rng.uniform(0.1, 3.0, S)
        sos = torch.from_numpy(np.stack(
            [rng.standard_normal(S), rng.standard_normal(S),
             rng.standard_normal(S), -2 * r * np.cos(th), r * r],
            axis=-1).astype(np.float32)).to(dev)
    sk = sp = torch.zeros((S, C, 2), device=dev)
    for T in lengths:
        buf = torch.from_numpy(rng.standard_normal(C * T + offset)
                               .astype(np.float32)).to(dev)
        x = buf[offset:].view(C, T)
        yk, sk = iir_k.biquad_cascade(sos, sk, x)
        yp, sp = iir_k.biquad_cascade_plain(sos, sp, x)
        torch.cuda.synchronize()
        assert torch.equal(yp, yk) and torch.equal(sp, sk)


def test_biquad_smem_matches_the_rule(dev):
    lib = iir_k._biquad_lib()
    for C in (1, 8, 528, 529, 1024, 16384, 16896, 40000):
        geo = iir_k.biquad_geometry(C, 100)
        assert lib.uhsdr_biquad_smem(geo.lanes) == geo.smem
        assert geo.smem <= build.SMEM_OPT_IN
    assert lib.uhsdr_biquad_smem(0) == lib.uhsdr_biquad_smem(33) == -1


def _sam_stage_inputs(rng, C, T, t0, dev):
    z = _pll_input(rng, C, T, t0).to(dev)
    ph = torch.from_numpy(rng.uniform(0, 2 * np.pi, (C, T))
                          .astype(np.float32)).to(dev)
    return z, ph.cos(), ph.sin()


def _sam_stage_state(rng, C, na, dev):
    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32) * 0.01).to(dev)
    fshape = (C, na) if na == 2 else (C,)
    return f(4, 7, C, 2), f(C, 2), (f(*fshape), f(*fshape))


@pytest.mark.parametrize("sideband", ["usb", "lsb", "stereo"])
@pytest.mark.parametrize("fade", [True, False], ids=["fade", "nofade"])
@pytest.mark.parametrize("C,lengths", [(40, (512, 1000, 64)),
                                       (300, (96, 33))])
def test_sam_sideband_kernel_bit_exact(dev, sideband, fade, C, lengths):
    """The fused sideband stage against its plain version, bit for bit on
    the audio and every state, over streamed blocks from a random state
    (ragged tiles, T % 4 != 0)."""
    from uhsdr_tpu_torch.cuda import sam as sam_k
    sp = sam_mod.make_params(24000.0, device=dev)
    na = 2 if sideband == "stereo" else 1
    rng = np.random.default_rng(18)
    ap, ds, fs = _sam_stage_state(rng, C, na, dev)
    k = p = (ap, ds, fs)
    t0 = 0
    for T in lengths:
        z, cs, sn = _sam_stage_inputs(rng, C, T, t0, dev)
        t0 += T
        n0 = sam_k.SAM_SIDEBAND.launches
        ak, *k = sam_k.sam_sideband(sp.ap_sos, sp.fade, *k, z, cs, sn,
                                    sideband, fade)
        assert sam_k.SAM_SIDEBAND.launches == n0 + 1
        apl, *p = sam_k.sam_sideband_plain(sp.ap_sos, sp.fade, *p, z, cs, sn,
                                           sideband, fade)
        torch.cuda.synchronize()
        assert ak.shape == ((C, 2, T) if na == 2 else (C, T))
        for a, b in ((apl, ak), (p[0], k[0]), (p[1], k[1]), (p[2][0], k[2][0]),
                     (p[2][1], k[2][1])):
            assert a.shape == b.shape and _bits_equal(a, b)


@pytest.mark.parametrize("sideband", ["usb", "stereo"])
def test_sam_sideband_channels_alone_match_the_batch(dev, sideband):
    from uhsdr_tpu_torch.cuda import sam as sam_k
    sp = sam_mod.make_params(24000.0, device=dev)
    na = 2 if sideband == "stereo" else 1
    rng = np.random.default_rng(19)
    C, T = 8192, 1024
    st = _sam_stage_state(rng, C, na, dev)
    z, cs, sn = _sam_stage_inputs(rng, C, T, 0, dev)
    full = sam_k.sam_sideband(sp.ap_sos, sp.fade, *st, z, cs, sn, sideband,
                              True)
    part = sam_k.sam_sideband(
        sp.ap_sos, sp.fade, st[0][:, :, :8].contiguous(),
        st[1][:8].contiguous(), tuple(f[:8].contiguous() for f in st[2]),
        z[:8].contiguous(), cs[:8].contiguous(), sn[:8].contiguous(),
        sideband, True)
    torch.cuda.synchronize()
    assert torch.equal(full[0][:8], part[0])
    assert torch.equal(full[1][:, :, :8], part[1])
    assert torch.equal(full[2][:8], part[2])
    for a, b in zip(full[3], part[3]):
        assert torch.equal(a[:8], b)


def test_sam_smem_matches_the_rule(dev):
    from uhsdr_tpu_torch.cuda import sam as sam_k
    lib = sam_k._lib()
    for na in (1, 2):
        for C in (1, 8, 528, 1024, 4224, 4225, 8192, 40000):
            geo = sam_k.sam_geometry(C, 100, na)
            assert lib.uhsdr_sam_sideband_smem(geo.lanes, na) == geo.smem
            # two blocks an SM past 32 channels a scheduler
            assert 2 * (geo.smem + 1024) <= 228 * 1024
    assert lib.uhsdr_sam_sideband_smem(9, 1) == -1
    assert lib.uhsdr_sam_sideband_smem(1, 3) == -1


def test_sam_sideband_refuses_what_the_kernel_does_not_take(dev):
    from uhsdr_tpu_torch.cuda import sam as sam_k
    sp = sam_mod.make_params(24000.0, device=dev)
    rng = np.random.default_rng(20)
    C, T = 4, 64
    st = _sam_stage_state(rng, C, 1, dev)
    z, cs, sn = _sam_stage_inputs(rng, C, T, 0, dev)
    with pytest.raises(ValueError):                 # not an allpass row
        bad = sp.ap_sos[0].clone()
        bad[0, 1] = 0.5
        sam_k.sam_sideband((bad, sp.ap_sos[1]), sp.fade, *st, z, cs, sn,
                           "usb", True)
    with pytest.raises(ValueError):                 # stereo's fade states
        sam_k.sam_sideband(sp.ap_sos, sp.fade, *st, z, cs, sn, "stereo",
                           True)
    with pytest.raises(ValueError):                 # 'both' is not its route
        sam_k.sam_sideband(sp.ap_sos, sp.fade, *st, z, cs, sn, "both", True)
    with pytest.raises(ValueError):                 # cos of another length
        sam_k.sam_sideband(sp.ap_sos, sp.fade, *st, z, cs[:, :32], sn,
                           "usb", True)


@pytest.mark.parametrize("which", ["sam_sideband", "pll", "pll_audio"])
def test_failed_builds_of_the_sam_kernels_raise(dev, monkeypatch, which):
    """The fused stage, K10 and K9 raise on a CUDA tensor when their build
    fails: no wrapper gives way to its plain version."""
    from uhsdr_tpu_torch.cuda import sam as sam_k
    owner = sam_k.SAM_SIDEBAND if which == "sam_sideband" else pll_k.PLL
    counter = {"sam_sideband": sam_k.SAM_SIDEBAND, "pll": pll_k.PLL,
               "pll_audio": pll_k.PLL_AUDIO}[which]
    monkeypatch.setattr(owner, "_lib", None)
    monkeypatch.setattr(owner, "flags", owner.flags +
                        ("-DFORCED_BUILD_FAILURE",))
    monkeypatch.setattr(build, "nvcc_path", lambda: "false")
    sp = sam_mod.make_params(24000.0, device=dev)
    p = pll_k.PllScalars(sp.g1, sp.g2, sp.omega_min, sp.omega_max)
    C, T = 4, 64
    z = torch.zeros((C, T), dtype=torch.complex64, device=dev)
    n0 = counter.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        if which == "sam_sideband":
            st = _sam_stage_state(np.random.default_rng(21), C, 1, dev)
            cs = torch.ones((C, T), device=dev)
            sam_k.sam_sideband(sp.ap_sos, sp.fade, *st, z, cs, cs, "usb",
                               True)
        elif which == "pll":
            pll_k.pll(p, torch.zeros((3, C), device=dev), z)
        else:
            pll_k.pll_audio(p, 0.9, 0.99, torch.zeros((5, C), device=dev), z)
    assert counter.launches == n0


# ---------------------------------------------------------------------------
# the RX options' helper kernels: IQ correction, NLMS and leaky LMS, the
# noise blanker, the spectral NR's gain machine (bit for bit against their
# plain versions, streamed blocks and edge streams)
# ---------------------------------------------------------------------------

def _edges(rng, x: np.ndarray, n0: int) -> np.ndarray:
    """x (C, T) f32 with edge samples by channel class c % 6: 0 as given;
    1 every 11th sample one of +-0, subnormals, 3e38, +-inf; 2 exact zeros
    (-0 at odd samples); 3 subnormal; 4 one NaN at stream sample 300; 5
    scaled to 1e30."""
    x = x.copy()
    C, T = x.shape
    n = np.arange(n0, n0 + T)
    special = np.array([0.0, -0.0, 1e-45, -3e-42, 1e-39, 3e38, -np.inf,
                        np.inf], np.float32)
    cls = np.arange(C) % 6
    pick = n % 11 == 3
    x[np.ix_(cls == 1, pick)] = special[(n[pick] // 11) % special.size]
    x[cls == 2] = np.where(n % 2 == 1, -0.0, 0.0).astype(np.float32)
    x[cls == 3] *= np.float32(1e-41)
    if n0 <= 300 < n0 + T:
        x[cls == 4, 300 - n0] = np.nan
    x[cls == 5] *= np.float32(1e30)
    return x


def _all_same(pairs) -> None:
    for what, (a, b) in pairs.items():
        if a.dtype in (torch.bool, torch.int32, torch.int64):
            assert torch.equal(a.cpu(), b.cpu()), what
        elif a.is_complex():
            assert _same(torch.view_as_real(a), torch.view_as_real(b)), what
        else:
            assert _same(a, b), what


@pytest.mark.parametrize("C,T,dtype,edge,offset", [
    (37, 4096, "int16", False, 0), (5, 1024, "f32", False, 0),
    (31, 2048, "f32", True, 0),
    # ragged channels and blocks: no multiple of the chunk (64 int16 or
    # 32 f32 sub-blocks) or of 32 sub-blocks
    (1, 32, "int16", False, 0), (3, 96, "f32", True, 0),
    (15, 8224, "int16", False, 0), (16, 96, "int16", False, 0),
    (17, 8224, "f32", True, 0), (511, 32, "f32", False, 0),
    (513, 96, "int16", False, 0), (8193, 96, "int16", False, 0),
    # planes that are not 16-byte aligned: plain loads into the stage
    (17, 8224, "int16", False, 1), (13, 2080, "f32", True, 1)])
def test_iqcorr_kernel_matches_plain(dev, C, T, dtype, edge, offset):
    from uhsdr_tpu_torch.cuda import iqcorr as iq_k
    rng = np.random.default_rng(71)

    def placed(v: torch.Tensor) -> torch.Tensor:
        """v on the card, `offset` elements into its storage."""
        buf = torch.empty(v.numel() + offset, dtype=v.dtype, device=dev)
        out = buf[offset:].view(v.shape)
        out.copy_(v)
        return out
    ts = [torch.zeros(C, device=dev) for _ in range(3)]
    if edge:
        ts[1][C // 2] = float("nan")
    tp = [t.clone() for t in ts]
    for b in range(3):
        n = np.arange(b * T, (b + 1) * T)
        z = (0.3 * np.exp(2j * np.pi * 0.011 * n)
             * np.linspace(0.2, 1.0, C)[:, None]
             + 0.01 * (rng.standard_normal((C, T))
                       + 1j * rng.standard_normal((C, T))))
        i_, q_ = z.real * 1.07, z.imag + 0.06 * z.real
        if dtype == "int16":
            i = torch.from_numpy(np.round(i_ * 32767).astype(np.int16))
            q = torch.from_numpy(np.round(q_ * 32767).astype(np.int16))
        else:
            i = torch.from_numpy(i_.astype(np.float32))
            q = torch.from_numpy(q_.astype(np.float32))
            if edge:
                i = torch.from_numpy(_edges(rng, i.numpy(), b * T))
                q = torch.from_numpy(_edges(rng, q.numpy(), b * T + 5))
        i, q = placed(i), placed(q)
        assert (i.data_ptr() % 16 == 0) == (offset == 0)
        n0 = iq_k.IQCORR.launches
        got = iq_k.iqcorr(*ts, i, q)
        assert iq_k.IQCORR.launches == n0 + 1
        ref = iq_k.iqcorr_plain(*tp, i, q)
        _all_same({k: (r, g) for k, r, g in zip(
            ("i", "q", "t1", "t2", "t3", "c1", "c2", "twin"), ref, got)})
        ts, tp = list(got[2:5]), list(ref[2:5])


def _lms_params(kind):
    from uhsdr_tpu_torch.ops import lms as lms_ops
    return {"notch": lms_ops.notch_params(), "nr": lms_ops.nr_params(),
            "leaky": lms_ops.leaky_lms_params(),
            "leaky_notch": lms_ops.leaky_lms_params(notch=True),
            "leaky96": lms_ops.leaky_lms_params(num_taps=96)}[kind]


def _lms_stream(dev, kind, C, lengths, edge, seed=72):
    """One LMS instance against its plain version over streamed blocks
    from a fresh state (with `edge`, a NaN weight and the edge samples),
    bit for bit on the output and every state leaf, one launch a block."""
    from uhsdr_tpu_torch.cuda import lms as lms_k
    p = _lms_params(kind)
    leaky = kind.startswith("leaky")
    L, D = p.num_taps, p.delay
    rng = np.random.default_rng(seed)
    st = [torch.zeros((C, L), device=dev), torch.zeros((C, L + D),
                                                       device=dev)]
    if leaky:
        st += [torch.full((C,), 120.0, device=dev),
               torch.full((C,), 0.001, device=dev)]
    if edge:
        st[0][C // 2, 3] = float("nan")
    sp = [t.clone() for t in st]
    n0 = 0
    for T in lengths:
        n = np.arange(n0, n0 + T)
        x = (0.5 * np.sin(2 * np.pi * 0.067 * n)
             + 0.1 * rng.standard_normal((C, T))).astype(np.float32)
        if edge:
            x = _edges(rng, x, n0)
        x = torch.from_numpy(x).to(dev)
        counter = lms_k.LMS_LEAKY if leaky else lms_k.LMS
        c0 = counter.launches
        if leaky:
            got = lms_k.leaky(p, st[0], st[1], st[2], st[3], x)
            ref = lms_k.leaky_plain(p, sp[0], sp[1], sp[2], sp[3], x)
        else:
            got = lms_k.nlms(p, st[0], st[1], x)
            ref = lms_k.nlms_plain(p, sp[0], sp[1], x)
        assert counter.launches == c0 + 1
        _all_same({k: (r, g) for k, r, g in zip(
            ("y", "w", "hist", "lidx", "ngamma"), ref, got)})
        st, sp = list(got[1:]), list(ref[1:])
        n0 += T


@pytest.mark.parametrize("kind", ["notch", "nr", "leaky", "leaky_notch"])
@pytest.mark.parametrize("C,lengths,edge", [
    (37, (300, 129, 300), False), (13, (257, 400), True),
    # ragged channels (no multiple of a warp's 8 or 16) and blocks (no
    # multiple of the group of 4 or the tile of 128), the state carried
    (1, (130, 7, 129), False), (3, (1, 262), True),
    (15, (130, 7, 129, 1, 262), True), (16, (129, 1), False),
    (17, (130, 7, 129, 1, 262), False), (511, (7, 130), True),
    (512, (262,), False), (513, (130, 7), False),
    (8193, (130, 7), False)])
def test_lms_kernels_match_plain(dev, kind, C, lengths, edge):
    _lms_stream(dev, kind, C, lengths, edge)


@pytest.mark.parametrize("kind", ["leaky", "leaky_notch", "leaky96"])
@pytest.mark.parametrize("C,lengths,edge", [
    (1, (130, 7, 257), False), (15, (1, 131, 6), True),
    (17, (130, 7, 257), True), (8193, (130, 7), False)])
def test_leaky_kernel_at_its_layout_edges(dev, kind, C, lengths, edge):
    """The leaky kernel (two lanes a channel, groups of four steps, tiles
    of 128) where a warp's channels run out (C not a multiple of 16; 8193
    past a block an SM) and the blocks are no multiple of the group or the
    tile, split across calls with the state carried."""
    _lms_stream(dev, kind, C, lengths, edge, seed=76)


def _impulsive(rng, C, n0, T, fs=12000.0):
    """Two tones and noise with impulses every ~97 samples, some within 7
    samples of a frame's or a block's edge."""
    n = np.arange(n0, n0 + T)
    x = (800.0 * np.sin(2 * np.pi * 550 / fs * n)
         + 300.0 * np.sin(2 * np.pi * 1230 / fs * n + 0.7)
         + 60.0 * rng.standard_normal((C, T)))
    hit = (n % 97 == 5) | (n % 128 == 126) | (n % 128 == 2)
    x[:, hit] += rng.choice([-1.0, 1.0], (C, hit.sum())) * rng.uniform(
        4000, 9000, (C, hit.sum()))
    return x.astype(np.float32)


def _blanker_stream(dev, C, lengths, edge, setting, make, seed=73):
    """The blanker against its plain version over streamed blocks of
    make(rng, C, n0, T) (with `edge`, a NaN in one carried context and
    the edge samples), bit for bit on the output and the context.
    Returns the number of samples the kernel changed."""
    from uhsdr_tpu_torch.cuda import blanker as nb_k
    from uhsdr_tpu_torch.nr import blanker as nb_mod
    mult = nb_mod.make_params(setting).threshold_mult
    rng = np.random.default_rng(seed)
    ctx = torch.zeros((C, nb_k.CONTEXT), device=dev)
    if edge:
        ctx[C // 2, 20] = float("nan")
    cp = ctx.clone()
    n0, changed = 0, 0
    for T in lengths:
        x = make(rng, C, n0, T)
        if edge:
            x = _edges(rng, x, n0)
        x = torch.from_numpy(x).to(dev)
        c0 = nb_k.BLANKER.launches
        y_in = torch.cat([ctx[:, nb_k.DELAY:], x], dim=-1)[:, :T]
        y, ctx = nb_k.blanker(mult, ctx, x)
        assert nb_k.BLANKER.launches == c0 + 1
        yp, cp = nb_k.blanker_plain(mult, cp, x)
        _all_same({"y": (yp, y), "context": (cp, ctx)})
        changed += int((y != y_in).sum())
        n0 += T
    return changed


@pytest.mark.parametrize("C,lengths,edge,setting", [
    (37, (1024, 256, 1024), False, 8), (13, (512, 512), True, 8),
    (9, (384,), False, 15)])
def test_blanker_kernel_matches_plain(dev, C, lengths, edge, setting):
    changed = _blanker_stream(dev, C, lengths, edge, setting, _impulsive)
    if not edge:
        assert changed > 0                    # something was repaired


def _quiet(rng, C, n0, T, fs=12000.0):
    """Two tones and a little noise: no impulse."""
    n = np.arange(n0, n0 + T)
    return (800.0 * np.sin(2 * np.pi * 550 / fs * n)
            + 300.0 * np.sin(2 * np.pi * 1230 / fs * n + 0.7)
            + 10.0 * rng.standard_normal((C, T))).astype(np.float32)


def _dense(rng, C, n0, T, fs=12000.0):
    """Impulses of 32000-72000 every 14 samples: seven or more a frame."""
    x = _quiet(rng, C, n0, T, fs)
    n = np.arange(n0, n0 + T)
    hit = n % 14 == 3
    x[:, hit] += (rng.choice([-1.0, 1.0], (C, hit.sum()))
                  * rng.uniform(32000, 72000, (C, hit.sum())))
    return x.astype(np.float32)


@pytest.mark.parametrize("make", ["quiet", "dense"])
@pytest.mark.parametrize("C,lengths,edge", [
    (1, (256, 128), False), (15, (128, 384), True), (17, (256, 128), False),
    (8193, (256,), False)])
def test_blanker_kernel_at_its_layout_edges(dev, make, C, lengths, edge):
    """The blanker kernel (two lanes a channel, up to 16 a warp) where a
    warp's channels run out, past a block an SM, on frames with no
    impulse (found 0: the two empty slots only) and with more than five
    (the cap), split across calls with the context carried."""
    fn = {"quiet": _quiet, "dense": _dense}[make]
    changed = _blanker_stream(dev, C, lengths, edge, 15 if make == "dense"
                              else 8, fn, seed=77)
    if make == "dense" and not edge:
        assert changed > 0


def _nr_spectra(rng, C, nF, f0):
    n = np.arange(f0 * 128, (f0 + nF + 1) * 128)
    x = (0.3 * np.sin(2 * np.pi * 700 / 12000 * n)
         * (np.sin(2 * np.pi * 0.5 / 12000 * n) > 0)
         + 0.05 * rng.standard_normal((C, n.size))).astype(np.float32)
    return x


@pytest.mark.parametrize("C,frames,edge", [(37, (8, 16, 8), False),
                                           (13, (16, 8), True)])
def test_nr_kernel_matches_plain(dev, C, frames, edge):
    """The gain machine through the 20-frame bootstrap and past it."""
    from uhsdr_tpu_torch.cuda import nr as nr_k
    from uhsdr_tpu_torch.nr import spectral as nr_mod
    from uhsdr_tpu_torch.ops import fftutil
    g = nr_k.gain_params(nr_mod.make_params(12000.0, 300.0, 2600.0,
                                            alpha=0.94))
    rng = np.random.default_rng(74)
    s = nr_mod.init_state((C,), device=dev)
    st = [s.xt, s.pslp, s.hk_old, s.init_count, s.nest_acc]
    if edge:
        st[0][C // 2, 40] = float("nan")
    sp = [t.clone() for t in st]
    win = torch.as_tensor(fftutil.sqrt_hann_sym(256), device=dev)
    f0 = 0
    for nF in frames:
        x = _nr_spectra(rng, C, nF, f0)
        if edge:
            x = _edges(rng, x, f0 * 128)
        frames_ = fftutil.frame_overlap(torch.from_numpy(x).to(dev), 256, 128)
        F = torch.fft.rfft(frames_ * win, dim=-1)
        c0 = nr_k.NR.launches
        got = nr_k.nr_gains(g, F.clone(), *st)
        assert nr_k.NR.launches == c0 + 1
        ref = nr_k.nr_gains_plain(g, F, *sp)
        _all_same({k: (r, v) for k, r, v in zip(
            ("F", "xt", "pslp", "hk_old", "init_count", "nest_acc"), ref,
            got)})
        st, sp = list(got[1:]), list(ref[1:])
        f0 += nF


def test_option_kernels_first_channels_alone_match_the_batch(dev):
    """Channels 0-7 alone give the bits they give in a batch of 45."""
    from uhsdr_tpu_torch.cuda import blanker as nb_k
    from uhsdr_tpu_torch.cuda import iqcorr as iq_k
    from uhsdr_tpu_torch.cuda import lms as lms_k
    from uhsdr_tpu_torch.cuda import nr as nr_k
    from uhsdr_tpu_torch.nr import spectral as nr_mod
    rng = np.random.default_rng(75)
    C, T = 45, 1024
    x = torch.from_numpy(_impulsive(rng, C, 0, T) / 9000.0).to(dev)
    z = torch.zeros(C, device=dev)
    got = iq_k.iqcorr(z, z, z, x, x.flip(-1).contiguous())
    one = iq_k.iqcorr(z[:8], z[:8], z[:8], x[:8], x.flip(-1)[:8].contiguous())
    _all_same({f"iqcorr {k}": (a[:8], b) for k, (a, b) in enumerate(
        zip(got, one))})
    for kind in ("notch", "leaky"):
        p = _lms_params(kind)
        w = torch.zeros((C, p.num_taps), device=dev)
        h = torch.zeros((C, p.num_taps + p.delay), device=dev)
        if kind == "notch":
            got = lms_k.nlms(p, w, h, x)
            one = lms_k.nlms(p, w[:8], h[:8], x[:8].contiguous())
        else:
            lv = torch.full((C,), 120.0, device=dev)
            gm = torch.full((C,), 0.001, device=dev)
            got = lms_k.leaky(p, w, h, lv, gm, x)
            one = lms_k.leaky(p, w[:8], h[:8], lv[:8], gm[:8],
                              x[:8].contiguous())
        _all_same({f"{kind} {k}": (a[:8], b) for k, (a, b) in enumerate(
            zip(got, one))})
    ctx = torch.zeros((C, nb_k.CONTEXT), device=dev)
    got = nb_k.blanker(4.0, ctx, x * 9000.0)
    one = nb_k.blanker(4.0, ctx[:8], (x * 9000.0)[:8].contiguous())
    _all_same({f"blanker {k}": (a[:8], b) for k, (a, b) in enumerate(
        zip(got, one))})
    g = nr_k.gain_params(nr_mod.make_params(12000.0, 300.0, 2600.0))
    s = nr_mod.init_state((C,), device=dev)
    F = torch.fft.rfft(torch.from_numpy(
        _nr_spectra(rng, C, 24, 0)).to(dev).reshape(C, 25, 128)[:, :24]
        .repeat(1, 1, 2), dim=-1).contiguous()
    st = [s.xt, s.pslp, s.hk_old, s.init_count, s.nest_acc]
    got = nr_k.nr_gains(g, F.clone(), *st)
    one = nr_k.nr_gains(g, F[:8].clone(), *(t[:8].contiguous() for t in st))
    _all_same({f"nr {k}": (a[:8], b) for k, (a, b) in enumerate(
        zip(got, one))})


def test_option_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from uhsdr_tpu_torch.cuda import blanker as nb_k
    from uhsdr_tpu_torch.cuda import iqcorr as iq_k
    from uhsdr_tpu_torch.cuda import lms as lms_k
    from uhsdr_tpu_torch.cuda import nr as nr_k
    from uhsdr_tpu_torch.nr import spectral as nr_mod
    C = 4
    z = torch.zeros(C, device=dev)
    with pytest.raises(ValueError):                 # T % 32 != 0
        iq_k.iqcorr(z, z, z, torch.zeros((C, 100), device=dev),
                    torch.zeros((C, 100), device=dev))
    with pytest.raises(ValueError):                 # int16 with f32
        iq_k.iqcorr(z, z, z, torch.zeros((C, 64), dtype=torch.int16,
                                         device=dev),
                    torch.zeros((C, 64), device=dev))
    with pytest.raises(ValueError):                 # f64 planes
        iq_k.iqcorr(z, z, z, torch.zeros((C, 64), dtype=torch.float64,
                                         device=dev),
                    torch.zeros((C, 64), dtype=torch.float64, device=dev))
    p = _lms_params("notch")
    x = torch.zeros((C, 64), device=dev)
    with pytest.raises(ValueError):                 # 80 taps
        lms_k.nlms(p._replace(num_taps=80), torch.zeros((C, 80), device=dev),
                   torch.zeros((C, 88), device=dev), x)
    with pytest.raises(ValueError):                 # history one short
        lms_k.nlms(p, torch.zeros((C, 96), device=dev),
                   torch.zeros((C, 103), device=dev), x)
    with pytest.raises(ValueError):                 # f64 input
        lms_k.nlms(p, torch.zeros((C, 96), device=dev),
                   torch.zeros((C, 104), device=dev), x.double())
    with pytest.raises(ValueError):                 # leaky: 80 taps
        lms_k.leaky(_lms_params("leaky")._replace(num_taps=80),
                    torch.zeros((C, 80), device=dev),
                    torch.zeros((C, 96), device=dev), z, z, x)
    with pytest.raises(ValueError):                 # leaky: delay 0
        lms_k.leaky(_lms_params("leaky")._replace(delay=0),
                    torch.zeros((C, 64), device=dev),
                    torch.zeros((C, 64), device=dev), z, z, x)
    # the libraries' layouts are the Python mirrors'
    lib = lms_k._lib(64, 16, 16, True)
    assert (lib.uhsdr_lms_leaky_lanes(), lib.uhsdr_lms_leaky_warps(),
            lib.uhsdr_lms_leaky_max_cpw(), lib.uhsdr_lms_leaky_group()) == (
        lms_k.LEAKY_LANES, lms_k.LEAKY_WARPS, lms_k.LEAKY_MAX_CPW,
        lms_k.LEAKY_GROUP)
    assert (lib.uhsdr_lms_nlms_lanes(), lib.uhsdr_lms_nlms_warps(),
            lib.uhsdr_lms_nlms_group()) == (
        lms_k.NLMS_LANES, lms_k.NLMS_WARPS, lms_k.NLMS_GROUP)
    for L, D in ((64, 16), (96, 16), (64, 1), (96, 200), (96, 8), (64, 4),
                 (64, 0)):
        for cpw in (1, 7, 8, 16):
            assert lib.uhsdr_lms_smem(L, D, cpw, 1) == lms_k.leaky_smem(
                L, D, cpw)
            assert lib.uhsdr_lms_smem(L, D, cpw, 0) == lms_k.nlms_smem(
                L, D, cpw)
        assert lib.uhsdr_lms_leaky_tile(L, D) == lms_k.leaky_tile(L, D)
    # the rules' blocks fit an SM: the notch, the NR, the leaky filter
    for p_ in (_lms_params("notch"), _lms_params("nr")):
        g = lms_k.nlms_geometry(8192, 2048, p_.num_taps, p_.delay)
        assert lib.uhsdr_lms_occupancy(
            p_.num_taps, int(p_.leak == 1.0), p_.delay, g.cpw) >= 1
    g = lms_k.leaky_geometry(8192, 2048, 64, 16)
    assert lib.uhsdr_lms_occupancy(64, 2, 16, g.cpw) >= 1
    iq_lib = iq_k._lib()
    for i16 in (True, False):
        g = iq_k.iqcorr_geometry(8192, 16384, i16)
        assert iq_lib.uhsdr_iqcorr_chunk(int(i16)) == g.chunk
        assert iq_lib.uhsdr_iqcorr_smem() == iq_k.iqcorr_smem()
        assert iq_lib.uhsdr_iqcorr_min_blocks() == iq_k.MIN_BLOCKS
        # the blocks an SM the rule counts on are resident at once
        assert iq_lib.uhsdr_iqcorr_occupancy(int(i16)) >= iq_k.MIN_BLOCKS
    assert (iq_lib.uhsdr_iqcorr_threads(), iq_lib.uhsdr_iqcorr_stages(),
            iq_lib.uhsdr_iqcorr_ahead(), iq_lib.uhsdr_iqcorr_stage_bytes()) \
        == (iq_k.THREADS, iq_k.STAGES, iq_k.AHEAD, iq_k.STAGE_BYTES)
    nb_lib = nb_k._lib(16)
    assert (nb_lib.uhsdr_blanker_lanes(), nb_lib.uhsdr_blanker_warps(),
            nb_lib.uhsdr_blanker_max_cpw()) == (
        nb_k.KERNEL_LANES, nb_k.WARPS, nb_k.MAX_CPW)
    for cpw in (1, 2, 16):
        assert nb_lib.uhsdr_blanker_smem(cpw) == nb_k.blanker_geometry(
            nb_k.WARPS * cpw * nb_k.SMS, 128, nb_k.SMS).smem
    with pytest.raises(ValueError):                 # T % 128 != 0
        nb_k.blanker(4.0, torch.zeros((C, 26), device=dev),
                     torch.zeros((C, 200), device=dev))
    with pytest.raises(ValueError):                 # f64 context
        nb_k.blanker(4.0, torch.zeros((C, 26), dtype=torch.float64,
                                      device=dev),
                     torch.zeros((C, 256), device=dev))
    g = nr_k.gain_params(nr_mod.make_params(12000.0, 300.0, 2600.0))
    s = nr_mod.init_state((C,), device=dev)
    st = (s.xt, s.pslp, s.hk_old, s.init_count, s.nest_acc)
    with pytest.raises(ValueError):                 # 128 bins, not 129
        nr_k.nr_gains(g, torch.zeros((C, 2, 128), dtype=torch.complex64,
                                     device=dev), *st)
    with pytest.raises(ValueError):                 # a float counter
        nr_k.nr_gains(g, torch.zeros((C, 2, 129), dtype=torch.complex64,
                                     device=dev),
                      *st[:3], st[3].float(), st[4])
    with pytest.raises(ValueError):                 # NR block of 200
        nr_mod.process_block(nr_mod.make_params(12000.0, 300.0, 2600.0),
                             s, torch.zeros((C, 200), device=dev))


@pytest.mark.parametrize("kw", [
    dict(mode="usb", iq_auto_correction=True, notch_enable=True,
         nb_enable=True, nr_enable=True),
    dict(mode="usb", leaky_nr_enable=True),
    dict(mode="usb", notch_enable=True, leaky_notch=True, nb_setting=12),
    dict(mode="am", bw_key="5P0KHZ", path_name="AM/SAM", nb_enable=True),
    dict(mode="ssbstereo", nr_enable=True, nr_strength=60),
    dict(mode="fm", bw_key="5P0KHZ", path_name="FM", iq_auto_correction=True,
         nr_enable=True, notch_enable=True)])
def test_option_chain_on_card_matches_cpu(dev, kw):
    from uhsdr_tpu_torch import trace_rx
    cfg = rx.RxConfig(**{**FLAGSHIP, "block_len": 4096, **kw})
    gpu, cpu = rx.RxChain(cfg, device=dev), rx.RxChain(cfg, device="cpu")
    C = 8
    sg, sc = gpu.init_state((C,)), cpu.init_state((C,))
    before = {k.name: k.launches for k in build.kernels()}
    for i, q in trace_rx.capture(3, C, dev, 5, cfg):
        yg, sg, _ = gpu(sg, i=i, q=q)
        yc, sc, _ = cpu(sc, i=i.cpu(), q=q.cpu())
        assert snr_db(yc, yg) >= CHAIN_DB
    for f, v in rx.state_to_numpy(sc).items():
        w = rx.state_to_numpy(sg)[f]
        if v.dtype == bool or v.dtype.kind in "iu":
            assert np.array_equal(v, w), f
        else:
            assert snr_db(v, w) >= CHAIN_DB, f
    ran = _launch_deltas(before)
    fm = cfg.mode == "fm"
    for name, on in (("iqcorr", cfg.iq_auto_correction),
                     ("lms", cfg.notch_enable and not cfg.leaky_notch
                      and not fm),
                     ("lms_leaky", (cfg.leaky_nr_enable or cfg.leaky_notch)
                      and not fm),
                     ("blanker", cfg.nb_enable and not fm),
                     ("nr", cfg.nr_enable and not fm)):
        assert (ran[name] == 3) == on and (ran[name] == 0) == (not on), \
            (name, ran[name])


# ---------------------------------------------------------------------------
# the IIR lattice (lattice.cu) and the table-mode FM modulator (fm_mod.cu):
# bit for bit with their plain versions, edge streams included
# ---------------------------------------------------------------------------

def _recurrence_edges(x: torch.Tensor, t0: int) -> torch.Tensor:
    """Edge samples by channel c % 6: 1 every 7th sample one of +-0,
    subnormals, 1e30, +-inf; 2 zeros; 3 subnormal; 4 one NaN at stream
    sample 40; 5 scaled to 1e30."""
    x = x.clone()
    C, T = x.shape
    n = torch.arange(t0, t0 + T, device=x.device)
    special = torch.tensor([0.0, -0.0, 1e-45, -3e-42, 1e30, float("inf"),
                            -float("inf")], device=x.device)
    cls = torch.arange(C, device=x.device) % 6
    pick = (n % 7 == 3).nonzero()[:, 0]
    rows = (cls == 1).nonzero()[:, 0]
    x[rows[:, None], pick[None, :]] = special[(n[pick] // 7) % 7]
    x[cls == 2] = 0.0
    x[cls == 3] *= 1e-41
    if t0 <= 40 < t0 + T:
        x[cls == 4, 40 - t0] = float("nan")
    x[cls == 5] *= 1e30
    return x


def _lattice_tables():
    """The imported tables (6, 8, 10 and 10 stages) and made-up stable
    lattices of every other stage count from 1 to 12."""
    from uhsdr_tpu_torch import data
    rng = np.random.default_rng(3)
    out = [data.lattice(n) for n in ("IIR_aa_10k", "IIR_8k_LPF",
                                     "IIR_2k3_1k412", "IIR_TX_2k7_FM")]
    for n in (1, 2, 3, 4, 5, 7, 9, 11, 12):
        out.append((rng.uniform(-0.8, 0.8, n).astype(np.float32),
                    rng.uniform(-1.0, 1.0, n + 1).astype(np.float32)))
    return out


# channel counts that fill no walker's rows (the launch rule's 4 x lanes a
# block) and blocks that end inside a tile, streamed with the state carried
_RAGGED = [(40, (100, 33, 100)), (33, (31, 1, 64)), (7, (500,)),
           (1, (45, 32, 3)), (3, (64, 13, 29)), (17, (100, 33, 100)),
           (8193, (40, 33))]


@pytest.mark.parametrize("C,lengths", _RAGGED)
@pytest.mark.parametrize("edge", [False, True])
def test_lattice_kernel_bit_exact(dev, C, lengths, edge):
    """Every stage count 1-12 against the plain version on the card, and
    at up to 64 channels its CPU route too, bit for bit on y and the
    state."""
    from uhsdr_tpu_torch.cuda import lattice as lat_k
    rng = np.random.default_rng(C)
    for pk, pv in _lattice_tables():
        sk = torch.zeros((C, len(pk)), device=dev)
        if edge:
            sk[C // 2, 0] = float("nan")
        sp, sc, t0 = sk, sk.cpu(), 0
        for T in lengths:
            x = torch.as_tensor(rng.standard_normal((C, T)) * 1000.0,
                                dtype=torch.float32, device=dev)
            if edge:
                x = _recurrence_edges(x, t0)
            t0 += T
            yk, sk = lat_k.lattice(pk, pv, sk, x)
            yp, sp = lat_k.lattice_plain(pk, pv, sp, x)
            torch.cuda.synchronize()
            assert _bits_equal(yp, yk) and _bits_equal(sp, sk), (len(pk), T)
            if C <= 64:
                # the plain version's CPU route (channel by channel on
                # NumPy scalars, `ops/steps.py::scan`) too
                yc, sc = lat_k.lattice_plain(pk, pv, sc, x.cpu())
                assert _bits_equal(yc, yk.cpu()) and _bits_equal(
                    sc, sk.cpu()), (len(pk), T, "cpu")


def test_lattice_kernel_refuses_and_counts(dev):
    from uhsdr_tpu_torch.cuda import lattice as lat_k
    from uhsdr_tpu_torch.cuda import ring
    lib = lat_k._lib()
    assert lib.uhsdr_lattice_max_stages() == lat_k.MAX_STAGES
    assert lib.uhsdr_lattice_max_lanes() == lat_k.MAX_LANES
    assert (lib.uhsdr_lattice_walkers(), lib.uhsdr_lattice_tile(),
            lib.uhsdr_lattice_stages(), lib.uhsdr_lattice_threads()) == (
        ring.WALKERS, ring.TILE, ring.STAGES, ring.THREADS)
    for C in (1, 17, 8192, 8193, 20000):
        g = lat_k.lattice_geometry(C, 100, 10)
        assert lib.uhsdr_lattice_smem(g.lanes) == g.smem, C
    assert lib.uhsdr_lattice_smem(0) == lib.uhsdr_lattice_smem(33) == -1
    pk, pv = np.zeros(13, np.float32), np.zeros(14, np.float32)
    x = torch.zeros((4, 10), device=dev)
    with pytest.raises(ValueError, match="lattice"):
        lat_k.lattice(pk, pv, torch.zeros((4, 13), device=dev), x)
    with pytest.raises(ValueError, match="lattice"):
        lat_k.lattice(pk[:6], pv[:7], torch.zeros((4, 5), device=dev), x)
    n0 = lat_k.LATTICE.launches
    lat_k.lattice(pk[:6], pv[:7], torch.zeros((4, 6), device=dev), x)
    assert lat_k.LATTICE.launches == n0 + 1


@pytest.mark.parametrize("C", [1, 3, 17, 37, 8193])
@pytest.mark.parametrize("count_domain,translate,subtone", [
    (True, 6000.0, 0.0), (True, -9000.0, 88.5), (False, 12000.0, 0.0)])
@pytest.mark.parametrize("edge", [False, True])
def test_fm_mod_kernel_bit_exact(dev, count_domain, translate, subtone, edge,
                                 C):
    """The kernel at the modulator's parameters (the legacy mode's too,
    which the chain runs in torch), a subtone plane, ragged channels and
    blocks streamed with the state carried, edge streams with a NaN
    state.  At up to 64 channels the plain version's CPU route
    (`ops/steps.py::scan`) holds the state bit for bit and i, q within
    1e-6: its DDS table is made with the CPU's sine."""
    from uhsdr_tpu_torch.cuda import fm_mod as fm_k
    from uhsdr_tpu_torch.mod import modulators as mods
    p = mods.fm_mod_params(translate, False, subtone,
                           count_domain=count_domain)
    rng = np.random.default_rng(9)
    z = torch.zeros((C,), device=dev)
    st = [z.clone(), z.clone(),
          torch.full((C,), 65000, dtype=torch.int32, device=dev)]
    if edge:
        st[0][C // 2] = float("nan")
    sp, t0 = list(st), 0
    sc = [t.cpu() for t in st]
    for T in (100, 31, 257):
        scale = 9000.0 if count_domain else 0.3
        x = torch.as_tensor(rng.standard_normal((C, T)) * scale,
                            dtype=torch.float32, device=dev)
        if edge:
            x = _recurrence_edges(x, t0)
        t0 += T
        add = (torch.as_tensor(rng.standard_normal((C, T)) * 0.01,
                               dtype=torch.float32, device=dev)
               if subtone else None)
        args = (mods.FM_TX_HPF_ALPHA, float(p.freq_word), p.mod_scale,
                mods.FM_MOD_AMPLITUDE_SCALING, p.swap_iq)
        got = fm_k.fm_mod(x, add, *st, *args)
        ref = fm_k.fm_mod_plain(x, add, *sp, *args)
        torch.cuda.synchronize()
        assert all(_bits_equal(a, b) for a, b in zip(ref, got)), T
        if C <= 64:
            cpu = fm_k.fm_mod_plain(
                x.cpu(), None if add is None else add.cpu(), *sc, *args)
            for k, (a, b) in enumerate(zip(cpu, got)):
                if k < 2:
                    assert torch.allclose(a, b.cpu(), rtol=0, atol=1e-6,
                                          equal_nan=True), (T, k, "cpu")
                else:
                    assert _bits_equal(a, b.cpu()), (T, k, "cpu")
            sc = list(cpu[2:])
        st, sp = list(got[2:]), list(ref[2:])


def test_fm_mod_kernel_refuses_and_counts(dev):
    from uhsdr_tpu_torch.cuda import fm_mod as fm_k
    from uhsdr_tpu_torch.cuda import ring
    lib = fm_k._lib()
    assert lib.uhsdr_fm_mod_table() == fm_k.TABLE
    assert lib.uhsdr_fm_mod_max_lanes() == fm_k.MAX_LANES
    assert (lib.uhsdr_fm_mod_walkers(), lib.uhsdr_fm_mod_tile(),
            lib.uhsdr_fm_mod_stages(), lib.uhsdr_fm_mod_threads()) == (
        ring.WALKERS, ring.TILE, ring.STAGES, ring.THREADS)
    for C in (1, 17, 8192, 8193, 20000):
        for add in (False, True):
            g = fm_k.fm_mod_geometry(C, 100, add)
            assert lib.uhsdr_fm_mod_smem(g.lanes, int(add)) == g.smem, C
    assert lib.uhsdr_fm_mod_smem(0, 0) == lib.uhsdr_fm_mod_smem(33, 1) == -1
    z = torch.zeros((4,), device=dev)
    acc = torch.zeros((4,), dtype=torch.int32, device=dev)
    x = torch.zeros((4, 10), device=dev)
    args = (0.05, 8192.0, 16.0, 0.875, False)
    with pytest.raises(ValueError, match="fm_mod"):
        fm_k.fm_mod(x, None, z, z, acc.to(torch.int64), *args)
    with pytest.raises(ValueError, match="fm_mod"):
        fm_k.fm_mod(x, torch.zeros((4, 9), device=dev), z, z, acc, *args)
    n0 = fm_k.FM_MOD.launches
    fm_k.fm_mod(x, None, z, z, acc, *args)
    assert fm_k.FM_MOD.launches == n0 + 1


@pytest.mark.parametrize("which", ["refchain", "legacy", "tx_fm"])
def test_slice19_chains_on_card_match_cpu(dev, which):
    """The reference chain (usb 2P3KHZ select 2), the legacy front's SSB
    flagship and FM TX on the card against the CPU at 80 dB, 3 blocks of
    8 channels."""
    from uhsdr_tpu_torch import trace_rx, trace_tx
    from uhsdr_tpu_torch.chain import refchain, tx
    C = 8
    if which == "refchain":
        cfg = refchain.RefRxConfig(mode="usb", select_id=2, block_len=4096)
        gpu = refchain.RefRxChain(cfg, device=dev)
        cpu = refchain.RefRxChain(cfg, device="cpu")
        proxy = rx.RxConfig(mode="usb", translate_hz=6000.0, iq_rate=48000.0,
                            block_len=4096)
        blocks = [(i.float(), q.float())
                  for i, q in trace_rx.capture(3, C, dev, 3, proxy)]
    elif which == "legacy":
        cfg = rx.RxConfig(**{**FLAGSHIP, "block_len": 4096, "front": "scipy"})
        gpu, cpu = rx.RxChain(cfg, device=dev), rx.RxChain(cfg, device="cpu")
        blocks = trace_rx.capture(3, C, dev, 3, cfg)
    else:
        cfg = tx.TxConfig(mode="fm", block_len=4096)
        gpu, cpu = tx.TxChain(cfg, device=dev), tx.TxChain(cfg, device="cpu")
        blocks = trace_tx.capture(3, C, dev, 3, cfg)
    sg, sc = gpu.init_state((C,)), cpu.init_state((C,))
    for blk in blocks:
        if which == "tx_fm":
            ig, qg, sg = gpu(sg, blk)
            ic, qc, sc = cpu(sc, blk.cpu())
            yg, yc = torch.complex(ig, qg), torch.complex(ic, qc)
        else:
            out_g = gpu(sg, i=blk[0], q=blk[1])
            out_c = cpu(sc, i=blk[0].cpu(), q=blk[1].cpu())
            (yg, sg), (yc, sc) = out_g[:2], out_c[:2]
        assert bool(torch.isfinite(torch.view_as_real(yg) if yg.is_complex()
                                   else yg).all())
        assert snr_db(yc, yg) >= CHAIN_DB, which


# ---------------------------------------------------------------------------
# The digital-mode decoders' helper kernels (cw.cu, psk.cu, rtty.cu), bit
# for bit against their plain versions: streamed ragged blocks, edge
# streams, channels 0-7 alone against the batch
# ---------------------------------------------------------------------------

def _digital_audio(C: int, T: int, seed: int) -> torch.Tensor:
    """(C, T) f32 @ 12 kHz from the port's own modulators, by channel
    c % 4: RTTY 45.45 Bd "RYRY CQ DE UHSDR", PSK63 "CQ CQ", CW 700 Hz
    "PARIS" at 25 wpm, noise alone; each from its own start offset and at
    its own level, plus noise."""
    from uhsdr_tpu_torch.modems import cw_text, psk, psk_text, rtty
    from uhsdr_tpu_torch.modems import rtty_text
    rng = np.random.default_rng(seed)
    rp, pp = rtty.make_params(), psk.make_params(speed=63)
    bits = rtty_text.codes_to_bits(rtty_text.encode("RYRY CQ DE UHSDR") * 3,
                                   rp.one_bit)
    signs, env = psk_text.bits_to_waveform_params(
        psk_text.encode_bits("CQ CQ " * 6), pp.rate)
    key = cw_text.text_to_keying("PARIS " * 4, 25, 12000.0)
    n = max(len(bits), len(signs), len(key)) + T
    bits = np.concatenate([bits, np.ones(n - len(bits), bool)])
    signs = np.concatenate([signs, np.ones(n - len(signs), np.float32)])
    env = np.concatenate([env, np.ones(n - len(env), np.float32)])
    key = np.concatenate([key, np.zeros(n - len(key), np.float32)])
    z64 = torch.zeros(1, dtype=torch.int64)
    srcs = [rtty.modulate(rp, z64, torch.from_numpy(bits[None]))[0][0],
            psk.modulate(pp, z64, torch.from_numpy(signs[None]),
                         torch.from_numpy(env[None]))[0][0],
            torch.from_numpy(key * np.sin(2 * np.pi * 700.0 / 12000.0
                                          * np.arange(n)).astype(np.float32)),
            torch.zeros(n)]
    x = np.empty((C, T), np.float32)
    for c in range(C):
        off = int(rng.integers(0, n - T))
        x[c] = srcs[c % 4][off:off + T].numpy() * (0.2 + c % 5)
    x += 0.02 * rng.standard_normal((C, T)).astype(np.float32)
    return torch.from_numpy(x)


def _modem_run(kind: str, C: int, lengths, dev, edge: bool, **kw):
    """Stream `kind`'s kernel and its plain version, on the card and on
    the CPU, over the blocks from the zero state (with `edge`, edge
    samples and a NaN in one channel's first state leaf); returns
    [(kernel out, plain out, the CPU's plain out)] a block, each a tuple
    of output tensors then state leaves."""
    from uhsdr_tpu_torch.modems import cw, psk, rtty
    x_all = _digital_audio(C, sum(lengths), seed=C + len(lengths)).to(dev)
    if kind == "cw":
        p = cw.make_params(atc=kw["atc"], noisecancel=kw["nc"],
                           thresh=kw.get("thresh", 32000.0))
        sk = cw.init_state((C,), dev)
        run = lambda s, x: cw_k.cw_detect(  # noqa: E731
            p.cos_v, p.sin_v, p.thresh, p.atc, p.noisecancel, s, x)
        plain = lambda s, x: cw_k.cw_detect_plain(  # noqa: E731
            p.cos_v, p.sin_v, p.thresh, p.atc, p.noisecancel, s, x)
        sk = cw_k.CwLeaves(*sk)
    elif kind == "psk":
        p = psk.make_params(speed=kw["speed"])
        s0 = psk.init_state((C,), p, dev)
        sk = psk_k.PskLeaves(s0.bpf_bq, s0.nco_phase, s0.prod_tail,
                             s0.last_symbol, s0.last_bit)
        d = int(psk.nco.freq_to_delta(psk.PSK_OFFSET, p.fs))
        run = lambda s, x: psk_k.psk(p.bpf, d, p.rate, s, x)  # noqa: E731
        plain = lambda s, x: psk_k.psk_plain(  # noqa: E731
            p.bpf, d, p.rate, s, x)
    else:
        p = rtty.make_params(atc=kw["atc"])
        sk = rtty.init_state((C,), dev)

        def run(s, x, f=rtty_k.rtty):
            n_slots = rtty.max_bytes(p, x.shape[-1])
            codes, nb, s = f(p.mark_bp, p.space_bp, p.lpf, p.one_bit, p.atc,
                             n_slots, s, x)
            return (codes, nb), s
        plain = lambda s, x: run(s, x, rtty_k.rtty_plain)  # noqa: E731
    if edge:
        first = sk[0].clone()
        first.view(first.shape[0], -1)[C // 2, 0] = float("nan")
        sk = type(sk)(first, *sk[1:])
    sp, sc, t0, out = sk, type(sk)(*(t.cpu() for t in sk)), 0, []
    for T in lengths:
        x = x_all[:, t0:t0 + T].contiguous()
        if edge:
            x = _recurrence_edges(x, t0)
        t0 += T
        yk, sk = run(sk, x)
        yp, sp = plain(sp, x)
        yc, sc = plain(sc, x.cpu())
        torch.cuda.synchronize()
        ys = [y if isinstance(y, tuple) else (y,) for y in (yk, yp, yc)]
        out.append(tuple(y + tuple(s) for y, s in zip(ys, (sk, sp, sc))))
    return out


# PSK's leaves that carry its sine: the product tail and the last symbol
PSK_SINE_LEAVES = (3, 4)


def _modem_same(out, kind: str) -> None:
    """The kernel against its plain version on the card, bit for bit,
    and against the plain version's CPU route (NumPy views of the
    tensors, `ops/steps.py::host_arrays`), bit for bit too, but for
    PSK's sine leaves: the CPU's `torch.sin` is not the card's `sinf`
    (each within 2 ulp of the sine), so those are held to 1e-5 of their
    largest magnitude, with the filter state, the phase and the bits
    equal."""
    for blk, (ks, ps, cs) in enumerate(out):
        for i, (a, b, c) in enumerate(zip(ks, ps, cs)):
            if a.dtype.is_floating_point:
                assert _bits_equal(b, a), (blk, i)
                if kind == "psk" and i in PSK_SINE_LEAVES:
                    fin = a[torch.isfinite(a)]
                    tol = 1e-5 * float(fin.abs().max()) if fin.numel() else 0
                    assert torch.allclose(c, a.cpu(), rtol=1e-5, atol=tol,
                                          equal_nan=True), (blk, i, "cpu")
                else:
                    assert _bits_equal(c, a.cpu()), (blk, i, "cpu")
            else:
                assert torch.equal(a, b), (blk, i)
                assert torch.equal(c, a.cpu()), (blk, i, "cpu")


@pytest.mark.parametrize("atc,nc", [(False, False), (False, True),
                                    (True, False), (True, True)])
@pytest.mark.parametrize("edge", [False, True])
def test_cw_kernel_bit_exact(dev, atc, nc, edge):
    out = _modem_run("cw", 37, (88 * 10, 88, 88 * 23), dev, edge, atc=atc,
                     nc=nc, thresh=3.0e3)
    _modem_same(out, "cw")
    if not edge:
        assert any(bool(o[0][0].any()) for o in out)


@pytest.mark.parametrize("speed", [31, 63, 125])
@pytest.mark.parametrize("edge", [False, True])
def test_psk_kernel_bit_exact(dev, speed, edge):
    rate = {31: 384, 63: 192, 125: 96}[speed]
    out = _modem_run("psk", 37, (rate * 3, rate, rate * 5), dev, edge,
                     speed=speed)
    _modem_same(out, "psk")


@pytest.mark.parametrize("atc", [False, True])
@pytest.mark.parametrize("edge", [False, True])
def test_rtty_kernel_bit_exact(dev, atc, edge):
    out = _modem_run("rtty", 37, (2048, 77, 1, 2500), dev, edge, atc=atc)
    _modem_same(out, "rtty")
    if not edge:
        assert sum(int(o[0][1].sum()) for o in out) > 0   # codes framed


@pytest.mark.parametrize("kind,kw", [("cw", dict(atc=True, nc=True)),
                                     ("psk", dict(speed=31)),
                                     ("rtty", dict(atc=True))])
def test_modem_kernels_first_channels_alone_match_the_batch(dev, kind, kw):
    T = {"cw": 88 * 23, "psk": 384 * 5, "rtty": 2048}[kind]
    x = _digital_audio(40, T, seed=41).to(dev)[:8].contiguous()
    x40 = _digital_audio(40, T, seed=41).to(dev)
    from uhsdr_tpu_torch.modems import cw, psk, rtty
    if kind == "cw":
        p = cw.make_params(atc=True)
        a = cw.keying_detect(p, cw.init_state((40,), dev), x40)
        b = cw.keying_detect(p, cw.init_state((8,), dev), x)
    elif kind == "psk":
        p = psk.make_params(speed=31)
        a = psk.demodulate(p, psk.init_state((40,), p, dev), x40)
        b = psk.demodulate(p, psk.init_state((8,), p, dev), x)
    else:
        p = rtty.make_params()
        a = rtty.demodulate(p, rtty.init_state((40,), dev), x40)
        b = rtty.demodulate(p, rtty.init_state((8,), dev), x)
    def flat(r):
        return [t for v in r for t in (v if isinstance(v, tuple) else (v,))]
    for u, v in zip(flat(a), flat(b)):
        assert torch.equal(u[:8], v), kind


def test_modem_wrappers_refuse_and_count(dev):
    from uhsdr_tpu_torch.modems import cw, psk, rtty
    assert cw_k.CW.lib().uhsdr_cw_max_blocksize() == cw_k.MAX_BLOCKSIZE
    assert psk_k.PSK.lib().uhsdr_psk_window() == psk_k.WINDOW
    pc = cw.make_params()
    with pytest.raises(ValueError, match="cw"):
        cw.keying_detect(pc, cw.init_state((4,), dev),
                         torch.zeros((4, 100), device=dev))
    pp = psk.make_params()
    with pytest.raises(ValueError, match="psk"):
        psk.demodulate(pp, psk.init_state((4,), pp, dev),
                       torch.zeros((4, 384), device=dev, dtype=torch.float64))
    pr = rtty.make_params()
    with pytest.raises(ValueError, match="rtty"):
        rtty.demodulate(pr, rtty.init_state((5,), dev),
                        torch.zeros((4, 300), device=dev))
    n0 = (cw_k.CW.launches, psk_k.PSK.launches, rtty_k.RTTY.launches)
    cw.keying_detect(pc, cw.init_state((4,), dev),
                     torch.zeros((4, 176), device=dev))
    psk.demodulate(pp, psk.init_state((4,), pp, dev),
                   torch.zeros((4, 384), device=dev))
    rtty.demodulate(pr, rtty.init_state((4,), dev),
                    torch.zeros((4, 300), device=dev))
    assert (cw_k.CW.launches, psk_k.PSK.launches, rtty_k.RTTY.launches) == \
        tuple(n + 1 for n in n0)


# K5 with a delta a channel (FreeDV's fronts): 0 Hz, large, and negative
# frequencies in one launch
FREEDV_OFFSETS = (0.0, 700.0, -1200.0, 3000.0, -3000.0, 23999.0, -6000.0,
                  12.5, -0.5)


def _freedv_deltas(C, dev):
    f = np.resize(np.asarray(FREEDV_OFFSETS), C)
    d = np.asarray([nco.freq_to_delta(-v, 48000.0) for v in f], np.uint32)
    return torch.from_numpy(d.astype(np.int64)).to(dev)


@pytest.mark.parametrize("C,B,dtype", [(9, 7680, "float32"),
                                       (5, 1206, "float32"),
                                       (3, 30720, "int16"),
                                       (1, 600, "float32")])
def test_fir_rt_delta_rows_match_plain(dev, C, B, dtype):
    """K5 with a (C,) tensor of increments (the DROW instance) against
    fir_rt_plain over three streamed blocks at FreeDV's 72 taps and /6,
    complex and planes out, counted once a launch as K5."""
    from uhsdr_tpu_torch.ops import design
    rng = np.random.default_rng(21)
    h = torch.from_numpy(design.decimation_fir(72, 6, 48000.0)
                         .astype(np.float32)).to(dev)
    deltas = _freedv_deltas(C, dev)
    ck = cp = torch.zeros((C, 71), dtype=torch.complex64, device=dev)
    ph = torch.from_numpy(rng.integers(0, 2**32, C)).to(dev)
    for blk in range(3):
        x = [torch.from_numpy(_int16(rng, (C, B))).to(dev) for _ in "iq"]
        if dtype == "float32":
            x = [v.to(torch.float32) / 32768.0 for v in x]
        n0 = fir_k.FIR_RT.launches
        yk, ck_new, pk = fir_k.fir_rt(h, ck, *x, 6, nco=(ph, deltas))
        (ar, ai), c2, _ = fir_k.fir_rt(h, ck, *x, 6, nco=(ph, deltas),
                                       planes_out=True)
        assert fir_k.FIR_RT.launches == n0 + 2
        yp, cp, pp = fir_k.fir_rt_plain(h, cp, *x, 6, nco=(ph, deltas))
        torch.cuda.synchronize()
        for a, b in ((yp, yk), (cp, ck_new), (pp, pk), (yp.real, ar),
                     (yp.imag, ai)):
            assert snr_db(a, b) >= FIR_DB
        assert torch.equal(c2, ck_new)
        ck = ck_new
        ph = nco.advance(ph, deltas, B)


def test_fir_rt_delta_rows_channel_alone(dev):
    """Each channel of a launch with a delta a channel gives the bits the
    scalar-delta launch gives that channel alone, a 0 delta included; a
    batch of 1 gives the bits of that channel in the batch."""
    from uhsdr_tpu_torch.ops import design
    rng = np.random.default_rng(22)
    C, B = 9, 7680
    h = torch.from_numpy(design.decimation_fir(72, 6, 48000.0)
                         .astype(np.float32)).to(dev)
    deltas = _freedv_deltas(C, dev)
    carry = torch.from_numpy((0.1 * (rng.standard_normal((C, 71))
                                     + 1j * rng.standard_normal((C, 71))))
                             .astype(np.complex64)).to(dev)
    ph = torch.from_numpy(rng.integers(0, 2**32, C)).to(dev)
    x = [torch.from_numpy(rng.standard_normal((C, B)).astype(np.float32))
         .to(dev) for _ in "iq"]
    full = fir_k.fir_rt(h, carry, *x, 6, nco=(ph, deltas))
    for c in range(C):
        sl = slice(c, c + 1)
        args = (h, carry[sl].contiguous(), *(v[sl].contiguous() for v in x),
                6)
        alone = fir_k.fir_rt(*args, nco=(ph[sl].contiguous(),
                                         int(deltas[c])))
        one = fir_k.fir_rt(*args, nco=(ph[sl].contiguous(),
                                       deltas[sl].contiguous()))
        torch.cuda.synchronize()
        for a, b, d in zip(full, alone, one):
            assert torch.equal(a[sl], b) and torch.equal(b, d), c


def test_fir_rt_delta_rows_refused(dev):
    """A delta a channel takes K5 alone, (C,) int64 on the planes'
    device."""
    h = torch.zeros(72, device=dev)
    carry = torch.zeros((4, 71), dtype=torch.complex64, device=dev)
    x = torch.zeros((4, 600), device=dev)
    ph = torch.zeros(4, dtype=torch.int64, device=dev)
    for bad in (torch.zeros(3, dtype=torch.int64, device=dev),
                torch.zeros(4, dtype=torch.int32, device=dev),
                torch.zeros(4, dtype=torch.int64)):
        with pytest.raises(ValueError, match="fir_rt"):
            fir_k.fir_rt(h, carry, x, x, 6, nco=(ph, bad))
    with pytest.raises(ValueError, match="fir_cx"):
        fir_k.fir_cx(h.to(torch.complex64), carry, x, x, 6,
                     nco=(ph, torch.zeros(4, dtype=torch.int64, device=dev)))


def test_freedv_fronts_on_card_match_cpu(dev):
    """FreeDvFleetGroup's front (one K5 launch a block) and
    FreeDvRadioMode's (a retune mid-stream, then 0 Hz) and RateConverter's
    up (K4) on the card against the same objects on the CPU."""
    from uhsdr_tpu_torch.modems import freedv
    rng = np.random.default_rng(23)
    C, B = 6, 7680
    off = np.asarray(FREEDV_OFFSETS[:C])
    g_card = fleet_mod.FreeDvFleetGroup(C, block_len_48k=B,
                                        translate_hz=off, device=dev)
    g_cpu = fleet_mod.FreeDvFleetGroup(C, block_len_48k=B,
                                       translate_hz=off, device="cpu")
    r_card = freedv.FreeDvRadioMode("freedv1600", B, 6000.0, device=dev)
    r_cpu = freedv.FreeDvRadioMode("freedv1600", B, 6000.0, device="cpu")
    for blk, extra in enumerate((0.0, 300.0, 300.0, -6000.0)):
        xi, xq = (rng.standard_normal((C, B)).astype(np.float32)
                  for _ in "iq")
        n0 = fir_k.FIR_RT.launches
        a = g_card.front_block(xi, xq)
        assert fir_k.FIR_RT.launches == n0 + 1
        b = g_cpu.front_block(xi, xq)
        assert a.dtype == b.dtype
        assert snr_db(torch.from_numpy(b), torch.from_numpy(a)) >= FIR_DB
        sa, sb = g_card.state_to_numpy(), g_cpu.state_to_numpy()
        assert np.array_equal(sa["phases"], sb["phases"])
        for k in ("ci", "cq"):
            assert snr_db(torch.from_numpy(sb[k]),
                          torch.from_numpy(sa[k])) >= FIR_DB, (blk, k)
        d = r_card._delta(extra)
        ya = r_card.conv.down_planes(torch.from_numpy(xi[:1]).to(dev),
                                     torch.from_numpy(xq[:1]).to(dev), d)
        yb = r_cpu.conv.down_planes(torch.from_numpy(xi[:1]),
                                    torch.from_numpy(xq[:1]), d)
        assert snr_db(yb, ya.cpu()) >= FIR_DB, blk
        s8 = rng.standard_normal((2, 1280)).astype(np.float32)
        n0 = fir_k.INTERP.launches
        ua = r_card.conv.up(torch.from_numpy(s8).to(dev))
        assert fir_k.INTERP.launches == n0 + 1
        ub = r_cpu.conv.up(torch.from_numpy(s8))
        assert snr_db(ub, ua.cpu()) >= FIR_DB


# ---------------------------------------------------------------------------
# the entry points: the command line and the live server on the card
# ---------------------------------------------------------------------------

def _cli(argv, monkeypatch):
    """`cli.main(argv)` in process: (its last JSON line, {writer: the
    array the command handed `io.ingest`'s WAV writer})."""
    import contextlib
    import io
    import json

    from uhsdr_tpu_torch import cli
    from uhsdr_tpu_torch.io import ingest
    got = {}
    for fn in ("write_audio_wav", "write_iq_wav"):
        orig = getattr(ingest, fn)

        def keep(path, a, *args, _fn=fn, _orig=orig, **kw):
            got[_fn] = np.array(a)
            _orig(path, a, *args, **kw)
        monkeypatch.setattr(ingest, fn, keep)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    monkeypatch.undo()
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1]), got


def _peak_hz(x, fs=48000.0):
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    spec[:8] = 0.0
    return np.fft.rfftfreq(len(x), 1 / fs)[spec.argmax()]


@pytest.mark.parametrize("mode,text", [("cw", "TEST"),
                                       ("rtty", "RYRY DE UHSDR"),
                                       ("psk", "psk31 de uhsdr")])
def test_cli_text_round_trip_on_card(dev, mode, text, tmp_path,
                                     monkeypatch):
    """`tx --text` then `rx --decode` on the card: the sent text comes
    back (CW's with the decoder's letter gaps removed, at 28 wpm)."""
    iq = str(tmp_path / "iq.wav")
    extra = ["--wpm", "28"] if mode == "cw" else []
    _cli(["tx", "--out", iq, "--mode", mode, "--text", text] + extra,
         monkeypatch)
    m, _ = _cli(["rx", "--input", iq, "--mode", mode, "--decode"],
                monkeypatch)
    got = m["text"].replace(" ", "") if mode == "cw" else m["text"]
    assert text in got, m["text"]


def test_cli_usb_tone_and_first_blocks_on_card(dev, tmp_path, monkeypatch):
    """`tx --mode usb` (a 700 Hz tone) and `rx` on the card: the audio's
    peak at 700 +- 15 Hz, and its first 3 blocks against the same
    command with `--device cpu` at 80 dB; the TX IQ against the CPU's at
    80 dB too."""
    iq = str(tmp_path / "iq.wav")
    _, tx_card = _cli(["tx", "--out", iq, "--mode", "usb"], monkeypatch)
    _, tx_cpu = _cli(["tx", "--out", str(tmp_path / "iq_cpu.wav"),
                      "--mode", "usb", "--device", "cpu"], monkeypatch)
    assert snr_db(tx_cpu["write_iq_wav"], tx_card["write_iq_wav"]) >= \
        CHAIN_DB
    argv = ["rx", "--input", iq, "--mode", "usb",
            "--out", str(tmp_path / "a.wav")]
    m, card = _cli(argv, monkeypatch)
    m_cpu, cpu = _cli(argv + ["--device", "cpu", "--max-blocks", "3"],
                      monkeypatch)
    a, b = card["write_audio_wav"], cpu["write_audio_wav"]
    assert abs(_peak_hz(a[24000:]) - 700.0) < 15.0
    assert snr_db(b, a[:b.size]) >= CHAIN_DB
    assert m_cpu["blocks"] == 3 and m["blocks"] > 3


def test_radio_server_on_card_with_cat_retune(dev, tmp_path):
    """`RadioServer` on the card over a looping capture: its first blocks
    against the CPU chain at 80 dB; a CAT retune over TCP moves the audio
    to the second station; `error` stays None."""
    from uhsdr_tpu_torch.control import cat, server
    from uhsdr_tpu_torch.io import ingest
    fs, block, center = 48000.0, 4096, 14_001_000
    t = np.arange(16 * block) / fs
    iq = (0.4 * np.exp(2j * np.pi * 6700.0 * t)
          + 0.3 * np.exp(2j * np.pi * (6000.0 + 1500.0 + 1000.0) * t)
          ).astype(np.complex64)
    path = str(tmp_path / "cap.wav")
    ingest.write_iq_wav(path, iq)
    radio, catsrv = server.serve(server.ServeConfig(
        iq_path=path, center_hz=center, block_len=block, loop=True,
        audio_keep_blocks=512))
    client = None
    try:
        client = cat.CatClient(port=catsrv.port)
        assert radio.wait_blocks(4, timeout=120), radio.error
        first = radio.audio()[:3 * block].copy()
        client.set_frequency(center + 1500)
        assert radio.wait_blocks(2, timeout=120), radio.error
        radio.audio_blocks.clear()
        assert radio.wait_blocks(6, timeout=120), radio.error
        after = radio.audio()[-3 * block:].copy()
    finally:
        if client is not None:
            client.close()
        radio.stop()
        catsrv.stop()
    assert radio.error is None, radio.error
    chain = rx.RxChain(rx.RxConfig(mode="usb", block_len=block),
                       device="cpu")
    st = chain.init_state((1,))
    z = ingest.read_iq_file(path)           # the capture as the pump reads it
    ref = []
    for k in range(3):
        zk = z[None, k * block:(k + 1) * block]
        y, st, _ = chain(st, i=zk.real.copy(), q=zk.imag.copy(),
                         tune_offset_hz=0.0)
        ref.append(y[0].numpy())
    assert snr_db(np.concatenate(ref), first) >= CHAIN_DB
    assert abs(_peak_hz(after) - 1000.0) < 30.0
