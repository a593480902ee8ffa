"""K6/K7's tile geometry (`cuda/fir.py::fir_cx_geometry`, the rule the
`kernels/front.cu` launcher applies to its complex-tap stage-A instances)
over every shape the port sends K6/K7, and their schedule.

The rule is pure Python, so it is checked here on the CPU: every wide-SSB
row at 48, 96 and 192 kHz (decimation 2 to 8), on int16 and f32 planes,
fits the shared memory with at least three blocks an SM, and a shape past
the buffers is refused with a ValueError before any launch, through the
wrapper on meta tensors too.  A NumPy walk of the kernel's schedule (the
rotated samples stored polyphase in padded tile rows with the halo copied
forward, each item's sliding register window over whole chunks of R
(hr, -hi) taps, the two accumulator arrays of each row group and the
groups' partial sums added in order, every output kind) in float32 is
held against `fir_cx_plain` and against the TPU kernels
(`uhsdr_tpu.pallas.fir.fir_decimate_pallas`, interpret mode) over three
streamed blocks, one shorter than the history.  The card checks that the
library computes the same shared memory and that the kernel matches its
plain version (tests/test_torch_cuda.py, chip_smoke.py's K6/K7 phase).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uhsdr_tpu.pallas import fir as pfir
from uhsdr_tpu_torch.chain import filterpaths, rx
from uhsdr_tpu_torch.cuda import fir as fir_k
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.ops import nco

R = fir_k.FRONT_R
# an H100 SM's shared memory (228 KB), what each resident block reserves
# besides its own (1 KB), and the blocks of 4 warps K6/K7 aim to keep
# resident on an SM (K5's aim)
SM_SMEM = 228 * 1024
BLOCK_RESERVED = 1024
BLOCKS_AIM = 3
# the schedule against the plain version and against the TPU kernels
# (both sum the same f32 products in another order)
TOL_DB = 100.0


def _wide_shapes(rate: float) -> set:
    """{(taps, decim)} of every configuration whose front is K6/K7 at
    `rate` (the wide-SSB rows: complex front taps, no stage B; above 48
    kHz the rows without an anti-alias lattice, as `make_params`
    takes them)."""
    shapes = set()
    for mode in ("usb", "lsb", "cw"):
        for fp in filterpaths.paths_for_mode(mode):
            cfg = rx.RxConfig(mode=mode, bw_key=fp.bw_key, path_name=fp.name,
                              iq_rate=rate)
            try:
                rx.check_slice(cfg)
                p = rx.make_params(cfg, "cpu")
            except (NotImplementedError, KeyError, ValueError):
                continue
            if p.front_fir.is_complex():
                assert p.front2 is None
                shapes.add((p.front_fir.shape[-1], cfg.decim))
    return shapes


@pytest.mark.parametrize("rate,want", [
    (48000.0, {(92, 2), (131, 4)}),
    (96000.0, {(245, 4)}),
    (192000.0, {(491, 8)})])
def test_every_wide_shape_fits(rate, want):
    assert _wide_shapes(rate) == want
    for taps, decim in want:
        for size in (2, 4):
            geo = fir_k.fir_cx_geometry(taps, decim, size)
            # no stage-B buffers; three blocks of 4 warps share an SM
            assert geo.ze == 0 and geo.pb == 0
            assert geo.smem <= fir_k.FIR_RT_SMEM_AIM
            assert BLOCKS_AIM * (geo.smem + BLOCK_RESERVED) <= SM_SMEM
            # whole chunks of R; the halo shorter than a tile, so its
            # copy never overlaps its source
            assert geo.t_tile % R == 0 and geo.e % R == 0
            assert geo.ap % R == 0 and geo.e >= -(-taps // decim)
            assert geo.t_tile > geo.e
            # the rows split so that no thread takes a second item where
            # the block has threads to spare
            assert 1 <= geo.p <= decim
            assert geo.p == 1 or geo.p * (geo.t_tile // R) \
                <= fir_k.FRONT_THREADS
            # K5's tiles, with the tap buffer doubled (whole chunks of
            # (hr, -hi) pairs) unless the doubled buffer moved the tile
            k5 = fir_k.fir_rt_geometry(taps, decim, size)
            if geo.t_tile == k5.t_tile:
                assert geo.smem - k5.smem == 4 * decim * geo.ap


@pytest.mark.parametrize("taps,decim,size,want", [
    (245, 4, 2, (1024, 1, 64, 57696)),    # the wide-SSB flagship
    (245, 4, 4, (512, 2, 64, 48464)),
    (491, 8, 2, (512, 2, 64, 71280)),     # 192 kHz
    (131, 4, 2, (1024, 1, 40, 56064)),    # 48 kHz
    (92, 2, 2, (2048, 1, 48, 54960)),
    (1200, 2, 2, (2048, 1, 600, 73728)),  # taps - 1 > 128 x decim
    (245, 16, 2, (256, 4, 16, 66976)),    # decimation 16
    (647, 16, 4, (128, 8, 48, 57216))])   # eight row groups
def test_named_tiles(taps, decim, size, want):
    """The wide flagship's tile (int16): 4096 samples a plane and one row
    group, so each thread writes its outputs straight out; 192 kHz: the
    rows in two groups."""
    geo = fir_k.fir_cx_geometry(taps, decim, size)
    assert (geo.t_tile, geo.p, geo.e, geo.smem) == want


@pytest.mark.parametrize("taps,decim,size", [
    (20000, 2, 2),          # polyphase rows past the shared memory
    (20000, 4, 4),
    (60000, 16, 2),
    (245, 0, 2),            # no decimation
    (245, 4, 8)])           # 8-byte samples
def test_shapes_past_the_buffers_are_refused(taps, decim, size):
    with pytest.raises(ValueError):
        fir_k.fir_cx_geometry(taps, decim, size)


def test_complex_taps_need_more_than_real_ones():
    """Where K5 (real taps) just fits, K6/K7's doubled tap buffer may not:
    the refusal names the shared memory."""
    taps = next(t for t in range(2000, 40000, 50)
                if _fits(fir_k.fir_rt_geometry, t)
                and not _fits(fir_k.fir_cx_geometry, t))
    with pytest.raises(ValueError, match="shared memory"):
        fir_k.fir_cx_geometry(taps, 4, 2)


def _fits(rule, taps) -> bool:
    try:
        rule(taps, 4, 2)
    except ValueError:
        return False
    return True


def test_wrapper_refuses_before_any_launch():
    """`fir_cx` on tensors off the CPU checks the geometry before it
    loads or launches anything: meta tensors stand in for the card's."""
    C, B, taps = 2, 64, 20000
    meta = dict(device="meta")
    h = torch.empty(taps, dtype=torch.complex64, **meta)
    carry = torch.empty((C, taps - 1), dtype=torch.complex64, **meta)
    x = torch.empty((C, B), dtype=torch.int16, **meta)
    with pytest.raises(ValueError, match="shared memory"):
        fir_k.fir_cx(h, carry, x, x, 2)
    phase = torch.empty(C, dtype=torch.int64, **meta)
    with pytest.raises(ValueError, match="shared memory"):
        fir_k.fir_cx(h, carry, x, x, 4, nco=(phase, 7))
    with pytest.raises(ValueError, match="decimation"):
        fir_k.fir_cx(h[:245], carry[:, :244], x, x, 0)
    with pytest.raises(ValueError, match="complex64"):      # real taps
        fir_k.fir_cx(torch.empty(245, **meta), carry[:, :244], x, x, 4)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def _pad(i):
    return i + i // R


def _walk(h, carry, xi, xq, decim, nco_arg, out):
    """K6/K7's schedule on one block in NumPy float32, every channel at
    once: h (taps,) complex64; carry (C, taps-1) complex64 raw history;
    xi, xq (C, B) int16 or f32; nco_arg None or (phase (C,) int64,
    delta); out "real", "complex" or "planes".  The rotated samples are
    the plain version's (the walk holds the schedule, not the rotor).
    Returns (y, new carry, peaks) as `fir_cx_plain`."""
    taps = h.shape[-1]
    C, B = xi.shape
    D, n_hist = decim, taps - 1
    geo = fir_k.fir_cx_geometry(taps, D, xi.element_size())
    E, AP, T, P = geo.e, geo.ap, geo.t_tile, geo.p
    a, b = fir_k.scale_planes(xi, xq)
    peaks = torch.maximum(a.abs().amax(-1), b.abs().amax(-1)).numpy()
    z, zh = torch.complex(a, b), carry
    if nco_arg is not None:
        ph, delta = nco_arg
        z = z * nco.rotor(nco.phase_ramp(ph, delta, B))
        zh = carry * nco.rotor(nco.phase_ramp(ph, delta, n_hist,
                                              start=-n_hist))
    z, zh = z.numpy(), zh.numpy()
    # the taps, polyphase: row b holds h[D a + b], zero past the row, as
    # (hr, -hi) pairs
    hr = np.zeros((D, AP), np.float32)
    hn = np.zeros((D, AP), np.float32)
    for bb in range(D):
        src = D * np.arange(AP) + bb
        ok = src < taps
        hr[bb, ok] = h.real.numpy()[src[ok]]
        hn[bb, ok] = -h.imag.numpy()[src[ok]]
    # the tile rows (D, RS) of each plane, NaN where nothing was stored
    RS = _pad(E + T) + 1
    xr = np.full((2, C, D, RS), np.nan, np.float32)
    for r in range(D):
        for col in range(E + 1):
            n = (col - E - (r > 0)) * D + r
            v = zh[:, n + n_hist] if -n_hist <= n < 0 else 0.0
            xr[0, :, r, _pad(col)] = np.real(v)
            xr[1, :, r, _pad(col)] = np.imag(v)
    T_out = B // D
    y = np.full((2, C, T_out), np.nan, np.float32)
    nob = T // R
    for t0 in range(0, T_out, T):
        tv = min(T, T_out - t0)
        # the load: sample l of the tile in row l % D, column E + l // D
        # (+1 in rows > 0)
        ll = np.arange(tv * D)
        rows = ll % D
        cols = np.array([_pad(c) for c in E + ll // D + (rows > 0)])
        xr[0][:, rows, cols] = np.real(z[:, t0 * D:(t0 + tv) * D])
        xr[1][:, rows, cols] = np.imag(z[:, t0 * D:(t0 + tv) * D])
        obs = np.arange(-(-tv // R))          # the items with an output
        part = np.zeros((P, 2, C, len(obs), R), np.float32)
        for pg in range(P):
            acc_r = np.zeros((C, len(obs), R), np.float32)
            acc_i = np.zeros((C, len(obs), R), np.float32)
            for bb in range(pg * D // P, (pg + 1) * D // P):
                row = 0 if bb == 0 else D - bb
                base = (R + 1) * (E // R + obs)
                wr = xr[0][:, row][:, base[:, None] + np.arange(R)]
                wi = xr[1][:, row][:, base[:, None] + np.arange(R)]
                for a0 in range(0, AP, R):
                    for i in range(R):
                        k_r, k_n = hr[bb, a0 + i], hn[bb, a0 + i]
                        slots = (np.arange(R) - i) % R
                        vr, vi = wr[..., slots], wi[..., slots]
                        if out == "real":
                            acc_r = acc_r + k_r * vr
                            acc_i = acc_i + k_n * vi
                        else:
                            acc_r = acc_r + k_r * vr
                            acc_r = acc_r + k_n * vi
                            acc_i = acc_i + k_r * vi
                            acc_i = acc_i - k_n * vr
                        if i < R - 1 or a0 + R < AP:
                            s = (R - 1 - i) % R
                            wr[..., s] = xr[0][:, row][:, base - i - 2]
                            wi[..., s] = xr[1][:, row][:, base - i - 2]
                    base = base - (R + 1)
            part[pg, 0], part[pg, 1] = acc_r, acc_i
        zs = part[0].copy()
        for pg in range(1, P):                 # the groups, in order
            zs = zs + part[pg]
        zs = zs.reshape(2, C, -1)[:, :, :tv]
        y[:, :, t0:t0 + tv] = zs
        if out == "real":
            y[0, :, t0:t0 + tv] = zs[0] + zs[1]
        if t0 + T < T_out:                     # the halo, copied forward
            for col in range(E + 1):
                xr[:, :, :, _pad(col)] = xr[:, :, :, _pad(T + col)]
    new_carry = np.concatenate([carry.numpy(), torch.complex(a, b).numpy()],
                               axis=-1)[:, B:]
    if out == "real":
        yo = y[0]
    elif out == "planes":
        yo = (y[0], y[1])
    else:
        yo = y[0] + 1j * y[1]
    return yo, new_carry, peaks


def _stream(rng, C, B, dtype):
    x = [np.clip(np.round(rng.standard_normal((C, B)) * 3277.0), -32768,
                 32767).astype(np.int16) for _ in "iq"]
    x[0][0] = np.clip(x[0][0].astype(np.int32) * 8, -32768, 32767)
    t = [torch.from_numpy(v) for v in x]
    if dtype == "float32":
        t = [v.to(torch.float32) / 32768.0 for v in t]
    return t


def _as_complex(y):
    return y[0] + 1j * y[1] if isinstance(y, tuple) else y


@pytest.mark.parametrize("taps,decim,dtype,use_nco,out,lengths", [
    # the wide flagship's shape: two tiles (one ragged), then a block
    # shorter than the history
    (245, 4, "int16", True, "real", (4200, 100, 4096)),
    (245, 4, "float32", False, "complex", (2048, 60, 2100)),  # two groups
    (491, 8, "int16", True, "real", (8200, 240, 4096)),       # 192 kHz
    (491, 8, "int16", False, "planes", (4104, 48, 1032)),
    (92, 2, "float32", True, "real", (4100, 50, 2000)),       # 48 kHz
    (131, 4, "int16", False, "complex", (4100, 64, 1024)),
    (647, 16, "int16", True, "real", (4112, 320, 2048))])     # decim 16
def test_schedule_is_the_plain_version(taps, decim, dtype, use_nco, out,
                                       lengths):
    rng = np.random.default_rng(taps + decim)
    C = 3
    h = torch.from_numpy(((rng.standard_normal(taps)
                           + 1j * rng.standard_normal(taps)) * 0.05)
                         .astype(np.complex64))
    delta = int(nco.freq_to_delta(-12000.0, 96000.0))
    ph = torch.from_numpy(rng.integers(0, 2**32, C))
    cw = cp = torch.zeros((C, taps - 1), dtype=torch.complex64)
    worst = np.inf
    for B in lengths:
        assert B % decim == 0
        xi, xq = _stream(rng, C, B, dtype)
        nco_arg = (ph, delta) if use_nco else None
        yw, cw_new, pw = _walk(h, cw, xi, xq, decim, nco_arg, out)
        yp, cp, pp = fir_k.fir_cx_plain(h, cp, xi, xq, decim, nco=nco_arg,
                                        real_out=out == "real",
                                        planes_out=out == "planes")
        worst = min(worst, snr_db(_as_complex(yp), _as_complex(yw)))
        assert worst >= TOL_DB, worst
        np.testing.assert_array_equal(cw_new, cp.numpy())
        np.testing.assert_array_equal(pw, pp.numpy())
        cw = torch.from_numpy(cw_new)
        ph = nco.advance(ph, delta, B)
    print(f"\n{taps} taps, decim {decim}, {dtype}, nco {use_nco}, {out}: "
          f"{worst:.1f} dB against fir_cx_plain")


@pytest.mark.parametrize("out", ["real", "complex"])
def test_schedule_is_the_tpu_kernel(out):
    """The walk over three streamed blocks, the middle one shorter than
    the history, against the TPU kernels (K7, the NCO fused) run in
    interpret mode over the same samples as one block: the Pallas kernel
    takes no block shorter than its halo (a multiple of 128 samples at
    least taps - 1 long)."""
    taps, decim, C = 131, 4, 8
    rng = np.random.default_rng(31)
    p = rx.make_params(rx.RxConfig(mode="usb", bw_key="4P0KHZ",
                                   path_name="LPF", iq_rate=48000.0), "cpu")
    h = p.front_fir
    assert h.shape == (taps,) and h.is_complex()
    delta = int(nco.freq_to_delta(-6000.0, 48000.0))
    phase0 = 2**32 - 7000
    lengths = (1024, 64, 960)
    blocks = [_stream(rng, C, B, "int16") for B in lengths]
    cw = torch.zeros((C, taps - 1), dtype=torch.complex64)
    ph = torch.full((C,), phase0, dtype=torch.int64)
    ys = []
    for xi, xq in blocks:
        yw, cw, _ = _walk(h, cw, xi, xq, decim, (ph, delta), out)
        cw = torch.from_numpy(cw)
        ph = nco.advance(ph, delta, xi.shape[-1])
        ys.append(yw)
    xi = np.concatenate([b[0].numpy() for b in blocks], -1)
    xq = np.concatenate([b[1].numpy() for b in blocks], -1)
    yj, cj = pfir.fir_decimate_pallas(
        h.numpy(), jnp.zeros((C, taps - 1), jnp.complex64),
        (jnp.asarray(xi), jnp.asarray(xq)), decim, tile_c=8, tile_t=64,
        real_out=out == "real", interpret=True,
        nco=(jnp.uint32(phase0), jnp.uint32(delta)))
    s_y = snr_db(np.asarray(yj), np.concatenate(ys, -1))
    s_c = snr_db(_as_complex(tuple(np.asarray(v) for v in cj))
                 if isinstance(cj, tuple) else np.asarray(cj), cw)
    print(f"\n{out} out: walk against the TPU kernel {s_y:.1f} dB, raw "
          f"carry {s_c:.1f} dB")
    assert min(s_y, s_c) >= TOL_DB
