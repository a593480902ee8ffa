#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`uhsdr_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 1234]      # on cuda:0

What it does, in order, failing (non-zero exit, no result line) at the
first phase that fails:

1. prints the card's name and power limit (nvidia-smi);
2. builds every hand-written kernel from the sources in
   `uhsdr_tpu_torch/kernels/` (one nvcc per source, started together) and
   prints the build time and each kernel's register/shared-memory report;
3. one phase per kernel: K1 (the fused SSB front; also 64 channels of
   f32 @ 48 kHz and of int16 @ 192 kHz), K3 (the AGC, at the
   SSB look-ahead of 48, the AM/SAM look-ahead of 96 and FM's 192, and at
   the fleet's FM group, 1024 x 16384 at w 192; its shared memory held to
   `agc_geometry`'s), K4
   (the interpolator: x8, x4, ssbstereo's 2C rows and the 48 kHz x2,
   channels 0-7 alone bit-equal to the batch), K5 (the real-tap AM/SAM
   front; also 64
   channels of int16 @ 192 kHz at decimation 16, the FM front at
   decimation 2 and 64 channels of the fleet's f32 FM front @ 48 kHz at
   decimation 1), K10 and K9 (the SAM PLL), K11 (the biquad
   cascade), K7 and K6 (the complex-tap wide-SSB front with and without
   the NCO, its output at 100 dB, its history and peaks bit-equal, its
   shared memory held to `fir_cx_geometry`'s; K7 also at 192 kHz, 491
   taps at decimation 8), K12 (the FM discriminator), K13 (the linked
   stereo AGC's machine), K1 with the two-channel modes' two stage-B filters
   (`front_pair`), K8 (the TX analytic FIR, NCO and conjugation on and
   off, its output at 100 dB and its history bit-equal, its shared
   memory held to `fir_real_geometry`'s), the fused TX ALC stage (its
   fast division first held to div.rn over every non-negative f32 it is
   used on, one launch; then y, alc_val and the new delay line at D = 288
   and at AM's gain scaling with D > T, channels 0-7 alone bit-equal to
   the batch; timed beside PR 13's four torch passes), K2 (the
   fused blocked SOS cascade, at the SSB PreFilter's shape, channels 0-7
   alone bit-equal to the batch, its shared memory held to
   `blocked_geometry`'s; two streamed blocks and the times at every
   other path's cascade shape and the fleet's two), K14
   (the grouped biquad scan, at SAM's stacked allpass shape, also held
   against K11), K15 (the modulated-taps SSB front), and the row variants
   of K3 (per-channel [min_volts, slope, hang_level], at the fleet's
   merged AGC shape 5120 x 4096) and K13 (per-channel [min_volts,
   hang_level], at 8192 x 2048).  Each streams 2-3
   blocks at its main path's shapes (8192 channels; K11 and K14 at the
   16384 stacked channels SAM gives them; the ALC's plain loop at 4096
   samples), the middle block ragged where the kernel has a tile or a
   history to be ragged against,
   through the kernel and through its plain torch version on the card,
   from the same seeded inputs with carries handed on.  FIR and cascade
   outputs and carries are held to SNR >= 90 dB, the PLL's cos/sin/audio
   and carries to max |err| <= 2e-5, the discriminator's angles to max
   |err| <= 2e-6 modulo 2 pi; K3, K13 and the ALC must be bit-exact.  It
   then times the kernel, the plain version and, where one PyTorch call
   computes the same function, that call (`library_ms`, never used by the
   port);
4. the main paths: `RxChain` on the card at 8192 ch x 16384 int16 samples
   @ 96 kHz, state carried, timed with CUDA events after 2 warm-up
   and over 8 timed blocks: the flagship SSB config, the AM/SAM
   flagship as AM, SAM both sidebands and SAM USB, the FM flagship, the
   wide-SSB flagship, the two-channel flagship (ssbstereo) and the SSB
   flagship with UHSDR_FRONT_MT=1 set around it alone (`ssb_mt`: K15 in
   place of K1); then, at 1024 channels and 4 timed blocks, the wide-SSB
   flagship untranslated (K6), the FM flagship with squelch and subtone
   detection, iq on the flagship's row and SAM stereo.  Then `TxChain` at
   the TX flagship (usb, 8192 ch x 16384 f32 audio @ 48 kHz, 8 timed
   blocks) and at 1024 channels lsb, am, cw and the legacy-front lsb.
   Then the entry path `biquad_grouped`: SAM usb's stacked allpass inputs
   (16384 x 4096, both coefficient sets) through `biquad_cascade(impl=
   "grouped")`, 4 timed blocks, state carried.  Then the mixed-mode fleet
   (`parallel.fleet.ChannelFleet`, six groups of 1024 channels: usb, lsb,
   cw, am, sam, fm at 48 kHz, 16384-sample f32 blocks, AGC thresholds
   60/50/70/60/55/60 dB) twice over the same blocks: `fleet`, the
   stage-batched step (one K3 launch with (3, 5120) rows for the five
   12 kHz groups), and `fleet_separate`, each group's chain; 2 + 6
   blocks each.  The two must agree bit for bit (a fresh pair, in
   lockstep, outside the timed runs), channels 0-7 of each group must
   match the port's CPU fleet over the first 2 blocks at 80 dB, and
   each group's channel 0 tone must come out.  Then `wideband`
   (`WidebandFleet`: 16.8 M wideband samples a block through the
   4096-channel analysis bank into usb on 2730 channels and am on 1366;
   channels 0-7 of each group's bank output through the port's CPU
   fleet over the first 2 blocks, audio and every state leaf at 80 dB;
   the bank held to the direct mix-filter-decimate form on 8 channels
   at 80 dB), `wideband_tx` (`WidebandTxFleet`: 4096 TX-flagship
   channels of 4096 samples through the synthesis bank; channels 0-7 of
   the chains' IQ before the bank and their state against the port's
   CPU `TxChain` over the first 2 blocks at 80 dB; channels 0 and 4095
   must land at their centre plus translate and tone) and the
   entry path `agc_stereo_rows` (`ops.agc.run_stereo` at 12 kHz on
   8192 x 2 x 2048 with a threshold per channel: K13's rows; channels
   0-7 against the CPU at 90 dB).  Every kernel's launch
   count is set to 0 just before each path and read just after, each
   kernel of that path must have been launched and no other, and every
   built kernel must have been launched by a chain path or the entry
   path.  Output and state must be
   finite, channels 0-7 must match the port's CPU chain (plain versions)
   over the first 3 blocks at SNR >= 80 dB on the output and on every
   state leaf (boolean and integer leaves equal), and channel 0's test
   tone must come out of the last block where it belongs (RX: 700 Hz,
   FM 1 kHz; TX: above or below the translate frequency, the AM and CW
   carriers);
5. prints one `{"kernels": [...]}` line and, last, the `{"ok": true, ...}`
   device line.

Exits non-zero without a result where CUDA is absent, and in a directory
that does not hold the `uhsdr_tpu_torch` package.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from uhsdr_tpu_torch import trace_blocked, trace_rx, trace_tx
from uhsdr_tpu_torch.chain import filterpaths, rx, tx
from uhsdr_tpu_torch.cuda import agc as agc_k
from uhsdr_tpu_torch.cuda import alc as alc_k
from uhsdr_tpu_torch.cuda import build
from uhsdr_tpu_torch.cuda import elemwise as ew_k
from uhsdr_tpu_torch.cuda import fir as fir_k
from uhsdr_tpu_torch.cuda import iir as iir_k
from uhsdr_tpu_torch.cuda import pll as pll_k
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.ops import agc as agc_ops
from uhsdr_tpu_torch.ops import channelizer as chz
from uhsdr_tpu_torch.ops import fir as fir_ops
from uhsdr_tpu_torch.ops import nco
from uhsdr_tpu_torch.parallel import fleet as pfleet

CFG = rx.FLAGSHIP            # the SSB flagship
SAM = rx.SAM_FLAGSHIP        # the AM/SAM flagship
FM = rx.FM_FLAGSHIP          # the FM flagship
WIDE = rx.WIDE_FLAGSHIP      # the wide-SSB flagship
STEREO = rx.STEREO_FLAGSHIP  # the two-channel flagship
TXF = tx.TX_FLAGSHIP         # the TX flagship
CHANNELS = rx.FLAGSHIP_CHANNELS

# The mixed-mode fleet (BASELINE config 5, `pfleet.FLEET_MIX`): six groups
# of 1024 channels at 48 kHz, 16384-sample f32 blocks.  The five 12 kHz
# groups share one K3 launch with (3, 5120) rows and one K4 launch; FM
# keeps its own K3 at 48 kHz.
FLEET_GROUP_CHANNELS = pfleet.FLEET_GROUP_CHANNELS
FLEET_BLOCK = pfleet.FLEET_MIX[0].block_len
# The wideband deployment (`pfleet.WIDEBAND_MIX`): M = 4096 channels of
# 4096 samples behind one analysis bank; its TX mirror, `WIDEBAND_TX`.
WB_M, WB_T = pfleet.WIDEBAND_CHANNELS, pfleet.WIDEBAND_MIX[0].block_len
# The entry path of K13's rows: the linked stereo AGC at 12 kHz with a
# threshold per channel (no chain of the reference gives run_stereo
# per-channel settings).
STEREO_ROWS_T = 2048
STEREO_ROWS_THRESH = np.linspace(40.0, 80.0, CHANNELS)

# H100 SXM published peaks (NVIDIA data sheet): HBM rate, FP32 outside the
# tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

# The floor of a recurrence kernel is not its bytes: a channel's T steps
# are a chain of dependent f32 operations, each at least FP32_LATENCY
# cycles.  Hand counts of the loop-carried chain per step, at source level:
# K3 and K13 (kernels/agc.cu::machine_step, in select form), volts to the
# next volts: the compare volts > pop_ratio * fba (rm >= volts
# and volts > save beside it), the fast predicate, two selects of the
# multiplier, the update multiply and add (rm - volts beside the compares),
# the min-volts max.
AGC_STEP_OPS = 7
# the blended step's count (pallas/agc.py:84-118's form), printed beside:
# the compare, its select, 1 - att, nine mask products and differences,
# three sums into keff, the update multiply and add, the min-volts max
AGC_STEP_OPS_BLENDED = 18
# K9/K10 (kernels/pll.cu): the loop phs -> sincosf (range reduction and
# polynomial, ~11 deep) -> mix (2) -> atan2f (division, polynomial and
# quadrant fix-up, ~22) -> loop filter (5) -> phase add and mod (8) is 48
# operations long and spans two steps (fil_out is applied one sample
# late), so 24 a step.
PLL_STEP_OPS = 24
# K11 (kernels/biquad.cu): a section's state to its next state: the output
# add, a1*y, the subtraction, the s2 add; sections overlap across samples.
BIQUAD_STEP_OPS = 4
# the ALC (kernels/alc.cu), alc_val to the next: the walker's SASS chain,
# cuda/alc.py::ALC_STEP_CHAIN
ALC_STEP_OPS = alc_k.ALC_STEP_CHAIN
FP32_LATENCY = 4

KERNEL_TOL_DB = 90.0
# K8 against its plain version (tests/test_torch_cuda.py's FIR_DB): both
# sum the same f32 products, in another order
FIR_TOL_DB = 100.0
# the JAX package's tests hold the TPU PLL kernels to 3e-4 against the XLA
# scan; these kernels repeat their plain versions' arithmetic and have read
# 0 on this card, so they are held to a few ulp of a unit-scale value
PLL_TOL_ABS = 2e-5
# the JAX package's test holds its polynomial discriminator to 2e-6
# against arctan2 (tests/test_pallas_fir.py:164-188); angles compared
# modulo 2 pi (one side of the branch cut may read +pi, the other -pi)
DISC_TOL_ABS = 2e-6
CHAIN_TOL_DB = 80.0


def max_abs(ref: torch.Tensor, got: torch.Tensor) -> float:
    return float((ref.to(torch.complex128 if ref.is_complex()
                          else torch.float64)
                  - got).abs().max())


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, by CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time (ms) for the work at the card's published peaks."""
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_o = flops / PEAK_FP32_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


class Failed(RuntimeError):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise Failed(msg)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def sm_clock_hz() -> float:
    """The card's maximum SM clock, e.g. '1980 MHz'."""
    mhz, unit = smi("clocks.max.sm").split()
    check(unit == "MHz", f"clocks.max.sm in {unit}")
    return float(mhz) * 1e6


def recurrence_ms(steps: int, ops: int) -> float:
    return steps * ops * FP32_LATENCY / sm_clock_hz() * 1e3


def held(name: str, pairs: dict,
         tol_abs: float | None = None) -> tuple[float, float]:
    """Print and check each (ref, got) pair: SNR >= KERNEL_TOL_DB, or with
    tol_abs max |err| <= tol_abs.  Returns (min SNR, max abs err)."""
    worst, err = math.inf, 0.0
    for what, (ref, got) in pairs.items():
        s, e = snr_db(ref, got), max_abs(ref, got)
        worst, err = min(worst, s), max(err, e)
        print(f"  {name} {what}: SNR {s:.1f} dB, max|err| {e:.3e}")
        if tol_abs is None:
            check(s >= KERNEL_TOL_DB and math.isfinite(e),
                  f"{name} {what}: SNR {s:.1f} dB < {KERNEL_TOL_DB} dB")
        else:
            check(e <= tol_abs, f"{name} {what}: max|err| {e:.3e} > "
                                f"{tol_abs:.1e}")
    return worst, err


def row(name, source, replaces, *, err, snr, ms, plain_ms, nbytes, flops,
        library_ms=None, library_note, **extra) -> dict:
    """One entry of the kernels line; `launches` is filled in after the
    main paths ran.  `library_note` names the one PyTorch call timed as
    `library_ms`, or says why there is none."""
    b_ms, b_by = bound(nbytes, flops)
    return dict(name=name, route="cuda",
                source=f"uhsdr_tpu_torch/kernels/{source}",
                replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                library_note=library_note,
                snr_db=snr if math.isfinite(snr) else None, ok=True, **extra)


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def iq_block(gen, dev, C, B, std=3277.0):
    """Seeded int16 IQ noise planes (std ~ -20 dBFS)."""
    def plane():
        x = torch.randn((C, B), generator=gen, device=dev) * std
        return x.round().clamp(-32768, 32767).to(torch.int16)
    return plane(), plane()


def front_stream(h, g, n_keep, delta, decim, C, lengths, dtype, dev, gen,
                 label):
    """K1 against its plain version over streamed blocks of `lengths`
    samples from zero carries and seeded NCO phases.  Returns (min SNR,
    max abs err, the first block's inputs)."""
    ck = cp = torch.zeros((C, n_keep), dtype=torch.complex64, device=dev)
    c2k = c2p = torch.zeros((C, g.shape[-1] - 1), dtype=torch.complex64,
                            device=dev)
    phase = torch.randint(0, 2**32, (C,), generator=gen, device=dev)
    worst, err, first = math.inf, 0.0, None
    for blk, Bk in enumerate(lengths):
        xi, xq = iq_block(gen, dev, C, Bk)
        if dtype == torch.float32:
            xi, xq = xi.to(dtype) / 32768.0, xq.to(dtype) / 32768.0
        if first is None:
            first = (ck, c2k, xi, xq, phase)
        yk, ck, c2k, pk_k = fir_k.front(h, g, ck, c2k, xi, xq, phase, delta,
                                        decim)
        yp, cp, c2p, pk_p = fir_k.front_plain(h, g, cp, c2p, xi, xq, phase,
                                              delta, decim)
        torch.cuda.synchronize()
        check(yk.shape == yp.shape, f"{label} output {tuple(yk.shape)}")
        s, e = held(f"{label} block {blk} ({Bk} samples)", {
            "audio": (yp, yk), "raw carry": (cp, ck),
            "front2 carry": (c2p, c2k), "peaks": (pk_p, pk_k)})
        worst, err = min(worst, s), max(err, e)
        phase = nco.advance(phase, delta, Bk)
    return worst, err, first


def phase_front(P, dev, gen):
    """K1 at the SSB flagship's shape (8192 ch, int16 @ 96 kHz, decim 8,
    227 + 199 taps): three streamed blocks, the middle one of 9000
    samples (two whole tiles and a ragged one); then 64 channels of each
    other shape K1 serves: f32 planes at 48 kHz (decim 4, 83 taps, the
    fleet's and `wideband`'s) and int16 at 192 kHz (decim 16, 455 taps),
    each with a ragged middle block.  K1's shared-memory rule in the
    library and in cuda/fir.py must agree at every shape the port sends
    it."""
    lib = fir_k.FRONT.lib()
    for rate in (48000.0, 96000.0, 192000.0):
        for mode in ("usb", "ssbstereo"):
            cfg = dataclasses.replace(CFG, iq_rate=rate, mode=mode)
            p = rx.make_params(cfg, "cpu")
            taps, taps2 = p.front_fir.shape[-1], p.front2.shape[-1]
            nb = 1 if p.front2.ndim == 1 else 2
            for size in (2, 4):
                want = fir_k.front_geometry(taps, taps2, cfg.decim, nb,
                                            size).smem
                got = lib.uhsdr_front_smem(taps, taps2, cfg.decim, nb, size)
                check(got == want, f"K1 shared memory at {rate:.0f} Hz, "
                                   f"nb {nb}, {size}-byte samples: library "
                                   f"{got}, cuda/fir.py {want}")
    params = P["ssb"]
    C, B, decim = CHANNELS, CFG.block_len, CFG.decim
    h, g, delta = params.front_fir, params.front2, params.nco_delta
    taps, taps2 = h.shape[-1], g.shape[-1]
    worst, err, first = front_stream(h, g, taps - 1, delta, decim, C,
                                     (B, 9000, B), torch.int16, dev, gen,
                                     "K1")
    for rate, dtype, mid in ((48000.0, torch.float32, 6000),
                             (192000.0, torch.int16, 5008)):
        cfg = dataclasses.replace(CFG, iq_rate=rate)
        p = rx.make_params(cfg, dev)
        s, e, _ = front_stream(
            p.front_fir, p.front2, p.front_fir.shape[-1] - 1, p.nco_delta,
            cfg.decim, 64, (B, mid, B), dtype, dev, gen,
            f"K1 {rate / 1000:.0f} kHz {str(dtype)[6:]} decim {cfg.decim}")
        worst, err = min(worst, s), max(err, e)
    ck0, c2k0, xi, xq, ph0 = first
    ms = cuda_ms(lambda: fir_k.front(h, g, ck0, c2k0, xi, xq, ph0, delta,
                                     decim), 10)
    plain_ms = cuda_ms(lambda: fir_k.front_plain(h, g, ck0, c2k0, xi, xq, ph0,
                                                 delta, decim), 2)
    # work: stage A, 2 planes x taps FMAs per output; stage B, complex taps
    # with real output, 2 FMAs per tap per output
    T_out = B // decim
    fma = C * T_out * (2 * taps + 2 * taps2)
    # bytes: int16 planes in, audio out, both carries in and out, phase in,
    # peaks out, taps in
    nbytes = (2 * C * B * 2 + C * T_out * 4 + 2 * C * (taps - 1) * 8
              + 2 * C * (taps2 - 1) * 8 + C * 8 + C * 4
              + 4 * (taps + 2 * taps2))
    r = row("front", "front.cu", "uhsdr_tpu/pallas/fir.py:179", err=err,
            snr=worst, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=2.0 * fma,
            library_note="no one PyTorch call mixes, decimates and runs "
                         "both FIR stages")
    print(f"  K1 front: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']}: {fma / 1e9:.2f} G "
          f"FMA, {nbytes / 2**20:.0f} MiB)")
    return r


def premixed_stack(carry, xi, xq, nco_arg):
    """(C, 2, taps-1+B) f32: the raw history and block of a front's input,
    rotated by the NCO where `nco_arg` is given, as a convolution's two
    input channels (real, imaginary)."""
    a, b = fir_k.scale_planes(xi, xq)
    z = torch.complex(a, b)
    n_hist = carry.shape[-1]
    if nco_arg is not None:
        phase, delta = nco_arg
        z = z * nco.rotor(nco.phase_ramp(phase, delta, z.shape[-1]))
        carry = carry * nco.rotor(nco.phase_ramp(phase, delta, n_hist,
                                                 start=-n_hist))
    zf = torch.cat([carry, z], dim=-1)
    return torch.stack([zf.real, zf.imag], dim=1).contiguous()


def premixed_planes(carry, xi, xq, phase, delta):
    """(2C, 1, taps-1+B) f32: K5's mixed input, I planes then Q planes, as
    a one-channel convolution's input."""
    st = premixed_stack(carry, xi, xq, (phase, delta))
    return st.transpose(0, 1).reshape(-1, 1, st.shape[-1]).contiguous()


def fir_rt_stream(h, delta, decim, C, lengths, dtype, dev, gen, label):
    """K5 (NCO on, complex out) against its plain version over streamed
    blocks of `lengths` samples from a zero carry and seeded NCO phases.
    Returns (min SNR, max abs err, the first block's inputs)."""
    taps = h.shape[-1]
    ck = cp = torch.zeros((C, taps - 1), dtype=torch.complex64, device=dev)
    phase = torch.randint(0, 2**32, (C,), generator=gen, device=dev)
    worst, err, first = math.inf, 0.0, None
    for blk, Bk in enumerate(lengths):
        xi, xq = iq_block(gen, dev, C, Bk)
        if dtype == torch.float32:
            xi, xq = xi.to(dtype) / 32768.0, xq.to(dtype) / 32768.0
        if first is None:
            first = (ck, xi, xq, phase)
        yk, ck, pk_k = fir_k.fir_rt(h, ck, xi, xq, decim, nco=(phase, delta))
        yp, cp, pk_p = fir_k.fir_rt_plain(h, cp, xi, xq, decim,
                                          nco=(phase, delta))
        torch.cuda.synchronize()
        check(tuple(yk.shape) == (C, Bk // decim) and yk.is_complex(),
              f"{label} output {tuple(yk.shape)} {yk.dtype}")
        s, e = held(f"{label} block {blk} ({Bk} samples)", {
            "iq": (yp, yk), "raw carry": (cp, ck), "peaks": (pk_p, pk_k)})
        worst, err = min(worst, s), max(err, e)
        phase = nco.advance(phase, delta, Bk)
    return worst, err, first


def k5_shapes() -> set:
    """{(taps, decim)} of every AM, SAM and FM row at 48, 96 and 192 kHz:
    the shapes the port sends K5."""
    shapes = set()
    for rate in (48000.0, 96000.0, 192000.0):
        for mode in ("am", "sam", "fm"):
            for fp in filterpaths.paths_for_mode(mode):
                cfg = rx.RxConfig(mode=mode, bw_key=fp.bw_key,
                                  path_name=fp.name, iq_rate=rate)
                taps = rx._rate_adapt_front(rx._front_design(cfg)[0],
                                            cfg.rate_mult, rate).shape[-1]
                shapes.add((taps, cfg.decim))
    return shapes


def phase_fir_rt(P, dev, gen):
    """K5 at the AM/SAM flagship's shape (8192 ch, int16 @ 96 kHz, decim
    4, 239 taps): three streamed blocks, the middle one shorter than the
    history; 64 channels of int16 at 192 kHz on a narrow row (decim 16,
    479 taps) with a ragged middle block; the options off the SAM path
    (f32 planes, no NCO, planes and real out); then the FM shapes
    (`fm_front_case`).  K5's shared-memory rule in the library and in
    cuda/fir.py must agree at every shape the port sends it."""
    lib = fir_k.FRONT.lib()
    for taps, decim in sorted(k5_shapes()):
        for size in (2, 4):
            want = fir_k.fir_rt_geometry(taps, decim, size).smem
            got = lib.uhsdr_front_smem(taps, 1, decim, 0, size)
            check(got == want, f"K5 shared memory at {taps} taps, decim "
                               f"{decim}, {size}-byte samples: library "
                               f"{got}, cuda/fir.py {want}")
    params = P["sam"]
    C, B, decim = CHANNELS, SAM.block_len, SAM.decim
    h = params.front_fir
    taps = h.shape[-1]
    delta = params.nco_delta
    short = decim * ((taps - 1) // (2 * decim))   # shorter than the history
    worst, err, first = fir_rt_stream(h, delta, decim, C, (B, short, B),
                                      torch.int16, dev, gen, "K5")
    cfg = dataclasses.replace(SAM, bw_key="2P3KHZ", iq_rate=192000.0)
    p = rx.make_params(cfg, dev)
    s, e, _ = fir_rt_stream(
        p.front_fir, p.nco_delta, cfg.decim, 64, (B, 5008, B), torch.int16,
        dev, gen, f"K5 192 kHz int16 decim {cfg.decim} "
                  f"({p.front_fir.shape[-1]} taps)")
    worst, err = min(worst, s), max(err, e)
    # the options off the SAM path: f32 planes, no NCO, planes and real out
    n = 1024
    xf = [v.to(torch.float32) / 32768.0 for v in iq_block(gen, dev, n, B)]
    c1 = 0.1 * torch.randn((n, taps - 1), generator=gen, device=dev,
                           dtype=torch.complex64)
    (ar, ai), cn, pk_k = fir_k.fir_rt(h, c1, *xf, decim, planes_out=True)
    yr, _, _ = fir_k.fir_rt(h, c1, *xf, decim, real_out=True)
    yp, cp1, pk_p = fir_k.fir_rt_plain(h, c1, *xf, decim)
    torch.cuda.synchronize()
    s, e = held("K5 f32 planes, no NCO", {
        "real plane": (yp.real, ar), "imag plane": (yp.imag, ai),
        "real_out": (yp.real, yr), "raw carry": (cp1, cn),
        "peaks": (pk_p, pk_k)})
    worst, err = min(worst, s), max(err, e)

    c0, xi, xq, ph0 = first
    ms = cuda_ms(lambda: fir_k.fir_rt(h, c0, xi, xq, decim,
                                      nco=(ph0, delta)), 10)
    plain_ms = cuda_ms(lambda: fir_k.fir_rt_plain(h, c0, xi, xq, decim,
                                                  nco=(ph0, delta)), 2)
    # one PyTorch call for the FIR itself, on planes mixed beforehand
    planes = premixed_planes(c0, xi, xq, ph0, delta)
    w = h.flip(0).reshape(1, 1, taps)

    def library():
        return torch.nn.functional.conv1d(planes, w, stride=decim)

    lib_ms = cuda_ms(library, 5)
    y_lib = library()[:, 0]
    y_pl = fir_k.fir_rt_plain(h, c0, xi, xq, decim, nco=(ph0, delta))[0]
    s_lib = snr_db(y_pl, torch.complex(y_lib[:C], y_lib[C:]))
    print(f"  K5 library call (conv1d, stride {decim}, planes mixed "
          f"beforehand) vs plain: SNR {s_lib:.1f} dB")
    del planes, y_lib, y_pl
    decim2, s, e = fm_front_case(P, dev, gen)
    worst, err = min(worst, s), max(err, e)
    T_out = B // decim
    fma = C * T_out * 2 * taps
    # bytes: int16 planes in, complex out, carry in and out, phase in,
    # peaks out, taps in
    nbytes = (2 * C * B * 2 + C * T_out * 8 + 2 * C * (taps - 1) * 8
              + C * 8 + C * 4 + 4 * taps)
    r = row("fir_rt", "front.cu", "uhsdr_tpu/pallas/fir.py:82", err=err,
            snr=worst, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=2.0 * fma, library_ms=lib_ms,
            library_note="conv1d with stride on planes mixed beforehand "
                         "(the FIR alone)", decim2=decim2)
    print(f"  K5 fir_rt: {ms:.4f} ms (plain {plain_ms:.3f} ms, library "
          f"{lib_ms:.3f} ms, bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']}: {fma / 1e9:.2f} G FMA, "
          f"{nbytes / 2**20:.0f} MiB)")
    return r


def fm_front_case(P, dev, gen) -> tuple:
    """K5 at the FM flagship's front: 239 taps at decimation 2, complex
    out, NCO; two streamed blocks (the second ragged) against the plain
    version, then timed; then 64 channels of the fleet's FM front (f32
    planes at 48 kHz, 89 taps, decimation 1) with a ragged middle block.
    Returns (the timing dict, min SNR, max abs err)."""
    params = P["fm"]
    C, B, decim = CHANNELS, FM.block_len, FM.decim
    h, delta = params.front_fir, params.nco_delta
    taps = h.shape[-1]
    worst, err, first = fir_rt_stream(
        h, delta, decim, C, (B, 1000), torch.int16, dev, gen,
        f"K5 FM front ({taps} taps, decim {decim})")
    cfg = dataclasses.replace(FM, iq_rate=48000.0)
    p = rx.make_params(cfg, dev)
    s, e, _ = fir_rt_stream(
        p.front_fir, p.nco_delta, cfg.decim, 64, (B, 6001, B),
        torch.float32, dev, gen, f"K5 48 kHz f32 decim {cfg.decim} "
                                 f"({p.front_fir.shape[-1]} taps)")
    worst, err = min(worst, s), max(err, e)
    c0, xi, xq, ph0 = first
    ms = cuda_ms(lambda: fir_k.fir_rt(h, c0, xi, xq, decim,
                                      nco=(ph0, delta)), 10)
    T_out = B // decim
    fma = C * T_out * 2 * taps
    nbytes = (2 * C * B * 2 + C * T_out * 8 + 2 * C * (taps - 1) * 8
              + C * 8 + C * 4 + 4 * taps)
    b_ms, b_by = bound(nbytes, 2.0 * fma)
    print(f"  K5 FM front, decim {decim}: {ms:.4f} ms (bound {b_ms:.4f} ms "
          f"by {b_by}: {fma / 1e9:.2f} G FMA, {nbytes / 2**20:.0f} MiB)")
    return (dict(ms=ms, bound_ms=b_ms, bound_by=b_by, taps=taps,
                 decim=decim), worst, err)


def k67_shapes() -> set:
    """{(taps, decim)} of every wide-SSB row at 48, 96 and 192 kHz that
    `make_params` takes: the shapes the port sends K6/K7."""
    shapes = set()
    for rate in (48000.0, 96000.0, 192000.0):
        for mode in ("usb", "lsb"):
            for fp in filterpaths.paths_for_mode(mode):
                cfg = rx.RxConfig(mode=mode, bw_key=fp.bw_key,
                                  path_name=fp.name, iq_rate=rate)
                try:
                    rx.check_slice(cfg)
                    p = rx.make_params(cfg, "cpu")
                except (NotImplementedError, KeyError, ValueError):
                    continue
                if p.front_fir.is_complex():
                    shapes.add((p.front_fir.shape[-1], cfg.decim))
    return shapes


def fir_cx_stream(h, delta, decim, C, lengths, use_nco, dev, gen, label):
    """K7 (use_nco) or K6 against its plain version, real output as the
    chain takes it, over streamed blocks of `lengths` int16 samples from a
    zero carry and seeded NCO phases: the output at >= FIR_TOL_DB, the raw
    history and the peaks bit-equal.  Returns (min SNR, max abs err, the
    first block's inputs, the last block's carry, phase and inputs)."""
    taps = h.shape[-1]
    ck = cp = torch.zeros((C, taps - 1), dtype=torch.complex64, device=dev)
    phase = torch.randint(0, 2**32, (C,), generator=gen, device=dev)
    worst, err, first = math.inf, 0.0, None
    for blk, Bk in enumerate(lengths):
        xi, xq = iq_block(gen, dev, C, Bk)
        nco_arg = (phase, delta) if use_nco else None
        if first is None:
            first = (ck, xi, xq, nco_arg)
        c_in = ck
        yk, ck, pk_k = fir_k.fir_cx(h, ck, xi, xq, decim, nco=nco_arg,
                                    real_out=True)
        yp, cp, pk_p = fir_k.fir_cx_plain(h, cp, xi, xq, decim, nco=nco_arg,
                                          real_out=True)
        torch.cuda.synchronize()
        check(tuple(yk.shape) == (C, Bk // decim) and not yk.is_complex(),
              f"{label} output {tuple(yk.shape)} {yk.dtype}")
        s, e = held(f"{label} block {blk} ({Bk} samples)", {
            "audio": (yp, yk)})
        check(s >= FIR_TOL_DB, f"{label} audio: {s:.1f} dB < {FIR_TOL_DB}")
        check(torch.equal(cp, ck) and torch.equal(pk_p, pk_k),
              f"{label} block {blk}: raw history or peaks not bit-equal")
        worst, err = min(worst, s), max(err, e)
        last = (c_in, phase, xi, xq)
        if use_nco:
            phase = nco.advance(phase, delta, Bk)
    return worst, err, first, last


def phase_fir_cx(P, dev, gen):
    """K7 (NCO fused, the wide-SSB flagship's front) and K6 (no NCO, the
    untranslated front), `front.cu`'s complex-tap stage A: 245 complex
    taps, decimation 4, real output as the chain takes it, three streamed
    blocks (the middle one shorter than the history), the output at 100
    dB and the raw history and the peaks bit-equal; channels 0-7 of the
    first block launched alone bit-equal to their place in the 8192; the
    complex and two-plane outputs at 1024 channels.  Then K7 at 192 kHz
    (491 taps, decimation 8, 8192 channels) streamed and timed.  The
    library's shared memory must be `fir_cx_geometry`'s at every wide-SSB
    shape."""
    lib = fir_k.FRONT.lib()
    for taps, decim in sorted(k67_shapes()):
        for size in (2, 4):
            want = fir_k.fir_cx_geometry(taps, decim, size).smem
            got = lib.uhsdr_fir_cx_smem(taps, decim, size)
            check(got == want, f"K6/K7 shared memory at {taps} taps, decim "
                               f"{decim}, {size}-byte samples: library "
                               f"{got}, cuda/fir.py {want}")
    params = P["wide"]
    C, B, decim = CHANNELS, WIDE.block_len, WIDE.decim
    h, delta = params.front_fir, params.nco_delta
    taps = h.shape[-1]
    short = decim * ((taps - 1) // (2 * decim))   # shorter than the history
    rows = []
    for K, name, use_nco, line in (("K7", "fir_cx_nco", True, 370),
                                   ("K6", "fir_cx", False, 47)):
        worst, err, first, last = fir_cx_stream(
            h, delta, decim, C, (B, short, B), use_nco, dev, gen, K)
        # batching changes no bit: channels 0-7 alone
        c0, xi, xq, nco0 = first
        y_all, c_all, p_all = fir_k.fir_cx(h, c0, xi, xq, decim, nco=nco0,
                                           real_out=True)
        nco8 = (nco0[0][:8].contiguous(), delta) if use_nco else None
        y8, c8, p8 = fir_k.fir_cx(h, c0[:8].contiguous(),
                                  xi[:8].contiguous(), xq[:8].contiguous(),
                                  decim, nco=nco8, real_out=True)
        torch.cuda.synchronize()
        check(torch.equal(y_all[:8], y8) and torch.equal(c_all[:8], c8)
              and torch.equal(p_all[:8], p8),
              f"{K}: channels 0-7 alone differ from the 8192-channel launch")
        del y_all, c_all
        # the outputs off the chain's path: complex and two planes
        n = 1024
        c_in, ph_l, xi_l, xq_l = last
        c1, x1i, x1q = c_in[:n].contiguous(), xi_l[:n], xq_l[:n]
        nco1 = (ph_l[:n].contiguous(), delta) if use_nco else None
        yc, cn, _ = fir_k.fir_cx(h, c1, x1i, x1q, decim, nco=nco1)
        (ar, ai), _, _ = fir_k.fir_cx(h, c1, x1i, x1q, decim, nco=nco1,
                                      planes_out=True)
        yp, cp1, _ = fir_k.fir_cx_plain(h, c1, x1i, x1q, decim, nco=nco1)
        torch.cuda.synchronize()
        s, e = held(f"{K} complex and planes out, {n} channels", {
            "complex": (yp, yc), "real plane": (yp.real, ar),
            "imag plane": (yp.imag, ai)})
        check(s >= FIR_TOL_DB and torch.equal(cp1, cn),
              f"{K} complex and planes out: {s:.1f} dB < {FIR_TOL_DB}, or "
              f"the raw history not bit-equal")
        worst, err = min(worst, s), max(err, e)

        ms = cuda_ms(lambda: fir_k.fir_cx(h, c0, xi, xq, decim, nco=nco0,
                                          real_out=True), 10)
        plain_ms = cuda_ms(lambda: fir_k.fir_cx_plain(
            h, c0, xi, xq, decim, nco=nco0, real_out=True), 2)
        # one PyTorch call for the FIR itself, on planes mixed beforehand:
        # Re y = sum hr*zr - hi*zi, a two-channel convolution
        stack = premixed_stack(c0, xi, xq, nco0)
        w = torch.stack([h.real.flip(0), -h.imag.flip(0)])[None].contiguous()

        def library():
            return torch.nn.functional.conv1d(stack, w, stride=decim)

        lib_ms = cuda_ms(library, 5)
        y_pl = fir_k.fir_cx_plain(h, c0, xi, xq, decim, nco=nco0,
                                  real_out=True)[0]
        s_lib = snr_db(y_pl, library()[:, 0])
        print(f"  {K} library call (conv1d, 2 channels, stride {decim}, "
              f"planes mixed beforehand) vs plain: SNR {s_lib:.1f} dB")
        del stack, y_pl
        T_out = B // decim
        fma = C * T_out * 2 * taps          # real output: 2 FMA a tap
        ap = fir_k.fir_cx_geometry(taps, decim).ap
        padded = C * T_out * 2 * decim * ap
        # bytes: int16 planes in, real audio out, carry in and out, phase
        # in (K7), peaks out, complex taps in
        nbytes = (2 * C * B * 2 + C * T_out * 4 + 2 * C * (taps - 1) * 8
                  + (C * 8 if use_nco else 0) + C * 4 + 8 * taps)
        extra = {}
        if use_nco:
            extra["at_192k"] = k7_192k_case(dev, gen)
            s, e = extra["at_192k"].pop("snr"), extra["at_192k"].pop("err")
            worst, err = min(worst, s), max(err, e)
        r = row(name, "front.cu", f"uhsdr_tpu/pallas/fir.py:{line}",
                err=err, snr=worst, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
                flops=2.0 * fma, library_ms=lib_ms,
                library_note="conv1d with stride, two input channels, on "
                             "planes mixed beforehand (the FIR alone)",
                padded_fma=padded, **extra)
        print(f"  {K} {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, library "
              f"{lib_ms:.3f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}: {fma / 1e9:.2f} G FMA, {padded / 1e9:.2f} "
              f"G padded, {nbytes / 2**20:.0f} MiB)")
        rows.append(r)
    return rows


def k7_192k_case(dev, gen) -> dict:
    """K7 at the 192 kHz wide row (usb 5P0KHZ: 491 taps, decimation 8) at
    8192 channels: three streamed blocks, the middle one shorter than the
    history, against the plain version, then timed.  Returns its timing
    and its worst SNR and error."""
    cfg = dataclasses.replace(WIDE, iq_rate=192000.0)
    p = rx.make_params(cfg, dev)
    h, delta, decim = p.front_fir, p.nco_delta, cfg.decim
    taps = h.shape[-1]
    C, B = CHANNELS, cfg.block_len
    short = decim * ((taps - 1) // (2 * decim))
    worst, err, first, _ = fir_cx_stream(
        h, delta, decim, C, (B, short, B), True, dev, gen,
        f"K7 192 kHz ({taps} taps, decim {decim})")
    c0, xi, xq, nco0 = first
    ms = cuda_ms(lambda: fir_k.fir_cx(h, c0, xi, xq, decim, nco=nco0,
                                      real_out=True), 10)
    plain_ms = cuda_ms(lambda: fir_k.fir_cx_plain(
        h, c0, xi, xq, decim, nco=nco0, real_out=True), 2)
    T_out = B // decim
    fma = C * T_out * 2 * taps
    padded = C * T_out * 2 * decim * fir_k.fir_cx_geometry(taps, decim).ap
    nbytes = (2 * C * B * 2 + C * T_out * 4 + 2 * C * (taps - 1) * 8
              + C * 8 + C * 4 + 8 * taps)
    b_ms, b_by = bound(nbytes, 2.0 * fma)
    print(f"  K7 at 192 kHz, {taps} taps, decim {decim}: {ms:.4f} ms (plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}: "
          f"{fma / 1e9:.2f} G FMA, {padded / 1e9:.2f} G padded)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                taps=taps, decim=decim, padded_fma=padded, snr=worst,
                err=err)


def wrapped_max(ref: torch.Tensor, got: torch.Tensor) -> float:
    """max |ref - got| of two angle tensors, modulo 2 pi."""
    d = torch.remainder(ref.double() - got.double() + math.pi, 2 * math.pi)
    return float((d - math.pi).abs().max())


def phase_fm_disc(P, dev, gen):
    """K12 at the FM flagship's shape (8192 ch x 8192 samples of the
    decimated complex IQ), three streamed blocks, the middle ragged."""
    C, T = CHANNELS, FM.block_len // FM.decim
    prev_k = prev_p = torch.zeros((C,), dtype=torch.complex64, device=dev)
    err, first = 0.0, None
    for blk, Tk in enumerate((T, 1000, T)):
        z = torch.view_as_complex(torch.randn((C, Tk, 2), generator=gen,
                                              device=dev)).contiguous()
        if first is None:
            first = (prev_k, z)
        yk = ew_k.fm_disc(prev_k, z)
        yp = ew_k.fm_disc_plain(prev_p, z)
        y2 = ew_k.fm_disc(prev_k, (z.real.contiguous(), z.imag.contiguous()))
        torch.cuda.synchronize()
        e = max(wrapped_max(yp, yk), wrapped_max(yp, y2))
        print(f"  K12 block {blk} ({Tk} samples): max|err| mod 2pi {e:.3e} "
              f"(complex and planes in)")
        check(e <= DISC_TOL_ABS, f"K12 block {blk}: max|err| {e:.3e} > "
                                 f"{DISC_TOL_ABS:.1e}")
        err = max(err, e)
        prev_k = prev_p = z[:, -1].contiguous()
    p0, z0 = first
    ms = cuda_ms(lambda: ew_k.fm_disc(p0, z0), 20)
    plain_ms = cuda_ms(lambda: ew_k.fm_disc_plain(p0, z0), 3)
    z_d = torch.cat([p0[:, None], z0[:, :-1]], dim=-1)

    def library():
        return torch.angle(torch.conj(z_d) * z0)

    lib_ms = cuda_ms(library, 10)
    print(f"  K12 library call (torch.angle of conj(z_d) z, z_d shifted "
          f"beforehand) vs plain: max|err| mod 2pi "
          f"{wrapped_max(ew_k.fm_disc_plain(p0, z0), library()):.3e}")
    del z_d
    # bytes: complex64 in, the carried sample in, f32 angle out; about 40
    # f32 operations a sample (the product 6, atan2f ~34)
    nbytes = C * T * 8 + C * 8 + C * T * 4
    r = row("fm_disc", "fm_disc.cu", "uhsdr_tpu/pallas/elemwise.py:25",
            err=err, snr=math.inf, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=40.0 * C * T, library_ms=lib_ms,
            library_note="torch.angle(torch.conj(z_d) * z), z_d the block "
                         "shifted by one sample beforehand")
    print(f"  K12 fm_disc: {ms:.4f} ms (plain {plain_ms:.3f} ms, library "
          f"{lib_ms:.3f} ms, bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']}: {nbytes / 2**20:.0f} MiB)")
    return r


def agc_block(gen, dev, C, T, t0, fs):
    """Seeded AGC input that walks attack, hang and decay: tone bursts whose
    level spans -80..0 dBFS across channels, then silence."""
    n = torch.arange(T, device=dev, dtype=torch.float32) + t0
    level = torch.logspace(-4, 0, C, device=dev)[:, None]
    tone = torch.sin(2 * math.pi * 700.0 / fs * n)[None, :]
    on = (n < 3072).to(torch.float32)[None, :]         # burst, then silence
    noise = torch.randn((C, T), generator=gen, device=dev) * 1e-5
    return (level * tone * on + noise).contiguous()


def agc_case(agc_params, fs, lengths, dev, gen, time_len=None, C=CHANNELS,
             name="K3"):
    """K3 against its plain version over streamed blocks of `lengths`
    samples, bit for bit; then times at the first block's length (the
    kernel, with `time_len`, on a fresh block of that length: the window,
    not the length, is what the plain check tests).  Per-channel settings
    in `agc_params` run the row variant.  The library's shared memory must
    be `agc_geometry`'s.  Returns (max |err|, ms, plain ms, bytes, flops,
    recurrence ms, timed length)."""
    kp = agc_ops.kernel_params(agc_params, C)
    p = kp.scalars
    rows = None if kp.rows is None else torch.as_tensor(kp.rows, device=dev)
    w = agc_params.attack_buffsize
    geo = agc_k.agc_geometry(C, lengths[0], w, rows is not None)
    smem = agc_k.AGC.lib().uhsdr_agc_smem(w)
    check(smem == geo.smem, f"{name} w={w}: the library's shared memory "
                            f"{smem} != agc_geometry's {geo.smem}")
    carry_k = carry_p = torch.zeros((agc_k.N_CARRY, C), device=dev)
    dl_k = dl_p = torch.zeros((C, w), device=dev)
    err, t0 = 0.0, 0
    first = None
    for blk, T in enumerate(lengths):
        x = agc_block(gen, dev, C, T, t0, fs)
        t0 += T
        if first is None:
            first = (carry_k, dl_k, x)
        yk, carry_k, dl_k = agc_k.agc(p, carry_k, dl_k, x, rows)
        yp, carry_p, dl_p = agc_k.agc_plain(p, carry_p, dl_p, x, rows)
        torch.cuda.synchronize()
        pairs = {"audio": (yp, yk), "delay": (dl_p, dl_k)}
        for i, f in enumerate(agc_ops.CARRY_FIELDS):
            pairs[f] = (carry_p[i], carry_k[i])
        _, e = held(f"{name} w={w} block {blk} ({T} samples)", pairs)
        err = max(err, e)
    check(err == 0.0, f"{name} w={w}: not bit-exact against its plain "
                      f"version (max|err| {err:.3e})")
    c0, d0, x0 = first
    plain_ms = cuda_ms(lambda: agc_k.agc_plain(p, c0, d0, x0, rows), 1)
    T = time_len or lengths[0]
    if T != lengths[0]:
        x0 = agc_block(gen, dev, C, T, 0, fs)
    ms = cuda_ms(lambda: agc_k.agc(p, c0, d0, x0, rows), 10)
    # work: x in, y out, carries and delay in and out (and the rows in);
    # about 60 f32 operations per machine step and gain law
    nbytes = (2 * C * T * 4 + 2 * (agc_k.N_CARRY * C + C * w) * 4
              + (0 if rows is None else rows.numel() * 4))
    rec_ms = recurrence_ms(T, AGC_STEP_OPS)
    b_ms, b_by = bound(nbytes, 60.0 * C * T)
    print(f"  {name} agc w={w}, {C} x {T}: {ms:.4f} ms (plain "
          f"{plain_ms:.1f} ms at {lengths[0]} steps; recurrence bound "
          f"{rec_ms:.4f} ms = {T} steps x {AGC_STEP_OPS} dependent ops x "
          f"{FP32_LATENCY} cycles, "
          f"{recurrence_ms(T, AGC_STEP_OPS_BLENDED):.4f} ms at the blended "
          f"step's {AGC_STEP_OPS_BLENDED}; {b_by} bound {b_ms:.4f} ms; "
          f"{geo.smem} B shared, {geo.grid} blocks)")
    return err, ms, plain_ms, nbytes, 60.0 * C * T, rec_ms, T


def phase_agc(P, dev, gen):
    T48, T96 = CFG.block_len // CFG.decim, SAM.block_len // SAM.decim
    err, ms, plain_ms, nbytes, flops, rec_ms, _ = agc_case(
        P["ssb"].agc, CFG.fs_dec, (T48, T48, T48), dev, gen)
    e96, ms96, plain96, nb96, fl96, rec96, _ = agc_case(
        P["sam"].agc, SAM.fs_dec, (T96, 1000, T96), dev, gen)
    b96, by96 = bound(nb96, fl96)
    # FM's look-ahead of 192: the plain loop checks 2048-step blocks; the
    # kernel is timed at the FM block's 8192 steps
    T192 = FM.block_len // FM.decim
    e192, ms192, plain192, nb192, fl192, rec192, _ = agc_case(
        P["fm"].agc, rx.IQ_RATE, (2048, 1000, 2048), dev, gen,
        time_len=T192)
    b192, by192 = bound(nb192, fl192)
    # the fleet's FM group: 1024 channels x 16384 steps at 48 kHz, w 192
    fm48 = pfleet.FLEET_MIX[-1]
    check(fm48.mode == "fm", "the fleet's last group is FM")
    efm, msfm, plainfm, nbfm, flfm, recfm, _ = agc_case(
        rx.make_params(fm48, dev).agc, fm48.fs_dec,
        (FLEET_BLOCK, 1000, FLEET_BLOCK), dev, gen,
        C=FLEET_GROUP_CHANNELS, name="K3 fleet FM")
    bfm, byfm = bound(nbfm, flfm)
    return row("agc", "agc.cu", "uhsdr_tpu/pallas/agc.py:159",
               err=max(err, e96, e192, efm), snr=math.inf, ms=ms,
               plain_ms=plain_ms, nbytes=nbytes, flops=flops,
               recurrence_ms=rec_ms,
               recurrence_blended_ms=recurrence_ms(T48, AGC_STEP_OPS_BLENDED),
               library_note="no PyTorch call computes a look-ahead AGC",
               w96=dict(ms=ms96, plain_ms=plain96, bound_ms=b96,
                        bound_by=by96, recurrence_ms=rec96, steps=T96),
               w192=dict(ms=ms192, plain_ms=plain192, plain_steps=2048,
                         bound_ms=b192, bound_by=by192,
                         recurrence_ms=rec192, steps=T192),
               fleet_fm=dict(ms=msfm, plain_ms=plainfm, bound_ms=bfm,
                             bound_by=byfm, recurrence_ms=recfm,
                             channels=FLEET_GROUP_CHANNELS,
                             steps=FLEET_BLOCK))


def interp_library(h, carry, x, interp):
    """One PyTorch call for the same function: a strided transposed
    convolution over carry ++ x (timed as `library_ms`, not used by the
    port)."""
    sub_len = carry.shape[-1] + 1
    xfull = torch.cat([carry, x], dim=-1)[:, None, :]
    taps = h.shape[-1]
    w = h.reshape(1, 1, taps)

    def call():
        return torch.nn.functional.conv_transpose1d(xfull, w, stride=interp)

    def result():
        y = call()[:, 0]
        o = (sub_len - 1) * interp
        return y[:, o:o + x.shape[-1] * interp]
    return call, result


def interp_case(h, C, lengths, L, dev, gen, label):
    """K4 against its plain version at x L over streamed blocks of the
    given lengths (the middle one ragged), channels 0-7 alone bit-equal
    to the batch; returns (min SNR, max |err|, the first block's (carry,
    x))."""
    sub_len = -(-h.shape[-1] // L)
    ck = cp = torch.zeros((C, sub_len - 1), device=dev)
    worst, err = math.inf, 0.0
    first = None
    for blk, B in enumerate(lengths):
        x = torch.randn((C, B), generator=gen, device=dev) * 0.1
        if first is None:
            first = (ck, x)
        yk, ck_next = fir_k.interpolate(h, ck, x, L)
        y8, c8 = fir_k.interpolate(h, ck[:8].contiguous(),
                                   x[:8].contiguous(), L)
        yp, cp = fir_k.interp_plain(h, cp, x, L)
        torch.cuda.synchronize()
        s, e = held(f"K4 {label} block {blk} ({B} samples)",
                    {"audio": (yp, yk), "carry": (cp, ck_next)})
        check(torch.equal(y8, yk[:8]) and torch.equal(c8, ck_next[:8]),
              f"K4 {label}: channels 0-7 alone differ from the batch")
        worst, err = min(worst, s), max(err, e)
        ck = ck_next
        del yk, yp, y8
    return worst, err, first


def interp_bytes(C, B, L, taps) -> float:
    """K4's bytes: x in, y out, the carry in and out, the taps."""
    return (C * B + C * B * L + 2 * C * (-(-taps // L) - 1) + taps) * 4.0


def phase_interp(P, dev, gen):
    """K4 at the SSB flagship's x8 (8192 x 2048, 93 taps), the AM/SAM x4
    (8192 x 4096), ssbstereo's 16384 rows at x8 and the 48 kHz x2 (8192 x
    8192, the decimation-2 rows' 16 taps), each over three streamed blocks
    with a ragged middle one; timed at each shape."""
    C, T, L = CHANNELS, CFG.block_len // CFG.decim, CFG.decim
    h = P["ssb"].interp_fir
    taps = h.shape[-1]
    sub_len = -(-taps // L)
    worst, err, (c0, x0) = interp_case(h, C, (T, T - 548, T), L, dev, gen,
                                       f"x{L}")
    ms = cuda_ms(lambda: fir_k.interpolate(h, c0, x0, L), 10)
    plain_ms = cuda_ms(lambda: fir_k.interp_plain(h, c0, x0, L), 3)
    call, result = interp_library(h, c0, x0, L)
    lib_ms = cuda_ms(call, 10)
    s_lib = snr_db(fir_k.interp_plain(h, c0, x0, L)[0], result())
    print(f"  K4 library call (conv_transpose1d) vs plain: SNR {s_lib:.1f} dB")
    del c0, x0
    x48 = rx.RxConfig(mode="am", bw_key="5P0KHZ", iq_rate=48000.0,
                      block_len=16384)
    others = {}
    # (label, taps, channels, low-rate samples, factor)
    for label, hh, Ck, Tk, Lk in (
            ("x4", P["sam"].interp_fir, C, SAM.block_len // SAM.decim,
             SAM.decim),
            ("ssbstereo_x8", h, 2 * C, T, L),
            ("x2_48k", rx.make_params(x48, dev).interp_fir, C,
             x48.block_len // x48.decim, x48.decim)):
        w, e, (ck, xk) = interp_case(hh, Ck, (Tk, Tk - 301, Tk), Lk, dev,
                                     gen, label)
        worst, err = min(worst, w), max(err, e)
        mk = cuda_ms(lambda: fir_k.interpolate(hh, ck, xk, Lk), 10)
        bk, byk = bound(interp_bytes(Ck, Tk, Lk, hh.shape[-1]), 0.0)
        others[label] = dict(ms=mk, bound_ms=bk, bound_by=byk,
                             shape=[Ck, Tk], interp=Lk, taps=hh.shape[-1])
        print(f"  K4 {label} ({Ck} x {Tk}, {hh.shape[-1]} taps): {mk:.4f} "
              f"ms, bound {bk:.4f} ms by {byk} ({100 * bk / mk:.1f}%)")
        del ck, xk
        torch.cuda.empty_cache()
    nbytes = interp_bytes(C, T, L, taps)
    r = row("interp", "interp.cu", "uhsdr_tpu/pallas/fir.py:1003",
            err=err, snr=worst, ms=ms, plain_ms=plain_ms,
            nbytes=nbytes, flops=2.0 * C * T * L * sub_len,
            library_ms=lib_ms, library_note="conv_transpose1d with stride",
            **others)
    print(f"  K4 interp x{L}: {ms:.4f} ms (plain {plain_ms:.3f} ms, library "
          f"{lib_ms:.4f} ms, bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']}: {nbytes / 2**20:.0f} MiB, "
          f"{100 * r['bound_ms'] / ms:.1f}%)")
    return r


def pll_block(gen, dev, C, T, t0, fs):
    """Seeded decimated IQ for the PLL: per channel a carrier 2..40 Hz off
    tune at -30 ... -6 dBFS (starting phase 1 rad, clear of the phase
    detector's branch cut), 40% AM at 300 Hz, noise 26 dB below the
    weakest carrier."""
    n = torch.arange(T, device=dev, dtype=torch.float64) + t0
    c = torch.arange(C, device=dev, dtype=torch.float64)[:, None]
    amp = 10.0 ** (-1.5 + 1.2 * (c % 64) / 63.0)
    f = 2.0 + 38.0 * (c % 97) / 96.0
    ph = 1.0 + 2 * math.pi * torch.remainder(f * n / fs, 1.0)
    env = amp * (1.0 + 0.4 * torch.sin(2 * math.pi * 300.0 / fs * n))
    z = torch.polar(env, ph).to(torch.complex64)
    noise = torch.randn((C, T, 2), generator=gen, device=dev) * 1.5e-3
    return (z + torch.view_as_complex(noise)).contiguous()


def phase_pll(P, dev, gen, audio: bool):
    """K10 (cos/sin out), or with `audio` K9 (audio and fade leveler)."""
    sp = P["sam"].sam
    C, T, fs = CHANNELS, SAM.block_len // SAM.decim, SAM.fs_dec
    scal = pll_k.PllScalars(sp.g1, sp.g2, sp.omega_min, sp.omega_max)
    K = "K9" if audio else "K10"
    if audio:
        def kernel(carry, z):
            a, co = pll_k.pll_audio(scal, sp.fade.mtauR, sp.fade.mtauI,
                                    carry, z)
            return {"audio": a}, co

        def plain(carry, z):
            a, co = pll_k.pll_audio_plain(scal, sp.fade.mtauR,
                                          sp.fade.mtauI, carry, z)
            return {"audio": a}, co
        n_carry = pll_k.N_CARRY_AUDIO
    else:
        def kernel(carry, z):
            c, s, co = pll_k.pll(scal, carry, z)
            return {"cos": c, "sin": s}, co

        def plain(carry, z):
            c, s, co = pll_k.pll_plain(scal, carry, z)
            return {"cos": c, "sin": s}, co
        n_carry = pll_k.N_CARRY
    names = ("phs", "fil_out", "omega2", "dc", "dc_insert")[:n_carry]
    ck = cp = torch.zeros((n_carry, C), device=dev)
    worst, err, t0 = math.inf, 0.0, 0
    first = None
    for blk, Tk in enumerate((T, 1000, T)):     # 1000: no whole time tile
        z = pll_block(gen, dev, C, Tk, t0, fs)
        t0 += Tk
        if first is None:
            first = (ck, z)
        out_k, ck = kernel(ck, z)
        out_p, cp = plain(cp, z)
        torch.cuda.synchronize()
        pairs = {k: (out_p[k], out_k[k]) for k in out_k}
        # the phase through its cosine and sine: a wrap at 2 pi is no error
        pairs["phs (cos, sin)"] = (
            torch.stack([cp[0].cos(), cp[0].sin()]),
            torch.stack([ck[0].cos(), ck[0].sin()]))
        for i in range(1, n_carry):
            pairs[names[i]] = (cp[i], ck[i])
        s, e = held(f"{K} block {blk} ({Tk} samples)", pairs,
                    tol_abs=PLL_TOL_ABS)
        worst, err = min(worst, s), max(err, e)
    c0, z0 = first
    ms = cuda_ms(lambda: kernel(c0, z0), 10)
    plain_ms = cuda_ms(lambda: plain(c0, z0), 1)
    # bytes: complex IQ in, one (K9) or two (K10) f32 planes out, carries;
    # about 70 f32 operations a step (sincosf ~25, atan2f ~30, the rest 15)
    n_out = 1 if audio else 2
    nbytes = C * T * 8 + n_out * C * T * 4 + 2 * n_carry * C * 4
    rec_ms = recurrence_ms(T, PLL_STEP_OPS)
    r = row("pll_audio" if audio else "pll", "pll.cu",
            f"uhsdr_tpu/pallas/pll.py:{97 if audio else 54}", err=err,
            snr=worst, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=70.0 * C * T, recurrence_ms=rec_ms,
            library_note="no PyTorch call computes a phase-locked loop")
    print(f"  {K} {r['name']}: {ms:.4f} ms (plain {plain_ms:.1f} ms; "
          f"recurrence bound {rec_ms:.4f} ms = {T} steps x {PLL_STEP_OPS} "
          f"dependent ops x {FP32_LATENCY} cycles; {r['bound_by']} bound "
          f"{r['bound_ms']:.4f} ms, {nbytes / 2**20:.0f} MiB)")
    return r


def phase_pll_cos_sin(P, dev, gen):
    return phase_pll(P, dev, gen, audio=False)


def phase_pll_audio(P, dev, gen):
    return phase_pll(P, dev, gen, audio=True)


def phase_biquad(P, dev, gen):
    """K11 at the shape SAM's sideband route gives it: the 7-section
    allpass chain over two paths stacked along channels."""
    sos = P["sam"].sam.ap_sos[0]
    S = sos.shape[0]
    C, T = 2 * CHANNELS, SAM.block_len // SAM.decim
    sk = sp_ = torch.zeros((S, C, 2), device=dev)
    worst, err = math.inf, 0.0
    first = None
    for blk, Tk in enumerate((T, 1000, T)):     # 1000: no whole time tile
        x = torch.randn((C, Tk), generator=gen, device=dev) * 0.1
        if first is None:
            first = (sk, x)
        yk, sk = iir_k.biquad_cascade(sos, sk, x)
        yp, sp_ = iir_k.biquad_cascade_plain(sos, sp_, x)
        torch.cuda.synchronize()
        s, e = held(f"K11 block {blk} ({Tk} samples)",
                    {"audio": (yp, yk), "state": (sp_, sk)})
        worst, err = min(worst, s), max(err, e)
    # general coefficients: the PreFilter's high-Q sections, 1000 channels
    sos_g = P["sam"].audio_sos.sos
    xg = torch.randn((1000, 1000), generator=gen, device=dev) * 0.1
    sg = torch.zeros((sos_g.shape[0], 1000, 2), device=dev)
    yk, sgk = iir_k.biquad_cascade(sos_g, sg, xg)
    yp, sgp = iir_k.biquad_cascade_plain(sos_g, sg, xg)
    torch.cuda.synchronize()
    s, e = held(f"K11 PreFilter SOS ({sos_g.shape[0]} sections)",
                {"audio": (yp, yk), "state": (sgp, sgk)})
    worst, err = min(worst, s), max(err, e)
    s0, x0 = first
    ms = cuda_ms(lambda: iir_k.biquad_cascade(sos, s0, x0), 10)
    plain_ms = cuda_ms(lambda: iir_k.biquad_cascade_plain(sos, s0, x0), 1)
    # bytes: x in, y out, states in and out; 9 f32 operations a section
    nbytes = 2 * C * T * 4 + 2 * S * C * 2 * 4 + S * 5 * 4
    rec_ms = recurrence_ms(T, BIQUAD_STEP_OPS)
    r = row("biquad", "biquad.cu", "uhsdr_tpu/pallas/iir.py:44", err=err,
            snr=worst, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=9.0 * S * C * T, recurrence_ms=rec_ms,
            library_note="torch has no IIR filter call")
    print(f"  K11 biquad ({S} sections, {C} stacked channels): {ms:.4f} ms "
          f"(plain {plain_ms:.1f} ms, bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']}: {nbytes / 2**20:.0f} MiB; recurrence "
          f"{rec_ms:.4f} ms)")
    return r


def phase_agc_scan(P, dev, gen):
    """K13 at the two-channel flagship's shape (8192 channels x 2048
    steps at 12 kHz): two channels of AGC input through the linked
    detector and its look-ahead max, then the machine on the kernel and on
    its plain version, bit for bit, over three streamed blocks (the
    middle one ragged)."""
    params = P["stereo"].agc
    p = agc_ops.kernel_params(params).scalars
    C, w = CHANNELS, params.attack_buffsize
    T, fs = STEREO.block_len // STEREO.decim, STEREO.fs_dec
    ck = cp = torch.zeros((agc_k.N_CARRY, C), device=dev)
    delay = torch.zeros((C, 2, w), device=dev)
    err, t0, first = 0.0, 0, None
    for blk, Tk in enumerate((T, 1000, T)):
        x = torch.stack([agc_block(gen, dev, C, Tk, t0, fs),
                         0.5 * agc_block(gen, dev, C, Tk, t0, fs)], dim=1)
        t0 += Tk
        xfull = torch.cat([delay, x], dim=-1)
        delay = xfull[..., xfull.shape[-1] - w:]
        a = xfull.abs().amax(dim=-2)
        rm = agc_k.look_ahead_max(a, w, Tk).contiguous()
        ax = a[:, :Tk].contiguous()
        if first is None:
            first = (ck, rm, ax)
        vk, ck = agc_k.agc_scan(p, ck, rm, ax)
        vp, cp = agc_k.agc_scan_plain(p, cp, rm, ax)
        torch.cuda.synchronize()
        pairs = {"volts": (vp, vk)}
        for i, f in enumerate(agc_ops.CARRY_FIELDS):
            pairs[f] = (cp[i], ck[i])
        _, e = held(f"K13 block {blk} ({Tk} steps)", pairs)
        err = max(err, e)
    check(err == 0.0, f"K13: not bit-exact against its plain version "
                      f"(max|err| {err:.3e})")
    c0, rm0, ax0 = first
    ms = cuda_ms(lambda: agc_k.agc_scan(p, c0, rm0, ax0), 10)
    plain_ms = cuda_ms(lambda: agc_k.agc_scan_plain(p, c0, rm0, ax0), 1)
    # bytes: rm and ax in, volts out, carries in and out; about 50 f32
    # operations a step
    nbytes = 3 * C * T * 4 + 2 * agc_k.N_CARRY * C * 4
    rec_ms = recurrence_ms(T, AGC_STEP_OPS)
    rec18 = recurrence_ms(T, AGC_STEP_OPS_BLENDED)
    r = row("agc_scan", "agc.cu", "uhsdr_tpu/pallas/agc.py:126", err=err,
            snr=math.inf, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=50.0 * C * T, recurrence_ms=rec_ms,
            recurrence_blended_ms=rec18,
            library_note="no PyTorch call computes the AGC's 5-state "
                         "machine")
    print(f"  K13 agc_scan, T={T}: {ms:.4f} ms (plain {plain_ms:.1f} ms; "
          f"recurrence bound {rec_ms:.4f} ms at {AGC_STEP_OPS} ops, "
          f"{rec18:.4f} at the blended step's {AGC_STEP_OPS_BLENDED}; "
          f"{r['bound_by']} bound {r['bound_ms']:.4f} ms, "
          f"{nbytes / 2**20:.0f} MiB)")
    return r


def fleet_thresholds() -> np.ndarray:
    """The AGC thresholds of the fleet's five 12 kHz groups, a group's
    1024 channels each: the per-channel rows their merged K3 takes."""
    return np.concatenate([np.full(FLEET_GROUP_CHANNELS, c.agc_thresh_db)
                           for c in pfleet.FLEET_MIX if c.mode != "fm"])


def phase_agc_rows(P, dev, gen):
    """K3 with per-channel rows at the fleet's merged AGC shape: the five
    12 kHz groups' 5120 channels x 4096 steps, look-ahead 48, thresholds
    60/50/70/60/55 dB, bit for bit against its plain version over three
    streamed blocks (the middle one ragged)."""
    th = fleet_thresholds()
    C, T = th.size, FLEET_BLOCK // 4
    params = agc_ops.make_params(12000.0, thresh_db=th)
    err, ms, plain_ms, nbytes, flops, rec_ms, _ = agc_case(
        params, 12000.0, (T, 1000, T), dev, gen, C=C, name="K3 rows")
    # the scalar K3 at the same shape, for the cost of the rows
    p60 = agc_ops.kernel_params(agc_ops.make_params(12000.0)).scalars
    x = agc_block(gen, dev, C, T, 0, 12000.0)
    c0 = torch.zeros((agc_k.N_CARRY, C), device=dev)
    d0 = torch.zeros((C, params.attack_buffsize), device=dev)
    scalar_ms = cuda_ms(lambda: agc_k.agc(p60, c0, d0, x), 10)
    print(f"  K3 scalar at the same shape: {scalar_ms:.4f} ms")
    return row("agc_rows", "agc.cu", "uhsdr_tpu/pallas/agc.py:176",
               err=err, snr=math.inf, ms=ms, plain_ms=plain_ms,
               nbytes=nbytes, flops=flops, recurrence_ms=rec_ms,
               recurrence_blended_ms=recurrence_ms(T, AGC_STEP_OPS_BLENDED),
               library_note="no PyTorch call computes a look-ahead AGC",
               channels=C, steps=T, scalar_ms=scalar_ms)


def phase_agc_scan_rows(P, dev, gen):
    """K13 with per-channel rows (min_volts, hang_level) at the
    `agc_stereo_rows` entry path's shape, 8192 channels x 2048 steps,
    thresholds 40 ... 80 dB across the channels, bit for bit against its
    plain version over three streamed blocks (the middle one ragged)."""
    C, T, w = CHANNELS, STEREO_ROWS_T, 48
    params = agc_ops.make_params(12000.0, thresh_db=STEREO_ROWS_THRESH)
    kp = agc_ops.kernel_params(params, C)
    p = kp.scalars
    rows = torch.as_tensor(kp.scan_rows, device=dev)
    ck = cp = torch.zeros((agc_k.N_CARRY, C), device=dev)
    err, t0, first = 0.0, 0, None
    for blk, Tk in enumerate((T, 1000, T)):
        a = agc_block(gen, dev, C, Tk + w, t0, 12000.0).abs()
        t0 += Tk
        rm = agc_k.look_ahead_max(a, w, Tk).contiguous()
        ax = a[:, :Tk].contiguous()
        if first is None:
            first = (ck, rm, ax)
        vk, ck = agc_k.agc_scan(p, ck, rm, ax, rows)
        vp, cp = agc_k.agc_scan_plain(p, cp, rm, ax, rows)
        torch.cuda.synchronize()
        pairs = {"volts": (vp, vk)}
        for i, f in enumerate(agc_ops.CARRY_FIELDS):
            pairs[f] = (cp[i], ck[i])
        _, e = held(f"K13 rows block {blk} ({Tk} steps)", pairs)
        err = max(err, e)
    check(err == 0.0, f"K13 rows: not bit-exact against its plain version "
                      f"(max|err| {err:.3e})")
    c0, rm0, ax0 = first
    ms = cuda_ms(lambda: agc_k.agc_scan(p, c0, rm0, ax0, rows), 10)
    # the scalar K13 on the same inputs, for the cost of the rows
    p60 = agc_ops.kernel_params(agc_ops.make_params(12000.0)).scalars
    scalar_ms = cuda_ms(lambda: agc_k.agc_scan(p60, c0, rm0, ax0), 10)
    plain_ms = cuda_ms(lambda: agc_k.agc_scan_plain(p, c0, rm0, ax0, rows),
                       1)
    # bytes: rm and ax in, volts out, carries in and out, the two rows in
    nbytes = 3 * C * T * 4 + 2 * agc_k.N_CARRY * C * 4 + 2 * C * 4
    rec_ms = recurrence_ms(T, AGC_STEP_OPS)
    rec18 = recurrence_ms(T, AGC_STEP_OPS_BLENDED)
    r = row("agc_scan_rows", "agc.cu", "uhsdr_tpu/pallas/agc.py:128",
            err=err, snr=math.inf, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=50.0 * C * T, recurrence_ms=rec_ms,
            recurrence_blended_ms=rec18, scalar_ms=scalar_ms,
            library_note="no PyTorch call computes the AGC's 5-state "
                         "machine")
    print(f"  K13 rows agc_scan, {C} x {T}: {ms:.4f} ms (scalar "
          f"{scalar_ms:.4f} ms on the same inputs; plain "
          f"{plain_ms:.1f} ms; recurrence bound {rec_ms:.4f} ms at "
          f"{AGC_STEP_OPS} ops, {rec18:.4f} at {AGC_STEP_OPS_BLENDED}; "
          f"{r['bound_by']} bound {r['bound_ms']:.4f} ms)")
    return r


def phase_front_pair(P, dev, gen):
    """K1 with the two-channel modes' two stage-B filters at the
    two-channel flagship's shape, the pair's 1810-sample raw history;
    three streamed blocks, the middle one shorter than the history."""
    params = P["stereo"]
    C, B, decim = CHANNELS, STEREO.block_len, STEREO.decim
    h, g, delta = params.front_fir, params.front2, params.nco_delta
    taps, taps2 = h.shape[-1], g.shape[-1]
    n_keep = rx._raw_history_len(STEREO, params)
    ck = cp = torch.zeros((C, n_keep), dtype=torch.complex64, device=dev)
    c2k = c2p = torch.zeros((C, taps2 - 1), dtype=torch.complex64,
                            device=dev)
    phase = torch.zeros((C,), dtype=torch.int64, device=dev)
    worst, err, first = math.inf, 0.0, None
    for blk, Bk in enumerate((B, 800, B)):
        xi, xq = iq_block(gen, dev, C, Bk)
        if first is None:
            first = (ck, c2k, xi, xq, phase)
        yk, ck, c2k, pk_k = fir_k.front(h, g, ck, c2k, xi, xq, phase, delta,
                                        decim)
        yp, cp, c2p, pk_p = fir_k.front_plain(h, g, cp, c2p, xi, xq, phase,
                                              delta, decim)
        torch.cuda.synchronize()
        check(tuple(yk.shape) == (C, 2, Bk // decim),
              f"front_pair output {tuple(yk.shape)}")
        s, e = held(f"K1 pair block {blk} ({Bk} samples)", {
            "audio (L, R)": (yp, yk), "raw carry": (cp, ck),
            "front2 carry": (c2p, c2k), "peaks": (pk_p, pk_k)})
        worst, err = min(worst, s), max(err, e)
        phase = nco.advance(phase, delta, Bk)
    ck0, c2k0, xi, xq, ph0 = first
    ms = cuda_ms(lambda: fir_k.front(h, g, ck0, c2k0, xi, xq, ph0, delta,
                                     decim), 10)
    plain_ms = cuda_ms(lambda: fir_k.front_plain(h, g, ck0, c2k0, xi, xq,
                                                 ph0, delta, decim), 2)
    T_out = B // decim
    fma = C * T_out * (2 * taps + 2 * 2 * taps2)
    # bytes: int16 planes in, two audio planes out, the raw history's last
    # taps-1 in and n_keep out, the stage-B carry in and out, phase in,
    # peaks out, taps in
    nbytes = (2 * C * B * 2 + 2 * C * T_out * 4 + C * (taps - 1) * 8
              + C * n_keep * 8 + 2 * C * (taps2 - 1) * 8 + C * 8 + C * 4
              + 4 * (taps + 4 * taps2))
    r = row("front_pair", "front.cu", "uhsdr_tpu/pallas/fir.py:179",
            err=err, snr=worst, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=2.0 * fma,
            library_note="no one PyTorch call mixes, decimates and runs "
                         "both FIR stages")
    print(f"  K1 front_pair: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']}: {fma / 1e9:.2f} G "
          f"FMA, {nbytes / 2**20:.0f} MiB)")
    return r


def phase_fir_real(P, dev, gen):
    """K8 at the TX flagship's shape (8192 ch x 16384 f32 audio, the
    201-tap TX Hilbert pair), with the NCO and without, conjugated and
    not: two streamed blocks each, the second shorter than the history;
    the output held to FIR_TOL_DB and the new history bit-equal.  K8's
    shared-memory rule in the library and in cuda/fir.py must agree at
    every block length the TX paths send it.  Timed at the flagship, with
    and without the NCO, and at `wideband_tx`'s 4096 x 4096."""
    params = P["tx"].ssb
    C, B = CHANNELS, TXF.block_len
    h, delta = params.fir, params.nco_delta
    taps = h.shape[-1]
    lib = fir_k.FIR_REAL.lib()
    for Bk in (B, WB_T, 100, 2048):
        want = fir_k.fir_real_geometry(taps, Bk).smem
        got = lib.uhsdr_fir_real_smem(taps, Bk)
        check(got == want, f"K8 shared memory at {taps} taps, block {Bk}: "
                           f"library {got}, cuda/fir.py {want}")
    worst, err = math.inf, 0.0
    for use_nco, conj in ((True, False), (True, True), (False, False),
                          (False, True)):
        ck = cp = torch.zeros((C, taps - 1), device=dev)
        phase = torch.zeros((C,), dtype=torch.int64, device=dev)
        for blk, Bk in enumerate((B, 100)):
            x = torch.randn((C, Bk), generator=gen, device=dev) * 1e4
            kw = dict(nco=(phase, delta) if use_nco else None, conj=conj)
            yk, ck = fir_k.fir_real(h, ck, x, **kw)
            yp, cp = fir_k.fir_real_plain(h, cp, x, **kw)
            torch.cuda.synchronize()
            check(tuple(yk.shape) == (C, Bk) and yk.is_complex(),
                  f"K8 output {tuple(yk.shape)} {yk.dtype}")
            label = f"K8 nco {use_nco} conj {conj} block {blk} ({Bk} samples)"
            s, e = held(label, {"iq": (yp, yk), "carry": (cp, ck)})
            check(s >= FIR_TOL_DB and torch.equal(cp, ck),
                  f"{label}: SNR {s:.1f} dB < {FIR_TOL_DB}, or the carry "
                  f"not bit-equal")
            worst, err = min(worst, s), max(err, e)
            phase = nco.advance(phase, delta, Bk)
            del yk, yp
    x = torch.randn((C, B), generator=gen, device=dev) * 1e4
    c0 = torch.zeros((C, taps - 1), device=dev)
    ph0 = torch.zeros((C,), dtype=torch.int64, device=dev)
    ms = cuda_ms(lambda: fir_k.fir_real(h, c0, x, nco=(ph0, delta)), 10)
    ms_no_nco = cuda_ms(lambda: fir_k.fir_real(h, c0, x), 10)
    xw, cw = x[:WB_M, :WB_T].contiguous(), c0[:WB_M]
    ms_wb = cuda_ms(lambda: fir_k.fir_real(h, cw, xw, nco=(ph0[:WB_M],
                                                             delta)), 10)
    del xw
    plain_ms = cuda_ms(lambda: fir_k.fir_real_plain(h, c0, x,
                                                    nco=(ph0, delta)), 2)
    # one PyTorch call for the FIR itself (no rotation): a convolution with
    # two output channels, the real and imaginary taps
    xfull = torch.cat([c0, x], dim=-1)[:, None, :]
    w = torch.stack([h.real.flip(0), h.imag.flip(0)])[:, None, :].contiguous()

    def library():
        return torch.nn.functional.conv1d(xfull, w)

    lib_ms = cuda_ms(library, 5)
    y_lib = library()
    s_lib = snr_db(fir_k.fir_real_plain(h, c0, x)[0],
                   torch.complex(y_lib[:, 0], y_lib[:, 1]))
    print(f"  K8 library call (conv1d, 2 output channels, no rotation) vs "
          f"plain: SNR {s_lib:.1f} dB")
    del xfull, y_lib
    fma = C * B * taps * 2
    # bytes: audio in, complex IQ out, carry in and out, phase in, taps in
    nbytes = C * B * 4 + C * B * 8 + 2 * C * (taps - 1) * 4 + C * 8 + 8 * taps
    r = row("fir_real", "fir_real.cu", "uhsdr_tpu/pallas/fir.py:911",
            err=err, snr=worst, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=2.0 * fma, library_ms=lib_ms,
            library_note="conv1d with two output channels (the real and "
                         "imaginary taps) over carry ++ block, the FIR "
                         "alone", ms_no_nco=ms_no_nco,
            ms_wideband_tx=ms_wb)
    print(f"  K8 fir_real: {ms:.4f} ms with the NCO, {ms_no_nco:.4f} ms "
          f"without, {ms_wb:.4f} ms at {WB_M} x {WB_T} (plain "
          f"{plain_ms:.3f} ms, library {lib_ms:.3f} ms, bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']}: "
          f"{fma / 1e9:.2f} G FMA, {nbytes / 2**20:.0f} MiB)")
    return r


def tx_level_block(gen, dev, C, T, t0):
    """ALC input in the count domain: 700 Hz bursts at 1e3 ... 5e4 counts
    across channels (the knee is 3e4), gated on and off, plus noise."""
    n = torch.arange(T, device=dev, dtype=torch.float32) + t0
    level = torch.logspace(3, 4.7, C, device=dev)[:, None]
    tone = torch.sin(2 * math.pi * 700.0 / 48000.0 * n)[None, :]
    on = (torch.remainder(n, 3000.0) < 1500.0).to(torch.float32)[None, :]
    noise = torch.randn((C, T), generator=gen, device=dev)
    return (level * tone * on + noise).contiguous()


def alc_edge_block(gen, dev, C, T, t0, pg):
    """ALC input where the walker's fast division is not div.rn's or is
    not taken, by channel class c % 9: 0, 7, 8 the audio of
    tx_level_block; 1 that audio with every 11th sample one of +-0,
    subnormals, |xp| just below, at and just above 2^-80, just below and
    past 2^100, 3e38 and +-inf (pg: the post-filter gain); 2 subnormal
    audio; 3 exact zeros (-0 at odd samples); 4 audio around |xp| =
    2^-80; 5 audio past 2^100; 6 one NaN at sample 1500 of the stream."""
    x = tx_level_block(gen, dev, C, T, t0)
    n = torch.arange(t0, t0 + T, device=dev)
    lo, hi = 2.0 ** -80 / pg, 2.0 ** 100 / pg
    special = torch.tensor(
        [0.0, -0.0, 1e-45, -3e-42, 1e-39, -1.1e-38, lo * (1 - 2 ** -12), lo,
         -lo * (1 + 2 ** -12), hi * (1 - 2 ** -12), -hi * (1 + 2 ** -12),
         3e38, -math.inf, math.inf], device=dev)
    cls = torch.arange(C, device=dev) % 9
    pick = n % 11 == 3
    x[(cls == 1)[:, None] & pick[None, :]] = special[
        (n // 11) % special.numel()].expand(C, T)[
        (cls == 1)[:, None] & pick[None, :]]
    x[cls == 2] *= 1e-43
    x[cls == 3] = torch.where(n % 2 == 1, -0.0, 0.0)
    x[cls == 4] = torch.randn((int((cls == 4).sum()), T), generator=gen,
                              device=dev) * (2.0 * lo)
    x[cls == 5] *= 2.0 ** 90
    if t0 <= 1500 < t0 + T:
        x[cls == 6, 1500 - t0] = math.nan
    return x.contiguous()


def alc_edge_val(C, dev):
    """Initial alc_val for alc_edge_block's stream: 1, but on channel
    classes 7 and 8 values outside [VAL_MIN, 1] (2, 5e-4, 0, a subnormal,
    -0.5, just below VAL_MIN), where the walker keeps div.rn."""
    v = torch.ones((C,), device=dev)
    c78 = torch.nonzero(torch.arange(C, device=dev) % 9 >= 7).flatten()
    outside = torch.tensor([2.0, 5e-4, 0.0, 1e-40, -0.5, 0.0009], device=dev)
    v[c78] = outside[torch.arange(c78.numel(), device=dev) % 6]
    return v


def alc_differ(ref, got) -> tuple[int, float]:
    """(elements whose bits differ, a NaN matching a NaN; max |err| over
    the elements finite in both)."""
    same = ((ref.view(torch.int32) == got.view(torch.int32))
            | (ref.isnan() & got.isnan()))
    fin = torch.isfinite(ref) & torch.isfinite(got)
    err = (ref[fin] - got[fin]).abs().max() if bool(fin.any()) else 0.0
    return int((~same).sum()), float(err)


def alc_stream(params, C, lengths, dev, gen, label, edge=False):
    """The fused ALC stage against its plain version over streamed blocks
    of the given lengths from a fresh state, bit for bit on y, alc_val
    and the new delay line (a fresh (C, D) tensor); with `edge`, on
    alc_edge_block's input from alc_edge_val's state.  Returns (the last
    alc_val, the first block's input, max |err|)."""
    D = params.delay
    vk = vp = alc_edge_val(C, dev) if edge else torch.ones((C,), device=dev)
    dk = dp = torch.zeros((C, D), device=dev)
    err, t0, first = 0.0, 0, None
    for blk, T in enumerate(lengths):
        x = (alc_edge_block(gen, dev, C, T, t0, params.postfilt_gain) if edge
             else tx_level_block(gen, dev, C, T, t0))
        t0 += T
        if first is None:
            first = x
        yk, vk, dk = alc_k.alc_run(params, vk, dk, x)
        yp, vp, dp = alc_k.alc_run_plain(params, vp, dp, x)
        torch.cuda.synchronize()
        diffs = {k: alc_differ(a, b) for k, (a, b) in
                 {"y": (yp, yk), "alc_val": (vp, vk),
                  "delay_buf": (dp, dk)}.items()}
        print(f"  ALC {label} block {blk} ({T} samples): "
              + ", ".join(f"{k} {n} differ (max|err| {e:.3e})"
                          for k, (n, e) in diffs.items()))
        err = max([err] + [e for _, e in diffs.values()])
        check(all(n == 0 for n, _ in diffs.values()),
              f"ALC {label} block {blk}: not bit-exact against its plain "
              "version")
        check(dk.shape == (C, D)
              and dk.untyped_storage().nbytes() == 4 * C * D,
              f"ALC {label}: the new delay line is not a fresh (C, D)")
    check(err == 0.0, f"ALC {label}: not bit-exact against its plain "
                      f"version (max|err| {err:.3e})")
    return vk, first, err


def alc_passes(params, v, delay_buf, x, gains):
    """PR 13's ALC stage without its kernel: the four torch passes that
    `mod/alc.py::run` ran around the gains-only launch (the post-filter
    gain, the gain scaling, the concatenation with the delay line, the
    delayed product), here on stand-in gains."""
    xp = x * params.postfilt_gain
    g = gains * params.gain_scaling
    xfull = torch.cat([delay_buf, xp], dim=-1)
    return xfull[..., :x.shape[-1]] * g, v, xfull[..., -params.delay:]


def phase_alc(P, dev, gen):
    """The fused ALC stage at 8192 channels, bit for bit against its plain
    version: the TX flagship's D = 288 over 4096 + 1000 + 4096 samples, AM's
    gain scaling 0.23 with D > T (100 + 37 + 100), inputs and states where
    the walker takes div.rn (alc_edge_block, 1000 + 777 + 1000; and with a
    negative decay, 300 + 77 + 300), and channels 0-7 alone against the
    batch; timed at the TX flagship's 16384 samples beside PR 13's torch
    passes around its gains-only kernel."""
    params = P["tx"].alc
    C, T = CHANNELS, 4096
    n_in, n_out, n_all = alc_k.alc_division_check(dev)
    print(f"  ALC division: the fast path against div.rn over {n_all} "
          f"inputs: {n_in} differ where the walker takes it, {n_out} "
          f"elsewhere")
    check(n_in == 0 and n_all == 0x7F800001,
          "ALC: the fast division is not div.rn's where it is used")
    vk, x0, err = alc_stream(params, C, (T, 1000, T), dev, gen, "D 288")
    check(float(vk.min()) < 0.9, "ALC: the gain never moved")
    am = tx.make_params(dataclasses.replace(TXF, mode="am"), dev).alc
    check(am.gain_scaling != 1.0 and am.delay > 100, "ALC: AM's params")
    err = max(err, alc_stream(am, C, (100, 37, 100), dev, gen,
                              "AM, D > T")[2])
    # where the walker takes div.rn: zeros, subnormals, the fast range's
    # edges, infinities, a NaN, alc_val outside [VAL_MIN, 1]; and a
    # negative decay, where it never takes the fast path
    vk, _, e = alc_stream(params, C, (1000, 777, 1000), dev, gen,
                          "edge inputs", edge=True)
    check(bool(vk[6::9].isnan().all()), "ALC: a NaN did not stay")
    neg = params._replace(decay=float(np.float32(-0.02)))
    err = max(err, e, alc_stream(neg, C, (300, 77, 300), dev, gen,
                                 "edge inputs, decay < 0", edge=True)[2])
    v1 = torch.ones((C,), device=dev)
    d1 = torch.zeros((C, params.delay), device=dev)
    y, v, d = alc_k.alc_run(params, v1, d1, x0)
    y8, v8, d8 = alc_k.alc_run(params, v1[:8], d1[:8], x0[:8].contiguous())
    torch.cuda.synchronize()
    check(torch.equal(y[:8], y8) and torch.equal(v[:8], v8)
          and torch.equal(d[:8], d8), "ALC: channels 0-7 alone differ "
                                      "from the batch")
    del y, v, d
    ms4k = cuda_ms(lambda: alc_k.alc_run(params, v1, d1, x0), 10)
    plain_ms = cuda_ms(lambda: alc_k.alc_run_plain(params, v1, d1, x0), 1)
    TB = TXF.block_len
    xb = tx_level_block(gen, dev, C, TB, 0)
    ms = cuda_ms(lambda: alc_k.alc_run(params, v1, d1, xb), 10)
    passes_ms = cuda_ms(lambda: alc_passes(params, v1, d1, xb, xb), 10)
    # bytes: x in, y out, the delay line in and out, the gain in and out;
    # f32 operations a step: the step's 15 (x pg, xp v, the division's
    # three FFMAs, q - 1, v decay, v ATTACK, the two products and
    # differences, the select, the two clamps) and the output's 3
    D = params.delay
    nbytes = 2 * C * TB * 4 + 2 * C * D * 4 + 2 * C * 4
    rec_ms = recurrence_ms(TB, ALC_STEP_OPS)
    geo = alc_k.alc_geometry(
        C, TB, torch.cuda.get_device_properties(dev).multi_processor_count)
    r = row("alc", "alc.cu", "uhsdr_tpu/mod/alc.py:72", err=err,
            snr=math.inf, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=18.0 * C * TB, recurrence_ms=rec_ms,
            library_note="no PyTorch call computes the ALC recurrence",
            tpu_kernel=False, plain_steps=T, ms_4096=ms4k,
            pr13_torch_passes_ms=passes_ms, lanes=geo.lanes,
            blocks=geo.blocks, division_differs_outside=n_out)
    print(f"  ALC (fused): {ms:.4f} ms at {TB} steps, {ms4k:.4f} ms at {T} "
          f"(plain {plain_ms:.1f} ms at {T}; PR 13's four torch passes "
          f"{passes_ms:.4f} ms; recurrence bound {rec_ms:.4f} ms; "
          f"{r['bound_by']} bound {r['bound_ms']:.4f} ms; {geo.lanes} "
          f"lanes a walker, {geo.blocks} blocks)")
    return r


def phase_blocked(P, dev, gen):
    """K2 at the SSB flagship's PreFilter (8192 ch x 2048 samples, 5
    sections): three streamed blocks of 1920, 2176 and 2048 samples (no
    multiple of 8 chunks, the first two) against its plain version (the
    cuBLAS matmuls and the 16-step carry loop the chains ran before K2);
    channels 0-7 run alone bit-equal to their place in the batch; the
    library's shared memory `blocked_geometry`'s for 1-8 sections.  Then
    two streamed blocks and the times at every other path's cascade
    shape: the AM/SAM PreFilter (8192 x 4096), ssbstereo's (8192 x 2 x
    2048), FM's 2-section squelch HPF (8192 x 8192), the TX SOPRANO voice
    bandpass (8192 x 16384) and the fleet's PreFilter (1024 x 4096) and
    squelch HPF (1024 x 16384)."""
    C = CHANNELS
    c = P["ssb"].audio_sos
    S = c.sections
    lib = iir_k._blocked_lib()
    for sec in range(1, iir_k.BLOCKED_MAX_SECTIONS + 1):
        check(lib.uhsdr_blocked_smem(sec) == iir_k.blocked_smem(sec),
              f"K2 shared memory for {sec} sections: library "
              f"{lib.uhsdr_blocked_smem(sec)}, rule "
              f"{iir_k.blocked_smem(sec)}")
    sk = sp = torch.zeros((S, C, 2), device=dev)
    worst, err, first = math.inf, 0.0, None
    for blk, T in enumerate((1920, 2176, 2048)):
        x = torch.randn((C, T), generator=gen, device=dev) * 0.1
        if first is None or T == 2048:
            first = (sk, x)
        s_in = sk
        yk, sk = iir_k.blocked_cascade(c, sk, x)
        yp, sp = iir_k.blocked_cascade_plain(c, sp, x)
        ya, sa = iir_k.blocked_cascade(c, s_in[:, :8].contiguous(),
                                       x[:8].contiguous())
        torch.cuda.synchronize()
        s, e = held(f"K2 PreFilter block {blk} ({T} samples)",
                    {"audio": (yp, yk), "state": (sp, sk)})
        check(torch.equal(ya, yk[:8]) and torch.equal(sa, sk[:, :8]),
              f"K2 block {blk}: channels 0-7 alone differ from the batch")
        worst, err = min(worst, s), max(err, e)
    print("  K2 channels 0-7 alone bit-equal to the batch in every block; "
          "shared memory as blocked_geometry for 1-8 sections")
    s0, x0 = first
    T = x0.shape[-1]
    ms = cuda_ms(lambda: iir_k.blocked_cascade(c, s0, x0), 20)
    plain_ms = cuda_ms(lambda: iir_k.blocked_cascade_plain(c, s0, x0), 5)
    nbytes, flops = trace_blocked.blocked_work(S, C, T)
    shapes = {}
    fleet = pfleet.FLEET_GROUP_CHANNELS
    usb48, fm48 = (rx.make_params(pfleet.FLEET_MIX[k], dev) for k in (0, -1))
    others = (("am", P["sam"].audio_sos, (C, SAM.block_len // SAM.decim)),
              ("ssbstereo", P["stereo"].audio_sos,
               (C, 2, STEREO.block_len // STEREO.decim)),
              ("fm_squelch", P["fm"].fm.squelch_sos,
               (C, FM.block_len // FM.decim)),
              ("tx_voice", P["tx"].voice_sos, (C, TXF.block_len)),
              ("fleet", usb48.audio_sos,
               (fleet, FLEET_BLOCK // pfleet.FLEET_MIX[0].decim)),
              ("fleet_squelch", fm48.fm.squelch_sos,
               (fleet, FLEET_BLOCK // pfleet.FLEET_MIX[-1].decim)))
    for label, cs, shape in others:
        Sk = cs.sections
        sko = spo = st = torch.zeros((Sk,) + shape[:-1] + (2,), device=dev)
        for blk in range(2):
            x = torch.randn(shape, generator=gen, device=dev) * 0.1
            yk, sko = iir_k.blocked_cascade(cs, sko, x)
            yp, spo = iir_k.blocked_cascade_plain(cs, spo, x)
            torch.cuda.synchronize()
            s, e = held(f"K2 {label} {tuple(shape)} {Sk} sections block "
                        f"{blk}", {"audio": (yp, yk), "state": (spo, sko)})
            worst, err = min(worst, s), max(err, e)
            del yk, yp
        k_ms = cuda_ms(lambda: iir_k.blocked_cascade(cs, st, x), 10)
        p_ms = cuda_ms(lambda: iir_k.blocked_cascade_plain(cs, st, x), 3)
        Ck = x.numel() // shape[-1]
        nb, fl = trace_blocked.blocked_work(Sk, Ck, shape[-1])
        b_ms, b_by = bound(nb, fl)
        geo = iir_k.blocked_geometry(Ck, shape[-1], Sk)
        shapes[label] = dict(shape=list(shape), sections=Sk, ms=k_ms,
                             plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                             cpw=geo.cpw, tr=geo.tr, blocks=geo.blocks)
        print(f"  K2 {label} {tuple(shape)} {Sk} sections, {geo.cpw} ch x "
              f"{geo.tr} chunks a round, {geo.blocks} blocks: {k_ms:.4f} "
              f"ms (plain {p_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}: "
              f"{fl / 2e9:.2f} G FMA, {nb / 2**20:.0f} MiB)")
        del x, st, sko, spo
    r = row("blocked", "blocked.cu", "uhsdr_tpu/pallas/iir.py:224", err=err,
            snr=worst, ms=ms, plain_ms=plain_ms, nbytes=nbytes, flops=flops,
            library_note="no one PyTorch call runs an SOS cascade (the "
                         "plain version is the cuBLAS matmul form)",
            shapes=shapes)
    geo = iir_k.blocked_geometry(C, T, S)
    print(f"  K2 blocked PreFilter ({C} x {T}, {S} sections), {geo.cpw} ch "
          f"x {geo.tr} chunks a round, {geo.blocks} blocks: {ms:.4f} ms "
          f"(plain {plain_ms:.3f} ms, bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']}: {flops / 2e9:.2f} G FMA, "
          f"{nbytes / 2**20:.0f} MiB)")
    return r


def phase_biquad_grouped(P, dev, gen):
    """K14 at SAM's stacked allpass shape (16384 x 4096, both coefficient
    sets), three streamed blocks (the middle one of 1000 samples ends
    inside a group) against its plain version and against K11."""
    C, T = 2 * CHANNELS, SAM.block_len // SAM.decim
    worst, err, times = math.inf, 0.0, {}
    for cset, sos in enumerate(P["sam"].sam.ap_sos):
        S = sos.shape[0]
        sk = sp = sq = torch.zeros((S, C, 2), device=dev)
        first = None
        for blk, Tk in enumerate((T, 1000, T)):
            x = torch.randn((C, Tk), generator=gen, device=dev) * 0.1
            if first is None:
                first = (sk, x)
            yk, sk = iir_k.biquad_cascade(sos, sk, x, impl="grouped")
            yp, sp = iir_k.biquad_grouped_plain(sos, sp, x)
            yq, sq = iir_k.biquad_cascade(sos, sq, x)
            torch.cuda.synchronize()
            s, e = held(f"K14 set {cset} block {blk} ({Tk} samples)",
                        {"audio": (yp, yk), "state": (sp, sk),
                         "audio vs K11": (yq, yk), "state vs K11": (sq, sk)})
            worst, err = min(worst, s), max(err, e)
            del yk, yp, yq
        s0, x0 = first
        times[cset] = (cuda_ms(lambda: iir_k.biquad_cascade(
            sos, s0, x0, impl="grouped"), 10),
            cuda_ms(lambda: iir_k.biquad_grouped_plain(sos, s0, x0), 2),
            cuda_ms(lambda: iir_k.biquad_cascade(sos, s0, x0), 10))
    ms, plain_ms, k11_ms = times[0]
    S = P["sam"].sam.ap_sos[0].shape[0]
    nbytes = 2 * C * T * 4 + 2 * S * C * 2 * 4
    r = row("biquad_grouped", "biquad.cu", "uhsdr_tpu/pallas/iir.py:112",
            err=err, snr=worst, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            # about 13 f32 operations a sample and section: the local
            # scan 7, the correction 4, the output 2
            flops=13.0 * S * C * T, library_note="torch has no IIR filter "
                                                 "call", k11_ms=k11_ms,
            set1=dict(ms=times[1][0], plain_ms=times[1][1],
                      k11_ms=times[1][2]))
    print(f"  K14 biquad_grouped ({S} sections, {C} x {T}, groups of 32): "
          f"{ms:.4f} ms, set 1 {times[1][0]:.4f} ms (K11 {k11_ms:.4f} / "
          f"{times[1][2]:.4f} ms; plain {plain_ms:.1f} ms; bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']})")
    return r


def phase_front_mt(P, dev, gen):
    """K15 at the SSB flagship's front (8192 ch x 16384 int16, 227 + 199
    taps, decimation 8): three streamed blocks, the middle one of 800
    samples (shorter than the stage-A history's span at the decimated
    rate), against its plain version."""
    params = P["ssb"]
    C, B, decim = CHANNELS, CFG.block_len, CFG.decim
    h, g, delta = params.front_fir, params.front2, params.nco_delta
    taps, taps2 = h.shape[-1], g.shape[-1]
    ck = cp = torch.zeros((C, taps - 1), dtype=torch.complex64, device=dev)
    c2k = c2p = torch.zeros((C, taps2 - 1), dtype=torch.complex64,
                            device=dev)
    phase = torch.zeros((C,), dtype=torch.int64, device=dev)
    worst, err, first = math.inf, 0.0, None
    for blk, Bk in enumerate((B, 800, B)):
        xi, xq = iq_block(gen, dev, C, Bk)
        if first is None:
            first = (ck, c2k, xi, xq, phase)
        yk, ck, c2k, pk_k = fir_k.front_mt(h, g, ck, c2k, xi, xq, phase,
                                           delta, decim)
        yp, cp, c2p, pk_p = fir_k.front_mt_plain(h, g, cp, c2p, xi, xq,
                                                 phase, delta, decim)
        torch.cuda.synchronize()
        check(tuple(yk.shape) == (C, Bk // decim),
              f"K15 output {tuple(yk.shape)}")
        s, e = held(f"K15 block {blk} ({Bk} samples)", {
            "audio": (yp, yk), "raw carry": (cp, ck),
            "front2 carry": (c2p, c2k), "peaks": (pk_p, pk_k)})
        worst, err = min(worst, s), max(err, e)
        phase = nco.advance(phase, delta, Bk)
    ck0, c2k0, xi, xq, ph0 = first
    ms = cuda_ms(lambda: fir_k.front_mt(h, g, ck0, c2k0, xi, xq, ph0, delta,
                                        decim), 10)
    plain_ms = cuda_ms(lambda: fir_k.front_mt_plain(h, g, ck0, c2k0, xi, xq,
                                                    ph0, delta, decim), 2)
    k1_ms = cuda_ms(lambda: fir_k.front(h, g, ck0, c2k0, xi, xq, ph0, delta,
                                        decim), 10)
    # work: stage A with complex taps, 4 FMAs a tap per output; stage B as
    # K1's; bytes as K1's plus the sine taps
    T_out = B // decim
    fma = C * T_out * (4 * taps + 2 * taps2)
    nbytes = (2 * C * B * 2 + C * T_out * 4 + 2 * C * (taps - 1) * 8
              + 2 * C * (taps2 - 1) * 8 + C * 8 + C * 4
              + 4 * (2 * taps + 2 * taps2))
    r = row("front_mt", "front.cu", "uhsdr_tpu/pallas/fir.py:287", err=err,
            snr=worst, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=2.0 * fma, k1_ms=k1_ms,
            library_note="no one PyTorch call mixes, decimates and runs "
                         "both FIR stages")
    print(f"  K15 front_mt: {ms:.4f} ms (K1 {k1_ms:.4f} ms in this call; "
          f"plain {plain_ms:.3f} ms, bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']}: {fma / 1e9:.2f} G FMA, "
          f"{nbytes / 2**20:.0f} MiB)")
    return r


# ---------------------------------------------------------------------------
# the main paths
# ---------------------------------------------------------------------------

def state_snrs(ref: dict, got: dict) -> dict:
    """{leaf: SNR dB} of two `rx.state_to_numpy` dicts; the PLL phase
    through its cosine and sine; integer leaves (the NCO phases, FM's
    counters) and boolean ones (FM's squelch and tone decisions) by
    equality."""
    out = {}
    for f, a in ref.items():
        b = got[f]
        if a.dtype == bool or a.dtype.kind in "iu":
            out[f] = math.inf if np.array_equal(a, b) else -math.inf
        elif f == "sam.phs":
            out[f] = snr_db(np.stack([np.cos(a), np.sin(a)]),
                            np.stack([np.cos(b), np.sin(b)]))
        else:
            out[f] = snr_db(a, b)
    return out


def timed_run(step, blocks, label, expect, n_warm, n_timed):
    """Set every kernel's launch count to 0, run `step(block)` over the
    warm-up blocks and then the timed ones between CUDA events, read the
    counts and check that each kernel of `expect`, and no other, was
    launched.  Returns (launches, ms/block: the mean over the timed
    window, the last step's result); prints each timed block, their
    median and the caching allocator's device allocations (cudaMalloc
    calls, each of which waits for the card) inside the window."""
    kernels = build.kernels()
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    gc.collect()    # keep earlier phases' garbage out of the timed window
    for blk in blocks[:n_warm]:
        step(blk)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n_timed + 1)]
    allocs0 = torch.cuda.memory_stats().get("num_device_alloc", 0)
    marks[0].record()
    for k, blk in enumerate(blocks[n_warm:]):
        out = step(blk)
        marks[k + 1].record()
    marks[-1].synchronize()
    allocs = torch.cuda.memory_stats().get("num_device_alloc", 0) - allocs0
    launches = {k.name: k.launches for k in kernels}
    each = [marks[k].elapsed_time(marks[k + 1]) for k in range(n_timed)]
    mean = marks[0].elapsed_time(marks[-1]) / n_timed
    print(f"  {label} ms of each timed block: "
          + " ".join(f"{t:.3f}" for t in each)
          + f" (mean {mean:.3f}, median {float(np.median(each)):.3f}); "
          f"device allocations in the window: {allocs}")
    print(f"  {label} launches: {launches}")
    for name in expect:
        check(launches[name] > 0, f"{label} never launched kernel {name}")
    for name, n in launches.items():
        check(n == 0 or name in expect,
              f"{label} launched {name}, which is not on its path")
    return launches, mean, out


def main_path(cfg, label, expect, dev, seed, n_timed, C, n_warm=2, n_ref=3,
              ref_ch=8):
    """Drive `RxChain(cfg)` on the card at C channels; returns (launches
    of every kernel on this path, ms/block, Ms/s, worst SNR against the
    port's CPU chain)."""
    B = cfg.block_len
    fm = cfg.mode == "fm"
    out_len, fs_out = ((B // cfg.decim, cfg.fs_dec) if fm
                       else (B, cfg.iq_rate))
    out_shape = (C,) + ((2,) if cfg.n_audio > 1 else ()) + (out_len,)
    blocks = trace_rx.capture(n_warm + n_timed, C, dev, seed, cfg)
    chain = rx.RxChain(cfg, device=dev)
    state = chain.init_state((C,))
    kept, kept_state = [], None

    def step(blk):
        nonlocal state, kept_state
        audio, state, taps = chain(state, i=blk[0], q=blk[1])
        if len(kept) < n_ref:
            kept.append(audio[:ref_ch].clone())
            if len(kept) == n_ref:
                # every block's state is made of new tensors, so holding
                # this one costs no copy inside the timed window
                kept_state = state
        return audio, taps

    launches, ms_block, (audio, taps) = timed_run(step, blocks, label, expect,
                                                  n_warm, n_timed)
    msps = C * B / (ms_block * 1e-3) / 1e6

    check(tuple(audio.shape) == out_shape,
          f"audio shape {tuple(audio.shape)}")
    check(bool(torch.isfinite(audio).all()), f"{label} audio not finite")
    for f, v in rx.state_to_numpy(state).items():
        check(bool(np.isfinite(v).all()), f"{label} state {f} not finite")
    # FM reports no ADC peaks, as the reference's FM branch
    check(fm != ("adc_peak" in taps), f"{label} taps {sorted(taps)}")
    if not fm:
        check(bool(torch.isfinite(taps["adc_peak"]).all()), "adc_peak")

    # the same channels through the port's plain versions on the CPU
    cpu = rx.RxChain(cfg, device="cpu")
    s_cpu = cpu.init_state((ref_ch,))
    worst = math.inf
    for blk in range(n_ref):
        i, q = blocks[blk]
        y_cpu, s_cpu, _ = cpu(s_cpu, i=i[:ref_ch].cpu(), q=q[:ref_ch].cpu())
        s = snr_db(y_cpu, kept[blk].cpu())
        worst = min(worst, s)
        print(f"  {label} vs CPU chain, block {blk}, ch 0-{ref_ch - 1}: "
              f"SNR {s:.1f} dB")

    def ref_channels(v):
        return np.take(v, range(ref_ch), axis=v.shape.index(C))

    leaves = state_snrs(rx.state_to_numpy(s_cpu),
                        {f: ref_channels(v) for f, v in
                         rx.state_to_numpy(kept_state).items()})
    low = min(leaves, key=leaves.get)
    print(f"  {label} state after block {n_ref - 1} vs CPU chain: worst "
          f"leaf {low} {leaves[low]:.1f} dB of {len(leaves)}")
    worst = min(worst, leaves[low])
    check(worst >= CHAIN_TOL_DB,
          f"{label} vs CPU chain: {worst:.1f} dB < {CHAIN_TOL_DB} dB")
    # the last block: with subtone detection the audio opens only after
    # two detection windows; two-channel audio: the left channel (USB,
    # filtered I, SAM's LSB), which carries the tone in each
    y0 = audio[0].reshape(-1, out_len)[0].cpu().double().numpy()
    spec = np.abs(np.fft.rfft((y0 - y0.mean()) * np.hanning(len(y0))))
    freqs = np.fft.rfftfreq(len(y0), 1.0 / fs_out)
    spec[freqs < 100.0] = 0.0           # AM: what is left of the carrier
    f_pk = float(freqs[spec.argmax()])
    tone = trace_rx.tone_hz(cfg)
    print(f"  {label} channel 0 audio peak {f_pk:.1f} Hz (tone {tone} Hz)")
    check(abs(f_pk - tone) < 20.0, f"{label} tone at {f_pk} Hz, not {tone}")
    return launches, ms_block, msps, worst, n_warm + n_timed


def grouped_path(P, dev, seed, n_timed=4, n_warm=2):
    """The entry path of K14: SAM usb's stacked allpass inputs (16384 x
    4096: its four paths, two per coefficient set) through
    `biquad_cascade(impl="grouped")`, one call per coefficient set a
    block, state carried; the last block's outputs and the final states
    held against K11 over the same blocks.  No block's output outlives
    the next block, so the timed blocks allocate no new device memory.
    Returns (launches, ms/block, worst SNR against K11, blocks run)."""
    sos = P["sam"].sam.ap_sos
    C, T = 2 * CHANNELS, SAM.block_len // SAM.decim
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    blocks = [[torch.randn((C, T), generator=gen, device=dev) * 0.1
               for _ in sos] for _ in range(n_warm + n_timed)]
    states = [torch.zeros((s.shape[0], C, 2), device=dev) for s in sos]

    def step(blk):
        ys = []
        for k, (s, x) in enumerate(zip(sos, blk)):
            y, states[k] = iir_k.biquad_cascade(s, states[k], x,
                                                impl="grouped")
            ys.append(y)
        return ys

    launches, ms_block, ys = timed_run(step, blocks, "biquad_grouped",
                                       ("biquad_grouped",), n_warm, n_timed)
    check(all(bool(torch.isfinite(y).all()) for y in ys + states),
          "biquad_grouped: output or state not finite")
    # the same blocks through K11, outside the counted window
    ref = [torch.zeros((s.shape[0], C, 2), device=dev) for s in sos]
    for blk in blocks:
        y_ref = []
        for k, (s, x) in enumerate(zip(sos, blk)):
            y, ref[k] = iir_k.biquad_cascade(s, ref[k], x)
            y_ref.append(y)
    worst = min(*(snr_db(a, b) for a, b in zip(y_ref, ys)),
                *(snr_db(r, st) for r, st in zip(ref, states)))
    print(f"  biquad_grouped vs K11: worst SNR {worst:.1f} dB (the last "
          f"block and the final states)")
    check(worst >= KERNEL_TOL_DB,
          f"biquad_grouped vs K11: {worst:.1f} dB < {KERNEL_TOL_DB} dB")
    return launches, ms_block, worst, n_warm + n_timed


def tx_vs_cpu(cfg, label, blocks, kept, kept_state, C):
    """The first channels of `blocks` (each (C, T) audio) through a CPU
    `TxChain(cfg)`: its (i + j q) against `kept` (the card's, one (ref_ch,
    T) tensor a block) and its state after them against `kept_state`
    (the card's, all C channels), every leaf; held >= CHAIN_TOL_DB.
    Returns the worst SNR."""
    ref_ch = kept[0].shape[0]
    cpu = tx.TxChain(cfg, device="cpu")
    s_cpu = cpu.init_state((ref_ch,))
    worst = math.inf
    for blk, got in enumerate(kept):
        ic, qc, s_cpu = cpu(s_cpu, blocks[blk][:ref_ch].cpu())
        s = snr_db(torch.complex(ic, qc), got.cpu())
        worst = min(worst, s)
        print(f"  {label} vs CPU chain, block {blk}, ch 0-{ref_ch - 1}: "
              f"SNR {s:.1f} dB")
    leaves = state_snrs(tx.state_to_numpy(s_cpu),
                        {f: v[:ref_ch] if v.shape[0] == C else
                         np.take(v, range(ref_ch), axis=1)
                         for f, v in tx.state_to_numpy(kept_state).items()})
    low = min(leaves, key=leaves.get)
    print(f"  {label} state after block {len(kept) - 1} vs CPU chain: worst "
          f"leaf {low} {leaves[low]:.1f} dB of {len(leaves)}")
    worst = min(worst, leaves[low])
    check(worst >= CHAIN_TOL_DB,
          f"{label} vs CPU chain: {worst:.1f} dB < {CHAIN_TOL_DB} dB")
    return worst


def tx_path(cfg, label, expect, dev, seed, n_timed, C, n_warm=2, n_ref=3,
            ref_ch=8):
    """Drive `TxChain(cfg)` on the card at C channels; returns (launches
    of every kernel on this path, ms/block, Ms/s of audio in, worst SNR
    against the port's CPU chain), as `main_path` does for RX."""
    B = cfg.block_len
    blocks = trace_tx.capture(n_warm + n_timed, C, dev, seed, cfg)
    chain = tx.TxChain(cfg, device=dev)
    state = chain.init_state((C,))
    kept, kept_state = [], None

    def step(audio):
        nonlocal state, kept_state
        i, q, state = chain(state, audio)
        if len(kept) < n_ref:
            kept.append(torch.complex(i[:ref_ch], q[:ref_ch]))
            if len(kept) == n_ref:
                kept_state = state
        return i, q

    launches, ms_block, (i, q) = timed_run(step, blocks, label, expect,
                                           n_warm, n_timed)
    msps = C * B / (ms_block * 1e-3) / 1e6
    check(tuple(i.shape) == (C, B) and tuple(q.shape) == (C, B),
          f"IQ shape {tuple(i.shape)}")
    check(bool(torch.isfinite(i).all() and torch.isfinite(q).all()),
          f"{label} IQ not finite")
    for f, v in tx.state_to_numpy(state).items():
        check(bool(np.isfinite(v).all()), f"{label} state {f} not finite")

    worst = tx_vs_cpu(cfg, label, blocks, kept, kept_state, C)
    z = (i[0] + 1j * q[0]).cpu().to(torch.complex128).numpy()
    spec = np.abs(np.fft.fft(z * np.hanning(len(z))))
    f_pk = float(np.fft.fftfreq(len(z), 1.0 / tx.IQ_RATE)[spec.argmax()])
    want = trace_tx.expected_peak_hz(cfg)
    print(f"  {label} channel 0 IQ peak {f_pk:.1f} Hz (expected {want} Hz)")
    check(abs(f_pk - want) < 20.0, f"{label} peak at {f_pk} Hz, not {want}")
    return launches, ms_block, msps, worst, n_warm + n_timed


# ---------------------------------------------------------------------------
# the fleet, wideband and per-channel AGC paths
# ---------------------------------------------------------------------------

def fleet_configs() -> list:
    return [dataclasses.replace(c, block_len=FLEET_BLOCK)
            for c in pfleet.FLEET_MIX]


def tone_peak_hz(y: torch.Tensor, fs: float) -> float:
    """The strongest audio frequency above 100 Hz of a channel's block."""
    y0 = y.cpu().double().numpy()
    spec = np.abs(np.fft.rfft((y0 - y0.mean()) * np.hanning(len(y0))))
    freqs = np.fft.rfftfreq(len(y0), 1.0 / fs)
    spec[freqs < 100.0] = 0.0
    return float(freqs[spec.argmax()])


def fleet_path(label, fused, blocks, dev, n_timed, n_warm=2, n_ref=2,
               ref_ch=8):
    """Drive `ChannelFleet` on the card, six groups of 1024 channels, by
    `step_fused` (cross-group stage batching) or `step_separate` (each
    group's chain); keeps channels 0-7 of each group's audio for the
    warm-up blocks and the states after them.  Returns (launches,
    ms/block, Ms/s of input samples, kept audio, kept states)."""
    cfgs = fleet_configs()
    C = FLEET_GROUP_CHANNELS
    fl = pfleet.ChannelFleet(cfgs, np.repeat(np.arange(len(cfgs)), C),
                             device=dev)
    step_fn = fl.step_fused if fused else fl.step_separate
    kept, kept_states = [], []

    def step(planes):
        outs = step_fn(planes)
        if len(kept) < n_ref:
            kept.append([o[:ref_ch].clone() for o in outs])
            if len(kept) == n_ref:
                # channels 0-7 of each state leaf, copied to the host in
                # the last warm-up block: no state outlives its block
                kept_states.extend(first_channels(g, ref_ch)
                                   for g in fl.groups)
        return outs

    expect = FLEET_KERNELS if fused else FLEET_SEPARATE_KERNELS
    launches, ms_block, outs = timed_run(step, blocks, label, expect, n_warm,
                                         n_timed)
    msps = C * len(cfgs) * FLEET_BLOCK / (ms_block * 1e-3) / 1e6
    for g, y in zip(fl.groups, outs):
        check(tuple(y.shape) == (C, FLEET_BLOCK),
              f"{label} {g.cfg.mode} audio {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), f"{label} {g.cfg.mode} audio")
        for f, v in rx.state_to_numpy(g.state).items():
            check(bool(np.isfinite(v).all()),
                  f"{label} {g.cfg.mode} state {f} not finite")
        f_pk = tone_peak_hz(y[0], g.cfg.iq_rate)
        tone = trace_rx.tone_hz(g.cfg)
        print(f"  {label} {g.cfg.mode} channel 0 audio peak {f_pk:.1f} Hz "
              f"(tone {tone} Hz)")
        check(abs(f_pk - tone) < 20.0,
              f"{label} {g.cfg.mode} tone at {f_pk} Hz, not {tone}")
    return launches, ms_block, msps, kept, kept_states


def first_channels(group, n: int) -> dict:
    """`rx.state_to_numpy` of a fleet group's state, its channels 0..n-1
    (the channel axis: the one of the group's width)."""
    C = group.channel_idx.size
    return {f: np.take(v, range(n), axis=v.shape.index(C))
            for f, v in rx.state_to_numpy(group.state).items()}


def fleet_vs_cpu(label, cfgs, blocks, kept, kept_states, ref_ch=8):
    """Channels 0-7 of each group (blocks[b][g]: group g's (i, q) of
    block b, their first ref_ch rows taken) through the port's fused
    fleet on the CPU (plain versions) over the blocks kept: audio and
    every state leaf >= CHAIN_TOL_DB.  Returns the worst SNR."""
    cpu = pfleet.ChannelFleet(cfgs, np.repeat(np.arange(len(cfgs)), ref_ch),
                              device="cpu")
    worst = math.inf
    for b, ys in enumerate(kept):
        outs = cpu.step_fused([(i[:ref_ch].cpu(), q[:ref_ch].cpu())
                               for i, q in blocks[b]])
        for g, y_cpu, y in zip(cpu.groups, outs, ys):
            s = snr_db(y_cpu, y.cpu())
            worst = min(worst, s)
            print(f"  {label} vs CPU fleet, block {b}, {g.cfg.mode} ch 0-"
                  f"{ref_ch - 1}: SNR {s:.1f} dB")
    for g, st in zip(cpu.groups, kept_states):
        leaves = state_snrs(rx.state_to_numpy(g.state), st)
        low = min(leaves, key=leaves.get)
        print(f"  {label} {g.cfg.mode} state vs CPU fleet: worst leaf {low} "
              f"{leaves[low]:.1f} dB of {len(leaves)}")
        worst = min(worst, leaves[low])
    check(worst >= CHAIN_TOL_DB,
          f"{label} vs CPU fleet: {worst:.1f} dB < {CHAIN_TOL_DB} dB")
    return worst


def fleet_lockstep(blocks, dev):
    """`step_fused` and `step_separate` on two fresh fleets over the same
    blocks, outside the timed runs: each group's audio and every state
    leaf compared after every block, bit for bit (every kernel computes a
    channel on its own, so the batching must change no bit; a leaf that
    differs would be held at >= 120 dB and named).  Also records the
    merged AGC's K3 calls: one a block, with (3, 5120) rows.  Returns
    (equal leaves and outputs, compared, the rows shapes seen)."""
    cfgs = fleet_configs()
    assign = np.repeat(np.arange(len(cfgs)), FLEET_GROUP_CHANNELS)
    a = pfleet.ChannelFleet(cfgs, assign, device=dev)
    b = pfleet.ChannelFleet(cfgs, assign, device=dev)
    rows_seen = []
    real = agc_k.agc

    def spy(p, carry, delay, x, rows=None):
        if rows is not None:
            rows_seen.append(tuple(rows.shape))
        return real(p, carry, delay, x, rows)

    n_eq = n_all = 0
    agc_k.agc = spy
    try:
        for k, planes in enumerate(blocks):
            ya = a.step_fused(planes)
            agc_k.agc = real
            yb = b.step_separate(planes)
            agc_k.agc = spy
            pairs = {f"{g.cfg.mode} audio": (y2.cpu().numpy(),
                                             y1.cpu().numpy())
                     for g, y1, y2 in zip(a.groups, ya, yb)}
            for ga, gb in zip(a.groups, b.groups):
                sa, sb = rx.state_to_numpy(ga.state), rx.state_to_numpy(
                    gb.state)
                check(sa.keys() == sb.keys(), "fleet state leaves differ")
                pairs.update({f"{ga.cfg.mode} {f}": (sb[f], sa[f])
                              for f in sa})
            for what, (x1, x2) in pairs.items():
                n_all += 1
                if np.array_equal(x1, x2):
                    n_eq += 1
                    continue
                s = (snr_db(x1, x2) if x1.dtype.kind in "fc"
                     else -math.inf)
                print(f"  fleet vs fleet_separate block {k}: {what} not "
                      f"bit-equal, SNR {s:.1f} dB")
                check(s >= 120.0, f"fleet vs fleet_separate: {what} "
                                  f"{s:.1f} dB < 120 dB")
    finally:
        agc_k.agc = real
    print(f"  fleet vs fleet_separate over {len(blocks)} blocks: {n_eq} of "
          f"{n_all} outputs and state leaves bit-equal; merged K3 rows "
          f"{sorted(set(rows_seen))}, {len(rows_seen)} calls")
    n_rows = sum(c.mode != "fm" for c in cfgs) * FLEET_GROUP_CHANNELS
    check(rows_seen == [(3, n_rows)] * len(blocks),
          f"fleet: merged K3 calls with rows {rows_seen}")
    return n_eq, n_all


def direct_channel(h: torch.Tensor, x: torch.Tensor, m: int, M: int):
    """Channel m of an M-channel analysis bank in its direct form: mix
    down by exp(-j 2 pi m i / M), filter by the prototype h, decimate by M
    from an empty history (the port's copy of
    tests/test_channelizer.py::_direct_channel)."""
    i = torch.arange(x.shape[-1], device=x.device, dtype=torch.float64)
    mixed = (x.to(torch.complex128)
             * torch.exp(-2j * math.pi * m * i / M)).to(torch.complex64)
    carry = torch.zeros(x.shape[:-1] + (h.shape[-1] - 1,),
                        dtype=torch.complex64, device=x.device)
    y, _ = fir_ops.fir_decimate_block(h, carry, mixed, M)
    return y


def wideband_path(dev, seed, n_timed, n_warm=2, n_ref=2, ref_ch=8):
    """Drive `WidebandFleet` on the card: one wideband stream of 16.8 M
    samples a block (seeded noise at 0.1 rms a plane) through the 4096-
    channel analysis bank into usb (2730 channels) and am (1366): the
    fused step; the step is `process_block_device`'s two halves, so that
    channels 0-7 of each group's bank planes and audio, and the states,
    are kept over the first n_ref blocks.  Those planes then go through
    the port's CPU fleet (audio and every state leaf >= CHAIN_TOL_DB),
    and the bank's first block, from zero state, is held against the
    direct form on 8 channels (>= CHAIN_TOL_DB).  Returns (launches,
    ms/block, Ms/s of wideband samples, worst SNR of the fleet, worst
    SNR of the bank)."""
    n_usb = pfleet.wideband_counts(WB_M)[0]
    cfgs = [dataclasses.replace(c, block_len=WB_T)
            for c in pfleet.WIDEBAND_MIX]
    wf = pfleet.WidebandFleet(cfgs, pfleet.wideband_counts(WB_M), device=dev)
    B = wf.wideband_block
    blocks = trace_rx.wideband_capture(n_warm + n_timed, B, dev, seed)
    kept_planes, kept, kept_states = [], [], []

    def step(blk):
        planes = wf.channel_planes(*blk)
        outs = wf.fleet.process_block_device(planes)
        if len(kept) < n_ref:
            kept_planes.append([(i[:ref_ch].clone(), q[:ref_ch].clone())
                                for i, q in planes])
            kept.append([y[:ref_ch].clone() for y in outs])
            if len(kept) == n_ref:
                kept_states.extend(first_channels(g, ref_ch)
                                   for g in wf.groups)
        return outs

    launches, ms_block, outs = timed_run(step, blocks, "wideband",
                                         WIDEBAND_KERNELS, n_warm, n_timed)
    msps = B / (ms_block * 1e-3) / 1e6
    check([tuple(y.shape) for y in outs] == [(n_usb, WB_T),
                                             (WB_M - n_usb, WB_T)],
          f"wideband audio {[tuple(y.shape) for y in outs]}")
    check(all(bool(torch.isfinite(y).all()) for y in outs),
          "wideband audio not finite")
    for g in wf.groups:
        for f, v in rx.state_to_numpy(g.state).items():
            check(bool(np.isfinite(v).all()),
                  f"wideband {g.cfg.mode} state {f} not finite")
    worst_fleet = fleet_vs_cpu("wideband", cfgs, kept_planes, kept,
                               kept_states, ref_ch)
    x0 = torch.complex(*blocks[0])
    y, _ = wf.bank(wf.bank.init_state(), x0)
    h = torch.as_tensor(wf.bank.prototype, device=dev)
    worst = math.inf
    for m in (0, 1, 2, n_usb - 1, n_usb, WB_M // 2, WB_M - 2, WB_M - 1):
        s = snr_db(direct_channel(h, x0, m, WB_M), y[m])
        worst = min(worst, s)
        print(f"  wideband bank channel {m} vs the direct form: SNR "
              f"{s:.1f} dB")
    check(worst >= CHAIN_TOL_DB,
          f"wideband bank vs direct form: {worst:.1f} dB < {CHAIN_TOL_DB}")
    return launches, ms_block, msps, worst_fleet, worst


def wideband_tx_path(dev, seed, n_timed, n_warm=2, n_ref=2, ref_ch=8):
    """Drive `WidebandTxFleet` on the card: 4096 channels of the TX
    flagship (usb, reference front, 6 kHz translate) at 4096 samples,
    trace_tx's tones, through the synthesis bank to 16.8 M wideband IQ
    samples a block; the step is `process_block_device`'s two halves, so
    that channels 0-7 of the chains' (i, q) before the bank are kept over
    the first n_ref blocks and held, with the state after them, against
    the port's CPU `TxChain` (>= CHAIN_TOL_DB).  Channel 0's tone must
    land at its channel centre (0 Hz) plus the translate and the tone,
    channel M-1's at -48 kHz plus its own.  Returns (launches, ms/block,
    Ms/s of wideband samples, worst SNR against the CPU chain)."""
    cfg = dataclasses.replace(pfleet.WIDEBAND_TX, block_len=WB_T)
    wf = pfleet.WidebandTxFleet([cfg], [WB_M], device=dev)
    blocks = trace_tx.capture(n_warm + n_timed, WB_M, dev, seed, cfg)
    kept, kept_state = [], None

    def step(a):
        nonlocal kept_state
        i_ch, q_ch = wf.chain_iq([a])
        out = wf.synthesize(i_ch, q_ch)
        if len(kept) < n_ref:
            kept.append(torch.complex(i_ch[:ref_ch], q_ch[:ref_ch]))
            if len(kept) == n_ref:
                kept_state = wf.groups[0][1]
        return out

    launches, ms_block, (i, q) = timed_run(step, blocks, "wideband_tx",
                                           TX_VOICE, n_warm, n_timed)
    n_out = WB_M * WB_T
    msps = n_out / (ms_block * 1e-3) / 1e6
    check(tuple(i.shape) == (n_out,) and tuple(q.shape) == (n_out,),
          f"wideband_tx IQ {tuple(i.shape)}")
    check(bool(torch.isfinite(i).all() and torch.isfinite(q).all()),
          "wideband_tx IQ not finite")
    worst = tx_vs_cpu(cfg, "wideband_tx", blocks, kept, kept_state, WB_M)
    fs_wide = WB_M * tx.IQ_RATE
    z = torch.complex(i, q).to(torch.complex128)
    win = torch.hann_window(n_out, dtype=torch.float64, device=z.device)
    spec = torch.fft.fft(z * win).abs().cpu().numpy()
    freqs = np.fft.fftfreq(n_out, 1.0 / fs_wide)
    for m in (0, WB_M - 1):
        centre = float(chz.channel_center_hz(m, WB_M, fs_wide))
        band = np.abs(freqs - centre) < tx.IQ_RATE / 2
        f_pk = float(freqs[band][spec[band].argmax()])
        want = (centre + trace_tx.expected_peak_hz(cfg)
                + 10.0 * (m % 200))
        print(f"  wideband_tx channel {m} peak {f_pk:.1f} Hz (centre "
              f"{centre:.0f} Hz, expected {want:.1f} Hz)")
        check(abs(f_pk - want) < max(20.0, 2 * fs_wide / n_out),
              f"wideband_tx channel {m} at {f_pk} Hz, not {want}")
    return launches, ms_block, msps, worst


def agc_stereo_rows_path(dev, seed, n_timed=4, n_warm=2, n_ref=2,
                         ref_ch=8):
    """The entry path of K13's rows: `ops.agc.run_stereo` at 12 kHz on
    (8192, 2, 2048) audio with a threshold per channel (40 ... 80 dB),
    state carried; channels 0-7 against the same call on the CPU (plain
    versions) over the first blocks, >= KERNEL_TOL_DB.  Returns
    (launches, ms/block, Ms/s of input samples, worst SNR)."""
    C, T = CHANNELS, STEREO_ROWS_T
    params = agc_ops.make_params(12000.0, thresh_db=STEREO_ROWS_THRESH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    blocks = [torch.stack([agc_block(gen, dev, C, T, k * T, 12000.0),
                           0.5 * agc_block(gen, dev, C, T, k * T, 12000.0)],
                          dim=1) for k in range(n_warm + n_timed)]
    state = agc_ops.init_state_stereo((C,), params, device=dev)
    setup = agc_ops.make_setup(params, C, dev)
    kept = []

    def step(x):
        nonlocal state
        y, state = agc_ops.run_stereo(params, state, x, setup)
        if len(kept) < n_ref:
            kept.append(y[:ref_ch].clone())
        return y

    launches, ms_block, y = timed_run(step, blocks, "agc_stereo_rows",
                                      ("agc_scan_rows",), n_warm, n_timed)
    check(tuple(y.shape) == (C, 2, T) and bool(torch.isfinite(y).all()),
          "agc_stereo_rows output")
    p8 = agc_ops.make_params(12000.0, thresh_db=STEREO_ROWS_THRESH[:ref_ch])
    s8 = agc_ops.init_state_stereo((ref_ch,), p8)
    worst = math.inf
    for k in range(n_ref):
        y_cpu, s8 = agc_ops.run_stereo(p8, s8, blocks[k][:ref_ch].cpu())
        s = snr_db(y_cpu, kept[k].cpu())
        worst = min(worst, s)
        print(f"  agc_stereo_rows vs CPU, block {k}, ch 0-{ref_ch - 1}: "
              f"SNR {s:.1f} dB")
    check(worst >= KERNEL_TOL_DB,
          f"agc_stereo_rows vs CPU: {worst:.1f} dB < {KERNEL_TOL_DB} dB")
    msps = C * 2 * T / (ms_block * 1e-3) / 1e6
    return launches, ms_block, msps, worst


# "blocked" (K2): every path whose cascade stage is non-empty (the
# PreFilter; FM's squelch HPF; the TX voice bandpass), all but wide SSB
SHARED = ("agc", "interp", "blocked")
FM_KERNELS = ("fir_rt", "fm_disc", "agc", "blocked")
TWO_CH = ("agc_scan", "interp", "blocked")
DEPTH = 1024          # channels of the paths run at a smaller depth
# (label, config, kernels it must launch, timed blocks, channels)
MAIN_PATHS = (
    ("ssb", CFG, ("front",) + SHARED, 8, CHANNELS),
    ("am", dataclasses.replace(SAM, mode="am"), ("fir_rt",) + SHARED, 8,
     CHANNELS),
    ("sam_both", dataclasses.replace(SAM, sam_sideband="both"),
     ("fir_rt", "pll_audio") + SHARED, 8, CHANNELS),
    ("sam_usb", dataclasses.replace(SAM, sam_sideband="usb"),
     ("fir_rt", "pll", "biquad") + SHARED, 8, CHANNELS),
    ("fm", FM, FM_KERNELS, 8, CHANNELS),
    ("wide", WIDE, ("fir_cx_nco", "agc", "interp"), 8, CHANNELS),
    ("ssbstereo", STEREO, ("front_pair",) + TWO_CH, 8, CHANNELS),
    # the reference's modulated-taps gate (UHSDR_FRONT_MT=1, set around
    # this path alone): K15 in place of K1
    ("ssb_mt", CFG, ("front_mt",) + SHARED, 8, CHANNELS),
    # the firmware's IQ conversion off: the untranslated front (K6)
    ("wide_noxlate", dataclasses.replace(WIDE, translate_hz=0.0),
     ("fir_cx", "agc", "interp"), 4, DEPTH),
    ("fm_sql", dataclasses.replace(FM, sql_threshold=10, subtone_hz=88.5),
     FM_KERNELS, 4, DEPTH),
    ("iq", dataclasses.replace(STEREO, mode="iq"), ("front_pair",) + TWO_CH,
     4, DEPTH),
    ("sam_stereo", dataclasses.replace(SAM, sam_sideband="stereo"),
     ("fir_rt", "pll", "biquad") + TWO_CH, 4, DEPTH),
)
PATH_ENV = {"ssb_mt": {"UHSDR_FRONT_MT": "1"}}
TX_VOICE = ("fir_real", "alc", "blocked")
# the fleet: K1 (usb, lsb, cw), K5 (am, sam, fm), K9 (sam both), K12 (fm),
# K2, K3 with rows (the five 12 kHz groups' merged AGC), K3 (FM's), K4
FLEET_SEPARATE_KERNELS = ("front", "fir_rt", "pll_audio", "fm_disc",
                          "blocked", "agc", "interp")
FLEET_KERNELS = FLEET_SEPARATE_KERNELS + ("agc_rows",)
WIDEBAND_KERNELS = ("front", "fir_rt", "blocked", "agc", "interp")
FLEET_TIMED = 6          # timed blocks of the fleet paths (2 warm-up)
WIDEBAND_TIMED = 6       # and of the wideband paths
# (label, config, kernels it must launch, timed blocks, channels); CW's
# keyed carrier runs no kernel (nor does the reference's)
TX_PATHS = (
    ("tx_usb", TXF, TX_VOICE, 8, CHANNELS),
    ("tx_lsb", dataclasses.replace(TXF, mode="lsb"), TX_VOICE, 4, DEPTH),
    ("tx_am", dataclasses.replace(TXF, mode="am"), TX_VOICE, 4, DEPTH),
    ("tx_cw", dataclasses.replace(TXF, mode="cw"), (), 4, DEPTH),
    ("tx_lsb_scipy", dataclasses.replace(TXF, mode="lsb", front="scipy"),
     TX_VOICE, 4, DEPTH),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.time()
    card = smi("name,power.limit")
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, max SM clock "
          f"{sm_clock_hz() / 1e6:.0f} MHz")
    t0 = time.time()
    logs = build.build_all()
    n_src = sum(k.lib_of is None for k in build.kernels())
    print(f"{len(build.kernels())} kernels built from {n_src} sources "
          f"in {time.time() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    configs = {"ssb": CFG, "sam": SAM, "fm": FM, "wide": WIDE,
               "stereo": STEREO}
    P = {key: rx.make_params(cfg, dev) for key, cfg in configs.items()}
    for key, cfg in configs.items():
        p = P[key]
        print(f"config {key}: {CHANNELS} ch x {cfg.block_len} @ "
              f"{cfg.iq_rate:.0f} Hz, decim {cfg.decim}, front "
              f"{p.front_fir.shape[-1]} taps, stage B "
              f"{0 if p.front2 is None else p.front2.shape[-1]} taps, "
              f"PreFilter {p.audio_sos.sections} sections, interp "
              f"{p.interp_fir.shape[-1]} taps, AGC w {p.agc.attack_buffsize}")
    P["tx"] = tx.make_params(TXF, dev)
    print(f"config tx: {CHANNELS} ch x {TXF.block_len} @ "
          f"{tx.IQ_RATE:.0f} Hz, mode {TXF.mode}, front {TXF.front}, "
          f"analytic FIR {P['tx'].ssb.fir.shape[-1]} taps, voice SOS "
          f"{P['tx'].voice_sos.sections} sections, ALC delay "
          f"{P['tx'].alc.delay}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rows = []
    for phase in (phase_front, phase_agc, phase_interp, phase_fir_rt,
                  phase_pll_cos_sin, phase_pll_audio, phase_biquad,
                  phase_fir_cx, phase_fm_disc, phase_agc_scan,
                  phase_front_pair, phase_fir_real, phase_alc,
                  phase_blocked, phase_biquad_grouped, phase_front_mt,
                  phase_agc_rows, phase_agc_scan_rows):
        t1 = time.time()
        print(f"phase {phase.__name__}:")
        r = phase(P, dev, gen)
        rows.extend(r if isinstance(r, list) else [r])
        torch.cuda.empty_cache()
        print(f"  ({time.time() - t1:.1f} s)")
    names = [k.name for k in build.kernels()]
    check(sorted(r["name"] for r in rows) == sorted(names),
          f"kernel phases {[r['name'] for r in rows]} != built {names}")

    by_path, per_block = {}, {}
    for label, cfg, expect, n_timed, C in MAIN_PATHS:
        t1 = time.time()
        print(f"phase main_path {label}:")
        env = PATH_ENV.get(label, {})
        os.environ.update(env)
        try:
            launches, ms_block, msps, worst, n_blocks = main_path(
                cfg, label, expect, dev, args.seed, n_timed, C)
        finally:
            for k in env:
                os.environ.pop(k)
        by_path[label] = launches
        per_block[label] = {k: n / n_blocks for k, n in launches.items()}
        torch.cuda.empty_cache()
        print(f"main path {label}: mode {cfg.mode}, bw {cfg.bw_key}, "
              f"sam_sideband {cfg.sam_sideband}, translate "
              f"{cfg.translate_hz:.0f} Hz, sql {cfg.sql_threshold}, subtone "
              f"{cfg.subtone_hz} Hz, {C} ch x "
              f"{cfg.block_len} int16 @ {cfg.iq_rate / 1e3:.0f} kHz: "
              f"{ms_block:.3f} ms/block over {n_timed} blocks, {msps:.1f} "
              f"Ms/s, CPU-chain SNR {worst:.1f} dB "
              f"({time.time() - t1:.1f} s) on {card}")
    for label, cfg, expect, n_timed, C in TX_PATHS:
        t1 = time.time()
        print(f"phase tx_path {label}:")
        launches, ms_block, msps, worst, n_blocks = tx_path(
            cfg, label, expect, dev, args.seed, n_timed, C)
        by_path[label] = launches
        per_block[label] = {k: n / n_blocks for k, n in launches.items()}
        torch.cuda.empty_cache()
        print(f"tx path {label}: mode {cfg.mode}, front {cfg.front}, "
              f"translate {cfg.translate_hz:.0f} Hz, {C} ch x "
              f"{cfg.block_len} f32 @ {tx.IQ_RATE / 1e3:.0f} kHz: "
              f"{ms_block:.3f} ms/block over {n_timed} blocks, {msps:.1f} "
              f"Ms/s, CPU-chain SNR {worst:.1f} dB "
              f"({time.time() - t1:.1f} s) on {card}")
    t1 = time.time()
    print("phase entry path biquad_grouped:")
    launches, ms_block, worst, n_blocks = grouped_path(P, dev, args.seed)
    by_path["biquad_grouped"] = launches
    per_block["biquad_grouped"] = {k: n / n_blocks
                                   for k, n in launches.items()}
    torch.cuda.empty_cache()
    print(f"entry path biquad_grouped: {2 * CHANNELS} ch x "
          f"{SAM.block_len // SAM.decim} f32, both allpass sets: "
          f"{ms_block:.3f} ms/block over 4 blocks, K11 SNR {worst:.1f} dB "
          f"({time.time() - t1:.1f} s) on {card}")
    # the fleet, twice over the same blocks: stage-batched and per group;
    # the CPU check of the stage-batched run after both timed runs
    cfgs = fleet_configs()
    fleet_blocks = trace_rx.fleet_capture(cfgs, 2 + FLEET_TIMED,
                                          FLEET_GROUP_CHANNELS, dev,
                                          args.seed)
    n_fleet = FLEET_GROUP_CHANNELS * len(cfgs)
    fleet_kept = None
    for label, fused in (("fleet", True), ("fleet_separate", False)):
        t1 = time.time()
        print(f"phase fleet path {label}:")
        launches, ms_block, msps, kept, kept_states = fleet_path(
            label, fused, fleet_blocks, dev, FLEET_TIMED)
        by_path[label] = launches
        per_block[label] = {k: n / len(fleet_blocks)
                            for k, n in launches.items()}
        if fused:
            fleet_kept = (kept, kept_states)
        del kept, kept_states
        torch.cuda.empty_cache()
        print(f"fleet path {label}: {len(cfgs)} groups "
              f"({', '.join(c.mode for c in cfgs)}) x "
              f"{FLEET_GROUP_CHANNELS} ch = {n_fleet} ch x {FLEET_BLOCK} f32 "
              f"@ 48 kHz: {ms_block:.3f} ms/block over {FLEET_TIMED} "
              f"blocks, {msps:.1f} Ms/s ({time.time() - t1:.1f} s) on "
              f"{card}")
    t1 = time.time()
    print("phase fleet vs the CPU fleet:")
    worst = fleet_vs_cpu("fleet", cfgs, fleet_blocks, *fleet_kept)
    del fleet_kept
    print(f"fleet vs CPU fleet, channels 0-7 of each group, blocks 0-1: "
          f"worst {worst:.1f} dB ({time.time() - t1:.1f} s)")
    t1 = time.time()
    print("phase fleet lockstep (fleet against fleet_separate):")
    n_eq, n_all = fleet_lockstep(fleet_blocks, dev)
    del fleet_blocks
    torch.cuda.empty_cache()
    print(f"fleet vs fleet_separate: {n_eq} of {n_all} bit-equal "
          f"({time.time() - t1:.1f} s)")
    t1 = time.time()
    print("phase wideband path:")
    launches, ms_block, msps, worst_fleet, worst = wideband_path(
        dev, args.seed, WIDEBAND_TIMED)
    by_path["wideband"] = launches
    per_block["wideband"] = {k: n / (2 + WIDEBAND_TIMED)
                             for k, n in launches.items()}
    torch.cuda.empty_cache()
    print(f"wideband path: {WB_M} ch x {WB_T} (usb {2 * WB_M // 3}, am "
          f"{WB_M - 2 * WB_M // 3}) from {WB_M * WB_T} wideband samples: "
          f"{ms_block:.3f} ms/block over {WIDEBAND_TIMED} blocks, "
          f"{msps:.1f} Ms/s (wideband), CPU-fleet SNR {worst_fleet:.1f} dB, "
          f"bank vs direct form {worst:.1f} dB "
          f"({time.time() - t1:.1f} s) on {card}")
    t1 = time.time()
    print("phase wideband_tx path:")
    launches, ms_block, msps, worst = wideband_tx_path(dev, args.seed,
                                                       WIDEBAND_TIMED)
    by_path["wideband_tx"] = launches
    per_block["wideband_tx"] = {k: n / (2 + WIDEBAND_TIMED)
                                for k, n in launches.items()}
    torch.cuda.empty_cache()
    print(f"wideband_tx path: {WB_M} ch x {WB_T} {TXF.mode} to "
          f"{WB_M * WB_T} wideband samples: {ms_block:.3f} ms/block over "
          f"{WIDEBAND_TIMED} blocks, {msps:.1f} Ms/s (wideband), CPU-chain "
          f"SNR {worst:.1f} dB ({time.time() - t1:.1f} s) on {card}")
    t1 = time.time()
    print("phase entry path agc_stereo_rows:")
    launches, ms_block, msps, worst = agc_stereo_rows_path(dev, args.seed)
    by_path["agc_stereo_rows"] = launches
    per_block["agc_stereo_rows"] = {k: n / 6 for k, n in launches.items()}
    torch.cuda.empty_cache()
    print(f"entry path agc_stereo_rows: {CHANNELS} ch x 2 x "
          f"{STEREO_ROWS_T} @ 12 kHz, thresholds 40-80 dB: {ms_block:.3f} "
          f"ms/block over 4 blocks, {msps:.1f} Ms/s, CPU SNR {worst:.1f} dB "
          f"({time.time() - t1:.1f} s) on {card}")
    # a kernel counts as launched by a chain path or by an entry path
    for r in rows:
        r["launches_by_path"] = {p: n[r["name"]] for p, n in by_path.items()
                                 if n[r["name"]]}
        r["launches_per_block"] = {p: per_block[p][r["name"]]
                                   for p in r["launches_by_path"]}
        r["launches"] = sum(r["launches_by_path"].values())
        check(r["launches"] > 0, f"no main path launched {r['name']}")
    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}, allow_nan=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
