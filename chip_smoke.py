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
   the fleet's FM group, 1024 channels at w 192, checked over 4096-step
   blocks and timed at 16384; its shared memory held to
   `agc_geometry`'s; an edge stream of +-0, +-inf, a NaN and subnormals
   at w 48 and 96, the NaNs where the plain version has them), K4
   (the interpolator: x8, x4, ssbstereo's 2C rows, the 48 kHz x2 and
   FreeDV's x6 of 72 taps at 512 x 5120, channels 0-7 alone bit-equal
   to the batch, `conv_transpose1d` timed at each shape), K5 (the
   real-tap AM/SAM front; also 64
   channels of int16 @ 192 kHz at decimation 16, the FM front at
   decimation 2, 64 channels of the fleet's f32 FM front @ 48 kHz at
   decimation 1 and FreeDV's front, 512 x 30720 f32 @ 48 kHz, 72 taps
   at decimation 6, with a delta a channel, at 100 dB), K10 and K9 (the SAM PLL: first its fast forms
   against the exact functions over their ranges, one launch; then
   also edge streams: carries outside [0, 2 pi], zeros, +-inf and a NaN
   in iq, timed too; the recurrence bound from the walker's critical
   cycle in `cuobjdump -sass` of this run's build), K11 (the biquad
   cascade, bit for bit), SAM's fused sideband stage (usb and lsb at
   8192 channels, stereo at 1024, fade on and off, bit for bit;
   channels 0-7 alone bit-equal to the batch), K7 and K6 (the
   complex-tap wide-SSB front with and without the NCO, its output at
   100 dB, its history and peaks bit-equal, its shared memory held to
   `fir_cx_geometry`'s; K7 also at 192 kHz, 491 taps at decimation 8;
   K6 also at the sharded RX step's stage B, 8192 x 2048 f32 planes,
   199 taps at decimation 1, real out, its row's `stage_b` entry with
   its bound and `conv1d`'s time),
   K12 (the FM discriminator), K13 (the linked
   stereo AGC's machine on K3's warps, its last block an edge stream, its
   shared memory held to `agc_scan_geometry`'s), K1 with the two-channel
   modes' two stage-B filters
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
   (the grouped biquad scan, a warp a row and a lane a group, at SAM's
   stacked allpass shape bit for bit against its plain version and at
   90 dB against K11; at each group length 16, 32 and 64 a block past
   PR 5's 512 groups and an edge stream from a NaN state, bit for bit;
   its launch, registers and spills printed), K15 (the modulated-taps
   SSB front, K1's kernel with complex stage-A taps: at the SSB flagship
   and on 64 channels at 48 and 192 kHz int16 and f32 and 96 kHz f32,
   its raw carry bit-equal, its
   shared memory held to `front_mt_geometry`'s; timed beside K1), the row
   variants of K3 (per-channel [min_volts, slope, hang_level], at the
   fleet's merged AGC shape 5120 x 4096) and K13 (per-channel [min_volts,
   hang_level], at 8192 x 2048), and the linked stereo AGC stage, scalar
   and with rows (8192 x 2 x 2048 at w 48, scalar also 1024 x 2 x 4096 at
   w 96; the last block an edge stream; bit for bit; timed beside the
   route it replaced, torch around K13, and K13 alone); then the RX
   options' four helper kernels, which have no TPU counterpart, bit for
   bit with edge streams (+-0, +-inf, a NaN, subnormals, 1e30, a NaN
   state) and channels 0-7 alone against the batch: the IQ correction
   (iqcorr.cu, 8192 x 16384 int16 imbalanced planes, then f32 edge
   planes; its launch rule and the runtime's blocks an SM printed),
   both filters of lms.cu's one body (the 96-tap NLMS notch and the
   64-tap NLMS NR, four lanes a channel; the leaky NR, the leaky notch
   and the 96-tap leaky NR, two lanes a channel, its branch-free
   reciprocal held to div.rn over every f32 of its range; both output
   modes; 8192 x 2048 @ 12 kHz; each timed beside its bound and the issue
   floors of what the function needs and of what the kernel issues), the
   noise blanker (blanker.cu, two lanes a channel; impulsive audio,
   repairs across frames and blocks, and audio without impulses, timed
   with the candidates found a frame) and the spectral NR's gain machine
   (nr.cu, 8192 x 16 frames of 129 bins, through the 20-frame bootstrap
   and past it); and the two helper kernels of slice 19, also bit for
   bit with edge streams and channels 0-7 alone: the CMSIS IIR lattice
   (lattice.cu, at the reference chain's PreFilter 8192 x 4096 with 10
   stages, then at every stage count from 1 to 12; timed there and at FM
   TX's voice shape 8192 x 16384; its FP32 instructions read from
   `cuobjdump -sass` of this run's build) and the table-mode FM modulator
   (fm_mod.cu, at the TX flagship's 8192 x 16384, with a subtone plane
   and the negative translate's I/Q swap); then the scope's zoom (K5's
   127-tap decimator at magnify 3 on the RX flagship's int16 planes, 8192
   x 16384, against its plain version; `scope.process` at magnify 3 and 0
   against the CPU on channels 0-7) and the three decoders' helper
   kernels, bit for bit with edge streams and channels 0-7 alone: CW
   keying detection (cw.cu, 8192 x 2024 @ 12 kHz), BPSK demodulation
   (psk.cu, PSK31 at 8192 x 1920; PSK63 and PSK125 at 1024 channels) and
   RTTY demodulation (rtty.cu, 8192 x 2048, with and without the ATC),
   each on decoder-tap audio of FSK, PSK and keyed-tone channels.  Each
   streams 2-4
   blocks at its main path's shapes (8192 channels; K11 and K14 at the
   16384 stacked channels SAM gives them; the ALC's plain loop at 4096
   samples), the middle block ragged where the kernel has a tile or a
   history to be ragged against,
   through the kernel and through its plain torch version on the card,
   from the same seeded inputs with carries handed on.  FIR and cascade
   outputs and carries are held to SNR >= 90 dB, the PLL's cos/sin/audio
   and carries to max |err| <= 2e-5, the discriminator's angles to max
   |err| <= 2e-6 modulo 2 pi; K15's output to FIR_TOL_DB (100 dB); K3,
   K13, the linked stage and the ALC must be bit-exact (a NaN matching a
   NaN).  It
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
   detection, iq on the flagship's row and SAM stereo; then the RX
   options: `ssb_opts` (the SSB flagship with the IQ correction, the
   notch, the blanker and the NR) and `ssb_leaky` (with the leaky LMS)
   at 8192 channels and 8 timed blocks, `am_nb` (AM on the AM/SAM
   flagship with the blanker) and `ssbstereo_nr` (the two-channel
   flagship with the NR) at 1024 channels and 4 (where the notch runs,
   channel 0's steady tone must be gone instead of found); then the
   legacy redesigned front: `ssb_scipy` (the SSB flagship on it, K7) at
   8192 channels and 8 timed blocks, `am_scipy`, `fm_scipy` (K5; FM at
   decimation 1 and 96 kHz), `iq_wide` (10P0KHZ) and `ssbstereo_wide`
   (5P0KHZ, two K7 launches) on the default front at 1024 channels and
   4, and `chain/output.py`'s `output_block` on `ssb_scipy`'s last block
   against the CPU.  Then `decode`: the SSB flagship with the scope
   (magnify 0) on its `spectrum_iq` tap and `modems.tap.DecoderTap` (CW,
   PSK63, RTTY) on its 12 kHz `audio_dec` tap, 2 + 8 blocks, printed
   beside SSB's ms/block; channels 0-2 carry an RTTY, a PSK63 and a CW
   message (made by the port's text tiers), which must decode.  Then
   the reference chain `RefRxChain` (f32 planes
   in the count domain @ 48 kHz): `refchain` (usb 2P3KHZ select 2: the
   torch mix, K5, K6, the lattice, K3, K4) at 8192 channels and 8 timed
   blocks, `refchain_sam` and `refchain_fm` at 1024 and 4.  Before
   them FreeDV (`modems/freedv.py`, `parallel/fleet.py::
   FreeDvFleetGroup`): `freedv`, the group in mode 1600 at 512 channels
   x 30720 f32 @ 48 kHz (bench_fleet.py's row) on the firmware's
   recorded 1600 IQ, each channel at its own offset within +-3 kHz, 6
   blocks: the front (one K5 launch a block, CUDA events), the front
   with the baseband's copy to the host, the batched NumPy modem tier
   (s a block), real-time channels of each tier; every channel must
   decode 60 frames with parity at most 0.2 a frame, channels 0-7 must
   match a CPU group of the port (baseband >= 100 dB, speech bit for
   bit); `freedv_front`, the front alone at 8192 channels beside its
   byte bound; `freedv700d`, 700D at 128 channels on the port's own
   transmission (5 frames a channel, channels 0-7 as the CPU's);
   `freedv_radio`, `FreeDvRadioMode` on one channel at translate 6000
   Hz, retuned +300 Hz mid-stream (the speech bit-equal to the CPU's);
   `freedv_glue`, `freedv_rx_block` (K5 without the NCO, K4 at x6).
   Then the entry points, in process (`cli.main`) on the card, captures
   written with numpy from `--seed` into a temporary directory:
   `cli_rx` (`rx --mode usb --block 4096` over 30 s of a +6.7 kHz tone
   in noise, f32 planes and `--raw-i16`: wall s, x real time, the first
   3 blocks against `--device cpu` at 80 dB, the tone at 700 Hz),
   `cli_text` (`tx --mode cw|rtty|psk --text`, then `rx --decode`: the
   texts come back; `tx --mode usb`, `rx`: the peak at 700 +- 15 Hz),
   `cli_freedv` (`rx --mode freedv1600 --block 4800` on the recorded
   1600 IQ: >= 60 frames, the CPU's speech bit for bit), `cli_channelize`
   (`channelize --channels 512 --block 4096`, 8 blocks of 24.6 MHz with
   tones in channels 37, 200 and 411: the loudest and the active count
   found) and `cli_serve` (`serve` with a `CatClient` over TCP: RX
   blocks/s against real time, the device busy share of a window under
   `utils/profiling.trace`, retunes, usb -> am -> usb, PTT with CW text,
   64 RX blocks; the first blocks against the CPU chain at 80 dB,
   `error` None).
   Then
   `TxChain` at the TX flagship (usb, 8192 ch x 16384 f32 audio @ 48
   kHz, 8 timed blocks) and at 1024 channels lsb, am, cw and the
   legacy-front lsb; FM at the TX flagship (`tx_fm`: the lattice, the
   ALC, fm_mod) and on the legacy front at 1024 (`tx_fm_scipy`, held to
   the CPU at 60 dB: its accumulator rounds K2's last bits into phase
   steps), whose channel 0 must sit on the carrier (the spectrum's mean
   frequency) with its modulation around it.
   Then the entry paths `biquad_grouped` and `biquad`: SAM usb's stacked
   allpass inputs as the reference stacks them (16384 x 4096, both
   coefficient sets) through `biquad_cascade(impl="grouped")` (K14) and
   `biquad_cascade` (K11), 4 timed blocks each, state carried, each held
   against the other, and their ms/block printed side by side.  Then the
   mixed-mode fleet
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
   8192 x 2 x 2048 with a threshold per channel: the linked stage's rows;
   channels 0-7 against the CPU at 90 dB) and the entry paths of K13,
   `agc_machine` and `agc_machine_rows` (`cuda.agc.agc_scan` on the
   linked detector's look-ahead max of such audio, scalar and with
   rows; channels 0-7 against the CPU at 90 dB).  Then the sharded
   paths (`parallel/`) in a process group of one rank (NCCL, a `file://`
   store in a temporary directory) on a 1 x 1 mesh: `sharded_rx`
   (`rx_sharded.make_sharded_rx(rx.FLAGSHIP)` at 8192 ch x 16384 f32
   planes @ 96 kHz, the flagship's int16 planes / 32768, 2 + 8 blocks:
   K5 stage A, K6 stage B, K2, K3, K4; every channel's
   audio and the state against `RxChain(rx.FLAGSHIP)`, fused K1, on the
   same planes at 80 dB over 3 blocks; its ms/block printed beside
   `ssb`'s), `sharded_rx_sp4` (1024 channels, each block cut into 4 time
   shards, each through `rx_sharded.front_end_local` with the previous
   shard's raw tail as its halo, then stage B and the post; held to the
   1 x 1 step on the same planes: the front's output and each shard's
   seam outputs at 100 dB, the audio at 80 dB; the NCO near the uint32
   wrap), `sharded_tx` (`tx_sharded.make_sharded_tx(tx.TX_FLAGSHIP)` at
   1024 ch, one block untimed, bit for bit against `TxChain`) and
   `sharded_wideband` (`wideband_sharded.make_sharded_channelizer` at
   the `wideband` path's 4096-channel bank, 2 + 6 blocks, against
   `WidebandFleet`'s bank at 100 dB; no hand kernel).  Every kernel's launch
   count is set to 0 just before each path and read just after, each
   kernel of that path must have been launched and no other, and every
   built kernel must have been launched by a chain path or the entry
   path.  Output and state must be
   finite, channels 0-7 must match the port's CPU chain (plain versions)
   over the first 3 blocks at SNR >= 80 dB on the output and on every
   state leaf (boolean and integer leaves equal; the NR's per-bin leaves
   over the bins of its band; where the notch runs, in two halves: the
   front's output, and the rest of the chain on the CPU from the card's
   front output, see main_path), and channel 0's test
   tone must come out of the last block where it belongs (RX: 700 Hz,
   FM 1 kHz; TX: above or below the translate frequency, the AM and CW
   carriers; where the notch runs, the tone must be gone);
5. prints one `{"kernels": [...]}` line and, last, the `{"ok": true, ...}`
   device line.

Exits non-zero without a result where CUDA is absent, and in a directory
that does not hold the `uhsdr_tpu_torch` package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from uhsdr_tpu_torch import (cli, trace_agc, trace_blocked,
                             trace_lattice_fm, trace_rx, trace_sam, trace_tx)
from uhsdr_tpu_torch import data as refdata
from uhsdr_tpu_torch.chain import filterpaths, output, refchain, rx, tx
from uhsdr_tpu_torch.control import cat as cat_mod
from uhsdr_tpu_torch.control import server as server_mod
from uhsdr_tpu_torch.cuda import agc as agc_k
from uhsdr_tpu_torch.cuda import alc as alc_k
from uhsdr_tpu_torch.cuda import blanker as nb_k
from uhsdr_tpu_torch.cuda import build
from uhsdr_tpu_torch.cuda import cw as cw_k
from uhsdr_tpu_torch.cuda import elemwise as ew_k
from uhsdr_tpu_torch.cuda import fir as fir_k
from uhsdr_tpu_torch.cuda import fm_mod as fm_k
from uhsdr_tpu_torch.cuda import iir as iir_k
from uhsdr_tpu_torch.cuda import iqcorr as iq_k
from uhsdr_tpu_torch.cuda import lattice as lat_k
from uhsdr_tpu_torch.cuda import lms as lms_k
from uhsdr_tpu_torch.cuda import nr as nr_k
from uhsdr_tpu_torch.cuda import pll as pll_k
from uhsdr_tpu_torch.cuda import psk as psk_k
from uhsdr_tpu_torch.cuda import rtty as rtty_k
from uhsdr_tpu_torch.cuda import sam as sam_k
from uhsdr_tpu_torch.io import ingest as ingest_mod
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.mod import modulators as mods
from uhsdr_tpu_torch.modems import cw as cw_mod
from uhsdr_tpu_torch.modems import cw_text, psk_text, rtty_text
from uhsdr_tpu_torch.modems import freedv as freedv_mod
from uhsdr_tpu_torch.modems import psk as psk_mod
from uhsdr_tpu_torch.modems import rtty as rtty_mod
from uhsdr_tpu_torch.modems import tap as tap_mod
from uhsdr_tpu_torch.nr import blanker as nb_mod
from uhsdr_tpu_torch.nr import spectral as nr_mod
from uhsdr_tpu_torch.ops import agc as agc_ops
from uhsdr_tpu_torch.ops import channelizer as chz
from uhsdr_tpu_torch.ops import design
from uhsdr_tpu_torch.ops import fftutil
from uhsdr_tpu_torch.ops import fir as fir_ops
from uhsdr_tpu_torch.ops import lms as lms_ops
from uhsdr_tpu_torch.ops import nco
from uhsdr_tpu_torch.parallel import fleet as pfleet
from uhsdr_tpu_torch.parallel import mesh as mesh_mod
from uhsdr_tpu_torch.parallel import (multihost, rx_sharded, tx_sharded,
                                      wideband_sharded)
from uhsdr_tpu_torch.spectrum import scope as scope_mod
from uhsdr_tpu_torch.utils import profiling

CFG = rx.FLAGSHIP            # the SSB flagship
SAM = rx.SAM_FLAGSHIP        # the AM/SAM flagship
FM = rx.FM_FLAGSHIP          # the FM flagship
WIDE = rx.WIDE_FLAGSHIP      # the wide-SSB flagship
STEREO = rx.STEREO_FLAGSHIP  # the two-channel flagship
TXF = tx.TX_FLAGSHIP         # the TX flagship
SCIPY = rx.SCIPY_FLAGSHIP    # the SSB flagship on the legacy front
REF = refchain.REF_FLAGSHIP  # the reference chain (usb 2P3KHZ select 2)
TX_FM = dataclasses.replace(TXF, mode="fm")   # FM TX at the TX flagship
CHANNELS = rx.FLAGSHIP_CHANNELS
# the FM modulator's constants, as mod/modulators.py passes them
FM_ALPHA = mods.FM_TX_HPF_ALPHA
FM_AMP = mods.FM_MOD_AMPLITUDE_SCALING

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
# K9/K10 (kernels/pll.cu): the loop's critical cycle phs[n+1] -> sincos ->
# mix -> atan2 -> loop filter -> phs[n+3] spans two steps (fil_out is
# applied one sample late); phase_pll reads its length in dependent SASS
# instructions of the walker's pair of steps from `cuobjdump -sass` of the
# library this run built (trace_sam.pll_cycle_chain) and holds it to
# cuda/pll.py::PLL_CYCLE_CHAIN, the count the source's notes give.
# K11 (kernels/biquad.cu): a section's state to its next state: the output
# add, a1*y, the subtraction, the s2 add; sections overlap across samples.
BIQUAD_STEP_OPS = 4
# the ALC (kernels/alc.cu), alc_val to the next: the walker's SASS chain,
# cuda/alc.py::ALC_STEP_CHAIN
ALC_STEP_OPS = alc_k.ALC_STEP_CHAIN
FP32_LATENCY = 4

KERNEL_TOL_DB = 90.0
# K14's blocks past PR 5's 512 groups and its edge streams: rows a block
GROUPED_LONG_ROWS = 1024
# K8 against its plain version (tests/test_torch_cuda.py's FIR_DB): both
# sum the same f32 products, in another order
FIR_TOL_DB = 100.0
# FreeDV (bench_fleet.py's row, :157-159): FREEDV_CHANNELS channels of
# FREEDV_BLOCK f32 samples @ 48 kHz a block through FreeDvFleetGroup, each
# at its own offset within +-3 kHz; the front alone at
# FREEDV_FRONT_CHANNELS; 700D at FREEDV_700D_CHANNELS; channels 0-7 held
# to a CPU run of the port
FREEDV_CHANNELS = 512
FREEDV_BLOCK = 7680 * 4
FREEDV_FRONT_CHANNELS = 8192
FREEDV_700D_CHANNELS = 128
FREEDV_REF_CH = 8
FREEDV_SPAN_HZ = 3000.0
# cycles the card spins ahead of a timed front (~1 ms at 1980 MHz)
FREEDV_SPIN_CYCLES = 2_000_000
# the offsets of phase_fir_rt's FreeDV case, repeated over the channels:
# 0 Hz, the edges of the band, and others of either sign
FREEDV_K5_OFFSETS = (0.0, 23999.0, -23999.0, 3000.0, -3000.0, 700.0,
                     -1200.0, 12.5)
# FreeDvRadioMode: blocks of 4800 (tests/test_freedv_mode.py), translate
# 6000 Hz; from block FREEDV_RETUNE_BLOCK on the capture moves by
# FREEDV_RETUNE_HZ and extra_offset_hz follows it
FREEDV_RADIO_BLOCK = 4800
FREEDV_RETUNE_BLOCK = 20
FREEDV_RETUNE_HZ = 300.0
# the bounds of tests/test_freedv_mode.py:66-70 (1600) and
# bench_fleet.py:202 (700D): frames a channel, parity per frame
FREEDV_MIN_FRAMES = {"freedv1600": 60, "freedv700d": 5}
FREEDV_MAX_PARITY = 0.2
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


def bits_held(name: str, pairs: dict) -> float:
    """Print and check each (ref, got) pair bit for bit, a NaN matching a
    NaN.  Returns the max |err| over the elements finite in both (0)."""
    err = 0.0
    for what, (ref, got) in pairs.items():
        check(ref.shape == got.shape, f"{name} {what}: shape "
                                      f"{tuple(got.shape)}")
        same = ((ref.view(torch.int32) == got.view(torch.int32))
                | (ref.isnan() & got.isnan()))
        n_diff = int((~same).sum())
        fin = torch.isfinite(ref) & torch.isfinite(got)
        e = float((ref[fin] - got[fin]).abs().max()) if bool(
            fin.any()) else 0.0
        n_nan = int(ref.isnan().sum())
        print(f"  {name} {what}: {n_diff} of {ref.numel()} differ "
              f"({n_nan} NaN), max|err| {e:.3e}")
        check(n_diff == 0, f"{name} {what}: {n_diff} elements differ")
        err = max(err, e)
    return err


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
    freedv, s, e = freedv_k5_case(dev, gen)
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
                         "(the FIR alone)", decim2=decim2,
            freedv=freedv)
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


def freedv_deltas(offsets, dev) -> torch.Tensor:
    """(C,) int64 NCO increments translating each offset (Hz) to 0 at
    48 kHz, as FreeDvFleetGroup makes them."""
    d = np.asarray([nco.freq_to_delta(-f, freedv_mod.IQ_RATE)
                    for f in offsets], np.uint32)
    return torch.as_tensor(d.astype(np.int64), device=dev)


def freedv_k5_case(dev, gen) -> tuple:
    """K5 at FreeDV's fleet shape (FREEDV_CHANNELS x FREEDV_BLOCK f32 @ 48
    kHz, 72 taps, decimation 6, planes out) with a delta a channel (0 Hz,
    +-23999 Hz and other positive and negative offsets): three streamed
    blocks, the middle one ragged, against fir_rt_plain at FIR_TOL_DB;
    timed beside the plain version and conv1d (stride 6, no NCO: the FIR
    alone).  Returns (the timing dict, min SNR, max abs err)."""
    C, B, decim = FREEDV_CHANNELS, FREEDV_BLOCK, freedv_mod.RATIO
    h = torch.as_tensor(design.decimation_fir(72, decim, 48000.0).astype(
        np.float32), device=dev)
    taps = h.shape[-1]
    deltas = freedv_deltas(np.resize(FREEDV_K5_OFFSETS, C), dev)
    ck = cp = torch.zeros((C, taps - 1), dtype=torch.complex64, device=dev)
    phase = torch.randint(0, 2**32, (C,), generator=gen, device=dev)
    worst, err, first = math.inf, 0.0, None
    for blk, Bk in enumerate((B, 4206, B)):
        xi, xq = (v.to(torch.float32) / 32768.0
                  for v in iq_block(gen, dev, C, Bk))
        first = first or (ck, xi, xq, phase)
        (ai, aq), ck, pk_k = fir_k.fir_rt(h, ck, xi, xq, decim,
                                          nco=(phase, deltas),
                                          planes_out=True)
        y, cp, pk_p = fir_k.fir_rt_plain(h, cp, xi, xq, decim,
                                         nco=(phase, deltas))
        torch.cuda.synchronize()
        s, e = held(f"K5 FreeDV, a delta a channel, block {blk} ({Bk} "
                    f"samples)", {"i plane": (y.real, ai),
                                  "q plane": (y.imag, aq),
                                  "raw carry": (cp, ck),
                                  "peaks": (pk_p, pk_k)})
        check(s >= FIR_TOL_DB, f"K5 FreeDV block {blk}: SNR {s:.1f} dB < "
                               f"{FIR_TOL_DB} dB")
        worst, err = min(worst, s), max(err, e)
        phase = nco.advance(phase, deltas, Bk)
    c0, xi, xq, ph0 = first
    ms = cuda_ms(lambda: fir_k.fir_rt(h, c0, xi, xq, decim,
                                      nco=(ph0, deltas), planes_out=True),
                 10)
    plain_ms = cuda_ms(lambda: fir_k.fir_rt_plain(
        h, c0, xi, xq, decim, nco=(ph0, deltas), planes_out=True), 2)
    st = premixed_stack(c0, xi, xq, None)
    planes = st.transpose(0, 1).reshape(-1, 1, st.shape[-1]).contiguous()
    w = h.flip(0).reshape(1, 1, taps)
    lib_ms = cuda_ms(lambda: torch.nn.functional.conv1d(planes, w,
                                                        stride=decim), 5)
    del st, planes
    T_out = B // decim
    fma = C * T_out * 2 * taps
    # bytes: f32 planes in and out, carry in and out, phases and deltas
    # in, peaks out, taps in
    nbytes = (2 * C * B * 4 + 2 * C * T_out * 4 + 2 * C * (taps - 1) * 8
              + 2 * C * 8 + C * 4 + 4 * taps)
    b_ms, b_by = bound(nbytes, 2.0 * fma)
    print(f"  K5 FreeDV ({C} x {B} f32, {taps} taps, decim {decim}, a "
          f"delta a channel): {ms:.4f} ms (plain {plain_ms:.3f} ms, conv1d "
          f"stride {decim} without the NCO {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms by {b_by}: {fma / 1e6:.0f} M FMA, "
          f"{nbytes / 1e6:.1f} MB)")
    return (dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                 bound_by=b_by, shape=[C, B], taps=taps, decim=decim,
                 library_note="conv1d stride 6 on the unrotated planes"),
            worst, err)


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
        case = ("at_192k", k7_192k_case) if use_nco else ("stage_b",
                                                           k6_stage_b_case)
        extra[case[0]] = case[1](P, dev, gen)
        s, e = extra[case[0]].pop("snr"), extra[case[0]].pop("err")
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


def k6_stage_b_case(P, dev, gen) -> dict:
    """K6 at the sharded RX step's stage B (`chain/rx.py::stage_b`, the
    unfused Hilbert combine): the SSB flagship's 199 complex taps at
    decimation 1 on 8192 x 2048 f32 planes of decimated IQ, real out.
    Three streamed blocks (the middle one shorter than the history)
    against the plain version, the output at FIR_TOL_DB and the history
    bit-equal; then timed beside the plain version and `conv1d` (the same
    FIR as a two-channel convolution).  Returns its row's numbers and its
    worst SNR and error."""
    g = P["ssb"].front2
    taps = g.shape[-1]
    C, T = CHANNELS, CFG.block_len // CFG.decim
    ck = cp = torch.complex(
        torch.randn((C, taps - 1), generator=gen, device=dev),
        torch.randn((C, taps - 1), generator=gen, device=dev)) * 0.1
    worst, err, first = math.inf, 0.0, None
    for blk, n in enumerate((T, (taps - 1) // 2, T)):
        zr, zi = (torch.randn((C, n), generator=gen, device=dev) * 0.1
                  for _ in "ri")
        if first is None:
            first = (ck, zr, zi)
        yk, ck, _ = fir_k.fir_cx(g, ck, zr, zi, 1, real_out=True)
        yp, cp, _ = fir_k.fir_cx_plain(g, cp, zr, zi, 1, real_out=True)
        torch.cuda.synchronize()
        s, e = held(f"K6 stage B block {blk} ({n} samples)", {
            "audio": (yp, yk)})
        check(s >= FIR_TOL_DB and torch.equal(cp, ck),
              f"K6 stage B block {blk}: {s:.1f} dB < {FIR_TOL_DB}, or the "
              f"history not bit-equal")
        worst, err = min(worst, s), max(err, e)
    c0, zr, zi = first
    ms = cuda_ms(lambda: fir_k.fir_cx(g, c0, zr, zi, 1, real_out=True), 10)
    plain_ms = cuda_ms(lambda: fir_k.fir_cx_plain(g, c0, zr, zi, 1,
                                                  real_out=True), 2)
    stack = torch.stack([torch.cat([c0.real, zr], -1),
                         torch.cat([c0.imag, zi], -1)], dim=1).contiguous()
    w = torch.stack([g.real.flip(0), -g.imag.flip(0)])[None].contiguous()

    def library():
        return torch.nn.functional.conv1d(stack, w)

    lib_ms = cuda_ms(library, 5)
    s_lib = snr_db(fir_k.fir_cx_plain(g, c0, zr, zi, 1, real_out=True)[0],
                   library()[:, 0])
    print(f"  K6 stage B library call (conv1d, 2 channels) vs plain: SNR "
          f"{s_lib:.1f} dB")
    del stack
    fma = C * T * 2 * taps              # real output: 2 FMA a tap
    # bytes: f32 planes in, real audio out, history in and out, peaks
    # out, complex taps in
    nbytes = (2 * C * T * 4 + C * T * 4 + 2 * C * (taps - 1) * 8 + C * 4
              + 8 * taps)
    b_ms, b_by = bound(nbytes, 2.0 * fma)
    print(f"  K6 stage B, {C} x {T} f32 planes, {taps} taps, decim 1: "
          f"{ms:.4f} ms (plain {plain_ms:.3f} ms, library {lib_ms:.3f} ms, "
          f"bound {b_ms:.4f} ms by {b_by}: {fma / 1e9:.2f} G FMA, "
          f"{nbytes / 2**20:.0f} MiB)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, taps=taps, decim=1, shape=[C, T],
                snr=worst, err=err)


def k7_192k_case(P, dev, gen) -> dict:
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


def agc_edges(x: torch.Tensor) -> torch.Tensor:
    """x ((C, T) or (C, 2, T)) with edges on channel classes c % 16: 1 a
    run of +-0 (the first half), 2 +inf in the last plane at T/2, 3 -inf
    in the first plane at T/2, 4 a NaN in the first plane at T/3, 5
    subnormals throughout, 6 negative subnormals in the last plane."""
    x = x.clone()
    v = x if x.ndim == 3 else x[:, None]
    T = v.shape[-1]
    c = torch.arange(v.shape[0], device=x.device) % 16
    v[c == 1, :, :T // 2] = 0.0
    v[c == 1, -1, :T // 2] = -0.0
    v[c == 2, -1, T // 2] = math.inf
    v[c == 3, 0, T // 2] = -math.inf
    v[c == 4, 0, T // 3] = math.nan
    v[c == 5] = 1e-42
    v[c == 6, -1] = -3e-45
    return x


def agc_edge_stream(C, w, fs, dev, gen, label, kernel, plain, planes):
    """`kernel` against `plain` (K3's `agc`/`agc_plain` or the stage's)
    over three streamed blocks of `agc_edges` input (the middle one of 33
    steps) from zero state, bit for bit, a NaN matching a NaN."""
    p = agc_ops.kernel_params(agc_ops.make_params(fs)).scalars
    shape = (C, 2, w) if planes == 2 else (C, w)
    ck = cp = torch.zeros((agc_k.N_CARRY, C), device=dev)
    dk = dp = torch.zeros(shape, device=dev)
    t0, err = 0, 0.0
    for blk, T in enumerate((2048, 33, 2048)):
        x = agc_block(gen, dev, C, T, t0, fs)
        if planes == 2:
            x = torch.stack([x, 0.5 * agc_block(gen, dev, C, T, t0, fs)], 1)
        x = agc_edges(x)
        t0 += T
        yk, ck, dk = kernel(p, ck, dk, x)
        yp, cp, dp = plain(p, cp, dp, x)
        torch.cuda.synchronize()
        err = max(err, bits_held(f"{label} edges block {blk} ({T} steps)", {
            "audio": (yp, yk), "carry": (cp, ck), "delay": (dp, dk)}))
    nan = yk.reshape(C, -1).isnan().all(-1)
    c = torch.arange(C, device=dev) % 16
    check(bool(nan[(c >= 2) & (c <= 4)].all()) and not bool(nan[c == 0].any()),
          f"{label} edges: NaN channels not the edge classes")
    return err


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
    # the fleet's FM group: 1024 channels at 48 kHz, w 192; the plain loop
    # checks 4096-step blocks (its 16384-step blocks took ~25 s each), the
    # kernel is timed at the fleet block's 16384 steps
    fm48 = pfleet.FLEET_MIX[-1]
    check(fm48.mode == "fm", "the fleet's last group is FM")
    efm, msfm, plainfm, nbfm, flfm, recfm, _ = agc_case(
        rx.make_params(fm48, dev).agc, fm48.fs_dec, (4096, 1000, 4096), dev,
        gen, time_len=FLEET_BLOCK, C=FLEET_GROUP_CHANNELS,
        name="K3 fleet FM")
    bfm, byfm = bound(nbfm, flfm)
    # +-0, +-inf, a NaN and subnormals: the NaNs where the plain version
    # has them (its look-ahead max and its blended step keep them)
    for fs in (CFG.fs_dec, SAM.fs_dec):
        w = agc_ops.make_params(fs).attack_buffsize
        agc_edge_stream(1024, w, fs, dev, gen, f"K3 w={w}", agc_k.agc,
                        agc_k.agc_plain, 1)
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
               fleet_fm=dict(ms=msfm, plain_ms=plainfm, plain_steps=4096,
                             bound_ms=bfm, bound_by=byfm, recurrence_ms=recfm,
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
             x48.block_len // x48.decim, x48.decim),
            # FreeDV's RateConverter.up: x6, 72 taps (12 a phase), the
            # speech of a fleet block at 8 kHz
            ("x6_freedv", torch.as_tensor(design.interpolation_fir(
                72, 6, 48000.0).astype(np.float32), device=dev),
             FREEDV_CHANNELS, FREEDV_BLOCK // 6, 6)):
        w, e, (ck, xk) = interp_case(hh, Ck, (Tk, Tk - 301, Tk), Lk, dev,
                                     gen, label)
        worst, err = min(worst, w), max(err, e)
        mk = cuda_ms(lambda: fir_k.interpolate(hh, ck, xk, Lk), 10)
        bk, byk = bound(interp_bytes(Ck, Tk, Lk, hh.shape[-1]), 0.0)
        call_k, result_k = interp_library(hh, ck, xk, Lk)
        lib_k = cuda_ms(call_k, 10)
        s_k = snr_db(fir_k.interp_plain(hh, ck, xk, Lk)[0], result_k())
        others[label] = dict(ms=mk, bound_ms=bk, bound_by=byk,
                             library_ms=lib_k, shape=[Ck, Tk], interp=Lk,
                             taps=hh.shape[-1])
        print(f"  K4 {label} ({Ck} x {Tk}, {hh.shape[-1]} taps): {mk:.4f} "
              f"ms, bound {bk:.4f} ms by {byk} ({100 * bk / mk:.1f}%), "
              f"library (conv_transpose1d) {lib_k:.4f} ms, its SNR against "
              f"the plain version {s_k:.1f} dB")
        del ck, xk, call_k, result_k
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


def pll_edge_block(gen, dev, C, T, t0, fs):
    """pll_block's input with edges: channel classes (c % 16) 8-11 silent,
    12 a +inf sample, 13 a -inf one, 14 a NaN, 15 silent for half the
    block."""
    z = pll_block(gen, dev, C, T, t0, fs)
    cls = torch.arange(C, device=dev) % 16
    z[(cls >= 8) & (cls < 12)] = 0
    z[cls == 12, T // 2] = complex(math.inf, 0.0)
    z[cls == 13, T // 3] = complex(0.0, -math.inf)
    z[cls == 14, T // 4] = complex(math.nan, 0.0)
    z[cls == 15, :T // 2] = 0
    return z.contiguous()


def pll_edge_carry(C, n_carry, dev):
    """Carries with the phase outside [0, 2 pi] on classes 0-7 (the fmodf
    wrap): 10, -3, 1e6, -1e6, 4 pi, -2 pi, 2 pi, -0; fil_out 0.3."""
    carry = torch.zeros((n_carry, C), device=dev)
    carry[0] = 1.0
    edge = torch.tensor([10.0, -3.0, 1e6, -1e6, 4 * math.pi, -2 * math.pi,
                         2 * math.pi, -0.0], device=dev)
    cls = torch.arange(C, device=dev) % 16
    carry[0, cls < 8] = edge[cls[cls < 8]]
    carry[1] = 0.3
    return carry


def pll_differ(ref, got) -> tuple[bool, float]:
    """(NaNs and infinities where the reference has them, max |err| over
    the values finite in both)."""
    same = (torch.equal(ref.isnan(), got.isnan())
            and torch.equal(ref.isinf(), got.isinf())
            and torch.equal(ref[ref.isinf()], got[got.isinf()]))
    fin = torch.isfinite(ref) & torch.isfinite(got)
    err = float((ref[fin].double() - got[fin]).abs().max()) \
        if bool(fin.any()) else 0.0
    return same, err


def phase_pll(P, dev, gen, audio: bool):
    """K10 (cos/sin out), or with `audio` K9 (audio and fade leveler):
    first (K10's phase) the walker's fast forms against the exact
    functions over their ranges in one launch; then three streamed blocks
    of pll_block's input and three of pll_edge_block's from
    pll_edge_carry, each output and carry held to PLL_TOL_ABS (NaNs and
    infinities where the plain version has them)."""
    sp = P["sam"].sam
    C, T, fs = CHANNELS, SAM.block_len // SAM.decim, SAM.fs_dec
    scal = pll_k.PllScalars(sp.g1, sp.g2, sp.omega_min, sp.omega_max)
    K = "K9" if audio else "K10"
    extra = {}
    if not audio:
        ck_ = pll_k.pll_fast_check(dev)
        print(f"  K10 fast forms: the wrap select differs from fmodf's on "
              f"{ck_.wrap_differ} of {ck_.wrap_checked} f32 in (-2 pi, 4 pi) "
              f"({ck_.wrap_outside} sent to fmodf); sincos on "
              f"{ck_.sincos_differ} of {ck_.sincos_checked} below 105615; "
              f"atan2 on {ck_.atan2_differ} of the {ck_.atan2_taken} seeded "
              f"pairs it takes (of {ck_.atan2_checked})")
        two_pi = np.float32(pll_k.TWO_PI)
        check(ck_.wrap_differ == 0 and ck_.wrap_outside == 0
              and ck_.wrap_checked == int(np.float32(2 * two_pi).view(
                  np.uint32)) + int(two_pi.view(np.uint32)),
              "K10: the wrap select is not fmodf's on its range")
        check(ck_.sincos_differ == 0 and ck_.atan2_differ == 0
              and ck_.atan2_taken > 0, "K10: a fast form is not the "
                                       "library's where it is used")
        extra["fast_check"] = ck_._asdict()
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
    worst, err = math.inf, 0.0
    first = first_edge = None
    for edge in (False, True):
        ck = cp = (pll_edge_carry(C, n_carry, dev) if edge
                   else torch.zeros((n_carry, C), device=dev))
        t0 = 0
        for blk, Tk in enumerate((T, 1000, T)):   # 1000: no whole tile
            z = (pll_edge_block if edge else pll_block)(gen, dev, C, Tk, t0,
                                                        fs)
            t0 += Tk
            if edge and first_edge is None:
                first_edge = (ck, z)
            elif not edge and first is None:
                first = (ck, z)
            out_k, ck = kernel(ck, z)
            out_p, cp = plain(cp, z)
            torch.cuda.synchronize()
            pairs = {k: (out_p[k], out_k[k]) for k in out_k}
            # the phase through its cosine and sine: a wrap at 2 pi is no
            # error
            pairs["phs (cos, sin)"] = (
                torch.stack([cp[0].cos(), cp[0].sin()]),
                torch.stack([ck[0].cos(), ck[0].sin()]))
            for i in range(1, n_carry):
                pairs[names[i]] = (cp[i], ck[i])
            label = f"{K} {'edge ' if edge else ''}block {blk} ({Tk} samples)"
            if not edge:
                s, e = held(label, pairs, tol_abs=PLL_TOL_ABS)
                worst = min(worst, s)
            else:
                e = 0.0
                for what, (ref, got) in pairs.items():
                    same, e1 = pll_differ(ref, got)
                    e = max(e, e1)
                    check(same and e1 <= PLL_TOL_ABS,
                          f"{label} {what}: non-finite values elsewhere than "
                          f"the plain version's, or max|err| {e1:.3e}")
                print(f"  {label}: NaNs and infinities where the plain "
                      f"version has them, max|err| {e:.3e} elsewhere")
            err = max(err, e)
        if edge:
            check(bool(ck[0][torch.arange(C, device=dev) % 16 == 14]
                       .isnan().all()), f"{K}: a NaN did not stay")
    c0, z0 = first
    ms = cuda_ms(lambda: kernel(c0, z0), 10)
    plain_ms = cuda_ms(lambda: plain(c0, z0), 1)
    # on the edge stream's first block (a quarter of the channels silent,
    # which the fast forms take; an infinity or a NaN on three classes of
    # 16 and carries outside [0, 2 pi], whose pairs take the library's
    # walk too)
    ce, ze = first_edge
    edge_ms = cuda_ms(lambda: kernel(ce, ze), 10)
    # bytes: complex IQ in, one (K9) or two (K10) f32 planes out, carries;
    # about 70 f32 operations a step (sincos ~20, atan2 ~30, the rest 20)
    n_out = 1 if audio else 2
    nbytes = C * T * 8 + n_out * C * T * 4 + 2 * n_carry * C * 4
    # the recurrence bound from the walker's critical cycle in this run's
    # build (K10's pair of steps; K9's is the same template)
    sass = trace_sam.pll_cycle_chain(pll_k.PLL._lib_path())
    chain = sass["chain"]
    check(chain == pll_k.PLL_CYCLE_CHAIN,
          f"{K}: the built walker's critical cycle is {chain} dependent "
          f"instructions, cuda/pll.py::PLL_CYCLE_CHAIN says "
          f"{pll_k.PLL_CYCLE_CHAIN}")
    step_ops = chain / pll_k.PLL_CYCLE_STEPS
    rec_ms = recurrence_ms(T, step_ops)
    geo = pll_k.pll_geometry(
        C, T, torch.cuda.get_device_properties(dev).multi_processor_count)
    r = row("pll_audio" if audio else "pll", "pll.cu",
            f"uhsdr_tpu/pallas/pll.py:{97 if audio else 54}", err=err,
            snr=worst, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=70.0 * C * T, recurrence_ms=rec_ms,
            cycle_chain=chain, edge_input_ms=edge_ms, lanes=geo.lanes,
            blocks=geo.blocks,
            library_note="no PyTorch call computes a phase-locked loop",
            **extra)
    print(f"  {K} {r['name']}: {ms:.4f} ms, {edge_ms:.4f} ms on the edge "
          f"input (plain {plain_ms:.1f} ms; recurrence bound {rec_ms:.4f} "
          f"ms = {T} steps x {step_ops} dependent ops x {FP32_LATENCY} "
          f"cycles, the critical cycle {chain} of the pair's "
          f"{sass['instructions']} SASS instructions; {r['bound_by']} bound "
          f"{r['bound_ms']:.4f} ms, {nbytes / 2**20:.0f} MiB; {geo.lanes} "
          f"lanes a walker, {geo.blocks} blocks)")
    return r


def phase_pll_cos_sin(P, dev, gen):
    return phase_pll(P, dev, gen, audio=False)


def phase_pll_audio(P, dev, gen):
    return phase_pll(P, dev, gen, audio=True)


def phase_biquad(P, dev, gen):
    """K11 at the shape SAM's sideband route gave it before the fused
    stage took the route (the entry path `biquad` runs it there): the
    7-section allpass chain over two paths stacked along channels, and
    the PreFilter's sections; bit for bit against its plain version."""
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
        check(torch.equal(yp, yk) and torch.equal(sp_, sk),
              f"K11 block {blk}: not bit-exact against its plain version")
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
    check(torch.equal(yp, yk) and torch.equal(sgp, sgk),
          "K11 PreFilter SOS: not bit-exact against its plain version")
    worst, err = min(worst, s), max(err, e)
    s0, x0 = first
    ms = cuda_ms(lambda: iir_k.biquad_cascade(sos, s0, x0), 10)
    plain_ms = cuda_ms(lambda: iir_k.biquad_cascade_plain(sos, s0, x0), 1)
    # bytes: x in, y out, states in and out; 9 f32 operations a section
    nbytes = 2 * C * T * 4 + 2 * S * C * 2 * 4 + S * 5 * 4
    rec_ms = recurrence_ms(T, BIQUAD_STEP_OPS)
    geo = iir_k.biquad_geometry(
        C, T, torch.cuda.get_device_properties(dev).multi_processor_count)
    r = row("biquad", "biquad.cu", "uhsdr_tpu/pallas/iir.py:44", err=err,
            snr=worst, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=9.0 * S * C * T, recurrence_ms=rec_ms, lanes=geo.lanes,
            blocks=geo.blocks,
            library_note="torch has no IIR filter call")
    print(f"  K11 biquad ({S} sections, {C} stacked channels): {ms:.4f} ms "
          f"(plain {plain_ms:.1f} ms, bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']}: {nbytes / 2**20:.0f} MiB; recurrence "
          f"{rec_ms:.4f} ms; {geo.lanes} lanes a walker, {geo.blocks} "
          "blocks)")
    return r


def sam_stage_block(gen, dev, C, T, t0, fs):
    """The fused stage's inputs: pll_block's iq and the cos and sin of a
    seeded phase (a locked loop's output is no different to the stage)."""
    z = pll_block(gen, dev, C, T, t0, fs)
    ph = torch.rand((C, T), generator=gen, device=dev) * (2 * math.pi)
    return z, ph.cos().contiguous(), ph.sin().contiguous()


def sam_stage_state(gen, dev, C, na):
    """A seeded state: allpass states, delays and fade states ~1e-2."""
    def f(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.01
    fshape = (C, na) if na == 2 else (C,)
    return f(4, 7, C, 2), f(C, 2), (f(*fshape), f(*fshape))


def phase_sam_sideband(P, dev, gen):
    """SAM's fused sideband stage against its plain version, bit for bit
    on the audio, the allpass states, the delays and the fade states, over
    three streamed blocks from a seeded state (4096, 1000 and 4099
    samples: a ragged tile, rows not 16-byte aligned): usb and lsb at 8192
    channels, stereo at 1024, each with the fade leveler on, and usb with
    it off; channels 0-7 alone bit-equal to the batch.  Timed at the SAM
    flagship's usb (8192 x 4096) beside its plain version (the route it
    replaced is timed by `python -m uhsdr_tpu_torch.trace_sam
    --baseline`)."""
    sp = P["sam"].sam
    T, fs = SAM.block_len // SAM.decim, SAM.fs_dec
    err = 0.0
    for sideband, C, fade in (("usb", CHANNELS, True), ("lsb", CHANNELS, True),
                              ("usb", CHANNELS, False),
                              ("stereo", DEPTH, True)):
        na = 2 if sideband == "stereo" else 1
        k = p = sam_stage_state(gen, dev, C, na)
        t0 = 0
        for blk, Tk in enumerate((T, 1000, T + 3)):
            z, cs, sn = sam_stage_block(gen, dev, C, Tk, t0, fs)
            t0 += Tk
            ak, *k = sam_k.sam_sideband(sp.ap_sos, sp.fade, *k, z, cs, sn,
                                        sideband, fade)
            apl, *p = sam_k.sam_sideband_plain(sp.ap_sos, sp.fade, *p, z, cs,
                                               sn, sideband, fade)
            torch.cuda.synchronize()
            diffs = {w: alc_differ(a, b) for w, (a, b) in {
                "audio": (apl, ak), "ap_state": (p[0], k[0]),
                "ds": (p[1], k[1]), "dc": (p[2][0], k[2][0]),
                "dc_insert": (p[2][1], k[2][1])}.items()}
            print(f"  sam_sideband {sideband} fade={fade} {C} ch block {blk} "
                  f"({Tk} samples): " + ", ".join(
                      f"{w} {n} differ" for w, (n, _) in diffs.items()))
            err = max([err] + [e for _, e in diffs.values()])
            check(ak.shape == ((C, 2, Tk) if na == 2 else (C, Tk))
                  and all(n == 0 for n, _ in diffs.values()),
                  f"sam_sideband {sideband} block {blk}: not bit-exact "
                  "against its plain version")
    C = CHANNELS
    st = sam_stage_state(gen, dev, C, 1)
    z, cs, sn = sam_stage_block(gen, dev, C, T, 0, fs)
    full = sam_k.sam_sideband(sp.ap_sos, sp.fade, *st, z, cs, sn, "usb",
                              True)
    part = sam_k.sam_sideband(
        sp.ap_sos, sp.fade, st[0][:, :, :8].contiguous(),
        st[1][:8].contiguous(), tuple(f[:8].contiguous() for f in st[2]),
        z[:8].contiguous(), cs[:8].contiguous(), sn[:8].contiguous(), "usb",
        True)
    torch.cuda.synchronize()
    check(torch.equal(full[0][:8], part[0])
          and torch.equal(full[1][:, :, :8], part[1])
          and torch.equal(full[2][:8], part[2])
          and all(torch.equal(a[:8], b) for a, b in zip(full[3], part[3])),
          "sam_sideband: channels 0-7 alone differ from the batch")
    del full, part
    ms = cuda_ms(lambda: sam_k.sam_sideband(sp.ap_sos, sp.fade, *st, z, cs,
                                            sn, "usb", True), 10)
    plain_ms = cuda_ms(lambda: sam_k.sam_sideband_plain(
        sp.ap_sos, sp.fade, *st, z, cs, sn, "usb", True), 1)
    # bytes: iq, cos, sin in, audio out, the states in and out; f32
    # operations a channel and sample: four products, 28 sections of 4,
    # the combine's 3, corr's 3, the fade leveler's 8
    nbytes = C * T * (8 + 4 + 4 + 4) + 2 * C * (4 * 7 * 2 + 2 + 2) * 4
    geo = sam_k.sam_geometry(
        C, T, 1, torch.cuda.get_device_properties(dev).multi_processor_count)
    r = row("sam_sideband", "sam.cu", "uhsdr_tpu/pallas/iir.py:44",
            err=err, snr=math.inf, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=130.0 * C * T, tpu_kernel=False, lanes=geo.lanes,
            blocks=geo.blocks,
            library_note="torch has no IIR filter call")
    print(f"  sam_sideband (fused, usb, {C} x {T}): {ms:.4f} ms (plain "
          f"{plain_ms:.1f} ms; "
          f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}: "
          f"{nbytes / 2**20:.0f} MiB; {geo.lanes} channels a walker, "
          f"{geo.blocks} blocks)")
    return r


def phase_agc_scan(P, dev, gen):
    """K13 at the two-channel flagship's shape (8192 channels x 2048
    steps at 12 kHz): two channels of AGC input through the linked
    detector and its look-ahead max, then the machine on the kernel and on
    its plain version, bit for bit, over four streamed blocks (the second
    ragged, the last an edge stream: NaNs where the plain walk has them);
    the library's shared memory held to `agc_scan_geometry`'s."""
    params = P["stereo"].agc
    p = agc_ops.kernel_params(params).scalars
    C, w = CHANNELS, params.attack_buffsize
    T, fs = STEREO.block_len // STEREO.decim, STEREO.fs_dec
    smem = agc_k.AGC.lib().uhsdr_agc_scan_smem()
    geo = agc_k.agc_scan_geometry(C, T)
    check(smem == geo.smem, f"K13: the library's shared memory {smem} != "
                            f"agc_scan_geometry's {geo.smem}")
    ck = cp = torch.zeros((agc_k.N_CARRY, C), device=dev)
    delay = torch.zeros((C, 2, w), device=dev)
    err, t0, first = 0.0, 0, None
    for blk, Tk in enumerate((T, 1000, T, T)):
        x = torch.stack([agc_block(gen, dev, C, Tk, t0, fs),
                         0.5 * agc_block(gen, dev, C, Tk, t0, fs)], dim=1)
        if blk == 3:          # the last block an edge stream
            x = agc_edges(x)
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
        err = max(err, bits_held(f"K13 block {blk} ({Tk} steps)", {
            "volts": (vp, vk), "carry": (cp, ck)}))
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
            recurrence_blended_ms=rec18, smem=geo.smem,
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
        err = max(err, bits_held(f"K13 rows block {blk} ({Tk} steps)", {
            "volts": (vp, vk), "carry": (cp, ck)}))
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


def stereo_case(params, C, T, fs, dev, gen, label, thresh=None):
    """The linked stage against its plain version at C x 2 x T, bit for
    bit over four streamed blocks (the second ragged, the last an edge
    stream), the library's shared memory held to `agc_stereo_geometry`;
    then timed beside the route it replaces and K13 alone on the same
    inputs.  Returns (max |err|, ms, plain ms, route ms, K13 ms, bytes,
    geometry)."""
    kp = agc_ops.kernel_params(params, C)
    p = kp.scalars
    rows = None if kp.rows is None else torch.as_tensor(kp.rows, device=dev)
    srows = (None if kp.scan_rows is None
             else torch.as_tensor(kp.scan_rows, device=dev))
    w = params.attack_buffsize
    geo = agc_k.agc_stereo_geometry(C, T, w, rows is not None)
    smem = agc_k.AGC.lib().uhsdr_agc_stereo_smem(w)
    check(smem == geo.smem, f"{label} w={w}: the library's shared memory "
                            f"{smem} != agc_stereo_geometry's {geo.smem}")
    ck = cp = torch.zeros((agc_k.N_CARRY, C), device=dev)
    dk = dp = torch.zeros((C, 2, w), device=dev)
    err, t0, first = 0.0, 0, None
    for blk, Tk in enumerate((T, 1000, T, T)):
        x = torch.stack([agc_block(gen, dev, C, Tk, t0, fs),
                         0.5 * agc_block(gen, dev, C, Tk, t0, fs)], dim=1)
        if blk == 3:
            x = agc_edges(x)
        t0 += Tk
        if first is None:
            first = (ck, dk, x)
        yk, ck, dk = agc_k.agc_stereo(p, ck, dk, x, rows)
        yp, cp, dp = agc_k.agc_stereo_plain(p, cp, dp, x, rows)
        torch.cuda.synchronize()
        check(dk.untyped_storage().nbytes() == 4 * dk.numel(),
              f"{label}: the new delay line is a view")
        err = max(err, bits_held(f"{label} block {blk} ({Tk} steps)", {
            "audio": (yp, yk), "carry": (cp, ck), "delay": (dp, dk)}))
    c0, d0, x0 = first
    ms = cuda_ms(lambda: agc_k.agc_stereo(p, c0, d0, x0, rows), 10)
    route_ms = cuda_ms(lambda: trace_agc.replaced_route(p, c0, d0, x0, rows,
                                                        srows), 10)
    xf = torch.cat([d0, x0], dim=-1).abs().amax(dim=-2)
    rm0 = agc_k.look_ahead_max(xf, w, T).contiguous()
    ax0 = xf[:, :T].contiguous()
    k13_ms = cuda_ms(lambda: agc_k.agc_scan(p, c0, rm0, ax0, srows), 10)
    plain_ms = cuda_ms(lambda: agc_k.agc_stereo_plain(p, c0, d0, x0, rows),
                       1)
    # bytes: x in, y out, the delay line in and out, the carries in and
    # out (and the rows in)
    nbytes = (2 * C * 2 * T * 4 + 2 * C * 2 * w * 4
              + 2 * agc_k.N_CARRY * C * 4
              + (0 if rows is None else rows.numel() * 4))
    return err, ms, plain_ms, route_ms, k13_ms, nbytes, geo


def stereo_row(name, label, params, C, T, fs, dev, gen):
    err, ms, plain_ms, route_ms, k13_ms, nbytes, geo = stereo_case(
        params, C, T, fs, dev, gen, label)
    rec_ms = recurrence_ms(T, AGC_STEP_OPS)
    r = row(name, "agc.cu", "uhsdr_tpu/pallas/agc.py:126", err=err,
            snr=math.inf, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=60.0 * C * T, recurrence_ms=rec_ms,
            recurrence_blended_ms=recurrence_ms(T, AGC_STEP_OPS_BLENDED),
            route_ms=route_ms, k13_ms=k13_ms, tpu_kernel=False,
            channels=C, steps=T, w=params.attack_buffsize, smem=geo.smem,
            sm_blocks=geo.sm_blocks,
            library_note="no PyTorch call computes a look-ahead AGC")
    print(f"  {label} {C} x 2 x {T}, w {params.attack_buffsize}: {ms:.4f} "
          f"ms (the route it replaces {route_ms:.4f} ms, K13 in it "
          f"{k13_ms:.4f}; plain {plain_ms:.1f} ms; recurrence bound "
          f"{rec_ms:.4f} ms; {r['bound_by']} bound {r['bound_ms']:.4f} ms; "
          f"{geo.smem} B shared, {geo.sm_blocks} blocks an SM)")
    return r


def phase_agc_stereo(P, dev, gen):
    """The linked stereo AGC stage at the two-channel flagship's shape
    (8192 x 2 x 2048 at 12 kHz, w 48), bit for bit against its plain
    version, edge stream included; also SAM stereo's look-ahead (w 96 at
    24 kHz) at 1024 x 2 x 4096, the SAM stereo path's shape."""
    params = P["stereo"].agc
    T = STEREO.block_len // STEREO.decim
    r = stereo_row("agc_stereo", "stage", params, CHANNELS, T,
                   STEREO.fs_dec, dev, gen)
    sam = P["sam"].agc
    err96, ms96, plain96, route96, k13_96, nb96, geo96 = stereo_case(
        sam, DEPTH, SAM.block_len // SAM.decim, SAM.fs_dec, dev, gen,
        "stage w 96")
    r["max_abs_err"] = max(r["max_abs_err"], err96)
    r["w96"] = dict(channels=DEPTH, steps=SAM.block_len // SAM.decim,
                    ms=ms96, route_ms=route96, k13_ms=k13_96,
                    plain_ms=plain96, bound_ms=bound(nb96, 0)[0],
                    sm_blocks=geo96.sm_blocks)
    print(f"  stage w 96, {DEPTH} x 2 x {SAM.block_len // SAM.decim}: "
          f"{ms96:.4f} ms (route {route96:.4f}, K13 {k13_96:.4f})")
    return r


def phase_agc_stereo_rows(P, dev, gen):
    """The linked stage with per-channel rows at the `agc_stereo_rows`
    entry path's shape (8192 x 2 x 2048, 12 kHz, thresholds 40 ... 80
    dB), bit for bit against its plain version, edge stream included."""
    params = agc_ops.make_params(12000.0, thresh_db=STEREO_ROWS_THRESH)
    return stereo_row("agc_stereo_rows", "stage rows", params, CHANNELS,
                      STEREO_ROWS_T, 12000.0, dev, gen)


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


def grouped_edges(x: torch.Tensor) -> torch.Tensor:
    """An edge stream for K14 in place on rows 0-9 of x: zeros, -0, +inf,
    -inf, a NaN, -0 rows, subnormals in two rows, -0 every 7th sample."""
    T = x.shape[-1]
    x[0] = 0.0
    x[1] = -0.0
    x[2, T // 3] = math.inf
    x[3, T // 2] = -math.inf
    x[4, T // 5] = math.nan
    x[6] = -0.0
    x[7, ::3] = 1e-40
    x[8] = x[8] * 1e-39
    x[9, 5::7] = -0.0
    return x


def phase_biquad_grouped(P, dev, gen):
    """K14 at SAM's stacked allpass shape (16384 x 4096, both coefficient
    sets, groups of 32), three streamed blocks (the middle one of 1000
    samples ends inside a group and a tile), bit for bit against its plain
    version and at 90 dB against K11; then at each group length a block
    past the 512 groups PR 5's kernel took (1024 rows: 513 x 16, 20000
    at 32, 33000 at 64) and an edge stream from a NaN state, bit for
    bit.  Prints each instance's launch and its registers and spills
    (`cuobjdump --dump-resource-usage` of the library this run built)."""
    C, T = 2 * CHANNELS, SAM.block_len // SAM.decim
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    usage = iir_k.grouped_resources(iir_k.BIQUAD._lib_path())
    geos = {}
    for L in iir_k.GROUP_LENS:
        geo = iir_k.grouped_geometry(C, T, L, 7, sms)
        geos[L] = dict(geo._asdict(), resources=usage[L])
        print(f"  K14 L = {L}: {geo.warps} warps (rows) a block, "
              f"{geo.resident} blocks an SM, {geo.blocks} blocks, tiles of "
              f"{geo.tile} ({geo.tiles} a row), {geo.smem} B shared; "
              f"registers, stack and local (spill) bytes {usage[L]}")
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
            label = f"K14 set {cset} block {blk} ({Tk} samples)"
            s, e = held(label, {"audio vs K11": (yq, yk),
                                "state vs K11": (sq, sk)})
            bits_held(label, {"audio": (yp, yk), "state": (sp, sk)})
            worst, err = min(worst, s), max(err, e)
            del yk, yp, yq
        s0, x0 = first
        times[cset] = (cuda_ms(lambda: iir_k.biquad_cascade(
            sos, s0, x0, impl="grouped"), 10),
            cuda_ms(lambda: iir_k.biquad_grouped_plain(sos, s0, x0), 2),
            cuda_ms(lambda: iir_k.biquad_cascade(sos, s0, x0), 10))
        del first, s0, x0
    sos = P["sam"].sam.ap_sos[1]
    S = sos.shape[0]
    R = GROUPED_LONG_ROWS
    for L, Tl in ((16, 513 * 16), (32, 20000), (64, 33000)):
        s0 = torch.randn((S, R, 2), generator=gen, device=dev) * 1e-2
        x = torch.randn((R, Tl), generator=gen, device=dev) * 0.1
        yk, sk = iir_k.biquad_cascade(sos, s0, x, impl="grouped",
                                      group_len=L)
        yp, sp = iir_k.biquad_grouped_plain(sos, s0, x, L)
        yq, sq = iir_k.biquad_cascade(sos, s0, x)
        torch.cuda.synchronize()
        label = f"K14 L = {L}, {R} x {Tl} ({-(-Tl // L)} groups)"
        held(label, {"audio vs K11": (yq, yk), "state vs K11": (sq, sk)})
        bits_held(label, {"audio": (yp, yk), "state": (sp, sk)})
        # the edge stream from a NaN state in row 5, -0 states in row 6
        s0[3, 5, 0] = math.nan
        s0[:, 6] = -0.0
        sk = sp = s0
        for Te in (64 * L, 40 * L + 7):
            x = grouped_edges(torch.randn((R, Te), generator=gen,
                                          device=dev) * 0.1)
            yk, sk = iir_k.biquad_cascade(sos, sk, x, impl="grouped",
                                          group_len=L)
            yp, sp = iir_k.biquad_grouped_plain(sos, sp, x, L)
            torch.cuda.synchronize()
            bits_held(f"K14 L = {L} edge stream ({Te} samples)",
                      {"audio": (yp, yk), "state": (sp, sk)})
            check(bool(yk[5].isnan().all()) and bool(
                torch.isfinite(yk[10:]).all()),
                  f"K14 L = {L} edge stream: NaNs where they do not belong")
        del x, yk, yp, yq, sk, sp, sq
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
                      k11_ms=times[1][2]), geometry=geos)
    print(f"  K14 biquad_grouped ({S} sections, {C} x {T}, groups of 32): "
          f"{ms:.4f} ms, set 1 {times[1][0]:.4f} ms (K11 {k11_ms:.4f} / "
          f"{times[1][2]:.4f} ms; plain {plain_ms:.1f} ms; bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']})")
    return r


def mt_stream(h, g, delta, decim, C, lengths, dtype, dev, gen, label):
    """K15 against its plain version over streamed blocks of `lengths`
    samples from zero carries and seeded NCO phases: audio, the stage-B
    carry and the peaks at >= FIR_TOL_DB, the raw carry bit-equal.
    Returns (min SNR, max abs err, the first block's inputs)."""
    taps = h.shape[-1]
    ck = cp = torch.zeros((C, taps - 1), dtype=torch.complex64, device=dev)
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
        yk, ck, c2k, pk_k = fir_k.front_mt(h, g, ck, c2k, xi, xq, phase,
                                           delta, decim)
        yp, cp, c2p, pk_p = fir_k.front_mt_plain(h, g, cp, c2p, xi, xq,
                                                 phase, delta, decim)
        torch.cuda.synchronize()
        check(tuple(yk.shape) == (C, Bk // decim),
              f"{label} output {tuple(yk.shape)}")
        check(torch.equal(cp, ck), f"{label} block {blk}: raw carry not "
                                   "bit-equal")
        s, e = held(f"{label} block {blk} ({Bk} samples)", {
            "audio": (yp, yk), "front2 carry": (c2p, c2k),
            "peaks": (pk_p, pk_k)})
        check(s >= FIR_TOL_DB, f"{label} block {blk}: {s:.1f} dB < "
                               f"{FIR_TOL_DB} dB")
        worst, err = min(worst, s), max(err, e)
        phase = nco.advance(phase, delta, Bk)
    return worst, err, first


def phase_front_mt(P, dev, gen):
    """K15, K1's register-blocked kernel with complex stage-A taps, at the
    SSB flagship's front (8192 ch x 16384 int16, 227 + 199 taps,
    decimation 8): three streamed blocks, the middle one of 800 samples
    (shorter than the stage-A history's span at the decimated rate); then
    64 channels at every other rate and plane type the mono rows send it
    (int16 and f32 at 48 and 192 kHz, f32 at 96 kHz), each with a ragged
    middle block; its output at FIR_TOL_DB, its raw carry bit-equal.  Its
    shared-memory rule in the library and in cuda/fir.py must agree at
    every mono shape.  Timed beside K1 on the same inputs."""
    lib = fir_k.FRONT.lib()
    for rate in (48000.0, 96000.0, 192000.0):
        cfg = dataclasses.replace(CFG, iq_rate=rate)
        p = rx.make_params(cfg, "cpu")
        taps, taps2, decim = (p.front_fir.shape[-1], p.front2.shape[-1],
                              cfg.decim)
        for size in (2, 4):
            want = fir_k.front_mt_geometry(taps, taps2, decim, size).smem
            got = lib.uhsdr_front_mt_smem(taps, taps2, decim, size)
            check(got == want, f"K15 shared memory at {rate:.0f} Hz, "
                               f"{size}-byte samples: library {got}, "
                               f"cuda/fir.py {want}")
    params = P["ssb"]
    C, B, decim = CHANNELS, CFG.block_len, CFG.decim
    h, g, delta = params.front_fir, params.front2, params.nco_delta
    taps, taps2 = h.shape[-1], g.shape[-1]
    worst, err, first = mt_stream(h, g, delta, decim, C, (B, 800, B),
                                  torch.int16, dev, gen, "K15")
    for rate, dtype, mid in ((48000.0, torch.int16, 2000),
                             (48000.0, torch.float32, 6000),
                             (96000.0, torch.float32, 9000),
                             (192000.0, torch.int16, 5008),
                             (192000.0, torch.float32, 1600)):
        cfg = dataclasses.replace(CFG, iq_rate=rate)
        p = rx.make_params(cfg, dev)
        s, e, _ = mt_stream(
            p.front_fir, p.front2, p.nco_delta, cfg.decim, 64, (B, mid, B),
            dtype, dev, gen,
            f"K15 {rate / 1000:.0f} kHz {str(dtype)[6:]} decim {cfg.decim}")
        worst, err = min(worst, s), max(err, e)
    ck0, c2k0, xi, xq, ph0 = first
    ms = cuda_ms(lambda: fir_k.front_mt(h, g, ck0, c2k0, xi, xq, ph0, delta,
                                        decim), 10)
    plain_ms = cuda_ms(lambda: fir_k.front_mt_plain(h, g, ck0, c2k0, xi, xq,
                                                    ph0, delta, decim), 2)
    k1_ms = cuda_ms(lambda: fir_k.front(h, g, ck0, c2k0, xi, xq, ph0, delta,
                                        decim), 10)
    # work: stage A with complex taps, 4 FMAs a tap per output; stage B as
    # K1's; bytes as K1's, the stage-A taps complex
    T_out = B // decim
    fma = C * T_out * (4 * taps + 2 * taps2)
    nbytes = (2 * C * B * 2 + C * T_out * 4 + 2 * C * (taps - 1) * 8
              + 2 * C * (taps2 - 1) * 8 + C * 8 + C * 4
              + 4 * (2 * taps + 2 * taps2))
    geo = fir_k.front_mt_geometry(taps, taps2, decim)
    r = row("front_mt", "front.cu", "uhsdr_tpu/pallas/fir.py:287", err=err,
            snr=worst, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=2.0 * fma, k1_ms=k1_ms, smem=geo.smem, t_tile=geo.t_tile,
            library_note="no one PyTorch call mixes, decimates and runs "
                         "both FIR stages")
    print(f"  K15 front_mt: {ms:.4f} ms (K1 {k1_ms:.4f} ms in this call; "
          f"plain {plain_ms:.3f} ms, bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']}: {fma / 1e9:.2f} G FMA, "
          f"{nbytes / 2**20:.0f} MiB; {r['bound_ms'] / ms:.1%} of it; "
          f"tiles of {geo.t_tile} outputs, {geo.smem} B shared)")
    return r


# ---------------------------------------------------------------------------
# the main paths
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the RX options' helper kernels (no TPU counterpart: the JAX package runs
# each as a lax.scan): IQ correction, NLMS / leaky LMS, the noise blanker,
# the spectral NR's gain machine
# ---------------------------------------------------------------------------

def opt_edges(x: torch.Tensor, n0: int) -> torch.Tensor:
    """x (C, T) f32 with edge samples by channel class c % 6: 1 every 11th
    sample one of +-0, subnormals, 3e38, +-inf; 2 exact zeros (-0 at odd
    samples); 3 subnormal; 4 one NaN at stream sample 300; 5 scaled to
    1e30; 0 as given."""
    x = x.clone()
    C, T = x.shape
    dev = x.device
    n = torch.arange(n0, n0 + T, device=dev)
    special = torch.tensor([0.0, -0.0, 1e-45, -3e-42, 1e-39, 3e38,
                            -math.inf, math.inf], device=dev)
    cls = torch.arange(C, device=dev) % 6
    pick = n % 11 == 3
    ri, ci = (cls == 1).nonzero()[:, 0], pick.nonzero()[:, 0]
    x[ri[:, None], ci[None, :]] = special[(n[pick] // 11) % special.numel()]
    x[cls == 2] = torch.where(n % 2 == 1, -0.0, 0.0)
    x[cls == 3] *= 1e-41
    if n0 <= 300 < n0 + T:
        x[cls == 4, 300 - n0] = math.nan
    x[cls == 5] *= 1e30
    return x


def same_bits(name: str, pairs: dict) -> float:
    """`bits_held` over float pairs (complex as their planes), equality
    over bool and integer ones."""
    flt = {}
    for what, (a, b) in pairs.items():
        if a.dtype in (torch.bool, torch.int32, torch.int64):
            n = int((a != b).sum())
            print(f"  {name} {what}: {n} of {a.numel()} differ")
            check(n == 0, f"{name} {what}: {n} elements differ")
        elif a.is_complex():
            flt[what] = (torch.view_as_real(a), torch.view_as_real(b))
        else:
            flt[what] = (a, b)
    return bits_held(name, flt)


def opt_audio(gen, dev, C, T, t0, fs=12000.0, impulses=False):
    """Decimated-rate audio: a tone gated at 0.35 Hz plus noise, per
    channel its own level; with `impulses`, impulses of 4000-9000 times
    the noise every 97 samples and at the edges of frames and blocks."""
    n = torch.arange(t0, t0 + T, device=dev, dtype=torch.float64)
    c = torch.arange(C, device=dev, dtype=torch.float64)[:, None]
    gate = (torch.sin(2 * math.pi * 0.35 / fs * n) > 0).double()
    x = (0.3 * torch.sin(2 * math.pi * (700.0 + 3.0 * (c % 50)) / fs * n)
         * (0.2 + gate) * (1.0 + (c % 7)))
    x = x + 0.05 * torch.randn((C, T), generator=gen, device=dev,
                               dtype=torch.float64)
    if impulses:
        hit = ((n.long() % 97) == 5) | ((n.long() % 128) == 126) | (
            (n.long() % 128) == 2)
        k = int(hit.sum())
        sign = torch.randint(0, 2, (C, k), generator=gen, device=dev) * 2 - 1
        x[:, hit] += sign * (4.0 + 5.0 * torch.rand(
            (C, k), generator=gen, device=dev, dtype=torch.float64))
    return x.float().contiguous()


def phase_iqcorr(P, dev, gen):
    """The IQ correction at the SSB flagship (8192 ch x 16384 int16),
    three streamed blocks (16384, 4096, 16384) with an imbalance of gain
    1.07 and phase 0.06 on the planes, then an edge stream of f32 planes
    (8192 x 4096, a NaN state channel), bit for bit against its plain
    version on every output and state leaf; channels 0-7 alone bit-equal
    to the batch."""
    C = CHANNELS
    T = CFG.block_len
    z = torch.zeros((C,), device=dev)
    tk = tp = (z, z, z)
    err, first = 0.0, None
    for blk, B in enumerate((T, 4096, T)):
        i, q = iq_block(gen, dev, C, B)
        i = (i.float() * 1.07).round().clamp(-32768, 32767).to(torch.int16)
        q = (q.float() + 0.06 * i.float()).round().clamp(
            -32768, 32767).to(torch.int16)
        if first is None:
            first = (i, q)
        got = iq_k.iqcorr(*tk, i, q)
        ref = iq_k.iqcorr_plain(*tp, i, q)
        torch.cuda.synchronize()
        err = max(err, same_bits(f"iqcorr block {blk} ({B} int16)", dict(
            zip(("i", "q", "t1", "t2", "t3", "c1", "c2", "twin"),
                zip(ref, got)))))
        tk, tp = got[2:5], ref[2:5]
    check(bool((got[6] != 1.0).all()), "iqcorr: c2 never moved")
    ts = [z.clone(), z.clone(), z.clone()]
    ts[1][C // 2] = math.nan
    for blk in range(2):
        i = opt_edges(torch.randn((C, 4096), generator=gen, device=dev)
                      * 0.1, 4096 * blk)
        q = opt_edges(torch.randn((C, 4096), generator=gen, device=dev)
                      * 0.1, 4096 * blk + 5)
        got = iq_k.iqcorr(*ts, i, q)
        ref = iq_k.iqcorr_plain(*ts, i, q)
        torch.cuda.synchronize()
        err = max(err, same_bits(f"iqcorr edge block {blk}", dict(
            zip(("i", "q", "t1", "t2", "t3", "c1", "c2", "twin"),
                zip(ref, got)))))
        ts = list(got[2:5])
    i, q = first
    full = iq_k.iqcorr(z, z, z, i, q)
    one = iq_k.iqcorr(z[:8], z[:8], z[:8], i[:8].contiguous(),
                      q[:8].contiguous())
    torch.cuda.synchronize()
    check(all(torch.equal(a[:8], b) for a, b in zip(full, one)),
          "iqcorr: channels 0-7 alone differ from the batch")
    del full
    ms = cuda_ms(lambda: iq_k.iqcorr(z, z, z, i, q), 10)
    plain_ms = cuda_ms(lambda: iq_k.iqcorr_plain(z, z, z, i, q), 1)
    # int16 planes in, f32 planes out, the state; about 10 f32 operations
    # a sample (sign q, |i|, |q|, three tree adds, q + c1 i, i c2)
    nbytes = 2 * C * T * 2 + 2 * C * T * 4 + 5 * C * 4 * 2
    geo = iq_k.iqcorr_geometry(C, T)
    r = row("iqcorr", "iqcorr.cu", "uhsdr_tpu/ops/iqcorr.py:56", err=err,
            snr=math.inf, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=10.0 * C * T, tpu_kernel=False,
            library_note="no PyTorch call computes the IQ correction")
    # under -fmad=false an FP32 operation is an instruction: the issue
    # floor is twice the FLOP bound
    print(f"  iqcorr at {C} x {T} int16: {ms:.4f} ms (plain "
          f"{plain_ms:.1f} ms; bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']}, {r['bound_ms'] / ms:.1%} of it; issue floor "
          f"{2 * 10.0 * C * T / PEAK_FP32_S * 1e3:.4f} ms); bit for bit, "
          f"edge streams too; channels 0-7 alone bit-equal; rule: "
          f"{geo.chunks} chunks of {geo.chunk} sub-blocks, {geo.blocks} "
          f"blocks of {iq_k.iqcorr_smem()} B shared, {iq_k.STAGES} stages; "
          f"the runtime's blocks an SM "
          f"{iq_k._lib().uhsdr_iqcorr_occupancy(1)} (the rule's "
          f"{iq_k.MIN_BLOCKS})")
    return r


def lms_stream(kind, params, C, lengths, dev, gen, edge=False):
    """One LMS instance against its plain version over streamed blocks
    from a fresh state (with `edge`, a NaN weight in one channel and the
    edge samples), bit for bit on the output and every state leaf.
    Returns max |err|."""
    leaky = kind.startswith("leaky")
    L, D = params.num_taps, params.delay
    st = [torch.zeros((C, L), device=dev), torch.zeros((C, L + D),
                                                       device=dev)]
    if leaky:
        st += [torch.full((C,), 120.0, device=dev),
               torch.full((C,), 0.001, device=dev)]
    if edge:
        st[0][C // 2, 3] = math.nan
    sp, err, t0 = list(st), 0.0, 0
    for blk, T in enumerate(lengths):
        x = opt_audio(gen, dev, C, T, t0)
        if edge:
            x = opt_edges(x, t0)
        t0 += T
        if leaky:
            got = lms_k.leaky(params, *st, x)
            ref = lms_k.leaky_plain(params, *sp, x)
        else:
            got = lms_k.nlms(params, *st, x)
            ref = lms_k.nlms_plain(params, *sp, x)
        torch.cuda.synchronize()
        err = max(err, same_bits(
            f"{kind}{' edge' if edge else ''} block {blk} ({T} samples)",
            dict(zip(("y", "w", "hist", "lidx", "ngamma"), zip(ref, got)))))
        st, sp = list(got[1:]), list(ref[1:])
    return err


def phase_lms(P, dev, gen):
    """Both kernels of lms.cu at the SSB flagship's decimated rate (8192
    ch x 2048 @ 12 kHz), bit for bit against their plain versions: the
    96-tap notch (error out) over 2048 + 777 + 2048 samples, the 64-tap
    NLMS NR (prediction out) over 1024 + 1024, the leaky NR (prediction)
    over 2048 + 777 + 2048, the leaky notch (error) over 1024 + 1024 and
    the 96-tap leaky NR over 1024 + 777; edge streams (a NaN weight, 512 +
    512) for the notch and the leaky NR; channels 0-7 alone bit-equal to
    the batch; the leaky kernel's reciprocal against div.rn over every f32
    of its range.  Timed at 8192 x 2048."""
    C, T = CHANNELS, CFG.block_len // CFG.decim
    kinds = {"notch": lms_ops.notch_params(), "nlms_nr": lms_ops.nr_params(),
             "leaky": lms_ops.leaky_lms_params(),
             "leaky_notch": lms_ops.leaky_lms_params(notch=True),
             "leaky96": lms_ops.leaky_lms_params(num_taps=96)}
    bad, n_rcp = lms_k.rcp_check(dev)
    print(f"  lms_leaky's reciprocal: {bad} of {n_rcp} f32 differ from "
          f"div.rn")
    check(bad == 0 and n_rcp == 2 * 252 * 2 ** 23,
          f"lms_leaky: the reciprocal differs from div.rn on {bad} inputs")
    err = {"lms": 0.0, "lms_leaky": 0.0}
    for kind, lengths in (("notch", (T, 777, T)), ("nlms_nr", (1024, 1024)),
                          ("leaky", (T, 777, T)),
                          ("leaky_notch", (1024, 1024)),
                          ("leaky96", (1024, 777))):
        name = "lms_leaky" if kind.startswith("leaky") else "lms"
        err[name] = max(err[name], lms_stream(kind, kinds[kind], C, lengths,
                                              dev, gen))
    for kind in ("notch", "leaky"):
        name = "lms_leaky" if kind.startswith("leaky") else "lms"
        err[name] = max(err[name], lms_stream(kind, kinds[kind], C,
                                              (512, 512), dev, gen,
                                              edge=True))
    x = opt_audio(gen, dev, C, T, 0)
    rows_out = []
    for name, kind in (("lms", "notch"), ("lms_leaky", "leaky")):
        p = kinds[kind]
        L, D = p.num_taps, p.delay
        st = [torch.zeros((C, L), device=dev),
              torch.zeros((C, L + D), device=dev)]
        if name == "lms_leaky":
            st += [torch.full((C,), 120.0, device=dev),
                   torch.full((C,), 0.001, device=dev)]
            run = lms_k.leaky
            plain = lms_k.leaky_plain
        else:
            run, plain = lms_k.nlms, lms_k.nlms_plain
        full = run(p, *st, x)
        one = run(p, *(t[:8].contiguous() for t in st), x[:8].contiguous())
        torch.cuda.synchronize()
        check(all(torch.equal(a[:8], b) for a, b in zip(full, one)),
              f"{name}: channels 0-7 alone differ from the batch")
        ms = cuda_ms(lambda: run(p, *st, x), 10)
        plain_ms = cuda_ms(lambda: plain(p, *st, x), 1)
        # the FP32 operations a sample that the function needs (a new
        # square a sample for the norm or sigma; the notch's leak of 1
        # without products) and, for the NLMS, that the kernel issues
        # (`cuda/lms.py`); x in, y out, the weights and history in and out
        if name == "lms_leaky":
            geo = lms_k.leaky_geometry(C, T, L, D)
            ops = issued = lms_k.leaky_ops(L)
        else:
            geo = lms_k.nlms_geometry(C, T, L, D)
            ops = lms_k.nlms_ops(L, p.leak)
            issued = lms_k.nlms_issued_ops(L, p.leak)
        nbytes = 2 * C * T * 4 + 2 * C * (2 * L + D) * 4
        r = row(name, "lms.cu", "uhsdr_tpu/ops/lms.py:"
                + ("96" if name == "lms_leaky" else "133"), err=err[name],
                snr=math.inf, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
                flops=C * T * ops, tpu_kernel=False, taps=L, delay=D,
                library_note="no PyTorch call computes an adaptive filter")
        # under -fmad=false an FP32 operation is an instruction: the issue
        # floor is twice the FLOP bound
        print(f"  {name} ({kind}, {L} taps, delay {D}) at {C} x {T}: "
              f"{ms:.4f} ms (plain {plain_ms:.1f} ms; bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({ops:.0f} a "
              f"sample), {r['bound_ms'] / ms:.1%} of it; issue floor "
              f"{2 * r['bound_ms']:.4f} ms, of what the kernel issues "
              f"({issued:.0f} a sample) "
              f"{2 * C * T * issued / PEAK_FP32_S * 1e3:.4f} ms); bit for "
              f"bit, edge streams too; channels 0-7 alone bit-equal; rule: "
              f"{geo}")
        rows_out.append(r)
    return rows_out


def blanker_flops(frames: int, slots: float) -> float:
    """FP32 operations of the blanker's kernel, counted from
    kernels/blanker.cu, for `frames` frames running `slots` repair slots
    each on average.  A frame: R 2750 ((128 - i) products and 127 sums a
    lag), Levinson 241, the two filters 5632 (11 products and sums an
    output), the mean, the variance, the LPC power and the threshold 535,
    the candidates 830 (|d|, the window max from pairs and quads, two
    tests a sample), the outputs' and the context's x * 1 + 0 308; a slot
    370 (its 20 contexts' x * 1 + 0, the two 7-step predictions of 10
    products and 9 sums, the cross-fade and the window's blend)."""
    return frames * (2750 + 241 + 5632 + 535 + 830 + 308 + 370 * slots)


def phase_blanker(P, dev, gen):
    """The noise blanker at the SSB flagship's decimated rate (8192 ch x
    2048 @ 12 kHz), impulsive audio over 2048 + 256 + 2048 samples (repairs
    across frames and blocks), then an edge stream (a NaN in a carried
    context, 1024 + 1024), then a block without impulses, bit for bit
    against its plain version on the output and the context; channels 0-7
    alone bit-equal to the batch.  Timed on the impulsive block (the row's
    time) and on the block without impulses, each with the mean candidates
    found a frame and the slots the kernel runs."""
    C, T = CHANNELS, CFG.block_len // CFG.decim
    mult = nb_mod.make_params(8).threshold_mult
    err = 0.0
    for edge, lengths in ((False, (T, 256, T)), (True, (1024, 1024))):
        ck = torch.zeros((C, nb_k.CONTEXT), device=dev)
        if edge:
            ck[C // 2, 20] = math.nan
        cp, t0 = ck, 0
        for blk, B in enumerate(lengths):
            x = opt_audio(gen, dev, C, B, t0, impulses=True)
            if edge:
                x = opt_edges(x, t0)
            t0 += B
            yk, ck = nb_k.blanker(mult, ck, x)
            yp, cp = nb_k.blanker_plain(mult, cp, x)
            torch.cuda.synchronize()
            err = max(err, same_bits(
                f"blanker{' edge' if edge else ''} block {blk} ({B})",
                {"y": (yp, yk), "context": (cp, ck)}))
    x = opt_audio(gen, dev, C, T, 0, impulses=True)
    xq = opt_audio(gen, dev, C, T, 0)
    c0 = torch.zeros((C, nb_k.CONTEXT), device=dev)
    yq, cq = nb_k.blanker(mult, c0, xq)
    yqp, cqp = nb_k.blanker_plain(mult, c0, xq)
    torch.cuda.synchronize()
    err = max(err, same_bits("blanker no impulse", {"y": (yqp, yq),
                                                    "context": (cqp, cq)}))
    y, c = nb_k.blanker(mult, c0, x)
    y8, c8 = nb_k.blanker(mult, c0[:8], x[:8].contiguous())
    torch.cuda.synchronize()
    delayed = torch.cat([c0[:, nb_k.DELAY:], x], dim=-1)[:, :T]
    n_rep = int((y != delayed).sum())
    print(f"  blanker: {n_rep} of {y.numel()} samples repaired at {C} x {T}")
    check(n_rep > 0, "blanker: nothing repaired")
    check(torch.equal(y[:8], y8) and torch.equal(c[:8], c8),
          "blanker: channels 0-7 alone differ from the batch")
    frames = C * T // nb_k.FRAME
    found, times = {}, {}
    for label, xin in (("impulsive", x), ("no impulse", xq)):
        n = nb_k.candidates(mult, c0, xin)
        fnd = float(n.clamp(max=nb_k.MAX_IMPULSES).float().mean())
        slots = float((n + 2).clamp(max=nb_k.MAX_IMPULSES).float().mean())
        ms = cuda_ms(lambda: nb_k.blanker(mult, c0, xin), 10)
        fl = blanker_flops(frames, slots)
        found[label], times[label] = (fnd, slots, fl), ms
        print(f"  blanker {label} at {C} x {T}: {ms:.4f} ms; candidates "
              f"found a frame {fnd:.3f} (of at most 5), slots run "
              f"{slots:.3f}; {fl / (C * T):.1f} FP32 operations a sample")
    plain_ms = cuda_ms(lambda: nb_k.blanker_plain(mult, c0, x), 1)
    # x in, y out, the context in and out
    nbytes = 2 * C * T * 4 + 2 * C * nb_k.CONTEXT * 4
    fnd, slots, fl = found["impulsive"]
    r = row("blanker", "blanker.cu", "uhsdr_tpu/nr/blanker.py:236", err=err,
            snr=math.inf, ms=times["impulsive"], plain_ms=plain_ms,
            nbytes=nbytes, flops=fl, tpu_kernel=False, repaired=n_rep,
            found_per_frame=fnd, slots_per_frame=slots,
            ms_no_impulse=times["no impulse"],
            found_per_frame_no_impulse=found["no impulse"][0],
            library_note="no PyTorch call computes the LPC blanker")
    print(f"  blanker at {C} x {T}: {r['ms']:.4f} ms (no impulse "
          f"{times['no impulse']:.4f}; plain {plain_ms:.1f} ms; bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']}, operations "
          f"{fl / PEAK_FP32_S * 1e3:.4f} ms); bit for bit, edge streams "
          f"too; channels 0-7 alone bit-equal")
    return r


def nr_spectra(gen, dev, C, nF, f0, edge=False):
    x = opt_audio(gen, dev, C, (nF + 1) * 128, f0 * 128)
    if edge:
        x = opt_edges(x, f0 * 128)
    win = torch.as_tensor(fftutil.sqrt_hann_sym(256), device=dev)
    return torch.fft.rfft(fftutil.frame_overlap(x, 256, 128) * win, dim=-1)


def phase_nr(P, dev, gen):
    """The spectral NR's gain machine at the SSB flagship's decimated rate
    (8192 ch x 16 frames of 129 bins: 2048 samples @ 12 kHz), three
    streamed blocks through the 20-frame bootstrap and past it, then an
    edge stream (a NaN in xt, 8 + 8 frames), bit for bit against its
    plain version on the weighted spectra and every state leaf; channels
    0-7 alone bit-equal to the batch."""
    C, nF = CHANNELS, CFG.block_len // CFG.decim // 128
    nrp = rx.make_params(dataclasses.replace(CFG, nr_enable=True), dev).nr
    g = nr_k.gain_params(nrp)
    err = 0.0
    for edge, frames in ((False, (nF, nF, nF)), (True, (8, 8))):
        s = nr_mod.init_state((C,), device=dev)
        st = [s.xt, s.pslp, s.hk_old, s.init_count, s.nest_acc]
        if edge:
            st[0] = st[0].clone()
            st[0][C // 2, 40] = math.nan
        sp, f0 = list(st), 0
        for blk, n in enumerate(frames):
            F = nr_spectra(gen, dev, C, n, f0, edge)
            f0 += n
            got = nr_k.nr_gains(g, F.clone(), *st)
            ref = nr_k.nr_gains_plain(g, F, *sp)
            torch.cuda.synchronize()
            err = max(err, same_bits(
                f"nr{' edge' if edge else ''} block {blk} ({n} frames)",
                dict(zip(("F", "xt", "pslp", "hk_old", "init_count",
                          "nest_acc"), zip(ref, got)))))
            st, sp = list(got[1:]), list(ref[1:])
    F = nr_spectra(gen, dev, C, nF, 0)
    s = nr_mod.init_state((C,), device=dev)
    st = [s.xt, s.pslp, s.hk_old, s.init_count, s.nest_acc]
    full = nr_k.nr_gains(g, F.clone(), *st)
    one = nr_k.nr_gains(g, F[:8].clone(), *(t[:8].contiguous() for t in st))
    torch.cuda.synchronize()
    check(all(torch.equal(a[:8], b) for a, b in zip(full, one)),
          "nr: channels 0-7 alone differ from the batch")
    del full
    Fk = F.clone()
    ms = cuda_ms(lambda: nr_k.nr_gains(g, Fk, *st), 10)
    plain_ms = cuda_ms(lambda: nr_k.nr_gains_plain(g, F, *st), 1)
    # the spectra in and out (complex64), four (C, 128) state planes and
    # the counter in and out; ~70 f32 operations a bin and frame
    nbytes = 2 * C * nF * 129 * 8 + 2 * (4 * C * 128 * 4 + C * 4)
    r = row("nr", "nr.cu", "uhsdr_tpu/nr/spectral.py:213", err=err,
            snr=math.inf, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=70.0 * C * nF * 128, tpu_kernel=False,
            library_note="no PyTorch call computes the NR's gain machine "
                         "(its FFTs are cuFFT, outside the kernel)")
    print(f"  nr at {C} x {nF} frames: {ms:.4f} ms (plain {plain_ms:.1f} "
          f"ms; bound {r['bound_ms']:.4f} ms by {r['bound_by']}); bit for "
          f"bit, edge streams too; channels 0-7 alone bit-equal")
    return r


def lattice_stream(pk, pv, C, lengths, dev, gen, label, edge=False,
                   scale=1000.0):
    """The lattice kernel against its plain version over streamed blocks
    from a zero state (with `edge`, a NaN state channel and the edge
    samples), bit for bit on y and the state.  Returns (max |err|, the
    first block's input)."""
    N = len(pk)
    sk = torch.zeros((C, N), device=dev)
    if edge:
        sk[C // 2, N // 2] = math.nan
    sp, err, t0, first = sk, 0.0, 0, None
    for blk, T in enumerate(lengths):
        x = torch.randn((C, T), generator=gen, device=dev) * scale
        if edge:
            x = opt_edges(x, t0)
        t0 += T
        first = x if first is None else first
        yk, sk = lat_k.lattice(pk, pv, sk, x)
        yp, sp = lat_k.lattice_plain(pk, pv, sp, x)
        torch.cuda.synchronize()
        err = max(err, bits_held(f"{label} block {blk} ({T} samples)",
                                 {"y": (yp, yk), "state": (sp, sk)}))
    return err, first


def phase_lattice(P, dev, gen):
    """The IIR lattice (lattice.cu) at the reference chain's PreFilter
    shape (8192 ch x 4096 @ 12 kHz, IIR_2k3_1k412's 10 stages) over 4096 +
    1000 + 4096 samples, then at each stage count the tables have (6, 8,
    10) and made-up stable lattices of every other count from 1 to 12
    (1024 x 600 + 77), an edge stream (a NaN state channel; +-0, +-inf, a
    NaN, subnormals, 1e30), bit for bit against its plain version on y and
    the state; channels 0-7 alone against the batch.  Timed at the
    PreFilter's shape and the FM TX voice lattice's (8192 x 16384); the
    plain loop at 256 samples.  Its walker's FADD and FMUL at 10 stages
    are read from `cuobjdump -sass` of this run's build, beside the
    schedule's count (trace_lattice_fm.py's)."""
    C = CHANNELS
    T = REF.block_len // REF.decim
    pk, pv = refdata.lattice(REF.path["pre"])
    check(len(pk) == 10, f"PreFilter lattice {len(pk)} stages")
    err, x0 = lattice_stream(pk, pv, C, (T, 1000, T), dev, gen,
                             "lattice N=10")
    rng = np.random.default_rng(11)
    for name in ("IIR_aa_10k", "IIR_8k_LPF", "IIR_TX_2k7_FM", 1, 2, 3, 4, 5,
                 7, 9, 11, 12):
        if isinstance(name, int):
            k = rng.uniform(-0.8, 0.8, name).astype(np.float32)
            v = rng.uniform(-1.0, 1.0, name + 1).astype(np.float32)
        else:
            k, v = refdata.lattice(name)
        err = max(err, lattice_stream(k, v, 1024, (600, 77), dev, gen,
                                      f"lattice {name} N={len(k)}")[0])
    err = max(err, lattice_stream(pk, pv, C, (1000, 777), dev, gen,
                                  "lattice edge", edge=True)[0])
    s0 = torch.zeros((C, 10), device=dev)
    full = lat_k.lattice(pk, pv, s0, x0)
    one = lat_k.lattice(pk, pv, s0[:8].contiguous(), x0[:8].contiguous())
    torch.cuda.synchronize()
    check(all(torch.equal(a[:8], b) for a, b in zip(full, one)),
          "lattice: channels 0-7 alone differ from the batch")
    del full
    ms = cuda_ms(lambda: lat_k.lattice(pk, pv, s0, x0), 10)
    TP = 256
    xp = x0[:, :TP].contiguous()
    plain_ms = cuda_ms(lambda: lat_k.lattice_plain(pk, pv, s0, xp), 1)
    kv, vv = refdata.lattice("IIR_TX_2k7_FM")
    TT = TXF.block_len
    xt = torch.randn((C, TT), generator=gen, device=dev) * 1000.0
    ms_tx = cuda_ms(lambda: lat_k.lattice(kv, vv, s0, xt), 10)
    # x in, y out, the state in and out; a stage's three products and
    # three sums, and the output's product and sum
    N = 10
    nbytes = 2 * C * T * 4 + 2 * C * N * 4
    rec_ms = recurrence_ms(T, lat_k.LATTICE_STEP_CHAIN)
    sass_fp, sass_all, _ = trace_lattice_fm.sass_lattice(
        lat_k.LATTICE._lib_path(), N)
    sass_want = (trace_lattice_fm.LATTICE_WU["whole"] + 1) * (6 * N + 4)
    r = row("lattice", "lattice.cu", "uhsdr_tpu/ops/lattice.py:33",
            err=err, snr=math.inf, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=(6.0 * N + 2.0) * C * T, recurrence_ms=rec_ms,
            tpu_kernel=False, plain_steps=TP, ms_tx_voice=ms_tx,
            bound_tx_voice_ms=bound(2 * C * TT * 4 + 2 * C * N * 4,
                                    (6.0 * N + 2.0) * C * TT)[0],
            sass_fp32=sass_fp, sass_instructions=sass_all,
            library_note="no PyTorch call computes a lattice filter")
    print(f"  lattice at {C} x {T}, 10 stages: {ms:.4f} ms (plain "
          f"{plain_ms:.1f} ms at {TP} samples; recurrence bound "
          f"{rec_ms:.4f} ms; {r['bound_by']} bound {r['bound_ms']:.4f} ms); "
          f"at {C} x {TT} (FM TX voice): {ms_tx:.4f} ms (bound "
          f"{r['bound_tx_voice_ms']:.4f} ms); bit for bit, every stage "
          f"count 1-12, edge streams too; channels 0-7 alone bit-equal; "
          f"SASS of lattice_kernel<10>: {sass_fp} FADD/FMUL (the "
          f"schedule's {sass_want}), {sass_all} instructions")
    return r


def fm_mod_stream(p, C, lengths, dev, gen, label, sub=False, edge=False):
    """fm_mod.cu against its plain version over streamed blocks of
    count-domain audio from a zero state (with `sub` a subtone plane; with
    `edge`, a NaN pre-emphasis state channel and the edge samples), bit
    for bit on the IQ and every state leaf.  Returns (max |err|, the
    first block's input)."""
    z = torch.zeros((C,), device=dev)
    st = [z.clone(), z.clone(), torch.zeros((C,), dtype=torch.int32,
                                            device=dev)]
    if edge:
        st[1][C // 2] = math.nan
    sp, err, t0, first = list(st), 0.0, 0, None
    for blk, T in enumerate(lengths):
        x = tx_level_block(gen, dev, C, T, t0)
        if edge:
            x = opt_edges(x, t0)
        add = (torch.randn((C, T), generator=gen, device=dev) * 0.01
               if sub else None)
        t0 += T
        first = x if first is None else first
        args = (FM_ALPHA, float(p.freq_word), p.mod_scale,
                FM_AMP, p.swap_iq)
        got = fm_k.fm_mod(x, add, *st, *args)
        ref = fm_k.fm_mod_plain(x, add, *sp, *args)
        torch.cuda.synchronize()
        err = max(err, same_bits(f"{label} block {blk} ({T} samples)", dict(
            zip(("i", "q", "hpf_a", "hpf_b", "accum"), zip(ref, got)))))
        st, sp = list(got[2:]), list(ref[2:])
    return err, first


def phase_fm_mod(P, dev, gen):
    """The table-mode FM modulator (fm_mod.cu) at the TX flagship's shape
    (8192 ch x 16384 count-domain audio @ 48 kHz) over 16384 + 3000 +
    16384 samples, then with a subtone plane and a negative translate
    (the I/Q swap, 4096 + 1000), an edge stream (a NaN state channel;
    +-0, +-inf, a NaN, subnormals, 1e30; 1000 + 777), bit for bit against
    its plain version on i, q and every state leaf; channels 0-7 alone
    against the batch.  Timed at 8192 x 16384; the plain loop at 1024
    samples."""
    C, T = CHANNELS, TXF.block_len
    p = P["tx_fm"].fm
    check(p.table_quant, "FM TX ref front: not the table mode")
    err, x0 = fm_mod_stream(p, C, (T, 3000, T), dev, gen, "fm_mod")
    neg = mods.fm_mod_params(-6000.0, False, 88.5, count_domain=True)
    err = max(err, fm_mod_stream(neg, C, (4096, 1000), dev, gen,
                                 "fm_mod subtone, swap", sub=True)[0])
    err = max(err, fm_mod_stream(p, C, (1000, 777), dev, gen, "fm_mod edge",
                                 edge=True)[0])
    z = torch.zeros((C,), device=dev)
    acc = torch.zeros((C,), dtype=torch.int32, device=dev)
    args = (FM_ALPHA, float(p.freq_word), p.mod_scale, FM_AMP, p.swap_iq)
    full = fm_k.fm_mod(x0, None, z, z, acc, *args)
    one = fm_k.fm_mod(x0[:8].contiguous(), None, z[:8], z[:8], acc[:8],
                      *args)
    torch.cuda.synchronize()
    check(all(torch.equal(a[:8], b) for a, b in zip(full, one)),
          "fm_mod: channels 0-7 alone differ from the batch")
    check(float(full[0].abs().max()) > 0.8 and bool(
        (full[4] != 0).any()), "fm_mod: no carrier or a still accumulator")
    del full
    ms = cuda_ms(lambda: fm_k.fm_mod(x0, None, z, z, acc, *args), 10)
    TP = 1024
    xp = x0[:, :TP].contiguous()
    plain_ms = cuda_ms(lambda: fm_k.fm_mod_plain(xp, None, z, z, acc, *args),
                       1)
    # audio in, i and q out, the state in and out; a sample's
    # pre-emphasis (3), the step (2), the accumulator (5), the index (2),
    # the amplitude (2)
    nbytes = 3 * C * T * 4 + 2 * 3 * C * 4
    rec_ms = recurrence_ms(T, fm_k.FM_MOD_STEP_CHAIN)
    r = row("fm_mod", "fm_mod.cu", "uhsdr_tpu/mod/modulators.py:244",
            err=err, snr=math.inf, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
            flops=14.0 * C * T, recurrence_ms=rec_ms, tpu_kernel=False,
            plain_steps=TP,
            library_note="no PyTorch call computes the FM modulator")
    print(f"  fm_mod at {C} x {T}: {ms:.4f} ms (plain {plain_ms:.1f} ms at "
          f"{TP} samples; recurrence bound {rec_ms:.4f} ms; {r['bound_by']} "
          f"bound {r['bound_ms']:.4f} ms); bit for bit, edge streams too; "
          f"channels 0-7 alone bit-equal")
    return r


# ---------------------------------------------------------------------------
# the digital-mode decoders' helper kernels (cw.cu, psk.cu, rtty.cu) and the
# scope's zoom on K5
# ---------------------------------------------------------------------------

# the decoder tap's block at the RX flagship (2048 samples @ 12 kHz)
DEC_T = CFG.block_len // CFG.decim
DEC_FS = 12000.0


def digital_audio(gen, dev, C, T, t0):
    """(C, T) f32 decoder-tap audio @ 12 kHz, stream samples t0.. on:
    by channel c % 4 a 45.45 Bd FSK pair (915 / 1085 Hz), a 500 Hz
    carrier reversed by PSK31 bits, a 700 Hz tone keyed on and off in
    528-sample elements, noise alone; the bits a hash of the bit index
    and the channel, so a stream continues across blocks; each channel at
    its own level, plus noise."""
    n = torch.arange(t0, t0 + T, device=dev, dtype=torch.float64)
    c = torch.arange(C, device=dev, dtype=torch.float64)[:, None]

    def bit(period):
        k = (n // period).long()[None, :] * 2654435761 + c.long() * 40503
        return ((k >> 7) & 1).double()

    w = 2 * math.pi / DEC_FS
    fsk = torch.cos(w * torch.where(bit(264) > 0, 915.0, 1085.0) * n)
    psk31 = (2 * bit(384) - 1) * torch.sin(w * 500.0 * n)
    keyed = bit(528) * torch.sin(w * 700.0 * n)
    x = torch.where(c % 4 == 0, fsk, torch.where(
        c % 4 == 1, psk31, torch.where(c % 4 == 2, keyed, 0.0)))
    x = x * (0.2 + c % 5) + 0.02 * torch.randn(
        (C, T), generator=gen, device=dev, dtype=torch.float64)
    return x.float().contiguous()


def modem_fns(kind: str, dev, **kw):
    """(init_state(C), kernel(state, x), plain(state, x)) of a decoder's
    wrapper; each returns (outputs tuple, state)."""
    if kind == "cw":
        p = cw_mod.make_params(atc=kw.get("atc", True),
                               noisecancel=kw.get("nc", True))

        def go(f):
            return lambda s, x: (lambda o: ((o[0],), o[1]))(f(
                p.cos_v, p.sin_v, p.thresh, p.atc, p.noisecancel, s, x))
        return (lambda C: cw_k.CwLeaves(*cw_mod.init_state((C,), dev)),
                go(cw_k.cw_detect), go(cw_k.cw_detect_plain))
    if kind == "psk":
        p = psk_mod.make_params(speed=kw.get("speed", 31))
        d = int(nco.freq_to_delta(psk_mod.PSK_OFFSET, p.fs))

        def init(C):
            s = psk_mod.init_state((C,), p, dev)
            return psk_k.PskLeaves(s.bpf_bq, s.nco_phase, s.prod_tail,
                                   s.last_symbol, s.last_bit)

        def go(f):
            return lambda s, x: (lambda o: ((o[0],), o[1]))(f(
                p.bpf, d, p.rate, s, x))
        return init, go(psk_k.psk), go(psk_k.psk_plain)
    p = rtty_mod.make_params(atc=kw.get("atc", True))

    def go(f):
        def run(s, x):
            codes, nb, s = f(p.mark_bp, p.space_bp, p.lpf, p.one_bit, p.atc,
                             rtty_mod.max_bytes(p, x.shape[-1]), s, x)
            return (codes, nb), s
        return run
    return (lambda C: rtty_mod.init_state((C,), dev), go(rtty_k.rtty),
            go(rtty_k.rtty_plain))


def modem_stream(kind, C, lengths, dev, gen, label, edge=False, **kw):
    """A decoder's kernel against its plain version over streamed blocks
    of `digital_audio` from the zero state (with `edge`, a NaN in one
    channel's first state leaf and the edge samples of `opt_edges`), bit
    for bit on every output and state leaf.  Returns (max |err|, the
    first block's input, the zero state)."""
    init, kern, plain = modem_fns(kind, dev, **kw)
    s0 = init(C)
    if edge:
        first = s0[0].clone()
        first.view(C, -1)[C // 2, 0] = math.nan
        s0 = type(s0)(first, *s0[1:])
    sk = sp = s0
    err, t0, x0 = 0.0, 0, None
    for blk, T in enumerate(lengths):
        x = digital_audio(gen, dev, C, T, t0)
        if edge:
            x = opt_edges(x, t0)
        x0 = x if x0 is None else x0
        t0 += T
        yk, sk = kern(sk, x)
        yp, sp = plain(sp, x)
        torch.cuda.synchronize()
        pairs = {f"out{i}": (a, b) for i, (a, b) in enumerate(zip(yp, yk))}
        pairs.update({f: (a, b) for f, a, b in zip(sp._fields, sp, sk)})
        err = max(err, same_bits(f"{label} block {blk} ({T} samples)",
                                 pairs))
    return err, x0, s0


def modem_alone(kind, x, s0, dev, **kw) -> None:
    """Channels 0-7 alone against the batch, every output and leaf."""
    _, kern, _ = modem_fns(kind, dev, **kw)
    yf, sf = kern(s0, x)
    y8, s8 = kern(type(s0)(*(t[:8].contiguous() for t in s0)),
                  x[:8].contiguous())
    torch.cuda.synchronize()
    check(all(torch.equal(a[:8], b) for a, b in zip(yf + tuple(sf),
                                                    y8 + tuple(s8))),
          f"{kind}: channels 0-7 alone differ from the batch")


def modem_row(kind, source, replaces, x, s0, dev, err, *, nbytes, flops,
              chain_ops, plain_steps, note, **kw) -> dict:
    """Time the kernel at the flagship's shape and the plain version on
    its first `plain_steps` samples; the row for the kernels line."""
    _, kern, plain = modem_fns(kind, dev, **kw)
    C, T = x.shape
    ms = cuda_ms(lambda: kern(s0, x), 20)
    xp = x[:, :plain_steps].contiguous()
    plain_ms = cuda_ms(lambda: plain(s0, xp), 1)
    rec_ms = recurrence_ms(T, chain_ops)
    r = row(kind, source, replaces, err=err, snr=math.inf, ms=ms,
            plain_ms=plain_ms, nbytes=nbytes, flops=flops,
            recurrence_ms=rec_ms, tpu_kernel=False, plain_steps=plain_steps,
            library_note=note)
    print(f"  {kind} at {C} x {T}: {ms:.4f} ms (plain {plain_ms:.1f} ms at "
          f"{plain_steps} samples; recurrence bound {rec_ms:.4f} ms; "
          f"{r['bound_by']} bound {r['bound_ms']:.4f} ms; library null); "
          f"bit for bit, edge streams too; channels 0-7 alone bit-equal")
    return r


def phase_cw(P, dev, gen):
    """The CW keying detector (cw.cu) at the decoder tap's shape (8192 ch
    x 2024 @ 12 kHz: the tap's whole 88-sample frames of a 2048 block)
    over 2024 + 88 + 2112 samples with the tap's settings (ATC,
    noisecancel), then the FIR smoother without the debounce (1024 x 880
    + 2112), an edge stream (1024 x 880 + 2112: a NaN state channel, +-0,
    +-inf, a NaN, subnormals, 1e30), bit for bit against its plain
    version; channels 0-7 alone against the batch.  Timed at 8192 x
    2024."""
    C, T = CHANNELS, (DEC_T // 88) * 88
    err, x0, s0 = modem_stream("cw", C, (T, 88, T + 88), dev, gen, "cw")
    err = max(err, modem_stream("cw", 1024, (880, 2112), dev, gen,
                                "cw smoother", atc=False, nc=False)[0])
    err = max(err, modem_stream("cw", 1024, (880, 2112), dev, gen,
                                "cw edge", edge=True)[0])
    modem_alone("cw", x0, s0, dev)
    nblk = T // 88
    # audio in, keying out, five state leaves (three f32, two bool) in and
    # out; two products and two sums a sample, ~20 operations a frame
    nbytes = C * T * 4 + C * nblk + 2 * C * 14
    return modem_row("cw", "cw.cu", "uhsdr_tpu/modems/cw.py:73", x0, s0,
                     dev, err, nbytes=nbytes,
                     flops=4.0 * C * T + 20.0 * C * nblk,
                     chain_ops=cw_k.CW_SAMPLE_CHAIN, plain_steps=T,
                     note="no PyTorch call computes the keying detector")


def phase_psk(P, dev, gen):
    """The BPSK demodulator (psk.cu) at the decoder tap's PSK31 shape
    (8192 ch x 1920 @ 12 kHz: five 384-sample symbols) over 1920 + 384 +
    2304 samples, PSK63 and PSK125 at 1024 channels (1920 + 192, 960 +
    96), an edge stream (1024 x 1920 + 384), bit for bit against its plain
    version (its sine torch.sin on the card); channels 0-7 alone against
    the batch.  Timed at 8192 x 1920."""
    C, T = CHANNELS, 1920
    err, x0, s0 = modem_stream("psk", C, (T, 384, 2304), dev, gen, "psk31")
    for speed, lengths in ((63, (1920, 192)), (125, (960, 96))):
        err = max(err, modem_stream("psk", 1024, lengths, dev, gen,
                                    f"psk{speed}", speed=speed)[0])
    err = max(err, modem_stream("psk", 1024, (1920, 384), dev, gen,
                                "psk edge", edge=True)[0])
    modem_alone("psk", x0, s0, dev)
    # audio in, bits out, the state (bq, phase, 23-sample tail, symbol,
    # bit: 116 bytes) in and out; a sample: the biquad's 9 operations, the
    # angle, sinf (counted as 20), the product, the window's sum
    nbytes = C * T * 4 + C * (T // 384) * 4 + 2 * C * 116
    return modem_row("psk", "psk.cu", "uhsdr_tpu/modems/psk.py:79", x0, s0,
                     dev, err, nbytes=nbytes, flops=32.0 * C * T,
                     chain_ops=psk_k.PSK_SAMPLE_CHAIN, plain_steps=T,
                     note="no PyTorch call computes the demodulator")


def phase_rtty(P, dev, gen):
    """The RTTY demodulator (rtty.cu) at the decoder tap's shape (8192 ch
    x 2048 @ 12 kHz) over 2048 + 77 + 2048 samples with the ATC, without
    it at 1024 channels (1000 + 2048), an edge stream (1024 x 2048 + 500),
    bit for bit against its plain version on the codes, nbytes and every
    state leaf; channels 0-7 alone against the batch.  Timed at 8192 x
    2048; the plain loop at 256 samples."""
    C, T = CHANNELS, DEC_T
    err, x0, s0 = modem_stream("rtty", C, (T, 77, T), dev, gen, "rtty")
    err = max(err, modem_stream("rtty", 1024, (1000, T), dev, gen,
                                "rtty no ATC", atc=False)[0])
    err = max(err, modem_stream("rtty", 1024, (T, 500), dev, gen,
                                "rtty edge", edge=True)[0])
    modem_alone("rtty", x0, s0, dev)
    n_slots = rtty_mod.max_bytes(rtty_mod.make_params(), T)
    # audio in, codes and nbytes out, 18 f32 state registers in and out; a
    # sample: three biquads (27), the squares, the ATC (~25), the DPLL and
    # UART (~50)
    nbytes = C * T * 4 + C * (n_slots + 1) * 4 + 2 * C * 18 * 4
    return modem_row("rtty", "rtty.cu", "uhsdr_tpu/modems/rtty.py:135", x0,
                     s0, dev, err, nbytes=nbytes, flops=104.0 * C * T,
                     chain_ops=rtty_k.RTTY_SAMPLE_CHAIN, plain_steps=256,
                     note="no PyTorch call computes the demodulator")


def phase_scope(P, dev, gen):
    """The scope's zoom at full width: K5's instance of the 127-tap
    decimator at magnify 3 (decim 8) on the RX flagship's int16 planes
    (8192 ch x 16384 @ 96 kHz, no NCO) over 16384 + 4096 + 16384 samples
    against its plain version (output, raw carry and peaks >= 90 dB, as
    phase_fir_rt), its shared memory held to `fir_rt_geometry`'s; then
    `scope.process` at magnify 3 and 0 on the card against the CPU on
    channels 0-7 (spectrum >= 90 dB, dBm within 1e-3 dB, SNAP within 0.01
    Hz) and timed.  K5's row is phase_fir_rt's."""
    sp3 = scope_mod.make_params(magnify=3, translate_hz=CFG.translate_hz)
    h = torch.from_numpy(sp3.zoom_fir).to(dev)
    taps, decim = h.shape[-1], 8
    for size in (2, 4):
        want = fir_k.fir_rt_geometry(taps, decim, size).smem
        got = fir_k.FRONT.lib().uhsdr_front_smem(taps, 1, decim, 0, size)
        check(got == want, f"zoom K5 shared memory {got} != {want}")
    C, B = CHANNELS, CFG.block_len
    ck = cp = torch.zeros((C, taps - 1), dtype=torch.complex64, device=dev)
    first = None
    for blk, Bk in enumerate((B, 4096, B)):
        xi, xq = iq_block(gen, dev, C, Bk)
        first = first or (xi, xq)
        yk, ck, pk_k = fir_k.fir_rt(h, ck, xi, xq, decim)
        yp, cp, pk_p = fir_k.fir_rt_plain(h, cp, xi, xq, decim)
        torch.cuda.synchronize()
        held(f"zoom K5 block {blk} ({Bk} samples)", {
            "iq": (yp, yk), "raw carry": (cp, ck), "peaks": (pk_p, pk_k)})
    xi, xq = first
    for mag in (3, 0):
        sp = scope_mod.make_params(magnify=mag, translate_hz=CFG.translate_hz)
        st = scope_mod.init_state((C,), sp, dev)
        sc = scope_mod.init_state((8,), sp, "cpu")
        for _ in range(2):
            out, st = scope_mod.process(sp, st, (xi, xq))
            oc, sc = scope_mod.process(sp, sc, (xi[:8].cpu(), xq[:8].cpu()))
        s = snr_db(oc["spectrum"], out["spectrum"][:8].cpu())
        e_dbm = float((oc["dbm"] - out["dbm"][:8].cpu()).abs().max())
        e_snap = float((oc["snap_freq"] - out["snap_freq"][:8].cpu()).abs()
                       .max())
        print(f"  scope magnify {mag} vs CPU, ch 0-7: spectrum {s:.1f} dB, "
              f"dBm {e_dbm:.2e} dB, SNAP {e_snap:.2e} Hz")
        check(s >= KERNEL_TOL_DB and e_dbm <= 1e-3 and e_snap <= 0.01,
              f"scope magnify {mag}: card vs CPU {s:.1f} dB, dBm "
              f"{e_dbm:.2e}, SNAP {e_snap:.2e}")
        ms = cuda_ms(lambda: scope_mod.process(sp, st, (xi, xq)), 10)
        print(f"  scope.process magnify {mag} at {C} x {B} int16: "
              f"{ms:.4f} ms")
    return []


# the spectral NR's per-bin state leaves
NR_BIN_LEAVES = ("nr.xt", "nr.pslp", "nr.hk_old", "nr.nest_acc")


def state_snrs(ref: dict, got: dict, nr_band=None) -> dict:
    """{leaf: SNR dB} of two `rx.state_to_numpy` dicts; the PLL phase
    through its cosine and sine; integer leaves (the NCO phases, FM's
    counters, the NR's frame counter) and boolean ones (FM's squelch and
    tone decisions, the twin-peaks flag) by equality.  With nr_band = (lo,
    hi), the NR's per-bin leaves over the bins of its band: outside it
    the gain is 1 and those bins never reach the audio, and their X is
    the front's and cascade's rounding floor, which the card and the CPU
    round apart (pslp there read 55.9 dB card against CPU on an H100,
    62.7 dB port against the JAX package on the CPU,
    tests/test_torch_nr.py)."""
    out = {}
    for f, a in ref.items():
        b = got[f]
        if nr_band is not None and f in NR_BIN_LEAVES:
            a, b = a[..., nr_band[0]:nr_band[1]], b[..., nr_band[0]:nr_band[1]]
        if a.dtype == bool or a.dtype.kind in "iu":
            out[f] = math.inf if np.array_equal(a, b) else -math.inf
        elif f == "sam.phs":
            out[f] = snr_db(np.stack([np.cos(a), np.sin(a)]),
                            np.stack([np.cos(b), np.sin(b)]))
        else:
            out[f] = snr_db(a, b)
    return out


def zero_launches():
    for k in build.kernels():
        k.launches = 0
    torch.cuda.synchronize()


def read_launches(label: str, expect) -> dict:
    """Read every kernel's launch count after a path and check that each
    kernel of `expect`, and no other, was launched."""
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in build.kernels()}
    print(f"  {label} launches: {launches}")
    for name in expect:
        check(launches[name] > 0, f"{label} never launched kernel {name}")
    for name, n in launches.items():
        check(n == 0 or name in expect,
              f"{label} launched {name}, which is not on its path")
    return launches


def timed_run(step, blocks, label, expect, n_warm, n_timed):
    """Set every kernel's launch count to 0, run `step(block)` over the
    warm-up blocks and then the timed ones between CUDA events, read the
    counts and check that each kernel of `expect`, and no other, was
    launched.  Returns (launches, ms/block: the mean over the timed
    window, the last step's result); prints each timed block, their
    median and the caching allocator's device allocations (cudaMalloc
    calls, each of which waits for the card) inside the window."""
    zero_launches()
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
    each = [marks[k].elapsed_time(marks[k + 1]) for k in range(n_timed)]
    mean = marks[0].elapsed_time(marks[-1]) / n_timed
    print(f"  {label} ms of each timed block: "
          + " ".join(f"{t:.3f}" for t in each)
          + f" (mean {mean:.3f}, median {float(np.median(each)):.3f}); "
          f"device allocations in the window: {allocs}")
    return read_launches(label, expect), mean, out


def main_path(cfg, label, expect, dev, seed, n_timed, C, n_warm=2, n_ref=3,
              ref_ch=8, keep=None):
    """Drive `RxChain(cfg)` on the card at C channels; returns (launches
    of every kernel on this path, ms/block, Ms/s, worst SNR against the
    port's CPU chain).  With a dict `keep`, the last block's audio goes to
    keep["audio"]."""
    B = cfg.block_len
    fm = cfg.mode == "fm"
    out_len, fs_out = ((B // cfg.front_decim, cfg.iq_rate / cfg.front_decim)
                       if fm else (B, cfg.iq_rate))
    out_shape = (C,) + ((2,) if cfg.n_audio > 1 else ()) + (out_len,)
    blocks = trace_rx.capture(n_warm + n_timed, C, dev, seed, cfg)
    chain = rx.RxChain(cfg, device=dev)
    state = chain.init_state((C,))
    kept, kept_state, kept_front = [], None, []
    # The notch outputs its error, x minus a prediction of x: on a steady
    # tone the two cancel by 40-50 dB, and the rounding of the front's
    # output (K1 against the CPU's FIR products, ~130 dB apart) comes out
    # of the notch that much larger.  Where it runs, the CPU chain is held
    # to the card's in two halves, each at CHAIN_TOL_DB: the front's
    # output (the pre-LMS audio), and the rest of the chain run on the
    # CPU from the card's pre-LMS audio.
    split = cfg.notch_enable and not fm

    def step(blk):
        nonlocal state, kept_state
        if split:
            zf, state, taps = rx.process_front(cfg, chain.params, state,
                                               blk)
            if len(kept_front) < n_ref:
                kept_front.append(zf[:ref_ch].clone())
            audio, state, taps = rx.demod_and_post(cfg, chain.params, state,
                                                   zf, taps)
        else:
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
    if keep is not None:
        keep["audio"] = audio

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
        if split:
            zf, s_cpu, taps_c = rx.process_front(
                cfg, cpu.params, s_cpu, (i[:ref_ch].cpu(), q[:ref_ch].cpu()))
            s = snr_db(zf, kept_front[blk].cpu())
            worst = min(worst, s)
            print(f"  {label} pre-LMS audio vs CPU chain, block {blk}, ch "
                  f"0-{ref_ch - 1}: SNR {s:.1f} dB")
            y_cpu, s_cpu, _ = rx.demod_and_post(
                cfg, cpu.params, s_cpu, kept_front[blk].cpu(), taps_c)
        else:
            y_cpu, s_cpu, _ = cpu(s_cpu, i=i[:ref_ch].cpu(),
                                  q=q[:ref_ch].cpu())
        s = snr_db(y_cpu, kept[blk].cpu())
        worst = min(worst, s)
        print(f"  {label} vs CPU chain{' from the pre-LMS audio' if split else ''}"
              f", block {blk}, ch 0-{ref_ch - 1}: SNR {s:.1f} dB")

    def ref_channels(v):
        return np.take(v, range(ref_ch), axis=v.shape.index(C))

    nrp = chain.params.nr
    leaves = state_snrs(rx.state_to_numpy(s_cpu),
                        {f: ref_channels(v) for f, v in
                         rx.state_to_numpy(kept_state).items()},
                        None if nrp is None else (nrp.vad_low, nrp.vad_high))
    low = min(leaves, key=leaves.get)
    print(f"  {label} state after block {n_ref - 1} vs CPU chain: worst "
          f"leaf {low} {leaves[low]:.1f} dB of {len(leaves)}; under 100 dB: "
          + ", ".join(f"{f} {v:.1f}" for f, v in leaves.items() if v < 100))
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
    if cfg.notch_enable and not fm:
        # the auto-notch takes the steady tone out: within 20 Hz of it
        # lies under a tenth of channel 0's audio power
        share = float((spec[np.abs(freqs - tone) < 20.0] ** 2).sum()
                      / (spec ** 2).sum())
        print(f"  {label} channel 0: the notched tone holds {share:.4f} of "
              f"the audio power")
        check(share < 0.1, f"{label}: the notch left the tone ({share:.3f} "
                           f"of the power)")
    else:
        check(abs(f_pk - tone) < 20.0,
              f"{label} tone at {f_pk} Hz, not {tone}")
    return launches, ms_block, msps, worst, n_warm + n_timed


# ---------------------------------------------------------------------------
# the decode path: the digital-mode decoders and the scope on the RX
# flagship's taps
# ---------------------------------------------------------------------------

DECODE_KERNELS = ("front", "blocked", "agc", "interp", "cw", "psk", "rtty")
# the messages channels 0-2 carry: RTTY 45.45 Bd / 170 Hz, PSK63, CW
DECODE_MSGS = {"rtty": "RYRY", "psk": "CQ", "cw": "TEST"}
DECODE_LEVEL = 0.25 * 32767.0       # -12 dBFS, the capture's channel 0
CW_WPM = 28


def psk_alignment(dev) -> tuple[float, float]:
    """The SSB flagship's delay (12 kHz samples) and phase at PSK's 500 Hz,
    seen by the PSK demodulator: tones 490, 500 and 510 Hz above the
    translate frequency (phase 0 at the stream's first sample) through
    `RxChain(CFG)` on three channels for three blocks; each tone's phase
    theta in the last block's decoder tap, fitted as R sin(w m + theta)
    against the demodulator's NCO (m from the stream's first decoder
    sample); the delay is -d theta / d w across 490-510 Hz (unambiguous
    below 300 samples).  Returns (delay, theta at 500 Hz)."""
    B, fs = CFG.block_len, CFG.iq_rate
    f_aud = torch.tensor([490.0, 500.0, 510.0], device=dev,
                         dtype=torch.float64)[:, None]
    chain = rx.RxChain(CFG, device=dev)
    st = chain.init_state((3,))
    for k in range(3):
        n = torch.arange(k * B, (k + 1) * B, device=dev, dtype=torch.float64)
        ph = 2 * math.pi * (CFG.translate_hz + f_aud) * n / fs
        i = (DECODE_LEVEL * torch.cos(ph)).round().to(torch.int16)
        q = (DECODE_LEVEL * torch.sin(ph)).round().to(torch.int16)
        _, st, taps = chain(st, i=i, q=q)
    y = taps["audio_dec"].double().cpu().numpy()
    m = np.arange(2 * DEC_T, 3 * DEC_T)
    theta = []
    for c, f in enumerate((490.0, 500.0, 510.0)):
        w = 2 * np.pi * f / DEC_FS
        a, b = np.linalg.lstsq(np.stack([np.sin(w * m), np.cos(w * m)], 1),
                               y[c], rcond=None)[0]
        theta.append(math.atan2(b, a))
    dth = math.remainder(theta[2] - theta[0], 2 * math.pi)
    delay = -dth / (2 * np.pi * 20.0 / DEC_FS)
    return delay, theta[1]


def decode_capture(n_blocks: int, C: int, dev, seed: int):
    """int16 IQ blocks (C, 16384) @ 96 kHz: noise of 30 counts rms on
    every channel; channel 0 carries RTTY 45.45 Bd / 170 Hz AFSK of
    "RYRY" (mark 915 Hz, idle mark around it), channel 1 PSK63 of "CQ"
    (`psk_text`'s preamble and postamble; its symbols placed on the
    demodulator's symbol clock and its carrier on its NCO's phase by
    `psk_alignment`), channel 2 CW of "TEST" at 28 wpm on 700 Hz from the
    first sample, each
    on the upper sideband of the translate frequency at -12 dBFS, from
    the port's own text tiers.  Returns (blocks, the PSK alignment)."""
    B, fs = CFG.block_len, CFG.iq_rate
    up = int(fs // DEC_FS)
    n_all = n_blocks * B
    m_all = n_blocks * DEC_T
    # RTTY: 0.1 s of idle mark, the message, idle mark
    one_bit = int(round(DEC_FS / 45.45))
    bits = rtty_text.codes_to_bits(rtty_text.encode(DECODE_MSGS["rtty"]),
                                   one_bit)
    key = np.ones(m_all, bool)
    lead = int(0.1 * DEC_FS)
    key[lead:lead + len(bits)] = bits[:m_all - lead]
    f = np.repeat(np.where(key, rtty_mod.MARK_FREQ,
                           rtty_mod.MARK_FREQ + 170.0), up)
    rtty_ph = 2 * np.pi * np.cumsum(CFG.translate_hz + f) / fs
    rtty_z = np.exp(1j * rtty_ph)
    # PSK63, aligned to the demodulator
    delay, theta = psk_alignment(dev)
    p63 = psk_mod.make_params(speed=63)
    signs, env = psk_text.bits_to_waveform_params(
        psk_text.encode_bits(DECODE_MSGS["psk"]), p63.rate)
    s0 = int(round(-delay)) % p63.rate
    base = np.zeros(m_all)
    seg = (signs * env)[:m_all - s0]
    base[s0:s0 + len(seg)] = seg
    t96 = np.arange(n_all)
    base96 = np.interp(t96 / up, np.arange(m_all), base)
    psk_z = base96 * np.exp(1j * (2 * np.pi * (CFG.translate_hz + 500.0)
                                  * t96 / fs - theta))
    # CW: the keyed text from the stream's first sample: from its zero
    # state the ATC's noise floor rises over some 1536 frames (18 s), and
    # until a tone sets its envelope noise alone keys it (ROADMAP queue C)
    keying = cw_text.text_to_keying(DECODE_MSGS["cw"], CW_WPM, DEC_FS)
    env_cw = np.zeros(m_all)
    env_cw[:len(keying)] = keying[:m_all]
    cw_z = np.repeat(env_cw, up) * np.exp(
        1j * 2 * np.pi * (CFG.translate_hz + 700.0) * t96 / fs)
    sig = torch.from_numpy(np.stack([rtty_z, psk_z, cw_z]) * DECODE_LEVEL
                           ).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    blocks = []
    for k in range(n_blocks):
        planes = []
        for part in (sig.real, sig.imag):
            x = torch.randn((C, B), generator=gen, device=dev) * 30.0
            x[:3] += part[:, k * B:(k + 1) * B].float()
            planes.append(x.round().clamp(-32768, 32767).to(torch.int16))
        blocks.append(tuple(planes))
    return blocks, (delay, theta, s0)


def decode_path(dev, seed, n_timed=8, n_warm=2):
    """The decoders and the scope off `RxChain(CFG)` at the flagship's
    width (8192 ch x 16384 int16 @ 96 kHz, state carried): on every block
    `scope.process` (magnify 0) reads the ``spectrum_iq`` tap and
    `modems.tap.DecoderTap` runs CW, PSK63 and RTTY on the ``audio_dec``
    tap (8192 x 2048 @ 12 kHz, the remainders carried on the card), one
    launch a mode.  Timed over `n_timed` blocks after `n_warm`.  Channels
    0-2 of `decode_capture` must decode to their messages; the scope's
    outputs must be finite.  Returns (launches, ms/block, Ms/s, blocks
    timed, blocks run)."""
    C, B = CHANNELS, CFG.block_len
    blocks, (delay, theta, s0) = decode_capture(n_warm + n_timed, C, dev,
                                                seed)
    print(f"  decode PSK alignment: chain delay {delay:.1f} samples @ 12 "
          f"kHz, phase {theta:.3f} rad at 500 Hz; symbols start at sample "
          f"{s0}")
    chain = rx.RxChain(CFG, device=dev)
    state = chain.init_state((C,))
    sp = scope_mod.make_params(translate_hz=CFG.translate_hz)
    ss = scope_mod.init_state((C,), sp, dev)
    dtap = tap_mod.DecoderTap(C, text_channels=(0, 1, 2), device=dev,
                              psk_params=psk_mod.make_params(speed=63))

    def step(blk):
        nonlocal state, ss
        audio, state, taps = chain(state, i=blk[0], q=blk[1])
        so, ss = scope_mod.process(sp, ss, taps["spectrum_iq"])
        return audio, so, dtap.push(taps["audio_dec"])

    launches, ms_block, (audio, so, out) = timed_run(
        step, blocks, "decode", DECODE_KERNELS, n_warm, n_timed)
    check(tuple(audio.shape) == (C, B) and bool(torch.isfinite(audio).all()),
          "decode audio")
    check(tuple(so["spectrum"].shape) == (C, sp.fft_len)
          and all(bool(torch.isfinite(v).all()) for v in so.values()),
          "decode scope outputs not finite")
    check(out["rtty"].codes.shape[0] == C and out["cw"].shape[0] == C
          and out["psk"].shape[0] == C, "decode outputs' shapes")
    texts = dtap.flush()
    for mode in ("rtty", "psk", "cw"):
        print(f"  decode {mode} text, channels 0-2: "
              + "; ".join(repr(texts[mode][c]) for c in range(3)))
    # each transcript, its spaces aside, is the message and nothing else.
    # The spaces are the text decoders' word gaps: CW's decoder, seeded
    # at 25 wpm, reads the gap after the first character (a dash) of a
    # 28 wpm signal as a word gap by the reference's rule (eq. 4.14,
    # `cw_text.py::CwTextDecoder._on_event`), and the JAX package's own
    # loopbacks compare with the spaces removed (tests/test_cw.py)
    ch = {"rtty": 0, "psk": 1, "cw": 2}
    for mode, msg in DECODE_MSGS.items():
        got = texts[mode][ch[mode]]
        check(got.replace(" ", "") == msg, f"decode: channel {ch[mode]} "
                                           f"{mode} gave {got!r}, not {msg!r}")
    return launches, ms_block, C * B / (ms_block * 1e-3) / 1e6, n_timed, \
        n_warm + n_timed


def biquad_path(P, dev, seed, impl, n_timed=4, n_warm=2):
    """The entry paths of K14 (impl "grouped") and K11 ("sequential"):
    SAM usb's stacked allpass inputs as the reference stacks them (16384
    x 4096: its four paths, two per coefficient set) through
    `biquad_cascade(impl=...)`, one call per coefficient set a block,
    state carried; the last block's outputs and the final states held
    against the other implementation over the same blocks.  No block's
    output outlives the next block, so the timed blocks allocate no new
    device memory.  Returns (launches, ms/block, worst SNR against the
    other, blocks run)."""
    sos = P["sam"].sam.ap_sos
    C, T = 2 * CHANNELS, SAM.block_len // SAM.decim
    other = "sequential" if impl == "grouped" else "grouped"
    label = "biquad_grouped" if impl == "grouped" else "biquad"
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    blocks = [[torch.randn((C, T), generator=gen, device=dev) * 0.1
               for _ in sos] for _ in range(n_warm + n_timed)]
    states = [torch.zeros((s.shape[0], C, 2), device=dev) for s in sos]

    def step(blk):
        ys = []
        for k, (s, x) in enumerate(zip(sos, blk)):
            y, states[k] = iir_k.biquad_cascade(s, states[k], x, impl=impl)
            ys.append(y)
        return ys

    launches, ms_block, ys = timed_run(step, blocks, label, (label,),
                                       n_warm, n_timed)
    check(all(bool(torch.isfinite(y).all()) for y in ys + states),
          f"{label}: output or state not finite")
    # the same blocks through the other implementation, outside the
    # counted window
    ref = [torch.zeros((s.shape[0], C, 2), device=dev) for s in sos]
    for blk in blocks:
        y_ref = []
        for k, (s, x) in enumerate(zip(sos, blk)):
            y, ref[k] = iir_k.biquad_cascade(s, ref[k], x, impl=other)
            y_ref.append(y)
    worst = min(*(snr_db(a, b) for a, b in zip(y_ref, ys)),
                *(snr_db(r, st) for r, st in zip(ref, states)))
    print(f"  {label} vs {other}: worst SNR {worst:.1f} dB (the last block "
          "and the final states)")
    check(worst >= KERNEL_TOL_DB,
          f"{label} vs {other}: {worst:.1f} dB < {KERNEL_TOL_DB} dB")
    return launches, ms_block, worst, n_warm + n_timed


def tx_vs_cpu(cfg, label, blocks, kept, kept_state, C, tol_db=CHAIN_TOL_DB):
    """The first channels of `blocks` (each (C, T) audio) through a CPU
    `TxChain(cfg)`: its (i + j q) against `kept` (the card's, one (ref_ch,
    T) tensor a block) and its state after them against `kept_state`
    (the card's, all C channels), every leaf; held >= tol_db.  FM's
    accumulator is compared by the phase its steps apart make: d steps
    read as -20 log10(d 2 pi / 65536) dB (one step 80.4 dB).  Returns the
    worst SNR."""
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
    ref = tx.state_to_numpy(s_cpu)
    got = {f: v[:ref_ch] if v.shape[0] == C else
           np.take(v, range(ref_ch), axis=1)
           for f, v in tx.state_to_numpy(kept_state).items()}
    acc = (ref.pop("mod.accum", None), got.pop("mod.accum", None))
    leaves = state_snrs(ref, got)
    if acc[0] is not None:
        d = np.abs(acc[0].astype(np.int64) - acc[1].astype(np.int64))
        d = int(np.minimum(d, 65536 - d).max())
        leaves["mod.accum"] = (math.inf if d == 0 else
                               -20.0 * math.log10(d * 2 * math.pi / 65536))
        print(f"  {label} FM accumulators at most {d} steps apart")
    low = min(leaves, key=leaves.get)
    print(f"  {label} state after block {len(kept) - 1} vs CPU chain: worst "
          f"leaf {low} {leaves[low]:.1f} dB of {len(leaves)}")
    worst = min(worst, leaves[low])
    check(worst >= tol_db, f"{label} vs CPU chain: {worst:.1f} dB < "
                           f"{tol_db} dB")
    return worst


def tx_path(cfg, label, expect, dev, seed, n_timed, C, n_warm=2, n_ref=3,
            ref_ch=8, tol_db=CHAIN_TOL_DB):
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

    worst = tx_vs_cpu(cfg, label, blocks, kept, kept_state, C, tol_db)
    z = (i[0] + 1j * q[0]).cpu().to(torch.complex128).numpy()
    spec = np.abs(np.fft.fft(z * np.hanning(len(z))))
    freqs = np.fft.fftfreq(len(z), 1.0 / tx.IQ_RATE)
    f_pk = float(freqs[spec.argmax()])
    if cfg.mode == "fm":
        # the carrier at the translate frequency: the spectrum's centroid
        # (an FM signal's mean frequency is its carrier's), with the
        # modulation spread around it (its rms deviation)
        pw = spec ** 2 / (spec ** 2).sum()
        f_mean = float((pw * freqs).sum())
        dev_rms = float(np.sqrt((pw * (freqs - f_mean) ** 2).sum()))
        print(f"  {label} channel 0 IQ: mean frequency {f_mean:.1f} Hz "
              f"(carrier {cfg.translate_hz} Hz), rms deviation "
              f"{dev_rms:.1f} Hz, peak {f_pk:.1f} Hz")
        check(abs(f_mean - cfg.translate_hz) < 50.0,
              f"{label} carrier at {f_mean} Hz, not {cfg.translate_hz}")
        check(300.0 < dev_rms < 5000.0,
              f"{label} rms deviation {dev_rms} Hz: no modulation")
        check(abs(f_pk - cfg.translate_hz) < 3000.0,
              f"{label} peak at {f_pk} Hz, off the carrier")
    else:
        want = trace_tx.expected_peak_hz(cfg)
        print(f"  {label} channel 0 IQ peak {f_pk:.1f} Hz (expected {want} "
              f"Hz)")
        check(abs(f_pk - want) < 20.0,
              f"{label} peak at {f_pk} Hz, not {want}")
    return launches, ms_block, msps, worst, n_warm + n_timed


def ref_capture(cfg, n_blocks, C, dev, seed):
    """f32 planes in the int16 count domain (the reference chain's input
    scale) of `trace_rx.capture`'s tones for cfg's mode at 48 kHz."""
    proxy = rx.RxConfig(mode=cfg.mode, translate_hz=cfg.translate_hz,
                        iq_rate=refchain.IQ_RATE, block_len=cfg.block_len)
    return [(i.float(), q.float()) for i, q in
            trace_rx.capture(n_blocks, C, dev, seed, proxy)]


def ref_leaves_snrs(ref: dict, got: dict, omega_max: float) -> dict:
    """`state_snrs` for two `refchain.state_to_numpy` dicts; SAM's PLL
    frequency estimate, which sits near zero on a carrier at the translate
    frequency, by its error against its range (1e-6 of omega_max reads
    as 120 dB)."""
    out = state_snrs({f: v for f, v in ref.items() if f != "sam.omega2"},
                     {f: v for f, v in got.items() if f != "sam.omega2"})
    if "sam.omega2" in ref:
        err = float(np.abs(ref["sam.omega2"] - got["sam.omega2"]).max())
        out["sam.omega2"] = (math.inf if err == 0.0 else
                             -20.0 * math.log10(err / omega_max))
    return out


def refchain_path(cfg, label, expect, dev, seed, n_timed, C, n_warm=2,
                  n_ref=3, ref_ch=8):
    """Drive `RefRxChain(cfg)` on the card at C channels of f32 planes @
    48 kHz, as `main_path` drives RxChain: timed blocks, launch counts,
    finite output and state, channels 0-7 against the port's CPU chain
    over the first blocks (output and every state leaf), channel 0's
    tone.  Returns (launches, ms/block, Ms/s, worst SNR, blocks run)."""
    B = cfg.block_len
    blocks = ref_capture(cfg, n_warm + n_timed, C, dev, seed)
    chain = refchain.RefRxChain(cfg, device=dev)
    state = chain.init_state((C,))
    kept, kept_state = [], None

    def step(blk):
        nonlocal state, kept_state
        audio, state = chain(state, i=blk[0], q=blk[1])
        if len(kept) < n_ref:
            kept.append(audio[:ref_ch].clone())
            if len(kept) == n_ref:
                kept_state = state
        return audio

    launches, ms_block, audio = timed_run(step, blocks, label, expect,
                                          n_warm, n_timed)
    msps = C * B / (ms_block * 1e-3) / 1e6
    check(tuple(audio.shape) == (C, B), f"audio shape {tuple(audio.shape)}")
    check(bool(torch.isfinite(audio).all()), f"{label} audio not finite")
    for f, v in refchain.state_to_numpy(state, cfg).items():
        check(bool(np.isfinite(v).all()), f"{label} state {f} not finite")
    cpu = refchain.RefRxChain(cfg, device="cpu")
    s_cpu = cpu.init_state((ref_ch,))
    worst = math.inf
    for blk in range(n_ref):
        i, q = blocks[blk]
        y_cpu, s_cpu = cpu(s_cpu, i=i[:ref_ch].cpu(), q=q[:ref_ch].cpu())
        s = snr_db(y_cpu, kept[blk].cpu())
        worst = min(worst, s)
        print(f"  {label} vs CPU chain, block {blk}, ch 0-{ref_ch - 1}: SNR "
              f"{s:.1f} dB")
    leaves = ref_leaves_snrs(
        refchain.state_to_numpy(s_cpu, cfg),
        {f: np.take(v, range(ref_ch), axis=v.shape.index(C)) for f, v in
         refchain.state_to_numpy(kept_state, cfg).items()},
        chain.params.sam.omega_max)
    low = min(leaves, key=leaves.get)
    print(f"  {label} state after block {n_ref - 1} vs CPU chain: worst "
          f"leaf {low} {leaves[low]:.1f} dB of {len(leaves)}")
    worst = min(worst, leaves[low])
    check(worst >= CHAIN_TOL_DB,
          f"{label} vs CPU chain: {worst:.1f} dB < {CHAIN_TOL_DB} dB")
    y0 = audio[0].cpu().double().numpy()
    spec = np.abs(np.fft.rfft((y0 - y0.mean()) * np.hanning(len(y0))))
    freqs = np.fft.rfftfreq(len(y0), 1.0 / refchain.IQ_RATE)
    spec[freqs < 100.0] = 0.0
    f_pk = float(freqs[spec.argmax()])
    tone = trace_rx.FM_TONE_HZ if cfg.mode == "fm" else trace_rx.TONE_HZ
    print(f"  {label} channel 0 audio peak {f_pk:.1f} Hz (tone {tone} Hz)")
    check(abs(f_pk - tone) < 20.0, f"{label} tone at {f_pk} Hz, not {tone}")
    return launches, ms_block, msps, worst, n_warm + n_timed


def output_stage(audio: torch.Tensor) -> float:
    """`chain.output.output_block` on the card on a main path's last audio
    block (chain scale), two blocks with per-channel mute and beep gates,
    against the same on the CPU.  Returns max |err|."""
    C, T = audio.shape
    p = output.make_params(af_gain=20, beep_freq_hz=880.0)
    gates = [(torch.arange(C) % 3 == 0, torch.arange(C) % 2 == 0),
             (False, True)]
    sk = output.init_state((C,), device=audio.device)
    sc = output.init_state((C,))
    err = 0.0
    for mute, beep in gates:
        def on(v, d):
            return v.to(d) if isinstance(v, torch.Tensor) else v
        yk, sk = output.output_block(p, sk, audio, on(mute, audio.device),
                                     on(beep, audio.device))
        yc, sc = output.output_block(p, sc, audio.cpu(), mute, beep)
        err = max(err, float((yk.cpu() - yc).abs().max()))
        check(bool(torch.equal(sk.beep_phase.cpu(), sc.beep_phase)),
              "output stage: the beep phases differ")
        check(float(yk.abs().max()) <= 1.0, "output stage: past full scale")
    print(f"  output stage on {C} x {T}: max |err| against the CPU "
          f"{err:.2e}")
    check(err <= 1e-6, f"output stage: {err:.2e} from the CPU")
    return err


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
    """The entry path of the linked stage's rows: `ops.agc.run_stereo` at
    12 kHz on (8192, 2, 2048) audio with a threshold per channel (40 ...
    80 dB), state carried; channels 0-7 against the same call on the CPU
    (plain versions) over the first blocks, >= KERNEL_TOL_DB.  Returns
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
                                      ("agc_stereo_rows",), n_warm, n_timed)
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


def agc_machine_path(dev, seed, rows: bool, n_timed=4, n_warm=2,
                     ref_ch=8):
    """The entry path of K13 (the reference's `_run_machine` on
    `agc_scan_pallas`): `cuda.agc.agc_scan` on the linked detector's
    look-ahead max and delayed |x| of (8192, 2, 2048) audio at 12 kHz,
    with scalar settings or a threshold per channel (`rows`), carries
    handed on; channels 0-7 against the same calls on the CPU over the
    first blocks, >= KERNEL_TOL_DB.  Returns (launches, ms/block, Ms/s of
    steps, worst SNR)."""
    C, T, w = CHANNELS, STEREO_ROWS_T, 48
    th = STEREO_ROWS_THRESH if rows else 60.0
    kp = agc_ops.kernel_params(agc_ops.make_params(12000.0, thresh_db=th),
                               C)
    srows = (None if kp.scan_rows is None
             else torch.as_tensor(kp.scan_rows, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    blocks = []
    tail = torch.zeros((C, w), device=dev)
    for k in range(n_warm + n_timed):
        a = torch.cat([tail, torch.stack(
            [agc_block(gen, dev, C, T, k * T, 12000.0),
             0.5 * agc_block(gen, dev, C, T, k * T, 12000.0)],
            dim=1).abs().amax(dim=1)], dim=-1)
        tail = a[:, T:].clone()
        blocks.append((agc_k.look_ahead_max(a, w, T).contiguous(),
                       a[:, :T].contiguous()))
    carry = torch.zeros((agc_k.N_CARRY, C), device=dev)
    kept = []

    def step(blk):
        nonlocal carry
        v, carry = agc_k.agc_scan(kp.scalars, carry, *blk, srows)
        if len(kept) < 2:
            kept.append(v[:ref_ch].clone())
        return v

    label = "agc_machine_rows" if rows else "agc_machine"
    name = "agc_scan_rows" if rows else "agc_scan"
    launches, ms_block, v = timed_run(step, blocks, label, (name,), n_warm,
                                      n_timed)
    check(tuple(v.shape) == (C, T) and bool(torch.isfinite(v).all()),
          f"{label} output")
    k8 = agc_ops.kernel_params(agc_ops.make_params(
        12000.0, thresh_db=STEREO_ROWS_THRESH[:ref_ch] if rows else 60.0),
        ref_ch)
    r8 = None if k8.scan_rows is None else torch.as_tensor(k8.scan_rows)
    c8 = torch.zeros((agc_k.N_CARRY, ref_ch))
    worst = math.inf
    for k in range(2):
        rm, ax = (t[:ref_ch].cpu() for t in blocks[k])
        v8, c8 = agc_k.agc_scan(k8.scalars, c8, rm, ax, r8)
        s = snr_db(v8, kept[k].cpu())
        worst = min(worst, s)
        print(f"  {label} vs CPU, block {k}, ch 0-{ref_ch - 1}: SNR "
              f"{s:.1f} dB")
    check(worst >= KERNEL_TOL_DB,
          f"{label} vs CPU: {worst:.1f} dB < {KERNEL_TOL_DB} dB")
    return launches, ms_block, C * T / (ms_block * 1e-3) / 1e6, worst


# "blocked" (K2): every path whose cascade stage is non-empty (the
# PreFilter; FM's squelch HPF; the TX voice bandpass), all but wide SSB
# ---------------------------------------------------------------------------
# FreeDV
# ---------------------------------------------------------------------------

def freedv_recorded_48k(translate_hz: float = 0.0, shift_from=None,
                        shift_hz: float = 0.0) -> np.ndarray:
    """The firmware's recorded 1600 IQ (`data.freedv("test_iq")`, 32000
    samples @ 8 kHz) raised to 48 kHz as tests/test_freedv_mode.py does
    (x6 zero-stuffing, a 96-tap 3.5 kHz lowpass), at +translate_hz, moved
    by shift_hz from sample shift_from on, phase-continuously; complex128
    on the host."""
    from scipy import signal
    iq8 = refdata.freedv("test_iq")
    iq8 = iq8 / (np.max(np.abs(iq8)) + 1e-9)
    up = np.zeros(len(iq8) * 6, np.complex128)
    up[::6] = iq8
    z = signal.lfilter(signal.firwin(96, 3500.0, fs=48000.0) * 6, [1.0], up)
    f = np.full(len(z), float(translate_hz))
    if shift_from is not None:
        f[shift_from:] += shift_hz
    ph = 2 * np.pi * np.concatenate([[0.0], np.cumsum(f[:-1])]) / 48000.0
    return z * np.exp(1j * ph)


def freedv_700d_48k() -> np.ndarray:
    """A 4 s 700D transmission made by the port's FreeDv700D.mod from
    bench_fleet.py's speech, raised x6 by resample_poly (complex128)."""
    from scipy import signal
    t8 = np.arange(8000 * 4) / 8000.0
    speech = (5000 * np.sin(np.cumsum(
        2 * np.pi * (120 + 25 * np.sin(2 * np.pi * 1.1 * t8)) / 8000.0))
    ).astype(np.float32)
    return signal.resample_poly(freedv_mod.FreeDv700D().mod(speech), 6, 1)


def freedv_planes(z48: np.ndarray, offsets: np.ndarray, k: int, B: int,
                  dev) -> tuple:
    """Block k of the capture z48 put at each channel's offset: (C, B) f32
    planes on the card, the rotation taken in float64."""
    C = len(offsets)
    n = torch.arange(k * B, (k + 1) * B, dtype=torch.float64, device=dev)
    z = torch.as_tensor(z48[k * B:(k + 1) * B], device=dev)
    f = torch.as_tensor(offsets, dtype=torch.float64, device=dev)
    xi = torch.empty((C, B), dtype=torch.float32, device=dev)
    xq = torch.empty_like(xi)
    for c0 in range(0, C, 1024):
        ang = (2 * math.pi / 48000.0) * f[c0:c0 + 1024, None] * n[None, :]
        zz = z[None, :] * torch.polar(torch.ones_like(ang), ang)
        xi[c0:c0 + 1024] = zz.real
        xq[c0:c0 + 1024] = zz.imag
    return xi, xq


def freedv_fleet_path(mode: str, C: int, dev, card: str) -> tuple:
    """`FreeDvFleetGroup(C, mode)` over the capture of the mode (mode
    1600: the firmware's recorded IQ; 700D: the port's own transmission),
    each channel at its own offset within +-FREEDV_SPAN_HZ, blocks of
    FREEDV_BLOCK f32 @ 48 kHz made on the card beforehand.  A block: the
    front (one K5 launch, timed with CUDA events), the baseband's copy to
    the host (the JAX group's NumPy expression), the batched modem tier
    (host NumPy, wall clock); the front's wall time with the copy
    includes the card's spin of FREEDV_SPIN_CYCLES ahead of the K5
    events.  Channels 0-7 go through a CPU group of the
    port too: the baseband >= FIR_TOL_DB and the speech bit for bit.
    Every channel must decode FREEDV_MIN_FRAMES[mode] frames; mode 1600
    with parity at most FREEDV_MAX_PARITY a frame.  Returns (launches,
    blocks run)."""
    z48 = freedv_recorded_48k() if mode == "freedv1600" else \
        freedv_700d_48k()
    B = FREEDV_BLOCK
    offsets = np.linspace(-FREEDV_SPAN_HZ, FREEDV_SPAN_HZ, C)
    blocks = [freedv_planes(z48, offsets, k, B, dev)
              for k in range(len(z48) // B)]
    grp = pfleet.FreeDvFleetGroup(C, mode, B, translate_hz=offsets,
                                  device=dev)
    ref = pfleet.FreeDvFleetGroup(FREEDV_REF_CH, mode, B,
                                  translate_hz=offsets[:FREEDV_REF_CH],
                                  device="cpu")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    k5_ms, front_ms, modem_s = [], [], []
    base_db, n_diff = math.inf, 0
    zero_launches()
    for xi, xq in blocks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the card spins while the host enqueues the front, so the events
        # read the launch's device time and not the host's enqueue
        torch.cuda._sleep(FREEDV_SPIN_CYCLES)
        ev[0].record()
        i_d, q_d = grp.front_device(xi, xq)
        ev[1].record()
        iq8 = i_d.cpu().numpy() + 1j * q_d.cpu().numpy()
        t1 = time.perf_counter()
        speech = grp._fleet_modem.demod(iq8)
        t2 = time.perf_counter()
        k5_ms.append(ev[0].elapsed_time(ev[1]))
        front_ms.append((t1 - t0) * 1e3)
        modem_s.append(t2 - t1)
        r8 = ref.front_block(xi[:FREEDV_REF_CH].cpu(),
                             xq[:FREEDV_REF_CH].cpu())
        base_db = min(base_db, snr_db(torch.from_numpy(r8), torch.from_numpy(
            iq8[:FREEDV_REF_CH])))
        for a, b in zip(ref._fleet_modem.demod(r8), speech):
            n_diff += int(a.shape != b.shape or not np.array_equal(a, b))
    launches = read_launches(mode, ("fir_rt",))
    del blocks
    st = grp.stats
    per_ch = grp._fleet_modem.frames_per_channel
    sec = B / 48000.0
    k5, fr, md = (float(np.mean(v)) for v in (k5_ms, front_ms, modem_s))
    print(f"  {mode}: K5 ms a block {' '.join(f'{v:.4f}' for v in k5_ms)} "
          f"(mean {k5:.4f}); front with the host copy, ms a block "
          f"{' '.join(f'{v:.2f}' for v in front_ms)} (mean {fr:.2f}); modem "
          f"tier, s a block {' '.join(f'{v:.3f}' for v in modem_s)} (mean "
          f"{md:.3f})")
    print(f"  {mode}: real-time channels: K5 {C * sec / (k5 * 1e-3):.0f}, "
          f"front with the copy {C * sec / (fr * 1e-3):.0f}, modem tier (one "
          f"process) {C * sec / md:.1f}; frames decoded {st['frames_decoded']}"
          f" (a channel: min {int(per_ch.min())}, max {int(per_ch.max())}), "
          + ", ".join(f"{k} {v}" for k, v in st.items()
                      if k not in ("frames_decoded", "channels"))
          + f"; channels 0-{FREEDV_REF_CH - 1} vs the CPU: baseband "
          f"{base_db:.1f} dB, {n_diff} speech blocks differ, frames "
          f"{ref._fleet_modem.frames_per_channel.tolist()}, "
          + ", ".join(f"{k} {v}" for k, v in ref.stats.items()
                      if k not in ("frames_decoded", "channels"))
          + f" on {card}")
    check(base_db >= FIR_TOL_DB, f"{mode}: channels 0-7 baseband "
                                 f"{base_db:.1f} dB < {FIR_TOL_DB} dB")
    check(n_diff == 0, f"{mode}: {n_diff} speech blocks of channels 0-7 "
                       f"differ from the CPU's")
    check(np.array_equal(per_ch[:FREEDV_REF_CH],
                         ref._fleet_modem.frames_per_channel),
          f"{mode}: channels 0-7 frames differ from the CPU's")
    check(int(per_ch.min()) >= FREEDV_MIN_FRAMES[mode],
          f"{mode}: a channel decoded {int(per_ch.min())} frames < "
          f"{FREEDV_MIN_FRAMES[mode]}")
    if mode == "freedv1600":
        check(st["parity_errors"] <= FREEDV_MAX_PARITY * st["frames_decoded"],
              f"{mode}: parity {st['parity_errors']} > {FREEDV_MAX_PARITY} "
              f"x {st['frames_decoded']} frames")
    return launches, len(k5_ms)


def freedv_front_path(dev, card: str) -> tuple:
    """The front alone at FREEDV_FRONT_CHANNELS x FREEDV_BLOCK (the
    recorded capture at offsets within +-FREEDV_SPAN_HZ): K5's ms a block
    by CUDA events over 10 blocks beside its byte bound, and one block
    with the host copy (front_block).  Returns (launches, blocks run)."""
    C, B = FREEDV_FRONT_CHANNELS, FREEDV_BLOCK
    offsets = np.linspace(-FREEDV_SPAN_HZ, FREEDV_SPAN_HZ, C)
    xi, xq = freedv_planes(freedv_recorded_48k(), offsets, 0, B, dev)
    grp = pfleet.FreeDvFleetGroup(C, block_len_48k=B, translate_hz=offsets,
                                  device=dev)
    zero_launches()
    ms = cuda_ms(lambda: grp.front_device(xi, xq), 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iq8 = grp.front_block(xi, xq)
    host_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches("freedv_front", ("fir_rt",))
    check(iq8.shape == (C, B // 6) and bool(np.isfinite(iq8).all()),
          "freedv_front baseband")
    T_out = B // 6
    nbytes = (2 * C * B * 4 + 2 * C * T_out * 4 + 2 * C * 71 * 8
              + 2 * C * 8 + C * 4 + 4 * 72)
    b_ms, b_by = bound(nbytes, 2.0 * C * T_out * 2 * 72)
    sec = B / 48000.0
    print(f"freedv_front: {C} ch x {B} f32 @ 48 kHz, K5 with a delta a "
          f"channel: {ms:.4f} ms a block (bound {b_ms:.4f} ms by {b_by}, "
          f"{nbytes / 1e6:.1f} MB; {100 * b_ms / ms:.1f}%), "
          f"{C * sec / (ms * 1e-3):.0f} real-time channels; with the host "
          f"copy {host_ms:.2f} ms, {C * sec / (host_ms * 1e-3):.0f} "
          f"real-time channels on {card}")
    return launches, 12


def freedv_radio_path(dev, card: str) -> tuple:
    """`FreeDvRadioMode("freedv1600")` on one channel of the recorded
    capture at translate 6000 Hz in blocks of FREEDV_RADIO_BLOCK; from
    block FREEDV_RETUNE_BLOCK on the capture moves by FREEDV_RETUNE_HZ and
    `extra_offset_hz` follows it (K5 with the NCO, its history re-rotated
    at the retune).  Frames and parity held to FREEDV_MIN_FRAMES and
    FREEDV_MAX_PARITY; the speech bit-equal to the port's radio on the
    CPU.  Returns (launches, blocks run)."""
    B = FREEDV_RADIO_BLOCK
    cap = freedv_recorded_48k(6000.0, FREEDV_RETUNE_BLOCK * B,
                              FREEDV_RETUNE_HZ).astype(np.complex64)
    on_card = freedv_mod.FreeDvRadioMode("freedv1600", B, 6000.0, device=dev)
    on_cpu = freedv_mod.FreeDvRadioMode("freedv1600", B, 6000.0,
                                        device="cpu")
    n_diff, n_blocks = 0, len(cap) // B
    zero_launches()
    t0 = time.perf_counter()
    for k in range(n_blocks):
        blk = cap[k * B:(k + 1) * B]
        extra = FREEDV_RETUNE_HZ if k >= FREEDV_RETUNE_BLOCK else 0.0
        a = on_card.rx_block(blk.real[None], blk.imag[None], extra)
        b = on_cpu.rx_block(blk.real[None], blk.imag[None], extra)
        n_diff += int(not np.array_equal(a, b))
    launches = read_launches("freedv_radio", ("fir_rt",))
    st = on_card.stats
    print(f"freedv_radio: 1 ch, {n_blocks} blocks of {B} f32 @ 48 kHz, "
          f"translate 6000 Hz, +{FREEDV_RETUNE_HZ:.0f} Hz from block "
          f"{FREEDV_RETUNE_BLOCK}: {st}, CPU {on_cpu.stats}, {n_diff} speech "
          f"blocks differ ({time.perf_counter() - t0:.1f} s) on {card}")
    check(n_diff == 0 and st == on_cpu.stats,
          "freedv_radio: the card's speech or stats differ from the CPU's")
    check(st["frames_decoded"] >= FREEDV_MIN_FRAMES["freedv1600"]
          and st["parity_errors"] <= FREEDV_MAX_PARITY * st["frames_decoded"],
          f"freedv_radio: {st}")
    return launches, n_blocks


def freedv_glue_path(dev, card: str) -> tuple:
    """`freedv_rx_block` (48k IQ -> K5 -> the 1600 modem -> K4 x6) over
    8 blocks of the recorded capture at 0 Hz (K5 without the NCO), held
    to the port's CPU route at FIR_TOL_DB.  Returns (launches, blocks
    run)."""
    B = FREEDV_RADIO_BLOCK
    cap = freedv_recorded_48k().astype(np.complex64)
    conv = freedv_mod.RateConverter(B, device=dev)
    conv_cpu = freedv_mod.RateConverter(B, device="cpu")
    modem, modem_cpu = freedv_mod.FreeDv1600(), freedv_mod.FreeDv1600()
    worst, n_out = math.inf, 0
    zero_launches()
    for k in range(8):
        blk = torch.from_numpy(cap[k * B:(k + 1) * B])
        y = freedv_mod.freedv_rx_block(conv, modem, blk.to(dev))
        yc = freedv_mod.freedv_rx_block(conv_cpu, modem_cpu, blk)
        check(tuple(y.shape) == tuple(yc.shape), "freedv_glue shapes")
        if y.shape[-1]:
            worst = min(worst, snr_db(yc, y.cpu()))
            n_out += y.shape[-1]
    launches = read_launches("freedv_glue", ("fir_rt", "interp"))
    print(f"freedv_glue: 8 blocks of {B} through freedv_rx_block, "
          f"{modem.frames_decoded} frames, {n_out} samples out @ 48 kHz, "
          f"CPU route {worst:.1f} dB on {card}")
    check(worst >= FIR_TOL_DB, f"freedv_glue: {worst:.1f} dB < "
                               f"{FIR_TOL_DB} dB")
    return launches, 8


# ---------------------------------------------------------------------------
# the entry points: the command line and the live server, in process
# ---------------------------------------------------------------------------

CLI_BLOCK = 4096
CLI_FS = 48000
CLI_SECONDS = 30                   # the rx capture: 30 s of 16-bit IQ
CLI_TONE_HZ = 6700.0               # +6.7 kHz: 700 Hz in usb's audio
CLI_CENTER = 14_001_000
CLI_RX_KERNELS = ("front", "blocked", "agc", "interp")
# channelize: 512 channels of 48 kHz, 24.6 MHz of HF (a direct-sampling
# receiver's span), 8 blocks; tones in three channels, the first loudest
CLI_CH_M = 512
CLI_CH_BLOCKS = 8
CLI_CH_TONES = ((37, 0.3), (200, 0.1), (411, 0.05))
# tx --text / rx --decode; the CW decoder's word gaps put spaces between
# a 28 wpm signal's letters, so CW's text is read with its spaces removed
CLI_TEXTS = {"cw": "TEST", "rtty": "RYRY DE UHSDR", "psk": "psk31 de uhsdr"}
CLI_TEXT_KERNELS = CLI_RX_KERNELS + ("fir_real", "alc", "cw", "psk", "rtty")
CLI_SERVE_BLOCKS = 64
CLI_SERVE_KERNELS = CLI_RX_KERNELS + ("fir_rt",)
CLI_CPU_BLOCKS = 3                 # blocks held to the CPU route


def run_cli(argv: list) -> tuple[dict, dict, float]:
    """`cli.main(argv)` in process: (its last JSON line, {writer: the
    array the command handed it}, wall s).  The arrays are taken where
    the command calls `io.ingest`'s WAV writers, before 16-bit rounding."""
    names = ("write_audio_wav", "write_iq_wav")
    saved = {fn: getattr(ingest_mod, fn) for fn in names}
    got = {}

    def keeper(fn):
        def keep(path, a, *args, **kw):
            got[fn] = np.array(a)
            saved[fn](path, a, *args, **kw)
        return keep
    for fn in names:
        setattr(ingest_mod, fn, keeper(fn))
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main([str(a) for a in argv])
    finally:
        for fn in names:
            setattr(ingest_mod, fn, saved[fn])
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli {' '.join(map(str, argv))} exited {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1]), got, wall


def peak_hz(audio: np.ndarray, fs: float = CLI_FS) -> float:
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    spec[:8] = 0.0
    return float(np.fft.rfftfreq(len(audio), 1 / fs)[spec.argmax()])


def cli_capture(path: str, seed: int) -> str:
    """CLI_SECONDS of a tone at +CLI_TONE_HZ (0.3 of full scale) in
    complex noise (0.01 rms a plane), 16-bit IQ WAV @ 48 kHz."""
    n = CLI_SECONDS * CLI_FS
    rng = np.random.default_rng(seed)
    t = np.arange(n) / CLI_FS
    iq = 0.3 * np.exp(2j * np.pi * CLI_TONE_HZ * t) + 0.01 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    ingest_mod.write_iq_wav(path, iq.astype(np.complex64))
    return path


def cli_rx_path(cap: str, tmp: str, card: str) -> tuple:
    """`rx --mode usb --block 4096` on the card over the whole capture,
    f32 planes and `--raw-i16`, after a 3-block warm-up run; the first
    blocks of each held to `rx --device cpu --max-blocks 3` at
    CHAIN_TOL_DB, the tone at 700 Hz.  Returns (launches, blocks run)."""
    argv = ["rx", "--input", cap, "--mode", "usb", "--block", CLI_BLOCK,
            "--out", f"{tmp}/rx.wav"]
    run_cli(argv + ["--max-blocks", CLI_CPU_BLOCKS])      # warm-up
    zero_launches()
    runs = {"f32": run_cli(argv), "raw_i16": run_cli(argv + ["--raw-i16"])}
    launches = read_launches("cli_rx", CLI_RX_KERNELS)
    m_cpu, got_cpu, wall_cpu = run_cli(argv + ["--device", "cpu",
                                               "--max-blocks",
                                               CLI_CPU_BLOCKS])
    ref = got_cpu["write_audio_wav"]
    n_blocks = 0
    for label, (m, got, wall) in runs.items():
        audio = got["write_audio_wav"]
        s = snr_db(ref, audio[:ref.size])
        pk = peak_hz(audio[-CLI_FS:])
        secs = m["blocks"] * CLI_BLOCK / CLI_FS
        print(f"  cli_rx {label}: {m['blocks']} blocks of {CLI_BLOCK} in "
              f"{wall:.2f} s wall, {secs / wall:.1f}x real time, "
              f"{m['blocks'] / wall:.1f} blocks/s; dBm {m['dbm']:.2f}, SNAP "
              f"{m['snap_freq_hz']:.1f} Hz, peak {pk:.1f} Hz; first "
              f"{CLI_CPU_BLOCKS} blocks against --device cpu {s:.1f} dB "
              f"on {card}")
        check(m["blocks"] == -(-CLI_SECONDS * CLI_FS // CLI_BLOCK)
              and np.isfinite(audio).all(), f"cli_rx {label}: {m}")
        check(s >= CHAIN_TOL_DB, f"cli_rx {label}: {s:.1f} dB against the "
                                 f"CPU < {CHAIN_TOL_DB} dB")
        check(abs(pk - 700.0) <= 15.0, f"cli_rx {label}: peak {pk:.1f} Hz")
        n_blocks += m["blocks"]
    print(f"  cli_rx --device cpu: {m_cpu['blocks']} blocks in "
          f"{wall_cpu:.2f} s")
    return launches, n_blocks


def cli_text_path(tmp: str, card: str) -> tuple:
    """`tx --mode cw|rtty|psk --text`, then `rx --decode` on the card:
    each decoded text holds the sent one; `tx --mode usb` (a 700 Hz tone),
    then `rx`: the audio's peak at 700 +- 15 Hz.  Returns (launches, RX
    blocks run)."""
    zero_launches()
    n_rx = 0
    for mode, text in CLI_TEXTS.items():
        iq = f"{tmp}/{mode}.wav"
        extra = ["--wpm", CW_WPM] if mode == "cw" else []
        m_tx, _, w_tx = run_cli(["tx", "--out", iq, "--mode", mode,
                                 "--text", text] + extra)
        m_rx, _, w_rx = run_cli(["rx", "--input", iq, "--mode", mode,
                                 "--decode"])
        got = m_rx["text"]
        n_rx += m_rx["blocks"]
        print(f"  cli_text {mode}: tx {m_tx['samples']} samples "
              f"({w_tx:.2f} s), rx {m_rx['blocks']} blocks ({w_rx:.2f} s): "
              f"{got!r} on {card}")
        seen = got.replace(" ", "") if mode == "cw" else got
        check(text in seen, f"cli_text {mode}: {got!r} lacks {text!r}")
    iq = f"{tmp}/usb.wav"
    m_tx, _, w_tx = run_cli(["tx", "--out", iq, "--mode", "usb"])
    m_rx, got, w_rx = run_cli(["rx", "--input", iq, "--mode", "usb",
                               "--out", f"{tmp}/usb_audio.wav"])
    pk = peak_hz(got["write_audio_wav"][24000:])
    print(f"  cli_text usb: tx {m_tx['samples']} samples ({w_tx:.2f} s), "
          f"rx {m_rx['blocks']} blocks ({w_rx:.2f} s), peak {pk:.1f} Hz "
          f"on {card}")
    check(abs(pk - 700.0) <= 15.0, f"cli_text usb: peak {pk:.1f} Hz")
    return read_launches("cli_text", CLI_TEXT_KERNELS), n_rx + m_rx["blocks"]


def cli_freedv_path(tmp: str, card: str) -> tuple:
    """`rx --mode freedv1600 --block 4800` on the firmware's recorded 1600
    IQ raised to 48 kHz at +6 kHz (`freedv_recorded_48k`, at half scale
    as tests/test_freedv_mode.py writes it): >= 60 frames, parity <= 0.2
    a frame, the speech and stats equal to `--device cpu`'s.  Returns
    (launches, blocks run)."""
    cap = f"{tmp}/freedv.wav"
    ingest_mod.write_iq_wav(cap, (0.5 * freedv_recorded_48k(6000.0)
                                  ).astype(np.complex64))
    argv = ["rx", "--input", cap, "--mode", "freedv1600", "--block",
            FREEDV_RADIO_BLOCK, "--out", f"{tmp}/freedv_speech.wav"]
    zero_launches()
    m, got, wall = run_cli(argv)
    launches = read_launches("cli_freedv", ("fir_rt",))
    m_cpu, got_cpu, wall_cpu = run_cli(argv + ["--device", "cpu"])
    same = np.array_equal(got["write_audio_wav"], got_cpu["write_audio_wav"])
    print(f"  cli_freedv: {m} in {wall:.2f} s wall "
          f"({m['blocks'] * FREEDV_RADIO_BLOCK / CLI_FS / wall:.1f}x real "
          f"time); --device cpu {wall_cpu:.2f} s, speech "
          f"{'bit-equal' if same else 'DIFFERS'} on {card}")
    check(m["frames_decoded"] >= FREEDV_MIN_FRAMES["freedv1600"]
          and m["parity_errors"] <= FREEDV_MAX_PARITY * m["frames_decoded"],
          f"cli_freedv: {m}")
    check(same and m == m_cpu, f"cli_freedv: card {m} against CPU {m_cpu}")
    return launches, m["blocks"]


def cli_channelize_path(tmp: str, seed: int, card: str) -> tuple:
    """`channelize --channels 512 --block 4096` over 8 blocks of a
    24.576 MHz capture with tones 6.7 kHz above the centres of channels
    37, 200 and 411 (0.3, 0.1, 0.05 of full scale) in noise: `rms_argmax`
    must be 37 and `active_channels` 3.  Returns (launches, blocks)."""
    M, n_blocks = CLI_CH_M, CLI_CH_BLOCKS
    fs = M * CLI_FS
    n = M * CLI_BLOCK * n_blocks
    rng = np.random.default_rng(seed)
    iq = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    t = np.arange(n) / fs
    for k, a in CLI_CH_TONES:
        iq += (a * np.exp(2j * np.pi * (k * CLI_FS + CLI_TONE_HZ) * t)
               ).astype(np.complex64)
    del t
    cap = f"{tmp}/wide.wav"
    ingest_mod.write_iq_wav(cap, iq, fs=fs)
    del iq
    zero_launches()
    m, _, wall = run_cli(["channelize", "--input", cap, "--channels", M,
                          "--block", CLI_BLOCK])
    launches = read_launches("cli_channelize", CLI_RX_KERNELS)
    secs = n_blocks * CLI_BLOCK / CLI_FS
    print(f"  cli_channelize: {m} in {wall:.2f} s wall, "
          f"{n / wall / 1e6:.1f} Ms/s wideband, {secs / wall:.2f}x real "
          f"time ({M} channels) on {card}")
    check(m["blocks"] == n_blocks and m["rms_argmax"] == CLI_CH_TONES[0][0]
          and m["active_channels"] == len(CLI_CH_TONES),
          f"cli_channelize: {m} against tones at {CLI_CH_TONES}")
    return launches, n_blocks


def serve_window(radio, n: int, trace_dir: str | None = None) -> tuple:
    """Wait for n RX blocks of a running server: (blocks/s, device busy
    share of the wall window under `profiling.trace`, None untraced)."""
    ctx = (profiling.trace(trace_dir) if trace_dir is not None
           else contextlib.nullcontext())
    with ctx as prof:
        b0, t0 = radio.blocks_processed, time.perf_counter()
        check(radio.wait_blocks(n, timeout=120), f"serve: {radio.error}")
        b1, wall = radio.blocks_processed, time.perf_counter() - t0
    busy = None
    if prof is not None:
        kern = [(e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if kern:
            busy = trace_rx.busy_share(kern)[0] / (wall * 1e6)
    return (b1 - b0) / wall, busy


def cli_serve_path(cap: str, tmp: str, card: str) -> tuple:
    """`serve` on the card over the looping capture with a `CatClient`
    over TCP (port 0): 16 blocks timed, 16 under the profiler (the device
    busy share of the wall window; the rest is the host's), then a CAT
    command every 8 blocks: retunes +-500 Hz, usb -> am -> usb, CW with
    "TEST" queued and PTT for 4 TX blocks, past 64 RX blocks.  The audio
    before the first command is held to the CPU chain at CHAIN_TOL_DB;
    `error` must stay None.  Returns (launches, RX blocks)."""
    rt = CLI_FS / CLI_BLOCK                       # blocks/s of real time
    cfg = server_mod.ServeConfig(iq_path=cap, center_hz=CLI_CENTER,
                                 block_len=CLI_BLOCK, mode="usb", loop=True,
                                 audio_keep_blocks=4 * CLI_SERVE_BLOCKS,
                                 device="cuda")
    zero_launches()
    radio, catsrv = server_mod.serve(cfg)
    client = None
    try:
        client = cat_mod.CatClient(port=catsrv.port)
        check(radio.wait_blocks(CLI_CPU_BLOCKS + 1, timeout=120),
              f"serve: {radio.error}")
        first = radio.audio()[:CLI_CPU_BLOCKS * CLI_BLOCK].copy()
        bps, _ = serve_window(radio, 16)
        bps_tr, busy = serve_window(radio, 16, f"{tmp}/serve_trace")
        b0, t0 = radio.blocks_processed, time.perf_counter()
        steps = [("tune", 500), ("tune", -500), ("mode", "am"),
                 ("tune", 500), ("mode", "usb"), ("tune", 0), ("ptt", "TEST"),
                 ("tune", -500)]
        for kind, arg in steps:
            check(radio.wait_blocks(8, timeout=120), f"serve: {radio.error}")
            if kind == "tune":
                client.set_frequency(CLI_CENTER + arg)
            elif kind == "mode":
                check(client.set_mode(arg), f"serve: set_mode {arg}")
            else:
                check(client.set_mode("cw"), "serve: set_mode cw")
                radio.queue_tx_text(arg)
                client.ptt(True)
                check(radio.wait_blocks(4, timeout=120, tx=True),
                      f"serve: {radio.error}")
                client.ptt(False)
                check(client.set_mode("usb"), "serve: set_mode usb")
        left = CLI_SERVE_BLOCKS - (radio.blocks_processed - b0)
        if left > 0:
            check(radio.wait_blocks(left, timeout=120),
                  f"serve: {radio.error}")
        n_cmd, wall = radio.blocks_processed - b0, time.perf_counter() - t0
        tele = dict(dial_hz=radio.dial_hz, mode=radio.mode,
                    dbm=radio.dbm, s_meter=radio.s_meter,
                    snap_hz=radio.snap_freq_hz, fwd_pwr_w=radio.fwd_pwr,
                    tx_blocks=radio.tx_blocks_processed)
    finally:
        if client is not None:
            client.close()
        radio.stop()
        catsrv.stop()
    launches = read_launches("cli_serve", CLI_SERVE_KERNELS)
    check(radio.error is None, f"serve: {radio.error}")
    # the CPU chain on the capture's first blocks, as the pump runs them
    c = rx.RxConfig(mode="usb", bw_key=cfg.bw_key,
                    translate_hz=cfg.translate_hz, agc_mode=cfg.agc_mode,
                    block_len=CLI_BLOCK)
    chain = rx.RxChain(c, device="cpu")
    st = chain.init_state((1,))
    ref = []
    with ingest_mod.IqIngest(cap, CLI_BLOCK) as src:
        for _ in range(CLI_CPU_BLOCKS):
            i, q = src.next_block()
            y, st, _ = chain(st, i=i[None], q=q[None], tune_offset_hz=0.0)
            ref.append(y[0].numpy())
    s = snr_db(np.concatenate(ref), first)
    share = ("not measured (no device events)" if busy is None else
             f"device busy {100 * busy:.1f}%, host {100 * (1 - busy):.1f}%")
    print(f"  cli_serve: usb at 1 channel, {bps:.1f} RX blocks/s "
          f"({bps / rt:.1f}x real time, {rt:.2f} blocks/s); under the "
          f"profiler {bps_tr:.1f} blocks/s, {share}; with the CAT commands "
          f"{n_cmd} RX blocks in {wall:.2f} s ({n_cmd / wall / rt:.1f}x "
          f"real time); telemetry {tele}; first {CLI_CPU_BLOCKS} blocks "
          f"against the CPU chain {s:.1f} dB on {card}")
    check(s >= CHAIN_TOL_DB, f"serve: {s:.1f} dB against the CPU chain")
    check(tele["tx_blocks"] >= 4 and tele["fwd_pwr_w"] > 0.0
          and tele["mode"] == "usb" and math.isfinite(tele["dbm"]),
          f"serve: telemetry {tele}")
    return launches, radio.blocks_processed


def cli_paths(seed: int, card: str) -> list:
    """The five entry-point paths: [(label, launches, blocks run)]."""
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        cap = cli_capture(f"{tmp}/cap.wav", seed)
        for label, run in (
                ("cli_rx", lambda: cli_rx_path(cap, tmp, card)),
                ("cli_text", lambda: cli_text_path(tmp, card)),
                ("cli_freedv", lambda: cli_freedv_path(tmp, card)),
                ("cli_channelize",
                 lambda: cli_channelize_path(tmp, seed, card)),
                ("cli_serve", lambda: cli_serve_path(cap, tmp, card))):
            t1 = time.time()
            print(f"phase entry path {label}:")
            launches, n_blocks = run()
            out.append((label, launches, n_blocks))
            torch.cuda.empty_cache()
            print(f"entry path {label}: {time.time() - t1:.1f} s")
    return out


SHARED = ("agc", "interp", "blocked")
FM_KERNELS = ("fir_rt", "fm_disc", "agc", "blocked")
TWO_CH = ("agc_stereo", "interp", "blocked")
DEPTH = 1024          # channels of the paths run at a smaller depth
# (label, config, kernels it must launch, timed blocks, channels)
MAIN_PATHS = (
    ("ssb", CFG, ("front",) + SHARED, 8, CHANNELS),
    ("am", dataclasses.replace(SAM, mode="am"), ("fir_rt",) + SHARED, 8,
     CHANNELS),
    ("sam_both", dataclasses.replace(SAM, sam_sideband="both"),
     ("fir_rt", "pll_audio") + SHARED, 8, CHANNELS),
    ("sam_usb", dataclasses.replace(SAM, sam_sideband="usb"),
     ("fir_rt", "pll", "sam_sideband") + SHARED, 8, CHANNELS),
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
     ("fir_rt", "pll", "sam_sideband") + TWO_CH, 4, DEPTH),
    # the RX options: the SSB flagship with the IQ correction, the notch,
    # the blanker and the NR; with the leaky LMS; AM with the blanker; the
    # two-channel flagship with the NR
    ("ssb_opts", trace_rx.config("ssb_opts"),
     ("iqcorr", "front", "lms", "blanker", "nr") + SHARED, 8, CHANNELS),
    ("ssb_leaky", trace_rx.config("ssb_leaky"),
     ("front", "lms_leaky") + SHARED, 8, CHANNELS),
    ("am_nb", dataclasses.replace(SAM, mode="am", nb_enable=True),
     ("fir_rt", "blanker") + SHARED, 4, DEPTH),
    ("ssbstereo_nr", dataclasses.replace(STEREO, nr_enable=True),
     ("front_pair", "nr") + TWO_CH, 4, DEPTH),
    # the legacy redesigned front: the SSB flagship on it (K7), AM and FM
    # (K5; FM at decimation 1 and 96 kHz), and the wide rows' iq (K5) and
    # ssbstereo (two K7 launches), which run it on the default front
    ("ssb_scipy", SCIPY, ("fir_cx_nco", "blocked", "agc", "interp"), 8,
     CHANNELS),
    ("am_scipy", dataclasses.replace(SCIPY, mode="am", bw_key="5P0KHZ",
                                     path_name=None),
     ("fir_rt",) + SHARED, 4, DEPTH),
    ("fm_scipy", dataclasses.replace(SCIPY, mode="fm", bw_key="5P0KHZ",
                                     path_name=None), FM_KERNELS, 4, DEPTH),
    ("iq_wide", dataclasses.replace(STEREO, mode="iq", bw_key="10P0KHZ",
                                    path_name=None),
     ("fir_rt",) + TWO_CH, 4, DEPTH),
    ("ssbstereo_wide", dataclasses.replace(STEREO, bw_key="5P0KHZ"),
     ("fir_cx_nco",) + TWO_CH, 4, DEPTH),
)
# the reference chain (RefRxChain, f32 planes @ 48 kHz): (label, config,
# kernels it must launch, timed blocks, channels)
REF_PATHS = (
    ("refchain", REF, ("fir_rt", "fir_cx", "lattice", "agc", "interp"), 8,
     CHANNELS),
    ("refchain_sam", dataclasses.replace(REF, mode="sam", select_id=None),
     ("fir_rt", "pll_audio", "lattice", "agc", "interp"), 4, DEPTH),
    ("refchain_fm", dataclasses.replace(REF, mode="fm", bw_key="3P6KHZ",
                                        select_id=None),
     ("fir_rt", "fm_disc", "blocked", "agc"), 4, DEPTH),
)
PATH_ENV = {"ssb_mt": {"UHSDR_FRONT_MT": "1"}}
# an earlier ms/block of a path, printed beside this run's (PERF.md
# section 5: chip_smoke.py on an H100 80GB HBM3 at 700 W)
EARLIER_MS = {"ssb_opts": "5.088 ms/block before the IQ correction's and "
                          "the NLMS notch's redesign"}
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
    # FM: the ref front's serial voice lattice, the ALC and the table-mode
    # modulator; the legacy front's voice SOS (K2), the ALC and the torch
    # modulator
    ("tx_fm", TX_FM, ("lattice", "alc", "fm_mod"), 8, CHANNELS),
    ("tx_fm_scipy", dataclasses.replace(TX_FM, front="scipy"),
     ("blocked", "alc"), 4, DEPTH),
)
# The legacy FM modulator rounds each step of its accumulator from the
# voice SOS's output, which K2 and its plain version sum in other orders
# (~100 dB apart): a rounding now and then lands a step apart, and the
# phase walks.  Its paths hold card against CPU at this bound, the steps
# apart counted as phase (ROADMAP queue C).
TX_TOL_DB = {"tx_fm_scipy": 60.0}


# ---------------------------------------------------------------------------
# the sharded paths (`parallel/`), at world size 1 on the card
# ---------------------------------------------------------------------------

# the sharded RX step's kernels: K5 (stage A), K6 (stage B at decimation
# 1), K2, K3, K4
SHARDED_RX_KERNELS = ("fir_rt", "fir_cx", "blocked", "agc", "interp")
SHARDED_SP = 4            # time shards a block of `sharded_rx_sp4`


def f32_planes(blocks) -> list:
    """int16 (i, q) planes -> f32 at full scale 1 (counts / 32768), in
    place of the int16 ones."""
    for k, (i, q) in enumerate(blocks):
        blocks[k] = (i.to(torch.float32) / 32768.0,
                     q.to(torch.float32) / 32768.0)
    return blocks


def sharded_rx_path(mesh, dev, seed, n_timed=8, n_warm=2, n_ref=3):
    """`rx_sharded.make_sharded_rx(rx.FLAGSHIP)` on a 1 x 1 mesh at 8192
    ch x 16384 f32 planes @ 96 kHz (the flagship's int16 planes / 32768),
    state carried, timed as the main paths; then `RxChain(rx.FLAGSHIP)`
    (fused K1) on the same planes over the first n_ref blocks: every
    channel's audio and every post-front state leaf at >= CHAIN_TOL_DB,
    the NCO phase equal.  Returns (launches, ms/block, Ms/s, worst
    SNR)."""
    cfg, C = CFG, CHANNELS
    blocks = f32_planes(trace_rx.capture(n_warm + n_timed, C, dev, seed,
                                         cfg))
    step_fn, init_state = rx_sharded.make_sharded_rx(cfg, mesh, dev)
    state = init_state(C)
    kept, kept_state = [], None

    def step(blk):
        nonlocal state, kept_state
        audio, state = step_fn(state, *blk)
        if len(kept) < n_ref:
            kept.append(audio.clone())
            if len(kept) == n_ref:
                kept_state = state
        return audio

    launches, ms_block, audio = timed_run(step, blocks, "sharded_rx",
                                          SHARDED_RX_KERNELS, n_warm,
                                          n_timed)
    msps = C * cfg.block_len / (ms_block * 1e-3) / 1e6
    check(tuple(audio.shape) == (C, cfg.block_len),
          f"sharded_rx audio shape {tuple(audio.shape)}")
    check(bool(torch.isfinite(audio).all()), "sharded_rx audio not finite")
    chain = rx.RxChain(cfg, device=dev)
    s = chain.init_state((C,))
    worst = math.inf
    for k in range(n_ref):
        y, s, _ = chain(s, i=blocks[k][0], q=blocks[k][1])
        v = snr_db(y, kept[k])
        worst = min(worst, v)
        print(f"  sharded_rx vs RxChain (fused K1) on the same planes, "
              f"block {k}, all {C} channels: SNR {v:.1f} dB")
    del blocks, kept
    ref = rx.state_to_numpy(s)
    got = rx.state_to_numpy(kept_state.post)
    check(np.array_equal(ref.pop("nco_phase"),
                         kept_state.phase.cpu().numpy().astype(np.uint32)),
          "sharded_rx NCO phase differs from RxChain's")
    ref.pop("front_carry")
    leaves = state_snrs(ref, got)
    low = min(leaves, key=leaves.get)
    print(f"  sharded_rx state after block {n_ref - 1} vs RxChain: worst "
          f"leaf {low} {leaves[low]:.1f} dB of {len(leaves)}")
    worst = min(worst, leaves[low])
    check(worst >= CHAIN_TOL_DB,
          f"sharded_rx vs RxChain: {worst:.1f} dB < {CHAIN_TOL_DB} dB")
    return launches, ms_block, msps, worst


def sharded_rx_sp4_path(mesh, dev, seed, n_blocks=3, C=DEPTH):
    """The sharded front's seams on the card: `rx.FLAGSHIP` at C channels,
    each block cut into SHARDED_SP time shards, each shard through
    `rx_sharded.front_end_local` with the previous shard's raw tail as its
    halo (the first shard's the previous block's), then stage B and the
    post on the joined output; held to the 1 x 1 step on the same planes:
    the front's output (the whole block through `front_end_local`) at
    >= FIR_TOL_DB, every shard's E seam outputs on their own too, and the
    audio at >= CHAIN_TOL_DB.  The NCO starts near the uint32 wrap.
    Returns (launches, worst SNR of the front, of the seams, of the
    audio)."""
    cfg = CFG
    p = rx.make_params(cfg, dev)
    blocks = f32_planes(trace_rx.capture(n_blocks, C, dev, seed + 1, cfg))
    T, L, decim = cfg.block_len, p.front_fir.shape[-1] - 1, cfg.front_decim
    t, E = T // SHARDED_SP, -(-L // decim)
    step_fn, init_state = rx_sharded.make_sharded_rx(cfg, mesh, dev)
    st = init_state(C)
    st = st._replace(phase=st.phase + (2**32 - 1000 * p.nco_delta) % 2**32)
    phase, hist, post = st.phase, st.carry, st.post
    worst_zf = worst_seam = worst_audio = math.inf
    zero_launches()
    for k, (i, q) in enumerate(blocks):
        whole = rx_sharded.front_end_local(p, cfg, 0, phase, hist, i, q)
        parts, h = [], hist
        for s in range(SHARDED_SP):
            ii = i[:, s * t:(s + 1) * t].contiguous()
            qq = q[:, s * t:(s + 1) * t].contiguous()
            parts.append(rx_sharded.front_end_local(p, cfg, s, phase, h, ii,
                                                    qq))
            h = torch.stack([ii[:, t - L:], qq[:, t - L:]], dim=1)
        zf = tuple(torch.cat([z[n] for z in parts], dim=-1) for n in (0, 1))
        a, b = torch.complex(*whole), torch.complex(*zf)
        seams = torch.cat([torch.arange(s * t // decim, s * t // decim + E)
                           for s in range(SHARDED_SP)]).to(dev)
        s_zf, s_seam = snr_db(a, b), snr_db(a[:, seams], b[:, seams])
        audio, post, _ = rx.demod_and_post(cfg, p, post, zf)
        y1, st = step_fn(st, i, q)
        s_a = snr_db(y1, audio)
        print(f"  sharded_rx_sp4 block {k}: front {s_zf:.1f} dB, the "
              f"{SHARDED_SP} x {E} seam outputs {s_seam:.1f} dB, audio "
              f"{s_a:.1f} dB against the 1 x 1 step")
        worst_zf, worst_seam = min(worst_zf, s_zf), min(worst_seam, s_seam)
        worst_audio = min(worst_audio, s_a)
        hist = torch.stack([i[:, T - L:], q[:, T - L:]], dim=1)
        phase = nco.advance(phase, p.nco_delta, T)
    launches = read_launches("sharded_rx_sp4", SHARDED_RX_KERNELS)
    check(min(worst_zf, worst_seam) >= FIR_TOL_DB
          and worst_audio >= CHAIN_TOL_DB,
          f"sharded_rx_sp4: front {worst_zf:.1f}, seams {worst_seam:.1f} "
          f"(< {FIR_TOL_DB}) or audio {worst_audio:.1f} dB (< "
          f"{CHAIN_TOL_DB})")
    return launches, worst_zf, worst_seam, worst_audio


def sharded_tx_path(mesh, dev, seed, C=DEPTH):
    """`tx_sharded.make_sharded_tx(tx.TX_FLAGSHIP)` on a 1 x 1 mesh at C
    channels x 16384 f32 audio, one block, untimed: the step is the
    port's `TxChain` on the rank's channels, which the `tx` paths time.
    Held to a second `TxChain` on the same block bit for bit.  Returns
    the launches."""
    (audio,) = trace_tx.capture(1, C, dev, seed, TXF)
    step_fn, init_state = tx_sharded.make_sharded_tx(TXF, mesh, dev)
    zero_launches()
    i, q, _ = step_fn(init_state(C), audio)
    launches = read_launches("sharded_tx", TX_VOICE)
    chain = tx.TxChain(TXF, device=dev)
    ri, rq, _ = chain(chain.init_state((C,)), audio)
    check(torch.equal(i, ri) and torch.equal(q, rq),
          "sharded_tx differs from TxChain")
    return launches


def sharded_wideband_path(mesh, dev, seed, n_timed=WIDEBAND_TIMED,
                          n_warm=2, n_ref=2):
    """`wideband_sharded.make_sharded_channelizer` on a 1 x 1 mesh at the
    `wideband` path's bank (4096 channels x 4096, 12 taps a branch),
    timed (torch products and FFT: no hand kernel); then
    `WidebandFleet`'s bank (`AnalysisPfb`) over the first n_ref blocks at
    >= FIR_TOL_DB.  Returns (launches, ms/block, Ms/s of wideband
    samples, worst SNR)."""
    B = WB_M * WB_T
    blocks = trace_rx.wideband_capture(n_warm + n_timed, B, dev, seed)
    step_fn, init_carry, bank = wideband_sharded.make_sharded_channelizer(
        WB_M, mesh, device=dev)
    carry = init_carry()
    kept = []

    def step(blk):
        nonlocal carry
        i, q, carry = step_fn(carry, *blk)
        if len(kept) < n_ref:
            kept.append(torch.complex(i, q))
        return i, q

    launches, ms_block, (i, q) = timed_run(step, blocks, "sharded_wideband",
                                           (), n_warm, n_timed)
    check(tuple(i.shape) == (WB_M, WB_T) and bool(torch.isfinite(i).all()),
          f"sharded_wideband output {tuple(i.shape)}")
    ref = chz.AnalysisPfb(WB_M, device=dev)         # WidebandFleet's bank
    state, worst = ref.init_state(), math.inf
    for k in range(n_ref):
        y, state = ref(state, torch.complex(*blocks[k]))
        v = snr_db(y, kept[k])
        worst = min(worst, v)
        print(f"  sharded_wideband vs WidebandFleet's bank, block {k}: SNR "
              f"{v:.1f} dB")
    check(worst >= FIR_TOL_DB,
          f"sharded_wideband vs the bank: {worst:.1f} dB < {FIR_TOL_DB}")
    return launches, ms_block, B / (ms_block * 1e-3) / 1e6, worst


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
    P["tx_fm"] = tx.make_params(TX_FM, dev)
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
                  phase_sam_sideband, phase_fir_cx, phase_fm_disc, phase_agc_scan,
                  phase_front_pair, phase_fir_real, phase_alc,
                  phase_blocked, phase_biquad_grouped, phase_front_mt,
                  phase_agc_rows, phase_agc_scan_rows, phase_agc_stereo,
                  phase_agc_stereo_rows, phase_iqcorr, phase_lms,
                  phase_blanker, phase_nr, phase_lattice, phase_fm_mod,
                  phase_scope, phase_cw, phase_psk, phase_rtty):
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
        keep = {} if label == "ssb_scipy" else None
        try:
            launches, ms_block, msps, worst, n_blocks = main_path(
                cfg, label, expect, dev, args.seed, n_timed, C, keep=keep)
        finally:
            for k in env:
                os.environ.pop(k)
        if keep:
            print(f"phase output stage on {label}'s last block:")
            output_stage(keep.pop("audio"))
        by_path[label] = launches
        per_block[label] = {k: n / n_blocks for k, n in launches.items()}
        if label == "ssb":
            ssb_ms = ms_block
        torch.cuda.empty_cache()
        print(f"main path {label}: mode {cfg.mode}, bw {cfg.bw_key}, "
              f"sam_sideband {cfg.sam_sideband}, translate "
              f"{cfg.translate_hz:.0f} Hz, sql {cfg.sql_threshold}, subtone "
              f"{cfg.subtone_hz} Hz, {C} ch x "
              f"{cfg.block_len} int16 @ {cfg.iq_rate / 1e3:.0f} kHz: "
              f"{ms_block:.3f} ms/block over {n_timed} blocks, {msps:.1f} "
              f"Ms/s, CPU-chain SNR {worst:.1f} dB "
              f"({time.time() - t1:.1f} s) on {card}"
              + (f"; earlier: {EARLIER_MS[label]}" if label in EARLIER_MS
                 else ""))
    t1 = time.time()
    print("phase decode path:")
    launches, ms_block, msps, n_timed, n_blocks = decode_path(dev, args.seed)
    by_path["decode"] = launches
    per_block["decode"] = {k: n / n_blocks for k, n in launches.items()}
    torch.cuda.empty_cache()
    dec_ms = {r["name"]: r["ms"] for r in rows
              if r["name"] in ("cw", "psk", "rtty")}
    print(f"decode path: {CHANNELS} ch x {CFG.block_len} int16 @ "
          f"{CFG.iq_rate / 1e3:.0f} kHz, the scope (magnify 0) and CW, "
          f"PSK63 and RTTY on the 12 kHz tap: {ms_block:.3f} ms/block over "
          f"{n_timed} blocks, {msps:.1f} Ms/s, beside SSB's {ssb_ms:.3f} "
          f"ms/block; the decoder kernels alone: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in dec_ms.items())
          + f" ({time.time() - t1:.1f} s) on {card}")
    for label, run in (
            ("freedv", lambda: freedv_fleet_path("freedv1600",
                                                 FREEDV_CHANNELS, dev, card)),
            ("freedv_front", lambda: freedv_front_path(dev, card)),
            ("freedv700d", lambda: freedv_fleet_path(
                "freedv700d", FREEDV_700D_CHANNELS, dev, card)),
            ("freedv_radio", lambda: freedv_radio_path(dev, card)),
            ("freedv_glue", lambda: freedv_glue_path(dev, card))):
        t1 = time.time()
        print(f"phase freedv path {label}:")
        launches, n_blocks = run()
        by_path[label] = launches
        per_block[label] = {k: n / n_blocks for k, n in launches.items()}
        torch.cuda.empty_cache()
        print(f"freedv path {label}: {time.time() - t1:.1f} s")
    for label, launches, n_blocks in cli_paths(args.seed, card):
        by_path[label] = launches
        per_block[label] = {k: n / n_blocks for k, n in launches.items()}
    for label, cfg, expect, n_timed, C in REF_PATHS:
        t1 = time.time()
        print(f"phase refchain_path {label}:")
        launches, ms_block, msps, worst, n_blocks = refchain_path(
            cfg, label, expect, dev, args.seed, n_timed, C)
        by_path[label] = launches
        per_block[label] = {k: n / n_blocks for k, n in launches.items()}
        torch.cuda.empty_cache()
        print(f"refchain path {label}: mode {cfg.mode}, bw {cfg.bw_key}, "
              f"select {cfg.select_id}, translate {cfg.translate_hz:.0f} Hz, "
              f"{C} ch x {cfg.block_len} f32 @ 48 kHz: {ms_block:.3f} "
              f"ms/block over {n_timed} blocks, {msps:.1f} Ms/s, CPU-chain "
              f"SNR {worst:.1f} dB ({time.time() - t1:.1f} s) on {card}")
    for label, cfg, expect, n_timed, C in TX_PATHS:
        t1 = time.time()
        print(f"phase tx_path {label}:")
        launches, ms_block, msps, worst, n_blocks = tx_path(
            cfg, label, expect, dev, args.seed, n_timed, C,
            tol_db=TX_TOL_DB.get(label, CHAIN_TOL_DB))
        by_path[label] = launches
        per_block[label] = {k: n / n_blocks for k, n in launches.items()}
        torch.cuda.empty_cache()
        print(f"tx path {label}: mode {cfg.mode}, front {cfg.front}, "
              f"translate {cfg.translate_hz:.0f} Hz, {C} ch x "
              f"{cfg.block_len} f32 @ {tx.IQ_RATE / 1e3:.0f} kHz: "
              f"{ms_block:.3f} ms/block over {n_timed} blocks, {msps:.1f} "
              f"Ms/s, CPU-chain SNR {worst:.1f} dB "
              f"({time.time() - t1:.1f} s) on {card}")
    bq_ms = {}
    for label, impl in (("biquad_grouped", "grouped"),
                        ("biquad", "sequential")):
        t1 = time.time()
        print(f"phase entry path {label}:")
        launches, ms_block, worst, n_blocks = biquad_path(P, dev, args.seed,
                                                          impl)
        bq_ms[label] = ms_block
        by_path[label] = launches
        per_block[label] = {k: n / n_blocks for k, n in launches.items()}
        torch.cuda.empty_cache()
        print(f"entry path {label}: {2 * CHANNELS} ch x "
              f"{SAM.block_len // SAM.decim} f32, both allpass sets: "
              f"{ms_block:.3f} ms/block over 4 blocks, SNR against "
              f"{'K11' if impl == 'grouped' else 'K14'} {worst:.1f} dB "
              f"({time.time() - t1:.1f} s) on {card}")
    print(f"entry paths: biquad_grouped (K14) {bq_ms['biquad_grouped']:.3f} "
          f"ms/block beside biquad (K11) {bq_ms['biquad']:.3f} ms/block on "
          f"{card}")
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
    for label, rows_on in (("agc_machine", False),
                           ("agc_machine_rows", True)):
        t1 = time.time()
        print(f"phase entry path {label}:")
        launches, ms_block, msps, worst = agc_machine_path(dev, args.seed,
                                                           rows_on)
        by_path[label] = launches
        per_block[label] = {k: n / 6 for k, n in launches.items()}
        torch.cuda.empty_cache()
        print(f"entry path {label}: K13 on {CHANNELS} ch x {STEREO_ROWS_T} "
              f"steps @ 12 kHz{', thresholds 40-80 dB' if rows_on else ''}: "
              f"{ms_block:.3f} ms/block over 4 blocks, {msps:.1f} Ms/s, CPU "
              f"SNR {worst:.1f} dB ({time.time() - t1:.1f} s) on {card}")
    # the sharded paths: a process group of one rank (NCCL), a 1 x 1 mesh
    with tempfile.TemporaryDirectory() as td:
        multihost.initialize("file://" + os.path.join(td, "rendezvous"), 1,
                             0, dev)
        try:
            mesh = mesh_mod.make_mesh(1, 1)
            t1 = time.time()
            print("phase sharded path sharded_rx:")
            launches, ms_block, msps, worst = sharded_rx_path(mesh, dev,
                                                              args.seed)
            by_path["sharded_rx"] = launches
            per_block["sharded_rx"] = {k: n / 10 for k, n in
                                       launches.items()}
            torch.cuda.empty_cache()
            print(f"sharded path sharded_rx: rx.FLAGSHIP on a 1 x 1 mesh, "
                  f"{CHANNELS} ch x {CFG.block_len} f32 @ "
                  f"{CFG.iq_rate / 1e3:.0f} kHz: {ms_block:.3f} ms/block "
                  f"over 8 blocks beside ssb's {ssb_ms:.3f} (fused K1), "
                  f"{msps:.1f} Ms/s, RxChain SNR {worst:.1f} dB "
                  f"({time.time() - t1:.1f} s) on {card}")
            t1 = time.time()
            print("phase sharded path sharded_rx_sp4:")
            launches, s_zf, s_seam, s_a = sharded_rx_sp4_path(mesh, dev,
                                                              args.seed)
            by_path["sharded_rx_sp4"] = launches
            per_block["sharded_rx_sp4"] = {k: n / 3 for k, n in
                                           launches.items()}
            torch.cuda.empty_cache()
            print(f"sharded path sharded_rx_sp4: {DEPTH} ch, {SHARDED_SP} "
                  f"time shards a block: front {s_zf:.1f} dB, seams "
                  f"{s_seam:.1f} dB, audio {s_a:.1f} dB against the 1 x 1 "
                  f"step ({time.time() - t1:.1f} s) on {card}")
            t1 = time.time()
            print("phase sharded path sharded_tx:")
            launches = sharded_tx_path(mesh, dev, args.seed)
            by_path["sharded_tx"] = launches
            per_block["sharded_tx"] = launches
            print(f"sharded path sharded_tx: tx.TX_FLAGSHIP on a 1 x 1 mesh, "
                  f"{DEPTH} ch x {TXF.block_len} f32, one block untimed, "
                  f"TxChain bit for bit ({time.time() - t1:.1f} s) on "
                  f"{card}")
            t1 = time.time()
            print("phase sharded path sharded_wideband:")
            launches, ms_block, msps, worst = sharded_wideband_path(
                mesh, dev, args.seed)
            by_path["sharded_wideband"] = launches
            per_block["sharded_wideband"] = {
                k: n / (2 + WIDEBAND_TIMED) for k, n in launches.items()}
            torch.cuda.empty_cache()
            print(f"sharded path sharded_wideband: {WB_M} ch x {WB_T} from "
                  f"{WB_M * WB_T} wideband samples on a 1 x 1 mesh: "
                  f"{ms_block:.3f} ms/block over {WIDEBAND_TIMED} blocks, "
                  f"{msps:.1f} Ms/s (wideband), bank SNR {worst:.1f} dB "
                  f"({time.time() - t1:.1f} s) on {card}")
        finally:
            torch.distributed.destroy_process_group()
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
