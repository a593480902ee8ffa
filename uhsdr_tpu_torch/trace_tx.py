"""Where the time of the port's TX path goes on the card.

    python -m uhsdr_tpu_torch.trace_tx [--mode usb|lsb|am|cw|wideband]
                                       [--front ref|scipy] [--seed 7]

Drives `chain.tx.TxChain` on cuda:0 at the TX flagship (usb, reference
front, 6 kHz translate, 8192 channels of f32 audio @ 48 kHz in
16384-sample blocks; the configuration bench_tx.py times) or another
mode or front at the same width (``--mode wideband``: the wideband TX
fleet, `parallel.fleet.WidebandTxFleet` at WIDEBAND_TX, 4096 channels of
4096 samples into one synthesis bank), for 2 warm-up, 4 untraced and 4 traced
blocks, and prints per block the device time with tracing off (CUDA
events), the host's enqueue time (wall clock of the calls, no sync), and
under `torch.profiler` the device time of every kernel by name and the
device's busy share of the traced window, as `trace_rx.py` does for RX.

Inputs are seeded voice-band tones made on the card (`capture`, which
chip_smoke.py drives the TX paths with too).  Exits 2 where CUDA is
absent.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys

import torch

from .chain import tx
from .parallel import fleet
from .trace_rx import BLOCKS, profile_blocks

TONE_HZ = 700.0      # channel 0's audio tone
CW_SIDETONE_LEVEL = 0.5


def config(mode: str = "usb", front: str = "ref") -> tx.TxConfig:
    return dataclasses.replace(tx.TX_FLAGSHIP, mode=mode, front=front)


def expected_peak_hz(cfg: tx.TxConfig) -> float:
    """Where channel 0's IQ spectrum peaks: the tone above (usb) or below
    (lsb) the translate frequency, the AM carrier at it, the CW carrier
    at translate + sidetone."""
    if cfg.mode == "usb":
        return cfg.translate_hz + TONE_HZ
    if cfg.mode == "lsb":
        return cfg.translate_hz - TONE_HZ
    if cfg.mode == "am":
        return cfg.translate_hz
    return cfg.translate_hz + cfg.cw_sidetone_hz


def capture(n_blocks: int, C: int, dev, seed: int, cfg: tx.TxConfig):
    """Seeded f32 audio blocks (C, cfg.block_len) made on `dev`: channel c
    carries a (TONE_HZ + 10·(c mod 200)) Hz tone at -30 ... 0 dBFS of the
    unit audio domain (channel 0 at -6 dBFS), plus noise 60 dB below full
    scale; for CW a keying envelope in [0, 1], on for the first 70% of
    each 20 ms."""
    B = cfg.block_len
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    c = torch.arange(C, device=dev, dtype=torch.float64)
    f = TONE_HZ + 10.0 * (c % 200)
    amp = 10.0 ** (-1.5 + 1.5 * (c % 64) / 63.0)
    amp[0] = 0.5
    out = []
    for k in range(n_blocks):
        n = torch.arange(k * B, (k + 1) * B, device=dev, dtype=torch.float64)
        if cfg.mode == "cw":
            on = (torch.remainder(n, 960.0) < 672.0).to(torch.float64)
            out.append((on * CW_SIDETONE_LEVEL)[None, :].expand(C, B)
                       .to(torch.float32).contiguous())
            continue
        ph = torch.remainder(f[:, None] * n / tx.IQ_RATE, 1.0) * (2 * math.pi)
        x = amp[:, None] * torch.sin(ph) + 1e-3 * torch.randn(
            (C, B), generator=gen, device=dev, dtype=torch.float64)
        out.append(x.to(torch.float32))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--mode", choices=("usb", "lsb", "am", "fm", "cw",
                                       "wideband"), default="usb")
    ap.add_argument("--front", choices=("ref", "scipy"), default="ref")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_tx: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.mode == "wideband":
        cfg, M = fleet.WIDEBAND_TX, fleet.WIDEBAND_CHANNELS
        wf = fleet.WidebandTxFleet([cfg], [M], device=dev)
        print(f"config: wideband TX, {M} channels of TX {cfg.mode} x "
              f"{cfg.block_len} -> {M * cfg.block_len} wideband samples")
        return profile_blocks(
            lambda s, audio: wf.process_block_device([audio]), None,
            capture(2 + 2 * BLOCKS, M, dev, args.seed, cfg),
            M * cfg.block_len)
    cfg = config(args.mode, args.front)
    C, B = tx.TX_FLAGSHIP_CHANNELS, cfg.block_len
    print(f"config: TX mode {cfg.mode}, front {cfg.front}, {C} ch x {B} "
          f"@ {tx.IQ_RATE:.0f} Hz")
    chain = tx.TxChain(cfg, device=dev)
    state = chain.init_state((C,))

    def step(state, audio):
        _, _, state = chain(state, audio)
        return state

    return profile_blocks(step, state,
                          capture(2 + 2 * BLOCKS, C, dev, args.seed, cfg),
                          C * B)


if __name__ == "__main__":
    sys.exit(main())
