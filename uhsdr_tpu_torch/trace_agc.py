"""Where K3's time goes on the card, phase by phase.

    python -m uhsdr_tpu_torch.trace_agc [--seed 7]

Builds `kernels/agc.cu` as it is and five variants of it (trace_front's
`build_variants`), four each with one phase of K3's tile loop left out: the
load (the front warp's x tiles from device memory), the look-ahead max
(the front warp's sliding max and its stage writes), the walk (the
walker warp's machine steps) and the gain law (the gain-law warps' log,
division and stores).  Every stage still passes between the warps, so a
variant runs to its end; its outputs are wrong: it only times.  A fifth
variant leaves out all but the walk: the walker warp's own pace.  Times
the six through `cuda.agc.agc`, each library in turn in the kernel's
place, on the same inputs (CUDA events, 10 launches after one, whole,
variants, variants reversed, whole) at the shapes the port sends K3: the
SSB flagship (8192 ch x 2048 steps, w 48), AM/SAM and wide SSB (8192 x
4096, w 96), FM (8192 x 8192, w 192), the fleet's merged five 12 kHz
groups (5120 x 4096, w 48, per-channel rows) and the fleet's FM group
(1024 x 16384, w 192).  Prints, per shape, each variant's ms, what the
left-out phase costs while the others still run (the whole kernel's time
less the variant's) and the walk alone, beside the bound: the larger of
the bytes (x in, y out, carries, delay line and rows) at the card's HBM
rate and the
recurrence (T steps x `AGC_STEP_OPS` dependent FP32 operations x 4
cycles at the card's maximum SM clock), the old 18-operation recurrence
beside; then one JSON line.  Exits 2 where CUDA is absent.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

import numpy as np
import torch

from .cuda import agc as agc_k
from .ops import agc as agc_ops
from .trace_front import build_variants, cuda_ms

PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
FP32_LATENCY = 4            # cycles of a dependent FP32 operation
# K3's loop-carried chain a step, volts to the next volts (kernels/agc.cu::
# machine_step): the compare, the fast predicate, two selects of the
# multiplier, the update multiply and add, the min-volts max
AGC_STEP_OPS = 7
AGC_STEP_OPS_BLENDED = 18   # the blended step's (pallas/agc.py:84-118)
# each phase in agc.cu: its loop headers and the same loops run 0 times,
# or its call and none
PHASES = {
    "load": (("for (int c = 0; c < nc; ++c) {  // load",
              "for (int c = 0; c < 0; ++c) {  // load"),),
    "max": (("    front_tile(rrow, hrow, w, g.ring, cnt, f, st);\n",
             "    (void)st;\n"),),
    "walk": (("for (int i = 0; i < cnt; ++i) {  // walk",
              "for (int i = 0; i < 0; ++i) {  // walk"),),
    "gain": (("for (int k = 0; k < GAIN_CH; ++k) {  // gain law\n",
              "for (int k = 0; k < 0; ++k) {  // gain law\n"),
             ("for (int k = 0; k < GAIN_CH; ++k) {  // gain law stores",
              "for (int k = 0; k < 0; ++k) {  // gain law stores")),
}
# the builds: each phase left out, and the walk alone (load, max and gain
# law left out)
VARIANTS = {**{f"no_{ph}": pairs for ph, pairs in PHASES.items()},
            "walk_alone": PHASES["load"] + PHASES["max"] + PHASES["gain"]}
# (label, channels, steps, sample rate (sets w), per-channel rows)
SHAPES = (("ssb_w48", 8192, 2048, 12000.0, False),
          ("am_w96", 8192, 4096, 24000.0, False),
          ("fm_w192", 8192, 8192, 48000.0, False),
          ("fleet_rows_w48", 5120, 4096, 12000.0, True),
          ("fleet_fm_w192", 1024, 16384, 48000.0, False))
# the fleet's five 12 kHz groups' thresholds (parallel/fleet.py FLEET_MIX)
FLEET_THRESH_DB = (60.0, 50.0, 70.0, 60.0, 55.0)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0].strip()


def recurrence_ms(steps: int, ops: int, clock_hz: float) -> float:
    return steps * ops * FP32_LATENCY / clock_hz * 1e3


def shape_inputs(C: int, T: int, fs: float, rows: bool, dev, gen):
    """(the launch's callable, its bytes, w) at one shape: tone bursts at
    -80..0 dBFS across the channels over noise, from zero carries."""
    th = (np.repeat(FLEET_THRESH_DB, C // len(FLEET_THRESH_DB)) if rows
          else 60.0)
    kp = agc_ops.kernel_params(agc_ops.make_params(fs, thresh_db=th), C)
    r = None if kp.rows is None else torch.as_tensor(kp.rows, device=dev)
    w = agc_ops.make_params(fs).attack_buffsize
    n = torch.arange(T, device=dev, dtype=torch.float32)
    level = torch.logspace(-4, 0, C, device=dev)[:, None]
    x = (level * torch.sin(2 * math.pi * 700.0 / fs * n)[None, :]
         * (n < T // 2).to(torch.float32)
         + torch.randn((C, T), generator=gen, device=dev) * 1e-5)
    carry = torch.zeros((agc_k.N_CARRY, C), device=dev)
    delay = torch.zeros((C, w), device=dev)
    nbytes = (2 * C * T + 2 * (agc_k.N_CARRY * C + C * w)
              + (0 if r is None else r.numel())) * 4
    return (lambda: agc_k.agc(kp.scalars, carry, delay, x, r)), nbytes, w


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_agc: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    mhz, unit = smi("clocks.max.sm").split()
    if unit != "MHz":
        raise RuntimeError(f"clocks.max.sm in {unit}")
    clock = float(mhz) * 1e6
    print(f"card: {card}, max SM clock {mhz} MHz")
    libs = build_variants(agc_k.AGC, VARIANTS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    names = ["whole", *VARIANTS]
    result = {}
    for label, C, T, fs, rows in SHAPES:
        launch, nbytes, w = shape_inputs(C, T, fs, rows, dev, gen)
        ms = {name: [] for name in names}
        try:
            for name in names + names[::-1]:
                # cuda.agc.agc launches through the library it finds here
                agc_k.AGC._lib = libs[name]
                ms[name].append(cuda_ms(launch))
        finally:
            agc_k.AGC._lib = libs["whole"]
        mean = {name: sum(v) / len(v) for name, v in ms.items()}
        b_ms = nbytes / PEAK_BYTES_S * 1e3
        r_ms = recurrence_ms(T, AGC_STEP_OPS, clock)
        r18 = recurrence_ms(T, AGC_STEP_OPS_BLENDED, clock)
        bound = max(b_ms, r_ms)
        cost = {ph: mean["whole"] - mean[f"no_{ph}"] for ph in PHASES}
        print(f"{label}: {C} x {T}, w {w}{' rows' if rows else ''}: whole "
              f"{mean['whole']:.4f} ms "
              f"({', '.join(f'{v:.4f}' for v in ms['whole'])}), bound "
              f"{bound:.4f} (bytes {b_ms:.4f}, recurrence {r_ms:.4f} at "
              f"{AGC_STEP_OPS} ops; {r18:.4f} at {AGC_STEP_OPS_BLENDED}); "
              "left out: "
              + ", ".join(f"{ph} {mean[f'no_{ph}']:.4f} "
                          f"(costs {cost[ph]:.4f})" for ph in PHASES)
              + f"; the walk alone {mean['walk_alone']:.4f}")
        result[label] = dict(channels=C, steps=T, w=w, rows=rows,
                             whole_ms=mean["whole"], bound_ms=bound,
                             bytes_ms=b_ms, recurrence_ms=r_ms,
                             recurrence_18_ms=r18,
                             without_ms={ph: mean[f"no_{ph}"]
                                         for ph in PHASES},
                             walk_alone_ms=mean["walk_alone"],
                             phase_cost_ms=cost)
    print(json.dumps({"card": card, "phases": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
