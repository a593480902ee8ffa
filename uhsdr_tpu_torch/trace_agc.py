"""Where the AGC kernels' time goes on the card, phase by phase, and an
earlier agc.cu beside them.

    python -m uhsdr_tpu_torch.trace_agc [--seed 7] [--baseline FILE]

Builds `kernels/agc.cu` as it is and variants of it (trace_front's
`build_variants`), each with one phase left out: K3's load (the front
warp's x tiles from device memory; the linked stage's too, one
`load_tile`), its look-ahead max (the front warp's sliding max and stage
writes, the stage's too), its walk and its gain law; K13's load (the
front warp's copies of rm and ax), the walk K13 and the stage share, and
K13's volts stores; the stage's gain law.  A variant still passes every
tile between the warps, so it runs to its end; its outputs are wrong: it
only times.  A further variant leaves K3 all but its walk.  Each shape
is timed through CUDA graphs (trace_blocked's `graph_ms`: device time,
no host time between launches) with the whole library and its relevant
variants in turns (whole, variants, variants reversed, whole):

- K3 at the shapes the port sends it: the SSB flagship (8192 ch x 2048
  steps, w 48), AM/SAM and wide SSB (8192 x 4096, w 96), FM (8192 x
  8192, w 192), the fleet's merged five 12 kHz groups (5120 x 4096, w
  48, per-channel rows), the fleet's FM group (1024 x 16384, w 192);
- K13 at the two-channel flagship's machine (8192 x 2048), scalar and
  with rows;
- the linked stereo stage at the two-channel flagship (8192 x 2 x 2048,
  w 48), with rows, and at SAM stereo's (1024 x 2 x 4096, w 96), beside
  the torch route it replaced around the new K13.

With --baseline FILE, an earlier agc.cu (its C interface K3's and K13's
as now, e.g. `git show b54d623:uhsdr_tpu_torch/kernels/agc.cu >
_commit_check/agc_parent.cu`) is built beside and timed in the same
turns: its K3 at K3's shapes, its K13 at K13's, and at the stage's
shapes the route the stage replaced around it (`replaced_route`).
Prints each time beside the bound (the larger of the bytes at the card's
HBM rate and the recurrence: T steps x `AGC_STEP_OPS` dependent FP32
operations x 4 cycles at the card's maximum SM clock), then one JSON
line.  Exits 2 where CUDA is absent.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import sys

import numpy as np
import torch

from .cuda import agc as agc_k
from .ops import agc as agc_ops
from .trace_alc_interp import build_baseline, smi
from .trace_blocked import graph_ms
from .trace_front import build_variants

PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
FP32_LATENCY = 4            # cycles of a dependent FP32 operation
# the machine's loop-carried chain a step, volts to the next volts
# (kernels/agc.cu::machine_step): the compare, the fast predicate, two
# selects of the multiplier, the update multiply and add, the min-volts
# max
AGC_STEP_OPS = 7
AGC_STEP_OPS_BLENDED = 18   # the blended step's (pallas/agc.py:84-118)


# each phase in agc.cu: its text and a replacement that leaves it out
PHASES = {
    "load": (("for (int c = 0; c < nc; ++c) {  // load",
              "for (int c = 0; c < 0; ++c) {  // load"),),
    "max": (("    front_tile<NP>(rrow, pl, hrow, w, g.ring, cnt, f, out);\n",
             "    (void)out;\n"),),
    "walk": (("for (int i = 0; i < cnt; ++i) {  // walk",
              "for (int i = 0; i < 0; ++i) {  // walk"),),
    "gain": (("for (int k = 0; k < GAIN_CH; ++k) {  // gain law\n",
              "for (int k = 0; k < 0; ++k) {  // gain law\n"),
             ("for (int k = 0; k < GAIN_CH; ++k) {  // gain law stores",
              "for (int k = 0; k < 0; ++k) {  // gain law stores")),
    "k13_load": (("        cp_async4(st + c * SS, rm + o);  // K13 load\n"
                  "        cp_async4(st + (CB + c) * SS, ax + o);\n", ""),),
    "plane_walk": (("for (int i = 0; i < cnt; ++i) {  // plane walk",
                    "for (int i = 0; i < 0; ++i) {  // plane walk"),),
    "k13_store": (("for (int k = 0; k < GAIN_CH; ++k) {  // volts stores",
                   "for (int k = 0; k < 0; ++k) {  // volts stores"),),
    "stage_gain": (
        ("for (int k = 0; k < GAIN_CH; ++k) {  // stage gain law\n",
         "for (int k = 0; k < 0; ++k) {  // stage gain law\n"),
        ("for (int k = 0; k < GAIN_CH; ++k) {  // stage gain law stores",
         "for (int k = 0; k < 0; ++k) {  // stage gain law stores")),
}
VARIANTS = {**{f"no_{ph}": pairs for ph, pairs in PHASES.items()},
            "walk_alone": PHASES["load"] + PHASES["max"] + PHASES["gain"]}
# the phases each kernel runs
K3_PHASES = ("load", "max", "walk", "gain")
K13_PHASES = ("k13_load", "plane_walk", "k13_store")
STAGE_PHASES = ("load", "max", "plane_walk", "stage_gain")
# (label, channels, steps, sample rate (sets w), per-channel rows)
K3_SHAPES = (("ssb_w48", 8192, 2048, 12000.0, False),
             ("am_w96", 8192, 4096, 24000.0, False),
             ("fm_w192", 8192, 8192, 48000.0, False),
             ("fleet_rows_w48", 5120, 4096, 12000.0, True),
             ("fleet_fm_w192", 1024, 16384, 48000.0, False))
K13_SHAPES = (("k13", 8192, 2048, 12000.0, False),
              ("k13_rows", 8192, 2048, 12000.0, True))
STAGE_SHAPES = (("stage_w48", 8192, 2048, 12000.0, False),
                ("stage_rows_w48", 8192, 2048, 12000.0, True),
                ("sam_stereo_w96", 1024, 4096, 24000.0, False))


def recurrence_ms(steps: int, ops: int, clock_hz: float) -> float:
    return steps * ops * FP32_LATENCY / clock_hz * 1e3


def replaced_route(p, carry, delay, x, rows=None, scan_rows=None):
    """The torch route `ops/agc.py::run_stereo` ran before the linked
    stage, around K13 on the card: the concatenation, the linked detector
    abs().amax(), its look-ahead max (unfold().amax()), two contiguous
    copies, K13, the gain law and the product."""
    T, w = x.shape[-1], delay.shape[-1]
    xfull = torch.cat([delay, x], dim=-1)
    a = xfull.abs().amax(dim=-2)
    v, c = agc_k.agc_scan(p, carry,
                          agc_k.look_ahead_max(a, w, T).contiguous(),
                          a[:, :T].contiguous(), scan_rows)
    g = agc_k.gain_law(p, v, None if rows is None else rows[1])
    return xfull[..., :T] * g[:, None, :], c, xfull[..., xfull.shape[-1] - w:]


def _signal(C: int, T: int, fs: float, dev, gen, planes: int = 1):
    """Tone bursts at -80..0 dBFS across the channels over noise: (C, T),
    or (C, 2, T) with the second plane at half the level."""
    n = torch.arange(T, device=dev, dtype=torch.float32)
    level = torch.logspace(-4, 0, C, device=dev)[:, None]
    x = (level * torch.sin(2 * math.pi * 700.0 / fs * n)[None, :]
         * (n < T // 2).to(torch.float32)
         + torch.randn((C, T), generator=gen, device=dev) * 1e-5)
    return x if planes == 1 else torch.stack([x, 0.5 * x], dim=1)


def _setup(C: int, fs: float, rows: bool, dev):
    th = np.linspace(40.0, 80.0, C) if rows else 60.0
    params = agc_ops.make_params(fs, thresh_db=th)
    kp = agc_ops.kernel_params(params, C)

    def on(a):
        return None if a is None else torch.as_tensor(a, device=dev)
    return kp.scalars, on(kp.rows), on(kp.scan_rows), params.attack_buffsize


def turns(entries: list) -> dict:
    """{name: [ms, ms]}: each (name, library, fn) timed through a graph
    with `library` in K3's place, in turns: the list, then reversed."""
    whole = agc_k.AGC.lib()
    ms = {name: [] for name, _, _ in entries}
    try:
        for name, lib, fn in entries + entries[::-1]:
            agc_k.AGC._lib = lib
            ms[name].append(graph_ms(fn, 10))
    finally:
        agc_k.AGC._lib = whole
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--baseline", type=pathlib.Path, default=None)
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
    base = None
    if args.baseline is not None:
        base = build_baseline(args.baseline, agc_k.AGC)
        for fn in ("uhsdr_agc_launch", "uhsdr_agc_scan_launch"):
            getattr(base, fn).argtypes, getattr(base, fn).restype = \
                agc_k.AGC.signatures[fn]
        base.uhsdr_error_string.argtypes = [ctypes.c_int]
        base.uhsdr_error_string.restype = ctypes.c_char_p
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    result = {}

    def report(label, C, T, w, rows, ms, phases, nbytes, extra=""):
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        b_ms = nbytes / PEAK_BYTES_S * 1e3
        r_ms = recurrence_ms(T, AGC_STEP_OPS, clock)
        cost = {ph: mean["whole"] - mean[f"no_{ph}"] for ph in phases}
        others = {k: v for k, v in mean.items()
                  if k != "whole" and not k.startswith("no_")}
        print(f"{label}: {C} x {T}, w {w}{' rows' if rows else ''}: whole "
              f"{mean['whole']:.4f} ms "
              f"({', '.join(f'{v:.4f}' for v in ms['whole'])}), bound "
              f"{max(b_ms, r_ms):.4f} (bytes {b_ms:.4f}, recurrence "
              f"{r_ms:.4f} at {AGC_STEP_OPS} ops); left out: "
              + ", ".join(f"{ph} {mean[f'no_{ph}']:.4f} (costs "
                          f"{cost[ph]:.4f})" for ph in phases)
              + "".join(f"; {k} {v:.4f} "
                        f"({', '.join(f'{x:.4f}' for x in ms[k])})"
                        for k, v in others.items()) + extra)
        result[label] = dict(channels=C, steps=T, w=w, rows=rows,
                             whole_ms=mean["whole"],
                             bound_ms=max(b_ms, r_ms), bytes_ms=b_ms,
                             recurrence_ms=r_ms,
                             recurrence_18_ms=recurrence_ms(
                                 T, AGC_STEP_OPS_BLENDED, clock),
                             without_ms={ph: mean[f"no_{ph}"]
                                         for ph in phases},
                             phase_cost_ms=cost, others_ms=others)

    for label, C, T, fs, rows in K3_SHAPES:
        p, r3, _, w = _setup(C, fs, rows, dev)
        x = _signal(C, T, fs, dev, gen)
        carry = torch.zeros((agc_k.N_CARRY, C), device=dev)
        delay = torch.zeros((C, w), device=dev)

        def k3():
            return agc_k.agc(p, carry, delay, x, r3)
        entries = [("whole", libs["whole"], k3)] + [
            (f"no_{ph}", libs[f"no_{ph}"], k3) for ph in K3_PHASES] + [
            ("walk_alone", libs["walk_alone"], k3)]
        if base is not None:
            entries.append(("baseline", base, k3))
        nbytes = (2 * C * T + 2 * (agc_k.N_CARRY * C + C * w)
                  + (0 if r3 is None else r3.numel())) * 4
        report(label, C, T, w, rows, turns(entries), K3_PHASES, nbytes)

    for label, C, T, fs, rows in K13_SHAPES:
        p, _, r2, w = _setup(C, fs, rows, dev)
        a = _signal(C, T + w, fs, dev, gen, 2).abs().amax(dim=1)
        rm = agc_k.look_ahead_max(a, w, T).contiguous()
        ax = a[:, :T].contiguous()
        carry = torch.zeros((agc_k.N_CARRY, C), device=dev)

        def k13():
            return agc_k.agc_scan(p, carry, rm, ax, r2)
        entries = [("whole", libs["whole"], k13)] + [
            (f"no_{ph}", libs[f"no_{ph}"], k13) for ph in K13_PHASES]
        if base is not None:
            entries.append(("baseline", base, k13))
        nbytes = (3 * C * T + 2 * agc_k.N_CARRY * C
                  + (0 if r2 is None else r2.numel())) * 4
        report(label, C, T, w, rows, turns(entries), K13_PHASES, nbytes)

    for label, C, T, fs, rows in STAGE_SHAPES:
        p, r3, r2, w = _setup(C, fs, rows, dev)
        x = _signal(C, T, fs, dev, gen, 2)
        carry = torch.zeros((agc_k.N_CARRY, C), device=dev)
        delay = torch.zeros((C, 2, w), device=dev)

        def stage():
            return agc_k.agc_stereo(p, carry, delay, x, r3)

        def route():
            return replaced_route(p, carry, delay, x, r3, r2)
        entries = [("whole", libs["whole"], stage)] + [
            (f"no_{ph}", libs[f"no_{ph}"], stage) for ph in STAGE_PHASES] + [
            ("route", libs["whole"], route)]
        if base is not None:
            entries.append(("baseline_route", base, route))
        nbytes = (2 * C * 2 * T + 2 * C * 2 * w + 2 * agc_k.N_CARRY * C
                  + (0 if r3 is None else r3.numel())) * 4
        geo = agc_k.agc_stereo_geometry(C, T, w, rows)
        report(label, C, T, w, rows, turns(entries), STAGE_PHASES, nbytes,
               f"; {geo.smem} B shared, {geo.sm_blocks} blocks an SM")
    print(json.dumps({"card": card, "phases": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
