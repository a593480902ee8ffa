"""Where the fused ALC's and K4's time goes on the card, phase by phase.

    python -m uhsdr_tpu_torch.trace_alc_interp [--seed 7]
        [--only alc|interp] [--baseline FILE [FILE ...]]

Builds `kernels/alc.cu` and `kernels/interp.cu` as they are and variants
of each (trace_front's `build_variants`) with one phase left out, and
times them through the wrappers (`cuda.alc.alc_run`,
`cuda.fir.interpolate`), each library in turn in the kernel's place, on
the same inputs (device time: CUDA events around a CUDA graph of 20
launches, after one; whole, variants, variants reversed, whole).

The ALC, at the TX flagship (8192 x 16384, D = 288), the 1024-channel TX
paths (D = 288; the legacy front's D = 64) and `wideband_tx`'s 4096 x
4096: left out in turn are the stores of y (a test the outputs never
pass keeps them computed), the copies of the delayed plane, and the
output warps' whole row loop; other designs: five stages, 64-step
tiles, no loads of x past the first tiles (the walk without the memory's
latency), and no second walk on div.rn (the cost of the fast division's
range test and its fallback).  Printed: the walker's cycles a step (the
whole's time at the card's maximum SM clock over T) beside the chain's
hand count, and the bound (the larger of the recurrence and the bytes).

K4 at x8 (8192 x 2048, 93 taps), x4 (8192 x 4096), ssbstereo's 16384
rows x8, the fleet's 5120-row launch (x4, 16 taps), 48 kHz x2 (8192 x
8192) and 192 kHz x16 (8192 x 1024, 187 taps): left out in turn are the
staging of the input tile (the tile keeps what it held), all but one
tap of the FMA loop, and the stores of y; one other design takes 8
samples a thread at x8 and x16.  Printed: each share of the byte bound,
and from `cuobjdump -sass` of the library each fixed instance's FFMA and
shared loads (a thread's window: (H + R) / 4 LDS.128 a thread).

With --baseline, each file is an earlier source built beside the new
one and timed at every shape in the same turns, before and after the
kernel: a file named alc*.cu is PR 13's gains-only ALC (its C interface
`uhsdr_alc_launch`), timed alone on the scaled audio and as that PR's
whole stage (the post-filter gain, the kernel, the gain scaling, the
concatenation with the delay line and the delayed product, as
`mod/alc.py::run` ran them); a file named interp*.cu is PR 13's K4 (the
same C interface, the taps on the card).  Then one JSON line.  The
variants' outputs are wrong: they only time.  Exits 2 where CUDA is
absent.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

from .chain import rx, tx
from .cuda import alc as alc_k
from .cuda import build
from .cuda import fir as fir_k
from .mod import alc as alc_mod
from .trace_blocked import graph_ms
from .trace_front import build_variants

PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
# the ALC step's loop-carried chain in SASS (as chip_smoke.py's)
ALC_STEP_OPS = alc_k.ALC_STEP_CHAIN
FP32_LATENCY = 4

ALC_PHASES = {
    "store": (("        yt[(size_t)k * p.T] = d * (g[k * SS] * p.gs);\n",
               "        if (d == 1e30f) yt[(size_t)k * p.T] = "
               "d * (g[k * SS] * p.gs);\n"),),
    "delayed": (("    if (m < ntiles)\n      copy_rows(plane(stage, m % "
                 "STAGES, 1, cb)",
                 "    if (m < 0)\n      copy_rows(plane(stage, m % "
                 "STAGES, 1, cb)"),),
    "output": (("      for (int k = 0; k < nr; ++k) {\n"
                "        const float d",
                "      for (int k = 0; k < 0; ++k) {\n        const float d"),),
}
# other designs: five stages, 64-step tiles, no loads of x past the first
# tiles (the walkers run on stale stages, the barriers kept: the walk
# without the memory's latency), no second walk on div.rn
ALC_DESIGNS = {
    "stages5": (("constexpr int STAGES = 4;", "constexpr int STAGES = 5;"),),
    "tile64": (("constexpr int TA = 32;", "constexpr int TA = 64;"),),
    "no_load": (("\n      load_tile(x, p, c0, nc, cb, m, vec, stage, lane);\n",
                 "\n"),),
    "fast_only": (("      v = v0;\n      walk_regs<false>(xp, g, v, decay);\n",
                   ""),),
}
INTERP_PHASES = {
    "load": (("  for (int i4 = threadIdx.x; i4 < (H + tile) / 4; "
              "i4 += THREADS) {",
              "  for (int i4 = threadIdx.x; i4 < 0; i4 += THREADS) {"),),
    "fma": (("      for (int k = 0; k < S; ++k) acc = fmaf(",
             "      for (int k = 0; k < 1; ++k) acc = fmaf("),),
    "store": (("  for (int e4 = lane; e4 < n4; e4 += 32) {",
               "  for (int e4 = lane; e4 < n4 && lane > 32; e4 += 32) {"),
              ("  for (int e = 4 * n4 + lane; e < n; e += 32) yw[e]",
               "  for (int e = 4 * n4 + lane; e < n && lane > 32; e += 32) "
               "yw[e]")),
}
INTERP_DESIGNS = {
    # 8 samples a thread at x8 and x16 (R*L = 64 and 128 outputs)
    "r8": (("  return L >= 8 ? 4 : 32 / L;",
            "  return L >= 8 ? 8 : 32 / L;"),),
}
# (label, C, T, delay, gain_scaling)
ALC_SHAPES = (("tx_flagship", 8192, 16384, 288, 1.0),
              ("tx_1024", 1024, 16384, 288, 1.0),
              ("tx_am_1024", 1024, 16384, 288, 0.23),
              ("tx_legacy_1024", 1024, 16384, 64, 1.0),
              ("wideband_tx", 4096, 4096, 288, 1.0))


def interp_shapes(dev):
    """(label, taps, C, B, L): the chains' K4 launches."""
    ssb = rx.make_params(rx.FLAGSHIP, dev).interp_fir
    sam = rx.make_params(rx.SAM_FLAGSHIP, dev).interp_fir
    f48 = rx.make_params(rx.RxConfig(mode="usb", bw_key="2P3KHZ",
                                     iq_rate=48000.0), dev).interp_fir
    x2 = rx.make_params(rx.RxConfig(mode="am", bw_key="5P0KHZ",
                                    iq_rate=48000.0), dev).interp_fir
    k16 = rx.make_params(rx.RxConfig(mode="usb", bw_key="2P3KHZ",
                                     iq_rate=192000.0), dev).interp_fir
    return (("x8", ssb, 8192, 2048, 8), ("x4", sam, 8192, 4096, 4),
            ("ssbstereo_x8", ssb, 16384, 2048, 8),
            ("fleet_x4", f48, 5120, 4096, 4), ("x2_48k", x2, 8192, 8192, 2),
            ("x16_192k", k16, 8192, 1024, 16))


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def build_baseline(path: pathlib.Path, kernel: build.CudaKernel):
    so = build.BUILD_DIR / "trace_alc_interp" / f"{path.stem}.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    p = subprocess.run([build.nvcc_path(), *kernel.flags, "-o", str(so),
                        str(path)], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{p.stdout}{p.stderr}")
    return ctypes.CDLL(str(so))


def alc_baseline(path: pathlib.Path):
    """PR 13's gains-only ALC: returns (gains(decay, v, xp), stage(params,
    v, delay_buf, x)), the latter PR 13's `mod/alc.py::run`."""
    lib = build_baseline(path, alc_k.ALC)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.uhsdr_alc_launch.argtypes = [P, P, I, I, F, P, P, P]
    lib.uhsdr_alc_launch.restype = I

    def gains(decay, v, xp):
        g, nv = torch.empty_like(xp), torch.empty_like(v)
        C, T = xp.shape
        err = lib.uhsdr_alc_launch(xp.data_ptr(), v.data_ptr(), C, T, decay,
                                   g.data_ptr(), nv.data_ptr(),
                                   build.stream_ptr(xp.device))
        if err:
            raise RuntimeError(f"baseline ALC launch failed: cudaError {err}")
        return g, nv

    def stage(params, v, delay_buf, x):
        xp = x * params.postfilt_gain
        g, nv = gains(params.decay, v, xp.contiguous())
        g = g * params.gain_scaling
        xfull = torch.cat([delay_buf, xp], dim=-1)
        y = xfull[..., :x.shape[-1]] * g
        return y, nv, xfull[..., xfull.shape[-1] - params.delay:]
    return gains, stage


def interp_baseline(path: pathlib.Path):
    """PR 13's K4 (the taps on the card): returns launch(h, carry, x, L)."""
    lib = build_baseline(path, fir_k.INTERP)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.uhsdr_interp_launch.argtypes = [P, P, I, I, P, I, I, P, P, P]
    lib.uhsdr_interp_launch.restype = I

    def launch(h, carry, x, L):
        C, B = x.shape
        y = torch.empty((C, B * L), device=x.device)
        nc = torch.empty_like(carry)
        err = lib.uhsdr_interp_launch(
            x.data_ptr(), carry.data_ptr(), C, B, h.data_ptr(), h.shape[-1],
            L, y.data_ptr(), nc.data_ptr(), build.stream_ptr(x.device))
        if err:
            raise RuntimeError(f"baseline K4 launch failed: cudaError {err}")
        return y, nc
    return launch


def turns(libs: dict, kernel: build.CudaKernel, fn, extra: dict) -> dict:
    """Device ms of fn() with each library in the kernel's place (whole,
    variants, variants reversed, whole) and of each `extra` callable
    beside the whole's turns."""
    names = list(libs)
    ms = {k: [] for k in names + list(extra)}
    try:
        for k in names + names[::-1]:
            if k == "whole":
                for e, g in extra.items():
                    ms[e].append(graph_ms(g))
            kernel._lib = libs[k]
            ms[k].append(graph_ms(fn))
    finally:
        kernel._lib = libs["whole"]
    return ms


def trace_alc(gen, dev, base, clock_hz) -> dict:
    variants = {f"no_{ph}": pairs for ph, pairs in ALC_PHASES.items()}
    variants.update(ALC_DESIGNS)
    libs = build_variants(alc_k.ALC, variants)
    for lib in libs.values():
        lib.geometry_checked = True
    alc_k._lib()
    tp = tx.make_params(tx.TX_FLAGSHIP, dev).alc
    result = {}
    for label, C, T, D, gs in ALC_SHAPES:
        params = alc_mod.make_params(tp.decay, D, 4.0, gs)
        n = torch.arange(T, device=dev, dtype=torch.float32)
        level = torch.logspace(3, 4.7, C, device=dev)[:, None]
        x = (level * torch.sin(2 * np.pi * 700.0 / 48000.0 * n)[None, :]
             * (torch.remainder(n, 3000.0) < 1500.0)[None, :]
             + torch.randn((C, T), generator=gen, device=dev)).contiguous()
        v = torch.ones(C, device=dev)
        d = torch.zeros((C, D), device=dev)
        extra = {}
        if base is not None:
            gains, stage = base
            xp = (x * params.postfilt_gain).contiguous()
            extra["baseline_kernel"] = lambda: gains(params.decay, v, xp)
            extra["baseline_stage"] = lambda: stage(params, v, d, x)
        ms = turns(libs, alc_k.ALC,
                   lambda: alc_k.alc_run(params, v, d, x), extra)
        mean = {k: float(np.mean(r)) for k, r in ms.items()}
        nbytes = (2 * C * T + 2 * C * D + 2 * C) * 4
        t_b = nbytes / PEAK_BYTES_S * 1e3
        t_r = T * ALC_STEP_OPS * FP32_LATENCY / clock_hz * 1e3
        cyc = mean["whole"] * 1e-3 * clock_hz / T
        cost = {ph: mean["whole"] - mean[f"no_{ph}"] for ph in ALC_PHASES}
        geo = alc_k.alc_geometry(C, T)
        print(f"alc {label} {C} x {T} D={D} gs={gs} (lanes {geo.lanes}, "
              f"{geo.blocks} blocks): whole {mean['whole']:.4f} ms ("
              + ", ".join(f"{r:.4f}" for r in ms["whole"]) + f"), "
              f"{cyc:.1f} cycles a step against the chain's "
              f"{ALC_STEP_OPS * FP32_LATENCY}; bound {max(t_b, t_r):.4f} "
              f"(recurrence {t_r:.4f}, bytes {t_b:.4f}); left out: "
              + ", ".join(f"{ph} {mean[f'no_{ph}']:.4f} (costs "
                          f"{cost[ph]:.4f})" for ph in ALC_PHASES)
              + "; designs: " + ", ".join(f"{d} {mean[d]:.4f}"
                                         for d in ALC_DESIGNS)
              + "".join(f"; {e} {mean[e]:.4f} ("
                        + ", ".join(f"{r:.4f}" for r in ms[e]) + ")"
                        for e in extra))
        result[label] = dict(
            shape=[C, T], delay=D, gain_scaling=gs, lanes=geo.lanes,
            whole_ms=mean["whole"], whole_readings=ms["whole"],
            cycles_a_step=cyc, chain_cycles=ALC_STEP_OPS * FP32_LATENCY,
            recurrence_bound_ms=t_r, byte_bound_ms=t_b,
            without_ms={ph: mean[f"no_{ph}"] for ph in ALC_PHASES},
            phase_cost_ms=cost,
            designs_ms={d: mean[d] for d in ALC_DESIGNS},
            baseline_kernel_ms=mean.get("baseline_kernel"),
            baseline_stage_ms=mean.get("baseline_stage"),
            baseline_readings={e: ms[e] for e in extra})
        del x, n, level
    return result


def sass_counts(lib: pathlib.Path) -> dict:
    """{(L, S): (FFMA, LDS.128, all LDS)} of each fixed K4 instance in
    `cuobjdump -sass` of the library."""
    cuobjdump = pathlib.Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        m = re.match(r"\S*interp_fixedILi(\d+)ELi(\d+)E", fn)
        if m:
            ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_.]+)", fn)
            out[(int(m.group(1)), int(m.group(2)))] = (
                sum(o.startswith("FFMA") for o in ops),
                sum(o.startswith("LDS.128") for o in ops),
                sum(o.startswith("LDS") for o in ops))
    return out


def trace_interp(gen, dev, base) -> dict:
    variants = {f"no_{ph}": pairs for ph, pairs in INTERP_PHASES.items()}
    variants.update(INTERP_DESIGNS)
    libs = build_variants(fir_k.INTERP, variants)
    for lib in libs.values():
        lib.geometry_checked = True
    fir_k._interp_lib()
    counts = sass_counts(fir_k.INTERP._lib_path())
    for (L, S), (ffma, lds128, lds) in sorted(counts.items()):
        geo = fir_k.interp_geometry(L, L * S, 4096)
        window = (geo.H + geo.R) // 4
        print(f"interp SASS x{L} S {S}: {ffma} FFMA, {lds128} LDS.128 of "
              f"{lds} LDS; the window's {window} LDS.128: "
              f"{window / ffma:.4f} shared loads a FMA ({lds / ffma:.4f} "
              "with the staged stores')")
    result = {"sass": {f"x{L}_S{S}": dict(ffma=c[0], lds128=c[1], lds=c[2])
                       for (L, S), c in counts.items()}}
    for label, h, C, B, L in interp_shapes(dev):
        taps = h.shape[-1]
        S = -(-taps // L)
        x = torch.randn((C, B), generator=gen, device=dev) * 0.1
        carry = torch.randn((C, S - 1), generator=gen, device=dev) * 0.1
        extra = {}
        if base is not None:
            extra["baseline"] = lambda: base(h, carry, x, L)
        ms = turns(libs, fir_k.INTERP,
                   lambda: fir_k.interpolate(h, carry, x, L), extra)
        mean = {k: float(np.mean(r)) for k, r in ms.items()}
        nbytes = (C * B + C * B * L + 2 * C * (S - 1) + taps) * 4
        t_b = nbytes / PEAK_BYTES_S * 1e3
        cost = {ph: mean["whole"] - mean[f"no_{ph}"] for ph in INTERP_PHASES}
        geo = fir_k.interp_geometry(L, taps, B, C)
        print(f"interp {label} {C} x {B} -> {B * L} ({taps} taps, S {S}, R "
              f"{geo.R}, {geo.blocks} blocks): whole {mean['whole']:.4f} ms "
              "(" + ", ".join(f"{r:.4f}" for r in ms["whole"]) + "), "
              f"{100 * t_b / mean['whole']:.1f}% of its byte bound "
              f"{t_b:.4f}; left out: "
              + ", ".join(f"{ph} {mean[f'no_{ph}']:.4f} (costs "
                          f"{cost[ph]:.4f})" for ph in INTERP_PHASES)
              + "; designs: " + ", ".join(f"{d} {mean[d]:.4f}"
                                         for d in INTERP_DESIGNS)
              + (f"; baseline {mean['baseline']:.4f} ("
                 + ", ".join(f"{r:.4f}" for r in ms["baseline"]) + ")"
                 if base is not None else ""))
        result[label] = dict(
            shape=[C, B], interp=L, taps=taps, R=geo.R,
            whole_ms=mean["whole"], whole_readings=ms["whole"],
            byte_bound_ms=t_b, bound_share=t_b / mean["whole"],
            without_ms={ph: mean[f"no_{ph}"] for ph in INTERP_PHASES},
            phase_cost_ms=cost,
            designs_ms={d: mean[d] for d in INTERP_DESIGNS},
            baseline_ms=mean.get("baseline"),
            baseline_readings=ms.get("baseline"))
        del x, carry
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--only", choices=("alc", "interp"), default=None)
    ap.add_argument("--baseline", type=pathlib.Path, nargs="+", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_alc_interp: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    mhz, unit = smi("clocks.max.sm").split()
    clock_hz = float(mhz) * 1e6
    print(f"card: {card}; max SM clock {mhz} {unit}")
    alc_base = interp_base = None
    for path in args.baseline:
        if path.name.startswith("alc"):
            alc_base = alc_baseline(path)
        elif path.name.startswith("interp"):
            interp_base = interp_baseline(path)
        else:
            raise SystemExit(f"--baseline {path}: name it alc*.cu or "
                             "interp*.cu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    result = {"card": card}
    if args.only in (None, "alc"):
        result["alc"] = trace_alc(gen, dev, alc_base, clock_hz)
        torch.cuda.empty_cache()
    if args.only in (None, "interp"):
        result["interp"] = trace_interp(gen, dev, interp_base)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
