"""Where K2's time goes on the card, phase by phase.

    python -m uhsdr_tpu_torch.trace_blocked [--seed 7] [--baseline FILE]

Builds `kernels/blocked.cu` as it is and variants of it (trace_front's
`build_variants`), five each with one phase left out: the load (the
cp.async staging of the tiles; the tiles keep what they held), the
triangle (the full chunks of taps; the diagonal chunk still runs), the
state terms (the x G partial sums and the u_{c-1} HS products), the
carry (the in-order chain u_c = x_c G + u_{c-1} F^T) and the stores of y
(a test the outputs never pass keeps them computed).  Two more are other
designs of the kernel (`DESIGNS`): 8 outputs a lane with eight warps a
block, and the kernel asking 24 KB more shared memory than it uses (two
blocks an SM where it holds three); and the kernel is timed with half
and with twice the channels a block its rule picks (2 to 32).  Times
them through `cuda.iir.blocked_cascade`, each library in turn in the
kernel's place, on the same inputs (device time: CUDA events around a
CUDA graph of 20 launches, after one; whole, variants, variants
reversed, whole) at the shapes the port sends K2: the SSB PreFilter
(8192 x 2048, 5 sections), the AM/SAM PreFilter (8192 x 4096),
ssbstereo's (8192 x 2 x 2048), FM's squelch HPF (8192 x 8192, 2
sections), the TX voice bandpass (8192 x 16384, 5), the fleet's PreFilter
(1024 x 4096) and squelch (1024 x 16384), and the wideband groups (2730 x
1024 and 1366 x 2048).  With --baseline, the file (an earlier
`blocked.cu` with the C interface that takes no channels a block) is
built too and timed at every shape in the same turns, before and after
the kernel.  Prints, per shape, each variant's ms and what the left-out
phase costs while the others still run (the whole less the variant), the
rest (the whole less every phase's cost), the bound (the larger of the
FMA time at the card's published FP32 peak and the byte time at its
memory rate: `blocked_work`) and the useful FMA rate against that peak;
then one JSON line.  The variants' outputs are wrong: they only time.
Exits 2 where CUDA is absent.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

from .chain import rx, tx
from .cuda import build
from .cuda import iir as iir_k
from .ops import iir
from .trace_front import PEAK_FMA_S, build_variants

PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
# each phase in blocked.cu: its loop headers and the same run 0 times
PHASES = {
    "load": (("for (int k = lane / PC; k < LANES; k += 32 / PC) {",
              "for (int k = lane / PC; k < 0; k += 32 / PC) {"),),
    "triangle": (("for (int k0 = 0; k0 < s0; k0 += RO, xw -= RO) {",
                  "for (int k0 = 0; k0 < 0; k0 += RO, xw -= RO) {"),),
    "state": (("for (int p = warp; p < PAIRS; p += NW) {  // xG",
               "for (int p = warp; p < 0; p += NW) {  // xG"),
              ("for (int j = 0; j < U; ++j) {  // HS",
               "for (int j = 0; j < 0; ++j) {  // HS")),
    "carry": (("for (int t = 0; t < tv; ++t) {",
               "for (int t = 0; t < 0; ++t) {"),),
    # the stores of y: a test the outputs never pass keeps them live
    "store": (("        if (rd.row((lane & ~(Q - 1)) + s, &ch, &c))\n",
               "        if (rd.row((lane & ~(Q - 1)) + s, &ch, &c) &&\n"
               "            v[s].x == 1e30f)\n"),),
}
# other designs: outputs a lane and warps a block
DESIGNS = {
    "ro8_nw8": (("constexpr int RO = 16;", "constexpr int RO = 8;"),
                ("constexpr int NW = 4;", "constexpr int NW = 8;")),
    # 24 KB more shared memory a block than it uses: two blocks an SM
    "two_blocks_sm": (("  const int smem = 4 * layout(U).floats;\n",
                       "  const int smem = 4 * layout(U).floats + 24576;\n"),
                      ("      4 * layout(U).floats);",
                       "      4 * layout(U).floats + 24576);")),
}
# (label, the cascade, shape of x)
SHAPES = (("ssb", "prefilter", (8192, 2048)),
          ("am_sam", "prefilter", (8192, 4096)),
          ("ssbstereo", "prefilter", (8192, 2, 2048)),
          ("fm_squelch", "squelch", (8192, 8192)),
          ("tx_voice", "soprano", (8192, 16384)),
          ("fleet", "prefilter", (1024, 4096)),
          ("fleet_squelch", "squelch", (1024, 16384)),
          ("wideband_usb", "prefilter", (2730, 1024)),
          ("wideband_am", "prefilter", (1366, 2048)))


def blocked_work(S: int, C: int, T: int, R: int = 128) -> tuple[float, float]:
    """(bytes, FP32 operations) of one K2 call: x in and y out, the states
    in and out, the tables; per chunk and channel the Toeplitz triangle
    R(R+1)/2, the state terms HS (2S R), G (R 2S) and F^T (4 S^2) FMAs."""
    nbytes = 2 * C * T * 4 + 2 * S * C * 2 * 4 + (R * R + 4 * S * R
                                                   + 4 * S * S) * 4
    fma = C * (T // R) * (R * (R + 1) / 2 + 4 * S * R + 4 * S * S)
    return nbytes, 2.0 * fma


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of fn() (launches on the current stream) by CUDA
    events around one replay of a CUDA graph of `reps` calls: no host
    time between the launches."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def cascade_of(name: str, dev) -> iir.Cascade:
    """The chains' cascades: the SSB flagship's PreFilter, FM's squelch
    HPF, the TX SOPRANO voice bandpass."""
    if name == "prefilter":
        return rx.make_params(rx.FLAGSHIP, dev).audio_sos
    if name == "squelch":
        return rx.make_params(rx.FM_FLAGSHIP, dev).fm.squelch_sos
    return tx.make_params(tx.TX_FLAGSHIP, dev).voice_sos


def baseline_launcher(path: pathlib.Path):
    """Build an earlier blocked.cu (its C interface takes no channels a
    block) with the kernel's flags; returns a launch(c, state, x)."""
    so = build.BUILD_DIR / "trace_blocked" / "baseline.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    p = subprocess.run([build.nvcc_path(), *iir_k.BLOCKED.flags, "-o",
                        str(so), str(path)], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.uhsdr_blocked_launch.argtypes = [P] * 6 + [I] * 3 + [P] * 3
    lib.uhsdr_blocked_launch.restype = I

    def launch(c, state, x):
        y, s = torch.empty_like(x), torch.empty_like(state)
        err = lib.uhsdr_blocked_launch(
            x.data_ptr(), state.data_ptr(), c.M.data_ptr(), c.HS.data_ptr(),
            c.G.data_ptr(), c.Ft.data_ptr(), c.sections,
            x.numel() // x.shape[-1], x.shape[-1], y.data_ptr(),
            s.data_ptr(), build.stream_ptr(x.device))
        if err:
            raise RuntimeError(f"baseline launch failed: cudaError {err}")
        return y, s
    return launch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--baseline", type=pathlib.Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_blocked: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}")
    variants = {f"no_{ph}": pairs for ph, pairs in PHASES.items()}
    variants.update(DESIGNS)
    libs = build_variants(iir_k.BLOCKED, variants)
    for lib in libs.values():
        # the designs' constants differ from cuda/iir.py's; they only time
        lib.geometry_checked = True
    base = baseline_launcher(args.baseline) if args.baseline else None
    rule = iir_k.blocked_geometry

    def regrid(factor):
        def geometry(C, T, S, sms=iir_k.BLOCKED_SMS):
            """the rule's launch with `factor` times its channels a block"""
            geo = rule(C, T, S, sms)
            return geo._replace(cpw=min(32, max(2, int(geo.cpw * factor))))
        return geometry
    grids = {"half_cpw": regrid(0.5), "twice_cpw": regrid(2)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    result = {}
    for label, name, shape in SHAPES:
        c = cascade_of(name, dev)
        S = c.sections
        x = torch.randn(shape, generator=gen, device=dev) * 0.1
        st = torch.zeros((S,) + shape[:-1] + (2,), device=dev)
        C, T = x.numel() // shape[-1], shape[-1]
        names = list(libs)
        ms = {k: [] for k in names + (["baseline"] if base else [])}

        def kernel():
            iir_k.blocked_cascade(c, st, x)
        ms.update({g: [] for g in grids})
        try:
            for k in names + names[::-1]:
                if k == "whole" and base is not None:
                    ms["baseline"].append(graph_ms(lambda: base(c, st, x)))
                iir_k.BLOCKED._lib = libs[k]
                ms[k].append(graph_ms(kernel))
                if k == "whole":
                    for g, geometry in grids.items():
                        iir_k.blocked_geometry = geometry
                        ms[g].append(graph_ms(kernel))
                    iir_k.blocked_geometry = rule
        finally:
            iir_k.BLOCKED._lib = libs["whole"]
            iir_k.blocked_geometry = rule
        mean = {k: float(np.mean(v)) for k, v in ms.items()}
        nbytes, flops = blocked_work(S, C, T)
        t_b, t_o = nbytes / PEAK_BYTES_S * 1e3, flops / 2 / PEAK_FMA_S * 1e3
        bound = max(t_b, t_o)
        cost = {ph: mean["whole"] - mean[f"no_{ph}"] for ph in PHASES}
        rest = mean["whole"] - sum(cost.values())
        geo = iir_k.blocked_geometry(C, T, S)
        print(f"{label} {tuple(shape)} S={S} (cpw {geo.cpw}, tr {geo.tr}, "
              f"{geo.blocks} blocks): whole {mean['whole']:.4f} ms "
              f"({', '.join(f'{v:.4f}' for v in ms['whole'])}); bound "
              f"{bound:.4f} ms by {'bytes' if t_b >= t_o else 'operations'}"
              f" (FMA {t_o:.4f}, bytes {t_b:.4f}), useful FMA at "
              f"{100 * t_o / mean['whole']:.1f}% of the FP32 peak; left "
              "out: " + ", ".join(f"{ph} {mean[f'no_{ph}']:.4f} (costs "
                                  f"{cost[ph]:.4f})" for ph in PHASES)
              + f"; the rest {rest:.4f}; designs: "
              + ", ".join(f"{d} {mean[d]:.4f}" for d in DESIGNS)
              + "".join(f", {g} {mean[g]:.4f}" for g in grids)
              + (f"; baseline {mean['baseline']:.4f} ("
                 + ", ".join(f"{v:.4f}" for v in ms["baseline"]) + ")"
                 if base else ""))
        result[label] = dict(shape=list(shape), sections=S, cpw=geo.cpw,
                             tr=geo.tr, whole_ms=mean["whole"],
                             whole_readings=ms["whole"], bound_ms=bound,
                             fma_bound_ms=t_o, byte_bound_ms=t_b,
                             without_ms={ph: mean[f"no_{ph}"]
                                         for ph in PHASES},
                             phase_cost_ms=cost, rest_ms=rest,
                             designs_ms={d: mean[d] for d in DESIGNS},
                             grids_ms={g: mean[g] for g in grids},
                             baseline_ms=mean.get("baseline"),
                             baseline_readings=ms.get("baseline"))
        del x, st
    print(json.dumps({"card": card, "phases": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
