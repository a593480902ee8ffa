"""Where K14, the grouped biquad scan (`kernels/biquad.cu::
biquad_grouped_kernel`), spends its time on the card, phase by phase.

    python -m uhsdr_tpu_torch.trace_biquad [--seed 7] [--baseline FILE]

Builds biquad.cu as it is and variants of it (trace_front's
`build_variants`), each with one phase of K14 left out: the load (the
cp.async copies past the first tile: the warps walk stale slots), the
local chain of phase 1 (each group's local state taken as its input term
alone: the products g1 x and g2 x stay), the shuffle scan of phase 2
(its five levels), the correction of phase 3 (u1 = v1: the table reads
and the four products and sums a sample go) and the coalesced stores of
y; and other designs: a ring of three tiles a warp, and the launch
bounds of four and of six blocks an SM at L = 32 (more and fewer
registers a lane).  Times them through `cuda.iir.biquad_cascade(impl=
"grouped")`, each library in turn in the kernel's place, on the same
inputs (device time: CUDA events around a CUDA graph of 20 launches,
after one; whole, variants, variants reversed, whole), K11 on the same
inputs beside the whole, at SAM's stacked allpass shape (16384 x 4096, 7
sections) for L = 16, 32 and 64, and for L = 32 with one and two warps a
block in place of the rule's four.  A phase's cost is the whole less the
build without it.  Prints each instance's registers and local memory
(`cuobjdump --dump-resource-usage`: spills), and each time's share of
the byte bound.

With --baseline, the file is an earlier biquad.cu (PR 16's: `git show
c125539:uhsdr_tpu_torch/kernels/biquad.cu > _commit_check/
biquad_parent.cu`; its K14 takes a table of nine levels after a head of
five floats and at most 512 groups), built beside the new one (with the
kernel directory on the include path, for ring.cuh) and timed at every
shape it takes in the same turns.  Then one JSON line.  The variants'
outputs are wrong: they only time.  Exits 2 where CUDA is absent.
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

from .cuda import build
from .cuda import iir as iir_k
from .demod import sam as sam_demod
from .trace_alc_interp import smi, turns
from .trace_front import build_variants

PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3

PHASES = {
    "no_load": (("    if (m < ntiles)\n      grouped_load<L>(ring + (m % "
                 "GSTAGES)",
                 "    if (m < ntiles && m < GSTAGES)\n      grouped_load<L>("
                 "ring + (m % GSTAGES)"),),
    "no_local_chain": (("    const float n1 = c1 + a11 * v1p + v2p;\n"
                        "    const float n2 = c2 + a21 * v1p;",
                        "    const float n1 = c1;\n"
                        "    const float n2 = c2;"),),
    "no_scan": (("  for (int j = 0; j < GLEVELS; ++j) {",
                 "  for (int j = 0; j < 0; ++j) {"),),
    "no_correction": (("    const float u1 = v1[l] + p.x * q1 + p.y * q2;",
                       "    const float u1 = v1[l];"),),
    "no_store": (("    grouped_store<L>(slot, yr + (size_t)j * TL, n, vec, "
                  "lane);",
                  "    if (lane > 32) grouped_store<L>(slot, yr + (size_t)j "
                  "* TL, n, vec, lane);"),),
}
DESIGNS = {
    "stages3": (("constexpr int GSTAGES = 2;", "constexpr int GSTAGES = 3;"),),
    "minb4_l32": (("GMinBlocks<32> { static constexpr int value = 5; }",
                   "GMinBlocks<32> { static constexpr int value = 4; }"),),
    "minb6_l32": (("GMinBlocks<32> { static constexpr int value = 5; }",
                   "GMinBlocks<32> { static constexpr int value = 6; }"),),
}
SHAPE = (16384, 4096)


def baseline(path: pathlib.Path):
    """PR 16's K14 from an earlier biquad.cu: returns cascade(sos, state,
    x, L), or raises where that kernel refuses the shape."""
    so = build.BUILD_DIR / "trace_biquad" / f"{path.stem}.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    p = subprocess.run([build.nvcc_path(), *iir_k.BIQUAD.flags,
                        f"-I{build.KERNEL_DIR}", "-o", str(so), str(path)],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.uhsdr_biquad_grouped_launch.argtypes = [P, P, P, I, I, I, I, P, P, P]
    lib.uhsdr_biquad_grouped_launch.restype = I
    max_groups = lib.uhsdr_biquad_grouped_max_groups()
    levels = lib.uhsdr_biquad_grouped_levels()
    tabs = {}

    def cascade(sos, state, x, L):
        C, T = x.shape
        if -(-T // L) > max_groups:
            raise ValueError(f"PR 16's K14 takes at most {max_groups} groups")
        key = (id(sos), L)
        if key not in tabs:
            recs = [np.concatenate([head] + [M.reshape(-1)
                                             for M in powers + lv])
                    for head, powers, lv in iir_k.grouped_powers(
                        tuple(sos.double().cpu().reshape(-1).tolist()), L,
                        levels)]
            tabs[key] = torch.as_tensor(
                np.concatenate(recs).astype(np.float32), device=x.device)
        y, ns = torch.empty_like(x), torch.empty_like(state)
        err = lib.uhsdr_biquad_grouped_launch(
            x.data_ptr(), state.data_ptr(), tabs[key].data_ptr(),
            sos.shape[0], C, T, L, y.data_ptr(), ns.data_ptr(),
            build.stream_ptr(x.device))
        if err:
            raise RuntimeError(f"baseline K14 launch failed: cudaError {err}")
        return y, ns
    return cascade


def direct(lib, warps: int):
    """K14 of library `lib` with `warps` warps a block in place of the
    rule's: returns cascade(sos, state, x, L)."""
    def cascade(sos, state, x, L):
        C, T = x.shape
        y, ns = torch.empty_like(x), torch.empty_like(state)
        err = lib.uhsdr_biquad_grouped_launch(
            x.data_ptr(), state.data_ptr(),
            iir_k.grouped_table(sos, L).data_ptr(), sos.shape[0], C, T, L,
            warps, 1, y.data_ptr(), ns.data_ptr(), build.stream_ptr(x.device))
        iir_k.BIQUAD_GROUPED.check(err)
        return y, ns
    return cascade


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--baseline", type=pathlib.Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_biquad: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(f"card: {card}")
    libs = build_variants(iir_k.BIQUAD, {**PHASES, **DESIGNS})
    for lib in libs.values():
        lib.geometry_checked = lib.grouped_checked = True
    iir_k._grouped_lib()
    usage = iir_k.grouped_resources(iir_k.BIQUAD._lib_path())
    print(f"K14's registers, stack and local bytes by L: {usage}")
    base = baseline(args.baseline) if args.baseline else None
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    sos = sam_demod.make_params(24000.0, device=dev).ap_sos[0]
    S = sos.shape[0]
    C, T = SHAPE
    x = torch.randn((C, T), generator=gen, device=dev) * 0.1
    st = torch.zeros((S, C, 2), device=dev)
    t_b = 2 * C * T * 4 / PEAK_BYTES_S * 1e3
    result = {"card": card, "resources": usage, "shape": [C, T, S],
              "byte_bound_ms": t_b}
    for L in iir_k.GROUP_LENS:
        extra = {"k11": lambda: iir_k.biquad_cascade(sos, st, x)}
        if base is not None:
            extra["baseline"] = lambda L=L: base(sos, st, x, L)
        if L == 32:
            extra.update({f"warps{w}": lambda w=w: direct(
                libs["whole"], w)(sos, st, x, L) for w in (1, 2)})
        use = {k: v for k, v in libs.items()
               if not k.startswith("minb") or k.endswith(f"l{L}")}
        ms = turns(use, iir_k.BIQUAD,
                   lambda L=L: iir_k.biquad_cascade(sos, st, x,
                                                    impl="grouped",
                                                    group_len=L), extra)
        mean = {k: float(np.mean(r)) for k, r in ms.items()}
        cost = {ph: mean["whole"] - mean[ph] for ph in PHASES}
        geo = iir_k.grouped_geometry(C, T, L, S, build.sm_count(0))
        print(f"K14 L = {L}, {C} x {T}, {S} sections ({geo.warps} warps a "
              f"block, {geo.resident} blocks an SM): whole "
              f"{mean['whole']:.4f} ms ("
              + ", ".join(f"{r:.4f}" for r in ms["whole"])
              + f"), byte bound {t_b:.4f} ({100 * t_b / mean['whole']:.1f}%)"
              "; without: "
              + ", ".join(f"{ph} {mean[ph]:.4f} (costs {cost[ph]:.4f})"
                          for ph in PHASES)
              + "".join(f"; {k} {v:.4f}" for k, v in mean.items()
                        if k != "whole" and k not in PHASES))
        result[f"k14_l{L}"] = dict(
            whole_ms=mean["whole"], whole_readings=ms["whole"],
            phase_cost_ms=cost, other_ms={k: v for k, v in mean.items()
                                          if k != "whole"},
            readings={k: r for k, r in ms.items() if k != "whole"},
            geometry=geo._asdict())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
