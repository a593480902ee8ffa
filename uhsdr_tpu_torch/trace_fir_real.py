"""Where K8's time goes on the card, phase by phase.

    python -m uhsdr_tpu_torch.trace_fir_real [--seed 7]

Builds `kernels/fir_real.cu` as it is and variants of it (trace_front's
`build_variants`), three each with one phase of the tile loop left out:
the load (the cp.async staging of the next tile and the copy of the
staged audio to its columns), the FIR (the chunk loop over the taps; the
window's first samples are still read) and the rotation and store (the
conjugation, the NCO's rotors and the stores of an item, in place of
which a sum of the item's accumulators is tested against a value it never
takes, so the FIR is not dropped); a fourth leaves out the load and the
store both (the FIR alone, with its barriers and halo copies).  Three
more are other designs of the kernel (`DESIGNS`): R = 16 outputs a
thread, eight blocks an SM, tiles of 16 KB.  Times them through
`cuda.fir.fir_real`, each library in turn in the kernel's place, on the
same inputs (CUDA events, 10 launches after one; whole, variants,
variants reversed, whole) at the shapes the port sends K8: the TX
flagship (8192 ch x 16384 f32, the 201-tap TX Hilbert pair) with the NCO
(usb) and without (am), the TX paths at 1024 channels, and
`wideband_tx`'s 4096 channels of 4096 samples.  Prints, per shape, each
variant's ms and what the left-out phase costs while the others still
run (the whole kernel's time less the variant's), the rest (the whole
less every phase's cost), beside the FMA bound at the card's published
FP32 peak (201 taps; the 208 the kernel runs, zero-padded to whole
chunks, beside).  Then runs K8 back to back at the flagship for a few
seconds while nvidia-smi samples the SM clock and the power draw every
100 ms, and prints their medians and the FP32 peak at that clock (the
published peak assumes 1980 MHz); then one JSON line.  The variants'
outputs are wrong: they only time.  Exits 2 where CUDA is absent.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from .chain import tx
from .cuda import fir as fir_k
from .trace_front import PEAK_FMA_S, build_variants, cuda_ms

# each phase in fir_real.cu: its loop headers (or its call) and the same
# run 0 times (or a sink that keeps the accumulators live)
PHASES = {
    "load": (("for (int k = threadIdx.x; k < nv; k += NT)",
              "for (int k = threadIdx.x; k < 0; k += NT)"),
             ("for (int k = nv * 4 + threadIdx.x; k < tb; k += NT)",
              "for (int k = nv * 4 + threadIdx.x; k < 0; k += NT)"),
             ("for (int j = tid; j < tv; j += NT) xbuf[pad(E + j)] = st[j];",
              "for (int j = tid; j < 0; j += NT) xbuf[pad(E + j)] = st[j];")),
    "fir": (("for (int k0 = k_lo; k0 < k_hi; k0 += R, xr -= R + 1)",
             "for (int k0 = k_lo; k0 < k_lo; k0 += R, xr -= R + 1)"),),
    "store": (("  if constexpr (NCO) rotor(ph, &s0, &c0);\n",
               "  {\n    float s_ = 0.f;\n"
               "    for (int r = 0; r < R; ++r) s_ += ar[r] + ai[r];\n"
               "    if (s_ != 1.5e-38f) return;\n"
               "    o[0] = make_float2(s_, (float)conj);\n    return;\n"
               "  }\n"),),
}
# the FIR alone: the load and the rotation and store both left out
ALONE = {"fir_alone": PHASES["load"] + PHASES["store"]}
# other designs of the same kernel: R = 16 outputs a thread; eight blocks
# an SM (64 registers a thread); tiles of 16 KB of audio
DESIGNS = {"r16": (("constexpr int R = 8;", "constexpr int R = 16;"),),
           "occ8": (("__launch_bounds__(NT, 4)",
                     "__launch_bounds__(NT, 8)"),),
           "tile16k": (("constexpr int TILE_BYTES = 8192;",
                        "constexpr int TILE_BYTES = 16384;"),)}
# (label, channels, block, NCO on)
SHAPES = (("tx_usb", 8192, 16384, True),
          ("tx_am", 8192, 16384, False),
          ("tx_1024", 1024, 16384, True),
          ("wideband_tx", 4096, 4096, True))
MAX_SM_MHZ = 1980.0         # the clock the published FP32 peak assumes


def clock_under_load(launch, seconds: float = 3.0) -> dict:
    """Median SM clock (MHz) and power draw (W) while `launch` runs back
    to back for `seconds`, from nvidia-smi sampling every 100 ms (the
    first second's samples dropped: the clock settles)."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t_end = time.time() + seconds
        while time.time() < t_end:
            for _ in range(20):
                launch()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    rows = [[float(v) for v in line.split(",")]
            for line in out.splitlines() if line.strip()]
    rows = rows[10:] or rows
    return dict(sm_mhz=statistics.median(r[0] for r in rows),
                power_w=statistics.median(r[1] for r in rows),
                samples=len(rows))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_fir_real: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}")
    variants = {f"no_{ph}": pairs for ph, pairs in PHASES.items()}
    variants.update(ALONE)
    variants.update(DESIGNS)
    libs = build_variants(fir_k.FIR_REAL, variants)
    for lib in libs.values():
        # a design variant's constants differ from cuda/fir.py's; the
        # kernel computes its own geometry
        lib.geometry_checked = True
    params = tx.make_params(tx.TX_FLAGSHIP, dev).ssb
    h, delta = params.fir, params.nco_delta
    taps = h.shape[-1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    names = ["whole"] + list(variants)
    result = {}
    for label, C, B, use_nco in SHAPES:
        x = torch.randn((C, B), generator=gen, device=dev) * 1e4
        carry = torch.randn((C, taps - 1), generator=gen, device=dev) * 1e4
        phase = torch.randint(0, 2**32, (C,), generator=gen, device=dev)
        nco = (phase, delta) if use_nco else None

        def launch():
            return fir_k.fir_real(h, carry, x, nco=nco)

        ms = {name: [] for name in names}
        try:
            for name in names + names[::-1]:
                fir_k.FIR_REAL._lib = libs[name]
                ms[name].append(cuda_ms(launch))
        finally:
            fir_k.FIR_REAL._lib = libs["whole"]
        mean = {name: sum(v) / len(v) for name, v in ms.items()}
        geo = fir_k.fir_real_geometry(taps, B)
        bound = C * B * 2 * taps / PEAK_FMA_S * 1e3
        bound_pad = C * B * 2 * geo.ap / PEAK_FMA_S * 1e3
        cost = {ph: mean["whole"] - mean[f"no_{ph}"] for ph in PHASES}
        rest = mean["whole"] - sum(cost.values())
        print(f"{label}: {C} ch x {B}, NCO {use_nco}, whole "
              f"{mean['whole']:.4f} ms "
              f"({', '.join(f'{v:.4f}' for v in ms['whole'])}), FMA bound "
              f"{bound:.4f} ms ({bound_pad:.4f} at {geo.ap} taps, "
              f"{bound_pad / mean['whole']:.1%} of the FP32 peak); left "
              "out: " + ", ".join(f"{ph} {mean[f'no_{ph}']:.4f} (costs "
                                  f"{cost[ph]:.4f})" for ph in PHASES)
              + f"; the rest {rest:.4f}; FIR alone {mean['fir_alone']:.4f}"
              f" ({bound_pad / mean['fir_alone']:.1%}); designs: "
              + ", ".join(f"{d} {mean[d]:.4f}" for d in DESIGNS))
        result[label] = dict(channels=C, block=B, nco=use_nco,
                             whole_ms=mean["whole"], fma_bound_ms=bound,
                             fma_bound_padded_ms=bound_pad,
                             without_ms={ph: mean[f"no_{ph}"]
                                         for ph in PHASES},
                             phase_cost_ms=cost, rest_ms=rest,
                             fir_alone_ms=mean["fir_alone"],
                             design_ms={d: mean[d] for d in DESIGNS})
        if label == "tx_usb":
            load = clock_under_load(launch)
            load["ms"] = cuda_ms(launch)
            peak = PEAK_FMA_S * load["sm_mhz"] / MAX_SM_MHZ
            load["fp32_peak_share"] = C * B * 2 * geo.ap / peak / (
                load["ms"] * 1e-3)
            print(f"{label} under load: SM clock {load['sm_mhz']:.0f} MHz, "
                  f"{load['power_w']:.1f} W ({load['samples']} samples); "
                  f"K8 {load['ms']:.4f} ms, "
                  f"{load['fp32_peak_share']:.1%} of the FP32 peak at "
                  "that clock")
            result[label]["under_load"] = load
        del x, carry
    print(json.dumps({"card": card, "phases": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
