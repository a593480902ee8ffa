"""Where the SAM demodulator's kernels spend their time on the card, phase
by phase: K10 and K9 (`kernels/pll.cu`), K11 (`kernels/biquad.cu`) and
the fused sideband stage (`kernels/sam.cu`).

    python -m uhsdr_tpu_torch.trace_sam [--seed 7] [--baseline FILE ...]

Builds both sources as they are and variants of each (trace_front's
`build_variants`) with one phase left out, and times them through the
wrappers (`cuda.pll.pll`, `pll_audio`, `cuda.iir.biquad_cascade`,
`cuda.sam.sam_sideband`), each library in turn in the kernel's place, on
the same inputs (device time: CUDA events around a CUDA graph of 20
launches, after one; whole, variants, variants reversed, whole).  A
phase's cost is the whole less the build without it.

K10 and K9 at the SAM flagship (8192 x 4096 at 24 kHz), the same with a
quarter of the channels silent (exact zeros, which the fast atan2
takes), K10 with a NaN in one channel of 16 (whose warp walks the rest
of the block with the library), and K9 at the fleet's sam group (1024 x
4096): left out in turn are the staging of iq past the first tiles (the
walkers run on stale stages, the barriers kept), the output warps'
stores, both (the walk alone), the fallback of a pair of steps to the
library's sincosf, atan2f and the fmodf wrap (its code; of these inputs
only the NaN takes it), and K9's fade epilogue; other designs:
`libdevice` walks every step with the library's functions (the branches
the fast forms take out), `zero_to_library` sends a zero pair to the
library's walk as the first fast atan2 did (a warp holding a
silent channel then walks every pair twice), `nan_to_fmodf` hands a
NaN phase to fmodf in the library's walk.  Printed: the walker's
cycles a step (the whole's time at the card's maximum SM clock over T)
beside the critical cycle's, and from `cuobjdump -sass` of the library
the length of that cycle in dependent instructions of K10's fast pair of
steps (the count `cuda/pll.py::PLL_CYCLE_CHAIN` carries).

K11 at SAM's stacked allpass shape (16384 x 4096, 7 sections) and the
fused stage (usb at 8192 x 4096, stereo at 1024 x 4096): left out in
turn are the staging past the first tiles, the stores, both, and the
stage's fade epilogue.  Printed: each share of the byte bound.

With --baseline, each file is an earlier source built beside the new one
and timed at every shape in the same turns: a file named pll*.cu is the
one-step walker of ba75447 (K9/K10; its C interface without the lanes
and alignment arguments), one named biquad*.cu that commit's K11, timed
alone and as the sideband route the fused stage replaced (the products,
delays and stacking in torch, K11 on the two stacked pairs, the combine
and the fade leveler's blocked one-poles):
`git show ba75447:uhsdr_tpu_torch/kernels/pll.cu > _commit_check/
pll_parent.cu` (the same for biquad.cu).  Then one JSON line.  The
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

from .cuda import build
from .cuda import iir as iir_k
from .cuda import pll as pll_k
from .cuda import sam as sam_k
from .demod import am as am_demod
from .demod import sam as sam_demod
from .trace_alc_interp import build_baseline, smi, turns
from .trace_front import build_variants

PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
FP32_LATENCY = 4

_NO_STAGE_PLL = ("      if (m >= STAGES) bar_sync(BAR_FREE + m % STAGES, "
                 "32 + OUT_T);\n      load_tile(",
                 "      if (m >= STAGES) bar_sync(BAR_FREE + m % STAGES, "
                 "32 + OUT_T);\n      if (m < STAGES) load_tile(")
_NO_STORE_PLL = ("    if (lane < cnt) {\n      const size_t t",
                 "    if (lane < cnt && lane > 32) {\n      const size_t t")
PLL_VARIANTS = {
    "no_stage": (_NO_STAGE_PLL,),
    "no_store": (_NO_STORE_PLL,),
    "walk_alone": (_NO_STAGE_PLL, _NO_STORE_PLL),
    "no_fallback": (("  if (!(ok0 & ok1)) {", "  if (false) {"),),
    "no_fade": (("  ok = ok & (fabsf(w.phs1) < SINCOS_FAST) & wrap_range(x);\n"
                 "  if (AUDIO) {\n    w.dc = p.mR * w.dc + p.aR * re;\n"
                 "    w.dci = p.mI * w.dci + p.aI * re;\n"
                 "    o0 = re + w.dci - w.dc;",
                 "  ok = ok & (fabsf(w.phs1) < SINCOS_FAST) & wrap_range(x);\n"
                 "  if (AUDIO) {\n    o0 = re;"),),
    # other designs: a zero pair (a silent channel) sends its pair of steps
    # to the library's walk, as the first fast atan2 did
    "zero_to_library": (
        ("  ok = (mx <= 0x1p100f) & ((mx >= 0x1p-100f) | (mx == 0.f)) &\n"
         "       ((mn == 0.f) | (mn * 0x1p100f >= mx));\n"
         "  float r = rcp_approx(fmaxf(mx, 0x1p-100f));",
         "  ok = (mx <= 0x1p100f) & (mx >= 0x1p-100f) &\n"
         "       ((mn == 0.f) | (mn * 0x1p100f >= mx));\n"
         "  float r = rcp_approx(mx);"),),
    # a NaN phase through fmodf in the library's walk
    "nan_to_fmodf": (("  if (!isfinite(x)) return x - x;\n", ""),),
    # every step on the library's sincosf and atan2f
    "libdevice": (("  const bool ok0 = pll_step_fast<AUDIO>(w, zr0, zi0, p, "
                   "o[0], o[1]);\n  const bool ok1 = pll_step_fast<AUDIO>(w, "
                   "zr1, zi1, p, o[2], o[3]);",
                   "  const bool ok0 = false, ok1 = false;"),),
}
PLL_PHASES = ("no_stage", "no_store", "walk_alone", "no_fallback", "no_fade")

_NO_STAGE_K11 = ("    front(ntiles, [&](int m) {\n      const int t0 = m * TA;\n",
                 "    front(ntiles, [&](int m) {\n      if (m >= STAGES) "
                 "return;\n      const int t0 = m * TA;\n")
_NO_STAGE_SAM = ("      const int t0 = m * TA, cnt = min(TA, g.T - t0);\n",
                 "      if (m >= STAGES) return;\n"
                 "      const int t0 = m * TA, cnt = min(TA, g.T - t0);\n")
# ring.cuh's output warps, written into each source by build_variants
_NO_STORE_RING = ("    if (lane < cnt) {\n      const float* pl",
                  "    if (lane < cnt && lane > 32) {\n      const float* pl")
BIQUAD_VARIANTS = {
    "no_stage": (_NO_STAGE_K11,),
    "no_store": (_NO_STORE_RING,),
    "walk_alone": (_NO_STAGE_K11, _NO_STORE_RING),
}
SAM_VARIANTS = {
    "no_stage": (_NO_STAGE_SAM,),
    "no_store": (_NO_STORE_RING,),
    "walk_alone": (_NO_STAGE_SAM, _NO_STORE_RING),
    "no_fade": (("  if (FADE) {\n    const float corr",
                 "  if (FADE && false) {\n    const float corr"),),
}


def pll_cycle_chain(lib: pathlib.Path) -> dict:
    """From `cuobjdump -sass` of the PLL library: K10's fast pair of steps
    and the length of its longest chain of dependent instructions
    (`sass_cycle_chain`)."""
    cuobjdump = pathlib.Path(build.nvcc_path()).with_name("cuobjdump")
    return sass_cycle_chain(subprocess.run(
        [str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
        check=True).stdout)


def sass_cycle_chain(sass: str) -> dict:
    """K10's fast pair of steps in the SASS text: the straight-line block
    from the walker's first LDS.128 (a tile's two samples; the output warps
    read LDS.64) to the branch that takes the library's fallback (the
    convergence marks BSSY and BSYNC are no instructions of the pair), and
    the length of its longest chain of dependent instructions: the loop's
    critical cycle over the two steps, the carried cos, sin and phases,
    loads and constants at depth 0."""
    fn = next(f for f in sass.split("Function : ")[1:]
              if re.match(r"\S*pll_kernelILb0E", f))
    lines = fn.splitlines()
    start = next(i for i, ln in enumerate(lines) if "LDS.128" in ln)
    depth, n_ins, longest = {}, 0, 0
    for ln in lines[start:]:
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                     r"\s*(.*?);", ln)
        if not m:
            continue
        op, args = m.group(2), m.group(3)
        if op.startswith("BRA"):
            break
        if op.startswith(("BSSY", "BSYNC")):
            continue
        regs = re.findall(r"(?<![\w.])-?\|?(R\d+|P\d)", args)
        n_ins += 1
        if not regs or op.startswith(("LDS", "LDC", "MOV", "IMAD.MOV",
                                      "HFMA2.MMA")):
            if regs:
                depth[regs[0]] = 0
            continue
        d = 1 + max([depth.get(r, 0) for r in regs[1:]] + [0])
        if m.group(1):          # predicated: its predicate and old value
            pr = m.group(1).strip().lstrip("@!")
            d = max(d, 1 + depth.get(pr, 0), depth.get(regs[0], 0))
        depth[regs[0]] = d
        longest = max(longest, d)
    return {"instructions": n_ins, "chain": longest}


def pll_baseline(path: pathlib.Path):
    """The earlier K10 and K9: returns (pll(p, carry, z), pll_audio(p, mR, mI,
    carry, z))."""
    lib = build_baseline(path, pll_k.PLL)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.uhsdr_pll_launch.argtypes = [P, P, I, I] + [F] * 4 + [P] * 4
    lib.uhsdr_pll_launch.restype = I
    lib.uhsdr_pll_audio_launch.argtypes = [P, P, I, I] + [F] * 8 + [P] * 3
    lib.uhsdr_pll_audio_launch.restype = I

    def pll(p, carry, z):
        C, T = z.shape
        c, s = (torch.empty((C, T), device=z.device) for _ in "cs")
        nc = torch.empty_like(carry)
        err = lib.uhsdr_pll_launch(
            z.data_ptr(), carry.data_ptr(), C, T, p.g1, p.g2, p.omega_min,
            p.omega_max, c.data_ptr(), s.data_ptr(), nc.data_ptr(),
            build.stream_ptr(z.device))
        if err:
            raise RuntimeError(f"baseline K10 launch failed: cudaError {err}")
        return c, s, nc

    def pll_audio(p, mR, mI, carry, z):
        C, T = z.shape
        a = torch.empty((C, T), device=z.device)
        nc = torch.empty_like(carry)
        err = lib.uhsdr_pll_audio_launch(
            z.data_ptr(), carry.data_ptr(), C, T, p.g1, p.g2, p.omega_min,
            p.omega_max, mR, float(np.float32(1 - mR)), mI,
            float(np.float32(1 - mI)), a.data_ptr(), nc.data_ptr(),
            build.stream_ptr(z.device))
        if err:
            raise RuntimeError(f"baseline K9 launch failed: cudaError {err}")
        return a, nc
    return pll, pll_audio


def replaced_route(ap_sos, fade, ap_state, ds, fade_state, iq, cos, sin,
                   sideband: str, fade_on: bool,
                   cascade=iir_k.biquad_cascade_plain):
    """The sideband route the fused stage replaced (demod/sam.py at
    ba75447, :142-185), with `cascade` as its K11 (by default K11's plain
    version): the products, delays and stacking in torch, K11 on the two
    stacked pairs, the combine and the fade leveler's blocked one-poles.
    Arguments as `cuda.sam.sam_sideband`'s.  Returns (the audio before the
    fade leveler, audio, ap_state, ds, fade state)."""
    n = iq.shape[0]
    i_t, q_t = iq.real, iq.imag
    ai, bi, aq, bq = cos * i_t, sin * i_t, cos * q_t, sin * q_t
    x0 = torch.cat([torch.cat([ds[:, 0:1], ai[:, :-1]], dim=-1),
                    torch.cat([ds[:, 1:2], bq[:, :-1]], dim=-1)])
    x1 = torch.cat([bi, aq])
    st0 = torch.cat([ap_state[0], ap_state[2]], dim=1)
    st1 = torch.cat([ap_state[1], ap_state[3]], dim=1)
    y0, s0 = cascade(ap_sos[0], st0, x0)
    y1, s1 = cascade(ap_sos[1], st1, x1)
    a, c, b, d = y0[:n], y0[n:], y1[:n], y1[n:]
    ap = torch.stack([s0[:, :n], s1[:, :n], s0[:, n:], s1[:, n:]])
    side = {}
    if sideband != "lsb":
        side["usb"] = (a - b) + (d + c)
    if sideband != "usb":
        side["lsb"] = (a + b) - (d - c)
    audio = (torch.stack([side["lsb"], side["usb"]], dim=-2)
             if sideband == "stereo" else side[sideband])
    ds_new = torch.stack([ai[:, -1], bq[:, -1]], dim=-1)
    out, fs = audio, fade_state
    if fade_on:
        corr = i_t * cos + q_t * sin
        if audio.ndim == 3:
            corr = corr[:, None, :].expand(audio.shape)
        out, f = am_demod.fade_leveler(
            am_demod.FadeLevelerParams(*fade),
            am_demod.FadeLevelerState(*fade_state), audio, corr)
        fs = (f.dc, f.dc_insert)
    return audio, out, ap, ds_new, fs


def biquad_baseline(path: pathlib.Path):
    """The earlier K11: returns cascade(sos, state, x)."""
    lib = build_baseline(path, iir_k.BIQUAD)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.uhsdr_biquad_launch.argtypes = [P, P, P, I, I, I, P, P, P]
    lib.uhsdr_biquad_launch.restype = I

    def cascade(sos, state, x):
        y, ns = torch.empty_like(x), torch.empty_like(state)
        C, T = x.shape
        err = lib.uhsdr_biquad_launch(
            x.data_ptr(), state.data_ptr(), sos.data_ptr(), sos.shape[0], C,
            T, y.data_ptr(), ns.data_ptr(), build.stream_ptr(x.device))
        if err:
            raise RuntimeError(f"baseline K11 launch failed: cudaError {err}")
        return y, ns
    return cascade


def _iq(gen, dev, C, T):
    n = torch.arange(T, device=dev, dtype=torch.float32)
    f = 2.0 + 38.0 * torch.arange(C, device=dev)[:, None] % 97 / 96.0
    z = 0.3 * torch.polar(torch.ones((C, T), device=dev),
                          1.0 + 2 * np.pi * f * n / 24000.0)
    return (z + torch.view_as_complex(torch.randn((C, T, 2), generator=gen,
                                                  device=dev) * 1e-3)
            ).contiguous()


def _report(label, ms, phases, t_b, extra=""):
    mean = {k: float(np.mean(r)) for k, r in ms.items()}
    cost = {ph: mean["whole"] - mean[ph] for ph in phases}
    print(f"{label}: whole {mean['whole']:.4f} ms ("
          + ", ".join(f"{r:.4f}" for r in ms["whole"]) + f"), byte bound "
          f"{t_b:.4f} ({100 * t_b / mean['whole']:.1f}%); without: "
          + ", ".join(f"{ph} {mean[ph]:.4f} (costs {cost[ph]:.4f})"
                      for ph in phases)
          + "".join(f"; {k} {v:.4f}" for k, v in mean.items()
                    if k != "whole" and k not in phases) + extra)
    return dict(whole_ms=mean["whole"], whole_readings=ms["whole"],
                byte_bound_ms=t_b, without_ms={ph: mean[ph] for ph in phases},
                phase_cost_ms=cost,
                other_ms={k: v for k, v in mean.items()
                          if k != "whole" and k not in phases},
                readings={k: r for k, r in ms.items() if k != "whole"})


def trace_pll(gen, dev, base, clock_hz) -> dict:
    libs = build_variants(pll_k.PLL, PLL_VARIANTS)
    for lib in libs.values():
        lib.geometry_checked = True
    pll_k._lib()
    chain = pll_cycle_chain(pll_k.PLL._lib_path())
    print(f"K10 SASS: the fast pair of steps is {chain['instructions']} "
          f"instructions, its longest dependent chain {chain['chain']} "
          f"(cuda/pll.py::PLL_CYCLE_CHAIN = {pll_k.PLL_CYCLE_CHAIN})")
    sp = sam_demod.make_params(24000.0, device=dev)
    p = pll_k.PllScalars(sp.g1, sp.g2, sp.omega_min, sp.omega_max)
    mR, mI = sp.fade.mtauR, sp.fade.mtauI
    result = {"sass": chain}
    for label, audio, C, T in (("k10_flagship", False, 8192, 4096),
                               ("k10_silent_quarter", False, 8192, 4096),
                               ("k9_flagship", True, 8192, 4096),
                               ("k9_silent_quarter", True, 8192, 4096),
                               ("k10_nan_sixteenth", False, 8192, 4096),
                               ("k9_fleet", True, 1024, 4096)):
        z = _iq(gen, dev, C, T)
        cls = torch.arange(C, device=dev) % 16
        if label.endswith("silent_quarter"):
            # channels 8-11 of every 16 silent (exact zeros), as
            # chip_smoke.py's pll_edge_block has them
            z[(cls >= 8) & (cls < 12)] = 0
        if label.endswith("nan_sixteenth"):
            # a NaN at T/4 in channel 14 of every 16 (one a walker warp),
            # as pll_edge_block has it: the channel's phase is NaN from
            # there on
            z[cls == 14, T // 4] = complex(float("nan"), 0.0)
        carry = torch.zeros((5 if audio else 3, C), device=dev)
        if audio:
            def fn():
                return pll_k.pll_audio(p, mR, mI, carry, z)
        else:
            def fn():
                return pll_k.pll(p, carry, z)
        extra = {}
        if base is not None:
            b_pll, b_audio = base
            extra["baseline"] = ((lambda: b_audio(p, mR, mI, carry, z))
                                 if audio else (lambda: b_pll(p, carry, z)))
        use = {k: v for k, v in libs.items()
               if audio or k != "no_fade"}
        ms = turns(use, pll_k.PLL, fn, extra)
        phases = [ph for ph in PLL_PHASES if ph in use]
        t_b = (C * T * (8 + (4 if audio else 8))) / PEAK_BYTES_S * 1e3
        whole = float(np.mean(ms["whole"]))
        cyc = whole * 1e-3 * clock_hz / T
        t_r = T / pll_k.PLL_CYCLE_STEPS * chain["chain"] * FP32_LATENCY \
            / clock_hz * 1e3
        result[label] = _report(
            f"{label} {C} x {T}", ms, phases, t_b,
            f"; {cyc:.1f} cycles a step at the max clock against the "
            f"critical cycle's {chain['chain'] * FP32_LATENCY / 2:.1f} "
            f"(recurrence bound {t_r:.4f} ms)")
        result[label].update(shape=[C, T], cycles_a_step=cyc,
                             recurrence_bound_ms=t_r)
        del z
    return result


def trace_biquad(gen, dev, base) -> dict:
    libs = build_variants(iir_k.BIQUAD, BIQUAD_VARIANTS)
    sam_libs = build_variants(sam_k.SAM_SIDEBAND, SAM_VARIANTS)
    for lib in [*libs.values(), *sam_libs.values()]:
        lib.geometry_checked = True
    iir_k._biquad_lib()
    sam_k._lib()
    sp = sam_demod.make_params(24000.0, device=dev)
    result = {}
    C, T = 16384, 4096
    x = torch.randn((C, T), generator=gen, device=dev) * 0.1
    st = torch.zeros((7, C, 2), device=dev)
    extra = {}
    if base is not None:
        extra["baseline"] = lambda: base(sp.ap_sos[0], st, x)
    ms = turns(libs, iir_k.BIQUAD,
               lambda: iir_k.biquad_cascade(sp.ap_sos[0], st, x), extra)
    t_b = 2 * C * T * 4 / PEAK_BYTES_S * 1e3
    result["k11_sam_stacked"] = _report(
        f"k11 {C} x {T} (7 sections)", ms,
        ["no_stage", "no_store", "walk_alone"], t_b)
    result["k11_sam_stacked"]["shape"] = [C, T]
    del x
    for label, sideband, C in (("sideband_usb", "usb", 8192),
                               ("sideband_stereo_1024", "stereo", 1024)):
        na = 2 if sideband == "stereo" else 1
        z = _iq(gen, dev, C, T)
        ph = torch.rand((C, T), generator=gen, device=dev) * (2 * np.pi)
        cs, sn = ph.cos().contiguous(), ph.sin().contiguous()
        fshape = (C, na) if na == 2 else (C,)
        state = (torch.zeros((4, 7, C, 2), device=dev),
                 torch.zeros((C, 2), device=dev),
                 (torch.zeros(fshape, device=dev),
                  torch.zeros(fshape, device=dev)))
        extra = {}
        if base is not None and sideband == "usb":
            extra["baseline_route"] = lambda: replaced_route(
                sp.ap_sos, sp.fade, *state, z, cs, sn, "usb", True,
                cascade=base)
        ms = turns(sam_libs, sam_k.SAM_SIDEBAND, lambda: sam_k.sam_sideband(
            sp.ap_sos, sp.fade, *state, z, cs, sn, sideband, True), extra)
        t_b = C * T * (8 + 4 + 4 + 4 * na) / PEAK_BYTES_S * 1e3
        result[label] = _report(
            f"{label} {C} x {T}", ms,
            ["no_stage", "no_store", "walk_alone", "no_fade"], t_b)
        result[label]["shape"] = [C, T]
        del z, ph, cs, sn
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--baseline", type=pathlib.Path, nargs="+", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_sam: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    mhz, unit = smi("clocks.max.sm").split()
    clock_hz = float(mhz) * 1e6
    print(f"card: {card}; max SM clock {mhz} {unit}")
    pll_base = bq_base = None
    for path in args.baseline:
        if path.name.startswith("pll"):
            pll_base = pll_baseline(path)
        elif path.name.startswith("biquad"):
            bq_base = biquad_baseline(path)
        else:
            raise SystemExit(f"--baseline {path}: name it pll*.cu or "
                             "biquad*.cu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    result = {"card": card, "pll": trace_pll(gen, dev, pll_base, clock_hz)}
    torch.cuda.empty_cache()
    result["biquad"] = trace_biquad(gen, dev, bq_base)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
