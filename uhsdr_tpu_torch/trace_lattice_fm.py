"""Where the lattice's and the FM modulator's time goes on the card.

    python -m uhsdr_tpu_torch.trace_lattice_fm [--seed 7]

Builds `kernels/lattice.cu` and `kernels/fm_mod.cu` as they are and
variants of each (trace_front's `build_variants`), and times them through
the wrappers (`cuda.lattice.lattice`, `cuda.fm_mod.fm_mod`), each library
in turn in the kernel's place, on the same inputs (device time: CUDA
events around a CUDA graph of 20 launches, after one; whole, variants,
variants reversed, whole).

The lattice (IIR_2k3_1k412's 10 stages) at the reference chain's
PreFilter (8192 x 4096) and the FM TX voice lattice's shape (8192 x
16384): other designs walk straight-line blocks of 4, 16 or 32 samples
(the whole's are 8); left out: the stores of y.  The FM modulator at the
TX flagship (8192 x 16384), without and with the subtone plane: left out
in turn are the stores of i and q, the table lookups (k itself stands
in), and the walker's recurrences (k read off x's bits: the ring and the
output warps alone); other designs keep five stages in the ring, or
tiles of 64 samples (a row's reads and writes in 256-byte runs).
Both also with the launch rule sized for twice the SMs (two blocks an
SM, half the lanes a walker).  Printed: each time, its cycles a sample
at the card's maximum SM clock, and its share of the byte bound; from
`cuobjdump -sass` of each lattice library the FP32 adds and products of
`lattice_kernel<10>` beside the schedule's count (6N + 4 a sample over
a block and the one-sample step of a short tile), and all its
instructions.  Then one JSON line.  The variants' outputs are
wrong: they only time.  Exits 2 where CUDA is absent.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

from . import data
from .cuda import build
from .cuda import fm_mod as fm_k
from .cuda import lattice as lat_k
from .mod import modulators as mods
from .trace_alc_interp import turns
from .trace_front import build_variants

PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3

_STORE_Y = "        yt[(size_t)k * T] = pl[(r0 + k) * SS + lane];"
LATTICE_WU = {"whole": 8, "wu4": 4, "wu16": 16, "wu32": 32}
LATTICE_VARIANTS = {
    f"wu{u}": (("constexpr int WU = 8;", f"constexpr int WU = {u};"),)
    for u in (4, 16, 32)}
LATTICE_VARIANTS["no_store"] = (
    (_STORE_Y, "        if (pl[(r0 + k) * SS + lane] == 1e30f) "
               "yt[(size_t)k * T] = 0.f;"),)

_STORE_IQ = ("        io[o + (size_t)i * p.T] = iv * p.amp;\n"
             "        qo[o + (size_t)i * p.T] = qv * p.amp;")
_STEP = ("  b = p.alpha * ((b + xn) - a);\n  a = xn;\n  float pre = b;\n"
         "  if constexpr (ADD) pre = pre + an;\n"
         "  const float r = p.word + pre * p.scale;\n"
         "  const float s = floorf(acc + r);\n"
         "  acc = s - 65536.f * floorf(s * (1.f / 65536.f));\n"
         "  return acc != acc ? -1 : (int)floorf(acc * (1.f / 64.f));")
FM_VARIANTS = {
    "no_store": ((_STORE_IQ, "        if (iv == 1e30f) io[o] = qv;"),),
    "no_lookup": (("          const float2 e = tab[fm_swz(k)];",
                   "          const float2 e = make_float2((float)k, 1.f);"),),
    "no_walk": ((_STEP, "  return __float_as_int(xn + an) & 1023;"),),
    "stages5": (("constexpr int STAGES = 4;", "constexpr int STAGES = 5;"),),
    "ta64": (("constexpr int TA = 32;", "constexpr int TA = 64;"),),
}


def sass_lattice(lib: pathlib.Path, N: int = 10) -> tuple[int, int, dict]:
    """(FADD + FMUL, all instructions, {opcode: count}) of
    `lattice_kernel<N>` in `cuobjdump -sass` of the library."""
    cuobjdump = pathlib.Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    for fn in sass.split("Function : ")[1:]:
        if re.match(rf"\S*lattice_kernelILi{N}E", fn):
            ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_.]+)", fn)
            fp = sum(o.startswith(("FADD", "FMUL")) for o in ops)
            hist = {}
            for o in ops:
                hist[o.split(".")[0]] = hist.get(o.split(".")[0], 0) + 1
            return fp, len(ops), hist
    raise RuntimeError(f"no lattice_kernel<{N}> in {lib}")


def two_blocks(module, fn):
    """fn() with the launch rule sized for twice the SMs (half the lanes a
    walker): two blocks an SM, two walkers a scheduler."""
    def run():
        real = module.sm_count
        module.sm_count = lambda index: 2 * real(index)
        try:
            return fn()
        finally:
            module.sm_count = real
    return run


def report(label, ms, T, nbytes, clock_hz) -> dict:
    mean = {k: float(np.mean(r)) for k, r in ms.items()}
    t_b = nbytes / PEAK_BYTES_S * 1e3
    for k, v in mean.items():
        print(f"{label} {k}: {v:.4f} ms, {v * 1e-3 * clock_hz / T:.1f} "
              f"cycles a sample, {t_b / v:.1%} of the byte bound "
              f"({t_b:.4f} ms)")
    return dict(ms=mean, readings=ms, bound_ms=t_b)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_lattice_fm: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    clock_hz = torch.cuda.get_device_properties(0).clock_rate * 1e3
    result = {"device": torch.cuda.get_device_name(0)}

    libs = build_variants(lat_k.LATTICE, LATTICE_VARIANTS)
    for lib in libs.values():
        lib.geometry_checked = True
    lat_k._lib()
    out = build.BUILD_DIR / "trace_lattice"
    paths = {"whole": lat_k.LATTICE._lib_path()}
    paths.update({n: next(out.glob(f"lattice_{n}-*.so"))
                  for n in LATTICE_VARIANTS})
    sass = {}
    N = 10
    for name, path in paths.items():
        fp, n, hist = sass_lattice(path, N)
        wu = LATTICE_WU.get(name, 8)
        # a block of WU samples and a short tile's one-sample step
        want = (wu + 1) * (6 * N + 4)
        sass[name] = dict(fp32=fp, all=n, schedule_fp32=want, opcodes=hist)
        top = sorted(hist.items(), key=lambda kv: -kv[1])[:12]
        print(f"lattice SASS {name}: lattice_kernel<{N}> {fp} FADD/FMUL "
              f"(the schedule's {want}: {6 * N + 4} a sample over {wu} + "
              f"1), {n} instructions; {top}")
    result["lattice_sass"] = sass
    pk, pv = data.lattice("IIR_2k3_1k412")
    for C, T in ((8192, 4096), (8192, 16384)):
        x = torch.randn((C, T), generator=gen, device=dev) * 1000.0
        s0 = torch.zeros((C, len(pk)), device=dev)
        ms = turns(libs, lat_k.LATTICE,
                   lambda: lat_k.lattice(pk, pv, s0, x),
                   {"two_blocks_an_sm": two_blocks(
                       lat_k, lambda: lat_k.lattice(pk, pv, s0, x))})
        result[f"lattice_{C}x{T}"] = report(
            f"lattice {C} x {T}", ms, T, 2 * C * T * 4 + 2 * C * 40,
            clock_hz)
        del x

    libs = build_variants(fm_k.FM_MOD, FM_VARIANTS)
    for lib in libs.values():
        lib.geometry_checked = True
    fm_k._lib()
    p = mods.fm_mod_params(6000.0, False, 88.5, count_domain=True)
    fa = (mods.FM_TX_HPF_ALPHA, float(p.freq_word), p.mod_scale,
          mods.FM_MOD_AMPLITUDE_SCALING, p.swap_iq)
    C, T = 8192, 16384
    n = torch.arange(T, device=dev, dtype=torch.float32)
    f = 700.0 + 10.0 * (torch.arange(C, device=dev) % 200)
    x = (3000.0 * torch.sin(2 * np.pi / 48000.0 * f[:, None] * n)
         + torch.randn((C, T), generator=gen, device=dev)).contiguous()
    add = 0.01 * torch.sin(2 * np.pi * 88.5 / 48000.0 * n).expand(C, T)
    add = add.contiguous()
    z = torch.zeros((C,), device=dev)
    acc = torch.zeros((C,), dtype=torch.int32, device=dev)
    for label, plane in (("fm_mod", None), ("fm_mod subtone", add)):
        ms = turns(libs, fm_k.FM_MOD,
                   lambda: fm_k.fm_mod(x, plane, z, z, acc, *fa),
                   {"two_blocks_an_sm": two_blocks(
                       fm_k, lambda: fm_k.fm_mod(x, plane, z, z, acc, *fa))})
        planes = 3 if plane is None else 4
        result[label.replace(" ", "_")] = report(
            f"{label} {C} x {T}", ms, T, planes * C * T * 4 + 6 * C * 4,
            clock_hz)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
