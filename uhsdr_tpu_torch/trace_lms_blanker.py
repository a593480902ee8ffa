"""Where the leaky LMS's and the noise blanker's time goes on the card.

    python -m uhsdr_tpu_torch.trace_lms_blanker [--seed 7]
        [--baseline FILE [FILE ...]]

Builds `kernels/lms.cu` and `kernels/blanker.cu` as they are, variants
of lms.cu whose leaky steps form only the lidx walk's outcome the test
picks (the compiler's own choice: fewer instructions, a longer chain) or
update the weights independently of the step's chain (what the chain
costs), and one of the blanker with its repairs left out (no slot runs),
and times them through the wrappers (the variants' outputs are wrong:
they only time)
(`cuda.lms.leaky`, `cuda.lms.nlms`, `cuda.blanker.blanker`) at the SSB
flagship's 12 kHz tap, 8192 x 2048: the leaky NR (64 taps) and its
96-tap instance, the NLMS notch (96 taps), the blanker on impulsive audio
(impulses every 97 samples and at the frames' edges) and on audio
without impulses (device time: CUDA events around a CUDA graph of 20
launches, after one; whole, variants, variants reversed, whole).  Each
kernel also with its launch rule sized for twice the SMs: eight channels
a warp, two warps a scheduler.  Printed: each time beside its FP32 issue floor
(-fmad=false: an instruction a FLOP; the blanker's: its byte bound)
and the cycles a step or frame at
the card's maximum SM clock; from `cuobjdump -sass` of the library each
kernel's opcode counts (FADD/FMUL, shuffles, shared loads, all) and from
`cuobjdump --dump-resource-usage` its registers and spills; and the
blanker's cycles a frame by phase (staging, R, Levinson, the two
filters, the statistics, the candidates, the repairs, the outputs), read
by clock64 in warp 0 of block 0 of a copy of blanker.cu built with the
marks written in.

With --baseline, each file is an earlier source built beside the new
one and timed at every shape in turns (earlier, new, new, earlier) and
held bit for bit to the new one's outputs: a file named lms*.cu is the
first lms.cu (eight lanes a channel for both filters, its C interface
`uhsdr_lms_launch`), one named blanker*.cu the first blanker.cu (a warp
a channel, `uhsdr_blanker_launch` without the channels a warp): `git
show 27cbe8b:uhsdr_tpu_torch/kernels/lms.cu > _commit_check/lms_parent.cu`
(the same for blanker.cu).  Then one JSON
line.  Exits 2 where CUDA is absent.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import re
import subprocess
import sys

import torch

from .cuda import blanker as nb_k
from .cuda import build
from .cuda import lms as lms_k
from .nr import blanker as nb_mod
from .ops import lms as lms_ops
from .trace_alc_interp import build_baseline, smi, turns
from .trace_front import build_variants

C, T = 8192, 2048
FP32_INSTR_S = 33.5e12     # FP32 instructions a second: 67 TFLOP/s / 2

LMS_VARIANTS = {
    "merged": (('    asm("" : "+f"(gu), "+f"(gd), "+f"(cu), "+f"(cd));\n',
                ""),),
    # the update made independent of the step's chain (1 - 2mu ngamma a
    # constant, c1 = inv): what the chain costs
    "chain_free": (("    c0 = up ? cu : cd;", "    c0 = 1.0f - tmu * a.den;"),
                   ("    const float c1 = te * inv[u];",
                    "    const float c1 = inv[u];")),
}
NB_VARIANTS = {
    "no_repairs": (
        ("  const int kmax = __reduce_max_sync(FULL, mine ? nsl : 0);",
         "  const int kmax = 0 * __reduce_max_sync(FULL, nsl);"),),
}


def sass_counts(lib: pathlib.Path, pattern: str) -> dict:
    """{opcode: count} and totals of the function of `lib` whose mangled
    name matches `pattern`, from `cuobjdump -sass`."""
    cuobjdump = pathlib.Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    for fn in sass.split("Function : ")[1:]:
        if re.match(pattern, fn):
            ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_.]+)", fn)
            hist = {}
            for o in ops:
                hist[o.split(".")[0]] = hist.get(o.split(".")[0], 0) + 1
            return dict(all=len(ops),
                        fp32=hist.get("FADD", 0) + hist.get("FMUL", 0),
                        shfl=hist.get("SHFL", 0), lds=hist.get("LDS", 0),
                        opcodes=dict(sorted(hist.items(),
                                            key=lambda kv: -kv[1])))
    raise RuntimeError(f"no function {pattern} in {lib}")


# where blanker.cu's phases end, in order (a mark after each)
NB_PHASES = (("stage", "    if (f + 1 < nfr) stage(f + 1, Bn);\n", False),
             ("R", "        R[i] = R[i] + __shfl_xor_sync(FULL, R[i], 1);\n"
                   "    }\n", False),
             ("levinson", "    // ---- whitening", True),
             ("whiten", "    // ---- the matched filter", True),
             ("matched", "    float mean;\n", True),
             ("stats", "    // ---- candidates", True),
             ("candidates", "    // ---- the repairs", True),
             ("repairs", "    // ---- out:", True),
             ("out", "      yq += T;\n    }\n  }\n", None))
_MARKS = """__device__ unsigned long long g_marks[16];
__device__ unsigned long long g_tlast;
#define MARK(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) { \\
  unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t_) :: "memory"); \\
  g_marks[i] += t_ - g_tlast; g_tlast = t_; } } while (0)
"""


def blanker_phases(mult, ctx, x) -> dict:
    """Cycles a frame of each blanker phase in warp 0 of block 0: a copy of
    blanker.cu with a clock64 mark after each phase (NB_PHASES), one launch
    on (ctx, x) after one to warm up."""
    src = nb_k.BLANKER.source_text()
    for i, (_, text, before) in enumerate(NB_PHASES):
        if src.count(text) != 1:
            raise RuntimeError(f"blanker.cu: '{text}' is not there once")
        if before is True:
            src = src.replace(text, f"    MARK({i});\n" + text)
        elif before is False:
            src = src.replace(text, text + f"    MARK({i});\n")
        else:
            src = src.replace(text, text[:-4] + f"    MARK({i});\n  }}\n")
    src = src.replace("namespace {\n", "namespace {\n" + _MARKS, 1)
    src = src.replace("  stage(0, Bw0);\n",
                      "  stage(0, Bw0);\n  if (blockIdx.x == 0 && threadIdx.x "
                      "== 0) g_tlast = clock64();\n")
    src += ('extern "C" int marks_read(unsigned long long* out) { return '
            '(int)cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks)); }\n'
            'extern "C" int marks_zero() { unsigned long long z[16] = {0}; '
            'return (int)cudaMemcpyToSymbol(g_marks, z, sizeof(z)); }\n')
    out = build.BUILD_DIR / "trace_lms_blanker"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "blanker_marks.cu"
    cu.write_text(src)
    lib = build_baseline(cu, nb_k.BLANKER)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.uhsdr_blanker_launch.argtypes = [P, P, I, I, I, F, P, P, P]
    C_, T_ = x.shape
    cpw = nb_k.blanker_geometry(C_, T_).cpw
    y, c = torch.empty_like(x), torch.empty_like(ctx)
    marks = (ctypes.c_ulonglong * 16)()
    for _ in range(2):
        lib.marks_zero()
        err = lib.uhsdr_blanker_launch(
            x.data_ptr(), ctx.data_ptr(), C_, T_, cpw, mult, y.data_ptr(),
            c.data_ptr(), build.stream_ptr(x.device))
        if err:
            raise RuntimeError(f"marked blanker launch failed: {err}")
        torch.cuda.synchronize()
    lib.marks_read(marks)
    frames = T_ // nb_k.FRAME
    return {name: marks[i] / frames for i, (name, _, _) in
            enumerate(NB_PHASES)}


def lms_baseline(path: pathlib.Path):
    """The first lms.cu: returns launch(leaky, params, w, hist, x, lidx,
    ngamma) -> its outputs."""
    lib = build_baseline(path, lms_k.LMS)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.uhsdr_lms_launch.argtypes = [I] * 6 + [P] * 5 + [F] * 8 + [P] * 6
    lib.uhsdr_lms_launch.restype = I

    def launch(leaky, p, w, hist, x, lidx=None, ngamma=None):
        Cx, Tx = x.shape
        y, w_out, h_out = (torch.empty_like(x), torch.empty_like(w),
                           torch.empty_like(hist))
        l_out = torch.empty((Cx,), device=x.device)
        g_out = torch.empty_like(l_out)
        if leaky:
            f = (p.two_mu, p.gamma, p.lidx_min, p.lidx_max, p.den_mult,
                 p.lincr, p.ldecr, 0.0)
            sl = (lidx.data_ptr(), ngamma.data_ptr())
        else:
            f = (p.mu, p.leak) + (0.0,) * 6
            sl = (None, None)
        err = lib.uhsdr_lms_launch(
            int(leaky), int(bool(p.output_error)), p.num_taps, p.delay, Cx,
            Tx, w.data_ptr(), hist.data_ptr(), x.data_ptr(), *sl, *f,
            y.data_ptr(), w_out.data_ptr(), h_out.data_ptr(),
            l_out.data_ptr(), g_out.data_ptr(), build.stream_ptr(x.device))
        if err:
            raise RuntimeError(f"baseline LMS launch failed: cudaError {err}")
        return ((y, w_out, h_out, l_out, g_out) if leaky
                else (y, w_out, h_out))
    return launch


def blanker_baseline(path: pathlib.Path):
    """The first blanker.cu: returns launch(mult, ctx, x) -> (y, ctx)."""
    lib = build_baseline(path, nb_k.BLANKER)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.uhsdr_blanker_launch.argtypes = [P, P, I, I, F, P, P, P]
    lib.uhsdr_blanker_launch.restype = I

    def launch(mult, ctx, x):
        y, c = torch.empty_like(x), torch.empty_like(ctx)
        err = lib.uhsdr_blanker_launch(
            x.data_ptr(), ctx.data_ptr(), x.shape[0], x.shape[1], mult,
            y.data_ptr(), c.data_ptr(), build.stream_ptr(x.device))
        if err:
            raise RuntimeError(f"baseline blanker launch failed: "
                               f"cudaError {err}")
        return y, c
    return launch


def audio(gen, dev, impulses: bool) -> torch.Tensor:
    """8192 x 2048 at 12 kHz: a gated tone and noise a channel, with
    `impulses` impulses of 4-9 every 97 samples and at frame edges."""
    n = torch.arange(T, device=dev, dtype=torch.float64)
    c = torch.arange(C, device=dev, dtype=torch.float64)[:, None]
    x = (0.3 * torch.sin(2 * math.pi * (700.0 + 3.0 * (c % 50)) / 12000.0
                         * n) * (1.0 + (c % 7)))
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


def same(a, b) -> bool:
    """Bit for bit, a NaN matching a NaN."""
    return all(bool(((x.view(torch.int32) == y.view(torch.int32))
                     | (x.isnan() & y.isnan())).all()) for x, y in zip(a, b))


def two_warps(module, fn):
    """fn() with the module's launch rule sized for twice the SMs: half
    the channels a warp, two warps a scheduler."""
    def run():
        saved = module.sm_count
        module.sm_count = lambda index: 2 * saved(index)
        try:
            return fn()
        finally:
            module.sm_count = saved
    return run


def report(label, ms, bound_ms, per, clock_hz) -> dict:
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    line = f"  {label}: " + ", ".join(
        f"{k} {mean[k]:.4f} ({', '.join(f'{r:.4f}' for r in v)})"
        for k, v in ms.items())
    whole = mean["whole"]
    cyc = whole * 1e-3 * clock_hz / per
    print(line + f"; floor {bound_ms:.4f} ms, "
          f"{cyc:.1f} cycles a {'frame' if per < T else 'step'}")
    return dict(ms=mean, readings=ms, floor_ms=bound_ms, cycles=cyc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--baseline", type=pathlib.Path, nargs="+", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_lms_blanker: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    clock_hz = torch.cuda.get_device_properties(0).clock_rate * 1e3
    card = smi("name,power.limit")
    print(f"trace_lms_blanker on {card}")
    result = {"device": torch.cuda.get_device_name(0), "card": card}
    lms_base = nb_base = None
    for path in args.baseline:
        if path.name.startswith("lms"):
            lms_base = lms_baseline(path)
        elif path.name.startswith("blanker"):
            nb_base = blanker_baseline(path)
        else:
            raise SystemExit(f"--baseline {path}: name it lms*.cu or "
                             f"blanker*.cu")

    # SASS and registers
    lms_lib = lms_k.LMS._lib_path()
    lms_k.LMS.lib()
    nb_k.BLANKER.lib()
    lms_libs = build_variants(lms_k.LMS, LMS_VARIANTS)
    libs = build_variants(nb_k.BLANKER, NB_VARIANTS)
    nb_lib = nb_k.BLANKER._lib_path()
    sass = {}
    for name, lib, pat in (
            ("leaky<8>", lms_lib, r"\S*lms_kernelILi8ELi2ELi2E"),
            ("leaky<12>", lms_lib, r"\S*lms_kernelILi12ELi2ELi2E"),
            ("notch<12>", lms_lib, r"\S*lms_kernelILi12ELi%dELi1E"
             % lms_k.NLMS_LANES),
            ("blanker", nb_lib, r"\S*blanker_kernel")):
        sass[name] = sass_counts(lib, pat)
        top = list(sass[name]["opcodes"].items())[:12]
        print(f"SASS {name}: {sass[name]['all']} instructions, "
              f"{sass[name]['fp32']} FADD/FMUL, {sass[name]['shfl']} SHFL, "
              f"{sass[name]['lds']} LDS; {top}")
    usage = {**build.resource_usage(lms_lib), **build.resource_usage(nb_lib)}
    for fn, u in usage.items():
        print(f"registers {fn}: {u}")
    result["sass"] = sass
    result["resources"] = usage

    # the LMS instances
    x = audio(gen, dev, False)
    for kind, p in (("leaky", lms_ops.leaky_lms_params()),
                    ("leaky96", lms_ops.leaky_lms_params(num_taps=96)),
                    ("notch", lms_ops.notch_params())):
        L, D = p.num_taps, p.delay
        leaky = kind.startswith("leaky")
        w = torch.zeros((C, L), device=dev)
        h = torch.zeros((C, L + D), device=dev)
        lv = torch.full((C,), 120.0, device=dev)
        gm = torch.full((C,), 0.001, device=dev)
        if leaky:
            run = lambda: lms_k.leaky(p, w, h, lv, gm, x)  # noqa: E731
            base = (lambda: lms_base(True, p, w, h, x, lv, gm)) \
                if lms_base else None
        else:
            run = lambda: lms_k.nlms(p, w, h, x)  # noqa: E731
            base = (lambda: lms_base(False, p, w, h, x)) if lms_base else None
        extra = {"two_warps": two_warps(lms_k, run)} if leaky else {}
        if base is not None:
            check = same(run(), base())
            print(f"  {kind}: the earlier body's outputs bit-equal: {check}")
            if not check:
                raise SystemExit(f"{kind}: the earlier body differs")
            extra["baseline"] = base
        ms = turns(lms_libs, lms_k.LMS, run, extra)
        flops = C * T * (7.0 * L + (30.0 if leaky else 10.0))
        result[kind] = report(f"{kind} ({L} taps) at {C} x {T}", ms,
                              1e3 * flops / FP32_INSTR_S, T, clock_hz)
    del x

    # the blanker
    mult = nb_mod.make_params(8).threshold_mult
    c0 = torch.zeros((C, nb_k.CONTEXT), device=dev)
    nb_k._lib(nb_k.blanker_geometry(C, T).cpw)
    for lib in libs.values():
        lib.layout_checked = {16, 8}
    for label, imp in (("impulsive", True), ("quiet", False)):
        x = audio(gen, dev, imp)
        run = lambda: nb_k.blanker(mult, c0, x)  # noqa: E731
        extra = {"two_warps": two_warps(nb_k, run)}
        if nb_base is not None:
            base = lambda: nb_base(mult, c0, x)  # noqa: E731
            check = same(run(), base())
            print(f"  blanker {label}: the earlier body's outputs "
                  f"bit-equal: {check}")
            if not check:
                raise SystemExit(f"blanker {label}: the earlier body differs")
            extra["baseline"] = base
        ms = turns(libs, nb_k.BLANKER, run, extra)
        result[f"blanker_{label}"] = report(
            f"blanker {label} at {C} x {T}", ms,
            1e3 * 2 * C * T * 4 / 3.35e12, T // nb_k.FRAME, clock_hz)
        ph = blanker_phases(mult, c0, x)
        print(f"  blanker {label}, cycles a frame by phase: "
              + ", ".join(f"{k} {v:.0f}" for k, v in ph.items())
              + f"; all {sum(ph.values()):.0f}")
        result[f"blanker_{label}"]["phase_cycles"] = ph
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
