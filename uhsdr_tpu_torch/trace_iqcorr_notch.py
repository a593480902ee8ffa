"""Where the IQ correction's and the NLMS notch's time goes on the card.

    python -m uhsdr_tpu_torch.trace_iqcorr_notch [--seed 7]
        [--baseline FILE [FILE ...]]

Builds `kernels/iqcorr.cu` and `kernels/lms.cu` as they are and
variants of each (`IQ_VARIANTS`, `LMS_VARIANTS`: iqcorr's walker without
the one-poles' walk, which is what the walk costs; the NLMS filter on
the generic leak instance, in the other layout of two lanes a channel
and a warp a scheduler, in blocks of 4 warps, with its norms from a
staged window of squares, and more; a variant whose outputs are wrong
only times), and times them through the wrappers (`cuda.iqcorr.iqcorr`,
`cuda.lms.nlms`, `cuda.lms.leaky`) at the SSB flagship's shapes: iqcorr
at 8192 x 16384 int16 and on the f32 edge stream's 8192 x 4096, the
notch (96 taps) and the NLMS NR (64 taps) at the 12 kHz tap's 8192 x
2048, and the leaky NR there, whose kernel shares the body (device time:
CUDA events around a CUDA graph of 20 launches, after one; whole,
variants, variants reversed, whole).  The variants that keep the outputs
are held bit for bit to the whole.  Printed: each time beside its bound
(iqcorr: its bytes; the LMS: the FP32 operations its function needs as
instructions, -fmad=false making an operation an instruction, and those
the kernel issues) and the cycles a step or sub-block at the card's
maximum SM clock; the runtime's blocks an SM; from `cuobjdump -sass` of
the libraries each kernel's opcode counts (FADD/FMUL, shuffles, shared
loads, all) and from `cuobjdump --dump-resource-usage` its registers and
spills.

With --baseline, each file is an earlier source built beside the new
one, timed at its shapes in turns (earlier, new, new, earlier) and held
bit for bit to the new one's outputs: a file named iqcorr*.cu is an
earlier iqcorr.cu (C interface without the alignment flag), one named
lms*.cu an earlier lms.cu (the NLMS kernel as `uhsdr_nlms_launch`, eight
lanes a channel): `git show 868038e:uhsdr_tpu_torch/kernels/iqcorr.cu >
_commit_check/iqcorr_parent.cu` (the same for lms.cu).  Then one JSON
line.  Exits 2 where CUDA is absent.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys

import torch

from .cuda import build
from .cuda import iqcorr as iq_k
from .cuda import lms as lms_k
from .ops import lms as lms_ops
from .trace_alc_interp import build_baseline, smi, turns
from .trace_front import build_variants
from .trace_lms_blanker import audio, sass_counts

C = 8192
T_IQ, T_EDGE, T_LMS = 16384, 4096, 2048
FP32_INSTR_S = 33.5e12     # FP32 instructions a second: 67 TFLOP/s / 2
BYTES_S = 3.35e12

IQ_VARIANTS = {
    # the walker forms c1 and c2 from the sums as they are: no walk
    "no_walk": (("      if (lane == 0) {\n        // the block-cadence",
                 "      if (false) {\n        // the block-cadence"),),
    # a ring of three stages, one chunk in flight past the one summed:
    # 26 KB a block, more blocks an SM, half the copies in flight a block
    "three_stages": (
        ("constexpr int STAGES = 4;", "constexpr int STAGES = 3;"),
        ("constexpr int AHEAD = 2; ", "constexpr int AHEAD = 1; ")),
}
LMS_VARIANTS = {
    "generic_leak": (("  return leak == 1.0f ? lms_launch_taps",
                      "  return false ? lms_launch_taps"),),
    # layout (a): two lanes a channel in blocks of 4 warps of twice the
    # rule's channels, a warp a scheduler (the leaky filter's layout),
    # groups of 4 steps on float4 windows
    "lanes2": (("constexpr int NL_LANES = 4; ",
                "constexpr int NL_LANES = 2; "),
               ("constexpr int NL_WARPS = 8; ",
                "constexpr int NL_WARPS = 4; "),
               ("constexpr int NL_GROUP = 8; ",
                "constexpr int NL_GROUP = 4; "),
               ("  if (cpw < 1 || cpw > NL_MAX_CPW",
                "  cpw *= 2;\n  if (cpw < 1 || cpw > NL_MAX_CPW")),
    # layout (a') in blocks of 4 warps, two an SM where they fit
    "warps4": (("constexpr int NL_WARPS = 8; ",
                "constexpr int NL_WARPS = 4; "),),
    # the NLMS step's division made a product (what div.rn and its
    # branch cost on the chain)
    "no_div": (("    const float f = a.mu * err / nrm[u];",
                "    const float f = a.mu * err * nrm[u];"),),
    # the norms not formed (the squares and their folds left out)
    "no_norm": (("    nrm[u] = lanes_tree(sq) + 1e-9f;",
                 "    nrm[u] = 1.0f + xs[u];"),),
    # the norms' squares read from a window of squares in shared memory,
    # staged once a sample as the leaky filter's (a second window in the
    # NLMS block), not formed from the window of x in registers
    "sq_window": (
        ("  constexpr bool SQ = MODE == LEAKY;",
         "  constexpr bool SQ = true;"),
        ("  const int smem = lk_smem(L, D, cpw, NL_WARPS, 1);",
         "  const int smem = lk_smem(L, D, cpw, NL_WARPS, 2);"),
        ("      sq[g] = v.at(0, g, u) * v.at(0, g, u);",
         "      sq[g] = qv.at(0, g, u);"),
        ("        sq[g] = sq[g] + v.at(k, g, u) * v.at(k, g, u);",
         "        sq[g] = sq[g] + qv.at(k, g, u);"),
        ("  float nrm[G], xn[G];\n#pragma unroll",
         "  float nrm[G], xn[G];\n  Window<P, HV, G> qv;\n"
         "  qv.load(xw + a.warps * a.cpw * a.stride);\n#pragma unroll")),
    # NLMS groups of 4 or 2 steps in place of 8 (the same bits): a half or
    # a quarter of the loop body, the window read two or four times as
    # often
    "group4": (("constexpr int NL_GROUP = 8; ",
                "constexpr int NL_GROUP = 4; "),),
    "group2": (("constexpr int NL_GROUP = 8; ",
                "constexpr int NL_GROUP = 2; "),),
    # the trees' shuffles left out (every filter; wrong outputs): what the
    # exchanges cost
    "no_shfl": (("    s = s + __shfl_xor_sync(FULL, s, off);",
                 "    s = s + s;"),),
}
# the variants whose NLMS outputs are the whole's, bit for bit
LMS_SAME = ("generic_leak", "lanes2", "warps4", "sq_window", "group4",
            "group2")
# the NLMS variants' channels a warp against the rule's
LMS_CPW = {"lanes2": 2}


class Trusted(set):
    """A variant library's layout checks taken as made: its layout is its
    own."""

    def __contains__(self, key) -> bool:
        return True


def same(a, b) -> bool:
    """Bit for bit, a NaN matching a NaN; bool leaves equal."""
    return all(bool((x == y).all()) if x.dtype == torch.bool else bool(
        ((x.view(torch.int32) == y.view(torch.int32))
         | (x.isnan() & y.isnan())).all()) for x, y in zip(a, b))


def iqcorr_baseline(path: pathlib.Path):
    """An earlier iqcorr.cu: returns launch(t1, t2, t3, i, q) -> its
    outputs, as `iq_k.iqcorr`'s."""
    lib = build_baseline(path, iq_k.IQCORR)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.uhsdr_iqcorr_launch.argtypes = [I] + [P] * 5 + [I] * 2 + [P] * 9
    lib.uhsdr_iqcorr_launch.restype = I

    def launch(t1, t2, t3, i, q):
        Cx, Tx = i.shape
        io, qo = (torch.empty((Cx, Tx), device=i.device) for _ in range(2))
        out = [torch.empty((Cx,), device=i.device) for _ in range(5)]
        twin = torch.empty((Cx,), dtype=torch.bool, device=i.device)
        err = lib.uhsdr_iqcorr_launch(
            int(i.dtype == torch.int16), i.data_ptr(), q.data_ptr(),
            t1.data_ptr(), t2.data_ptr(), t3.data_ptr(), Cx, Tx,
            io.data_ptr(), qo.data_ptr(), *(o.data_ptr() for o in out),
            twin.data_ptr(), build.stream_ptr(i.device))
        if err:
            raise RuntimeError(f"baseline iqcorr launch failed: {err}")
        return (io, qo, *out, twin)
    return launch


def lms_baseline(path: pathlib.Path):
    """An earlier lms.cu: returns (nlms(params, w, hist, x), leaky(params,
    w, hist, lidx, ngamma, x)), as `lms_k.nlms`'s and `lms_k.leaky`'s."""
    lib = build_baseline(path, lms_k.LMS)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.uhsdr_nlms_launch.argtypes = [I] * 5 + [P] * 3 + [F] * 2 + [P] * 4
    lib.uhsdr_nlms_launch.restype = I
    lib.uhsdr_lms_leaky_launch.argtypes = \
        lms_k.LMS.signatures["uhsdr_lms_leaky_launch"][0]
    lib.uhsdr_lms_leaky_launch.restype = I

    def nlms(p, w, hist, x):
        Cx, Tx = x.shape
        y, w_out, h_out = (torch.empty_like(x), torch.empty_like(w),
                           torch.empty_like(hist))
        err = lib.uhsdr_nlms_launch(
            int(bool(p.output_error)), p.num_taps, p.delay, Cx, Tx,
            w.data_ptr(), hist.data_ptr(), x.data_ptr(), p.mu, p.leak,
            y.data_ptr(), w_out.data_ptr(), h_out.data_ptr(),
            build.stream_ptr(x.device))
        if err:
            raise RuntimeError(f"baseline NLMS launch failed: {err}")
        return y, w_out, h_out

    def leaky(p, w, hist, lidx, ngamma, x):
        Cx, Tx = x.shape
        geo = lms_k.leaky_geometry(Cx, Tx, p.num_taps, p.delay)
        out = [torch.empty_like(v) for v in (x, w, hist, lidx, ngamma)]
        err = lib.uhsdr_lms_leaky_launch(
            int(bool(p.output_error)), p.num_taps, p.delay, Cx, Tx, geo.cpw,
            int(Tx % 4 == 0), w.data_ptr(), hist.data_ptr(), x.data_ptr(),
            lidx.data_ptr(), ngamma.data_ptr(), p.two_mu, p.gamma,
            p.lidx_min, p.lidx_max, p.den_mult, p.lincr, p.ldecr,
            *(o.data_ptr() for o in out), build.stream_ptr(x.device))
        if err:
            raise RuntimeError(f"baseline leaky launch failed: {err}")
        return tuple(out)
    return nlms, leaky


def report(label, ms, bound_ms, per, unit, clock_hz, by) -> dict:
    """Print and return the readings' means beside the bound, and the
    cycles the whole takes for each of its `per` `unit`s."""
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    line = f"  {label}: " + ", ".join(
        f"{k} {mean[k]:.4f} ({', '.join(f'{r:.4f}' for r in v)})"
        for k, v in ms.items())
    cyc = mean["whole"] * 1e-3 * clock_hz / per
    print(line + f"; {by} {bound_ms:.4f} ms ({bound_ms / mean['whole']:.1%}"
          f" of it), {cyc:.1f} cycles a {unit}")
    return dict(ms=mean, readings=ms, bound_ms=bound_ms, bound_by=by,
                cycles=cyc)


def iq_planes(gen, dev, T, int16: bool):
    """Imbalanced IQ planes (gain 1.07, phase 0.06) at about -20 dBFS."""
    i = torch.randn((C, T), generator=gen, device=dev) * 0.1
    q = torch.randn((C, T), generator=gen, device=dev) * 0.1 + 0.06 * i
    i = i * 1.07
    if int16:
        return tuple((v * 32768).round().clamp(-32768, 32767)
                     .to(torch.int16) for v in (i, q))
    return i.contiguous(), q.contiguous()


def lms_case(p, dev, x):
    """The inputs and the wrapper call of an LMS instance at (C, T_LMS)."""
    L, D = p.num_taps, p.delay
    w = torch.zeros((C, L), device=dev)
    h = torch.zeros((C, L + D), device=dev)
    if hasattr(p, "two_mu"):
        lv = torch.full((C,), 120.0, device=dev)
        gm = torch.full((C,), 0.001, device=dev)
        return (w, h, lv, gm), lambda: lms_k.leaky(p, w, h, lv, gm, x)
    return (w, h), lambda: lms_k.nlms(p, w, h, x)


def with_lib(lib, fn):
    """fn() with `lib` in the LMS kernel's place."""
    def run():
        saved = lms_k.LMS._lib
        lms_k.LMS._lib = lib
        try:
            return fn()
        finally:
            lms_k.LMS._lib = saved
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--baseline", type=pathlib.Path, nargs="+", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_iqcorr_notch: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    clock_hz = torch.cuda.get_device_properties(0).clock_rate * 1e3
    card = smi("name,power.limit")
    print(f"trace_iqcorr_notch on {card}")
    result = {"device": torch.cuda.get_device_name(0), "card": card}
    iq_base = nlms_base = leaky_base = None
    for path in args.baseline:
        if path.name.startswith("iqcorr"):
            iq_base = iqcorr_baseline(path)
        elif path.name.startswith("lms"):
            nlms_base, leaky_base = lms_baseline(path)
        else:
            raise SystemExit(f"--baseline {path}: name it iqcorr*.cu or "
                             f"lms*.cu")

    # SASS and registers
    iq_k._lib()
    lms_k.LMS.lib()
    iq_libs = build_variants(iq_k.IQCORR, IQ_VARIANTS)
    for name, lib in iq_libs.items():
        if name != "whole":     # a variant's layout is its own
            lib.layout_checked = True
    lms_libs = build_variants(lms_k.LMS, LMS_VARIANTS)
    for name, lib in lms_libs.items():
        if name != "whole":
            lib.checked = Trusted()
    iq_lib, lms_lib = iq_k.IQCORR._lib_path(), lms_k.LMS._lib_path()
    lanes2_lib = pathlib.Path(lms_libs["lanes2"]._name)
    sass = {}
    for name, lib, pat in (
            ("iqcorr<int16>", iq_lib, r"\S*iqcorr_kernelIsE"),
            ("iqcorr<f32>", iq_lib, r"\S*iqcorr_kernelIfE"),
            ("notch<12, 2>", lanes2_lib, r"\S*lms_kernelILi12ELi2ELi1E"),
            ("notch<12, 4>", lms_lib, r"\S*lms_kernelILi12ELi4ELi1E"),
            ("nlms<12, 4>", lms_lib, r"\S*lms_kernelILi12ELi4ELi0E"),
            ("leaky<8>", lms_lib, r"\S*lms_kernelILi8ELi2ELi2E")):
        sass[name] = sass_counts(lib, pat)
        top = list(sass[name]["opcodes"].items())[:12]
        print(f"SASS {name}: {sass[name]['all']} instructions, "
              f"{sass[name]['fp32']} FADD/FMUL, {sass[name]['shfl']} SHFL, "
              f"{sass[name]['lds']} LDS; {top}")
    usage = {**build.resource_usage(iq_lib), **build.resource_usage(lms_lib)}
    for fn, u in usage.items():
        print(f"registers {fn}: {u}")
    result["sass"] = sass
    result["resources"] = usage

    # the IQ correction: int16 at the flagship, the f32 edge stream's shape
    for label, T, i16 in (("iqcorr int16", T_IQ, True),
                          ("iqcorr f32", T_EDGE, False)):
        i, q = iq_planes(gen, dev, T, i16)
        z = torch.zeros((C,), device=dev)
        run = lambda: iq_k.iqcorr(z, z, z, i, q)  # noqa: E731
        extra = {}
        if iq_base is not None:
            base = lambda: iq_base(z, z, z, i, q)  # noqa: E731
            check = same(run(), base())
            print(f"  {label}: the earlier body's outputs bit-equal: {check}")
            if not check:
                raise SystemExit(f"{label}: the earlier body differs")
            extra["baseline"] = base
        ms = turns(iq_libs, iq_k.IQCORR, run, extra)
        nbytes = 2 * C * T * (2 if i16 else 4) + 2 * C * T * 4 + 5 * C * 8
        geo = iq_k.iqcorr_geometry(C, T, i16)
        result[label.replace(" ", "_")] = r = report(
            f"{label} at {C} x {T}", ms, 1e3 * nbytes / BYTES_S,
            C * (T // iq_k.SUBBLOCK) / build.sm_count(0),
            "sub-block of an SM", clock_hz, "bytes")
        r["walk_ms"] = r["ms"]["whole"] - r["ms"]["no_walk"]
        r["rule"] = geo._asdict()
        r["occupancy"] = {k: lib.uhsdr_iqcorr_occupancy(int(i16))
                          for k, lib in iq_libs.items()}
        print(f"    the walk costs {r['walk_ms']:.4f} ms; {geo}; the "
              f"runtime's blocks an SM: {r['occupancy']}")
        del i, q

    # the LMS: the notch, the NLMS NR and the leaky NR
    x = audio(gen, dev, False)
    for kind, p in (("notch", lms_ops.notch_params()),
                    ("nlms_nr", lms_ops.nr_params()),
                    ("leaky", lms_ops.leaky_lms_params())):
        L, D = p.num_taps, p.delay
        leaky = kind == "leaky"
        st, run = lms_case(p, dev, x)
        extra = {}
        if not leaky:
            want = run()
            for name in LMS_SAME:
                check = same(want, with_lib(lms_libs[name], run)())
                print(f"  {kind}: {name} bit-equal: {check}")
                if not check:
                    raise SystemExit(f"{kind}: {name} differs")
        base = None
        if leaky and leaky_base is not None:
            base = lambda: leaky_base(p, *st, x)  # noqa: E731
        elif not leaky and nlms_base is not None:
            base = lambda: nlms_base(p, *st, x)  # noqa: E731
        if base is not None:
            check = same(run(), base())
            print(f"  {kind}: the earlier body's outputs bit-equal: {check}")
            if not check:
                raise SystemExit(f"{kind}: the earlier body differs")
            extra["baseline"] = base
        ms = turns(lms_libs, lms_k.LMS, run, extra)
        # FP32 operations a sample: what the function needs and, for the
        # NLMS, what the kernel issues (`cuda/lms.py`)
        ops = lms_k.leaky_ops(L) if leaky else lms_k.nlms_ops(L, p.leak)
        issued = ops if leaky else lms_k.nlms_issued_ops(L, p.leak)
        result[kind] = r = report(
            f"{kind} ({L} taps) at {C} x {T_LMS}", ms,
            1e3 * C * T_LMS * ops / FP32_INSTR_S, T_LMS, "step", clock_hz,
            "issue floor")
        r["issue_floor_issued_ms"] = 1e3 * C * T_LMS * issued / FP32_INSTR_S
        geo = (lms_k.leaky_geometry(C, T_LMS, L, D) if leaky
               else lms_k.nlms_geometry(C, T_LMS, L, D))
        r["rule"] = geo._asdict()
        mode = 2 if leaky else int(p.leak == 1.0)
        r["occupancy"] = {
            name: lms_libs[name].uhsdr_lms_occupancy(
                L, mode, D, geo.cpw * LMS_CPW.get(name, 1))
            for name in (("whole",) if leaky else ("whole", "lanes2",
                                                    "warps4"))}
        print(f"    the kernel's issue floor ({issued:.0f} operations a "
              f"sample) {r['issue_floor_issued_ms']:.4f} ms; {geo}; the "
              f"runtime's blocks an SM: {r['occupancy']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
