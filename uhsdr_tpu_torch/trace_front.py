"""Where K1's, K15's, K5's, K7's and K6's time goes on the card, phase by
phase, and an earlier front.cu beside them.

    python -m uhsdr_tpu_torch.trace_front [--seed 7] [--baseline FILE]

Builds `kernels/front.cu` as it is and three variants of it, each with one
phase of the tile loop left out: the load (staged planes to rotated
polyphase samples), stage A, stage B (K1's and K15's; K5, K6 and K7,
the same kernel with no stage B, have none).  Times the four through
`cuda.fir.front` (K1), `cuda.fir.front_mt` (K15), `cuda.fir.fir_rt` (K5)
or `cuda.fir.fir_cx` (K7 with the NCO, K6 without; real output, as the
chain takes it), each library in turn in the kernel's place, on the same
inputs (CUDA events, 10 launches after one) at the shapes the port sends
them: K1 and K15 at the SSB flagship (8192 ch x 16384 int16 @ 96 kHz,
decim 8), K15 also at 48 and 192 kHz, K1 at the two-channel
flagship's two stage-B filters, the fleet's f32 planes at 48 kHz (1024
ch, decim 4) and int16 at 192 kHz (8192 ch, decim 16); K5 at the AM/SAM
flagship (8192 ch x 16384 int16 @ 96 kHz, decim 4, 239 taps) and the FM
flagship (decim 2); K7 and K6 at the wide-SSB flagship (8192 ch x 16384
int16 @ 96 kHz, decim 4, 245 complex taps), K7 at 192 kHz (491 taps,
decim 8) and on the 48 kHz wide rows (131 taps at decim 4, 92 at decim
2).  Prints, per shape, each variant's ms and what the left-out phase
costs while the others still run (the whole kernel's time less the
variant's), the rest (the whole less every phase's cost), beside the FMA
bound at the card's published FP32 peak; stage A's share of the whole
and its rate against that peak at the padded taps (the polyphase rows
zero-padded to whole chunks of 8, as the kernel runs them); then one
JSON line.  The variants' outputs are wrong: they only time.  The
variants build into `_build/` beside the kernels.  With --baseline FILE,
an earlier front.cu (`git show b54d623:uhsdr_tpu_torch/kernels/front.cu >
_commit_check/front_parent.cu`: K15 as the one-output-a-thread body,
reached through `uhsdr_front_launch` with the modulated taps' sine part)
is built beside and, at the K1 and K15 shapes, timed in the same turns.
Exits 2 where CUDA is absent.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

import torch

from .chain import rx
from .cuda import build
from .cuda import fir as fir_k

PEAK_FMA_S = 33.5e12        # H100 SXM, FP32 outside the tensor cores / 2
# the loop header of each phase in front.cu and the same loop run 0 times
PHASES = {
    "load": ("for (int j = tid; j * G < tb; j += NT) {",
             "for (int j = tid; j * G < 0; j += NT) {"),
    "stage_a": ("for (int it = tid; it < nob * geo.p; it += NT) {",
                "for (int it = tid; it < 0; it += NT) {"),
    "stage_b": ("for (int it = tid; it < nob * geo.pb; it += NT) {",
                "for (int it = tid; it < 0; it += NT) {"),
}
WIDE = dict(mode="usb", bw_key="5P0KHZ", iq_rate=96000.0)
# (label, config, channels, plane dtype, the kernel: K1, K5, K7 or K6)
SHAPES = (("ssb", dict(mode="usb", iq_rate=96000.0), 8192, torch.int16,
           "K1"),
          ("ssbstereo", dict(mode="ssbstereo", iq_rate=96000.0), 8192,
           torch.int16, "K1"),
          ("fleet_48k_f32", dict(mode="usb", iq_rate=48000.0), 1024,
           torch.float32, "K1"),
          ("usb_192k", dict(mode="usb", iq_rate=192000.0), 8192,
           torch.int16, "K1"),
          ("ssb_k15", dict(mode="usb", iq_rate=96000.0), 8192, torch.int16,
           "K15"),
          ("usb_48k_k15", dict(mode="usb", iq_rate=48000.0), 8192,
           torch.int16, "K15"),
          ("usb_192k_k15", dict(mode="usb", iq_rate=192000.0), 8192,
           torch.int16, "K15"),
          ("sam_k5", dict(mode="sam", bw_key="5P0KHZ", path_name="AM/SAM",
                          iq_rate=96000.0), 8192, torch.int16, "K5"),
          ("fm_k5", dict(mode="fm", bw_key="5P0KHZ", path_name="FM",
                         iq_rate=96000.0), 8192, torch.int16, "K5"),
          ("wide_k7", WIDE, 8192, torch.int16, "K7"),
          ("wide_k6", dict(WIDE, translate_hz=0.0), 8192, torch.int16, "K6"),
          ("wide_192k_k7", dict(WIDE, iq_rate=192000.0), 8192, torch.int16,
           "K7"),
          ("wide_48k_131_k7", dict(WIDE, bw_key="4P0KHZ", iq_rate=48000.0),
           8192, torch.int16, "K7"),
          ("wide_48k_92_k7", dict(WIDE, bw_key="10P0KHZ", iq_rate=48000.0),
           8192, torch.int16, "K7"))
BLOCK = 16384


def build_variants(kernel: build.CudaKernel = fir_k.FRONT,
                   variants: dict | None = None) -> dict:
    """{variant: ctypes library}: the kernel's own library ("whole") and
    one build of its source for each variant, {name: ((text, replacement),
    ...)} (by default K1's: "no_<phase>" for each of `PHASES`, the phase's
    loop header replaced by one that runs 0 times), with the kernel's
    flags, nvcc processes started together, into `_build/trace_<source>/`
    (the source with its own headers written in, so a variant may patch
    them too)."""
    if variants is None:
        variants = {f"no_{ph}": (pair,) for ph, pair in PHASES.items()}
    stem = kernel.source.stem
    src = kernel.source_text()
    out = build.BUILD_DIR / f"trace_{stem}"
    out.mkdir(parents=True, exist_ok=True)
    procs, paths = {}, {}
    for name, pairs in variants.items():
        text = src
        for old, new in pairs:
            if src.count(old) != 1:
                raise RuntimeError(f"{kernel.source.name}: '{old}' is not "
                                   f"there once; update the trace's PHASES")
            text = text.replace(old, new)
        tag = hashlib.sha1((text + " ".join(kernel.flags)).encode()
                           ).hexdigest()
        cu = out / f"{stem}_{name}.cu"
        so = out / f"{stem}_{name}-{tag[:12]}.so"
        paths[name] = so
        if not so.exists():
            cu.write_text(text)
            procs[name] = subprocess.Popen(
                [build.nvcc_path(), *kernel.flags, "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {"whole": kernel.lib()}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    for name, so in paths.items():
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in kernel.signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def shape_inputs(kw: dict, C: int, dtype, dev, gen, kernel: str,
                 base=None):
    """(the launch's callable, its FMAs, stage A's FMAs at the padded
    taps, the earlier library's launch or None) at one shape: K1's
    `front` (K15's `front_mt`); K5's `fir_rt` (NCO on, complex out) where
    the row has real taps and no stage B; K7's or K6's `fir_cx` (with the
    NCO or without it, real out) where its taps are complex.  `base`: an
    earlier front.cu's library, launched for K1 and K15."""
    cfg = rx.RxConfig(**{"bw_key": "2P3KHZ", "path_name": "LPF",
                         "translate_hz": 12000.0, **kw})
    p = rx.make_params(cfg, dev)
    n_keep = rx._raw_history_len(cfg, p)
    x = [(torch.randn((C, BLOCK), generator=gen, device=dev) * 3277.0)
         .round().clamp(-32768, 32767) for _ in range(2)]
    x = [v.to(torch.int16) if dtype == torch.int16 else v / 32768.0
         for v in x]
    carry = (torch.randn((C, n_keep), generator=gen, device=dev) * 0.1
             ).to(torch.complex64)
    phase = torch.randint(0, 2**32, (C,), generator=gen, device=dev)
    taps, T_out = p.front_fir.shape[-1], BLOCK // cfg.decim
    size = 2 if dtype == torch.int16 else 4
    if p.front2 is None:
        fma = C * T_out * 2 * taps
        args = (p.front_fir, carry, *x, cfg.decim)
        if p.front_fir.is_complex():
            ap = fir_k.fir_cx_geometry(taps, cfg.decim, size).ap
            nco = (phase, p.nco_delta) if kernel == "K7" else None
            return ((lambda: fir_k.fir_cx(*args, nco=nco, real_out=True)),
                    fma, C * T_out * 2 * cfg.decim * ap, None)
        ap = fir_k.fir_rt_geometry(taps, cfg.decim, size).ap
        return ((lambda: fir_k.fir_rt(*args, nco=(phase, p.nco_delta))), fma,
                C * T_out * 2 * cfg.decim * ap, None)
    carry2 = (torch.randn((C, p.front2.shape[-1] - 1), generator=gen,
                          device=dev) * 0.1).to(torch.complex64)
    nb = 1 if p.front2.ndim == 1 else 2
    taps2 = p.front2.shape[-1]
    mt = kernel == "K15"
    # K15's stage A: complex taps, 4 FMAs a tap and an output
    fma = C * T_out * ((4 if mt else 2) * taps + 2 * nb * taps2)
    ap = fir_k.front_geometry(taps, taps2, cfg.decim, nb, size, n_keep,
                              cx=mt).ap
    args = (p.front_fir, p.front2, carry, carry2, *x, phase, p.nco_delta,
            cfg.decim)
    old = None
    if base is not None and nb == 1:
        old = baseline_launch(base, mt, *args)
    return ((lambda: (fir_k.front_mt if mt else fir_k.front)(*args)), fma,
            C * T_out * (4 if mt else 2) * cfg.decim * ap, old)


def baseline_launch(lib, mt: bool, h, g, carry, carry2, xi, xq, phase,
                    delta, decim):
    """One launch of an earlier front.cu's K15 (mt, its modulated taps'
    cosine and sine parts as two f32 planes) or K1 through its
    `uhsdr_front_launch` (with the sine-taps argument), with the host
    work of the current wrapper (the stage-B taps split into two planes
    and the outputs allocated each call)."""
    C, B = xi.shape
    hm = fir_k.modulated_taps(h, delta) if mt else None
    ha = hm.real.contiguous() if mt else h
    hs = hm.imag.contiguous() if mt else None

    def launch():
        g_re, g_im = g.real.contiguous(), g.imag.contiguous()
        out = torch.empty((C, B // decim), device=xi.device)
        nc, nc2 = torch.empty_like(carry), torch.empty_like(carry2)
        pk = torch.empty((C,), device=xi.device)
        err = lib.uhsdr_front_launch(
            0 if xi.dtype == torch.int16 else 1, xi.data_ptr(),
            xq.data_ptr(), fir_k.INT16_SCALE if xi.dtype == torch.int16
            else 1.0, C, B, carry.shape[-1], carry.data_ptr(),
            carry2.data_ptr(), phase.data_ptr(),
            int(delta) & 0xffffffff, ha.data_ptr(), h.shape[-1], decim,
            None if hs is None else hs.data_ptr(), g_re.data_ptr(),
            g_im.data_ptr(), g.shape[-1], 1, out.data_ptr(), nc.data_ptr(),
            nc2.data_ptr(), pk.data_ptr(), build.stream_ptr(xi.device))
        if err:
            raise RuntimeError(f"baseline front launch failed: cudaError "
                               f"{err}")
    return launch


def build_baseline(path: pathlib.Path):
    """An earlier front.cu built with the kernel's flags, its
    `uhsdr_front_launch` bound with the sine-taps argument it took."""
    so = build.BUILD_DIR / "trace_front" / f"{path.stem}.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    p = subprocess.run([build.nvcc_path(), *fir_k.FRONT.flags, "-o", str(so),
                        str(path)], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.uhsdr_front_launch.argtypes = [
        I, P, P, ctypes.c_float, I, I, I, P, P, P, ctypes.c_uint32, P, I, I,
        P, P, P, I, I, P, P, P, P, P]
    lib.uhsdr_front_launch.restype = I
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--baseline", type=pathlib.Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_front: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}")
    libs = build_variants()
    base = None if args.baseline is None else build_baseline(args.baseline)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    result = {}
    for label, kw, C, dtype, kernel in SHAPES:
        launch, fma, fma_a, old = shape_inputs(kw, C, dtype, dev, gen,
                                               kernel, base)
        phases = [ph for ph in PHASES
                  if kernel in ("K1", "K15") or ph != "stage_b"]
        names = ["whole"] + [f"no_{ph}" for ph in phases]
        # whole, variants, variants reversed, whole: two readings each;
        # the earlier library's beside the whole's
        ms = {name: [] for name in names + (["baseline"] if old else [])}
        try:
            for name in names + names[::-1]:
                if name == "whole" and old is not None:
                    ms["baseline"].append(cuda_ms(old))
                # fir.front, fir.front_mt, fir.fir_rt and fir.fir_cx
                # launch through the library they find here
                fir_k.FRONT._lib = libs[name]
                ms[name].append(cuda_ms(launch))
        finally:
            fir_k.FRONT._lib = libs["whole"]
        mean = {name: sum(v) / len(v) for name, v in ms.items()}
        bound = fma / PEAK_FMA_S * 1e3
        cost = {ph: mean["whole"] - mean[f"no_{ph}"] for ph in phases}
        rest = mean["whole"] - sum(cost.values())
        # stage A at the padded taps: its share of the whole, and its rate
        # against the FP32 peak
        bound_a = fma_a / PEAK_FMA_S * 1e3
        share_a = cost["stage_a"] / mean["whole"]
        peak_a = bound_a / cost["stage_a"]
        print(f"{label} ({kernel}): {C} ch, whole {mean['whole']:.4f} ms "
              f"({', '.join(f'{v:.4f}' for v in ms['whole'])}), FMA bound "
              f"{bound:.4f} ms; left out: "
              + ", ".join(f"{ph} {mean[f'no_{ph}']:.4f} "
                          f"(costs {cost[ph]:.4f})" for ph in phases)
              + f"; the rest {rest:.4f}; stage A {100 * share_a:.1f}% of "
              f"the whole, {100 * peak_a:.1f}% of the FP32 peak at "
              f"{fma_a / 1e9:.2f} G padded FMA ({bound_a:.4f} ms)"
              + (f"; the earlier front.cu {mean['baseline']:.4f} ms ("
                 + ", ".join(f"{v:.4f}" for v in ms["baseline"]) + ")"
                 if "baseline" in ms else ""))
        result[label] = dict(kernel=kernel, channels=C,
                             whole_ms=mean["whole"], fma_bound_ms=bound,
                             without_ms={ph: mean[f"no_{ph}"]
                                         for ph in phases},
                             phase_cost_ms=cost, rest_ms=rest,
                             stage_a_padded_bound_ms=bound_a,
                             stage_a_share=share_a,
                             stage_a_peak_share=peak_a,
                             baseline_ms=mean.get("baseline"))
    print(json.dumps({"card": card, "phases": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
