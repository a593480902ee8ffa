"""Where the time of the port's main path goes on the card.

    python -m uhsdr_tpu_torch.trace_rx [--mode usb|am|sam|fm|wide|ssbstereo
                                               |ssb_opts|ssb_leaky|ssb_scipy
                                               |decode|refchain|fleet
                                               |fleet_separate|wideband
                                               |sharded]
                                       [--sideband both|usb|lsb|stereo]
                                       [--group-channels 1024] [--warm 2]
                                       [--seed 7]

Drives `chain.rx.RxChain` on cuda:0 at the flagship SSB config (usb
2P3KHZ, 12 kHz translate, 8192 channels of int16 IQ @ 96 kHz,
16384-sample blocks) or, with ``--mode am`` / ``--mode sam``, at the
AM/SAM flagship (5P0KHZ AM/SAM path, same channel count, rate and
block), ``--mode fm`` at the FM flagship (5P0KHZ FM path), ``--mode
wide`` at the wide-SSB flagship (usb 5P0KHZ, one complex-tap front) and
``--mode ssbstereo`` at the two-channel flagship (the SSB flagship's row,
both sidebands, the linked stereo AGC), ``--mode ssb_opts`` at the SSB
flagship with the RX options IQ correction, notch, blanker and NR on,
``--mode ssb_leaky`` with the leaky LMS, ``--mode ssb_scipy`` on the
legacy redesigned front (`rx.SCIPY_FLAGSHIP`), ``--mode decode`` the SSB
flagship with the scope (magnify 0) on its ``spectrum_iq`` tap and the
decoder tap (`modems.tap.DecoderTap`: CW, PSK63, RTTY) on its
``audio_dec`` tap, ``--mode refchain`` the
reference chain `chain.refchain.RefRxChain` at `REF_FLAGSHIP` (usb 2P3KHZ
select 2, the same channels and block of f32 planes @ 48 kHz); ``--mode
fleet`` drives
`parallel.fleet.ChannelFleet` at its mixed-mode deployment (FLEET_MIX:
six groups of 1024 channels of f32 planes @ 48 kHz) through its
stage-batched step, ``--mode fleet_separate`` the same through each
group's chain, ``--mode wideband`` `WidebandFleet` at WIDEBAND_MIX (16.8 M
wideband samples a block, 4096 channels), ``--mode sharded`` the sharded
RX step (`parallel.rx_sharded.make_sharded_rx(rx.FLAGSHIP)`) on a 1 x 1
mesh in a process group of one rank (NCCL), on the flagship's planes as
f32 (counts / 32768); ``--group-channels`` sets a
fleet group's width.  Each runs ``--warm`` (2) warm-up, 4 untraced and 4
traced blocks and prints, per block:

* the step time with tracing off (CUDA events around the timed blocks)
  and the host's enqueue time (wall clock of the calls, no sync), with
  what can hold the host in it: the caching allocator's device
  allocations and frees over those blocks (each a cudaMalloc/cudaFree,
  which waits for the card) and the calls PyTorch reports as
  synchronising (`torch.cuda.set_sync_debug_mode`) in one more block;
* under `torch.profiler` (CUPTI), the device time of every kernel by
  name, the device's busy share of the traced window (union of kernel
  intervals over first-start..last-end) and the step time with tracing
  on, whose difference from the untraced one is the tracing overhead.

Inputs are a seeded int16 tone-plus-noise capture made on the card
(`capture`, which chip_smoke.py drives the main path with too).
Exits 2 where CUDA is absent.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time
import warnings
from collections import defaultdict

import torch

from .chain import refchain, rx
from .parallel import fleet

TONE_HZ = 700.0      # channel 0's audio tone
FM_TONE_HZ = 1000.0  # channel 0's audio tone in FM configs
FM_DEVIATION_HZ = 2000.0
SUBTONE_DEVIATION_HZ = 300.0
BLOCKS = 4           # untraced blocks, then as many traced


def config(mode: str = "usb", sideband: str = "both") -> rx.RxConfig:
    """The full-width config of a mode: the SSB flagship (with the RX
    options, "ssb_opts" and "ssb_leaky"; on the legacy front,
    "ssb_scipy"), the FM or the wide-SSB flagship,
    or the AM/SAM flagship in that mode and sideband."""
    if mode == "usb":
        return rx.FLAGSHIP
    if mode == "fm":
        return rx.FM_FLAGSHIP
    if mode == "wide":
        return rx.WIDE_FLAGSHIP
    if mode == "ssbstereo":
        return rx.STEREO_FLAGSHIP
    if mode == "ssb_opts":
        return dataclasses.replace(rx.FLAGSHIP, iq_auto_correction=True,
                                   notch_enable=True, nb_enable=True,
                                   nr_enable=True)
    if mode == "ssb_leaky":
        return dataclasses.replace(rx.FLAGSHIP, leaky_nr_enable=True)
    if mode == "ssb_scipy":
        return rx.SCIPY_FLAGSHIP
    return dataclasses.replace(rx.SAM_FLAGSHIP, mode=mode,
                               sam_sideband=sideband)


def tone_hz(cfg: rx.RxConfig) -> float:
    """The audio tone channel 0 of `capture` carries."""
    return FM_TONE_HZ if cfg.mode == "fm" else TONE_HZ


def capture(n_blocks: int, C: int, dev, seed: int,
            cfg: rx.RxConfig = rx.FLAGSHIP):
    """Seeded int16 IQ blocks (C, cfg.block_len), made on `dev`, plus
    noise of 30 counts rms.  SSB configs: channel c carries one tone
    (TONE_HZ + 10·(c mod 200)) Hz above the translate frequency, so USB
    audio at that offset, at -60 ... -6 dBFS across channels (channel 0 at
    -12 dBFS).  AM/SAM configs: channel c carries a carrier 3·(c mod 8) Hz
    above the translate frequency (starting phase 1 rad, clear of the
    PLL phase detector's branch cut), amplitude-modulated 50% by that
    tone, at -40 ... -6 dBFS (channel 0 at -12 dBFS).  FM configs: the
    AM/SAM carriers, frequency-modulated at 2 kHz deviation by a
    (FM_TONE_HZ + 10·(c mod 200)) Hz tone and, where the config detects a
    subaudible tone, on even channels by that tone at 300 Hz deviation."""
    B = cfg.block_len
    am = cfg.mode in ("am", "sam")
    fm = cfg.mode == "fm"
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    c = torch.arange(C, device=dev, dtype=torch.float64)
    f_tone = tone_hz(cfg) + 10.0 * (c % 200)
    if am or fm:
        f = cfg.translate_hz + 3.0 * (c % 8)
        amp = 10.0 ** (-2.0 + 1.7 * (c % 64) / 63.0) * 32767.0 / 1.5
    else:
        f = cfg.translate_hz + f_tone
        amp = 10.0 ** (-3.0 + 2.7 * (c % 64) / 63.0) * 32767.0
    amp[0] = 0.25 * 32767.0
    out = []
    for k in range(n_blocks):
        n = torch.arange(k * B, (k + 1) * B, device=dev, dtype=torch.float64)

        def turns(freq):
            return torch.remainder(freq[:, None] * n / cfg.iq_rate,
                                   1.0) * (2 * math.pi)

        ph = turns(f)
        env = amp[:, None]
        if fm:
            ph = ph + 1.0 + FM_DEVIATION_HZ / f_tone[:, None] * torch.sin(
                turns(f_tone))
            if cfg.subtone_hz:
                sub = torch.full_like(f, cfg.subtone_hz)
                ph = ph + ((c % 2 == 0)[:, None] * SUBTONE_DEVIATION_HZ
                           / cfg.subtone_hz * torch.sin(turns(sub)))
        elif am:
            ph = ph + 1.0
            env = env * (1.0 + 0.5 * torch.sin(turns(f_tone)))

        def plane(tr):
            x = env * tr(ph) + 30.0 * torch.randn(
                (C, B), generator=gen, device=dev, dtype=torch.float64)
            return x.round().clamp(-32768, 32767).to(torch.int16)
        out.append((plane(torch.cos), plane(torch.sin)))
    return out


def fleet_capture(cfgs, n_blocks: int, C: int, dev, seed: int) -> list:
    """blocks[b][g] = fleet group g's (i, q) f32 planes of block b, C
    channels: `capture` for its config, in full scale 1.0.  The SSB
    tones sit above the translate frequency; an LSB group's capture is
    made 1400 Hz lower, so channel 0's tone lies 700 Hz below it."""
    per_group = []
    for g, cfg in enumerate(cfgs):
        ccfg = cfg
        if cfg.mode == "lsb":
            ccfg = dataclasses.replace(
                cfg, translate_hz=cfg.translate_hz - 2 * TONE_HZ)
        per_group.append([(i.to(torch.float32) / 32768.0,
                           q.to(torch.float32) / 32768.0) for i, q in
                          capture(n_blocks, C, dev, seed + g, ccfg)])
    return [[per_group[g][b] for g in range(len(cfgs))]
            for b in range(n_blocks)]


def wideband_capture(n_blocks: int, B: int, dev, seed: int) -> list:
    """Seeded wideband (i, q) f32 noise planes of B samples, 0.1 rms."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [(torch.randn(B, generator=gen, device=dev) * 0.1,
             torch.randn(B, generator=gen, device=dev) * 0.1)
            for _ in range(n_blocks)]


def busy_share(intervals) -> tuple[float, float]:
    """(busy us, window us) of a list of (start, end) intervals."""
    iv = sorted(intervals)
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, iv[-1][1] - iv[0][0]


def profile_blocks(step, state, blocks, samples: int, warm: int = 2) -> int:
    """Run `state = step(state, block)` over `warm` warm-up, BLOCKS
    untraced and BLOCKS traced blocks and print the untraced device time
    and host enqueue per block (the window's mean, and each block's with
    its device allocations), then under the profiler the device busy
    share and the device time of every kernel by name.  `samples`: input
    samples a block, for the rate.  Returns the exit code."""
    from torch.profiler import ProfilerActivity, profile
    n = BLOCKS
    for blk in blocks[:warm]:                            # warm-up, build
        state = step(state, blk)
    torch.cuda.synchronize()

    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    host, allocs = [], []
    mem0 = torch.cuda.memory_stats()
    prev = mem0.get("num_device_alloc", 0)
    marks[0].record()
    for k, blk in enumerate(blocks[warm:warm + n]):
        t0 = time.perf_counter()
        state = step(state, blk)
        host.append(time.perf_counter() - t0)
        marks[k + 1].record()
        now = torch.cuda.memory_stats().get("num_device_alloc", 0)
        allocs.append(now - prev)
        prev = now
    marks[-1].synchronize()
    mem = {k: torch.cuda.memory_stats().get(k, 0) - mem0.get(k, 0)
           for k in ("num_device_alloc", "num_device_free")}
    each = [marks[k].elapsed_time(marks[k + 1]) for k in range(n)]
    step_ms = marks[0].elapsed_time(marks[-1]) / n
    print(f"untraced: {step_ms:.4f} ms/block on the device (mean; median "
          f"{sorted(each)[n // 2]:.4f}), host enqueue "
          f"{sum(host) / n * 1e3:.4f} ms/block, "
          f"{samples / step_ms / 1e3:.1f} Ms/s; device allocations "
          f"{mem['num_device_alloc'] / n:.1f}, frees "
          f"{mem['num_device_free'] / n:.1f} a block")
    for k in range(n):
        print(f"  untraced block {k}: device {each[k]:.4f} ms, host "
              f"{host[k] * 1e3:.4f} ms, device allocations {allocs[k]}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state = step(state, blocks[1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)
             and "prototype" not in str(w.message)]
    print(f"synchronising calls in one block: {len(syncs)}"
          + "".join(f"\n  {w.filename}:{w.lineno} {w.message}"
                    for w in syncs[:5]))
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for blk in blocks[2 + n:2 + 2 * n]:
            state = step(state, blk)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / n
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        print("traced: the profiler recorded no device activity")
        return 1
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kern:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    busy, window = busy_share([(e.time_range.start, e.time_range.end)
                               for e in kern])
    print(f"traced: {traced_ms:.4f} ms/block wall (synchronised), device "
          f"busy {busy / n / 1e3:.4f} ms/block of a {window / n / 1e3:.4f} "
          f"ms/block window = {100 * busy / window:.1f}% busy, "
          f"{100 * (1 - busy / window):.1f}% idle")
    total = sum(v[0] for v in by_name.values())
    print(f"{'ms/block':>9} {'share':>6} {'calls/block':>11}  kernel")
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"{us / n / 1e3:9.4f} {100 * us / total:5.1f}% "
              f"{cnt / n:11.1f}  {name[:90]}")
    return 0


def sharded(dev, n: int, seed: int, warm: int) -> int:
    """`--mode sharded`: the sharded RX step at world size 1."""
    import os
    import tempfile

    import torch.distributed as dist

    from .parallel import mesh, multihost, rx_sharded
    cfg = rx.FLAGSHIP
    C, B = rx.FLAGSHIP_CHANNELS, cfg.block_len
    print(f"config: sharded, rx.FLAGSHIP on a 1 x 1 mesh, {C} ch x {B} f32 "
          f"@ {cfg.iq_rate:.0f} Hz")
    blocks = [(i.float() / 32768.0, q.float() / 32768.0)
              for i, q in capture(n, C, dev, seed, cfg)]
    with tempfile.TemporaryDirectory() as td:
        multihost.initialize("file://" + os.path.join(td, "rendezvous"), 1,
                             0, dev)
        try:
            step, init_state = rx_sharded.make_sharded_rx(
                cfg, mesh.make_mesh(1, 1), dev)
            return profile_blocks(lambda s, blk: step(s, *blk)[1],
                                  init_state(C), blocks, C * B, warm)
        finally:
            dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--mode", choices=("usb", "am", "sam", "fm", "wide",
                                       "ssbstereo", "ssb_opts", "ssb_leaky",
                                       "ssb_scipy", "decode", "refchain",
                                       "fleet", "fleet_separate",
                                       "wideband", "sharded"),
                    default="usb")
    ap.add_argument("--sideband", choices=("both", "usb", "lsb", "stereo"),
                    default="both", help="sam_sideband for --mode sam")
    ap.add_argument("--group-channels", type=int,
                    default=fleet.FLEET_GROUP_CHANNELS,
                    help="channels a fleet group (--mode fleet, "
                         "fleet_separate)")
    ap.add_argument("--warm", type=int, default=2, help="warm-up blocks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_rx: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    n = args.warm + 2 * BLOCKS
    if args.mode in ("fleet", "fleet_separate"):
        C = args.group_channels
        cfgs = fleet.FLEET_MIX
        fl = fleet.ChannelFleet(
            cfgs, [k for k in range(len(cfgs)) for _ in range(C)],
            device=dev)
        run = fl.step_fused if args.mode == "fleet" else fl.step_separate
        print(f"config: {args.mode}, {', '.join(c.mode for c in cfgs)} x "
              f"{C} ch x {cfgs[0].block_len} f32 @ 48 kHz, {args.warm} "
              f"warm-up blocks")
        # above the deployment's width, 4 distinct blocks in turn: 10 of
        # 4096 channels a group would hold 32 GB of input
        distinct = n if C <= fleet.FLEET_GROUP_CHANNELS else 4
        blocks = fleet_capture(cfgs, distinct, C, dev, args.seed)
        return profile_blocks(lambda s, blk: run(blk), None,
                              [blocks[k % distinct] for k in range(n)],
                              C * len(cfgs) * cfgs[0].block_len, args.warm)
    if args.mode == "wideband":
        wf = fleet.WidebandFleet(fleet.WIDEBAND_MIX, fleet.wideband_counts(),
                                 device=dev)
        print(f"config: wideband, {wf.n_channels} channels "
              f"{fleet.wideband_counts()} x {wf.block_len}")
        return profile_blocks(
            lambda s, blk: wf.process_block_device(*blk), None,
            wideband_capture(n, wf.wideband_block, dev, args.seed),
            wf.wideband_block, args.warm)
    if args.mode == "sharded":
        return sharded(dev, n, args.seed, args.warm)
    if args.mode == "refchain":
        cfg = refchain.REF_FLAGSHIP
        C, B = rx.FLAGSHIP_CHANNELS, cfg.block_len
        chain = refchain.RefRxChain(cfg, device=dev)
        print(f"config: RefRxChain mode {cfg.mode}, bw {cfg.bw_key}, select "
              f"{cfg.select_id}, {C} ch x {B} f32 @ {refchain.IQ_RATE:.0f} "
              f"Hz")
        # the SSB capture at 48 kHz, as f32 planes in the count domain
        proxy = rx.RxConfig(mode=cfg.mode, translate_hz=cfg.translate_hz,
                            iq_rate=refchain.IQ_RATE, block_len=B)
        blocks = [(i.float(), q.float())
                  for i, q in capture(n, C, dev, args.seed, proxy)]
        return profile_blocks(
            lambda s, blk: chain(s, i=blk[0], q=blk[1])[1],
            chain.init_state((C,)), blocks, C * B, args.warm)
    if args.mode == "decode":
        from .modems import psk, tap
        from .spectrum import scope
        cfg = rx.FLAGSHIP
        C, B = rx.FLAGSHIP_CHANNELS, cfg.block_len
        print(f"config: decode, mode {cfg.mode}, bw {cfg.bw_key}, {C} ch x "
              f"{B} @ {cfg.iq_rate:.0f} Hz, the scope and CW, PSK63, RTTY "
              f"on the 12 kHz tap")
        chain = rx.RxChain(cfg, device=dev)
        sp = scope.make_params(translate_hz=cfg.translate_hz)
        dtap = tap.DecoderTap(C, device=dev,
                              psk_params=psk.make_params(speed=63))

        def dec_step(state, blk):
            cs, ss = state
            _, cs, taps = chain(cs, i=blk[0], q=blk[1])
            _, ss = scope.process(sp, ss, taps["spectrum_iq"])
            dtap.push(taps["audio_dec"])
            return cs, ss

        return profile_blocks(dec_step, (chain.init_state((C,)),
                                         scope.init_state((C,), sp, dev)),
                              capture(n, C, dev, args.seed, cfg), C * B,
                              args.warm)
    cfg = config(args.mode, args.sideband)
    C, B = rx.FLAGSHIP_CHANNELS, cfg.block_len
    print(f"config: mode {cfg.mode}, bw {cfg.bw_key}, sam_sideband "
          f"{cfg.sam_sideband}, {C} ch x {B} @ {cfg.iq_rate:.0f} Hz")
    chain = rx.RxChain(cfg, device=dev)

    def step(state, blk):
        _, state, _ = chain(state, i=blk[0], q=blk[1])
        return state

    return profile_blocks(step, chain.init_state((C,)),
                          capture(n, C, dev, args.seed, cfg), C * B,
                          args.warm)


if __name__ == "__main__":
    sys.exit(main())
