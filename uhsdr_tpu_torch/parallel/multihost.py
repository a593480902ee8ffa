"""The multi-host layer: the process group over every host's ranks and
per-host IQ ingest for the sharded paths, the counterpart of
`uhsdr_tpu.parallel.multihost`.

SURVEY §2.6 "distributed communication backend": the reference's data
transports are I2S DMA and USB streams into ONE core; at scale the
equivalent is a process group over the network, each host feeding the IQ
of ITS channels (`local_tile`), the (dp, sp) mesh over every host's
ranks, one rank a device.  The backend follows the device: NCCL on CUDA,
gloo on the CPU.

Topology: the ``sp`` (time, halo) axis stays within a host, whose ranks
are consecutive (the halo is latency-bound), while ``dp`` (independent
channels) spans hosts: channels never talk, so the only traffic between
hosts is ingest.

    python -m uhsdr_tpu_torch.parallel.multihost N [--device cpu]

starts N "hosts" of 2 ranks each on this machine (a `file://` rendezvous
in a temporary directory), runs one sharded RX step with per-host ingest,
one wideband channelizer step and one TX step, each rank holding its
output against the single-device chain on its channels, and all-reduces
a checksum that every rank must agree on.  It prints a PASS line a rank
and OK, and exits 0.  It runs on CUDA, each host's ranks on cuda:0 and
cuda:1 (two cards a host), and raises without CUDA unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..chain.rx import resolve_device
from . import mesh as mesh_mod

RANKS_PER_HOST = 2
TIMEOUT_S = 90
# the directory that holds the package, where the demo's ranks start
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def initialize(init_method: str, world_size: int, rank: int, device=None,
               local_world_size: int | None = None) -> torch.device:
    """Join the process group: NCCL for a CUDA device, gloo for the CPU,
    with a timeout of TIMEOUT_S, so a stuck collective fails instead of
    hanging.  On CUDA the rank takes the card of its local rank (rank
    mod the host's ranks).  Returns the rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % _local_world(local_world_size,
                                                           world_size))
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dev


def _local_world(local_world_size: int | None = None,
                 world_size: int | None = None) -> int:
    """The ranks of a host: the argument, else LOCAL_WORLD_SIZE, else the
    whole world (one host)."""
    if local_world_size is not None:
        return local_world_size
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return world_size if world_size is not None else dist.get_world_size()


def make_global_mesh(n_sp: int = 1,
                     local_world_size: int | None = None) -> mesh_mod.Mesh:
    """The (dp, sp) mesh over every host's ranks with sp inside a host:
    a host's ranks are consecutive and n_sp divides them."""
    world = dist.get_world_size()
    local = _local_world(local_world_size)
    if world % local or local % n_sp:
        raise ValueError(f"{world} ranks, {local} a host, sp {n_sp}: sp "
                         f"must divide a host's ranks and they the world")
    return mesh_mod.make_mesh(world // n_sp, n_sp)


def local_tile(mesh: mesh_mod.Mesh, local_iq: np.ndarray,
               local_world_size: int | None = None) -> np.ndarray:
    """Per-host ingest, the counterpart of `host_local_to_global`: the
    host holds the (C_host, T) IQ of its own channels (its dp rows, in
    order), and each rank takes its (C / n_dp, T / n_sp) tile of the
    global grid from it, so no process holds the whole capture.  Returns
    a contiguous copy."""
    local = _local_world(local_world_size)
    rows = local // mesh.n_sp                     # dp rows a host
    c = local_iq.shape[0] // rows
    t = local_iq.shape[-1] // mesh.n_sp
    r = mesh.dp_idx % rows                        # the row in its host
    return np.ascontiguousarray(
        local_iq[r * c:(r + 1) * c, mesh.sp_idx * t:(mesh.sp_idx + 1) * t])


# ---------------------------------------------------------------------------
# the demo: N hosts x 2 ranks on localhost
# ---------------------------------------------------------------------------

DEMO_BLOCK = 4096
DEMO_HOST_CHANNELS = 8
DEMO_BANK = (16, 6)              # channels, taps a branch


def _host_capture(host: int, seed: int = 5):
    """A host's (C_host, T) IQ: a USB tone 700 + 100 c Hz above the 6 kHz
    translate on each of its channels (c the global channel), in noise."""
    rng = np.random.default_rng(seed + host)
    C = DEMO_HOST_CHANNELS
    c = host * C + np.arange(C)[:, None]
    t = np.arange(DEMO_BLOCK) / 48000.0
    z = 0.3 * np.exp(2j * np.pi * (6700.0 + 100.0 * c) * t) + 0.01 * (
        rng.standard_normal((C, t.size)) + 1j * rng.standard_normal(
            (C, t.size)))
    return z.real.astype(np.float32), z.imag.astype(np.float32)


def _demo_rank(rank: int, world: int, init: str, device: str) -> None:
    from ..chain import rx, tx
    from ..metrics import snr_db
    from ..ops import channelizer as chz
    from . import rx_sharded, tx_sharded, wideband_sharded

    # the host's ranks come from LOCAL_WORLD_SIZE, as a launcher sets it
    dev = initialize(init, world, rank, device)
    mesh = make_global_mesh(n_sp=RANKS_PER_HOST)
    host = rank // RANKS_PER_HOST
    n_hosts = world // RANKS_PER_HOST
    C = DEMO_HOST_CHANNELS * n_hosts
    mine = mesh_mod.channel_slice(mesh, C)
    # this host's channels, of which this rank's are a slice
    sub = slice(mine.start - host * DEMO_HOST_CHANNELS,
                mine.stop - host * DEMO_HOST_CHANNELS)

    # the sharded RX step, the host's IQ ingested tile by tile
    cfg = rx.RxConfig(mode="usb", bw_key="2P3KHZ", path_name="LPF",
                      translate_hz=6000.0, block_len=DEMO_BLOCK)
    step, init_state = rx_sharded.make_sharded_rx(cfg, mesh, dev)
    i_host, q_host = _host_capture(host)
    audio, _ = step(init_state(C),
                    torch.as_tensor(local_tile(mesh, i_host), device=dev),
                    torch.as_tensor(local_tile(mesh, q_host), device=dev))
    chain = rx.RxChain(cfg, device="cpu")
    ref, _, _ = chain(chain.init_state((sub.stop - sub.start,)),
                      i=i_host[sub], q=q_host[sub])
    s_rx = snr_db(ref, audio.cpu())

    # the wideband bank: every rank makes the block, takes its time shard
    M, K = DEMO_BANK
    B = world * M * K * 2
    rng = np.random.default_rng(11)
    wide = (rng.standard_normal(B) + 1j * rng.standard_normal(B)).astype(
        np.complex64)
    wstep, init_carry, bank = wideband_sharded.make_sharded_channelizer(
        M, mesh, taps_per_branch=K, device=dev)
    b = B // world
    part = wide[rank * b:(rank + 1) * b]
    i_ch, q_ch, _ = wstep(init_carry(),
                          torch.as_tensor(part.real.copy(), device=dev),
                          torch.as_tensor(part.imag.copy(), device=dev))
    ref_bank = chz.AnalysisPfb(M, prototype=bank.prototype, device="cpu")
    y_ref, _ = ref_bank(ref_bank.init_state(), torch.as_tensor(wide))
    ch = mesh_mod.channel_slice(mesh, M)
    s_wb = snr_db(y_ref[ch], torch.complex(i_ch, q_ch).cpu())

    # the TX step on this rank's channels
    tcfg = tx.TxConfig(mode="usb", translate_hz=6000.0, block_len=DEMO_BLOCK)
    tchain, tx_init = tx_sharded.make_sharded_tx(tcfg, mesh, dev)
    t = np.arange(DEMO_BLOCK) / 48000.0
    voice = np.tile((0.4 * np.sin(2 * np.pi * 700.0 * t)).astype(
        np.float32), (mine.stop - mine.start, 1))
    ti, tq, _ = tchain(tx_init(C), voice)
    cpu_tx = tx.TxChain(tcfg, device="cpu")
    ri, rq, _ = cpu_tx(cpu_tx.init_state((voice.shape[0],)), voice)
    s_tx = snr_db(torch.complex(ri, rq), torch.complex(ti, tq).cpu())

    chk = torch.tensor([float(audio.abs().sum() + i_ch.abs().sum()
                              + ti.abs().sum())], dtype=torch.float64,
                       device=dev)
    dist.all_reduce(chk)
    print(f"rank {rank}: rx {s_rx:.1f} dB, wideband {s_wb:.1f} dB, tx "
          f"{s_tx:.1f} dB, checksum {float(chk):.6f}", flush=True)
    ok = (min(s_rx, s_tx) >= 80.0 and s_wb >= 100.0
          and bool(torch.isfinite(chk).all()))
    dist.destroy_process_group()
    if not ok:
        raise SystemExit(f"rank {rank}: FAIL")
    print(f"rank {rank}: PASS", flush=True)


def demo(n_hosts: int, device=None) -> bool:
    """Run the demo's ranks as subprocesses (each with a timeout) on
    `device` (CUDA unless the caller names the CPU); print each rank's
    last lines and OK or FAIL.  Returns whether it passed."""
    device = resolve_device(device).type
    world = n_hosts * RANKS_PER_HOST
    with tempfile.TemporaryDirectory() as td:
        init = "file://" + os.path.join(td, "rendezvous")
        env = dict(os.environ, LOCAL_WORLD_SIZE=str(RANKS_PER_HOST))
        procs = [subprocess.Popen(
            [sys.executable, "-m", __spec__.name, "--rank", str(r), "--world",
             str(world), "--init", init, "--device", device],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=_ROOT) for r in range(world)]
        outs = []
        for pr in procs:
            try:
                out, _ = pr.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for p in procs:
                    p.kill()
                out, _ = pr.communicate()
            outs.append(out)
    sums = set()
    ok = True
    for r, (pr, out) in enumerate(zip(procs, outs)):
        passed = pr.returncode == 0 and f"rank {r}: PASS" in out
        ok &= passed
        sums |= {line.rsplit("checksum ", 1)[1] for line in out.splitlines()
                 if "checksum " in line}
        print(f"--- rank {r} (rc={pr.returncode}) ---")
        print("\n".join(out.strip().splitlines()[-3:]))
    ok &= len(sums) == 1
    print("OK" if ok else "FAIL")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("hosts", type=int, nargs="?", default=2)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _demo_rank(args.rank, args.world, args.init, args.device)
        return 0
    return 0 if demo(args.hosts, args.device) else 1


if __name__ == "__main__":
    sys.exit(main())
