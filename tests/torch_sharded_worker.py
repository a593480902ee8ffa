"""One rank of the gloo world that tests/test_torch_sharded*.py spawn.  It
imports the port alone (no JAX), runs the job's cases on a (dp, sp) mesh
on the CPU and writes what it got for the test to compare:

    python -m tests.torch_sharded_worker RANK WORLD INIT JOB OUT

JOB is a pickle of {name: case} (see `run_case`), INIT the `file://`
rendezvous, OUT the directory this rank writes rank{RANK}.pkl into.
"""
from __future__ import annotations

import pickle
import sys

import numpy as np
import torch

from uhsdr_tpu_torch.chain import rx, tx
from uhsdr_tpu_torch.parallel import mesh as mesh_mod
from uhsdr_tpu_torch.parallel import (multihost, rx_sharded, tx_sharded,
                                      wideband_sharded)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def run_rx(mesh, case) -> dict:
    """case: cfg (RxConfig keywords), blocks [(i, q) global (C, T) f32],
    state (a global state to start from, or None).  Returns this rank's
    audio over the blocks and the gathered global state."""
    cfg = rx.RxConfig(**case["cfg"])
    step, init_state = rx_sharded.make_sharded_rx(cfg, mesh, "cpu")
    C, T = case["blocks"][0][0].shape
    state = (init_state(C) if case.get("state") is None
             else rx_sharded.scatter_state(cfg, mesh, case["state"], "cpu"))
    rows, cols = mesh_mod.grid_slice(mesh, C, T)
    audio = []
    for i, q in case["blocks"]:
        y, state = step(state, _t(i[rows, cols]), _t(q[rows, cols]))
        audio.append(y.numpy())
    return dict(audio=np.concatenate(audio, -1),
                state=rx_sharded.gather_state(cfg, mesh, state))


def run_tx(mesh, case) -> dict:
    """case: cfg (TxConfig keywords), blocks [global (C, T) f32 audio]."""
    cfg = tx.TxConfig(**case["cfg"])
    step, init_state = tx_sharded.make_sharded_tx(cfg, mesh, "cpu")
    C = case["blocks"][0].shape[0]
    state = init_state(C)
    sl = mesh_mod.channel_slice(mesh, C)
    iq = []
    for audio in case["blocks"]:
        i, q, state = step(state, _t(audio[sl]))
        iq.append((i + 1j * q).numpy())
    return dict(iq=np.concatenate(iq, -1),
                state=tx_sharded.gather_state(cfg, mesh, state))


def run_wideband(mesh, case) -> dict:
    """case: M, K, prototype, blocks [(B,) complex wideband]."""
    step, init_carry, _ = wideband_sharded.make_sharded_channelizer(
        case["M"], mesh, taps_per_branch=case["K"],
        prototype=case["prototype"], device="cpu")
    carry = init_carry()
    out = []
    for x in case["blocks"]:
        b = x.shape[-1] // mesh.size
        part = x[mesh.rank * b:(mesh.rank + 1) * b]
        i, q, carry = step(carry, _t(part.real), _t(part.imag))
        out.append((i + 1j * q).numpy())
    return dict(y=np.concatenate(out, -1))


def run_mesh(mesh, case) -> dict:
    """This rank's coordinates and slices of a (C, T) grid."""
    C, T = case["shape"]
    return dict(dp=mesh.dp_idx, sp=mesh.sp_idx, sp_ranks=mesh.sp_ranks,
                channels=mesh_mod.channel_slice(mesh, C),
                grid=mesh_mod.grid_slice(mesh, C, T))


RUN = {"rx": run_rx, "tx": run_tx, "wideband": run_wideband,
       "mesh": run_mesh}


def main(rank: int, world: int, init: str, job: str, out: str) -> None:
    torch.set_num_threads(1)
    multihost.initialize(init, world, rank, "cpu")
    with open(job, "rb") as f:
        cases = pickle.load(f)
    mesh = mesh_mod.make_mesh(*cases.pop("mesh_shape"))
    got = {name: RUN[case["kind"]](mesh, case)
           for name, case in cases.items()}
    with open(f"{out}/rank{rank}.pkl", "wb") as f:
        pickle.dump(got, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
