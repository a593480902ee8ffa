"""The port's multi-host layer (`uhsdr_tpu_torch.parallel.multihost`) on
the CPU:

* `local_tile`: every rank's tile, taken from its host's channels alone,
  is its tile of the global grid (`mesh.grid_slice`), for hosts of one
  and of two dp rows;
* the demo, `python -m uhsdr_tpu_torch.parallel.multihost 2 --device
  cpu`: two "hosts" of two gloo ranks each run one sharded RX step with
  per-host ingest, one wideband step and one TX step, each rank held to
  the single-device chain on its channels, and agree on an all-reduced
  checksum; it prints OK and exits 0 (the JAX package's counterpart is
  tools/run_multihost_demo.py); without `--device` it takes CUDA and
  raises where CUDA is absent.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from uhsdr_tpu_torch.parallel import mesh as tmesh
from uhsdr_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_hosts,local,n_sp", [(2, 2, 2), (2, 4, 2),
                                                (3, 2, 1)])
def test_local_tile_is_the_global_tile(n_hosts, local, n_sp):
    world = n_hosts * local
    n_dp = world // n_sp
    C, T = 4 * n_dp, 64
    g = np.arange(C * T, dtype=np.float32).reshape(C, T)
    c_host = C // n_hosts
    for r in range(world):
        d = r // n_sp
        m = tmesh.Mesh(n_dp, n_sp, r, None,
                       tuple(range(d * n_sp, (d + 1) * n_sp)))
        host = r // local
        tile = multihost.local_tile(m, g[host * c_host:(host + 1) * c_host],
                                    local_world_size=local)
        rows, cols = tmesh.grid_slice(m, C, T)
        assert np.array_equal(tile, g[rows, cols]), r


def test_multihost_demo_runs():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-m", "uhsdr_tpu_torch.parallel.multihost", "2",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    print(r.stdout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "OK"
    assert r.stdout.count(": PASS") == 4


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal where CUDA is absent")
def test_multihost_demo_runs_on_cuda_unless_asked_for_the_cpu():
    """Without `--device` the demo takes CUDA, and raises where it is
    absent before starting a rank."""
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.demo(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.main(["1"])
