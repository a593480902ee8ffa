"""The sharded paths of the port (`uhsdr_tpu_torch.parallel`: `mesh`,
`rx_sharded`) and its unfused stage B on the CPU, against the JAX
package's (`uhsdr_tpu.parallel`, on the conftest's 8 virtual CPU devices,
the XLA front route its own tests use):

* mesh coordinates and slices against the JAX mesh's index sets at (1, 1),
  (2, 2) and (4, 2); `make_mesh` raises without a process group;
* `rx_sharded.front_end_local`, each block cut into time shards with the
  previous shard's raw tail as the halo, against the port's unsharded
  front (K5 and K6/K7's plain versions) at >= 100 dB, the E seam outputs
  of every shard on their own too, across a uint32 phase wrap;
* `chain/rx.py::stage_b` on complex stage-A output against the JAX
  `stage_b` (its `fir.fir_block` route on the CPU) over 3 streamed
  blocks at >= 90 dB, `front2_carry` included;
* the sharded RX step at world size 1 in this process (gloo) against the
  port's single-device chain, the JAX sharded state handed in through
  `scatter_state` and out through `gather_state` (two seeds);
* the sharded RX step in a 2 x 2 gloo world of four CPU processes (usb
  2P3KHZ @ 48 kHz, translate 6000, C = 8, T = 4096, 4 blocks; usb with
  NR, 2 blocks) against the JAX sharded step on a 2 x 2 submesh and the
  port's single-device `RxChain`: audio and every gathered state leaf at
  >= 80 dB, integer and boolean leaves equal; and the JAX sharded state
  after block 1 handed to the world through `scatter_state`, block 2's
  audio at >= 90 dB and its state, back through `gather_state`, at 90 dB
  on every leaf but three (`assert_handed_over`: the PreFilter's state,
  the AGC's delay line and the interpolator's carry after it, at 80 dB;
  the JAX CPU route runs the PreFilter as a dilated scan, 87.9 dB from
  float64, ROADMAP queue C's standing divergences).

SAM, FM, TX and the wideband bank are in tests/test_torch_sharded_modes.py,
which uses this module's helpers.  A world's ranks are subprocesses
(tests/torch_sharded_worker.py, which imports the port alone) with a
`file://` rendezvous under the test's temporary directory and a timeout.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from uhsdr_tpu.chain import rx as jrx
from uhsdr_tpu.parallel import mesh as jmesh
from uhsdr_tpu.parallel import rx_sharded as jrs
from uhsdr_tpu_torch.chain import rx as trx
from uhsdr_tpu_torch.cuda import fir as fir_k
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.parallel import mesh as tmesh
from uhsdr_tpu_torch.parallel import multihost
from uhsdr_tpu_torch.parallel import rx_sharded as trs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN_DB = 80.0
HANDOVER_DB = 90.0
FIR_DB = 100.0
STAGE_B_DB = 90.0
LOOSE_LEAVES = ("audio_sos_state", "agc.delay", "interp_carry")
WORLD_TIMEOUT_S = 120
C, T = 8, 4096
USB = dict(mode="usb", bw_key="2P3KHZ", path_name="LPF",
           translate_hz=6000.0, block_len=T)
NR = dict(USB, nr_enable=True)
WORLD_OF_ONE = dict(USB, translate_hz=12000.0, iq_rate=96000.0)


# ---------------------------------------------------------------------------
# helpers (tests/test_torch_sharded_modes.py uses them too)
# ---------------------------------------------------------------------------

def spawn_world(tmp, cases: dict, mesh_shape=(2, 2)) -> list[dict]:
    """Run `cases` in a gloo world of n_dp x n_sp CPU processes; returns
    each rank's results, in rank order."""
    world = mesh_shape[0] * mesh_shape[1]
    job = os.path.join(tmp, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump(dict(cases, mesh_shape=mesh_shape), f)
    init = "file://" + os.path.join(tmp, "rendezvous")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_sharded_worker", str(r),
         str(world), init, job, str(tmp)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    got = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            got.append(pickle.load(f))
    return got


def joined(ranks: list[dict], name: str, key: str) -> np.ndarray:
    """A per-rank result joined over the ranks' channels (rank order)."""
    return np.concatenate([r[name][key] for r in ranks], axis=0)


def capture(n_blocks: int, kind: str = "usb", seed: int = 0,
            n_ch: int = C, fs: float = 48000.0, block: int = T):
    """f32 (i, q) blocks, (n_ch, block) each, a different signal on every
    channel (so a channel in the wrong place shows): a USB tone 700 + 100 c
    Hz above the 6 kHz translate ("usb"), an AM carrier at the translate
    with a 700 + 50 c Hz tone ("sam"), an FM carrier at the translate
    with a 700 Hz tone at index 1 + c / 4 ("fm"); levels -6 to -26 dBFS,
    noise at -60."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * block) / fs
    c = np.arange(n_ch)[:, None]
    amp = 0.5 * 10.0 ** (-np.linspace(0, 20, n_ch) / 20.0)[:, None]
    if kind == "usb":
        z = np.exp(2j * np.pi * (6700.0 + 100.0 * c) * t)
    elif kind == "sam":
        z = np.exp(2j * np.pi * 6000.0 * t) * (
            1.0 + 0.5 * np.sin(2 * np.pi * (700.0 + 50.0 * c) * t))
    else:
        z = np.exp(2j * np.pi * 6000.0 * t + 1j * (1.0 + c / 4.0)
                   * np.sin(2 * np.pi * 700.0 * t))
    z = amp * z + 1e-3 * (rng.standard_normal(z.shape)
                          + 1j * rng.standard_normal(z.shape))
    i, q = z.real.astype(np.float32), z.imag.astype(np.float32)
    return [(i[:, k * block:(k + 1) * block], q[:, k * block:(k + 1) * block])
            for k in range(n_blocks)]


def jax_sharded(cfg_kw: dict, blocks, state=None):
    """The JAX sharded step on a 2 x 2 submesh of the virtual devices.
    Returns (audio over the blocks, the state after each block as a
    dotted dict)."""
    mesh = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    step, init_state = jrs.make_sharded_rx(jrx.RxConfig(**cfg_kw), mesh)
    grid = jmesh.grid_sharding(mesh)
    state = init_state(blocks[0][0].shape[0]) if state is None else state
    audio, states = [], []
    for i, q in blocks:
        y, state = step(state, jax.device_put(i, grid),
                        jax.device_put(q, grid))
        audio.append(np.asarray(y))
        states.append(state)
    return np.concatenate(audio, -1), states


def port_single(cfg_kw: dict, blocks):
    """The port's single-device RxChain on the CPU: (audio over the
    blocks, its final state in the sharded layout)."""
    chain = trx.RxChain(trx.RxConfig(**cfg_kw), device="cpu")
    state = chain.init_state((blocks[0][0].shape[0],))
    audio = []
    for i, q in blocks:
        y, state, _ = chain(state, i=i, q=q)
        audio.append(y.numpy())
    flat = trx.state_to_numpy(state)
    fc = flat["front_carry"]
    flat["front_carry"] = np.stack([fc.real, fc.imag], axis=1)
    return np.concatenate(audio, -1), flat


def leaf_snrs(ref: dict, got: dict) -> dict:
    """{leaf: SNR dB} of `got`'s leaves against `ref`'s: integer and
    boolean leaves by equality (inf or -inf), the PLL phase through its
    cosine and sine."""
    out = {}
    for f, v in got.items():
        r = np.asarray(ref[f])
        assert r.shape == v.shape, (f, r.shape, v.shape)
        if v.dtype == bool or v.dtype.kind in "iu":
            out[f] = np.inf if np.array_equal(r, v) else -np.inf
        elif f == "sam.phs":
            out[f] = snr_db(np.stack([np.cos(r), np.sin(r)]),
                            np.stack([np.cos(v), np.sin(v)]))
        else:
            out[f] = snr_db(r, v)
    return out


def assert_handed_over(what: str, ref: dict, got: dict):
    """A state a block after a hand-over: every leaf at HANDOVER_DB but
    the PreFilter's state, the AGC's delay line after it and the
    interpolator's carry (the block's last AGC outputs), at CHAIN_DB: the
    JAX CPU route runs the PreFilter as a dilated scan, 87.9 dB from
    float64 (ROADMAP queue C's standing divergences), and the audio after
    it reads about 90.7 dB.  Prints every leaf under HANDOVER_DB."""
    for f, s in sorted(leaf_snrs(ref, got).items()):
        if s < HANDOVER_DB:
            print(f"\n{what}: {f} {s:.1f} dB")
        assert s >= (CHAIN_DB if f in LOOSE_LEAVES else HANDOVER_DB), \
            (what, f, s)


def assert_close(what: str, ref, got, db: float):
    """Audio, or every leaf of a state, at `db`."""
    if isinstance(ref, dict):
        leaves = leaf_snrs(ref, got)
        low = min(leaves, key=leaves.get)
        s, where = leaves[low], f"worst leaf {low}"
    else:
        assert np.shape(ref) == np.shape(got), (what, np.shape(got))
        s, where = snr_db(ref, got), "audio"
    print(f"\n{what}: {where} {s:.1f} dB")
    assert s >= db, (what, where, s)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def _jax_indices(n_dp, n_sp, Cg, Tg):
    """{rank: (channel slice, grid slices)} from the JAX mesh's shardings
    (device r of the mesh is rank r)."""
    mesh = jmesh.make_mesh(n_dp, n_sp, devices=jax.devices()[:n_dp * n_sp])
    devs = list(mesh.devices.flat)
    ch = jmesh.channel_sharding(mesh).devices_indices_map((Cg,))
    grid = jmesh.grid_sharding(mesh).devices_indices_map((Cg, Tg))
    return {r: (_span(ch[d][0], Cg), (_span(grid[d][0], Cg),
                                      _span(grid[d][1], Tg)))
            for r, d in enumerate(devs)}


def _span(s: slice, n: int) -> tuple:
    """(start, stop) of a slice over n elements."""
    return s.indices(n)[:2]


@pytest.mark.parametrize("n_dp,n_sp", [(1, 1), (2, 2), (4, 2)])
def test_mesh_slices_match_jax(n_dp, n_sp):
    Cg, Tg = 64, 1024
    want = _jax_indices(n_dp, n_sp, Cg, Tg)
    for r in range(n_dp * n_sp):
        m = tmesh.Mesh(n_dp, n_sp, r, None, tuple(
            range((r // n_sp) * n_sp, (r // n_sp + 1) * n_sp)))
        assert (m.dp_idx, m.sp_idx) == divmod(r, n_sp)
        assert _span(tmesh.channel_slice(m, Cg), Cg) == want[r][0]
        rows, cols = tmesh.grid_slice(m, Cg, Tg)
        assert (_span(rows, Cg), _span(cols, Tg)) == want[r][1]


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(1, 1)


# ---------------------------------------------------------------------------
# the front, shard by shard, and the unfused stage B
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,decim,taps", [
    (dict(trx.FLAGSHIP.__dict__), 8, 227),              # K5, planes out
    (dict(trx.WIDE_FLAGSHIP.__dict__), 4, 245),         # K7, real out
    (dict(trx.SAM_FLAGSHIP.__dict__), 4, 239),          # K5, complex out
    (dict(trx.WIDE_FLAGSHIP.__dict__, translate_hz=0.0), 4, 245),   # K6
    (dict(trx.SCIPY_FLAGSHIP.__dict__, mode="fm", bw_key="5P0KHZ",
          path_name=None), 1, 199)])                    # K5 at decimation 1
def test_front_end_local_matches_the_unsharded_front(kw, decim, taps):
    cfg = trx.RxConfig(**kw)
    p = trx.make_params(cfg, "cpu")
    L = p.front_fir.shape[-1] - 1
    assert (cfg.front_decim, L + 1) == (decim, taps)
    E = -(-L // decim)
    n_ch, B, n_sp = 4, 4096, 4
    rng = np.random.default_rng(3)

    def plane(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) * 0.1

    carry = torch.complex(plane(n_ch, L), plane(n_ch, L))
    # phases near the wrap: delta * B * k crosses 2^32 within the block
    phase = torch.tensor([2**32 - 5, 2**32 - p.nco_delta * 100 % 2**32,
                          2**31, 7], dtype=torch.int64) % 2**32
    f = fir_k.fir_cx if p.front_fir.is_complex() else fir_k.fir_rt
    real = cfg.mode in ("usb", "lsb", "cw") and p.front_fir.is_complex()
    nco_arg = (phase, p.nco_delta) if p.nco_delta else None
    for blk in range(2):
        i, q = plane(n_ch, B), plane(n_ch, B)
        ref, new_carry, _ = f(p.front_fir, carry, i, q, decim, nco=nco_arg,
                              **(dict(real_out=True) if real else {}))
        t = B // n_sp
        hist = torch.stack([carry.real, carry.imag], dim=1)
        parts = []
        for s in range(n_sp):
            ii, qq = i[:, s * t:(s + 1) * t], q[:, s * t:(s + 1) * t]
            z = trs.front_end_local(p, cfg, s, phase, hist, ii.contiguous(),
                                    qq.contiguous())
            parts.append(torch.complex(*z) if isinstance(z, tuple) else z)
            hist = torch.stack([ii[:, -L:], qq[:, -L:]], dim=1)
        got = torch.cat(parts, dim=-1)
        seams = [slice(s * t // decim, s * t // decim + E)
                 for s in range(n_sp)]
        s_all = snr_db(ref, got)
        s_seam = snr_db(torch.cat([ref[:, k] for k in seams], -1),
                        torch.cat([got[:, k] for k in seams], -1))
        print(f"\n{cfg.mode} {cfg.front} block {blk}: {s_all:.1f} dB, "
              f"the {n_sp} x {E} seam outputs {s_seam:.1f} dB")
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert s_all >= FIR_DB and s_seam >= FIR_DB
        carry = new_carry
        if nco_arg:
            phase = (phase + p.nco_delta * B) % 2**32
            nco_arg = (phase, p.nco_delta)


def test_unfused_stage_b_matches_jax():
    """Complex stage-A output (a complex tensor, and its planes) through
    the port's stage B against the JAX `stage_b`, 3 streamed blocks."""
    cfg_kw = dict(USB, translate_hz=12000.0, iq_rate=96000.0)
    jcfg, tcfg = jrx.RxConfig(**cfg_kw), trx.RxConfig(**cfg_kw)
    jp, tp = jrx.make_params(jcfg), trx.make_params(tcfg, "cpu")
    js = jrx.init_state(jcfg, jp, (C,))
    ts = ts2 = trx.init_state(tcfg, tp, (C,))
    rng = np.random.default_rng(7)
    n = T // tcfg.decim
    step = jax.jit(lambda s, z: jrx.stage_b(jcfg, jp, s, z))
    for blk in range(3):
        z = ((rng.standard_normal((C, n)) + 1j * rng.standard_normal(
            (C, n))) * 0.1).astype(np.complex64)
        yj, js = step(js, z)
        yt, ts = trx.stage_b(tcfg, tp, ts, torch.from_numpy(z))
        zt = torch.from_numpy(z)
        y2, ts2 = trx.stage_b(tcfg, tp, ts2, (zt.real.contiguous(),
                                              zt.imag.contiguous()))
        assert not yt.is_complex() and torch.equal(yt, y2)
        for what, a, b in (("audio", yj, yt), ("front2_carry",
                                                js.front2_carry,
                                                ts.front2_carry)):
            s = snr_db(np.asarray(a), b)
            print(f"\nstage B block {blk} {what}: {s:.1f} dB")
            assert s >= STAGE_B_DB
    # real audio (K1's, stage B fused) and fronts without a stage B pass
    audio = torch.ones((2, 16))
    out, s2 = trx.stage_b(tcfg, tp, ts, audio)
    assert out is audio and s2 is ts


# ---------------------------------------------------------------------------
# the step at world size 1, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def world_of_one(tmp_path):
    multihost.initialize("file://" + str(tmp_path / "rendezvous"), 1, 0,
                         "cpu")
    try:
        yield tmesh.make_mesh()
    finally:
        dist.destroy_process_group()


def test_world_of_one_matches_the_chain(world_of_one):
    """The step as the card runs it (n_sp = 1: no collective) at the
    flagship's rates cut to 8 channels x 4096: K5 stage A, K6 stage B,
    against the single-device chain's fused K1, 3 blocks."""
    mesh = world_of_one
    cfg = trx.RxConfig(**WORLD_OF_ONE)
    blocks = capture(3, fs=96000.0)
    step, init_state = trs.make_sharded_rx(cfg, mesh, "cpu")
    state, audio = init_state(C), []
    for i, q in blocks:
        y, state = step(state, torch.from_numpy(i), torch.from_numpy(q))
        audio.append(y.numpy())
    want, flat = port_single(WORLD_OF_ONE, blocks)
    assert_close("world of 1 vs RxChain", want, np.concatenate(audio, -1),
                 CHAIN_DB)
    assert_close("world of 1 state vs RxChain", flat,
                 trs.gather_state(cfg, mesh, state), CHAIN_DB)


@pytest.mark.parametrize("seed", [0, 1])
def test_world_of_one_takes_jax_state(world_of_one, seed):
    """The JAX sharded state after one block handed in (a JAX RxState),
    the next block's audio against the JAX step and the state after it
    out through `gather_state`."""
    mesh = world_of_one
    cfg = trx.RxConfig(**WORLD_OF_ONE)
    blocks = capture(2, seed=seed, fs=96000.0)
    step, _ = trs.make_sharded_rx(cfg, mesh, "cpu")
    mesh1 = jmesh.make_mesh(1, 1, devices=jax.devices()[:1])
    jstep, jinit = jrs.make_sharded_rx(jrx.RxConfig(**WORLD_OF_ONE), mesh1)
    _, js = jstep(jinit(C), *blocks[0])
    state = trs.scatter_state(cfg, mesh, jax.tree.map(np.asarray, js), "cpu")
    yj, js = jstep(js, *blocks[1])
    y, state = step(state, torch.from_numpy(blocks[1][0]),
                    torch.from_numpy(blocks[1][1]))
    assert_close(f"world of 1 from the JAX state, seed {seed}",
                 np.asarray(yj), y.numpy(), HANDOVER_DB)
    assert_handed_over(f"world of 1 state back, seed {seed}",
                       tmesh.flatten(js), trs.gather_state(cfg, mesh, state))


# ---------------------------------------------------------------------------
# a 2 x 2 gloo world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def usb_world(tmp_path_factory):
    """The usb cases run in one world; the JAX sharded state after block
    1 is computed before the world starts."""
    usb = capture(4)
    nr = capture(2, seed=1)
    ja, jstates = jax_sharded(USB, usb)
    cases = dict(
        usb=dict(kind="rx", cfg=USB, blocks=usb),
        usb_handover=dict(kind="rx", cfg=USB, blocks=usb[2:3],
                          state=tmesh.flatten(jstates[1])),
        nr=dict(kind="rx", cfg=NR, blocks=nr),
        mesh=dict(kind="mesh", shape=(C, T)))
    ranks = spawn_world(str(tmp_path_factory.mktemp("usb_world")), cases)
    return dict(ranks=ranks, usb=usb, nr=nr, jax_usb=(ja, jstates))


def test_world_mesh_matches_jax(usb_world):
    want = _jax_indices(2, 2, C, T)
    for r, got in enumerate(usb_world["ranks"]):
        m = got["mesh"]
        assert (m["dp"], m["sp"]) == divmod(r, 2)
        assert m["sp_ranks"] == tuple(range(2 * (r // 2), 2 * (r // 2) + 2))
        rows, cols = m["grid"]
        assert (_span(m["channels"], C),
                (_span(rows, C), _span(cols, T))) == want[r]


def test_sharded_usb_matches_jax_and_the_chain(usb_world):
    ranks = usb_world["ranks"]
    ja, jstates = usb_world["jax_usb"]
    audio = joined(ranks, "usb", "audio")
    state = ranks[0]["usb"]["state"]
    want, flat = port_single(USB, usb_world["usb"])
    assert_close("usb vs JAX sharded", ja, audio, CHAIN_DB)
    assert_close("usb state vs JAX sharded", tmesh.flatten(jstates[-1]),
                 state, CHAIN_DB)
    assert_close("usb vs RxChain", want, audio, CHAIN_DB)
    assert_close("usb state vs RxChain", flat, state, CHAIN_DB)
    # every rank gathers the same state
    for r in ranks[1:]:
        assert all(np.array_equal(v, r["usb"]["state"][f])
                   for f, v in state.items())


def test_sharded_usb_takes_the_jax_state(usb_world):
    ranks = usb_world["ranks"]
    ja, jstates = usb_world["jax_usb"]
    assert_close("usb block 2 from the JAX state", ja[:, 2 * T:3 * T],
                 joined(ranks, "usb_handover", "audio"), HANDOVER_DB)
    assert_handed_over("usb state back to JAX", tmesh.flatten(jstates[2]),
                       ranks[0]["usb_handover"]["state"])


def test_sharded_nr_matches_jax_and_the_chain(usb_world):
    ranks = usb_world["ranks"]
    audio = joined(ranks, "nr", "audio")
    ja, jstates = jax_sharded(NR, usb_world["nr"])
    want, flat = port_single(NR, usb_world["nr"])
    assert_close("usb+nr vs JAX sharded", ja, audio, CHAIN_DB)
    assert_close("usb+nr state vs JAX sharded", tmesh.flatten(jstates[-1]),
                 ranks[0]["nr"]["state"], CHAIN_DB)
    assert_close("usb+nr vs RxChain", want, audio, CHAIN_DB)
    assert_close("usb+nr state vs RxChain", flat, ranks[0]["nr"]["state"],
                 CHAIN_DB)


def test_sharded_rx_refuses_what_jax_refuses():
    for kw in (dict(USB, iq_auto_correction=True),
               dict(USB, mode="ssbstereo")):
        with pytest.raises(ValueError):
            trs.check_config(trx.RxConfig(**kw))
