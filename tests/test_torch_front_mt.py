"""K15, the modulated-taps SSB front: its plain version
(`cuda/fir.py::front_mt_plain`, what `front_mt` runs on CPU tensors)
against the TPU kernel it replaces and against the f32 fronts, and the
SSB flagship chain with the reference's gate on (`UHSDR_FRONT_MT=1`),
on the flagship's 227-tap stage A at decimation 8 and its 199-tap stage
B, 8 channels, int16 input, a nonzero NCO phase:

* against `fir_decimate_pallas(..., fuse2=..., nco_static_delta=...)`
  under `UHSDR_FRONT_MT=1` (`_fir_kernel_rt_s2_mt`, interpret mode), two
  streamed blocks: that kernel runs its dots in one bf16 pass, so audio
  and the stage-B carry are held to the JAX test's own bound, 2e-2 of
  the audio's peak (tests/test_pallas_fir.py:437-441); raw carry and
  peaks equal;
* against the same call with the gate off (the f32 rotor-plane kernel,
  `_fir_kernel_rt_s2`) and against the port's K1 plain version
  (`front_plain`, which rotates the input): >= 100 dB on audio and
  both carries (`-s` prints them);
* the SSB flagship chain with the gate on through `front_mt` (K1 must
  not run), four streamed blocks against the JAX CPU chain from zero
  state and through the hand-over: audio and every state leaf >= 80 dB
  (tests/test_torch_rx.py::run_streamed_both_ways); a retuned block
  takes K1, the gate's static-delta condition.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from tests import test_torch_rx as common
from uhsdr_tpu.pallas import fir as pfir
from uhsdr_tpu_torch.chain import rx as trx
from uhsdr_tpu_torch.cuda import fir as fir_k
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.ops import nco

F32_DB = 100.0
BF16_REL = 2e-2
C, B = 8, 2048
PHASE0 = 2**32 - 123457


def _front():
    p = trx.make_params(trx.RxConfig(**common.FLAGSHIP), device="cpu")
    return p.front_fir, p.front2, p.nco_delta, trx.RxConfig(
        **common.FLAGSHIP).decim


def _blocks(n, seed=61):
    rng = np.random.default_rng(seed)
    return [(rng.integers(-4000, 4000, (C, B)).astype(np.int16),
             rng.integers(-4000, 4000, (C, B)).astype(np.int16))
            for _ in range(n)]


def _pallas(h, g, delta, decim, carry, c2, blk, phase, static):
    """The JAX fused front on one block; returns numpy (audio, raw carry,
    stage-B carry, peaks)."""
    y, nc, pk, (f2r, f2i) = pfir.fir_decimate_pallas(
        h.numpy(), carry, (jnp.asarray(blk[0]), jnp.asarray(blk[1])), decim,
        tile_c=8, tile_t=256, nco=(jnp.uint32(phase), jnp.uint32(delta)),
        nco_static_delta=delta if static else None, peaks_out=True,
        fuse2=(g.numpy(), c2), interpret=True)
    return (np.asarray(y), np.asarray(nc), (f2r, f2i),
            np.asarray(pk).max(axis=-1))


def _run_port(fn, h, g, delta, decim, blocks):
    taps, taps2 = h.shape[-1], g.shape[-1]
    carry = torch.zeros((C, taps - 1), dtype=torch.complex64)
    c2 = torch.zeros((C, taps2 - 1), dtype=torch.complex64)
    phase = torch.full((C,), PHASE0, dtype=torch.int64)
    out = []
    for blk in blocks:
        y, carry, c2, pk = fn(h, g, carry, c2, torch.from_numpy(blk[0]),
                              torch.from_numpy(blk[1]), phase, delta, decim)
        out.append((y, carry, c2, pk))
        phase = nco.advance(phase, delta, B)
    return out


def _run_pallas(h, g, delta, decim, blocks, static):
    taps, taps2 = h.shape[-1], g.shape[-1]
    carry = jnp.zeros((C, taps - 1), jnp.complex64)
    c2 = (jnp.zeros((C, taps2 - 1), jnp.float32),
          jnp.zeros((C, taps2 - 1), jnp.float32))
    phase = PHASE0
    out = []
    for blk in blocks:
        y, carry, c2, pk = _pallas(h, g, delta, decim, carry, c2, blk,
                                   phase, static)
        out.append((y, np.asarray(carry),
                    np.asarray(c2[0]) + 1j * np.asarray(c2[1]), pk))
        phase = (phase + delta * B) % 2**32
    return out


def test_front_mt_plain_matches_pallas_mt(monkeypatch):
    monkeypatch.setenv("UHSDR_FRONT_MT", "1")
    h, g, delta, decim = _front()
    blocks = _blocks(2)
    port = _run_port(fir_k.front_mt_plain, h, g, delta, decim, blocks)
    ref = _run_pallas(h, g, delta, decim, blocks, static=True)
    for k, ((y, cr, c2, pk), (yj, crj, c2j, pkj)) in enumerate(zip(port,
                                                                   ref)):
        scale = float(np.abs(yj).max())
        e_y = float(np.abs(yj - y.numpy()).max())
        e_c2 = float(np.abs(c2j - c2.numpy()).max())
        print(f"\nblock {k}: K15 plain vs the bf16 Pallas MT kernel: audio "
              f"max|err| {e_y / scale:.2e}, stage-B carry {e_c2 / scale:.2e} "
              f"of the audio's peak (SNR {snr_db(yj, y):.1f} dB)")
        assert e_y <= BF16_REL * scale and e_c2 <= BF16_REL * scale
        np.testing.assert_array_equal(cr.numpy(), crj)
        np.testing.assert_array_equal(pk.numpy(), pkj)


def test_front_mt_plain_matches_f32_fronts(monkeypatch):
    monkeypatch.delenv("UHSDR_FRONT_MT", raising=False)
    h, g, delta, decim = _front()
    blocks = _blocks(2, seed=62)
    port = _run_port(fir_k.front_mt_plain, h, g, delta, decim, blocks)
    k1 = _run_port(fir_k.front_plain, h, g, delta, decim, blocks)
    ref = _run_pallas(h, g, delta, decim, blocks, static=True)
    for k, ((y, cr, c2, pk), (y1, cr1, c21, pk1), (yj, _, c2j, _)) in \
            enumerate(zip(port, k1, ref)):
        s = {"rotor-plane kernel, audio": snr_db(yj, y),
             "rotor-plane kernel, stage-B carry": snr_db(c2j, c2),
             "K1 plain, audio": snr_db(y1, y),
             "K1 plain, stage-B carry": snr_db(c21, c2)}
        print(f"\nblock {k}: K15 plain vs " + ", ".join(
            f"{n} {v:.1f} dB" for n, v in s.items()))
        assert min(s.values()) >= F32_DB, s
        assert torch.equal(cr, cr1) and torch.equal(pk, pk1)


def test_ssb_chain_with_mt_gate_matches_jax(monkeypatch):
    monkeypatch.setenv("UHSDR_FRONT_MT", "1")

    def k1_must_not_run(*args, **kwargs):
        raise AssertionError("K1 ran with UHSDR_FRONT_MT=1 and a static "
                             "delta")
    monkeypatch.setattr(fir_k, "front", k1_must_not_run)
    common.run_streamed_both_ways(
        dict(mode="usb", bw_key="2P3KHZ", path_name="LPF", iq_rate=96000.0),
        common.CHAIN_DB)


def test_mt_gate_keeps_k1_for_a_retune(monkeypatch):
    """A tune offset makes the delta dynamic: the gate routes to K1."""
    monkeypatch.setenv("UHSDR_FRONT_MT", "1")
    calls = []

    def spy(fn):
        def wrapped(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped
    monkeypatch.setattr(fir_k, "front", spy(fir_k.front))
    monkeypatch.setattr(fir_k, "front_mt", spy(fir_k.front_mt))
    chain = trx.RxChain(trx.RxConfig(**dict(common.FLAGSHIP,
                                            block_len=1024)), device="cpu")
    s = chain.init_state((2,))
    z = np.zeros((2, 1024), np.int16)
    s = chain(s, i=z, q=z)[1]
    chain(s, i=z, q=z, tune_offset_hz=250.0)
    assert calls == ["front_mt", "front"]
