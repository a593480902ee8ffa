"""The port's `FreeDvFleetGroup` against the JAX package's, on the CPU
(K5's plain version with a delta a channel).

The two groups take the same 48 kHz planes.  The JAX group mixes in XLA
and decimates by FFT convolution over a post-mix history; the port's runs
the translation and the decimation as one K5 call over a raw history.
Held: each block's 8 kHz baseband >= 100 dB, the NCO phases equal, the
histories >= 100 dB after conversion (`state_to_numpy`), and every
decision downstream equal: frames a channel, parity counts, LDPC
failures and the decoded speech bit for bit.  The state is handed over
mid-stream both ways and the stream goes on as if it had not been.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal

from uhsdr_tpu import data as jdata
from uhsdr_tpu.modems import freedv as jfdv
from uhsdr_tpu.parallel import fleet as jfleet
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.parallel import fleet as tfleet

FS = 48000.0
TOL_DB = 100.0
BLOCK = 7680
OFFSETS = [0.0, 700.0, -1200.0]


def _snr(ref, got) -> float:
    return snr_db(torch.as_tensor(np.array(ref)),
                  torch.as_tensor(np.array(got)))


def _speech(seconds: float) -> np.ndarray:
    t8 = np.arange(int(8000 * seconds)) / 8000.0
    f0 = 120 + 25 * np.sin(2 * np.pi * 1.1 * t8)
    return (5000 * np.sin(np.cumsum(2 * np.pi * f0 / 8000.0))).astype(
        np.float32)


def _planes(iq48: np.ndarray, offsets) -> tuple[np.ndarray, np.ndarray]:
    T = BLOCK * (len(iq48) // BLOCK)
    n = np.arange(T)
    z = np.stack([iq48[:T] * np.exp(2j * np.pi * f * n / FS)
                  for f in offsets])
    return (np.ascontiguousarray(z.real).astype(np.float32),
            np.ascontiguousarray(z.imag).astype(np.float32))


def transmission(mode: str, offsets) -> tuple[np.ndarray, np.ndarray]:
    """A 4 s FreeDV transmission of the mode (the JAX group's test
    signal), raised to 48 kHz and put at each channel's offset."""
    tx = (jfdv.FreeDv1600(vocoder="codec2") if mode == "freedv1600"
          else jfdv.FreeDv700D())
    iq48 = signal.resample_poly(tx.mod(_speech(4.0)), 6, 1).astype(
        np.complex64)
    return _planes(iq48, offsets)


def recorded(offsets) -> tuple[np.ndarray, np.ndarray]:
    """The firmware's recorded 1600 IQ raised to 48 kHz as
    tests/test_freedv_mode.py does, at each channel's offset."""
    iq8 = jdata.freedv("test_iq")
    iq8 = iq8 / (np.max(np.abs(iq8)) + 1e-9)
    up = np.zeros(len(iq8) * 6, np.complex128)
    up[::6] = iq8
    z = signal.lfilter(signal.firwin(96, 3500.0, fs=FS) * 6, [1.0], up)
    return _planes(z.astype(np.complex64), offsets)


def jax_state(g) -> dict:
    """The JAX group's state in `state_to_numpy`'s layout."""
    return {"phases": np.asarray(g._phases), "ci": np.asarray(g._ci),
            "cq": np.asarray(g._cq),
            "modem": tfleet.modem_state(g._fleet_modem)}


def set_jax_state(g, s: dict):
    g._phases = jnp.asarray(s["phases"])
    g._ci, g._cq = jnp.asarray(s["ci"]), jnp.asarray(s["cq"])
    tfleet.load_modem_state(g._fleet_modem, s["modem"])


def run(group, xi, xq, blocks) -> dict:
    """Drive a group over the blocks; per block its baseband, speech and
    state (the JAX group's read as `jax_state`)."""
    out = {"base": [], "speech": [], "state": []}
    for k in blocks:
        s = slice(k * BLOCK, (k + 1) * BLOCK)
        iq8 = group.front_block(xi[:, s], xq[:, s])
        out["base"].append(iq8)
        out["speech"].append(group._fleet_modem.demod(iq8))
        out["state"].append(group.state_to_numpy()
                            if isinstance(group, tfleet.FreeDvFleetGroup)
                            else jax_state(group))
    return out


def assert_same_run(ref: dict, got: dict, jg, tg):
    for k, (a, b) in enumerate(zip(ref["base"], got["base"])):
        assert b.dtype == a.dtype and b.shape == a.shape
        assert _snr(a, b) >= TOL_DB, k
    for k, (a, b) in enumerate(zip(ref["state"], got["state"])):
        np.testing.assert_array_equal(b["phases"], a["phases"])
        assert b["phases"].dtype == np.uint32
        assert _snr(a["ci"] + 1j * a["cq"], b["ci"] + 1j * b["cq"]) \
            >= TOL_DB, k
    for a, b in zip(ref["speech"], got["speech"]):
        for sa, sb in zip(a, b):
            np.testing.assert_array_equal(sb, sa)
    np.testing.assert_array_equal(tg._fleet_modem.frames_per_channel,
                                  jg._fleet_modem.frames_per_channel)
    assert tg.stats == jg.stats


@pytest.fixture(scope="module")
def synthetic_1600():
    xi, xq = transmission("freedv1600", OFFSETS)
    blocks = range(xi.shape[1] // BLOCK)
    jg = jfleet.FreeDvFleetGroup(3, block_len_48k=BLOCK,
                                 translate_hz=np.asarray(OFFSETS))
    tg = tfleet.FreeDvFleetGroup(3, block_len_48k=BLOCK,
                                 translate_hz=np.asarray(OFFSETS),
                                 device="cpu")
    return jg, tg, run(jg, xi, xq, blocks), run(tg, xi, xq, blocks)


def test_group_front_and_state(synthetic_1600):
    """Baseband a block, phases, histories and decisions as the JAX
    group's, at offsets [0, 700, -1200] Hz in blocks of 7680."""
    jg, tg, ref, got = synthetic_1600
    assert_same_run(ref, got, jg, tg)


def test_group_decodes_every_channel(synthetic_1600):
    jg, tg, ref, got = synthetic_1600
    per_ch = tg._fleet_modem.frames_per_channel
    assert (per_ch >= 10).all(), per_ch
    for c in range(3):
        sp = np.concatenate([b[c] for b in got["speech"]])
        rms = float(np.sqrt(np.mean(sp.astype(np.float64) ** 2)))
        assert 10.0 < rms < 20000.0, (c, rms)


def test_group_on_recorded_iq():
    """The firmware's recorded 1600 IQ (the card's capture) at 3 channels
    and offsets 0, +2500 and -3000 Hz: the JAX group's frames, parity and
    speech, and the bounds the card path holds (>= 60 frames a channel,
    parity <= 0.2 x frames)."""
    offsets = [0.0, 2500.0, -3000.0]
    xi, xq = recorded(offsets)
    blocks = range(xi.shape[1] // BLOCK)
    jg = jfleet.FreeDvFleetGroup(3, block_len_48k=BLOCK,
                                 translate_hz=np.asarray(offsets))
    tg = tfleet.FreeDvFleetGroup(3, block_len_48k=BLOCK,
                                 translate_hz=np.asarray(offsets),
                                 device="cpu")
    ref, got = run(jg, xi, xq, blocks), run(tg, xi, xq, blocks)
    assert_same_run(ref, got, jg, tg)
    assert (tg._fleet_modem.frames_per_channel >= 60).all()
    assert tg.stats["parity_errors"] <= 0.2 * tg.stats["frames_decoded"]


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_state_handed_over_mid_stream(first):
    """Two blocks on one package's group, its state handed to the other
    package's, two more there: the same as the JAX group over all four."""
    offsets = [700.0, -1200.0]
    xi, xq = recorded(offsets)

    def jax_group():
        return jfleet.FreeDvFleetGroup(2, block_len_48k=BLOCK,
                                       translate_hz=np.asarray(offsets))

    def torch_group():
        return tfleet.FreeDvFleetGroup(2, block_len_48k=BLOCK,
                                       translate_hz=np.asarray(offsets),
                                       device="cpu")
    jg = jax_group()
    ref = run(jg, xi, xq, range(4))
    if first == "jax":
        a, b = jax_group(), torch_group()
        run(a, xi, xq, range(2))
        b.state_from_numpy(jax_state(a))
    else:
        a, b = torch_group(), jax_group()
        run(a, xi, xq, range(2))
        set_jax_state(b, a.state_to_numpy())
    got = run(b, xi, xq, range(2, 4))
    tail = {k: v[2:] for k, v in ref.items()}
    for k, (x, y) in enumerate(zip(tail["base"], got["base"])):
        assert _snr(x, y) >= TOL_DB, k
    for x, y in zip(tail["state"], got["state"]):
        np.testing.assert_array_equal(y["phases"], x["phases"])
        assert _snr(x["ci"] + 1j * x["cq"], y["ci"] + 1j * y["cq"]) \
            >= TOL_DB
    for x, y in zip(tail["speech"], got["speech"]):
        for sx, sy in zip(x, y):
            np.testing.assert_array_equal(sy, sx)
    np.testing.assert_array_equal(b._fleet_modem.frames_per_channel,
                                  jg._fleet_modem.frames_per_channel)
    assert b.stats == jg.stats
    assert jg._fleet_modem.frames_per_channel.min() > 0


def test_modem_state_round_trip():
    """`modem_state` of a port tier loaded into a fresh one reads back
    the same, and a tier of another class is refused."""
    g = tfleet.FreeDvFleetGroup(2, device="cpu")
    xi, xq = recorded([0.0, 0.0])
    g.process_block(xi[:, :BLOCK], xq[:, :BLOCK])
    s = tfleet.modem_state(g._fleet_modem)
    h = tfleet.FreeDvFleetGroup(2, device="cpu")
    tfleet.load_modem_state(h._fleet_modem, s)
    t = tfleet.modem_state(h._fleet_modem)
    assert t.keys() == s.keys()
    np.testing.assert_array_equal(t["_iq_in"], s["_iq_in"])
    with pytest.raises(ValueError):
        tfleet.load_modem_state(
            tfleet.FreeDvFleetGroup(2, "freedv700d", device="cpu")
            ._fleet_modem, s)


def test_group_700d():
    """Mode 700D at 2 channels: baseband, state and decisions as the JAX
    group's."""
    offsets = [0.0, 900.0]
    xi, xq = transmission("freedv700d", offsets)
    blocks = range(xi.shape[1] // BLOCK)
    jg = jfleet.FreeDvFleetGroup(2, mode="freedv700d", block_len_48k=BLOCK,
                                 translate_hz=np.asarray(offsets))
    tg = tfleet.FreeDvFleetGroup(2, mode="freedv700d", block_len_48k=BLOCK,
                                 translate_hz=np.asarray(offsets),
                                 device="cpu")
    ref, got = run(jg, xi, xq, blocks), run(tg, xi, xq, blocks)
    assert_same_run(ref, got, jg, tg)
    assert (tg._fleet_modem.frames_per_channel >= 5).all()
    assert tg.stats["fec_failures"] == jg.stats["fec_failures"]
