"""The port's command line (`uhsdr_tpu_torch.cli`) against the JAX
package's (`uhsdr_tpu.cli`), in process on the CPU (``--device cpu``).

The same argv goes to both `main`s; the arrays each writes (audio, IQ,
the channelizer's .npy) are taken where the command hands them to its
writer, before the 16-bit WAV rounds them.  Bounds:

* ``rx`` usb, 3 blocks of 4096 at 48 kHz: audio >= 90 dB; the scope's
  dBm within 0.01 dB and its SNAP estimate within 0.1 Hz (the two
  packages' CPU chains part by rounding alone);
* ``rx --decode`` on a short CW message the port's ``tx`` keyed: the
  same text;
* ``tx --mode cw`` >= 100 dB (a keyed carrier through the modulator);
* ``tx --mode usb`` >= 80 dB against the JAX chain with its voice
  bandpass on its off-CPU route, as tests/test_torch_tx.py holds the
  chains (the JAX CPU route's dilated scan sits ~77.5 dB from an exact
  cascade);
* ``channelize`` at 8 channels: the JSON's counts equal, ``rms_max``
  within 1e-4 relative, the .npy >= 90 dB;
* ``config save|show``: the same JSON;
* without ``--device cpu`` and no CUDA, every chain command raises the
  port's `resolve_device` error.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from uhsdr_tpu import cli as jcli
from uhsdr_tpu.chain import tx as jtx
from uhsdr_tpu.io import ingest as jing
from uhsdr_tpu.ops import iir as jiir
from uhsdr_tpu_torch import cli as tcli
from uhsdr_tpu_torch.io import ingest as ting
from uhsdr_tpu_torch.metrics import snr_db

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 48000
AUDIO_DB = 90.0
CW_DB = 100.0
TX_DB = 80.0
DBM_TOL = 0.01
SNAP_TOL_HZ = 0.1


def _run(mod, argv, monkeypatch) -> tuple[dict, dict]:
    """main(argv) of one package: (its last JSON line, {writer: the array
    it was given})."""
    ing = jing if mod is jcli else ting
    got = {}
    for fn in ("write_audio_wav", "write_iq_wav"):
        orig = getattr(ing, fn)

        def keep(path, a, *args, _fn=fn, _orig=orig, **kw):
            got[_fn] = np.array(a)
            _orig(path, a, *args, **kw)
        monkeypatch.setattr(ing, fn, keep)
    if mod is tcli:
        argv = argv + ["--device", "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    monkeypatch.undo()
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1]), got


def _both(argv, monkeypatch):
    return _run(jcli, argv, monkeypatch), _run(tcli, argv, monkeypatch)


@pytest.fixture(scope="module")
def usb_capture(tmp_path_factory):
    """3 blocks of a tone at +6.7 kHz with noise, 16-bit IQ WAV."""
    n = 3 * 4096 + 100
    rng = np.random.default_rng(21)
    t = np.arange(n) / FS
    iq = (0.3 * np.exp(2j * np.pi * 6700.0 * t) + 0.01 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    path = str(tmp_path_factory.mktemp("cap") / "usb.wav")
    ting.write_iq_wav(path, iq)
    return path


def test_rx_usb_matches_jax(usb_capture, tmp_path, monkeypatch):
    argv = ["rx", "--input", usb_capture, "--out", str(tmp_path / "a.wav"),
            "--max-blocks", "3"]
    (jm, ja), (tm, ta) = _both(argv, monkeypatch)
    assert (tm["blocks"], tm["samples"]) == (jm["blocks"], jm["samples"]) \
        == (3, 3 * 4096)
    s = snr_db(ja["write_audio_wav"], ta["write_audio_wav"])
    assert s >= AUDIO_DB, s
    assert abs(tm["audio_rms"] - jm["audio_rms"]) <= 1e-4 * jm["audio_rms"]
    assert abs(tm["dbm"] - jm["dbm"]) <= DBM_TOL, (tm, jm)
    assert abs(tm["snap_freq_hz"] - jm["snap_freq_hz"]) <= SNAP_TOL_HZ


def test_rx_decode_cw_text_equal(tmp_path, monkeypatch):
    iq = str(tmp_path / "cw.wav")
    tm, _ = _run(tcli, ["tx", "--out", iq, "--mode", "cw", "--text", "TE",
                        "--wpm", "30"], monkeypatch)
    assert tm["samples"] > 0
    (jm, _), (tm, _) = _both(["rx", "--input", iq, "--mode", "cw",
                              "--decode"], monkeypatch)
    assert tm["text"] == jm["text"]
    assert tm["text"].replace(" ", "").startswith("TE"), tm["text"]


def test_tx_cw_matches_jax(tmp_path, monkeypatch):
    argv = ["tx", "--out", str(tmp_path / "iq.wav"), "--mode", "cw",
            "--text", "CQ", "--wpm", "28"]
    (jm, ja), (tm, ta) = _both(argv, monkeypatch)
    assert tm == jm | {"out": tm["out"]}
    s = snr_db(ja["write_iq_wav"], ta["write_iq_wav"])
    assert s >= CW_DB, s


def test_tx_usb_matches_jax(tmp_path, monkeypatch):
    t = np.arange(3 * 4096 + 100) / FS
    mic = str(tmp_path / "mic.wav")
    ting.write_audio_wav(mic, 0.5 * np.sin(2 * np.pi * 700.0 * t),
                         norm=False)
    argv = ["tx", "--out", str(tmp_path / "iq.wav"), "--mode", "usb",
            "--audio-in", mic]

    def exact_voice_sos(sos, state, x, precise=False):
        return jiir.biquad_cascade_blocked(np.asarray(sos), state, x,
                                           exact_carry=True)
    monkeypatch.setattr(jtx, "_voice_sos", exact_voice_sos)
    jm, ja = _run(jcli, argv, monkeypatch)
    tm, ta = _run(tcli, argv, monkeypatch)
    assert tm["samples"] == jm["samples"] == 3 * 4096
    s = snr_db(ja["write_iq_wav"], ta["write_iq_wav"])
    assert s >= TX_DB, s


def test_channelize_matches_jax(tmp_path, monkeypatch):
    M, T, n_blocks = 8, 2048, 3
    n = M * T * n_blocks
    rng = np.random.default_rng(22)
    t = np.arange(n) / (M * FS)
    # tones in channels 2 and 5 (+6.7 kHz into each), noise elsewhere
    iq = sum(a * np.exp(2j * np.pi * (k * FS + 6700.0) * t)
             for k, a in ((2, 0.3), (5, 0.1))) + 0.003 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    cap = str(tmp_path / "wide.wav")
    ting.write_iq_wav(cap, iq.astype(np.complex64), fs=M * FS)
    out = {}
    for name, mod in (("jax", jcli), ("port", tcli)):
        npy = str(tmp_path / f"{name}.npy")
        m, _ = _run(mod, ["channelize", "--input", cap, "--channels",
                          str(M), "--block", str(T), "--out", npy],
                    monkeypatch)
        out[name] = (m, np.load(npy))
    (jm, ja), (tm, ta) = out["jax"], out["port"]
    for k in ("blocks", "channels", "samples_per_channel", "rms_argmax",
              "active_channels"):
        assert tm[k] == jm[k], k
    assert (tm["rms_argmax"], tm["blocks"]) == (2, n_blocks)
    assert abs(tm["rms_max"] - jm["rms_max"]) <= 1e-4 * jm["rms_max"]
    assert ta.shape == ja.shape == (M, T * n_blocks)
    s = snr_db(ja, ta)
    assert s >= AUDIO_DB, s


def test_config_save_show_equal(tmp_path, monkeypatch):
    res = {}
    for name, mod in (("jax", jcli), ("port", tcli)):
        path = str(tmp_path / f"{name}.json")
        outs = []
        for argv in (["config", "save", "--file", path, "--set",
                      "cw_speed_wpm=25", "--set", "agc_mode=fast"],
                     ["config", "show", "--file", path],
                     ["config", "show", "--file", str(tmp_path / "none")]):
            f = io.StringIO()
            with contextlib.redirect_stdout(f):
                assert mod.main(argv) == 0
            outs.append(json.loads(f.getvalue()))
        outs[0]["saved"] = os.path.basename(outs[0]["saved"])
        res[name] = (outs, open(path).read())
    assert res["port"][0][1:] == res["jax"][0][1:]
    assert res["port"][0][0]["entries"] == res["jax"][0][0]["entries"]
    assert res["port"][1] == res["jax"][1]
    assert res["port"][0][1]["cw_speed_wpm"] == 25
    with contextlib.redirect_stderr(io.StringIO()):
        assert tcli.main(["config", "save", "--file", str(tmp_path / "x"),
                          "--set", "no_such=1"]) == 1


def test_conformance_runs_the_port_conformance_files(monkeypatch):
    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda cmd, cwd=None: calls.append((cmd, cwd)) or 0)
    assert tcli.main(["conformance"]) == 0
    (cmd, cwd), = calls
    assert cwd is not None and os.path.samefile(cwd, REPO)
    files = [a for a in cmd if a.startswith("tests/")]
    assert "tests/test_torch_conformance.py" in files
    assert all(os.path.basename(f).startswith("test_torch_conformance")
               for f in files)


def test_python_dash_m_runs(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "uhsdr_tpu_torch.cli",
                        "config", "show", "--file", str(tmp_path / "no")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["agc_mode"] == "med"


@pytest.mark.parametrize("argv", [
    ["rx", "--input", "{cap}"],
    ["rx", "--input", "{cap}", "--mode", "freedv1600"],
    ["tx", "--out", "{tmp}/o.wav"],
    ["channelize", "--input", "{cap}", "--channels", "4"],
    ["serve", "--input", "{cap}", "--port", "0"],
], ids=["rx", "rx_freedv", "tx", "channelize", "serve"])
def test_chain_commands_need_cuda_unless_told(argv, usb_capture, tmp_path,
                                              monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a.format(cap=usb_capture, tmp=tmp_path) for a in argv]
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        tcli.main(argv)
