"""The port's live radio server (`uhsdr_tpu_torch.control.server`) on the
CPU (``device="cpu"``), against the port's chains run directly and the
JAX package's server.

* RX: the pump's audio and telemetry are bit-equal to the port's
  `RxChain` and scope run block by block on the same capture; the first
  3 blocks are held to the JAX server's at >= 90 dB (the two packages'
  CPU chains part by rounding alone).
* A CAT retune over TCP, mid-stream: the audio is bit-equal to the chain
  run with the `tune_offset_hz` the pump gave each block (0, then the
  retune), and the retuned station's tone is heard: the counterpart of
  tests/test_server.py's retune checks.
* A CAT mode switch rebuilds the chain between blocks (usb -> am ->
  usb), and a switch to the mode the chain runs does not.
* PTT with queued CW text: the TX IQ is bit-equal to the port's `TxChain`
  keyed by the same text.
* An error on the pump (a capture that does not open) is kept in
  ``error`` and makes ``serve`` exit 1.
* A kernel build begun on two threads at once (the pump's first launch
  beside `build_all`) finishes on both, each nvcc writing its own file.

Every wait has its own timeout and every test stops its server in
``finally``.
"""
from __future__ import annotations

import contextlib
import io
import os
import sys
import threading

import numpy as np
import pytest

from uhsdr_tpu.control import server as jserver
from uhsdr_tpu_torch import cli as tcli
from uhsdr_tpu_torch.chain import rx, tx
from uhsdr_tpu_torch.control import cat
from uhsdr_tpu_torch.control import server
from uhsdr_tpu_torch.cuda import build
from uhsdr_tpu_torch.io import ingest
from uhsdr_tpu_torch.metrics import snr_db
from uhsdr_tpu_torch.modems import cw_text
from uhsdr_tpu_torch.spectrum import scope

FS = 48000.0
CENTER = 14_001_000
BLOCK = 2048
N_BLOCKS = 4
JAX_DB = 90.0
WAIT_S = 120.0


def _dominant_hz(x, fs=FS):
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    spec[:8] = 0.0
    return np.fft.rfftfreq(len(x), 1 / fs)[np.argmax(spec)]


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """Station A at the dial (700 Hz audio), station B 1.5 kHz up (1000 Hz
    when dialed to it), N_BLOCKS blocks, 16-bit IQ WAV."""
    t = np.arange(N_BLOCKS * BLOCK) / FS
    iq = (0.4 * np.exp(2j * np.pi * (6000.0 + 700.0) * t)
          + 0.3 * np.exp(2j * np.pi * (6000.0 + 1500.0 + 1000.0) * t)
          ).astype(np.complex64)
    path = str(tmp_path_factory.mktemp("serve") / "capture.wav")
    ingest.write_iq_wav(path, iq, fs=int(FS))
    return path


def _cfg(mod, capture, **kw):
    base = dict(iq_path=capture, center_hz=CENTER, block_len=BLOCK,
                mode="usb", bw_key="2P3KHZ", loop=False)
    if mod is server:
        base["device"] = "cpu"
    return mod.ServeConfig(**{**base, **kw})


def _run_to_end(radio) -> None:
    """Start a non-looping server and wait for its pump to end."""
    radio.start()
    radio._thread.join(timeout=WAIT_S)
    assert not radio._thread.is_alive(), "pump did not end"
    assert radio.error is None, radio.error


def _direct(capture, offsets, mode="usb"):
    """The port's chain and scope run block by block as the pump runs
    them: (audio, [(dbm, s_meter, snap) per block])."""
    c = _cfg(server, capture, mode=mode)
    cfg = rx.RxConfig(mode=mode, bw_key=c.bw_key,
                      translate_hz=c.translate_hz, agc_mode=c.agc_mode,
                      block_len=BLOCK)
    chain = rx.RxChain(cfg, device="cpu")
    state = chain.init_state((1,))
    scp = scope.make_params(translate_hz=c.translate_hz,
                            f_lo=cfg.path.audio_band[0],
                            f_hi=cfg.path.audio_band[1], mode=mode,
                            dbm_constant=c.dbm_cal)
    sst = scope.init_state((1,), scp, device="cpu")
    audio, tele = [], []
    with ingest.IqIngest(capture, BLOCK, loop=True) as src:
        for off in offsets:
            i, q = src.next_block()
            y, state, taps = chain(state, i=i[None], q=q[None],
                                   tune_offset_hz=off)
            out, sst = scope.process(scp, sst, taps["spectrum_iq"])
            audio.append(y[0].numpy())
            dbm = out["dbm"][:1]
            tele.append(tuple(float(v) for v in (
                dbm[0], scope.dbm_to_s_units(dbm)[0], out["snap_freq"][0])))
    return np.concatenate(audio), tele


def test_rx_audio_equals_chain_and_jax_server(capture):
    radio = server.RadioServer(_cfg(server, capture))
    jradio = jserver.RadioServer(_cfg(jserver, capture))
    try:
        _run_to_end(radio)
        _run_to_end(jradio)
    finally:
        radio.stop()
        jradio.stop()
    assert radio.blocks_processed == jradio.blocks_processed == N_BLOCKS
    want, tele = _direct(capture, [0.0] * N_BLOCKS)
    np.testing.assert_array_equal(radio.audio(), want)
    assert (radio.dbm, radio.s_meter, radio.snap_freq_hz) == tele[-1]
    s = snr_db(jradio.audio()[:3 * BLOCK], radio.audio()[:3 * BLOCK])
    assert s >= JAX_DB, s
    assert abs(_dominant_hz(radio.audio()[BLOCK:]) - 700.0) < 30.0


def test_cat_retune_equals_chain_with_tune_offset(capture, monkeypatch):
    offsets = []
    call = rx.RxChain.__call__

    def record(self, state, *a, tune_offset_hz=None, **kw):
        offsets.append(tune_offset_hz)
        return call(self, state, *a, tune_offset_hz=tune_offset_hz, **kw)
    monkeypatch.setattr(rx.RxChain, "__call__", record)
    radio, catsrv = server.serve(_cfg(server, capture, loop=True,
                                      audio_keep_blocks=64))
    client = None
    try:
        client = cat.CatClient(port=catsrv.port)
        assert radio.wait_blocks(3, timeout=WAIT_S), radio.error
        client.set_frequency(CENTER + 1500)
        assert client.get_frequency() == (CENTER + 1500, "usb")
        assert radio.wait_blocks(6, timeout=WAIT_S), radio.error
    finally:
        if client is not None:
            client.close()
        radio.stop()
        catsrv.stop()
    assert radio.error is None, radio.error
    n = radio.blocks_processed
    assert n <= 64 and offsets[:n][0] == 0.0 and offsets[n - 1] == 1500.0
    assert set(offsets[:n]) == {0.0, 1500.0}
    want, tele = _direct(capture, offsets[:n])
    np.testing.assert_array_equal(radio.audio(), want)
    assert (radio.dbm, radio.s_meter, radio.snap_freq_hz) == tele[-1]
    assert abs(_dominant_hz(want[-3 * BLOCK:]) - 1000.0) < 30.0


def test_cat_mode_switch_rebuilds_the_chain(capture, monkeypatch):
    """usb -> am -> usb over CAT: the pump builds an AM chain and then a
    USB one again, between blocks (the JAX server's hook compares with
    the mode the protocol has just written and never rebuilds)."""
    built = []
    init = rx.RxChain.__init__

    def record(self, cfg, *a, **kw):
        built.append(cfg.mode)
        init(self, cfg, *a, **kw)
    monkeypatch.setattr(rx.RxChain, "__init__", record)
    radio, catsrv = server.serve(_cfg(server, capture, loop=True))
    client = None
    try:
        client = cat.CatClient(port=catsrv.port)
        assert radio.wait_blocks(1, timeout=WAIT_S), radio.error
        for mode in ("am", "usb", "usb"):
            assert client.set_mode(mode)
            assert radio.wait_blocks(2, timeout=WAIT_S), radio.error
    finally:
        if client is not None:
            client.close()
        radio.stop()
        catsrv.stop()
    assert radio.error is None, radio.error
    assert built == ["usb", "am", "usb"] and radio.mode == "usb"


def test_ptt_iq_equals_tx_chain(capture):
    text, wpm = "TE", 30.0
    radio, catsrv = server.serve(_cfg(server, capture, loop=True,
                                      cw_wpm=wpm))
    client = None
    try:
        client = cat.CatClient(port=catsrv.port)
        assert client.set_mode("cw")
        assert radio.wait_blocks(2, timeout=WAIT_S), radio.error
        radio.queue_tx_text(text)
        client.ptt(True)
        assert radio.wait_blocks(16, timeout=WAIT_S, tx=True), radio.error
        client.ptt(False)
        assert radio.wait_blocks(1, timeout=WAIT_S), radio.error
    finally:
        if client is not None:
            client.close()
        radio.stop()
        catsrv.stop()
    assert radio.error is None, radio.error
    assert radio.mode == "cw" and radio.fwd_pwr > 0.0
    got = radio.tx_iq()
    n = got.size // BLOCK
    # the text's keying, its last block padded with key-up, then the
    # key-down tune carrier
    key = cw_text.text_to_keying(text, wpm, FS).astype(np.float32)
    n_key = -(-len(key) // BLOCK)
    assert n_key < n <= 64
    src = np.ones(n * BLOCK, np.float32)
    src[:n_key * BLOCK] = 0.0
    src[:len(key)] = key
    chain = tx.TxChain(tx.TxConfig(mode="cw", translate_hz=6000.0,
                                   block_len=BLOCK), device="cpu")
    state = chain.init_state((1,))
    want = []
    for k in range(n):
        i, q, state = chain(state, src[None, k * BLOCK:(k + 1) * BLOCK])
        want.append((i[0] + 1j * q[0]).numpy())
    np.testing.assert_array_equal(got, np.concatenate(want))


def test_pump_error_is_kept_and_serve_exits_1(tmp_path):
    missing = str(tmp_path / "missing.wav")
    radio = server.RadioServer(_cfg(server, missing))
    try:
        radio.start()
        assert not radio.wait_blocks(1, timeout=WAIT_S)
    finally:
        radio.stop()
    assert radio.error is not None
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        rc = tcli.main(["serve", "--input", missing, "--port", "0",
                        "--status-every", "0.05", "--device", "cpu"])
    assert rc == 1 and "error" in err.getvalue()


def test_kernel_build_from_two_threads(tmp_path, monkeypatch):
    """A fake nvcc (writes its -o file half-way through a second) under
    CUDA_HOME: two threads start and finish one source's build at once,
    both writes before either process ends."""
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "time.sleep(0.5)\n"
        "open(out, 'wb').write(b'not a library')\n"
        "time.sleep(0.5)\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    k = build.CudaKernel("two_thread_probe", "cw.cu")
    errors, gate = [], threading.Barrier(2)

    def run():
        try:
            gate.wait(timeout=30)
            k.finish_build(k.start_build())
        except Exception as e:      # collected for the assert below
            errors.append(repr(e))
    try:
        threads = [threading.Thread(target=run) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        build._ALL.remove(k)
    assert errors == []
    assert k._lib_path().read_bytes() == b"not a library"
    assert not list((tmp_path / "_build").glob("*.tmp"))
    assert os.environ["CUDA_HOME"] == str(tmp_path / "cuda")
