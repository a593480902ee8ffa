"""The port's host I/O (`uhsdr_tpu_torch.io.ingest`) against the JAX
package's, on the CPU.

Both are copies over the same native ring (`runtime/libuhsdr_ingest.so`,
`libuhsdr_sink.so`) with the same NumPy reader where the library is
missing or not asked for, so every result is held equal: the blocks of
`IqIngest` (native and `force_numpy`, f32 and `raw_i16`, looping past the
end of the capture, a ragged last block), `FleetIngest`, the whole-file
readers, the WAV writers byte for byte and `AudioSink`'s files and
counters.
"""
from __future__ import annotations

import numpy as np
import pytest

from uhsdr_tpu.io import ingest as jing
from uhsdr_tpu_torch.io import ingest as ting

FS = 48000


def _capture(path, n: int, seed: int, wav: bool = True):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    iq = (0.4 * np.exp(2j * np.pi * 6700.0 * t) + 0.05 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    if wav:
        jing.write_iq_wav(path, iq)
    else:
        raw = np.stack([iq.real, iq.imag], -1) * 32767
        raw.astype(np.int16).reshape(-1).tofile(path)
    return path


def _blocks(mod, path, block, n_max, **kw) -> list:
    out = []
    with mod.IqIngest(path, block, **kw) as src:
        for _ in range(n_max):
            b = src.next_block()
            if b is None:
                break
            out.append(b)
    return out


def test_native_library_is_shared():
    assert ting._LIB_PATH == jing._LIB_PATH
    assert (ting._LIB is None) == (jing._LIB is None)
    assert (ting._SINK_LIB is None) == (jing._SINK_LIB is None)


@pytest.mark.parametrize("force_numpy", [False, True])
@pytest.mark.parametrize("raw_i16", [False, True])
@pytest.mark.parametrize("loop", [False, True])
@pytest.mark.parametrize("wav", [True, False])
def test_iq_ingest_blocks_equal(tmp_path, force_numpy, raw_i16, loop, wav):
    path = _capture(str(tmp_path / ("c.wav" if wav else "c.raw")),
                    5 * 1024 + 300, 11, wav)
    kw = dict(force_numpy=force_numpy, raw_i16=raw_i16, loop=loop)
    a = _blocks(jing, path, 1024, 14, **kw)
    b = _blocks(ting, path, 1024, 14, **kw)
    assert len(b) == len(a) == (14 if loop else 6)
    for (ai, aq), (bi, bq) in zip(a, b):
        assert bi.dtype == ai.dtype == (np.int16 if raw_i16 else np.float32)
        np.testing.assert_array_equal(bi, ai)
        np.testing.assert_array_equal(bq, aq)


def test_whole_file_readers_equal(tmp_path):
    for wav in (True, False):
        path = _capture(str(tmp_path / ("c.wav" if wav else "c.raw")),
                        3000, 12, wav)
        np.testing.assert_array_equal(ting.read_iq_file(path),
                                      jing.read_iq_file(path))
        for a, b in zip(jing.read_iq_file_i16(path),
                        ting.read_iq_file_i16(path)):
            np.testing.assert_array_equal(b, a)


def test_fleet_ingest_equal(tmp_path):
    paths = [_capture(str(tmp_path / f"c{k}.wav"), 4096 + 512 * k, 20 + k)
             for k in range(3)]
    out = {}
    for name, mod in (("jax", jing), ("port", ting)):
        got = []
        with mod.FleetIngest(paths, 1024) as src:
            while (b := src.next_block()) is not None:
                got.append(b)
        out[name] = got
    assert len(out["port"]) == len(out["jax"]) >= 4
    for (ai, aq), (bi, bq) in zip(out["jax"], out["port"]):
        np.testing.assert_array_equal(bi, ai)
        np.testing.assert_array_equal(bq, aq)


def test_wav_writers_byte_equal(tmp_path):
    rng = np.random.default_rng(13)
    iq = (rng.standard_normal(2000) + 1j * rng.standard_normal(2000)
          ).astype(np.complex64) * 0.7
    mono = rng.standard_normal(3000).astype(np.float32)
    stereo = rng.standard_normal((2, 1500)).astype(np.float32)
    cases = [("write_iq_wav", (iq,), {}),
             ("write_iq_wav", (iq,), {"fs": 96000}),
             ("write_audio_wav", (mono,), {}),
             ("write_audio_wav", (mono * 0.1,), {"norm": False}),
             ("write_audio_wav", (stereo,), {"fs": 12000}),
             ("write_audio_wav", (np.zeros(10, np.float32),), {})]
    for k, (fn, args, kw) in enumerate(cases):
        pa, pb = str(tmp_path / f"j{k}.wav"), str(tmp_path / f"t{k}.wav")
        getattr(jing, fn)(pa, *args, **kw)
        getattr(ting, fn)(pb, *args, **kw)
        assert open(pa, "rb").read() == open(pb, "rb").read(), (fn, kw)


@pytest.mark.parametrize("channels", [1, 2])
def test_audio_sink_equal(tmp_path, channels):
    rng = np.random.default_rng(14 + channels)
    shape = (256,) if channels == 1 else (2, 256)
    blocks = [np.clip(rng.standard_normal(shape) * 0.3, -1, 1
                      ).astype(np.float32) for _ in range(6)]
    res = {}
    for name, mod in (("jax", jing), ("port", ting)):
        path = str(tmp_path / f"{name}.wav")
        with mod.AudioSink(path, fs=FS, channels=channels,
                           block_samples=256, ring_blocks=16) as sink:
            ok = [sink.push(b) for b in blocks]
        res[name] = (ok, sink.dropped, open(path, "rb").read())
    assert res["port"] == res["jax"]
    assert all(res["port"][0]) and len(res["port"][2]) > 6 * 256 * 2
