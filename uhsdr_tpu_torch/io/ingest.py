"""IQ capture ingest — Python binding to the native runtime.

The native engine (`runtime/iq_ingest.cpp`) is the framework's data-plane
transport, the analog of the reference's I2S DMA double-buffering + USB
audio streaming (`uhsdr_hw_i2s.c`, `usbd_audio_if.c`): a producer thread
reads raw int16 IQ (or 16-bit stereo WAV) into a ring of blocks —
pre-converted f32 planes, or UNCONVERTED int16 planes in raw_i16 mode
(half the ring memory/traffic; the chain's int16 ingest path converts in
its front kernel); `next_block()` pops without blocking on disk.

Falls back to a pure-NumPy reader when the shared library is missing
(e.g. before `make -C runtime`).

A copy of the JAX package's module of the same name (the port
imports nothing of that package): the same classes and decisions,
its imports re-pointed at the port's own modules.
"""
from __future__ import annotations

import ctypes
import os
import wave

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "runtime",
    "libuhsdr_ingest.so")


def _load_lib():
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.uhsdr_ingest_open.restype = ctypes.c_void_p
    lib.uhsdr_ingest_open.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                      ctypes.c_long, ctypes.c_int]
    lib.uhsdr_ingest_next.restype = ctypes.c_long
    lib.uhsdr_ingest_next.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.POINTER(ctypes.c_float)]
    lib.uhsdr_ingest_close.argtypes = [ctypes.c_void_p]
    try:
        lib.uhsdr_ingest_open2.restype = ctypes.c_void_p
        lib.uhsdr_ingest_open2.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                           ctypes.c_long, ctypes.c_int,
                                           ctypes.c_int]
        lib.uhsdr_ingest_next_i16.restype = ctypes.c_long
        lib.uhsdr_ingest_next_i16.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_int16)]
        lib._has_i16 = True
    except AttributeError:       # stale .so without the raw_i16 mode
        lib._has_i16 = False
    lib.uhsdr_fleet_open.restype = ctypes.c_void_p
    lib.uhsdr_fleet_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                     ctypes.c_long, ctypes.c_long,
                                     ctypes.c_long, ctypes.c_int]
    lib.uhsdr_fleet_next.restype = ctypes.c_long
    lib.uhsdr_fleet_next.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.POINTER(ctypes.c_float)]
    lib.uhsdr_fleet_close.argtypes = [ctypes.c_void_p]
    return lib


def _load_sink_lib():
    path = os.path.join(os.path.dirname(_LIB_PATH), "libuhsdr_sink.so")
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.uhsdr_sink_open.restype = ctypes.c_void_p
    lib.uhsdr_sink_open.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                    ctypes.c_int, ctypes.c_long,
                                    ctypes.c_long]
    lib.uhsdr_sink_push.restype = ctypes.c_int
    lib.uhsdr_sink_push.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_long]
    lib.uhsdr_sink_dropped.restype = ctypes.c_long
    lib.uhsdr_sink_dropped.argtypes = [ctypes.c_void_p]
    lib.uhsdr_sink_written.restype = ctypes.c_long
    lib.uhsdr_sink_written.argtypes = [ctypes.c_void_p]
    lib.uhsdr_sink_close.argtypes = [ctypes.c_void_p]
    return lib


_LIB = _load_lib()
_SINK_LIB = _load_sink_lib()


class IqIngest:
    """Streaming IQ block source.  Produces (i_plane, q_plane) float32 —
    or UNCONVERTED int16 planes with raw_i16=True (half the ring memory,
    memcpy and host->device traffic; `chain.rx.process_block` takes the
    (i16, q16) tuple directly and the front kernel converts it)."""

    def __init__(self, path: str, block_samples: int,
                 ring_blocks: int = 4, loop: bool = False,
                 force_numpy: bool = False, raw_i16: bool = False):
        self.block = block_samples
        self.raw_i16 = raw_i16
        self._native = None
        self._np_data = None
        self._np_pos = 0
        self._loop = loop
        use_native = (_LIB is not None and not force_numpy
                      and (not raw_i16 or getattr(_LIB, "_has_i16", False)))
        if use_native:
            if getattr(_LIB, "_has_i16", False):
                h = _LIB.uhsdr_ingest_open2(path.encode(), block_samples,
                                            ring_blocks, int(loop),
                                            int(raw_i16))
            else:
                # Stale .so without the raw_i16 mode: the f32 path still
                # works through the original entry point (raw_i16 with a
                # stale lib already fell back to numpy via use_native).
                h = _LIB.uhsdr_ingest_open(path.encode(), block_samples,
                                           ring_blocks, int(loop))
            if not h:
                raise OSError(f"ingest_open failed: {path}")
            self._native = h
        elif raw_i16:
            i16, q16 = read_iq_file_i16(path)
            self._np_data = (i16, q16)
        else:
            self._np_data = read_iq_file(path)

    def next_block(self):
        """Returns (i, q) planes of block length — float32, or int16 in
        raw_i16 mode — or None at stream end."""
        if self._native is not None:
            if self.raw_i16:
                i = np.empty(self.block, np.int16)
                q = np.empty(self.block, np.int16)
                n = _LIB.uhsdr_ingest_next_i16(
                    self._native,
                    i.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                    q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
            else:
                i = np.empty(self.block, np.float32)
                q = np.empty(self.block, np.float32)
                n = _LIB.uhsdr_ingest_next(
                    self._native,
                    i.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if n < 0:  # wrong-mode sentinel; must survive `python -O`
                raise RuntimeError("ingest mode mismatch (raw_i16 flag "
                                   "does not match the open mode)")
            if n == 0:
                return None
            return i, q
        # numpy fallback
        if self.raw_i16:
            i16, q16 = self._np_data
            if self._np_pos >= len(i16):
                if not self._loop:
                    return None
                self._np_pos = 0
            end = self._np_pos + self.block
            ci, cq = i16[self._np_pos:end], q16[self._np_pos:end]
            self._np_pos = end
            if len(ci) < self.block:
                ci = np.pad(ci, (0, self.block - len(ci)))
                cq = np.pad(cq, (0, self.block - len(cq)))
            return ci.copy(), cq.copy()
        z = self._np_data
        if self._np_pos >= len(z):
            if not self._loop:
                return None
            self._np_pos = 0
        end = self._np_pos + self.block
        chunk = z[self._np_pos:end]
        self._np_pos = end
        if len(chunk) < self.block:
            chunk = np.pad(chunk, (0, self.block - len(chunk)))
        return (np.ascontiguousarray(chunk.real, np.float32),
                np.ascontiguousarray(chunk.imag, np.float32))

    def close(self):
        if self._native is not None:
            _LIB.uhsdr_ingest_close(self._native)
            self._native = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_iq_file_i16(path: str):
    """Whole-file IQ read as UNCONVERTED (i16, q16) planes."""
    if path.lower().endswith(".wav"):
        with wave.open(path, "rb") as w:
            assert w.getnchannels() == 2 and w.getsampwidth() == 2
            raw = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    else:
        raw = np.fromfile(path, np.int16)
    raw = raw[: len(raw) // 2 * 2]
    return raw[0::2].copy(), raw[1::2].copy()


def read_iq_file(path: str) -> np.ndarray:
    """Whole-file IQ read (int16 interleaved raw, or stereo WAV)."""
    if path.lower().endswith(".wav"):
        with wave.open(path, "rb") as w:
            assert w.getnchannels() == 2 and w.getsampwidth() == 2
            raw = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    else:
        raw = np.fromfile(path, np.int16)
    raw = raw[: len(raw) // 2 * 2].astype(np.float32) / 32768.0
    return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)


def write_iq_wav(path: str, iq: np.ndarray, fs: int = 48000) -> None:
    """Write complex IQ to 16-bit stereo WAV (the capture format the
    reference's digital-IQ USB mode produces)."""
    scaled = np.clip(np.stack([iq.real, iq.imag], -1) * 32767, -32768, 32767)
    inter = scaled.astype(np.int16).reshape(-1)
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(inter.tobytes())


def write_audio_wav(path: str, audio: np.ndarray, fs: int = 48000,
                    norm: bool = True) -> None:
    """Mono (T,) or stereo (2, T) audio -> 16-bit WAV (stereo for the
    two-channel demod modes: DEMOD_IQ/SSBSTEREO/SAM-stereo)."""
    a = np.asarray(audio, np.float64)
    if norm and np.max(np.abs(a)) > 0:
        a = a / np.max(np.abs(a)) * 0.9
    nch = 1 if a.ndim == 1 else a.shape[0]
    if a.ndim > 1:
        a = a.T.reshape(-1)  # interleave L/R
    with wave.open(path, "wb") as w:
        w.setnchannels(nch)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes((a * 32767).astype(np.int16).tobytes())


class FleetIngest:
    """Batched multi-channel IQ source: N capture files -> (C, block)
    f32 planes per pop (the native runtime gathers one block from every
    channel's producer thread).  Falls back to per-file Python readers
    when the native library is absent."""

    def __init__(self, paths, block_samples: int, ring_blocks: int = 4,
                 loop: bool = False):
        self.paths = list(paths)
        self.block = int(block_samples)
        self.n = len(self.paths)
        self._handle = None
        self._fallback = None
        if _LIB is not None and hasattr(_LIB, "uhsdr_fleet_open"):
            arr = (ctypes.c_char_p * self.n)(
                *[p.encode() for p in self.paths])
            self._handle = _LIB.uhsdr_fleet_open(arr, self.n, self.block,
                                                 ring_blocks, int(loop))
        if self._handle is None:
            self._fallback = [IqIngest(p, block_samples, ring_blocks,
                                       loop) for p in self.paths]

    def next_block(self):
        """-> (i (C, block), q (C, block)) or None at end of any file."""
        if self._handle is not None:
            i_out = np.empty((self.n, self.block), np.float32)
            q_out = np.empty((self.n, self.block), np.float32)
            got = _LIB.uhsdr_fleet_next(
                self._handle,
                i_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                q_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if got == 0:
                return None
            return i_out, q_out
        outs = [src.next_block() for src in self._fallback]
        if any(o is None for o in outs):
            return None
        return (np.stack([o[0] for o in outs]),
                np.stack([o[1] for o in outs]))

    def close(self):
        if self._handle is not None:
            _LIB.uhsdr_fleet_close(self._handle)
            self._handle = None
        if self._fallback:
            for s in self._fallback:
                s.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class AudioSink:
    """Streaming audio output — the codec-DAC / USB-audio-OUT transport
    (`uhsdr_hw_i2s.c` TX double buffer, `usbd_audio_if.c`).

    The DSP loop pushes float32 blocks and never blocks on disk I/O or
    the f32->int16 conversion (native writer thread,
    `runtime/audio_sink.cpp`); overflow drops whole blocks and counts
    them (the reference's TX-underrun-counter role).  Falls back to a
    synchronous pure-Python WAV writer when the native library is not
    built.
    """

    def __init__(self, path: str, fs: int = 48000, channels: int = 1,
                 block_samples: int = 8192, ring_blocks: int = 8):
        self.channels = channels
        self.block = block_samples
        self._native = None
        self._wave = None
        if _SINK_LIB is not None:
            h = _SINK_LIB.uhsdr_sink_open(path.encode(), fs, channels,
                                          block_samples, ring_blocks)
            if h:
                self._native = h
        if self._native is None:
            self._wave = wave.open(path, "wb")
            self._wave.setnchannels(channels)
            self._wave.setsampwidth(2)
            self._wave.setframerate(fs)
            self._py_written = 0

    def push(self, audio: np.ndarray) -> bool:
        """audio: (T,) mono or (channels, T) f32 in [-1, 1].
        Returns False if the block was dropped (ring overflow)."""
        a = np.asarray(audio, np.float32)
        if a.ndim == 2:            # (ch, T) -> interleaved (T*ch,)
            a = np.ascontiguousarray(a.T).reshape(-1)
            n = audio.shape[-1]
        else:
            n = a.size
        if self._native is not None:
            ok = _SINK_LIB.uhsdr_sink_push(
                self._native, a.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float)), n)
            return bool(ok)
        pcm = np.clip(a * 32767.0, -32768, 32767).astype(np.int16)
        self._wave.writeframes(pcm.tobytes())
        self._py_written += n
        return True

    @property
    def dropped(self) -> int:
        if self._native is not None:
            return int(_SINK_LIB.uhsdr_sink_dropped(self._native))
        return 0

    @property
    def written(self) -> int:
        """Frames flushed to disk so far."""
        if self._native is not None:
            return int(_SINK_LIB.uhsdr_sink_written(self._native))
        return self._py_written

    def close(self) -> None:
        if self._native is not None:
            _SINK_LIB.uhsdr_sink_close(self._native)
            self._native = None
        elif self._wave is not None:
            self._wave.close()
            self._wave = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
