"""Profiling / observability.

The reference instruments with a DWT cycle-counter event profiler
(`misc/profiling.{h,c}`: profileTimedEventStart/Stop accumulating
count+duration per event slot, wrapped around the audio interrupt and NR)
plus ITM trace and GPIO scope toggles.  The port's equivalents, as the
JAX package's (`EventProfiler` and `throughput` are copies of its):

  * `EventProfiler` — named accumulating timers with counts/total/mean,
    the direct analog of the ProfileEvent slots;
  * `throughput()` — samples/s counters;
  * `trace()` — context manager around `torch.profiler`, the host's ops
    and, where CUDA is present, the card's kernels, written into `logdir`
    as a Chrome trace (chrome://tracing, Perfetto).
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass


@dataclass
class _Slot:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


class EventProfiler:
    """Accumulating named event timers (ProfileTP1..9 analog)."""

    def __init__(self):
        self.slots: dict[str, _Slot] = {}
        self._open: dict[str, float] = {}

    def start(self, name: str) -> None:
        self._open[name] = time.perf_counter()

    def stop(self, name: str) -> None:
        t0 = self._open.pop(name, None)
        if t0 is None:
            return
        dt = time.perf_counter() - t0
        slot = self.slots.setdefault(name, _Slot())
        slot.count += 1
        slot.total_s += dt
        slot.max_s = max(slot.max_s, dt)

    @contextlib.contextmanager
    def event(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def report(self) -> dict:
        return {k: {"count": s.count, "total_ms": s.total_s * 1e3,
                    "mean_ms": s.mean_s * 1e3, "max_ms": s.max_s * 1e3}
                for k, s in sorted(self.slots.items())}


def throughput(samples: int, channels: int, seconds: float) -> dict:
    total = samples * channels
    return {
        "samples_per_s": total / seconds,
        "msamples_per_s": total / seconds / 1e6,
        "realtime_channels_48k": total / seconds / 48000.0,
        "x_realtime_vs_reference": total / seconds / 48000.0,
    }


@contextlib.contextmanager
def trace(logdir: str):
    """A `torch.profiler` trace of the block, CPU ops and (where CUDA is
    present) the card's kernels, written to ``logdir/trace.json``.  Yields
    the profiler, whose ``key_averages()`` the caller may read."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
