"""Runtime self-tests / failure detection.

Twin-peaks monitor — reference `AudioDriver_RxHandleTwinpeaks`
(`audio_driver.c:2173-2253`): the codec occasionally boots with I and Q
misaligned by one sample, destroying mirror rejection ("twinpeak
syndrome").  The firmware measures the I/Q phase from the Moseley-Slump
accumulators, and if it is implausible restarts the codec; after 4
failed restarts it declares the fault uncorrectable.

Here the same state machine runs per channel in the control plane (block
cadence, host side).  The "codec restart" action becomes a callback the
ingest runtime uses to resynchronize its source (and the chain resets the
IQ-correction state).  Semantics preserved:

* WAIT: settle for 1000 blocks (0.667 s at the reference cadence);
* SAMPLING: phase = asin(teta1/teta3) smoothed 0.05/0.95 over 50 runs;
* |phase| > pi/8 (22.5 deg)  -> RESTART_REQUESTED, else DONE;
* >= 4 restarts -> UNCORRECTABLE.

A copy of the JAX package's module of the same name (the port
imports nothing of that package): the same classes and decisions,
its imports re-pointed at the port's own modules.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

SETTLE_BLOCKS = 1000
PHASE_RUNS = 50
PHASE_ALPHA = 0.05
PHASE_THRESHOLD = np.pi / 8.0
MAX_RESTARTS = 4


class TwinpeaksStatus(enum.Enum):
    SAMPLING = 0
    DONE = 1
    WAIT = 2
    UNCORRECTABLE = 3
    RESTART_REQUESTED = 4


@dataclass
class TwinpeaksMonitor:
    """Per-channel twin-peaks state machines (vectorized over channels)."""
    n_channels: int
    status: np.ndarray = field(init=False)
    _settle: np.ndarray = field(init=False)
    _phase: np.ndarray = field(init=False)
    _runs: np.ndarray = field(init=False)
    _restarts: np.ndarray = field(init=False)

    def __post_init__(self):
        n = self.n_channels
        self.status = np.full(n, TwinpeaksStatus.WAIT.value, np.int32)
        self._settle = np.zeros(n, np.int64)
        self._phase = np.zeros(n, np.float64)
        self._runs = np.zeros(n, np.int64)
        self._restarts = np.zeros(n, np.int64)

    def update(self, teta1: np.ndarray, teta3: np.ndarray,
               blocks_elapsed: int = 1) -> np.ndarray:
        """Feed the current smoothed Moseley-Slump accumulators
        (per-channel) once per processed block.  Returns channel indices
        for which a source restart is requested."""
        t1 = np.asarray(teta1, np.float64)
        t3 = np.asarray(teta3, np.float64)
        st = self.status

        waiting = st == TwinpeaksStatus.WAIT.value
        self._settle[waiting] += blocks_elapsed
        settled = waiting & (self._settle > SETTLE_BLOCKS)
        st[settled] = TwinpeaksStatus.SAMPLING.value
        self._settle[settled] = 0
        self._phase[settled] = 0.0
        self._runs[settled] = 0

        sampling = (st == TwinpeaksStatus.SAMPLING.value) & (t3 != 0.0)
        ratio = np.clip(np.divide(t1, np.where(t3 == 0, 1.0, t3)), -1.0, 1.0)
        cur = np.arcsin(ratio)
        first = sampling & (self._runs == 0)
        self._phase[first] = cur[first]
        later = sampling & (self._runs > 0)
        self._phase[later] = (PHASE_ALPHA * cur[later]
                              + (1 - PHASE_ALPHA) * self._phase[later])
        self._runs[sampling] += 1

        decide = sampling & (self._runs == PHASE_RUNS)
        bad = decide & (np.abs(self._phase) > PHASE_THRESHOLD)
        good = decide & ~bad
        st[good] = TwinpeaksStatus.DONE.value
        self._restarts[good] = 0
        self._restarts[bad] += 1
        st[bad] = TwinpeaksStatus.RESTART_REQUESTED.value
        uncorrectable = bad & (self._restarts >= MAX_RESTARTS)
        st[uncorrectable] = TwinpeaksStatus.UNCORRECTABLE.value
        self._restarts[uncorrectable] = 0
        return np.flatnonzero(st == TwinpeaksStatus.RESTART_REQUESTED.value)

    def acknowledge_restart(self, channels) -> None:
        """The source was restarted for these channels; re-enter WAIT
        (reference: `ui_driver.c:7422-7426` sets TWINPEAKS_WAIT)."""
        self.status[channels] = TwinpeaksStatus.WAIT.value
        self._settle[channels] = 0
        self._runs[channels] = 0
