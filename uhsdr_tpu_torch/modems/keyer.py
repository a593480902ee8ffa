"""CW keyer — iambic A/B, Ultimatic and straight-key state machine.

Reference: `CwGen_Process` / `CwGen_ProcessIambic`
(`cw/cw_gen.c:640,827`): paddle closures sampled at the block cadence
drive a dit/dah element generator with standard timing (dit = 1.2/wpm s,
dah = 3 dits, inter-element = 1 dit); iambic B remembers a squeeze
released mid-element (one extra alternating element), Ultimatic repeats
the last-pressed paddle.  Output is the keying envelope consumed by
`mod.modulators.cw_carrier`; edges are shaped there / in cw_text.

This is human-input control logic at audio-block cadence -> host side.

A copy of the JAX package's NumPy module of the same name (the port
imports nothing of that package); the same state machine.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np


class KeyerMode(Enum):
    IAMBIC_A = "iambic_a"
    IAMBIC_B = "iambic_b"
    ULTIMATIC = "ultimatic"
    STRAIGHT = "straight"


@dataclass
class Keyer:
    mode: KeyerMode = KeyerMode.IAMBIC_B
    wpm: float = 20.0
    fs: float = 48000.0
    weight: float = 1.0          # dit-length weighting (CwGen_SetSpeed)

    def __post_init__(self):
        self._dit = int(self.fs * 1.2 / self.wpm * self.weight)
        self._state = "idle"     # idle | dit | dah | gap
        self._remain = 0
        self._next_element = None
        self._memory = None      # iambic-B squeeze memory
        self._last_element = None

    def process(self, dit_paddle: bool, dah_paddle: bool,
                n_samples: int) -> np.ndarray:
        """Advance the keyer by n_samples given current paddle closures.
        Returns the keying envelope (0/1 floats)."""
        if self.mode == KeyerMode.STRAIGHT:
            return np.full(n_samples, 1.0 if dit_paddle or dah_paddle else 0.0,
                           np.float32)

        out = np.zeros(n_samples, np.float32)
        i = 0
        while i < n_samples:
            if self._state in ("dit", "dah"):
                run = min(self._remain, n_samples - i)
                out[i:i + run] = 1.0
                self._remain -= run
                i += run
                if self._remain == 0:
                    # iambic-B: latch the opposite paddle if squeezed
                    if (self.mode == KeyerMode.IAMBIC_B and dit_paddle
                            and dah_paddle):
                        self._memory = ("dah" if self._state == "dit"
                                        else "dit")
                    self._last_element = self._state
                    self._state = "gap"
                    self._remain = self._dit
            elif self._state == "gap":
                run = min(self._remain, n_samples - i)
                i += run
                self._remain -= run
                if self._remain == 0:
                    self._state = "idle"
            else:  # idle: decide next element
                nxt = None
                if self._memory is not None:
                    nxt = self._memory
                    self._memory = None
                elif dit_paddle and dah_paddle:
                    if self.mode == KeyerMode.ULTIMATIC:
                        nxt = self._last_element or "dit"
                    else:  # iambic: alternate
                        nxt = ("dah" if self._last_element == "dit"
                               else "dit")
                elif dit_paddle:
                    nxt = "dit"
                elif dah_paddle:
                    nxt = "dah"
                if nxt is None:
                    break
                self._state = nxt
                self._remain = self._dit if nxt == "dit" else 3 * self._dit
        return out


class DigiTxBuffer:
    """Shared TX text FIFO between keyboard/CAT/macros and the CW/RTTY/PSK
    encoders (reference `cw/uhsdr_digi_buffer.c`)."""

    def __init__(self, maxlen: int = 256):
        self._buf: list[str] = []
        self._maxlen = maxlen

    def put(self, text: str) -> int:
        room = self._maxlen - len(self._buf)
        accepted = text[:room]
        self._buf.extend(accepted)
        return len(accepted)

    def get(self) -> str | None:
        return self._buf.pop(0) if self._buf else None

    def has_data(self) -> bool:
        return bool(self._buf)

    def clear(self) -> None:
        self._buf.clear()
