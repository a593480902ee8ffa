"""Baudot (ITA2) text coding for RTTY — host side.

Reference: `rtty.c:27-40` Baudot->ASCII tables and
`Rtty_Modulator_GenSample` framing (1 start + 5 data (LSB first) +
1.5/2 stop bits).

A copy of the JAX package's NumPy module of the same name (the port
imports nothing of that package); the same arrays and decoder.
"""
from __future__ import annotations

import numpy as np

# ITA2 letters and figures shifts (standard tables)
LETTERS = "\0E\nA SIU\rDRJNFCKTZLWHYPQOBG\0MXV\0"
FIGURES = "\x003\n- \x0787\r\x054',!:(5\")2#6019?&\0./;\0"
LTRS = 0x1F
FIGS = 0x1B


class BaudotDecoder:
    def __init__(self):
        self.figures = False
        self.text = []

    def push_codes(self, codes) -> str:
        for c in codes:
            c = int(c)
            if c < 0:
                continue
            if c == LTRS:
                self.figures = False
            elif c == FIGS:
                self.figures = True
            else:
                table = FIGURES if self.figures else LETTERS
                ch = table[c] if c < len(table) else "\0"
                if ch != "\0":
                    self.text.append(ch)
        return "".join(self.text)


def encode(text: str) -> list[int]:
    """ASCII -> Baudot codes with shift handling."""
    codes = [LTRS]
    figures = False
    for ch in text.upper():
        if ch in LETTERS and ch != "\0":
            if figures:
                codes.append(LTRS)
                figures = False
            codes.append(LETTERS.index(ch))
        elif ch in FIGURES and ch != "\0":
            if not figures:
                codes.append(FIGS)
                figures = True
            codes.append(FIGURES.index(ch))
    return codes


def codes_to_bits(codes: list[int], one_bit: int,
                  stopbits: float = 1.5) -> np.ndarray:
    """Expand framed codes to a sample-rate mark/space boolean stream
    (True = mark).  Idle = mark."""
    out = [np.ones(2 * one_bit, bool)]          # idle lead-in
    stop_len = int(one_bit * stopbits)
    for c in codes:
        out.append(np.zeros(one_bit, bool))     # start (space)
        for b in range(5):
            bit = bool((c >> b) & 1)
            out.append(np.full(one_bit, bit, bool))
        out.append(np.ones(stop_len, bool))     # stop (mark)
    out.append(np.ones(4 * one_bit, bool))
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# Reference-exact TX tone (Rtty_Modulator_* semantics, rtty.c:796-932)
# ---------------------------------------------------------------------------

def _ref_bit_periods(text: str, n_bits: int) -> np.ndarray:
    """The per-bit-period tone selector (1 = mark, 0 = space) the
    firmware's modulator produces for `text`, including its framing
    quirks: charset-switch codes injected on LETTERS/SYMBOLS changes,
    the initial SYMBOLS+LETTERS preamble whose first start bit is
    consumed by the shift-before-reload ordering, 2 stop bits, and
    LETTERS idle fill."""
    from .. import data
    a2b = data.digimode_tables()["ascii2baudot"]
    queue = [int(a2b[ord(c) & 0x7F]) for c in text]
    queue = [q for q in queue if q > 0]

    MODE_MASK, LETTER, SYMBOL = 0b100000, 0b11111, 0b11011
    char_bits = 0
    idx = 0
    mode_letters = True

    def frame(code5: int):
        nonlocal char_bits, idx
        char_bits |= ((code5 << 1) | 0b11000000) << idx
        idx += 8

    def load(info: int):
        nonlocal char_bits, idx, mode_letters
        char_bits = 0
        idx = 0
        want_letters = bool(info & MODE_MASK)
        if want_letters != mode_letters:
            mode_letters = want_letters
            frame(LETTER if want_letters else SYMBOL)
        char_bits_shiftless = info & ~MODE_MASK
        frame(char_bits_shiftless)

    # Rtty_Modulator_StartTX: mode preset LETTERS, then LETTER_CODE
    # framed through the SYMBOLS branch (its mode flag bit is clear)
    mode_letters = True
    load(LETTER)            # queues SYMBOL + LETTER chars (16 slots)

    bits = np.empty(n_bits, np.uint8)
    for b in range(n_bits):
        char_bits >>= 1                     # shift BEFORE reload check
        if idx == 0:
            if queue:
                load(queue.pop(0))
            else:
                load(LETTER | MODE_MASK)    # idle
        idx -= 1
        bits[b] = char_bits & 1
    return bits


def gen_tx_tone_ref(text: str, n: int, fs: int = 48000,
                    baud: float = 45.45, shift: float = 170.0) -> np.ndarray:
    """Reference-exact RTTY TX tone: (n,) float64 int16-scale AFSK.
    Matches `Rtty_Modulator_GenSample` sample-for-sample — per-tone
    soft-DDS accumulators (mark 915 / space 915+shift) where only the
    ACTIVE tone advances, 10-bit table synthesis, bit periods of
    round(12000/baud)*fs/12000 samples."""
    from ..ops import softdds
    one_bit = int(round(round(12000.0 / baud) * fs / 12000.0))
    n_bits = -(-n // one_bit)
    bits = np.repeat(_ref_bit_periods(text, n_bits), one_bit)[:n]

    steps = (softdds.step_for(915.0 + shift, fs),     # [0] = space
             softdds.step_for(915.0, fs))             # [1] = mark
    tbl = softdds.table()
    out = np.empty(n, np.float64)
    for tone in (0, 1):
        active = bits == tone
        # the accumulator advances only while this tone is selected:
        # pre-advance count = number of active samples before each one
        cnt = np.cumsum(active) - active
        accs = (np.uint64(steps[tone]) * cnt.astype(np.uint64)) \
            & np.uint64(0xFFFFFFFF)
        idx = (accs >> np.uint64(softdds.ACC_SHIFT)).astype(np.int64) \
            % softdds.DDS_TBL_SIZE
        out[active] = tbl[idx[active]]
    return out
