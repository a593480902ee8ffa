"""CW symbol->text decoding (host side) and text->keying generation.

Port of the reference's event-driven Morse logic:
  * timing acquisition & adaptive averages — Guenther 1973 equations
    (`cw/cw_decoder.c:409-489` InitializationFunc, `:556-700`
    DataRecognitionFunc: eqs 4.1-4.15)
  * character assembly / code generation (`:700-718` CodeGenFunc: base-4
    packing, dit=2 dash=3)
  * word-space correction for I/J/Q/U/V/Z (`:823-850` WordSpaceFunc)
  * keyer-side text->morse generation with shaped edges (`cw/cw_gen.c`).

This is low-rate (~136 Hz/channel) control logic; it consumes the boolean
keying stream produced by `modems.cw.keying_detect` on the card.

A copy of the JAX package's NumPy module of the same name (the port
imports nothing of that package); the same arrays and decoders.
"""
from __future__ import annotations

import numpy as np

# Morse code table: char -> dits/dahs.  Standard ITU Morse.
MORSE = {
    "A": ".-", "B": "-...", "C": "-.-.", "D": "-..", "E": ".", "F": "..-.",
    "G": "--.", "H": "....", "I": "..", "J": ".---", "K": "-.-", "L": ".-..",
    "M": "--", "N": "-.", "O": "---", "P": ".--.", "Q": "--.-", "R": ".-.",
    "S": "...", "T": "-", "U": "..-", "V": "...-", "W": ".--", "X": "-..-",
    "Y": "-.--", "Z": "--..",
    "0": "-----", "1": ".----", "2": "..---", "3": "...--", "4": "....-",
    "5": ".....", "6": "-....", "7": "--...", "8": "---..", "9": "----.",
    ".": ".-.-.-", ",": "--..--", "?": "..--..", "'": ".----.",
    "!": "-.-.--", "/": "-..-.", "(": "-.--.", ")": "-.--.-",
    "&": ".-...", ":": "---...", ";": "-.-.-.", "=": "-...-",
    "+": ".-.-.", "-": "-....-", "_": "..--.-", '"': ".-..-.",
    "$": "...-..-", "@": ".--.-.",
}

# code integer (base-4 packing, dit=2 dash=3) -> char
def _pack(code_str: str) -> int:
    code = 0
    for c in code_str:
        code = code * 4 + (3 if c == "-" else 2)
    return code


CODE_TO_CHAR = {_pack(v): k for k, v in MORSE.items()}


class CwTextDecoder:
    """Streaming Morse decoder for one channel of keying booleans at the
    decode-block cadence (fs/blocksize Hz)."""

    def __init__(self, block_rate_hz: float,
                 nominal_wpm: float | None = 25.0):
        """nominal_wpm seeds the Guenther timing averages (the operator's
        configured keyer speed, like the reference's menu CW speed); the
        decoder then starts classifying immediately and the adaptive
        equations track the actual speed.  Pass None to instead acquire
        timing from scratch over the first events (the reference's
        98-event InitializationFunc behavior, cw_decoder.c:409-489)."""
        self.block_rate = block_rate_hz
        self.nominal_wpm = nominal_wpm
        self.reset()

    def reset(self):
        self.prevstate = False
        self.timer = 0
        self.events = []            # (state, duration) pending
        # Seed the Guenther averages so the dot-vs-dash classifier is not
        # degenerate before acquisition (pulse_avg==0 classifies every
        # mark as dash); the adaptive equations converge to the actual
        # speed either way.
        dot0 = self.block_rate * 1.2 / (self.nominal_wpm or 25.0)
        self.pulse_avg = (dot0 / 4 + 3 * dot0) / 2.0
        self.dot_avg = dot0
        self.dash_avg = 3 * dot0
        self.symspace_avg = dot0
        self.cwspace_avg = 3 * dot0
        self.w_space = 0.0
        # seeded: decode from the first event (acquisition would otherwise
        # consume the first ~2 characters and can split a character when
        # it flips to initialized mid-stream)
        self.initialized = self.nominal_wpm is not None
        self.init_processed = 0
        self.dash_flag = False
        self.wspace_flag = False
        self.data = []              # dot/dash states of current char
        self.text = []
        self.wpm = 0.0

    # ---- event intake -----------------------------------------------------
    def push_keying(self, keying: np.ndarray):
        """keying: 1-D bool array at block cadence."""
        for st in keying:
            st = bool(st)
            if st != self.prevstate:
                self._on_event(self.prevstate, self.timer)
                self.timer = 0
                self.prevstate = st
            self.timer += 1
            # long key-up timeout finalizes a pending char
            if (self.initialized and not self.prevstate and self.data
                    and self.timer > 10 * max(self.dash_avg, 1.0)):
                self._finalize_char()
                self.wspace_flag = True
                self._emit_space_if_needed(force=True)
        return "".join(self.text)

    # ---- timing acquisition (Guenther eqs) --------------------------------
    def _acquire(self, state: bool, t: float):
        p = self.init_processed
        if state:
            if p > 32:
                if t > self.pulse_avg:
                    self.dash_avg += (t - self.dash_avg) / 4.0
                else:
                    self.dot_avg += (t - self.dot_avg) / 4.0
            else:
                if t > self.pulse_avg:
                    self.dash_avg = (t + self.dash_avg) / 2.0
                else:
                    self.dot_avg = (t + self.dot_avg) / 2.0
            self.pulse_avg = (self.dot_avg / 4 + self.dash_avg) / 2.0
        else:
            if p > 32:
                if t > self.pulse_avg:
                    self.cwspace_avg += (t - self.cwspace_avg) / 4.0
                else:
                    self.symspace_avg += (t - self.symspace_avg) / 4.0
        self.init_processed += 1
        # the reference acquires over 98 events from scratch
        # (cw_decoder.c:440); with nominal-speed seeding a short
        # refinement pass suffices
        if self.init_processed >= 16:
            self.initialized = True

    # ---- recognition ------------------------------------------------------
    def _on_event(self, state: bool, t: int):
        if t <= 0:
            return
        if not self.initialized:
            self._acquire(state, float(t))
            return
        if state:   # mark
            if self.pulse_avg - t >= 0:     # dot (eq 4.10)
                self.dash_flag = False
                self.data.append((0, t))
                self.dot_avg += (t - self.dot_avg) / 8.0
            else:
                self.dash_flag = True
                self.data.append((1, t))
                if t <= 5 * self.dash_avg:
                    self.dash_avg += (t - self.dash_avg) / 8.0
            self.pulse_avg = (self.dot_avg / 4 + self.dash_avg) / 2.0
        else:       # space
            full_char = True
            last_t = self.data[-1][1] if self.data else 0
            if self.dash_flag:
                self.dash_flag = False
                eq4_12 = t - (self.pulse_avg - (last_t - self.pulse_avg) / 4.0)
                if eq4_12 < 0:
                    self.symspace_avg += (t - self.symspace_avg) / 8.0
                    full_char = False
                elif t <= 10 * self.dash_avg:
                    eq4_14 = t - (self.cwspace_avg
                                  - (last_t - self.pulse_avg) / 4.0)
                    if eq4_14 >= 0:
                        self.w_space = t
                        self.wspace_flag = True
            else:
                if t - self.pulse_avg < 0:  # eq 4.11
                    self.symspace_avg += (t - self.symspace_avg) / 8.0
                    full_char = False
                elif t <= 10 * self.dash_avg:
                    self.cwspace_avg += (t - self.cwspace_avg) / 8.0
                    if t - self.cwspace_avg >= 0:   # eq 4.13
                        self.w_space = t
                        self.wspace_flag = True
            if full_char and self.data:
                self._finalize_char()
        self._update_wpm()

    def _finalize_char(self):
        code = 0
        for st, _ in self.data[:38]:
            code = code * 4 + (3 if st else 2)
        self.data = []
        ch = CODE_TO_CHAR.get(code, "#")
        self.text.append(ch)
        self._emit_space_if_needed(ch)

    def _emit_space_if_needed(self, ch: str = "", force: bool = False):
        if not self.wspace_flag:
            return
        self.wspace_flag = False
        if not force and ch in "IJQUVZ":
            # word-space correction (eq 4.15)
            if (self.cwspace_avg + self.pulse_avg) - self.w_space >= 0:
                return
        self.text.append(" ")

    def _update_wpm(self):
        spdcalc = (10.0 * self.dot_avg + 4.0 * self.dash_avg
                   + 9.0 * self.symspace_avg + 5.0 * self.cwspace_avg)
        if self.initialized and spdcalc > 0:
            ms_per_word = spdcalc * 1000.0 / self.block_rate
            wpm_raw = 0.5 + 60000.0 / ms_per_word
            self.wpm = 0.3 * wpm_raw + 0.7 * self.wpm


# ---------------------------------------------------------------------------
# TX side: text -> keying envelope (CwGen analog)
# ---------------------------------------------------------------------------

def text_to_keying(text: str, wpm: float, fs: float,
                   rise_ms: float = 5.0) -> np.ndarray:
    """Morse keying envelope for `text` at `wpm`, sample rate fs, with
    raised-cosine edges (the reference shapes edges through a smoothing
    table to kill clicks, `cw/cw_gen.c:449-510`)."""
    dot = int(round(fs * 1.2 / wpm))          # PARIS timing
    env = []
    for word in text.upper().split(" "):
        for ci, ch in enumerate(word):
            code = MORSE.get(ch)
            if code is None:
                continue
            for si, sym in enumerate(code):
                env.extend([1.0] * (dot if sym == "." else 3 * dot))
                env.extend([0.0] * dot)       # inter-element
            env.extend([0.0] * (2 * dot))     # char space (total 3 dots)
        env.extend([0.0] * (4 * dot))         # word space (total 7 dots)
    env = np.asarray(env, np.float32)
    # shape edges
    nr = max(int(fs * rise_ms / 1000.0), 1)
    ramp = 0.5 * (1 - np.cos(np.pi * np.arange(nr) / nr)).astype(np.float32)
    kernel = np.ones(nr, np.float32) / nr
    # convolve the rectangular envelope with a smoothing kernel (equivalent
    # click suppression to the reference's table ramp)
    sm = np.convolve(env, kernel)[: len(env)]
    return sm.astype(np.float32)


# ---------------------------------------------------------------------------
# Reference-exact TX keying envelope (CwGen_ProcessIambic text entry)
# ---------------------------------------------------------------------------

# cw_char_codes semantics (cw_gen.c:106-154): base-4 digits, 2=dit 3=dah
_REF_CODES = {
    " ": 1, "E": 2, "T": 3, "I": 10, "A": 11, "N": 14, "M": 15,
    "S": 42, "U": 43, "R": 46, "W": 47, "D": 58, "K": 59, "G": 62,
    "O": 63, "H": 170, "V": 171, "F": 174, "L": 186, "P": 190, "J": 191,
    "B": 234, "X": 235, "C": 238, "Y": 239, "Z": 250, "Q": 251,
    "5": 682, "4": 683, "3": 687, "2": 703, "1": 767, "6": 938,
    "=": 939, "/": 942, "7": 1002, "8": 1018, "9": 1022, "0": 1023,
    "?": 2810, ".": 3003, "@": 3054, "-": 3755, ",": 4015, ":": 4074,
}

_SMOOTH_STEPS = 9        # CW_SMOOTH_STEPS (cw_gen.c:65)
_SMOOTH_LEN = 2          # samples per table step
_BLOCK = 32              # firmware audio block


def _elements(ch: str):
    """dit(2)/dah(3) element list for one character."""
    code, out = _REF_CODES[ch], []
    while code > 1:
        out.append(code % 4)
        code //= 4
    return out[::-1]


def text_to_keying_ref(text: str, wpm: int, fs: float = 48000.0,
                       n_blocks: int | None = None) -> np.ndarray:
    """The firmware text-keyer's exact per-sample keying envelope
    (CwGen_ProcessIambic + sm_table shaping, block-granular timing from
    CwGen_SetSpeed at weight 100):

      element on-time  = dit/dah_time blocks (tone, sm_table rise over
                         the first 256 samples, fall over the last
                         CW_SMOOTH_STEPS blocks)
      element gap      = pause_time blocks
      character gap    = pause_time + END_PROC block + space-timer
                         countdown until space_timer < space_time -
                         dah_time (the CheckDigiBufferState gate)

    Bit-exact against the tests/golden/ref_tx.py CwTextTxOracle gain
    trace (test_tx_conformance).  fs must be the 48 k block-rate family
    (one block = 32 samples at 1500 Hz)."""
    from .. import data

    assert abs(fs - 48000.0) < 1e-6, "reference keyer timing is 48k-only"
    sm = np.asarray(data.digimode_tables()["cw_sm_table"])
    dit = (180000 // wpm + _SMOOTH_STEPS * 100) // 100
    dah = (3 * 180000 // wpm + _SMOOTH_STEPS * 100) // 100
    pause = (180000 // wpm - _SMOOTH_STEPS * 100) // 100
    space = 6 * (180000 // wpm) // 100

    # build the per-block schedule: (tone?, key_timer_after_dec, elem_K)
    blocks: list[tuple[bool, int, int]] = []

    def tone_element(K: int):
        # KEY_DOWN block (timer K-1 after dec) + KEY_UP blocks K-2..0,
        # then the KEY_UP->PAUSE transition block and (pause-1) PAUSE
        # blocks of silence; the next element/char starts IN the
        # PAUSE-expiry block (handled by the caller appending tone
        # right after the gap)
        for b in range(K):
            blocks.append((True, K - 1 - b, K))
        for _ in range(pause):
            blocks.append((False, 0, 0))

    chars = [c for c in text.upper() if c in _REF_CODES]
    for c in chars:
        els = _elements(c)
        if not els:                  # space char: space_timer fill
            for _ in range(space):
                blocks.append((False, 0, 0))
            continue
        for e in els:
            tone_element(dah if e == 3 else dit)
        # character end: END_PROC processing block + space-timer
        # countdown until the digi-buffer gate opens (space_timer <
        # space - dah; one decrement per IDLE block) -> dah more silent
        # blocks; the gate-open block itself is the next char's first
        # tone block.  Total char gap = pause + 1 + dah.
        for _ in range(1 + dah):
            blocks.append((False, 0, 0))

    if n_blocks is not None:
        blocks = blocks[:n_blocks] + \
            [(False, 0, 0)] * (n_blocks - len(blocks))

    # render the envelope: sm_ptr walks the table 16 steps per block on
    # edges, exactly as CwGen_RemoveClickOn{Rising,Falling}Edge
    env = np.zeros(len(blocks) * _BLOCK, np.float64)
    sm_ptr = 0
    prev_tone = False
    for bi, (tone, kt, K) in enumerate(blocks):
        if not tone:
            prev_tone = False
            continue
        if not prev_tone:
            sm_ptr = 0               # KEY_DOWN resets the table walk
        g = np.ones(_BLOCK)
        rising = (sm_ptr < 128) and (kt == K - 1 or kt > dit // 2)
        if rising and sm_ptr < 128:
            j = 0
            for s in range(_BLOCK):
                g[s] *= sm[sm_ptr]
                j += 1
                if j == _SMOOTH_LEN:
                    j = 0
                    sm_ptr += 1
                    if sm_ptr > 127:
                        break
        if kt < _SMOOTH_STEPS and kt != K - 1:
            if sm_ptr > 127:
                sm_ptr = 127
            j = 0
            for s in range(_BLOCK):
                g[s] *= sm[sm_ptr]
                j += 1
                if j == _SMOOTH_LEN:
                    j = 0
                    if sm_ptr > 0:
                        sm_ptr -= 1
        env[bi * _BLOCK:(bi + 1) * _BLOCK] = g
        prev_tone = True
    return env
