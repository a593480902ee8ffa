"""PSK31 varicode text coding and TX waveform building (host side).

Varicode (G3PLX standard): each char is a unique bit pattern with no two
consecutive zeros inside; characters separated by '00'.  Differential
BPSK: bit 0 = phase reversal, bit 1 = no change (reference
`Bpsk_DecodeVaricode` / `Psk_Modulator_GenSample`, `psk.c:533-760`).

A copy of the JAX package's NumPy module of the same name (the port
imports nothing of that package); the same arrays and decoder.
"""
from __future__ import annotations

import numpy as np

from ._varicode_table import VARICODE

CODE_TO_CHAR = {int(v, 2): chr(i) for i, v in enumerate(VARICODE)}


class VaricodeDecoder:
    def __init__(self):
        self.word = 0
        self.last_bit = 1
        self.text = []

    def push_bits(self, bits) -> str:
        for b in bits:
            b = int(b)
            if self.last_bit == 0 and b == 0 and self.word != 0:
                ch = CODE_TO_CHAR.get(self.word >> 1)
                # a word no character has (noise) is dropped; the JAX
                # package's test `ch in ...` raises on it (ch None)
                if ch is not None and (ch.isprintable() or ch in "\n\r\t "):
                    self.text.append(ch)
                self.word = 0
            else:
                self.word = (self.word << 1) | b
            self.last_bit = b
        return "".join(self.text)


def encode_bits(text: str, preamble_zeros: int = 32,
                postamble_ones: int = 32) -> np.ndarray:
    """Text -> differential bit stream (incl. 00 separators, preamble of
    reversals, postamble of steady carrier)."""
    bits = [0] * preamble_zeros
    for ch in text:
        code = VARICODE[ord(ch) & 0x7F]
        bits.extend(int(c) for c in code)
        bits.extend([0, 0])
    bits.extend([1] * postamble_ones)
    return np.asarray(bits, np.int32)


def bits_to_waveform_params(bits: np.ndarray, rate: int):
    """Expand a differential bit stream to per-sample (signs, envelope).

    bit 0 -> phase reversal at the middle of the bit with raised-cosine
    amplitude dip (the reference shapes with a cosine envelope generator);
    bit 1 -> steady carrier.
    """
    n = len(bits) * rate
    signs = np.ones(n, np.float32)
    env = np.ones(n, np.float32)
    half = rate // 2
    ramp = 0.5 * (1 + np.cos(np.pi * np.arange(rate) / rate))  # 1 -> 0
    cur = 1.0
    for i, b in enumerate(bits):
        s = i * rate
        if b == 0:
            # cosine dip through zero at mid-bit, then flip sign
            env[s:s + half] = ramp[::2][:half]
            env[s + half:s + rate] = ramp[::2][:rate - half][::-1]
            signs[s:s + half] = cur
            cur = -cur
            signs[s + half:s + rate] = cur
        else:
            signs[s:s + rate] = cur
    return signs, env


# ---------------------------------------------------------------------------
# Reference-exact TX tone (Psk_Modulator_* semantics, psk.c:686-841)
# ---------------------------------------------------------------------------

def gen_tx_tone_ref(text: str, n: int, fs: int = 48000,
                    speed: float = 31.25) -> np.ndarray:
    """Reference-exact BPSK TX tone: (n,) float64 int16-scale.  Matches
    `Psk_Modulator_GenSample` sample-for-sample: ~1 s preamble of
    phase-reversal zeros, reversed-varicode characters separated by two
    zeros, postamble ones, the |sine| half-bit-rate envelope DDS (its
    accumulator advancing only while shaping, reset at each reversal's
    bit middle), 500 Hz carrier DDS, integer gain division."""
    from .. import data
    from ..ops import softdds

    varicode = data.digimode_tables()["psk_varicode"]

    def reversed_code(c: int) -> int:
        code, ret = int(varicode[c]), 0
        while code > 0:
            ret = (ret | (code & 1)) << 1
            code >>= 1
        return ret

    SAMPLE_MAX = 32766
    bit_len = round(fs / speed * 2)
    half = bit_len // 2
    carrier_step = softdds.step_for(500.0, fs)
    env_step = softdds.step_for(speed / 2.0, fs)
    tbl = softdds.table()

    # --- bit-level state machine -> per-half-bit segments ---
    queue = [ord(c) & 0x7F for c in text] + [0x04]
    OFF, ACTIVE, PREAMBLE, POSTAMBLE, INACTIVE = range(5)
    state, tx_bits, tx_zeros, tx_ones = PREAMBLE, 0, 0, 0
    sign_next = sign_cur = 1
    tx_win = True

    signs = np.zeros(0, np.int64)
    wins = np.zeros(0, bool)
    offs = np.zeros(0, bool)
    # the sample loop hits bit_start at phase bit_len//4 and bit_middle
    # at phase 0; emit segments between those events in phase order:
    # [0, half/2) with last decision, [half/2, half) after bit_start
    seg_signs, seg_wins, seg_offs = [], [], []
    phase0 = True        # phase counter starts at 0 -> first event is
    #                      bit_middle (a no-op with tx_win initial state)
    total = 0
    while total < n + bit_len:
        # bit_middle (phase 0)
        sign_cur = sign_next
        if tx_win:
            env_reset = True
        else:
            env_reset = False
        if state == INACTIVE:
            state = OFF
        # segment phase [0, half//2)
        seg_signs.append(sign_cur)
        seg_wins.append(tx_win)
        seg_offs.append(state == OFF)
        seg_resets = env_reset
        # bit_start (phase half//2  == bit_len//4)
        if state != OFF:
            if tx_bits == 0:
                if tx_zeros < 2 or state == PREAMBLE:
                    tx_zeros += 1
                    if state == PREAMBLE and tx_zeros >= speed:
                        state = ACTIVE
                elif queue:
                    ch = queue.pop(0)
                    state = ACTIVE
                    if ch == 0x04:
                        state = POSTAMBLE
                    else:
                        tx_bits = reversed_code(ch)
                        tx_zeros = 0
                        tx_ones = 0
                if state == POSTAMBLE:
                    if tx_ones < speed:
                        tx_ones += 16
                        tx_bits = 0xFFFF
                    else:
                        state = INACTIVE
            if (tx_bits & 1) == 0 and tx_ones == 0:
                sign_next *= -1
            tx_win = (sign_next != sign_cur or state == INACTIVE)
            tx_bits >>= 1
        # segment phase [half//2, half)
        seg_signs.append(sign_cur)
        seg_wins.append(tx_win)
        seg_offs.append(state == OFF)
        signs = np.append(signs, [seg_signs[-2], seg_signs[-1]])
        wins = np.append(wins, [seg_wins[-2], seg_wins[-1]])
        offs = np.append(offs, [seg_offs[-2], seg_offs[-1]])
        if len(signs) == 2:
            resets = [seg_resets]
        else:
            resets.append(seg_resets)
        total += half

    # --- vectorized synthesis over the quarter-bit segments ---
    q1 = half // 2                       # phase [0, q1) then [q1, half)
    seg_lens = []
    for k in range(len(signs) // 2):
        seg_lens += [q1, half - q1]
    out = np.empty(sum(seg_lens), np.float64)
    carrier_acc = 0
    env_acc = 0
    pos = 0
    for k, (ln, sg, wn, off) in enumerate(zip(seg_lens, signs, wins, offs)):
        if k % 2 == 0 and resets[k // 2] and wins[k]:
            # Bpsk_ResetWin at bit_middle of a shaped bit
            env_acc = 0
        # carrier advances ONLY while the modulator is on (retval path)
        if off:
            out[pos:pos + ln] = 0.0
            pos += ln
            continue
        car, carrier_acc = softdds.samples(carrier_acc, carrier_step, ln)
        if wn:
            env, env_acc = softdds.samples(env_acc, env_step, ln)
            coeff = np.abs(env)
        else:
            coeff = np.full(ln, SAMPLE_MAX, np.int64)
        prod = coeff * sg * car
        out[pos:pos + ln] = np.trunc(prod / SAMPLE_MAX)
        pos += ln
    return out[:n]
