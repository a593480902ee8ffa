"""FreeDV digital-voice mode.

The counterpart of `uhsdr_tpu.modems.freedv`.  The reference vendors the
full Codec2/FreeDV library (~113 kLoC, `drivers/freedv/`) and glues it to
the chain via sample-rate-converted ring buffers processed off the hot
path (`freedv_uhsdr.c:166-320`, `audio_driver.c:1330-1470`: 48 kHz IQ ->
drop-decimate /6 -> 8 kHz modem <-> 24-tap polyphase x6 interpolation
back).  This module keeps the JAX package's two tiers, in the firmware's
IRQ/PendSV split:

  * the device front: the NCO translation and the 72-tap /6 decimation
    from 48 kHz to the 8 kHz modem rate in one launch of K5
    (`cuda/fir.py::fir_rt`, the NCO fused; `RateConverter.down`), and the
    x6 interpolation back on K4 (`cuda/fir.py::interpolate`,
    `RateConverter.up`);
  * the modem tier: host NumPy, copied from the JAX package with the
    same decisions -- `FreeDv1600` (FDMDV DQPSK, Golay(23,12), Codec2
    1300; `modems/fdmdv.py`, `golay.py`, `codec2_1300.py`) and
    `FreeDv700D` (OFDM, LDPC(224,112), Codec2 700C; `modems/ofdm.py`,
    `ldpc.py`, `codec2_700c.py`), batched over channels in
    `modems/fdmdv_batch.py`.

The JAX front carries the post-mix history of its decimator; K5 carries
the raw pre-mix one and rotates it with the current increment.  The two
agree while the increment is fixed; `RateConverter` re-rotates its raw
history where the increment changes (a retune), so they agree across one
too.
"""
from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from ..chain.rx import resolve_device
from ..cuda import fir as fir_k
from ..ops import design, nco

MODEM_RATE = 8000.0

# --- reference 1600 frame layout (freedv_comptx_fdmdv_1600,
# freedv_api.c:792-882 / freedv_comprx rx :1430-1480): Golay(23,12)
# protects codec bits [0:8]+[11:15] (voicing, pitch MSBs, energy MSBs);
# the 11 parity bits sit at frame bits [52:63] MSB-first; bit 63 spare.
GOLAY_DATA_POS = np.concatenate([np.arange(0, 8), np.arange(11, 15)])
_NONCRIT_POS = np.array([i for i in range(52)
                         if i not in set(GOLAY_DATA_POS.tolist())])


def frame_codeword(b64: np.ndarray) -> np.ndarray:
    """The 23-bit Golay codeword carried by a 64-bit 1600-mode frame."""
    return np.concatenate([b64[GOLAY_DATA_POS], b64[52:63]])


def pack_codec_bits(cbits: np.ndarray) -> np.ndarray:
    """Our vocoder frame (52,) with critical bits FIRST -> reference
    frame slots (52,) with critical bits at the Golay-protected
    positions [0:8]+[11:15]."""
    out = np.empty(52, np.uint8)
    out[GOLAY_DATA_POS] = cbits[:12]
    out[_NONCRIT_POS] = cbits[12:]
    return out


def unpack_codec_bits(slots: np.ndarray) -> np.ndarray:
    return np.concatenate([slots[GOLAY_DATA_POS], slots[_NONCRIT_POS]])

IQ_RATE = 48000.0
RATIO = 6


class FreeDvModem(Protocol):
    """The contract `freedv_comprx`/`freedv_comptx` fulfil in the
    reference.  Implementations: codec2 binding (future) or test stubs."""

    def demod(self, iq_8k: np.ndarray) -> np.ndarray:
        """complex 8 kHz modem input -> 8 kHz speech (may be empty while
        the modem accumulates a frame)."""
        ...

    def mod(self, speech_8k: np.ndarray) -> np.ndarray:
        """8 kHz speech -> complex 8 kHz modem output."""
        ...


class LoopbackModem:
    """Plumbing-test modem: SSB-like passthrough (audio = Re(iq))."""

    def demod(self, iq_8k: np.ndarray) -> np.ndarray:
        return np.real(iq_8k).astype(np.float32)

    def mod(self, speech_8k: np.ndarray) -> np.ndarray:
        return speech_8k.astype(np.complex64)


class FreeDv1600:
    """FreeDV 1600 digital voice: 1300 bit/s vocoder + Golay FEC + 16-
    carrier FDMDV DQPSK.  The full-stack analog of `freedv_comptx` /
    `freedv_comprx` for mode 1600 (`freedv_api.c:143-146,559,1244`).

    Frame layout (the reference's 1600 mode, bit positions and all):
      52 codec bits (critical bits in slots [0:8]+[11:15]) + 11
      Golay(23,12) parity bits at [52:63] + 1 spare/text bit = 64 bits
      / 40 ms = two FDMDV symbols.

    Frame alignment onto the symbol stream is recovered from the FEC
    itself: both 2-symbol phases are scored by Golay syndrome weight.
    """

    def __init__(self, vocoder: str = "codec2"):
        """vocoder: "codec2" (default) — the reference's CODEC2_MODE_1300
        codec (`modems/codec2_1300.py`): the DECODER is waveform-
        interoperable with real off-air FreeDV speech and the ENCODER
        emits streams the reference firmware's decoder renders
        (tests/test_codec2_golden.py); or "lpc" — this repo's original
        independent LPC-10-class vocoder both ways."""
        from . import codec2_1300
        from . import fdmdv as fdmdv_mod
        from . import golay
        from . import vocoder as vocoder_mod
        self._fdmdv = fdmdv_mod
        self._golay = golay
        self._voc = vocoder_mod
        self.vocoder_impl = vocoder
        self._c2dec = (codec2_1300.Codec2Decoder1300()
                       if vocoder == "codec2" else None)
        self._c2enc = (codec2_1300.Codec2Encoder1300()
                       if vocoder == "codec2" else None)
        self.modulator = fdmdv_mod.FdmdvModulator()
        self.demodulator = fdmdv_mod.FdmdvDemodulator()
        self.vocoder = vocoder_mod.Vocoder()
        self._speech_in = np.zeros(0, np.float32)
        self._iq_in = np.zeros(0, np.complex64)
        self._sym_buf: list[np.ndarray] = []
        self._align = None        # 0 or 1: frame phase in symbols
        self._align_score = [0, 0]
        self.text_bits_rx: list[int] = []
        self.text_bits_tx: list[int] = []
        self.frames_decoded = 0
        self.parity_errors = 0
        self.ber_est = 0.0

    # --- TX ---
    def mod(self, speech_8k: np.ndarray) -> np.ndarray:
        self._speech_in = np.concatenate(
            [self._speech_in, np.asarray(speech_8k, np.float32)])
        out = []
        F = self._voc.FRAME
        while len(self._speech_in) >= F:
            frame, self._speech_in = (self._speech_in[:F],
                                      self._speech_in[F:])
            if self._c2enc is not None:
                # real Codec2 1300 payload, already in reference slot
                # order (codec2_encode_1300 packing)
                slots = self._c2enc.encode_frame(frame.astype(np.float64))
            else:
                cbits = self._voc.encode_frame(frame.astype(np.float64))
                slots = pack_codec_bits(cbits)
            cw = self._golay.encode_bits(slots[GOLAY_DATA_POS][None, :])[0]
            parity = cw[12:]                      # (11,) MSB-first
            text = np.array([self.text_bits_tx.pop(0)
                             if self.text_bits_tx else 0], np.uint8)
            bits64 = np.concatenate([slots, parity, text])
            out.append(self.modulator.modulate_frame(
                bits64.reshape(2, self._fdmdv.BITS_PER_SYMBOL)))
        if not out:
            return np.zeros(0, np.complex64)
        return np.concatenate(out)

    # --- RX ---
    def demod(self, iq_8k: np.ndarray) -> np.ndarray:
        self._iq_in = np.concatenate(
            [self._iq_in, np.asarray(iq_8k, np.complex64)])
        M = self._fdmdv.M
        n_sym = len(self._iq_in) // M
        if n_sym == 0:
            return np.zeros(0, np.float32)
        take, self._iq_in = (self._iq_in[: n_sym * M],
                             self._iq_in[n_sym * M:])
        bits, sync = self.demodulator.demod_symbols(take)
        for row, sy in zip(bits, sync):
            self._sym_buf.append((row, bool(sy)))

        speech = []
        while len(self._sym_buf) >= 3:   # keep one spare for realignment
            # determine/maintain frame alignment via Golay syndrome
            if self._align is None:
                if len(self._sym_buf) < 4:
                    break
                scores = []
                for ph in (0, 1):
                    b64 = np.concatenate([self._sym_buf[ph][0],
                                          self._sym_buf[ph + 1][0]])
                    _, ncorr = self._golay.decode_bits(
                        frame_codeword(b64)[None, :])
                    scores.append(int(ncorr[0]))
                self._align = int(np.argmin(scores))
                if self._align:
                    self._sym_buf.pop(0)
            (b0, s0), (b1, s1) = self._sym_buf[0], self._sym_buf[1]
            b64 = np.concatenate([b0, b1])
            # pilot DBPSK +,+,-,-: the flip flag alternates every symbol
            # when locked — alternation IS the sync indicator
            frame_synced = s0 != s1
            del self._sym_buf[:2]
            if not frame_synced:
                # modem not locked: emit silence (squelch, the glue's
                # analog of freedv squelch at low sync/SNR)
                speech.append(np.zeros(self._voc.FRAME, np.float32))
                continue
            slots = b64[:52].copy()
            data, ncorr = self._golay.decode_bits(
                frame_codeword(b64)[None, :])
            self.parity_errors += int(ncorr[0])
            # running channel-BER estimate from the Golay corrections
            # (the vhf deframer's 0.995/0.005 one-pole on uw errors,
            # freedv_vhf_framing.c:821, applied to the (23,12) codeword)
            self.ber_est = (0.995 * self.ber_est
                            + 0.005 * float(ncorr[0]) / 23.0)
            slots[GOLAY_DATA_POS] = data[0]       # FEC-corrected
            self.text_bits_rx.append(int(b64[63]))
            if self._c2dec is not None:
                # the real over-the-air payload IS Codec2 1300: decode
                # the 52 frame slots directly (codec2.c:1249-1360);
                # ber_est > 0.15 engages the decoder's soft-mute branch
                # (codec2.c:1297)
                pcm = self._c2dec.decode_frame(slots, ber_est=self.ber_est)
                speech.append(pcm.astype(np.float32))   # int16-scale floats
            else:
                cbits = unpack_codec_bits(slots)
                frame = self._voc.decode_frame_bits(cbits)
                speech.append(self.vocoder.synth.synthesize(frame))
            self.frames_decoded += 1
        if not speech:
            return np.zeros(0, np.float32)
        return np.concatenate(speech).astype(np.float32)

    @property
    def snr_db(self) -> float:
        return self.demodulator.snr_est


class FreeDv700D:
    """FreeDV 700D-class digital voice: 700 bit/s vocoder frames + LDPC
    (224,112) + pilot-aided coherent OFDM.  The analog of the reference's
    mode 700D (`freedv_api.c` + `drivers/freedv/ofdm.c` +
    `mpdecode_core.c`), same subsystem composition, independent
    implementation (see modems/ofdm.py, modems/ldpc.py docstrings).

    Frame economy: one OFDM frame (160 ms, 238 bit slots) carries one
    LDPC codeword (224 bits = 112 data = 4 x 28-bit vocoder frames) +
    14 spare bits; speech in and modem out run at exactly 1280 samples
    per frame each way.
    """

    def __init__(self, vocoder: str = "codec2"):
        """vocoder: "codec2" (default) — the reference's CODEC2_MODE_700C
        newamp1 codec (`modems/codec2_700c.py`, `freedv_api.c:218`):
        waveform-interoperable both ways with real 700D speech
        (tests/test_codec2_golden.py 700C rows); or "lpc" — this repo's
        original independent LPC vocoder."""
        from . import codec2_700c
        from . import ldpc
        from . import ofdm as ofdm_mod
        from . import vocoder as vocoder_mod
        self._ldpc = ldpc
        self._ofdm = ofdm_mod
        self._voc = vocoder_mod
        self.vocoder_impl = vocoder
        self._c2dec = (codec2_700c.Codec2Decoder700C()
                       if vocoder == "codec2" else None)
        self._c2enc = (codec2_700c.Codec2Encoder700C()
                       if vocoder == "codec2" else None)
        self.modulator = ofdm_mod.OfdmModulator()
        self.demodulator = ofdm_mod.OfdmDemodulator()
        self.synth = vocoder_mod.Synthesizer()
        self._speech_in = np.zeros(0, np.float32)
        self.frames_decoded = 0
        self.fec_failures = 0
        self.snr_db = 0.0

    def _encode_28(self, chunk: np.ndarray) -> np.ndarray:
        """One 320-sample chunk -> (28,) vocoder bits."""
        if self._c2enc is not None:
            return self._c2enc.encode_frame(chunk.astype(np.float64))
        return self._voc.encode_frame_700(chunk.astype(np.float64))

    def mod(self, speech_8k: np.ndarray) -> np.ndarray:
        self._speech_in = np.concatenate(
            [self._speech_in, np.asarray(speech_8k, np.float32)])
        F = self._voc.FRAME
        out = []
        while len(self._speech_in) >= 4 * F:
            chunk, self._speech_in = (self._speech_in[: 4 * F],
                                      self._speech_in[4 * F:])
            data = np.concatenate([
                self._encode_28(chunk[i * F:(i + 1) * F])
                for i in range(4)])                        # (112,)
            cw = self._ldpc.encode(data)                   # (224,)
            bits = np.concatenate(
                [cw, np.zeros(self._ofdm.BITS_PER_FRAME - cw.size,
                              np.uint8)])
            out.append(self.modulator.modulate_frame(bits))
        if not out:
            return np.zeros(0, np.complex64)
        return np.concatenate(out)

    def demod(self, iq_8k: np.ndarray, flush: bool = False) -> np.ndarray:
        frames, snrs = self.demodulator.demod(iq_8k)
        if flush:
            fb2, sn2 = self.demodulator.flush()
            if len(fb2):
                frames = np.concatenate([frames, fb2]) if len(frames) \
                    else fb2
                snrs = np.concatenate([snrs, sn2]) if len(snrs) else sn2
        # soft LLRs from the demodulator's max-ratio metrics (fade-
        # weighted) — the hard +-4 fallback only if unavailable
        soft = self.demodulator.llrs[-len(frames):] if len(frames) else []
        self.demodulator.llrs.clear()
        speech = []
        for k, fbits in enumerate(frames):
            if soft:
                llr = np.asarray(soft[k][:self._ldpc.N], float)
            else:
                llr = (1.0 - 2.0 * fbits[:self._ldpc.N].astype(float)) * 4.0
            data, ok = self._ldpc.decode(llr)
            if len(snrs):
                self.snr_db = 0.8 * self.snr_db + 0.2 * float(snrs[k])
            if not ok:
                # FEC did not converge: random energy bits decode as loud
                # noise — squelch the frame (the reference mutes on sync/
                # SNR loss too)
                self.fec_failures += 1
                speech.append(np.zeros(4 * self._voc.FRAME, np.float32))
                continue
            for i in range(4):
                if self._c2dec is not None:
                    # the real over-the-air 700D payload IS Codec2 700C:
                    # decode the 28-bit newamp1 frame directly
                    # (codec2.c:2024, newamp1.c:536)
                    pcm = self._c2dec.decode_frame(data[i * 28:(i + 1) * 28])
                    speech.append(pcm.astype(np.float32))
                else:
                    fr = self._voc.decode_frame_700_bits(
                        data[i * 28:(i + 1) * 28])
                    speech.append(self.synth.synthesize(fr))
            self.frames_decoded += 1
        if not speech:
            return np.zeros(0, np.float32)
        return np.concatenate(speech).astype(np.float32)


def _check_block(n: int):
    if n % RATIO:
        raise ValueError(f"block {n} is not a multiple of {RATIO}")


class RateConverter:
    """48k <-> 8k conversion for the modem path.

    The reference drop-decimates 48k->8k with modulus counters (no
    anti-alias filter! `audio_driver.c:1340-1341`) and interpolates back
    with a 24-tap polyphase (`:1422-1442`).  Here both directions are
    polyphase FIRs, as in the JAX package: `down` is one K5 launch (72
    taps, /6), with the NCO translation fused where an increment is
    given, and `up` one K4 launch (x6, 72 taps, 12 a phase).  Tensors
    live on `device` (CUDA unless the caller names another).
    """

    def __init__(self, block_len_48k: int, device=None):
        _check_block(block_len_48k)
        self.block = block_len_48k
        self.device = resolve_device(device)
        self.h_dec = design.decimation_fir(72, RATIO, IQ_RATE).astype(np.float32)
        self.h_int = design.interpolation_fir(72, RATIO, IQ_RATE).astype(np.float32)
        self._h_dec = torch.as_tensor(self.h_dec, device=self.device)
        self._h_int = torch.as_tensor(self.h_int, device=self.device)
        # the decimator's raw history (..., 71) complex64 and the increment
        # it is rotated with (None: not rotated, the post-mix history)
        self._dec_carry = None
        self._dec_delta = None
        # the NCO's uint32 phase (..., ) int64, made at the first rotated
        # block and advanced by rotated blocks alone (the JAX package's
        # FreeDvRadioMode._phase)
        self.phase = None
        self._int_carry = None

    def _rotate_history(self, delta):
        """Re-rotate the raw history from the increment it was kept for to
        `delta` (None: no rotation), so that K5 rotates it into the same
        post-mix samples: raw' = raw rotor(old ramp) conj(rotor(new ramp))
        over the history's sample indices -71..-1."""
        old = self._dec_delta
        if old == delta:
            return
        n = self._dec_carry.shape[-1]
        zero = torch.zeros_like(self.phase)
        ramp_old = nco.phase_ramp(self.phase if old is not None else zero,
                                  0 if old is None else old, n, start=-n)
        ramp_new = nco.phase_ramp(self.phase if delta is not None else zero,
                                  0 if delta is None else delta, n, start=-n)
        self._dec_carry = self._dec_carry * nco.rotor(
            (ramp_old - ramp_new) & nco.MASK32)
        self._dec_delta = delta

    def down_planes(self, xi, xq, delta: int | None = None) -> torch.Tensor:
        """(..., B) f32 planes at 48 kHz -> (..., B/6) complex64 at 8 kHz,
        rotated first by the NCO at `delta` (a uint32 increment) where one
        is given: one K5 launch."""
        bs, B = tuple(xi.shape[:-1]), xi.shape[-1]
        xi = xi.reshape(-1, B).contiguous()
        xq = xq.reshape(-1, B).contiguous()
        C = xi.shape[0]
        if self._dec_carry is None:
            self._dec_carry = torch.zeros((C, 71), dtype=torch.complex64,
                                          device=self.device)
        if delta is not None and self.phase is None:
            self.phase = torch.zeros((C,), dtype=torch.int64,
                                     device=self.device)
        if self.phase is not None:
            self._rotate_history(delta)
        nco_arg = None if delta is None else (self.phase, int(delta))
        y, self._dec_carry, _ = fir_k.fir_rt(self._h_dec, self._dec_carry,
                                             xi, xq, RATIO, nco=nco_arg)
        if delta is not None:
            self.phase = nco.advance(self.phase, int(delta), B)
        return y.reshape(bs + (B // RATIO,))

    def down(self, iq_48k: torch.Tensor, delta: int | None = None
             ) -> torch.Tensor:
        """(..., B) complex 48 kHz IQ -> (..., B/6) complex64 at 8 kHz."""
        z = torch.as_tensor(iq_48k, device=self.device)
        return self.down_planes(z.real.to(torch.float32),
                                z.imag.to(torch.float32), delta)

    def up(self, audio_8k: torch.Tensor) -> torch.Tensor:
        """(..., n) f32 at 8 kHz -> (..., 6n) f32 at 48 kHz: one K4
        launch, none for an empty block (the history stays)."""
        x = torch.as_tensor(audio_8k, dtype=torch.float32, device=self.device)
        bs, n = tuple(x.shape[:-1]), x.shape[-1]
        sub = -(-72 // RATIO)
        if self._int_carry is None:
            self._int_carry = torch.zeros(bs + (sub - 1,),
                                          dtype=torch.float32,
                                          device=self.device)
        if n == 0:
            return x.new_zeros(bs + (0,))
        y, carry = fir_k.interpolate(
            self._h_int, self._int_carry.reshape(-1, sub - 1).contiguous(),
            x.reshape(-1, n).contiguous(), RATIO)
        self._int_carry = carry.reshape(bs + (sub - 1,))
        return y.reshape(bs + (n * RATIO,))


def freedv_rx_block(conv: RateConverter, modem: FreeDvModem,
                    iq_48k: torch.Tensor) -> torch.Tensor:
    """The RX glue path: 48k IQ -> 8k -> modem -> 8k speech -> 48k audio."""
    iq8 = conv.down(iq_48k)
    speech = modem.demod(iq8.cpu().numpy())
    return conv.up(torch.as_tensor(speech))


class FreeDvRadioMode:
    """FreeDV as a selectable MODE OF THE RADIO — the reference's
    IRQ-side glue (`AudioDriver_RxProcessorFreeDV` `audio_driver.c:
    1330-1470`: tap the TRANSLATED 48k IQ, rate-convert /6, hand to the
    deferred modem, upsample the 8k speech x6 back into the audio path)
    plus the TX mirror (`tx_processor.c:601-714`); the counterpart of the
    JAX package's (`cli rx/tx --mode freedv1600|freedv700d`, `serve`).

    RX: the NCO translation and the /6 decimation are one K5 launch a
    block with a carried uint32 phase (one without the NCO when the
    frequency is 0), on `device`; the modem and the x6 interpolation of
    its variable-length speech are host NumPy, as the reference's are.
    """

    MODES = ("freedv1600", "freedv700d")

    def __init__(self, mode: str, block_len: int,
                 translate_hz: float = 0.0, fs: float = IQ_RATE,
                 device=None):
        if mode not in self.MODES:
            raise ValueError(f"mode {mode!r} is not one of {self.MODES}")
        _check_block(block_len)
        self.mode = mode
        # RX decodes the real over-the-air Codec2 payload
        self.modem = (FreeDv1600(vocoder="codec2")
                      if mode == "freedv1600" else FreeDv700D())
        self.conv = RateConverter(block_len, device)
        self.device = self.conv.device
        self._translate = float(translate_hz)
        self._fs = float(fs)
        self._up_tails: dict = {}
        self._tx_n = 0

    def _planes(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _delta(self, extra_offset_hz: float) -> int | None:
        """The NCO increment that translates by -(translate + extra), or
        None at 0 Hz (no rotation, as the reference's :431-433)."""
        f = self._translate + float(extra_offset_hz)
        if f == 0.0:
            return None
        return int(nco.freq_to_delta(-f, self._fs))

    def _up48(self, x_new: np.ndarray, key: str) -> np.ndarray:
        """Streaming x6 polyphase interpolation of a VARIABLE-length 8k
        chunk, the JAX package's float64 NumPy (the modem's output lengths
        vary per block and are on the host already).  `key` names the
        carried tail (separate streams for RX speech and TX I/Q
        planes)."""
        h = np.asarray(self.conv.h_int, np.float64)
        carry = self._up_tails.setdefault(key, np.zeros(0, np.float64))
        x = np.concatenate([carry, np.asarray(x_new, np.float64)])
        keep = (len(h) + RATIO - 1) // RATIO
        if len(x) <= keep:
            self._up_tails[key] = x
            return np.zeros(0, np.float32)
        up = np.zeros(len(x) * RATIO)
        up[::RATIO] = x
        y = np.convolve(up, h)[: len(x) * RATIO]
        valid = y[keep * RATIO:]
        self._up_tails[key] = x[-keep:]
        return valid.astype(np.float32)

    # ---- RX: one 48k IQ block -> 48k speech (variable length) ----
    def rx_block(self, i_p, q_p, extra_offset_hz: float = 0.0) -> np.ndarray:
        iq8 = self.conv.down_planes(self._planes(i_p), self._planes(q_p),
                                    self._delta(extra_offset_hz))
        speech8 = self.modem.demod(iq8.cpu().numpy().reshape(-1))
        return self._up48(speech8, "rx")

    # ---- TX: 48k speech block -> 48k IQ (variable length) ----
    def tx_block(self, speech_48k) -> np.ndarray:
        s = self._planes(speech_48k)
        z = self.conv.down_planes(s, torch.zeros_like(s))
        speech8 = z.real.cpu().numpy().reshape(-1)
        iq8 = self.modem.mod(speech8)
        i48 = self._up48(iq8.real, "tx_i")
        q48 = self._up48(iq8.imag, "tx_q")
        iq48 = (i48 + 1j * q48).astype(np.complex64)
        if self._translate != 0.0 and len(iq48):
            n = self._tx_n + np.arange(len(iq48))
            self._tx_n += len(iq48)
            iq48 = (iq48 * np.exp(2j * np.pi * self._translate * n
                                  / self._fs)).astype(np.complex64)
        return iq48

    @property
    def stats(self) -> dict:
        m = self.modem
        out = {"frames_decoded": getattr(m, "frames_decoded", 0),
               "parity_errors": getattr(m, "parity_errors", 0)}
        if hasattr(m, "snr_db"):
            out["snr_db"] = float(m.snr_db)
        return out
