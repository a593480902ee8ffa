"""The decoder tap: the digital-mode decoders on the RX chain's 12 kHz
``audio_dec`` tap, over all channels at once.

The batched counterpart of the JAX package's command-line decoder stack
(uhsdr_tpu/cli.py:43-107, `_make_text_decoder`; the reference's decoder
tap, audio_driver.c:2527-2556).  Each `push` takes one block of the tap,
(C, T) f32: it prefixes the remainder the last block left (T mod 88 for
CW's frames, T mod `rate` for PSK's symbols; the CLI keeps it in NumPy,
here it stays on the device), runs each mode's demodulator once over all
channels (one kernel launch a mode on the card) and returns each mode's
per-block result.  For the channels the caller names, the results are
kept on the device and handed to the host text decoders
(`CwTextDecoder`, `VaricodeDecoder`, `BaudotDecoder`) by `texts`, so a
stream of blocks is not held up by a copy to the host each block.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..chain.rx import resolve_device
from . import cw, cw_text, psk, psk_text, rtty, rtty_text

MODES = ("cw", "psk", "rtty")
FS = 12000.0                 # the decoder tap's rate
# the CLI's decoders: CW at 700 Hz with the ATC, RTTY 45.45 Bd / 170 Hz
# with the ATC
CW_PARAMS = cw.make_params(fs=FS, target_freq=700.0, atc=True)
RTTY_PARAMS = rtty.make_params(fs=FS, baud=45.45, shift=170.0)


class RttyOut(NamedTuple):
    codes: torch.Tensor    # (C, max_bytes) int32, -1 = none
    nbytes: torch.Tensor   # (C,) int32


class DecoderTap:
    """The three decoders over C channels of the decoder tap, state and
    remainders carried on `device` (CUDA unless the caller names
    another).  `text_channels` names the channels whose results go to
    the host text decoders.  CW and RTTY run `CW_PARAMS` and
    `RTTY_PARAMS`; PSK runs `psk_params`, PSK31 by default.  `modes`
    names the decoders that run (all three by default; the command line
    runs one)."""

    def __init__(self, channels: int, text_channels=(), device=None,
                 psk_params: psk.PskParams | None = None, modes=MODES):
        if not modes or set(modes) - set(MODES):
            raise ValueError(f"modes {modes!r}: some of {MODES}")
        self.modes = tuple(m for m in MODES if m in modes)
        self.device = resolve_device(device)
        self.channels = int(channels)
        self.text_channels = tuple(int(c) for c in text_channels)
        self._sel = torch.tensor(self.text_channels, dtype=torch.int64,
                                 device=self.device)
        C, dev = (self.channels,), self.device
        pp = psk_params or psk.make_params(fs=FS, speed=31)
        self.params = {"cw": CW_PARAMS, "psk": pp, "rtty": RTTY_PARAMS}
        self.state = {"cw": cw.init_state(C, dev),
                      "psk": psk.init_state(C, pp, dev),
                      "rtty": rtty.init_state(C, dev)}
        self.tail = {m: torch.zeros((self.channels, 0), dtype=torch.float32,
                                    device=dev) for m in ("cw", "psk")}
        self.pending = {m: [] for m in self.modes}
        n = len(self.text_channels)
        make = {"cw": lambda: cw_text.CwTextDecoder(
                    FS / CW_PARAMS.blocksize),
                "psk": psk_text.VaricodeDecoder,
                "rtty": rtty_text.BaudotDecoder}
        self.decoders = {m: [make[m]() for _ in range(n)]
                         for m in self.modes}

    def _framed(self, mode: str, audio: torch.Tensor, unit: int):
        """The whole frames of the remainder and this block; the rest
        stays as the next remainder.  None where no frame is whole."""
        buf = torch.cat([self.tail[mode], audio], dim=-1)
        n = (buf.shape[-1] // unit) * unit
        self.tail[mode] = buf[:, n:].contiguous()
        return buf[:, :n].contiguous() if n else None

    def push(self, audio_dec: torch.Tensor) -> dict:
        """One block of the tap, (C, T) f32 at 12 kHz.  Returns {mode:
        result} of each mode that runs: CW the keying (C, frames) bool,
        PSK the bits (C, symbols) int32 (None where no frame or symbol was
        whole), RTTY an `RttyOut`."""
        audio = audio_dec.to(torch.float32).contiguous()
        out = {}
        if "cw" in self.modes:
            x = self._framed("cw", audio, CW_PARAMS.blocksize)
            out["cw"] = None
            if x is not None:
                out["cw"], self.state["cw"] = cw.keying_detect(
                    CW_PARAMS, self.state["cw"], x)
        if "psk" in self.modes:
            p = self.params["psk"]
            x = self._framed("psk", audio, p.rate)
            out["psk"] = None
            if x is not None:
                out["psk"], self.state["psk"] = psk.demodulate(
                    p, self.state["psk"], x)
        if "rtty" in self.modes:
            codes, nb, self.state["rtty"] = rtty.demodulate(
                RTTY_PARAMS, self.state["rtty"], audio)
            out["rtty"] = RttyOut(codes, nb)
        if self.text_channels:
            for m, r in out.items():
                if r is not None:
                    r = r.codes if m == "rtty" else r
                    self.pending[m].append(r.index_select(0, self._sel))
        return out

    def texts(self) -> dict:
        """Hand the kept results to the host text decoders (one copy a
        mode) and return {mode: {channel: transcript so far}}."""
        res = {}
        for m in self.modes:
            if self.pending[m]:
                got = torch.cat(self.pending[m], dim=-1).cpu().numpy()
                self.pending[m] = []
                for k, dec in enumerate(self.decoders[m]):
                    if m == "cw":
                        dec.push_keying(got[k])
                    elif m == "psk":
                        dec.push_bits(got[k])
                    else:
                        dec.push_codes(got[k])
            res[m] = {c: self._text(m, dec) for c, dec in
                      zip(self.text_channels, self.decoders[m])}
        return res

    @staticmethod
    def _text(mode: str, dec) -> str:
        if mode == "cw":
            return dec.push_keying(np.zeros(0, bool))
        if mode == "psk":
            return dec.push_bits([])
        return dec.push_codes([])

    def flush(self) -> dict:
        """`texts`, after CW's decoders have seen a key-up long enough to
        end their last character (the CLI's flush, cli.py:72-74)."""
        self.texts()
        for dec in self.decoders.get("cw", ()):
            dec.push_keying(np.zeros(2000, bool))
        return self.texts()
