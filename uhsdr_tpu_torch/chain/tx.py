"""TX signal chain — the torch counterpart of `uhsdr_tpu.chain.tx` (itself
the equivalent of the firmware's `TxProcessor_Run`,
`tx_processor.c:891-1078`).

  audio in (48 kHz, batched over channels)
    -> voice conditioning: TX bandpass (the SOPRANO lattice as an exact SOS
       cascade; the legacy front's redesigned bandpass)
                                            [K2: cuda.iir.blocked_cascade]
       FM on the ref front: the IIR_TX_2k7_FM lattice as the exact serial
       recurrence                           [cuda.lattice.lattice]
       + voice compressor/ALC
       (`TxProcessor_PrepareVoice` :440, `TxProcessor_VoiceCompressor` :173)
                                            [the fused ALC stage:
                                             cuda.alc.alc_run]
    -> per-mode modulator: SSB / AM / FM / CW (mod.modulators)
                                            [K8: cuda.fir.fir_real; FM's
                                             table-mode accumulator
                                             cuda.fm_mod.fm_mod]
    -> final IQ gain + phase calibration    (`TxProcessor_IqFinalProcessing`
                                            :282)
  IQ out (48 kHz complex)

Everything is a function of (params, state, block), as the RX chain.
Entry points default to ``device="cuda"`` and raise where CUDA is absent;
``device="cpu"`` runs the kernels' plain torch versions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import data as refdata
from ..cuda import iir as iir_k
from ..mod import alc as alc_mod
from ..mod import modulators as mods
from ..ops import design, iir, latconv, lattice, nco
from .rx import leaves_to_numpy, resolve_device

IQ_RATE = 48000.0

_INT16_FS = 32767.0


def _lattice_sos5(name: str) -> np.ndarray:
    pk, pv = refdata.lattice(name)
    sos6 = np.asarray(latconv.lattice_to_sos(pk, pv), np.float64)
    sos6 = sos6 / sos6[:, 3:4]
    return np.concatenate([sos6[:, :3], sos6[:, 4:]],
                          axis=1).astype(np.float32)


@dataclass(frozen=True)
class TxConfig:
    """Static per-chain configuration; the JAX package's fields and
    defaults."""
    mode: str = "usb"               # usb | lsb | am | fm | cw
    front: str = "ref"              # "ref": the firmware's imported tables
    #                                 (iq_tx_wide Hilbert pair, TX IIR
    #                                 lattice, ALC/carrier constants, audio
    #                                 scaled through the int16-count
    #                                 domain); "scipy": legacy redesigned
    #                                 filters
    translate_hz: float = 6000.0
    block_len: int = 4096
    compressor: bool = True
    alc_decay: float = 0.02
    tx_bandpass: bool = True        # 275-2700 voice bandpass
    fm_dev_5khz: bool = False
    fm_subtone_hz: float = 0.0
    cw_sidetone_hz: float = 700.0
    iq_gain_balance: float = 0.0    # final calibration
    iq_phase_balance: float = 0.0


# The TX deployment bench_tx.py times (bench_tx.py:36-41): usb, ref front,
# 8192 channels of f32 audio @ 48 kHz in 16384-sample blocks.
TX_FLAGSHIP = TxConfig(mode="usb", translate_hz=6000.0, block_len=16384)
TX_FLAGSHIP_CHANNELS = 8192


class TxParams(NamedTuple):
    voice_sos: iir.Cascade | None
    alc: alc_mod.AlcParams | None
    ssb: mods.SsbModParams | None
    am: mods.AmModParams | None
    fm: mods.FmModParams | None
    cw_delta: int | None
    iq_gain: float
    iq_phase: float
    # ref front: the unit-domain audio is lifted into the firmware's
    # int16-count domain (where ALC_KNEE=30000 and AM_CARRIER_LEVEL=5100
    # live) and the IQ normalized back with the mode's gain compensation
    # (SSB/AM_GAIN_COMP=1.133, audio_driver.h:419-421)
    in_scale: float = 1.0
    out_scale: float = 1.0
    # (pk, pv) f32: the ref front's FM voice bandpass as the exact serial
    # lattice (its accumulator floors the audio every sample, so it
    # integrates any arithmetic difference of an SOS twin)
    voice_lat: tuple | None = None
    device: Any = None            # where the chain's tensors live


class TxState(NamedTuple):
    voice_sos_state: torch.Tensor | None   # (S, C, 2); (C, N) for a lattice
    alc: alc_mod.AlcState | None
    mod: mods.SsbModState | mods.FmModState | None
    cw_phase: torch.Tensor | None          # (C,) int64 in [0, 2^32)


def check_slice(cfg: TxConfig):
    if cfg.mode not in ("usb", "lsb", "am", "fm", "cw"):
        raise ValueError(f"TX mode {cfg.mode!r}")
    if cfg.front not in ("ref", "scipy"):
        raise ValueError(f"TX front {cfg.front!r}")


def make_params(cfg: TxConfig, device=None) -> TxParams:
    """The reference-table products (chain/tx.py:92-138 of the
    reference: the SOPRANO voice lattice as its exact SOS, FM's
    IIR_TX_2k7_FM as the serial lattice, compression level 2 ALC with the
    288-sample look-ahead, the iq_tx_wide pair, the AM carrier, FM's DDS
    constants) for usb/lsb/am/fm on the ref front; the legacy designs
    (:141-161) otherwise, CW included."""
    check_slice(cfg)
    dev = resolve_device(device)
    mode = cfg.mode
    voice = mode in ("usb", "lsb", "am", "fm")
    fm = (mods.fm_mod_params(cfg.translate_hz, cfg.fm_dev_5khz,
                             cfg.fm_subtone_hz,
                             count_domain=cfg.front == "ref")
          if mode == "fm" else None)
    if cfg.front == "ref" and voice:
        voice_lat = None
        if cfg.tx_bandpass and mode == "fm":
            pk, pv = refdata.lattice("IIR_TX_2k7_FM")
            voice_lat = (np.asarray(pk, np.float32),
                         np.asarray(pv, np.float32))
        return TxParams(
            voice_sos=(iir.cascade(_lattice_sos5("IIR_TX_SOPRANO"), dev)
                       if cfg.tx_bandpass and mode != "fm" else None),
            alc=(alc_mod.make_params(
                decay=10.0 ** (-((10.0 + 35.0) / 10.0)),  # alc_decay_var=10
                delay=288,           # AUDIO_DELAY_BUFSIZE ring at block 32
                postfilt_gain=4.0,   # alc_params[tx_comp_level=2]
                gain_scaling=0.23 if mode == "am" else 1.0)
                 if cfg.compressor else None),
            ssb=(mods.ssb_params_ref(cfg.translate_hz, lsb=mode == "lsb",
                                     device=dev)
                 if mode in ("usb", "lsb") else None),
            am=mods.am_params_ref(cfg.translate_hz, dev) if mode == "am"
            else None,
            fm=fm, cw_delta=None,
            iq_gain=1.0 + cfg.iq_gain_balance,
            iq_phase=cfg.iq_phase_balance,
            in_scale=_INT16_FS,
            # FM's DDS output is already unit-scale; the linear voice modes
            # normalize the count-domain IQ back down
            out_scale=1.0 if mode == "fm" else 1.133 / _INT16_FS,
            voice_lat=voice_lat,
            device=dev)
    voice_sos = None
    if cfg.tx_bandpass and voice:
        voice_sos = iir.cascade(design.audio_bandpass_sos(
            275.0, 2700.0, IQ_RATE, order=6).astype(np.float32), dev)
    return TxParams(
        voice_sos=voice_sos,
        alc=alc_mod.make_params(decay=cfg.alc_decay) if cfg.compressor
        else None,
        ssb=(mods.ssb_params(translate_hz=cfg.translate_hz,
                             lsb=mode == "lsb", device=dev)
             if mode in ("usb", "lsb") else None),
        am=mods.am_params(cfg.translate_hz, device=dev) if mode == "am"
        else None,
        fm=fm,
        cw_delta=(int(nco.freq_to_delta(cfg.translate_hz
                                        + cfg.cw_sidetone_hz, IQ_RATE))
                  if mode == "cw" else None),
        iq_gain=1.0 + cfg.iq_gain_balance,
        iq_phase=cfg.iq_phase_balance, device=dev)


def params_from_numpy(p: Any, device=None) -> TxParams:
    """The JAX package's TxParams (NumPy leaves) -> the port's TxParams,
    so both chains run off one set of design products."""
    dev = resolve_device(device)
    return TxParams(
        voice_sos=(None if p.voice_sos is None
                   else iir.cascade(p.voice_sos, dev)),
        alc=None if p.alc is None else alc_mod.params_from_numpy(p.alc),
        ssb=None if p.ssb is None else mods.params_from_numpy(p.ssb, dev),
        am=None if p.am is None else mods.params_from_numpy(p.am, dev),
        fm=None if p.fm is None else mods.fm_params_from_numpy(p.fm),
        cw_delta=None if p.cw_delta is None else int(p.cw_delta),
        iq_gain=float(p.iq_gain), iq_phase=float(p.iq_phase),
        in_scale=float(p.in_scale), out_scale=float(p.out_scale),
        voice_lat=(None if p.voice_lat is None else tuple(
            np.asarray(v, np.float32) for v in p.voice_lat)),
        device=dev)


def init_state(cfg: TxConfig, params: TxParams, batch_shape) -> TxState:
    bs = tuple(batch_shape)
    dev = params.device
    if params.voice_lat is not None:
        voice = lattice.init_state(bs, params.voice_lat[0].shape[0], dev)
    elif params.voice_sos is not None:
        voice = torch.zeros((params.voice_sos.sections,) + bs + (2,),
                            dtype=torch.float32, device=dev)
    else:
        voice = None
    mod = None
    if cfg.mode in ("usb", "lsb", "am"):
        mod = mods.ssb_init(bs, dev)
    elif cfg.mode == "fm":
        mod = mods.fm_mod_init(bs, dev)
    return TxState(
        voice_sos_state=voice,
        alc=(None if params.alc is None
             else alc_mod.init_state(bs, params.alc, device=dev)),
        mod=mod,
        cw_phase=(torch.zeros(bs, dtype=torch.int64, device=dev)
                  if cfg.mode == "cw" else None))


def process_block(cfg: TxConfig, params: TxParams, state: TxState,
                  audio: torch.Tensor):
    """audio: (C, T) f32 (CW: the keying envelope in [0, 1]).  Returns
    (iq (C, T) complex64, new_state, taps): ``taps`` carries the monitor
    streams the reference exports in its TX stream modes
    (`tx_processor.c:1031-1066`), "source" (the input audio) and
    "processed" (after the bandpass and compressor)."""
    taps = {"source": audio}
    sos_state, alc_state = state.voice_sos_state, state.alc
    if cfg.mode != "cw":
        if params.in_scale != 1.0:
            audio = audio * params.in_scale
        if params.voice_lat is not None:
            audio, sos_state = lattice.iir_lattice_block(
                *params.voice_lat, sos_state, audio)
        elif params.voice_sos is not None:
            audio, sos_state = iir_k.cascade_dispatch(
                params.voice_sos, sos_state, audio)
        if params.alc is not None:
            audio, alc_state = alc_mod.run(params.alc, alc_state, audio)
    taps["processed"] = audio

    cw_phase, mod_state = state.cw_phase, state.mod
    if cfg.mode in ("usb", "lsb"):
        iq, mod_state = mods.ssb_modulate(params.ssb, state.mod, audio)
    elif cfg.mode == "am":
        iq, mod_state = mods.am_modulate(params.am, state.mod, audio)
    elif cfg.mode == "fm":
        iq, mod_state = mods.fm_modulate(params.fm, state.mod, audio)
    else:
        iq, cw_phase = mods.cw_carrier(audio, state.cw_phase,
                                       params.cw_delta)

    # final IQ calibration (TxProcessor_IqFinalProcessing) and the ref
    # front's gain compensation / count-domain normalization
    gain = float(np.float32(params.iq_gain * params.out_scale))
    i_out = iq.real * gain
    q_out = (iq.imag * float(np.float32(params.out_scale))
             + i_out * params.iq_phase)
    return torch.complex(i_out, q_out), TxState(
        voice_sos_state=sos_state, alc=alc_state, mod=mod_state,
        cw_phase=cw_phase), taps


_UINT32_LEAVES = ("mod.phase", "mod.sub_phase", "cw_phase")


def state_from_numpy(s: Any, device=None) -> TxState:
    """The JAX package's TxState (NumPy leaves) -> the port's TxState;
    uint32 phases become int64."""
    dev = resolve_device(device)

    def t(a):
        if a is None:
            return None
        a = np.array(a)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.as_tensor(a, device=dev).contiguous()

    mod = None
    if s.mod is not None:
        kind = (mods.FmModState if hasattr(s.mod, "accum")
                else mods.SsbModState)
        mod = kind(*(t(v) for v in s.mod))
    return TxState(
        voice_sos_state=t(s.voice_sos_state),
        alc=None if s.alc is None else alc_mod.AlcState(
            t(s.alc.alc_val), t(s.alc.delay_buf)),
        mod=mod, cw_phase=t(s.cw_phase))


def state_to_numpy(state: TxState) -> dict:
    """The port's TxState -> {dotted field: NumPy array}, the phases as
    uint32 (the JAX package's dtype); leaves that are None are left out."""
    return leaves_to_numpy(state, _UINT32_LEAVES)


class TxChain:
    """One TX chain for a static config, batched over a leading channel
    axis, on one device (CUDA unless ``device`` names another)."""

    def __init__(self, cfg: TxConfig, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = make_params(cfg, self.device)

    def init_state(self, batch_shape=()) -> TxState:
        return init_state(self.cfg, self.params, batch_shape)

    def __call__(self, state: TxState, audio):
        """audio: (C, T) f32 (a NumPy array or a tensor).  Returns (i, q,
        new_state), the IQ as f32 planes, as the reference's TxChain."""
        if isinstance(audio, np.ndarray):
            audio = torch.from_numpy(np.ascontiguousarray(audio, np.float32))
        audio = audio.to(self.device, torch.float32).contiguous()
        iq, state, _ = process_block(self.cfg, self.params, state, audio)
        return iq.real, iq.imag, state
