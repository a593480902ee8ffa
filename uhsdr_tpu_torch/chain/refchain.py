"""Reference-exact RX chain: the firmware's stage structure with its exact
imported coefficient tables — the torch counterpart of
`uhsdr_tpu.chain.refchain`, the serial conformance twin of `chain.rx`
(whose front fuses the stages into one FIR).  Stage by stage, on the card:

  narrow SSB/CW (audio_driver.c:2718-2745):
      FreqShift                             [ops.nco.mix]
      -> decimate I/Q (FirRxDecimate_sideband_supp, real taps)
                                            [K5: cuda.fir.fir_rt, no NCO]
      -> Hilbert pair @ fs_dec (i_rx_new/q_rx_new) -> I±Q: one complex
         FIR h_i ∓ j·h_q with real output   [K6: cuda.fir.fir_cx]
  wide SSB:
      FreqShift -> Hilbert pair @48k -> I±Q [K6]
      -> decimate the audio                 [K5 on (audio, a zero plane),
                                             real out]
  AM/SAM:
      FreqShift -> decimate I/Q with the per-path AM lowpass taps [K5]
      -> envelope / SAM PLL @ fs_dec        [demod.am; K9/K10 and the
                                             sideband stage, demod.sam]
  FM:
      FreqShift -> 89-tap lowpass both planes @48k [K5 at decimation 1]
      -> discriminator [K12], de-emphasis/HPF -> FM_RX_SCALING -> AGC [K3]

  then the decimated-domain post chain (audio_driver.c:2436-2592):
      IIR-lattice PreFilter                 [cuda.lattice.lattice]
      -> WDSP AGC                           [K3: cuda.agc.agc]
      -> post-AGC gain scaling
      -> FIR interpolate                    [K4: cuda.fir.interpolate]
      -> IIR-lattice anti-alias             [cuda.lattice.lattice]

Everything is a function of (params, state, block) batched over a leading
channel axis; entry points default to ``device="cuda"`` and raise where
CUDA is absent, and run the kernels' plain torch versions only when the
caller asks for ``device="cpu"``.  Where the port's carried state differs
from the reference's in layout (the Hilbert pair's history is one
complex history here, two f32 planes there; the wide path's audio
history is complex with a zero imaginary part here), `state_from_numpy`
and `state_to_numpy` map it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import data
from ..cuda import fir as fir_kernels
from ..demod import am as am_mod
from ..demod import fm as fm_mod
from ..demod import sam as sam_mod
from ..ops import agc as agc_mod
from ..ops import fir as fir_ops
from ..ops import lattice, nco
from .rx import leaves_to_numpy, resolve_device

IQ_RATE = 48000.0

POST_AGC_GAIN_SCALING_DECIMATE_4 = 3.46     # audio_driver.h:362
POST_AGC_GAIN_SCALING_DECIMATE_2 = 3.46 * 0.6
FM_RX_SCALING_2K5 = 10000.0                 # audio_driver.c:1494
FM_RX_SCALING_5K = FM_RX_SCALING_2K5 / 2.0


@dataclass(frozen=True)
class RefRxConfig:
    """The reference chain's fields, names and defaults."""
    mode: str = "usb"               # usb | lsb | cw | am | sam | fm
    bw_key: str = "2P3KHZ"
    path_name: str | None = None
    select_id: int | None = None
    translate_hz: float = 6000.0
    block_len: int = 4096
    agc_mode: str = "med"
    agc_thresh_db: float = 60.0
    fade_leveler: bool = True
    sam_sideband: str = "both"
    fm_dev5: bool = False
    sql_threshold: int = 0

    @property
    def path(self) -> dict:
        return data.find_path(self.mode, self.bw_key,
                              select_id=self.select_id, name=self.path_name)

    @property
    def decim(self) -> int:
        return self.path["decim"]

    @property
    def fs_dec(self) -> float:
        return IQ_RATE / self.decim

    @property
    def uses_decimated_iq(self) -> bool:
        return data.uses_decimated_iq(self.path, self.mode)


# The reference chain at the SSB flagship's width: usb 2P3KHZ, the
# firmware's select-2 row (tests/test_conformance_ref.py's narrow case).
REF_FLAGSHIP = RefRxConfig(mode="usb", bw_key="2P3KHZ", select_id=2,
                           block_len=16384)


class RefRxParams(NamedTuple):
    nco_delta: int
    dec_fir: torch.Tensor | None    # (taps,) f32 real decimator taps
    hilb: torch.Tensor | None       # SSB/CW: (taps,) complex64 h_i ∓ j·h_q;
    #                                 FM: (taps,) f32 the 89-tap lowpass
    pre_pk: np.ndarray | None
    pre_pv: np.ndarray | None
    interp_fir: torch.Tensor | None
    aa_pk: np.ndarray | None
    aa_pv: np.ndarray | None
    agc: agc_mod.AgcParams
    fade: am_mod.FadeLevelerParams
    sam: sam_mod.SamParams
    fm: Any
    post_scale: float


class RefRxState(NamedTuple):
    nco_phase: torch.Tensor         # (C,) int64 in [0, 2^32)
    dec_carry: torch.Tensor | None  # (C, taps-1) complex64
    hilb_carry: torch.Tensor | None  # (C, taps-1) complex64
    pre_lat: torch.Tensor | None    # (C, N)
    agc: agc_mod.AgcState
    fade: am_mod.FadeLevelerState
    sam: sam_mod.SamState
    fm: Any
    interp_carry: torch.Tensor | None
    aa_lat: torch.Tensor | None


def _hilbert(mode: str, h_i: np.ndarray, h_q: np.ndarray) -> np.ndarray:
    """The Hilbert pair as one complex FIR whose real response is I + Q
    (usb, cw) or I - Q (lsb): Re((x_i + j x_q) ⊛ (h_i ∓ j h_q))."""
    sgn = 1.0 if mode == "lsb" else -1.0
    return (np.asarray(h_i, np.float32)
            + 1j * sgn * np.asarray(h_q, np.float32)).astype(np.complex64)


def _on_device(cfg: RefRxConfig, dev, *, nco_delta, dec_fir, hilb, pre_pk,
               pre_pv, interp_fir, aa_pk, aa_pv, agc, fade, sam, fm,
               post_scale) -> RefRxParams:
    """NumPy products (the reference's RefRxParams fields; `hilb` its (2,
    taps) f32 pair) -> the port's RefRxParams on `dev`."""
    def f32(a):
        return None if a is None else torch.as_tensor(
            np.ascontiguousarray(a, np.float32), device=dev)

    def host(a):
        return None if a is None else np.ascontiguousarray(a, np.float32)

    h = None
    if hilb is not None:
        h = (f32(hilb[0]) if cfg.mode == "fm" else torch.as_tensor(
            _hilbert(cfg.mode, hilb[0], hilb[1]), device=dev))
    return RefRxParams(
        nco_delta=int(nco_delta) & nco.MASK32, dec_fir=f32(dec_fir), hilb=h,
        pre_pk=host(pre_pk), pre_pv=host(pre_pv),
        interp_fir=f32(interp_fir), aa_pk=host(aa_pk), aa_pv=host(aa_pv),
        agc=agc_mod.AgcParams(**agc._asdict()),
        fade=am_mod.FadeLevelerParams(float(fade.mtauR), float(fade.mtauI)),
        sam=sam_mod.params_from_numpy(sam, dev),
        fm=None if fm is None else fm_mod.params_from_numpy(fm, dev),
        post_scale=float(post_scale))


def make_params(cfg: RefRxConfig, device=None) -> RefRxParams:
    """The reference chain's products from the imported tables
    (chain/refchain.py:126-174 of the reference)."""
    if cfg.mode not in ("usb", "lsb", "cw", "am", "sam", "fm"):
        raise ValueError(f"mode {cfg.mode!r}")
    dev = resolve_device(device)
    path = cfg.path
    dec_fir = hilb = None
    if cfg.mode in ("am", "sam"):
        dec_fir = data.fir(path["fir_i"], path["fir_numtaps"])
    elif cfg.mode == "fm":
        hilb = np.stack([data.fir(path["fir_i"], path["fir_numtaps"])] * 2)
    else:
        dec_fir = data.decimator(path["dec"])
        hilb = np.stack([data.fir(path["fir_i"], path["fir_numtaps"]),
                         data.fir(path["fir_q"], path["fir_numtaps"])])
    pre_pk = pre_pv = aa_pk = aa_pv = interp_fir = None
    if cfg.mode != "fm":
        if path["pre"] is not None:
            pre_pk, pre_pv = data.lattice(path["pre"])
        if path["interpolate"] is not None:
            interp_fir, _ = data.interpolator(path["interpolate"], cfg.decim)
        if path["antialias"] is not None:
            aa_pk, aa_pv = data.lattice(path["antialias"])
    fs_post = IQ_RATE if cfg.mode == "fm" else cfg.fs_dec
    post_scale = (POST_AGC_GAIN_SCALING_DECIMATE_4 if cfg.decim == 4
                  else POST_AGC_GAIN_SCALING_DECIMATE_2)
    post_scale *= 0.5 if cfg.mode in ("am", "sam") else 0.333
    return _on_device(
        cfg, dev, nco_delta=nco.freq_to_delta(-cfg.translate_hz, IQ_RATE),
        dec_fir=dec_fir, hilb=hilb, pre_pk=pre_pk, pre_pv=pre_pv,
        interp_fir=interp_fir, aa_pk=aa_pk, aa_pv=aa_pv,
        agc=agc_mod.make_params(fs_post, mode=cfg.agc_mode,
                                thresh_db=cfg.agc_thresh_db,
                                remove_dc=cfg.mode in ("am", "sam")),
        fade=am_mod.fade_leveler_params(cfg.fs_dec),
        sam=sam_mod.make_params(cfg.fs_dec),
        fm=(fm_mod.numpy_params(IQ_RATE, cfg.sql_threshold, 0.0)
            if cfg.mode == "fm" else None),
        post_scale=post_scale)


def params_from_numpy(p: Any, cfg: RefRxConfig, device=None) -> RefRxParams:
    """The JAX package's RefRxParams (NumPy leaves) -> the port's, so both
    chains run off one set of tables."""
    return _on_device(
        cfg, resolve_device(device), nco_delta=p.nco_delta,
        dec_fir=p.dec_fir, hilb=p.hilb, pre_pk=p.pre_pk, pre_pv=p.pre_pv,
        interp_fir=p.interp_fir, aa_pk=p.aa_pk, aa_pv=p.aa_pv, agc=p.agc,
        fade=p.fade, sam=p.sam, fm=p.fm, post_scale=p.post_scale)


def init_state(cfg: RefRxConfig, params: RefRxParams,
               batch_shape=()) -> RefRxState:
    bs = tuple(batch_shape)
    dev = params.sam.ap_sos[0].device

    def carry(h):
        return None if h is None else fir_ops.init_carry(bs, h.shape[-1],
                                                         device=dev)

    interp_carry = None
    if params.interp_fir is not None:
        sub_len = -(-params.interp_fir.shape[-1] // cfg.decim)
        interp_carry = torch.zeros(bs + (sub_len - 1,), dtype=torch.float32,
                                   device=dev)
    return RefRxState(
        nco_phase=torch.zeros(bs, dtype=torch.int64, device=dev),
        dec_carry=carry(params.dec_fir), hilb_carry=carry(params.hilb),
        pre_lat=(None if params.pre_pk is None else lattice.init_state(
            bs, params.pre_pk.shape[0], dev)),
        agc=agc_mod.init_state(bs, params.agc, device=dev),
        fade=am_mod.fade_leveler_init(bs, device=dev),
        sam=sam_mod.init_state(bs, device=dev),
        fm=(None if params.fm is None
            else fm_mod.init_state(bs, params.fm, device=dev)),
        interp_carry=interp_carry,
        aa_lat=(None if params.aa_pk is None else lattice.init_state(
            bs, params.aa_pk.shape[0], dev)))


def process_block(cfg: RefRxConfig, params: RefRxParams, state: RefRxState,
                  iq):
    """iq: an (i, q) tuple of (C, B) f32 planes @48 kHz, or a complex
    (C, B) tensor.  Returns (audio48 (C, B), new_state)."""
    xi, xq = iq if isinstance(iq, tuple) else (iq.real, iq.imag)
    nco_phase = state.nco_phase
    if cfg.translate_hz != 0.0:
        z, nco_phase = nco.mix(torch.complex(xi, xq), state.nco_phase,
                               params.nco_delta)
        xi, xq = z.real, z.imag
    xi, xq = xi.contiguous(), xq.contiguous()
    dec_carry, hilb_carry = state.dec_carry, state.hilb_carry
    fade_state, sam_state = state.fade, state.sam

    if cfg.mode == "fm":
        zf, hilb_carry, _ = fir_kernels.fir_rt(params.hilb, hilb_carry, xi,
                                               xq, 1)
        audio, fm_state = fm_mod.demod(params.fm, state.fm, zf)
        audio = audio * (FM_RX_SCALING_5K if cfg.fm_dev5
                         else FM_RX_SCALING_2K5)
        audio, agc_state = agc_mod.run(params.agc, state.agc, audio)
        return audio, state._replace(nco_phase=nco_phase,
                                     hilb_carry=hilb_carry, agc=agc_state,
                                     fm=fm_state)

    if cfg.uses_decimated_iq:
        z, dec_carry, _ = fir_kernels.fir_rt(params.dec_fir, dec_carry, xi,
                                             xq, cfg.decim)
        xi, xq = z.real.contiguous(), z.imag.contiguous()

    if cfg.mode in ("usb", "lsb", "cw"):
        audio, hilb_carry, _ = fir_kernels.fir_cx(
            params.hilb, hilb_carry, xi, xq, 1, real_out=True)
    elif cfg.mode == "am":
        audio, fade_state = am_mod.demod(torch.complex(xi, xq), params.fade,
                                         state.fade, cfg.fade_leveler)
    else:
        audio, _, sam_state = sam_mod.demod(
            params.sam, state.sam, torch.complex(xi, xq),
            sideband=cfg.sam_sideband, fade_leveler_on=cfg.fade_leveler)

    if not cfg.uses_decimated_iq:
        audio, dec_carry, _ = fir_kernels.fir_rt(
            params.dec_fir, dec_carry, audio, torch.zeros_like(audio),
            cfg.decim, real_out=True)

    # ---- post chain ----
    pre_lat = state.pre_lat
    if params.pre_pk is not None:
        audio, pre_lat = lattice.iir_lattice_block(
            params.pre_pk, params.pre_pv, state.pre_lat, audio)
    audio, agc_state = agc_mod.run(params.agc, state.agc, audio)
    audio = audio * params.post_scale
    interp_carry = state.interp_carry
    if params.interp_fir is not None:
        audio, interp_carry = fir_kernels.interpolate(
            params.interp_fir, state.interp_carry, audio.contiguous(),
            cfg.decim)
    aa_lat = state.aa_lat
    if params.aa_pk is not None:
        audio, aa_lat = lattice.iir_lattice_block(
            params.aa_pk, params.aa_pv, state.aa_lat, audio)
    return audio, state._replace(
        nco_phase=nco_phase, dec_carry=dec_carry, hilb_carry=hilb_carry,
        pre_lat=pre_lat, agc=agc_state, fade=fade_state, sam=sam_state,
        interp_carry=interp_carry, aa_lat=aa_lat)


_NESTED = {"agc": agc_mod.AgcState, "fade": am_mod.FadeLevelerState,
           "fm": fm_mod.FmState}
_UINT32_LEAVES = ("nco_phase", "fm.tone_phase")


def state_to_numpy(state: RefRxState, cfg: RefRxConfig) -> dict:
    """The port's RefRxState -> {dotted field: NumPy array} in the
    reference's layout: the Hilbert pair's history as its two f32 planes
    (C, 2, n), the wide path's audio history real, the NCO phases uint32.
    Leaves that are None are left out."""
    out = leaves_to_numpy(state, _UINT32_LEAVES)
    if "hilb_carry" in out:
        h = out["hilb_carry"]
        out["hilb_carry"] = np.stack([h.real, h.imag], axis=-2).astype(
            np.float32)
    if "dec_carry" in out and not cfg.uses_decimated_iq:
        out["dec_carry"] = np.ascontiguousarray(out["dec_carry"].real)
    return out


def state_from_numpy(s: Any, cfg: RefRxConfig, device=None) -> RefRxState:
    """The JAX package's RefRxState (NumPy leaves) -> the port's: a stream
    can move from one chain to the other mid-sequence."""
    dev = resolve_device(device)

    def t(a):
        if a is None:
            return None
        a = np.array(a)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.as_tensor(a, device=dev).contiguous()

    def nested(typ, v):
        if v is None:
            return None
        return typ(**{f: (nested(am_mod.FadeLevelerState, getattr(v, f))
                          if f == "fade" else t(getattr(v, f)))
                      for f in typ._fields})

    leaves = {f: t(getattr(s, f)) for f in RefRxState._fields
              if f not in _NESTED and f != "sam"}
    hc = leaves["hilb_carry"]
    if hc is not None:
        leaves["hilb_carry"] = torch.complex(hc[..., 0, :],
                                             hc[..., 1, :]).contiguous()
    dc = leaves["dec_carry"]
    if dc is not None and not dc.is_complex():
        leaves["dec_carry"] = torch.complex(dc, torch.zeros_like(dc))
    return RefRxState(**leaves, sam=nested(sam_mod.SamState, s.sam),
                      **{f: nested(typ, getattr(s, f))
                         for f, typ in _NESTED.items()})


class RefRxChain:
    """One reference-exact chain for a static config, batched over a
    leading channel axis, on one device (CUDA unless ``device`` names
    another)."""

    def __init__(self, cfg: RefRxConfig, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = make_params(cfg, self.device)

    def init_state(self, batch_shape=()) -> RefRxState:
        return init_state(self.cfg, self.params, batch_shape)

    def _tensor(self, a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        return a.to(self.device, torch.float32).contiguous()

    def __call__(self, state: RefRxState, iq=None, i=None, q=None):
        """iq: complex (C, B) array; or i=, q=: f32 planes (NumPy arrays or
        tensors).  Returns (audio48, new_state)."""
        if iq is not None:
            i, q = np.real(iq), np.imag(iq)
        return process_block(self.cfg, self.params, state,
                             (self._tensor(i), self._tensor(q)))
