"""RX signal chain: the narrow and wide SSB/CW, AM, synchronous-AM, FM and
two-channel (iq, ssbstereo, SAM stereo) slices — the torch counterpart of
`uhsdr_tpu.chain.rx` (itself the equivalent of the
firmware's `AudioDriver_RxProcessor`, audio_driver.c:2603-2942, plus its
decimated-domain post-processing, :2436-2592).

Stage order of the reference-table chains:

  int16 (or f32) IQ planes, batched over channels
    -> with iq_auto_correction: the Moseley-Slump IQ correction, f32
       planes at full scale 1 out         [cuda.iqcorr.iqcorr]
    -> the reference-table front (front="ref"):
       SSB/CW: ADC peak taps, NCO translation, stage-A decimator, stage-B
       Hilbert-combine FIR, real audio out  [K1: cuda.fir.front; under
       UHSDR_FRONT_MT=1 and a static delta K15: cuda.fir.front_mt, the
       translation in modulated stage-A taps]
       iq/ssbstereo: the same with two stage-B filters, two-channel
       audio (C, 2, T) out                  [K1, counted as front_pair]
       wide SSB: ADC peak taps, NCO translation, one complex-tap
       decimating FIR (Hilbert pair ⊛ decimator), real audio out
                                            [K7, K6 untranslated:
                                             cuda.fir.fir_cx]
       AM/SAM/FM: ADC peak taps, NCO translation, the per-path AM lowpass
       as the decimator, complex IQ out     [K5: cuda.fir.fir_rt]
    -> or the legacy redesigned front (front="scipy", and iq/ssbstereo on
       the wide rows, where the reference has no table pair): one scipy
       filter of 199 (high_taps) or 89 taps at the capture rate.
       usb/lsb/cw: a complex analytic bandpass, real audio out
                                            [K7, K6 untranslated:
                                             cuda.fir.fir_cx]
       ssbstereo: a USB and an LSB bandpass on the same planes, real
       (C, 2, T) audio out                  [K7/K6, two launches]
       am/sam/iq/fm: a symmetric lowpass (real taps; the TPU's real-tap
       kernel too, pallas/fir.py:513), complex IQ out, FM at decimation 1
       and the capture rate, iq split into its Re/Im channels
                                            [K5: cuda.fir.fir_rt]
    -> the sharded front (parallel/rx_sharded.py) leaves stage B out and
       hands complex stage-A output to `stage_b`, the unfused Hilbert
       combine at fs_dec, real audio out  [K6 at decimation 1:
                                           cuda.fir.fir_cx]
    -> demod: SSB (the real part, already taken by K1/K7); AM envelope
       and fade leveler; SAM PLL            [K9/K10: cuda.pll] with the
       sideband stage (products, allpass chains, combine, fade leveler;
       K11's chains on the TPU)             [cuda.sam.sam_sideband];
       FM discriminator                     [K12: cuda.elemwise.fm_disc],
       de-emphasis, squelch, subtone gate, FM_RX_SCALING; the FM chain
       then runs the AGC and biquad2 alone at 48 kHz
    -> the NLMS auto-notch, then the leaky LMS (options; leaky_notch puts
       the leaky LMS in the notch's place)  [cuda.lms.nlms, cuda.lms.leaky]
    -> PreFilter lattice as an exact SOS cascade (the legacy front: a
       scipy audio bandpass)                [K2: cuda.iir.
       blocked_cascade; blocks that do not chunk K11]
    -> WDSP look-ahead AGC                  [K3: cuda.agc.agc], for AM/SAM
       followed by its DC blocker; two-channel audio: the linked stereo
       AGC, one machine on max(|L|, |R|), the whole stage one launch
                                            [cuda.agc.agc_stereo; the
                                             reference's K13 inside]
    -> the LPC noise blanker, then the spectral NR (options)
                                            [cuda.blanker.blanker;
                                             cuda.nr.nr_gains between
                                             torch.fft's rfft and irfft]
    -> post-AGC scale, EQ biquad1 (pruned empty at neutral settings)
    -> polyphase interpolation to the IQ rate [K4: cuda.fir.interpolate;
                                               two channels as 2C rows]
    -> anti-alias lattice (48 kHz paths only), treble biquad2
  audio out (IQ rate, real)

Everything is a function of (params, state, block).  Params and state
hold torch tensors on one device; entry points default to
``device="cuda"`` and raise where CUDA is absent, and run the kernels'
plain torch versions only when the caller asks for ``device="cpu"``.
`RxConfig` has every field of the JAX package's, under its names and
defaults.  ``cw_offset_hz`` (read by no chain code in either package),
the backend selectors ``front_impl`` and ``iir_impl``, ``front_prec`` and
``nr_prec_escalate`` are accepted for configuration parity: the port
computes the same thing for every value; ``high_taps`` is read by the
legacy front alone.  FM runs the IQ correction but none of
the decimated-rate options (the reference's FM branches skip them; their
states pass through).  The port always computes in
full FP32 (the kernels use FP32 FMAs, never TF32 or bf16, K15
included, whose TPU counterpart runs one bf16 pass; the smoothers'
matmuls and the cascade's plain form refuse to run on the card with
TF32 on, which callers that compare numbers pin off).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import data as refdata
from ..cuda import fir as fir_kernels
from ..cuda import iir as iir_k
from ..demod import am as am_mod
from ..demod import fm as fm_mod
from ..demod import sam as sam_mod
from ..demod import ssb as ssb_mod
from ..nr import blanker as nb_mod
from ..nr import spectral as nr_mod
from ..ops import agc as agc_mod
from ..ops import design, iir, iqcorr, latconv, lms, nco
from ..ops import fir as fir_ops
from . import eq as eq_mod
from . import filterpaths

IQ_RATE = 48000.0

_EMPTY_SOS = np.zeros((0, 5), np.float32)

# post-AGC output scaling (audio_driver.h:362-364, audio_driver.c:2517-2527)
POST_AGC_GAIN_SCALING_DECIMATE_4 = 3.46
POST_AGC_GAIN_SCALING_DECIMATE_2 = 3.46 * 0.6
# FM audio scaling ahead of the AGC (audio_driver.c:1494-1495)
FM_RX_SCALING_2K5 = 10000.0
FM_RX_SCALING_5K = FM_RX_SCALING_2K5 / 2.0

# the legacy front's filter lengths (filters.h: 199 / 89 RX taps)
RX_TAPS_HI = 199
RX_TAPS_LO = 89


def resolve_device(device=None) -> torch.device:
    """The chain's device: CUDA unless the caller names another.  Raises
    where CUDA is absent rather than falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "uhsdr_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' for the plain torch path")
    return dev


@dataclass(frozen=True)
class RxConfig:
    """Static per-chain configuration (channels sharing a config are
    batched).  The fields keep the JAX package's names and defaults."""
    mode: str = "usb"              # usb | lsb | cw | am | sam | fm | iq |
    #                                ssbstereo
    bw_key: str = "2P3KHZ"
    path_name: str | None = None   # sub-path of the filter registry
    front: str = "ref"             # "ref": the firmware's imported tables;
    #                                "scipy": the legacy redesigned front
    ref_select_id: int | None = None  # FilterPathInfo row selector
    translate_hz: float = 6000.0   # reference: ±6k/±12k (audio_driver.c:445)
    block_len: int = 4096          # IQ-rate samples per block
    high_taps: bool = True         # the legacy front's 199- vs 89-tap filter
    agc_mode: str = "med"
    agc_thresh_db: float = 60.0
    nr_enable: bool = False
    nr_strength: int = 141         # spectral NR (nr_enable)
    nb_enable: bool = False
    nb_setting: int = 8            # noise blanker (nb_enable), 0..15
    notch_enable: bool = False
    leaky_nr_enable: bool = False
    leaky_notch: bool = False      # leaky LMS as the notch (notch_enable)
    sql_threshold: int = 0         # FM squelch
    subtone_hz: float = 0.0        # FM subaudible tone detect
    sam_sideband: str = "both"     # SAM: both | usb | lsb | stereo
    fade_leveler: bool = True      # AM/SAM
    cw_offset_hz: float = 700.0    # accepted; no chain code reads it
    iq_auto_correction: bool = False
    fm_dev5: bool = False          # FM deviation 5 kHz (else 2.5 kHz)
    front_impl: str = "auto"       # accepted; the port's front is its kernel
    front_prec: str = "default"    # accepted; the port computes in FP32
    iir_impl: str = "auto"         # accepted; the cascades are K2 / K11
    iq_rate: float = IQ_RATE       # 48 kHz or a multiple (96 kHz flagship)
    eq: eq_mod.EqSettings = eq_mod.EqSettings()   # tone controls
    nr_prec_escalate: bool = True  # NR's front precision (nr_enable)

    @property
    def path(self) -> filterpaths.FilterPath:
        return filterpaths.find_path(self.mode, self.bw_key, self.path_name)

    @property
    def use_ref_front(self) -> bool:
        """The reference-table front runs: front="ref", and for the
        two-channel modes a narrow (decimated-IQ) SSB row; the wide rows
        have no table pair and run the legacy front, as the reference's
        (chain/rx.py:174-193)."""
        if self.front != "ref":
            return False
        if self.mode in ("iq", "ssbstereo"):
            try:
                return refdata.uses_decimated_iq(self.ref_path, "usb")
            except KeyError:
                return False
        return True

    @property
    def ref_path(self) -> dict:
        """The firmware FilterPathInfo row (audio_filter.c:147-928).  The
        two-channel modes run the firmware's SSB rows (the demod-mode
        branch comes after the filters, audio_driver.c:2757-2777)."""
        return refdata.find_path(self.mode, self.bw_key,
                                 select_id=self.ref_select_id)

    @property
    def n_audio(self) -> int:
        """1 (mono) or 2: IQ as stereo, LSB/USB stereo, SAM stereo — the
        reference's USE_TWO_CHANNEL_AUDIO modes (audio_driver.c:2618)."""
        if self.mode in ("iq", "ssbstereo"):
            return 2
        return 2 if self.mode == "sam" and self.sam_sideband == "stereo" \
            else 1

    @property
    def front_pair(self) -> bool:
        """The front feeds the two audio channels through a filter pair
        (the state carries its raw history on both planes, (C, 2, n), in
        the reference's layout): ssbstereo always, iq on the
        reference-table front (the legacy iq runs one symmetric lowpass
        and splits Re/Im)."""
        return self.mode == "ssbstereo" or (self.mode == "iq"
                                            and self.use_ref_front)

    @property
    def stage_b_pair(self) -> bool:
        """The pair is stage A and two stage-B filters (K1, counted as
        front_pair): the two-channel modes on the reference-table front."""
        return self.front_pair and self.use_ref_front

    @property
    def rate_mult(self) -> int:
        """iq_rate / 48 kHz: faster captures lift the 48k front filter by
        this factor (noble identity) so the chain runs at the reference's
        decimated rates."""
        k = self.iq_rate / IQ_RATE
        if k != int(k) or k < 1:
            raise ValueError(f"iq_rate must be a multiple of 48 kHz, "
                             f"got {self.iq_rate}")
        return int(k)

    @property
    def decim(self) -> int:
        base = (self.ref_path["decim"] if self.use_ref_front
                else self.path.decim)
        return int(base * self.iq_rate / IQ_RATE)

    @property
    def front_decim(self) -> int:
        """The front's decimation: the legacy FM front runs at decimation 1
        and its chain at the capture rate (chain/rx.py:678-679 of the
        reference)."""
        return 1 if self.mode == "fm" and not self.use_ref_front \
            else self.decim

    @property
    def fs_dec(self) -> float:
        return self.iq_rate / self.decim


# The flagship deployment, the chain bench.py times (bench.py:89-113): the
# BASELINE's "10k simultaneous SSB channels @96 kHz", run at 8192
# channels of int16 IQ planes.
FLAGSHIP = RxConfig(mode="usb", bw_key="2P3KHZ", path_name="LPF",
                    translate_hz=12000.0, iq_rate=96000.0, block_len=16384)
FLAGSHIP_CHANNELS = 8192

# The AM/SAM deployment at the flagship's channel count, rate and block:
# the 5 kHz AM/SAM path (firmware decimation 2, so 24 kHz after the
# front), the configuration tools/bench_sam_fm.py times.  Run with
# mode="am", or mode="sam" and sam_sideband both | usb | lsb.
SAM_FLAGSHIP = RxConfig(mode="sam", bw_key="5P0KHZ", path_name="AM/SAM",
                        translate_hz=12000.0, iq_rate=96000.0,
                        block_len=16384)

# The FM deployment at the flagship's channel count, rate and block: the
# 5 kHz FM path (the 89-tap lowpass lifted to 96 kHz, decimation 2 to the
# reference's 48 kHz FM chain), the FM configuration
# tools/bench_sam_fm.py:55 times.
FM_FLAGSHIP = RxConfig(mode="fm", bw_key="5P0KHZ", path_name="FM",
                       translate_hz=12000.0, iq_rate=96000.0,
                       block_len=16384)

# The two-channel deployment: the flagship's filter with both sidebands
# demodulated at once, USB left and LSB right (audio_driver.c:2774-2777);
# mode="iq" on the same row gives the filtered I and Q.
STEREO_FLAGSHIP = RxConfig(mode="ssbstereo", bw_key="2P3KHZ",
                           path_name="LPF", translate_hz=12000.0,
                           iq_rate=96000.0, block_len=16384)

# The wide-SSB deployment: the narrowest wide-SSB row that runs at 96 kHz
# (5P0KHZ, no anti-alias lattice): one 245-tap complex front decimating
# by 4 to 24 kHz, x4 interpolation.
WIDE_FLAGSHIP = RxConfig(mode="usb", bw_key="5P0KHZ", path_name="LPF",
                         translate_hz=12000.0, iq_rate=96000.0,
                         block_len=16384)

# The SSB flagship on the legacy redesigned front: one 199-tap complex
# analytic bandpass decimating by 8, the scipy audio bandpass and
# interpolator.
SCIPY_FLAGSHIP = RxConfig(mode="usb", bw_key="2P3KHZ", path_name="LPF",
                          front="scipy", translate_hz=12000.0,
                          iq_rate=96000.0, block_len=16384)


def check_slice(cfg: RxConfig):
    """Raise ValueError for a mode or sideband no chain has."""
    if cfg.mode not in ("usb", "lsb", "cw", "am", "sam", "fm", "iq",
                        "ssbstereo"):
        raise ValueError(f"mode {cfg.mode!r}")
    if cfg.mode == "sam" and cfg.sam_sideband not in ("both", "usb", "lsb",
                                                      "stereo"):
        raise ValueError(f"sam_sideband {cfg.sam_sideband!r}")


class RxParams(NamedTuple):
    """Design products for one chain config, resident on one device."""
    nco_delta: int                # uint32 phase increment
    front_fir: torch.Tensor       # (taps,) the decimating front: f32 real
    #                               taps, or complex64 for wide SSB and
    #                               the legacy SSB front; (2, taps)
    #                               complex64 for legacy ssbstereo
    front2: torch.Tensor | None   # (taps2,) complex64 stage-B Hilbert FIR,
    #                               (2, taps2) for the two-channel modes;
    #                               None without a second stage
    audio_sos: iir.Cascade        # PreFilter lattice as SOS
    interp_fir: torch.Tensor      # (taps,) f32 interpolator
    agc: agc_mod.AgcParams
    fade: am_mod.FadeLevelerParams
    sam: sam_mod.SamParams
    fm: fm_mod.FmParams | None    # FM only
    iq_gain: float
    iq_phase: float
    post_scale: float             # firmware post-AGC scaling
    eq1_sos: iir.Cascade          # decimated-rate EQ (biquad1)
    eq2_sos: iir.Cascade          # IQ-rate treble shelf (biquad2)
    aa_sos: iir.Cascade           # post-interp anti-alias lattice
    nr: nr_mod.NrParams | None = None          # spectral NR (nr_enable)
    nb: nb_mod.NbParams | None = None          # noise blanker (nb_enable)
    notch: lms.LmsParams | None = None         # NLMS auto-notch
    leaky: lms.LeakyLmsParams | None = None    # leaky LMS (NR or notch)


class RxState(NamedTuple):
    nco_phase: torch.Tensor       # (C,) int64 in [0, 2^32)
    front_carry: torch.Tensor     # (C, taps-1) complex64 RAW pre-mix IQ;
    #                               iq/ssbstereo: (C, taps-1 + decim *
    #                               (taps2-1)), the reference's pair's
    front2_carry: torch.Tensor | None  # (C, taps2-1) complex64 stage-A
    #                                    output; None without a stage B
    # the post chain's leaves carry an audio-channel axis (2,) after C in
    # the two-channel modes, as the reference's (its NUM_AUDIO_CHANNELS
    # loops), but for the linked AGC's shared machine leaves
    audio_sos_state: torch.Tensor  # (S, C, 2)
    agc: agc_mod.AgcState
    fade: am_mod.FadeLevelerState
    sam: sam_mod.SamState
    fm: fm_mod.FmState | None     # FM only
    interp_carry: torch.Tensor    # (C, sub_len-1)
    eq1: torch.Tensor
    eq2: torch.Tensor
    aa: torch.Tensor
    # the options' states (None where the option is off), named and nested
    # as the reference's: iqcorr per RF channel (C,), the others on the
    # post chain's rows (C,) or (C, 2)
    iqcorr: iqcorr.IqCorrState | None = None
    nr: nr_mod.NrState | None = None
    nb: nb_mod.NbState | None = None
    notch: lms.LmsState | None = None
    leaky: lms.LeakyLmsState | None = None


def _upsample(h: np.ndarray, k: int) -> np.ndarray:
    """Zero-stuff h by k (the multirate noble identity's rate lift)."""
    if k == 1:
        return h
    u = np.zeros(k * (len(h) - 1) + 1, h.dtype)
    u[::k] = h
    return u


def _rate_adapt_front(h: np.ndarray, k: int, iq_rate: float) -> np.ndarray:
    """Lift a 48k-rate front filter to a k·48k input rate: a short
    wideband anti-alias ⊛ upsample_k(h) is one decimating filter at the
    capture rate (chain/rx.py:308-318 of the reference)."""
    if k == 1:
        return h
    hb = design.lowpass_fir(32 * k - 1, 20000.0, iq_rate)
    return np.convolve(hb, _upsample(h, k))


def _sos5(sos6: np.ndarray) -> np.ndarray:
    """scipy (n,6) SOS -> the chain's normalized (n,5) [b0 b1 b2 a1 a2]."""
    sos6 = np.asarray(sos6, np.float64)
    sos6 = sos6 / sos6[:, 3:4]
    return np.concatenate([sos6[:, :3], sos6[:, 4:]],
                          axis=1).astype(np.float32)


def _lattice_sos5(name: str | None) -> np.ndarray:
    if name is None:
        return _EMPTY_SOS
    pk, pv = refdata.lattice(name)
    return _sos5(latconv.lattice_to_sos(pk, pv))


def _post_scale(cfg: RxConfig) -> float:
    """Firmware post-AGC scaling, exact (audio_driver.c:2517-2527); FM's
    scaling ahead of its AGC (:1494-1495).  The legacy front multiplies
    it by the reference interpolator's net passband gain over the
    decimation, where the row has a reference analog (its tables do not
    compensate the zero-stuffing, the scipy interpolator does; the
    reference's `_reference_post_scale`, chain/rx.py:61-83)."""
    if cfg.mode == "fm":
        return FM_RX_SCALING_5K if cfg.fm_dev5 else FM_RX_SCALING_2K5
    ref_decim = (cfg.ref_path["decim"] if cfg.use_ref_front
                 else cfg.path.decim)
    base = (POST_AGC_GAIN_SCALING_DECIMATE_4 if ref_decim == 4
            else POST_AGC_GAIN_SCALING_DECIMATE_2)
    base *= 0.5 if cfg.mode in ("am", "sam") else 0.333
    if cfg.use_ref_front:
        return base
    try:
        row = refdata.find_path(cfg.mode, cfg.bw_key)
        if row["interpolate"] is not None:
            g_ref = refdata.interp_passband_gain(row["interpolate"],
                                                 ref_decim)
            base *= g_ref / ref_decim
    except KeyError:
        pass                        # no reference analog for this path
    return base


def _on_device(device, *, nco_delta, front_fir_re, front_fir_im, front2_re,
               front2_im, audio_sos, interp_fir, agc, fade, sam, fm, iq_gain,
               iq_phase, post_scale, eq1_sos, eq2_sos, aa_sos, nr=None,
               nb=None, notch=None, leaky=None) -> RxParams:
    """NumPy design products (the JAX package's RxParams fields) ->
    the port's RxParams on `device`.  The front stays real f32 unless its
    imaginary taps are non-zero (wide SSB: complex64)."""
    dev = torch.device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def c64(re, im):
        return torch.as_tensor(
            (np.asarray(re, np.float32)
             + 1j * np.asarray(im, np.float32)).astype(np.complex64),
            device=dev)

    front = (c64(front_fir_re, front_fir_im)
             if np.any(np.asarray(front_fir_im)) else f32(front_fir_re))
    return RxParams(
        nco_delta=int(nco_delta) & nco.MASK32,
        front_fir=front,
        front2=None if front2_re is None else c64(front2_re, front2_im),
        audio_sos=iir.cascade(audio_sos, dev),
        interp_fir=f32(interp_fir),
        agc=agc_mod.AgcParams(**agc._asdict()),
        fade=am_mod.FadeLevelerParams(float(fade.mtauR), float(fade.mtauI)),
        sam=sam_mod.params_from_numpy(sam, dev),
        fm=None if fm is None else fm_mod.params_from_numpy(fm, dev),
        iq_gain=float(iq_gain),
        iq_phase=float(iq_phase),
        post_scale=float(post_scale),
        eq1_sos=iir.cascade(eq1_sos, dev),
        eq2_sos=iir.cascade(eq2_sos, dev),
        aa_sos=iir.cascade(aa_sos, dev),
        nr=nr, nb=nb, notch=notch, leaky=leaky)


def _option_params(cfg: RxConfig, fs_dec: float) -> dict:
    """The options' parameters, as the reference makes them
    (chain/rx.py:424-438): the NR on the path's audio band at the
    decimated rate, its alpha 0.799 + strength/1000; the leaky LMS in the
    notch's place under leaky_notch."""
    nr = None
    if cfg.nr_enable:
        lo, hi = cfg.path.audio_band
        nr = nr_mod.make_params(fs_dec, lo, hi,
                                alpha=0.799 + cfg.nr_strength / 1000.0)
    leaky = None
    if cfg.leaky_nr_enable or (cfg.notch_enable and cfg.leaky_notch):
        leaky = lms.leaky_lms_params(
            notch=cfg.notch_enable and cfg.leaky_notch)
    return dict(
        nr=nr, nb=nb_mod.make_params(cfg.nb_setting) if cfg.nb_enable
        else None,
        notch=(lms.notch_params() if cfg.notch_enable and not cfg.leaky_notch
               else None),
        leaky=leaky)


def _front_design(cfg: RxConfig):
    """(stage-A or only front FIR, stage-B FIR or None) as NumPy arrays,
    before the lift to the capture rate.  Narrow SSB/CW: the firmware's
    real decimator, then its Hilbert pair fused into one complex FIR g =
    h_i ∓ j·h_q whose real response is I±Q.  iq/ssbstereo: the same
    decimator, then two such filters, one per audio channel
    (audio_driver.c:2770-2777): ssbstereo g0 = h_i - j·h_q (USB), g1 =
    h_i + j·h_q (LSB); iq g0 = h_i (filtered I), g1 = -j·h_q (Re of
    -j(a+jb) is b: filtered Q).  The reference folds each into one
    input-rate filter dec ⊛ upsample(g_k) (chain/rx.py:364-398); by the
    noble identity that is this stage A followed by g_k.  Wide SSB: the
    Hilbert pair before the (real) decimator, one complex FIR g ⊛ dec.
    AM/SAM/FM: the per-path AM lowpass, no stage B."""
    rp = cfg.ref_path
    if cfg.mode in ("am", "sam", "fm"):
        return refdata.fir(rp["fir_i"], rp["fir_numtaps"]), None
    h_i = refdata.fir(rp["fir_i"], rp["fir_numtaps"])
    h_q = refdata.fir(rp["fir_q"], rp["fir_numtaps"])
    dec = refdata.decimator(rp["dec"])
    if cfg.front_pair:
        gs = ((h_i - 1j * h_q, h_i + 1j * h_q) if cfg.mode == "ssbstereo"
              else (h_i.astype(complex), -1j * h_q))
        return dec, np.stack(gs)
    sgn = 1.0 if cfg.mode == "lsb" else -1.0          # g = h_i ∓ j·h_q
    g = h_i + 1j * sgn * h_q
    if refdata.uses_decimated_iq(rp, cfg.mode):       # narrow SSB/CW
        return dec, g
    return np.convolve(g, dec), None                  # wide SSB


def _make_params_legacy(cfg: RxConfig, dev) -> RxParams:
    """The legacy redesigned front and post products (chain/rx.py:477-552
    of the reference): one scipy filter at the capture rate — a complex
    analytic bandpass for usb/lsb/cw (cw on the USB band), a symmetric
    lowpass at the row's AM cutoff class for am/sam/iq, a USB and an LSB
    bandpass for ssbstereo, a lowpass of half the row's width (at least
    5 kHz) for FM; the scipy audio bandpass at fs_dec, the scipy
    interpolator of 16 taps a phase, no anti-alias lattice."""
    path = cfg.path
    taps = RX_TAPS_HI if cfg.high_taps else RX_TAPS_LO
    lo, hi = path.audio_band
    fs = cfg.iq_rate
    usb, lsb = (max(lo, 50.0), hi), (-hi, -max(lo, 50.0))
    if cfg.mode in ("usb", "cw"):
        h = design.complex_bandpass_fir(taps, *usb, fs)
    elif cfg.mode == "lsb":
        h = design.complex_bandpass_fir(taps, *lsb, fs)
    elif cfg.mode in ("am", "sam", "iq"):
        cut = min(max(hi, 2300.0), 10000.0)
        h = design.complex_bandpass_fir(taps, -cut, cut, fs)
    elif cfg.mode == "ssbstereo":
        h = np.stack([design.complex_bandpass_fir(taps, *usb, fs),
                      design.complex_bandpass_fir(taps, *lsb, fs)])
    else:                                               # fm
        cut = path.width / 2 if path.width >= 5000 else 5000.0
        h = design.complex_bandpass_fir(taps, -cut, cut, fs)
    fs_dec = cfg.fs_dec
    return _on_device(
        dev,
        nco_delta=nco.freq_to_delta(-cfg.translate_hz, fs),
        front_fir_re=h.real, front_fir_im=h.imag,
        front2_re=None, front2_im=None,
        audio_sos=design.audio_bandpass_sos(lo if lo > 60 else 0.0,
                                            min(hi, 0.45 * fs_dec), fs_dec),
        interp_fir=design.interpolation_fir(16 * cfg.decim, cfg.decim, fs),
        agc=agc_mod.make_params(fs_dec, mode=cfg.agc_mode,
                                thresh_db=cfg.agc_thresh_db,
                                remove_dc=cfg.mode in ("am", "sam")),
        fade=am_mod.fade_leveler_params(fs_dec),
        sam=sam_mod.make_params(fs_dec),
        fm=(fm_mod.numpy_params(fs, cfg.sql_threshold, cfg.subtone_hz)
            if cfg.mode == "fm" else None),
        iq_gain=1.0, iq_phase=0.0,
        post_scale=_post_scale(cfg),
        eq1_sos=eq_mod.rx_biquad1_sos(cfg.eq, fs_dec),
        eq2_sos=eq_mod.rx_biquad2_sos(cfg.eq, fs),
        aa_sos=_EMPTY_SOS, **_option_params(cfg, fs_dec))


def make_params(cfg: RxConfig, device=None) -> RxParams:
    """The reference-table front and post products (chain/rx.py:336-464
    of the reference), or the legacy front's (`_make_params_legacy`).
    Narrow SSB/CW: stage A is the firmware's real
    decimator lifted to the capture rate, stage B its Hilbert pair fused
    into one complex FIR g = h_i ∓ j·h_q whose real response is I±Q.
    Wide SSB: the Hilbert pair runs before the (real) decimator, which
    commutes with Re(·), so the whole front is ONE complex decimating FIR
    g ⊛ dec with real output.  AM/SAM/FM: the per-path AM lowpass is the
    decimator, on both planes (FM: decimation 1 at 48 kHz, its chain stays
    at 48 kHz), and there is no stage B.  The PreFilter and anti-alias
    lattices run as exact SOS, and the interpolator uses the firmware's
    taps."""
    check_slice(cfg)
    dev = resolve_device(device)
    if not cfg.use_ref_front:
        return _make_params_legacy(cfg, dev)
    rp = cfg.ref_path
    k = cfg.rate_mult
    am_sam = cfg.mode in ("am", "sam")
    fm = cfg.mode == "fm"
    front, front2 = _front_design(cfg)
    front = _rate_adapt_front(front, k, cfg.iq_rate)
    fs_dec = IQ_RATE if fm else cfg.fs_dec     # the FM chain runs at 48 kHz
    interp_fir = np.zeros(1, np.float64)
    if rp["interpolate"] is not None:
        h_int, _ = refdata.interpolator(rp["interpolate"], rp["decim"])
        if k > 1:
            # extra zero-stuff by k compensated by a gain-k image filter
            hb = design.lowpass_fir(32 * k - 1, 20000.0, cfg.iq_rate) * k
            h_int = np.convolve(hb, _upsample(h_int, k))
        interp_fir = h_int
    aa_sos = _EMPTY_SOS
    if rp["antialias"] is not None:
        if k != 1:
            raise ValueError(
                f"post anti-alias lattice is 48k-rate only (iq_rate="
                f"{cfg.iq_rate}, mode={cfg.mode!r}, "
                f"antialias={rp['antialias']!r})")
        aa_sos = _lattice_sos5(rp["antialias"])
    return _on_device(
        dev,
        nco_delta=nco.freq_to_delta(-cfg.translate_hz, cfg.iq_rate),
        front_fir_re=front.real, front_fir_im=front.imag,
        front2_re=None if front2 is None else front2.real,
        front2_im=None if front2 is None else front2.imag,
        audio_sos=_lattice_sos5(rp["pre"]),
        interp_fir=interp_fir,
        agc=agc_mod.make_params(fs_dec, mode=cfg.agc_mode,
                                thresh_db=cfg.agc_thresh_db,
                                remove_dc=am_sam),
        fade=am_mod.fade_leveler_params(cfg.fs_dec),
        sam=sam_mod.make_params(cfg.fs_dec),
        fm=(fm_mod.numpy_params(IQ_RATE, cfg.sql_threshold, cfg.subtone_hz)
            if fm else None),
        iq_gain=1.0, iq_phase=0.0,
        post_scale=_post_scale(cfg),
        eq1_sos=eq_mod.rx_biquad1_sos(cfg.eq, fs_dec),
        # the reference designs biquad2 at the IQ rate even where the FM
        # chain runs it on 48 kHz audio (chain/rx.py:460, :1050-1052)
        eq2_sos=eq_mod.rx_biquad2_sos(cfg.eq, cfg.iq_rate),
        aa_sos=aa_sos, **_option_params(cfg, fs_dec))


def params_from_numpy(p: Any, device=None,
                      cfg: RxConfig | None = None) -> RxParams:
    """The JAX package's RxParams (NumPy leaves) -> the port's RxParams,
    so both chains run off one set of design products.  The two-channel
    modes' (2, taps) input-rate front pair of the reference-table front is
    kept factored in the port (stage A, then two stage-B filters; see
    `_front_design`): its factors come from `cfg` through the port's own
    design copy.  The legacy ssbstereo pair stays as it is."""
    front = dict(front_fir_re=p.front_fir_re, front_fir_im=p.front_fir_im,
                 front2_re=p.front2_re, front2_im=p.front2_im)
    if np.ndim(p.front_fir_re) == 2:
        if cfg is None or not cfg.front_pair:
            raise ValueError("a (2, taps) front pair: pass the two-channel "
                             "mode's cfg")
    if np.ndim(p.front_fir_re) == 2 and cfg.stage_b_pair:
        stage_a, pair = _front_design(cfg)
        stage_a = _rate_adapt_front(stage_a, cfg.rate_mult, cfg.iq_rate)
        front = dict(front_fir_re=stage_a, front_fir_im=np.zeros(1),
                     front2_re=pair.real, front2_im=pair.imag)
    return _on_device(
        resolve_device(device), nco_delta=p.nco_delta, **front,
        audio_sos=p.audio_sos, interp_fir=p.interp_fir, agc=p.agc,
        fade=p.fade, sam=p.sam, fm=p.fm, iq_gain=p.iq_gain,
        iq_phase=p.iq_phase,
        post_scale=p.post_scale,
        eq1_sos=p.eq1_sos, eq2_sos=p.eq2_sos, aa_sos=p.aa_sos,
        nr=None if p.nr is None else nr_mod.params_from_numpy(p.nr),
        nb=None if p.nb is None else nb_mod.params_from_numpy(p.nb),
        notch=None if p.notch is None else lms.params_from_numpy(p.notch),
        leaky=None if p.leaky is None else lms.params_from_numpy(p.leaky))


def _raw_history_len(cfg: RxConfig, params: RxParams) -> int:
    """Samples of raw IQ the front carries: its taps - 1, or for the
    two-channel modes on the reference-table front the reference's
    input-rate pair's (stage A's taps - 1 + decim * (taps2 - 1), whose
    last stage-A taps - 1 feed K1)."""
    n = params.front_fir.shape[-1] - 1
    if cfg.stage_b_pair:
        n += cfg.decim * (params.front2.shape[-1] - 1)
    return n


def init_state(cfg: RxConfig, params: RxParams, batch_shape) -> RxState:
    bs = tuple(batch_shape)
    dev = params.front_fir.device
    # two-channel modes: the post chain runs per audio channel
    bs_post = bs + ((2,) if cfg.n_audio > 1 else ())

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    sub_len = -(-params.interp_fir.shape[-1] // cfg.decim)
    return RxState(
        nco_phase=zeros(bs, torch.int64),
        front_carry=fir_ops.init_carry(
            bs, _raw_history_len(cfg, params) + 1, device=dev),
        front2_carry=(None if params.front2 is None else fir_ops.init_carry(
            bs, params.front2.shape[-1], device=dev)),
        audio_sos_state=zeros((params.audio_sos.sections,) + bs_post + (2,)),
        # two-channel modes: the LINKED stereo AGC (one machine)
        agc=(agc_mod.init_state_stereo(bs, params.agc, device=dev)
             if cfg.n_audio > 1
             else agc_mod.init_state(bs, params.agc, device=dev)),
        fade=am_mod.fade_leveler_init(bs_post, device=dev),
        sam=sam_mod.init_state(bs, device=dev, n_audio=cfg.n_audio),
        fm=(None if params.fm is None
            else fm_mod.init_state(bs, params.fm, device=dev)),
        interp_carry=zeros(bs_post + (sub_len - 1,)),
        eq1=zeros((params.eq1_sos.sections,) + bs_post + (2,)),
        eq2=zeros((params.eq2_sos.sections,) + bs_post + (2,)),
        aa=zeros((params.aa_sos.sections,) + bs_post + (2,)),
        iqcorr=(iqcorr.init_state(bs, device=dev)
                if cfg.iq_auto_correction else None),
        nr=(None if params.nr is None
            else nr_mod.init_state(bs_post, device=dev)),
        nb=(None if params.nb is None
            else nb_mod.init_state(bs_post, device=dev)),
        notch=(None if params.notch is None
               else lms.init_state(bs_post, params.notch, device=dev)),
        leaky=(None if params.leaky is None
               else lms.leaky_lms_init(bs_post, params.leaky, device=dev)))


def _map_state(state, fn):
    """A copy of an RxState (the port's or the reference's) with `fn`
    applied to every array leaf, nested states rebuilt as the port's
    types; leaves that are None stay None."""
    def leaf(v):
        return None if v is None else fn(v)

    fade = am_mod.FadeLevelerState(leaf(state.fade.dc),
                                   leaf(state.fade.dc_insert))
    sam = sam_mod.SamState(
        **{f: leaf(getattr(state.sam, f))
           for f in sam_mod.SamState._fields if f != "fade"},
        fade=am_mod.FadeLevelerState(leaf(state.sam.fade.dc),
                                     leaf(state.sam.fade.dc_insert)))
    agc = agc_mod.AgcState(**{f: leaf(getattr(state.agc, f))
                              for f in agc_mod.AgcState._fields})
    fm = None if state.fm is None else fm_mod.FmState(
        **{f: leaf(getattr(state.fm, f)) for f in fm_mod.FmState._fields})
    nested = dict(agc=agc, fade=fade, sam=sam, fm=fm)
    for name, typ in (("iqcorr", iqcorr.IqCorrState),
                      ("nr", nr_mod.NrState), ("nb", nb_mod.NbState),
                      ("notch", lms.LmsState),
                      ("leaky", lms.LeakyLmsState)):
        v = getattr(state, name, None)
        nested[name] = None if v is None else typ(
            **{f: leaf(getattr(v, f)) for f in typ._fields})
    return RxState(**{f: nested[f] if f in nested
                      else leaf(getattr(state, f))
                      for f in RxState._fields})


def _stage_a_history(cfg: RxConfig, params: RxParams, raw: torch.Tensor,
                     phase: torch.Tensor, delta: int) -> torch.Tensor:
    """The last taps2 - 1 stage-A outputs of a two-channel front, rebuilt
    from its raw history (C, n) (samples -n .. -1): mixed by the NCO at
    `delta` as the reference mixes its carry (chain/rx.py:742-755) and
    filtered by stage A, the decimation phase aligned to the end of the
    history (blocks are multiples of the decimation)."""
    h = params.front_fir
    n, n_hist = raw.shape[-1], h.shape[-1] - 1
    z = raw * nco.rotor(nco.phase_ramp(phase, delta, n, start=-n))
    za, _ = fir_ops.fir_decimate_block(h, z[..., :n_hist], z[..., n_hist:],
                                       cfg.decim)
    return za.contiguous()


def state_from_numpy(s: Any, device=None,
                     cfg: RxConfig | None = None) -> RxState:
    """The JAX package's RxState (leaves given as NumPy arrays, e.g. via
    ``np.asarray``) -> the port's RxState: a stream can move from one
    chain to the other mid-sequence; uint32 leaves become int64.  The
    two-channel modes need `cfg`: the reference carries its pair's raw
    history on both planes (C, 2, n) and no stage-B history, the port
    the raw history once and the stage-A history, rebuilt here."""
    dev = resolve_device(device)

    def t(a):
        a = np.array(a)                     # a writable copy
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.as_tensor(a, device=dev).contiguous()

    state = _map_state(s, t)
    if cfg is not None and cfg.front_pair:
        raw = state.front_carry[..., 0, :].contiguous()
        state = state._replace(front_carry=raw)
        if cfg.stage_b_pair:
            params = make_params(cfg, dev)
            state = state._replace(front2_carry=_stage_a_history(
                cfg, params, raw, state.nco_phase, params.nco_delta))
    return state


_UINT32_LEAVES = ("nco_phase", "fm.tone_phase")


def leaves_to_numpy(state, uint32_leaves=()) -> dict:
    """{dotted field: NumPy array} of a state's tensor leaves, nested
    NamedTuples under dotted names (``agc.volts``); the leaves named in
    `uint32_leaves` (phases carried as int64) as uint32, the JAX
    package's dtype.  Leaves that are None are left out."""
    out = {}

    def walk(prefix, v):
        if v is None:
            return
        if isinstance(v, torch.Tensor):
            a = v.cpu().numpy()
            out[prefix] = (a.astype(np.uint32) if prefix in uint32_leaves
                           else a)
            return
        for f in v._fields:
            walk(f"{prefix}.{f}" if prefix else f, getattr(v, f))

    walk("", state)
    return out


def state_to_numpy(state: RxState, cfg: RxConfig | None = None) -> dict:
    """The port's RxState -> {field: NumPy array}, nested fields under
    dotted names (``agc.volts``, ``sam.fade.dc``) and the NCO phases as
    uint32 (the JAX package's dtype), for comparison with the
    reference's state.  A leaf that is None (no stage B, no FM state) is
    left out.  With the cfg of a two-channel mode the leaves are the
    reference's: the raw history on both planes (C, 2, n), no stage-B
    history."""
    out = leaves_to_numpy(state, _UINT32_LEAVES)
    if cfg is not None and cfg.front_pair:
        fc = out["front_carry"]
        out["front_carry"] = np.repeat(fc[..., None, :], 2, axis=-2)
        out.pop("front2_carry", None)
    return out


def _planes(iq):
    """(i, q) planes from an (i, q) tuple of int16/f32 tensors or a
    complex tensor."""
    if isinstance(iq, tuple):
        return iq
    return (iq.real.to(torch.float32).contiguous(),
            iq.imag.to(torch.float32).contiguous())


def _tune_offset_delta(offset_hz, fs: float) -> int:
    """A tune offset (Hz) -> uint32 NCO delta, in float32 on the host with
    the reference's arithmetic (chain/rx.py:603-614): the fraction of a
    turn split into two 16-bit halves, each exact in f32, so the result
    is bit-equal to the JAX chain's in-graph delta."""
    f32 = np.float32
    frac = np.mod(-f32(offset_hz) / f32(fs), f32(1.0))
    hi = np.floor(frac * f32(65536.0))
    lo = np.floor((frac * f32(65536.0) - hi) * f32(65536.0))
    return (int(hi) * 65536 + int(lo)) & nco.MASK32


def process_front(cfg: RxConfig, params: RxParams, state: RxState, iq,
                  tune_offset_hz=None):
    """IQ correction, ADC peak taps, NCO translation and the front FIR.
    Narrow SSB/CW: both stages fused in the K1 kernel, real audio at
    fs_dec out; iq/ssbstereo: K1 with two stage-B filters, (C, 2, T)
    audio out.  Wide SSB and the legacy SSB front: the complex-tap front,
    K7 when translating and K6 when not, real audio out; legacy
    ssbstereo: two such launches, (C, 2, T) audio out.  AM/SAM/FM and
    the legacy iq: the one real-tap decimating stage in the K5 kernel,
    complex decimated IQ out (FM reports no ADC peaks, as the reference's
    FM branch; the legacy FM front does not decimate).  Every mode taps
    ``spectrum_iq``, the (i, q) planes after the IQ correction.
    `tune_offset_hz` (the live retune, the reference's LO step) adds its
    delta to the translation.
    Returns (zf, new_state, taps)."""
    xi, xq = _planes(iq)
    iqc_state = state.iqcorr
    if cfg.iq_auto_correction:
        # the Moseley-Slump correction in place of the static calibration
        # (chain/rx.py:649-660 of the reference): f32 planes at full scale
        xi, xq, iqc_state = iqcorr.correct(state.iqcorr, xi, xq)
    elif not (params.iq_gain == 1.0 and params.iq_phase == 0.0):
        # non-identity calibration (audio_driver.c:2254-2316); identity
        # skips the arithmetic so int16 planes reach the kernel as they
        # are (chain/rx.py:654-660 of the reference)
        a, b = fir_kernels.scale_planes(xi, xq)
        xi = a * params.iq_gain
        xq = b + xi * params.iq_phase
    xi, xq = xi.contiguous(), xq.contiguous()
    # the scope's pre-translate tap (chain/rx.py:666 of the reference),
    # in every mode: the planes as the front reads them, int16 meaning
    # counts / 32768; no complex copy of the block is made for it
    spectrum_iq = (xi, xq)
    delta = params.nco_delta
    if tune_offset_hz is not None:
        delta = (delta + _tune_offset_delta(tune_offset_hz, cfg.iq_rate)) \
            & nco.MASK32
    translating = cfg.translate_hz != 0.0 or tune_offset_hz is not None
    nco_phase = state.nco_phase
    front2_carry = state.front2_carry
    nco_arg = (nco_phase, delta) if translating else None
    if cfg.stage_b_pair and tune_offset_hz is not None:
        # the reference mixes its pair's whole raw history with this
        # block's delta (chain/rx.py:742-755): the stage-A outputs made
        # with an earlier delta are rebuilt from the raw history
        front2_carry = _stage_a_history(cfg, params, state.front_carry,
                                        nco_phase, delta)
    if params.front2 is not None:
        # K1 rotates at any delta, 0 included; K15 under the reference's
        # own gate (pallas/fir.py:589-593): a mono front, a static delta
        mt = (params.front2.ndim == 1 and tune_offset_hz is None
              and os.environ.get("UHSDR_FRONT_MT") == "1")
        front = fir_kernels.front_mt if mt else fir_kernels.front
        zf, front_carry, front2_carry, peak = front(
            params.front_fir, params.front2, state.front_carry,
            front2_carry, xi, xq, nco_phase, delta, cfg.decim)
        translating = True
    elif params.front_fir.ndim == 2:
        # the legacy ssbstereo pair: the USB and the LSB filter on the
        # same planes, one launch each; both keep the same raw history
        out = [fir_kernels.fir_cx(h, state.front_carry, xi, xq, cfg.decim,
                                  nco=nco_arg, real_out=True)
               for h in params.front_fir]
        zf = torch.stack([o[0] for o in out], dim=-2)
        front_carry, peak = out[0][1], out[0][2]
    elif params.front_fir.is_complex():
        zf, front_carry, peak = fir_kernels.fir_cx(
            params.front_fir, state.front_carry, xi, xq, cfg.decim,
            nco=nco_arg, real_out=True)
    else:
        zf, front_carry, peak = fir_kernels.fir_rt(
            params.front_fir, state.front_carry, xi, xq, cfg.front_decim,
            nco=nco_arg)
    if translating:
        nco_phase = nco.advance(nco_phase, delta, xi.shape[-1])
    # ADC clip / signal-level detect (audio_driver.c:2660-2685)
    taps_out = {"spectrum_iq": spectrum_iq}
    if cfg.mode != "fm":
        taps_out.update(adc_peak=peak, adc_clip=peak > 0.985,
                        adc_half_clip=peak > 0.5,
                        adc_quarter_clip=peak > 0.25)
    state = state._replace(iqcorr=iqc_state, nco_phase=nco_phase,
                           front_carry=front_carry, front2_carry=front2_carry)
    return zf, state, taps_out


def stage_b(cfg: RxConfig, params: RxParams, state: RxState, zf):
    """Stage B, the Hilbert-combine FIR at fs_dec with real output.  The
    K1 kernel fuses it at every NCO delta (and updates front2_carry), so
    real audio passes through; the other fronts have no second stage and
    their output passes through too.  Complex stage-A output, a complex
    tensor or its (re, im) f32 planes, is what the sharded front gives
    (`parallel/rx_sharded.py`): it runs the reference's unfused stage B
    (chain/rx.py:939-984 there), the complex-tap front at decimation 1
    without the NCO, real out (K6, once a stage-B filter), its history
    front2_carry in K1's layout, so a state moves between the two
    fronts.  The two-channel modes' filter pair is K1's alone."""
    if params.front2 is None or not (isinstance(zf, tuple)
                                     or zf.is_complex()):
        return zf, state
    if params.front2.ndim != 1:
        raise ValueError("an unfused stage B takes one stage-B filter; "
                         "the two-channel pair runs fused in K1")
    zr, zi = zf if isinstance(zf, tuple) else (zf.real.contiguous(),
                                               zf.imag.contiguous())
    y, front2_carry, _ = fir_kernels.fir_cx(
        params.front2, state.front2_carry, zr, zi, 1, real_out=True)
    return y, state._replace(front2_carry=front2_carry)


def _demod_sos_pre_agc(cfg: RxConfig, params: RxParams, state: RxState,
                       zf, taps_out: dict):
    """Demodulation + the PreFilter cascade (the usb/lsb/cw, am and sam
    branches of the reference's `_demod_sos_pre_agc`)."""
    check_slice(cfg)
    fade_state, sam_state = state.fade, state.sam
    if cfg.mode == "am":
        audio, fade_state = am_mod.demod(zf, params.fade, state.fade,
                                         cfg.fade_leveler)
    # iq/ssbstereo (audio_driver.c:2770-2777): K1's two real outputs ARE
    # the two channels (filtered I/Q, or USB/LSB), as SSB's is its audio
    elif cfg.mode == "sam":
        audio, _, sam_state = sam_mod.demod(
            params.sam, state.sam, zf, sideband=cfg.sam_sideband,
            fade_leveler_on=cfg.fade_leveler)
    elif cfg.mode == "iq" and not cfg.front_pair:
        # the legacy iq: one symmetric lowpass, the planes split to L/R
        audio = torch.stack([zf.real, zf.imag], dim=-2)
    else:
        audio = ssb_mod.demod(zf)
    # the decimated-rate LMS stages (chain/rx.py:1019-1030 of the
    # reference): the NLMS auto-notch, then the leaky LMS (the NR
    # instance, or the notch under leaky_notch)
    notch_state, leaky_state = state.notch, state.leaky
    if params.notch is not None:
        audio, notch_state = lms.run(params.notch, state.notch, audio)
    if params.leaky is not None:
        audio, leaky_state = lms.leaky_lms_run(params.leaky, state.leaky,
                                               audio)
    audio, sos_state = iir_k.cascade_dispatch(
        params.audio_sos, state.audio_sos_state, audio)
    state = state._replace(audio_sos_state=sos_state, fade=fade_state,
                           sam=sam_state, notch=notch_state,
                           leaky=leaky_state)
    return audio, state, taps_out


def demod_pre_agc(cfg: RxConfig, params: RxParams, state: RxState, zf,
                  taps_out: dict | None = None):
    """Everything up to the AGC.  FM: the demodulator at 48 kHz and
    FM_RX_SCALING (the reference applies the AGC after the scale,
    audio_driver.c:2824-2836)."""
    taps_out = {} if taps_out is None else taps_out
    if cfg.mode == "fm":
        audio, fm_state = fm_mod.demod(params.fm, state.fm, zf)
        return audio * params.post_scale, state._replace(fm=fm_state), \
            taps_out
    zf, state = stage_b(cfg, params, state, zf)
    return _demod_sos_pre_agc(cfg, params, state, zf, taps_out)


def post_to_dec(cfg: RxConfig, params: RxParams, state: RxState, audio,
                taps_out: dict):
    """Decimated-rate post-AGC stages: the noise blanker and the spectral
    NR (on the NR input, as the reference's audio_nr.c:357-366), the
    firmware's post-AGC scaling and EQ biquad1."""
    nb_state, nr_state = state.nb, state.nr
    if params.nb is not None:
        audio, nb_state = nb_mod.process_block(params.nb, state.nb, audio)
    if params.nr is not None:
        audio, nr_state = nr_mod.process_block(params.nr, state.nr, audio)
    state = state._replace(nb=nb_state, nr=nr_state)
    audio = audio * params.post_scale
    audio, eq1_state = iir_k.cascade_dispatch(params.eq1_sos, state.eq1,
                                              audio)
    taps_out["audio_dec"] = audio
    return audio, state._replace(eq1=eq1_state), taps_out


def interp_stage(cfg: RxConfig, params: RxParams, state: RxState, audio,
                 taps_out: dict):
    """Interpolation back to the IQ rate (K4; two-channel audio as 2C
    rows), the anti-alias lattice and the treble biquad2."""
    lead, ic = audio.shape[:-1], state.interp_carry
    rows = audio.reshape(-1, audio.shape[-1]).contiguous()
    y, interp_carry = fir_kernels.interpolate(
        params.interp_fir, ic.reshape(rows.shape[0], ic.shape[-1]),
        rows, cfg.decim)
    audio48 = y.reshape(lead + y.shape[-1:])
    interp_carry = interp_carry.reshape(ic.shape)
    audio48, aa_state = iir_k.cascade_dispatch(params.aa_sos, state.aa,
                                               audio48)
    audio48, eq2_state = iir_k.cascade_dispatch(params.eq2_sos, state.eq2,
                                                audio48)
    return audio48, state._replace(interp_carry=interp_carry, aa=aa_state,
                                   eq2=eq2_state), taps_out


def post_after_agc(cfg: RxConfig, params: RxParams, state: RxState, audio,
                   taps_out: dict):
    """The post-AGC half: scaling, EQ biquad1, interpolation, anti-alias
    lattice, treble biquad2.  FM: biquad2 alone (its chain stays at
    48 kHz)."""
    if cfg.mode == "fm":
        audio, eq2_state = iir_k.cascade_dispatch(params.eq2_sos,
                                                  state.eq2, audio)
        return audio, state._replace(eq2=eq2_state), taps_out
    audio, state, taps_out = post_to_dec(cfg, params, state, audio, taps_out)
    return interp_stage(cfg, params, state, audio, taps_out)


def demod_and_post(cfg: RxConfig, params: RxParams, state: RxState, zf,
                   taps_out: dict | None = None):
    audio, state, taps_out = demod_pre_agc(cfg, params, state, zf, taps_out)
    agc_run = agc_mod.run_stereo if cfg.n_audio > 1 else agc_mod.run
    audio, agc_state = agc_run(params.agc, state.agc, audio)
    state = state._replace(agc=agc_state)
    return post_after_agc(cfg, params, state, audio, taps_out)


def process_block(cfg: RxConfig, params: RxParams, state: RxState, iq,
                  tune_offset_hz=None):
    """iq: an (i, q) tuple of (C, block) int16 or f32 planes, or a complex
    (C, block) tensor.  Returns (audio, new_state, taps): audio is (C,
    block) at the IQ rate, (C, 2, block) in the two-channel modes, or
    (C, block // front_decim) for FM (at 48 kHz on the reference-table
    front, at the capture rate on the legacy one)."""
    zf, state, taps_out = process_front(cfg, params, state, iq,
                                        tune_offset_hz)
    return demod_and_post(cfg, params, state, zf, taps_out)


class RxChain:
    """One RX chain for a static config, batched over a leading channel
    axis, on one device (CUDA unless ``device`` names another)."""

    def __init__(self, cfg: RxConfig, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = make_params(cfg, self.device)

    def init_state(self, batch_shape=()) -> RxState:
        return init_state(self.cfg, self.params, batch_shape)

    def _tensor(self, a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device).contiguous()

    def __call__(self, state: RxState, iq=None, i=None, q=None,
                 tune_offset_hz=None):
        """iq: complex (C, block) array; or i=, q=: int16 or f32 planes
        (NumPy arrays or tensors).  tune_offset_hz: an extra frequency
        shift on top of the translation (the live retune)."""
        if iq is not None:
            if not np.iscomplexobj(iq) and not (
                    isinstance(iq, torch.Tensor) and iq.is_complex()):
                raise ValueError("pass complex iq or i=/q= planes")
            i, q = np.real(iq), np.imag(iq)
            if isinstance(iq, np.ndarray):
                i, q = i.astype(np.float32), q.astype(np.float32)
        i, q = self._tensor(i), self._tensor(q)
        if i.dtype != torch.int16:
            i, q = i.to(torch.float32), q.to(torch.float32)
        return process_block(self.cfg, self.params, state, (i, q),
                             tune_offset_hz)
