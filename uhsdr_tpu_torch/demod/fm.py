"""FM demodulation: differential discriminator, de-emphasis, squelch,
subaudible-tone detection.

The torch counterpart of `uhsdr_tpu.demod.fm`.  Reference:
`AudioDriver_DemodFM` (`audio_driver.c:1544-1737`), constants
`:1490-1513` (LPF alpha 0.05, HPF alpha 0.96, squelch smoothing 0.005,
hysteresis 3, subtone ratio threshold 1.75, debounce 2/5, Goertzel window
400 blocks of 32 samples).

The discriminator ``atan2(I'Q - IQ', I'I + QQ')`` is K12
(`cuda.elemwise.fm_disc`) with a one-sample carry.  De-emphasis and HPF
are one-pole recurrences (`ops.iir.one_pole_block`).  The squelch noise
estimate (its 2-section HPF on K2, `cuda.iir.cascade_dispatch`) samples
the HPF'd discriminator every 32 samples (the
reference's 1500 Hz block cadence) and runs its hysteresis at that
cadence, here without a loop over sub-blocks (`_squelch_scan`).  Subtone
detection projects the de-emphasised audio onto 3 bins (on, below, above
the tone) per accumulation window and applies the ratio/debounce logic.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cuda import elemwise
from ..cuda import iir as iir_k
from ..ops import iir, nco

LPF_ALPHA = 0.05       # de-emphasis (reference FM_RX_LPF_ALPHA)
HPF_ALPHA = 0.96       # audio HPF (FM_RX_HPF_ALPHA)
SQL_SMOOTHING = 0.005  # squelch one-pole (FM_RX_SQL_SMOOTHING)
SQL_HYSTERESIS = 3
SQL_PROC_DECIM = 200   # hysteresis evaluated every 200 sub-blocks
SUBBLOCK = 32          # reference IQ_BLOCK_SIZE cadence for squelch sampling
TONE_DET_ALPHA = 0.9
TONE_THRESHOLD = 1.75
TONE_DEBOUNCE_MAX = 5
TONE_DEBOUNCE_THRESH = 2
GOERTZEL_WINDOW_SAMPLES = 400 * 32   # 400 blocks of 32 @48k
SQL_CAP = 0.175


class FmParams(NamedTuple):
    fs: float
    sql_threshold: int            # 0..24, 0 = squelch off
    subtone_hz: float             # 0 = detection off
    squelch_sos: iir.Cascade      # HPF for the noise estimate
    deltas: torch.Tensor | None   # (3,) int64 NCO deltas [ctr, low, high]


def params_from_numpy(p, device=None) -> FmParams:
    """FmParams on `device` from the reference's FmParams fields (fs,
    sql_threshold, subtone_hz, (S, 5) squelch_sos, (3,) uint32 deltas or
    None)."""
    dev = torch.device(device)
    deltas = None
    if p.deltas is not None:
        deltas = torch.as_tensor(np.asarray(p.deltas).astype(np.int64),
                                 device=dev)
    return FmParams(fs=float(p.fs), sql_threshold=int(p.sql_threshold),
                    subtone_hz=float(p.subtone_hz),
                    squelch_sos=iir.cascade(p.squelch_sos, dev),
                    deltas=deltas)


def numpy_params(fs: float = 48000.0, sql_threshold: int = 0,
                 subtone_hz: float = 0.0) -> FmParams:
    """The design products with NumPy leaves (the reference's FmParams:
    (S, 5) f32 squelch SOS, (3,) uint32 deltas or None)."""
    # noise HPF above the voice band (the reference's IIR_Squelch_HPF
    # lattice): a 4th-order Butterworth at 5.4 kHz
    from scipy import signal as sps
    z, p, k = sps.butter(4, 5400 / (fs / 2), btype="high", output="zpk")
    sos = sps.zpk2sos(z, p, k)              # a0 = 1: drop that column
    deltas = None
    if subtone_hz > 0:
        # differential detection: above/below = ±5% like the reference's
        # UiCalcSubaudibleDetFreq high/low offsets
        freqs = np.array([subtone_hz, subtone_hz * 0.95, subtone_hz * 1.05])
        deltas = np.stack([nco.freq_to_delta(float(f), fs) for f in freqs])
    return FmParams(fs, sql_threshold, subtone_hz,
                    np.concatenate([sos[:, :3], sos[:, 4:]],
                                   axis=1).astype(np.float32), deltas)


def make_params(fs: float = 48000.0, sql_threshold: int = 0,
                subtone_hz: float = 0.0, device=None) -> FmParams:
    return params_from_numpy(numpy_params(fs, sql_threshold, subtone_hz),
                             device)


class FmState(NamedTuple):
    z_prev: torch.Tensor          # (C,) complex64 previous IQ sample
    lpf: torch.Tensor             # (C,) de-emphasis state
    hpf_a: torch.Tensor           # (C,)
    hpf_b: torch.Tensor           # (C,)
    sql_sos_state: torch.Tensor   # (S, C, 2)
    sql_avg: torch.Tensor         # (C,)
    sql_count: torch.Tensor       # (C,) float sub-block counter
    squelched: torch.Tensor       # (C,) bool
    tone_acc: torch.Tensor        # (C, 3) complex64 [ctr, low, high]
    tone_phase: torch.Tensor      # (C, 3) int64 NCO phases in [0, 2^32)
    tone_nsamp: torch.Tensor      # (C,) int32 samples accumulated
    subdet: torch.Tensor          # (C,) smoothed ratio
    tdet: torch.Tensor            # (C,) int32 debounce counter
    tone_detected: torch.Tensor   # (C,) bool


def init_state(batch_shape, params: FmParams, device=None) -> FmState:
    bs = tuple(batch_shape)

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return FmState(
        z_prev=zeros(bs, torch.complex64), lpf=zeros(bs), hpf_a=zeros(bs),
        hpf_b=zeros(bs),
        sql_sos_state=zeros((params.squelch_sos.sections,) + bs + (2,)),
        sql_avg=zeros(bs), sql_count=zeros(bs),
        squelched=zeros(bs, torch.bool),
        tone_acc=zeros(bs + (3,), torch.complex64),
        tone_phase=zeros(bs + (3,), torch.int64),
        tone_nsamp=zeros(bs, torch.int32), subdet=zeros(bs),
        tdet=zeros(bs, torch.int32),
        tone_detected=torch.ones(bs, dtype=torch.bool, device=device))


def _decide(thr: int, capped, squelched):
    """The hysteresis decision at an evaluation (audio_driver.c:1596-1661):
    the squelch state after it, from the capped average."""
    if thr == 0:
        return torch.zeros_like(squelched)
    scaled = 22.0 - torch.clamp(capped * 172.0, max=24.0)
    open_cond = scaled >= (thr + SQL_HYSTERESIS)
    close_cond = scaled < (thr - SQL_HYSTERESIS if thr > SQL_HYSTERESIS
                           else thr)
    return torch.where(squelched, ~open_cond, close_cond)


def _squelch_scan(params: FmParams, state: FmState, noise: torch.Tensor):
    """Hysteresis squelch at the sub-block cadence (audio_driver.c:
    1596-1661).  noise: (C, n) = sqrt(|HPF'd discriminator|) at sub-block
    starts.  Returns (sql_avg, count, squelched, squelched after each
    sub-block (C, n)).

    The reference's scan (demod/fm.py:101-137 of the JAX package) steps
    avg = (1-s)·avg + s·ns and a float counter; when the counter reaches
    SQL_PROC_DECIM it caps avg at 0.175, evaluates the hysteresis and
    resets.  Between two evaluations avg is the linear one-pole, so this
    splits the sub-blocks at the evaluations (per channel, from the
    carried counter: no host sync) and runs each segment as one batched
    `one_pole_block` from zero state plus the carried value's decay:
    segment s covers the sub-blocks after evaluation s up to and including
    evaluation s+1, and its average is L_s[i] + start_s·a^(i - p_s), with
    start_s the capped value of evaluation s at sub-block p_s (the carried
    average at p_0 = -1 for the first).  A block of n sub-blocks holds at
    most floor((n-1)/200) + 1 evaluations, so the loop runs over at most
    that many + 1 segments, each a few (C,)-sized operations.  The powers
    of a are float64 rounded once where the reference's f32 recurrence
    rounds at each step, so the two averages differ by a few ulp; a
    decision can flip only where 22 - min(172·capped, 24) lands within
    that of an integer threshold."""
    thr = params.sql_threshold
    C, n = noise.shape
    dev = noise.device
    a, b = 1.0 - SQL_SMOOTHING, SQL_SMOOTHING
    i = torch.arange(n, device=dev, dtype=torch.float32)
    # k = i - (first evaluation's index): evaluations where k % 200 == 0
    k = i + (state.sql_count[:, None] + 1.0 - SQL_PROC_DECIM)
    is_eval = (k >= 0) & (torch.remainder(k, SQL_PROC_DECIM) == 0)
    # segment of a sub-block = evaluations strictly before it
    seg = torch.where(k > 0, torch.floor((k - 1) / SQL_PROC_DECIM) + 1,
                      torch.zeros_like(k)).to(torch.int64)
    n_seg = (n - 1) // SQL_PROC_DECIM + 2
    masks = torch.stack([seg == s for s in range(n_seg)])      # (S, C, n)
    lin, _ = iir.one_pole_block(a, b, torch.zeros((n_seg, C), device=dev),
                                noise[None] * masks)
    powers = torch.cat([torch.ones(1, device=dev),
                        iir.decay_table(a, n + 1, str(dev))])  # a^0..a^n+1
    start, p = state.sql_avg, torch.full((C,), -1.0, device=dev)
    sq = state.squelched
    avg_end = torch.zeros_like(start)
    sq_states = [sq]
    for s in range(n_seg):
        steps = (i[None, :] - p[:, None]).clamp(min=0).to(torch.int64)
        avg_s = lin[s] + start[:, None] * powers[steps]        # (C, n)
        in_seg = masks[s]
        # the average after the last sub-block, where it ends this segment
        avg_end = torch.where(in_seg[:, -1], avg_s[:, -1], avg_end)
        ev = is_eval & in_seg                                  # (C, n)
        has_ev = ev.any(-1)
        v = torch.where(ev, avg_s, torch.zeros_like(avg_s)).sum(-1)
        capped = torch.clamp(v, max=SQL_CAP)
        sq = torch.where(has_ev, _decide(thr, capped, sq), sq)
        sq_states.append(sq)
        avg_end = torch.where(has_ev & ev[:, -1], capped, avg_end)
        start = torch.where(has_ev, capped, start)
        p = torch.where(has_ev, ev.float().argmax(-1).float(), p)
    # squelch state after sub-block i: the state after the evaluations at
    # or before it
    after = (seg + is_eval.long()).clamp(max=n_seg)
    sq_seq = torch.gather(torch.stack(sq_states, -1), 1, after)
    n_ev = is_eval.sum(-1).to(torch.float32)
    count = state.sql_count + n - SQL_PROC_DECIM * n_ev
    return avg_end, count, sq, sq_seq


def demod(params: FmParams, state: FmState, iq: torch.Tensor):
    """iq (C, T) complex64 at 48 kHz -> (audio (C, T), new_state)."""
    T = iq.shape[-1]
    iq = iq.contiguous()
    angle = elemwise.fm_disc(state.z_prev, iq)                # K12

    # de-emphasis LPF a[n] = a[n-1] + alpha*(angle - a[n-1]) followed by
    # HPF b[n] = alpha*(b[n-1] + a[n] - a[n-1]): two one-poles
    al, ah = LPF_ALPHA, HPF_ALPHA
    deemph, lpf_last = iir.one_pole_block(1.0 - al, al, state.lpf, angle)
    a_d = torch.cat([state.hpf_a[..., None], deemph[..., :-1]], dim=-1)
    audio, hpf_last = iir.one_pole_block(ah, ah, state.hpf_b, deemph - a_d)

    # --- squelch noise estimate ---
    sq, sos_state = iir_k.cascade_dispatch(
        params.squelch_sos, state.sql_sos_state, angle)
    n_sub = T // SUBBLOCK
    noise = torch.sqrt(torch.abs(sq[..., : n_sub * SUBBLOCK: SUBBLOCK]))
    sql_avg, count, squelched, sq_seq = _squelch_scan(params, state, noise)
    # the gate at sample rate (sub-block granularity), the last sub-block's
    # state held over a ragged tail
    gate = torch.repeat_interleave(~sq_seq, SUBBLOCK, dim=-1)
    if gate.shape[-1] < T:
        gate = torch.cat([gate, gate[..., -1:].expand(
            gate.shape[:-1] + (T - gate.shape[-1],))], dim=-1)

    # --- subaudible tone detection ---
    tone_acc, tone_phase = state.tone_acc, state.tone_phase
    tone_nsamp, subdet = state.tone_nsamp, state.subdet
    tdet, tone_detected = state.tdet, state.tone_detected
    if params.deltas is not None:
        # sum_t deemph[t] e^{-j(p0 + delta t)} = e^{-j p0} · (deemph @
        # e^{-j delta t}): one (C, T) @ (T, 3) product per plane
        ramp = nco.rotor(nco.phase_ramp(torch.zeros(3, dtype=torch.int64,
                                                    device=iq.device),
                                        params.deltas, T))    # (3, T)
        iir.need_fp32_matmul(deemph, "the subtone projection")
        proj = torch.complex(deemph @ ramp.real.mT, -(deemph @ ramp.imag.mT))
        proj = proj * nco.rotor(tone_phase).conj()
        tone_acc = tone_acc + proj
        tone_phase = nco.advance(tone_phase, params.deltas, T)
        tone_nsamp = tone_nsamp + T
        done = tone_nsamp >= GOERTZEL_WINDOW_SAMPLES
        e = tone_acc.abs().square()                           # (C, 3)
        ratio = e[..., 0] / torch.clamp((e[..., 1] + e[..., 2]) / 2.0,
                                        min=1e-12)
        subdet_new = (1 - TONE_DET_ALPHA) * subdet + TONE_DET_ALPHA * ratio
        subdet = torch.where(done, subdet_new, subdet)
        tdet_new = torch.where(subdet > TONE_THRESHOLD,
                               torch.clamp(tdet + 1, max=TONE_DEBOUNCE_MAX),
                               torch.clamp(tdet - 1, min=0))
        tdet = torch.where(done, tdet_new, tdet)
        tone_detected = torch.where(done, tdet >= TONE_DEBOUNCE_THRESH,
                                    tone_detected)
        tone_acc = torch.where(done[..., None], torch.zeros_like(tone_acc),
                               tone_acc)
        tone_nsamp = torch.where(done, torch.zeros_like(tone_nsamp),
                                 tone_nsamp)

    audio = torch.where(gate & tone_detected[..., None], audio,
                        torch.zeros_like(audio))
    new_state = FmState(
        z_prev=iq[..., -1].contiguous(), lpf=lpf_last,
        hpf_a=deemph[..., -1].contiguous(), hpf_b=hpf_last,
        sql_sos_state=sos_state, sql_avg=sql_avg, sql_count=count,
        squelched=squelched, tone_acc=tone_acc, tone_phase=tone_phase,
        tone_nsamp=tone_nsamp, subdet=subdet, tdet=tdet,
        tone_detected=tone_detected)
    return audio, new_state
