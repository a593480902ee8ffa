"""Mixed-mode channel fleets: many receiver channels with per-channel
chain configs, run as per-config groups on one device — the counterpart
of `uhsdr_tpu.parallel.fleet` (BASELINE config 5, "10k mixed-mode
channels").

`ChannelFleet` groups its channels by config; each group is one
`RxChain` over its channel batch.  A block runs in one of two ways:

* `step_fused`: cross-group stage batching (`_make_stage_batched_step`):
  a stage whose parameters match across groups runs as one kernel launch
  over their concatenated channels, which pays a sequential kernel's
  latency floor once.  In particular groups whose AGC shares its time
  constants and block length run ONE K3 launch, the gain-law settings
  that differ (an operator's threshold per mode) carried as per-channel
  rows (`_merge_agc_params`);
* `step_separate`: each group's whole chain, one after another.

Both give the same output: every kernel computes each channel on its
own, so batching changes no bits.  `process_block_device` takes the
fused step at every width.  The reference takes per-group steps when
every group has 2048 channels or more (fleet.py:356 there, a v5e XLA
scheduling limit of one large jit); on an H100 the fused step was the
faster at 1024, 2048 and 4096 channels a group (PERF.md).

`WidebandFleet` is the realistic deployment: one wideband IQ stream
through the polyphase analysis bank (`ops.channelizer.AnalysisPfb`) into
a fleet of contiguous channel ranges.  `WidebandTxFleet` is its TX
mirror: per-group `TxChain`s into the synthesis bank.
`FreeDvFleetGroup` is N FreeDV channels: one K5 launch a block for their
translations and /6 decimations, then the batched NumPy modem tier.
"""
from __future__ import annotations

import copy
import types
from dataclasses import dataclass

import numpy as np
import torch

from ..chain import rx
from ..chain import tx as tx_chain
from ..chain.rx import resolve_device
from ..cuda import fir as fir_k
from ..modems import freedv as freedv_mod
from ..ops import agc as agc_mod
from ..ops import channelizer as chz
from ..ops import design, iir, nco

# The mixed-mode deployment (BASELINE config 5, the mix bench_fleet.py:50-66
# times): six groups at 48 kHz, 6 kHz translate, 16384-sample blocks, an
# operator's AGC threshold per mode, FLEET_GROUP_CHANNELS channels a
# group.  The five 12 kHz groups share their AGC time constants.
FLEET_MIX = tuple(
    rx.RxConfig(mode=m, bw_key=bw, path_name=path, agc_thresh_db=th,
                translate_hz=6000.0, block_len=16384)
    for m, bw, path, th in (("usb", "2P3KHZ", "LPF", 60.0),
                            ("lsb", "2P7KHZ", "LPF", 50.0),
                            ("cw", "500HZ", "750Hz", 70.0),
                            ("am", "2P5KHZ", "AM/SAM", 60.0),
                            ("sam", "2P3KHZ", "AM/SAM", 55.0),
                            ("fm", "5P0KHZ", "FM", 60.0)))
FLEET_GROUP_CHANNELS = 1024

# The wideband deployment (bench_wideband.py:37-50): WIDEBAND_CHANNELS
# channels of 4096 samples behind one analysis bank of 12 taps a branch,
# usb on two thirds of them and am 5P0KHZ on the rest.
WIDEBAND_MIX = (
    rx.RxConfig(mode="usb", bw_key="2P3KHZ", path_name="LPF",
                translate_hz=6000.0, block_len=4096),
    rx.RxConfig(mode="am", bw_key="5P0KHZ", path_name="AM/SAM",
                translate_hz=6000.0, block_len=4096))
WIDEBAND_CHANNELS = 4096
# Its TX mirror: WIDEBAND_CHANNELS channels of the TX flagship's mode,
# front and translate at 4096 samples.
WIDEBAND_TX = tx_chain.TxConfig(mode="usb", translate_hz=6000.0,
                                block_len=4096)


def wideband_counts(M: int = WIDEBAND_CHANNELS) -> list[int]:
    """WIDEBAND_MIX's channels: usb on 2M/3, am on the rest."""
    return [2 * M // 3, M - 2 * M // 3]


@dataclass
class _Group:
    cfg: rx.RxConfig
    chain: rx.RxChain
    state: rx.RxState
    channel_idx: np.ndarray     # global channel numbers of this group


def _agc_batch_key(params: rx.RxParams, audio: torch.Tensor) -> tuple | None:
    """Groups whose AGC runs share this key can be served by ONE kernel
    launch over their concatenated channels: the block length and every
    time constant the kernel takes as a scalar; the gain-law fields may
    differ per group, as per-channel rows.  None: the group keeps its own
    AGC (AGC off, per-channel time constants, two-channel audio)."""
    a = params.agc
    if a.agc_off or audio.ndim != 2:
        return None
    if any(np.ndim(v) > 0 for v in (a.attack_mult, a.decay_mult,
                                    a.fast_decay_mult, a.hang_decay_mult)):
        return None
    return (int(audio.shape[-1]), int(a.attack_buffsize),
            float(a.attack_mult), float(a.decay_mult),
            float(a.fast_decay_mult), float(a.hang_decay_mult),
            float(a.fast_backmult), float(a.hang_backmult),
            float(a.out_target), float(a.inv_max_input),
            int(a.hang_time_samples), bool(a.hang_enable),
            float(a.pop_ratio))


def _merge_agc_params(plist: list, sizes: list[int]) -> agc_mod.AgcParams:
    """One AgcParams over the concatenated channel axis.  Gain-law fields
    become (C_total,) rows where they differ between groups; remove_dc is
    off, the DC blocker runs per group after the merged AGC."""
    p0 = plist[0]

    def same(field):
        v0 = getattr(p0, field)
        return all(np.ndim(getattr(p, field)) == 0 and np.ndim(v0) == 0
                   and float(getattr(p, field)) == float(v0)
                   for p in plist)

    def cat(field):
        return np.concatenate([
            np.broadcast_to(np.asarray(getattr(p, field), np.float32), (n,))
            for p, n in zip(plist, sizes)])

    merged = {f: cat(f) for f in ("min_volts", "slope_constant",
                                  "hang_level", "fixed_gain")
              if not same(f)}
    return p0._replace(remove_dc=False, **merged)


def _group_by(keyfn, n: int) -> dict:
    out: dict = {}
    for k in range(n):
        out.setdefault(keyfn(k), []).append(k)
    return out


def _cat(ts, dim=0):
    return ts[0] if len(ts) == 1 else torch.cat(ts, dim=dim)


def _slices(sizes):
    offs = np.cumsum([0] + list(sizes))
    return [slice(int(offs[j]), int(offs[j + 1])) for j in range(len(sizes))]


def _host(t) -> bytes:
    return b"" if t is None else t.detach().cpu().numpy().tobytes()


def _make_stage_batched_step(chains: list):
    """The fused fleet step with cross-group stage batching (the
    reference's, fleet.py:89-295).  A stage whose parameters match across
    groups runs once over their concatenated channels:

      * the front: K1 fuses stage A (NCO, decimator) and stage B (the
        Hilbert combine), so groups concatenate only where both stages'
        taps match, as well as the translation and decimation (the
        reference batches its two stages apart; its separate stage-B
        concat has nothing left to do here);
      * the AGC: one launch per rate class, per-channel gain-law rows where
        the groups' settings differ (`_merge_agc_params`), the AM/SAM DC
        blocker per group after it; two-channel groups run their chain's
        linked `run_stereo` (the reference's fused step sends their
        (C, 2, T) audio to the mono AGC, which fails: ROADMAP section C);
      * the interpolation, with the anti-alias and treble cascades after
        it: groups with one interpolator, decimation, both cascades and
        audio layout.

    Demodulation, the PreFilter cascade and the decimated-rate post run
    per group.  Cost rule (the reference's, measured there): concatenate
    and slice only the state leaves a stage advances.

    The static keys are read once, here, from the parameters on the host.
    Returns fused(states, planes) -> (per-group audio, new states)."""
    n = len(chains)
    cfgs = [c.cfg for c in chains]
    prms = [c.params for c in chains]
    front_key = []
    for k, (c, p) in enumerate(zip(cfgs, prms)):
        front_key.append((
            _host(p.front_fir), str(p.front_fir.dtype), _host(p.front2),
            None if p.front2 is None else tuple(p.front2.shape),
            p.nco_delta, c.decim, c.mode == "fm", c.translate_hz != 0.0,
            c.front_pair, p.iq_gain, p.iq_phase,
            # an IQ-corrected group carries its own correction state and
            # runs its own front, as the reference never merges one
            # (uhsdr_tpu/parallel/fleet.py:134-136)
            k if c.iq_auto_correction else None))
    # each rate class's merged AgcParams and its device rows, made on the
    # class's first block: the parameters never change
    agc_merged: dict = {}
    interp_key = [None if c.mode == "fm" else (
        _host(p.interp_fir), c.decim, c.n_audio, p.aa_sos.sos.shape,
        _host(p.aa_sos.sos), p.eq2_sos.sos.shape, _host(p.eq2_sos.sos))
        for c, p in zip(cfgs, prms)]

    def fused(states, planes_in):
        st = list(states)

        # ---------- the front (K1, K5, K6/K7) ----------
        def akey(k):
            i, q = planes_in[k]
            return front_key[k] + (tuple(i.shape[1:]), i.dtype)

        zfs = [None] * n
        for _, idxs in _group_by(akey, n).items():
            if len(idxs) == 1:
                k = idxs[0]
                zfs[k], st[k], _ = rx.process_front(cfgs[k], prms[k], st[k],
                                                    planes_in[k])
                continue
            sizes = [planes_in[k][0].shape[0] for k in idxs]
            k0 = idxs[0]
            m = st[k0]._replace(
                nco_phase=_cat([st[k].nco_phase for k in idxs]),
                front_carry=_cat([st[k].front_carry for k in idxs]),
                front2_carry=(None if st[k0].front2_carry is None else
                              _cat([st[k].front2_carry for k in idxs])))
            gi = _cat([planes_in[k][0] for k in idxs])
            gq = _cat([planes_in[k][1] for k in idxs])
            zf, m, _ = rx.process_front(cfgs[k0], prms[k0], m, (gi, gq))
            for sl, k in zip(_slices(sizes), idxs):
                zfs[k] = zf[sl]
                st[k] = st[k]._replace(
                    nco_phase=m.nco_phase[sl], front_carry=m.front_carry[sl],
                    front2_carry=(None if m.front2_carry is None
                                  else m.front2_carry[sl]))

        # ---------- demodulation and the PreFilter (per group) ----------
        pre = [None] * n
        for k in range(n):
            if cfgs[k].mode == "fm":
                pre[k], st[k], _ = rx.demod_pre_agc(cfgs[k], prms[k], st[k],
                                                    zfs[k])
            else:
                pre[k], st[k], _ = rx._demod_sos_pre_agc(
                    cfgs[k], prms[k], st[k], zfs[k], {})

        # ---------- the AGC: one launch per rate class ----------
        post_in = [None] * n
        for key, idxs in _group_by(
                lambda k: _agc_batch_key(prms[k], pre[k]), n).items():
            if key is None or len(idxs) == 1:
                for k in idxs:
                    run = (agc_mod.run_stereo if cfgs[k].n_audio > 1
                           else agc_mod.run)
                    post_in[k], agc_g = run(prms[k].agc, st[k].agc, pre[k])
                    st[k] = st[k]._replace(agc=agc_g)
                continue
            sizes = [pre[k].shape[0] for k in idxs]
            mkey = (key, tuple(idxs), tuple(sizes))
            if mkey not in agc_merged:
                merged_p = _merge_agc_params([prms[k].agc for k in idxs],
                                             sizes)
                agc_merged[mkey] = (merged_p, agc_mod.make_setup(
                    merged_p, sum(sizes), pre[idxs[0]].device))
            merged_p, setup = agc_merged[mkey]
            merged_s = agc_mod.AgcState(*(
                torch.cat([getattr(st[k].agc, f) for k in idxs], dim=0)
                for f in agc_mod.AgcState._fields))
            y_cat, agc_cat = agc_mod.run(merged_p, merged_s,
                                         torch.cat([pre[k] for k in idxs]),
                                         setup)
            for sl, k in zip(_slices(sizes), idxs):
                agc_g = agc_mod.AgcState(*(v[sl] for v in agc_cat))
                y_g = y_cat[sl]
                if prms[k].agc.remove_dc:
                    y_g, dc_g = iir.dc_blocker_block(agc_mod.DC_BLOCKER_R,
                                                     agc_g.dc, y_g)
                    agc_g = agc_g._replace(dc=dc_g)
                st[k] = st[k]._replace(agc=agc_g)
                post_in[k] = y_g

        # ---------- decimated-rate post (per group) ----------
        dec_audio = [None] * n
        for k in range(n):
            if cfgs[k].mode != "fm":
                dec_audio[k], st[k], _ = rx.post_to_dec(cfgs[k], prms[k],
                                                        st[k], post_in[k], {})

        # ---------- interpolation and the IQ-rate post ----------
        def ikey(k):
            if interp_key[k] is None:
                return None
            return interp_key[k] + (dec_audio[k].shape[-1],)

        outs = [None] * n
        for key, idxs in _group_by(ikey, n).items():
            if key is None or len(idxs) == 1:
                for k in idxs:
                    if cfgs[k].mode == "fm":
                        outs[k], st[k], _ = rx.post_after_agc(
                            cfgs[k], prms[k], st[k], post_in[k], {})
                    else:
                        outs[k], st[k], _ = rx.interp_stage(
                            cfgs[k], prms[k], st[k], dec_audio[k], {})
                continue
            sizes = [dec_audio[k].shape[0] for k in idxs]
            k0 = idxs[0]
            # the cascades' states are (S, C, ...): channels on dim 1
            m = st[k0]._replace(
                interp_carry=_cat([st[k].interp_carry for k in idxs]),
                eq2=_cat([st[k].eq2 for k in idxs], dim=1),
                aa=_cat([st[k].aa for k in idxs], dim=1))
            a48, m, _ = rx.interp_stage(cfgs[k0], prms[k0], m,
                                        _cat([dec_audio[k] for k in idxs]),
                                        {})
            for sl, k in zip(_slices(sizes), idxs):
                st[k] = st[k]._replace(interp_carry=m.interp_carry[sl],
                                       eq2=m.eq2[:, sl], aa=m.aa[:, sl])
                outs[k] = a48[sl]
        return outs, st

    return fused


class ChannelFleet:
    """Virtual receiver channels with per-channel configs, processed as
    per-config groups on one device (CUDA unless ``device`` names
    another)."""

    def __init__(self, configs: list[rx.RxConfig], assignments: list[int],
                 device=None):
        """configs: the distinct chain configs; assignments[ch] = the
        config index of channel ch."""
        self.device = resolve_device(device)
        self.assignments = np.asarray(assignments)
        self.n_channels = len(assignments)
        self.groups: list[_Group] = []
        for gi, cfg in enumerate(configs):
            idx = np.flatnonzero(self.assignments == gi)
            if idx.size == 0:
                continue
            chain = rx.RxChain(cfg, device=self.device)
            self.groups.append(_Group(cfg=cfg, chain=chain,
                                      state=chain.init_state((idx.size,)),
                                      channel_idx=idx))
        self._fused = None

    def process_block(self, i_plane: np.ndarray, q_plane: np.ndarray):
        """i/q: (n_channels, T) f32 host planes.  Each group runs its own
        chain; returns the audio (n_channels, T) f32, gathered back into
        global channel order."""
        T = i_plane.shape[-1]
        result = np.empty((self.n_channels, T), np.float32)
        for g in self.groups:
            audio, g.state, _ = g.chain(
                g.state, i=np.ascontiguousarray(i_plane[g.channel_idx]),
                q=np.ascontiguousarray(q_plane[g.channel_idx]))
            result[g.channel_idx] = audio.cpu().numpy()
        return result

    def step_separate(self, planes: list[tuple]) -> list[torch.Tensor]:
        """Each group's whole chain, one group after another."""
        outs = []
        for g, (i_p, q_p) in zip(self.groups, planes):
            a, g.state, _ = rx.process_block(g.cfg, g.chain.params, g.state,
                                             (i_p, q_p))
            outs.append(a)
        return outs

    def step_fused(self, planes: list[tuple]) -> list[torch.Tensor]:
        """All groups in one step with cross-group stage batching."""
        if self._fused is None:
            self._fused = _make_stage_batched_step(
                [g.chain for g in self.groups])
        outs, states = self._fused([g.state for g in self.groups], planes)
        for g, s in zip(self.groups, states):
            g.state = s
        return outs

    def process_block_device(self, planes: list[tuple]) -> list[torch.Tensor]:
        """planes[k] = (i, q): group k's (group_size, T) int16 or f32
        planes on the fleet's device.  Returns the per-group audio on the
        device, nothing fetched, from `step_fused`."""
        return self.step_fused(planes)

    @property
    def group_sizes(self) -> dict[str, int]:
        return {f"{g.cfg.mode}/{g.cfg.bw_key}": g.channel_idx.size
                for g in self.groups}


class WidebandFleet:
    """ONE wideband IQ stream -> polyphase analysis bank -> mixed-mode
    fleet, all on the device.  The RF front end delivers one capture at
    fs_wide = M * fs_chan; the critically sampled bank splits it into M
    channel streams for one filter pass and one inverse DFT, and
    contiguous channel ranges feed the config groups (row slices, no
    gathers).

    configs[k] serves channels [sum(counts[:k]), sum(counts[:k+1])); sum
    (counts) = M.  Every config shares block_len = wideband_block // M."""

    def __init__(self, configs: list[rx.RxConfig], counts: list[int],
                 taps_per_branch: int = 12, device=None):
        if len(configs) != len(counts):
            raise ValueError("one count per config")
        self.device = resolve_device(device)
        M = int(sum(counts))
        self.n_channels = M
        self.bank = chz.AnalysisPfb(M, taps_per_branch=taps_per_branch,
                                    device=self.device)
        self.bank_state = self.bank.init_state()
        self.block_len = configs[0].block_len
        if any(c.block_len != self.block_len for c in configs):
            raise ValueError("uniform block_len required")
        assignments = sum(([k] * n for k, n in enumerate(counts)), [])
        self.fleet = ChannelFleet(configs, assignments, device=self.device)
        self.groups = self.fleet.groups

    @property
    def wideband_block(self) -> int:
        """Wideband samples consumed per step."""
        return self.block_len * self.n_channels

    def channel_planes(self, i_wide: torch.Tensor, q_wide: torch.Tensor):
        """The analysis bank alone: wideband planes in, each group's
        (i, q) channel planes out (the bank's state advances)."""
        y, self.bank_state = self.bank(self.bank_state,
                                       torch.complex(i_wide, q_wide))
        i_ch, q_ch = y.real.contiguous(), y.imag.contiguous()
        planes = []
        for g in self.groups:
            lo, hi = int(g.channel_idx[0]), int(g.channel_idx[-1]) + 1
            planes.append((i_ch[lo:hi], q_ch[lo:hi]))
        return planes

    def process_block_device(self, i_wide: torch.Tensor,
                             q_wide: torch.Tensor) -> list[torch.Tensor]:
        """i/q_wide: (wideband_block,) f32 planes on the device at
        fs_wide.  Returns the per-group audio on the device."""
        return self.fleet.process_block_device(
            self.channel_planes(i_wide, q_wide))

    def process_block(self, i_wide: np.ndarray, q_wide: np.ndarray):
        """Host convenience: wideband f32 planes in, (M, T) audio out."""
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)
        outs = self.process_block_device(dev(i_wide), dev(q_wide))
        return torch.cat(outs, dim=0).cpu().numpy()


class WidebandTxFleet:
    """TX mirror of `WidebandFleet`: per-group TX chains -> synthesis
    filterbank -> ONE wideband IQ stream at fs_wide = M * 48 kHz, channel
    m centred at +m * fs_wide / M (a multi-carrier exciter)."""

    def __init__(self, configs: list, counts: list[int],
                 taps_per_branch: int = 12, device=None):
        if len(configs) != len(counts):
            raise ValueError("one count per config")
        self.device = resolve_device(device)
        M = int(sum(counts))
        self.n_channels = M
        self.bank = chz.SynthesisPfb(M, taps_per_branch=taps_per_branch,
                                     device=self.device)
        self.bank_state = self.bank.init_state()
        self.block_len = configs[0].block_len
        if any(c.block_len != self.block_len for c in configs):
            raise ValueError("uniform block_len required")
        self.groups = []
        self.group_counts = []
        for cfg, n in zip(configs, counts):
            if n == 0:
                continue
            chain = tx_chain.TxChain(cfg, device=self.device)
            self.groups.append((chain, chain.init_state((n,))))
            self.group_counts.append(n)

    def chain_iq(self, audio_groups: list):
        """The TX chains alone: audio_groups is a LIST of per-group
        (counts[k], T) f32 audio tensors on the device.  Returns the
        channels' (i, q), each (M, T), in channel order (the chains'
        states advance)."""
        if not isinstance(audio_groups, (list, tuple)) \
                or len(audio_groups) != len(self.groups):
            raise ValueError("one (count, T) audio tensor per group")
        i_parts, q_parts, new_groups = [], [], []
        for (chain, state), audio, n in zip(self.groups, audio_groups,
                                            self.group_counts):
            if tuple(audio.shape) != (n, self.block_len):
                raise ValueError(f"audio {tuple(audio.shape)}, expected "
                                 f"{(n, self.block_len)}")
            gi, gq, state = chain(state, audio)
            new_groups.append((chain, state))
            i_parts.append(gi)
            q_parts.append(gq)
        self.groups = new_groups
        return _cat(i_parts), _cat(q_parts)

    def synthesize(self, i_ch: torch.Tensor, q_ch: torch.Tensor):
        """The synthesis bank alone: (M, T) channel planes in, (i_wide,
        q_wide) f32 of length T * M out (the bank's state advances)."""
        x, self.bank_state = self.bank(self.bank_state,
                                       torch.complex(i_ch, q_ch))
        return x.real.contiguous(), x.imag.contiguous()

    def process_block_device(self, audio_groups: list):
        """audio_groups: a LIST of per-group (counts[k], T) f32 audio
        tensors on the device.  Returns (i_wide, q_wide), f32 of length
        T * M."""
        return self.synthesize(*self.chain_iq(audio_groups))


def modem_state(obj):
    """A modem tier's state as plain values: each object a dict of its
    attributes under "__class__" (its class's name), modules left out,
    arrays and lists copied.  The JAX package's modem tier is the same
    NumPy code, so this reads its objects as well as the port's."""
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(modem_state(v) for v in obj)
    if isinstance(obj, dict):
        return {k: modem_state(v) for k, v in obj.items()}
    if hasattr(obj, "__dict__"):
        return {"__class__": type(obj).__name__,
                **{k: modem_state(v) for k, v in vars(obj).items()
                   if not isinstance(v, types.ModuleType)}}
    return copy.deepcopy(obj)


def _is_object(tree) -> bool:
    return isinstance(tree, dict) and "__class__" in tree


def load_modem_state(obj, tree: dict):
    """Set a modem tier object's state from `modem_state`'s tree of an
    object of the same class (of either package): its objects, and lists
    of them, are loaded in place, every other attribute is copied."""
    if tree["__class__"] != type(obj).__name__:
        raise ValueError(f"state of a {tree['__class__']}, not of a "
                         f"{type(obj).__name__}")
    for k, v in tree.items():
        if k == "__class__":
            continue
        cur = getattr(obj, k, None)
        if _is_object(v):
            load_modem_state(cur, v)
        elif isinstance(v, list) and v and all(_is_object(e) for e in v):
            if len(cur) != len(v):
                raise ValueError(f"{k}: {len(v)} objects, not {len(cur)}")
            for c, e in zip(cur, v):
                load_modem_state(c, e)
        else:
            setattr(obj, k, modem_state(v))


class FreeDvFleetGroup:
    """N FreeDV channels as ONE fleet group (the north-star scaling of
    the reference's single FreeDV path, `freedv_uhsdr.c:166-320`); the
    counterpart of the JAX package's `parallel.fleet.FreeDvFleetGroup`.

    Two tiers, mirroring the firmware's IRQ/PendSV split:
      * radio-front tier: every channel's NCO translation (its own
        increment) and the 48k->8k /6 decimation in ONE K5 launch a block
        (`cuda/fir.py::fir_rt` with a (C,) tensor of increments, planes
        out), the phases and the raw history carried on `device`;
      * modem tier: the batched host NumPy of `modems/fdmdv_batch.py`
        (`FreeDv1600Fleet` or `FreeDv700DFleet`), as the JAX package's.

    `state_to_numpy` / `state_from_numpy` carry the state to and from the
    JAX group's layout (`phases` uint32, the post-mix `ci` / `cq` (C, 71)
    f32 and `modem`, `modem_state`'s tree of the modem tier).
    """

    def __init__(self, n_channels: int, mode: str = "freedv1600",
                 block_len_48k: int = 7680,
                 translate_hz: float | np.ndarray = 0.0, device=None):
        from ..modems import fdmdv_batch

        if block_len_48k % freedv_mod.RATIO:
            raise ValueError(f"block {block_len_48k} is not a multiple of "
                             f"{freedv_mod.RATIO}")
        self.device = dev = resolve_device(device)
        self.n_channels = n_channels
        self.block_len = block_len_48k
        self.mode = mode
        self._fleet_modem = (fdmdv_batch.FreeDv1600Fleet(n_channels)
                             if mode == "freedv1600"
                             else fdmdv_batch.FreeDv700DFleet(n_channels))
        self._h_dec = torch.as_tensor(design.decimation_fir(
            72, freedv_mod.RATIO, freedv_mod.IQ_RATE).astype(np.float32),
            device=dev)
        deltas = np.asarray([nco.freq_to_delta(-f, freedv_mod.IQ_RATE)
                             for f in np.broadcast_to(translate_hz,
                                                      (n_channels,))],
                            np.uint32)
        self._deltas = torch.as_tensor(deltas.astype(np.int64), device=dev)
        self._phases = torch.zeros((n_channels,), dtype=torch.int64,
                                   device=dev)
        # the raw pre-mix history of the decimator
        self._carry = torch.zeros((n_channels, 71), dtype=torch.complex64,
                                  device=dev)

    def front_device(self, i_plane, q_plane):
        """Device tier: (C, T) f32 48k planes -> the (C, T/6) f32 planes
        (i, q) of the 8 kHz baseband on the device, one K5 launch."""
        xi = torch.as_tensor(i_plane, dtype=torch.float32,
                             device=self.device).contiguous()
        xq = torch.as_tensor(q_plane, dtype=torch.float32,
                             device=self.device).contiguous()
        (i_d, q_d), self._carry, _ = fir_k.fir_rt(
            self._h_dec, self._carry, xi, xq, freedv_mod.RATIO,
            nco=(self._phases, self._deltas), planes_out=True)
        self._phases = nco.advance(self._phases, self._deltas, xi.shape[-1])
        return i_d, q_d

    def front_block(self, i_plane, q_plane) -> np.ndarray:
        """Device tier only: (C, T) 48k planes -> (C, T/6) complex 8 kHz
        baseband on the host, built as the JAX group builds it."""
        i_d, q_d = self.front_device(i_plane, q_plane)
        return i_d.cpu().numpy() + 1j * q_d.cpu().numpy()

    def process_block(self, i_plane, q_plane) -> list[np.ndarray]:
        """Full step: device front + batched modem tier.  Returns the
        per-channel decoded speech (int16-scale f32 @8k, possibly empty
        while the modem buffers)."""
        return self._fleet_modem.demod(self.front_block(i_plane, q_plane))

    def _history_rotor(self) -> torch.Tensor:
        """rotor of the NCO phases of the history's samples -71..-1."""
        n = self._carry.shape[-1]
        return nco.rotor(nco.phase_ramp(self._phases, self._deltas, n,
                                        start=-n))

    def state_to_numpy(self) -> dict:
        """The state in the JAX group's layout: `phases` (C,) uint32,
        `ci` / `cq` the post-mix history's planes (C, 71) f32, `modem`
        (`modem_state` of the modem tier)."""
        post = self._carry * self._history_rotor()
        return {"phases": self._phases.cpu().numpy().astype(np.uint32),
                "ci": post.real.cpu().numpy(), "cq": post.imag.cpu().numpy(),
                "modem": modem_state(self._fleet_modem)}

    def state_from_numpy(self, s: dict):
        """Take a state in the JAX group's layout (`state_to_numpy`)."""
        self._phases = torch.as_tensor(
            np.asarray(s["phases"]).astype(np.int64), device=self.device)
        post = torch.complex(
            torch.as_tensor(np.array(s["ci"], np.float32),
                            device=self.device),
            torch.as_tensor(np.array(s["cq"], np.float32),
                            device=self.device))
        self._carry = (post * self._history_rotor().conj()).contiguous()
        load_modem_state(self._fleet_modem, s["modem"])

    @property
    def stats(self) -> dict:
        return self._fleet_modem.stats
