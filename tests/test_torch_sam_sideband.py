"""SAM's fused sideband stage on the CPU: its plain version
(`cuda/sam.py::sam_sideband_plain`, what `demod.sam.demod` runs on CPU
tensors for the usb, lsb and stereo sidebands) against the JAX package
and against the composition it replaces.

* Against `uhsdr_tpu.demod.sam.demod`: usb, lsb and stereo, the fade
  leveler on and off, four streamed blocks (the second a ragged 1000
  samples) of 4 channels from a numpy seed, the state handed over before
  block 2 in both directions (a JAX state continued by the port, a port
  state continued by JAX), the audio, the carrier estimate and every
  state leaf held to SAM_DB, the bound tests/test_torch_sam.py holds the
  demodulator to (`-s` prints the values).
* Against the composition it replaces (`trace_sam.replaced_route`: the
  products and delays, two `cuda.iir.biquad_cascade_plain` calls on the
  stacked C0 and C1 paths, the combine, `demod.am.fade_leveler`'s blocked
  one-poles): the allpass
  chains' outputs, their states and the delays bit for bit (the stage's
  y = c*x + s1; s1 = s2; s2 = x - c*y drops the DF2T products by 0 and 1),
  the fade leveler's output and states at FADE_DB (the sequential
  one-pole against the blocked matmul form).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uhsdr_tpu.demod import am as jam
from uhsdr_tpu.demod import sam as jsam
from uhsdr_tpu_torch import trace_sam
from uhsdr_tpu_torch.cuda import iir as iir_k
from uhsdr_tpu_torch.cuda import sam as sam_k
from uhsdr_tpu_torch.demod import am as tam
from uhsdr_tpu_torch.demod import sam as tsam
from uhsdr_tpu_torch.metrics import snr_db

FS = 24000.0
SAM_DB = 75.0           # tests/test_torch_sam.py's bound
FADE_DB = 110.0
C = 4
LENGTHS = (256, 1000, 256, 256)


def _carrier(rng, T, t0, f_off=21.0, am=0.5, noise=0.01):
    t = (np.arange(T) + t0) / FS
    x = (0.8 * (1 + am * np.sin(2 * np.pi * 300 * t))
         * np.exp(1j + 2j * np.pi * f_off * t))[None] * np.ones((C, 1))
    return (x + noise * (rng.standard_normal((C, T))
                         + 1j * rng.standard_normal((C, T)))
            ).astype(np.complex64)


def _blocks(seed):
    rng = np.random.default_rng(seed)
    out, t0 = [], 0
    for T in LENGTHS:
        out.append(_carrier(rng, T, t0))
        t0 += T
    return out


def _to_torch(js) -> tsam.SamState:
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))
    return tsam.SamState(
        phs=t(js.phs), fil_out=t(js.fil_out), omega2=t(js.omega2),
        ap_state=t(js.ap_state), ds=t(js.ds),
        fade=tam.FadeLevelerState(t(js.fade.dc), t(js.fade.dc_insert)))


def _to_jax(ts) -> jsam.SamState:
    def j(a):
        return jnp.asarray(a.numpy())
    return jsam.SamState(
        phs=j(ts.phs), fil_out=j(ts.fil_out), omega2=j(ts.omega2),
        ap_state=j(ts.ap_state), ds=j(ts.ds),
        fade=jam.FadeLevelerState(j(ts.fade.dc), j(ts.fade.dc_insert)))


def _leaves(js, ts) -> dict:
    out = {}
    for f in ("fil_out", "omega2", "ap_state", "ds"):
        out[f] = snr_db(np.asarray(getattr(js, f)), getattr(ts, f))
    a = np.asarray(js.phs)
    out["phs"] = snr_db(np.stack([np.cos(a), np.sin(a)]),
                        torch.stack([ts.phs.cos(), ts.phs.sin()]))
    out["fade.dc"] = snr_db(np.asarray(js.fade.dc), ts.fade.dc)
    out["fade.dc_insert"] = snr_db(np.asarray(js.fade.dc_insert),
                                   ts.fade.dc_insert)
    return out


def _check(label, yj, yt, js, ts, extra=None):
    leaves = _leaves(js, ts)
    leaves["audio"] = snr_db(np.asarray(yj), yt)
    leaves.update(extra or {})
    low = min(leaves, key=leaves.get)
    print(f"\n{label}: audio {leaves['audio']:.1f} dB, worst {low} "
          f"{leaves[low]:.1f} dB")
    assert leaves[low] >= SAM_DB, leaves


def _n_audio(sideband):
    return 2 if sideband == "stereo" else 1


@pytest.mark.parametrize("fade", [True, False], ids=["fade", "nofade"])
@pytest.mark.parametrize("sideband", ["usb", "lsb", "stereo"])
def test_demod_matches_jax_streamed_and_handed_over(sideband, fade):
    """The port's demodulator (K10's plain loop, then the stage's plain
    version) against the JAX demodulator over four blocks, and each
    continued from the other's state over block 2."""
    jp, tp = jsam.make_params(FS), tsam.make_params(FS)
    na = _n_audio(sideband)
    js, ts = jsam.init_state((C,), n_audio=na), tsam.init_state((C,),
                                                                n_audio=na)
    blocks = _blocks(21)
    outs_j, outs_t = [], []
    for k, blk in enumerate(blocks):
        if k == 2:
            hand_j, hand_t = js, ts
        yj, oj, js = jsam.demod(jp, js, jnp.asarray(blk), sideband, fade)
        yt, ot, ts = tsam.demod(tp, ts, torch.from_numpy(blk), sideband,
                                fade)
        assert yt.shape == ((C, 2, blk.shape[-1]) if na == 2
                            else (C, blk.shape[-1]))
        outs_j.append((yj, js))
        outs_t.append((yt, ts))
        _check(f"SAM {sideband} fade={fade} block {k} ({blk.shape[-1]})",
               yj, yt, js, ts, {"omega": snr_db(np.asarray(oj), ot)})
    # a JAX state continued by the port, a port state continued by JAX,
    # over block 2
    yt, _, tj = tsam.demod(tp, _to_torch(hand_j), torch.from_numpy(blocks[2]),
                           sideband, fade)
    yj, _, jt = jsam.demod(jp, _to_jax(hand_t), jnp.asarray(blocks[2]),
                           sideband, fade)
    _check("JAX -> port, block 2", outs_j[2][0], yt, outs_j[2][1], tj)
    _check("port -> JAX, block 2", yj, outs_t[2][0], jt, outs_t[2][1])


def _bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("sideband", ["usb", "lsb", "stereo"])
def test_stage_matches_the_composition_it_replaces(sideband):
    """Bit for bit on the allpass outputs (through the fade-off audio),
    states and delays; the fade leveler at FADE_DB."""
    tp = tsam.make_params(FS)
    na = _n_audio(sideband)
    rng = np.random.default_rng(23)
    fshape = (C, na) if na == 2 else (C,)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                * 0.01)
    ap, ds, fs = f(4, 7, C, 2), f(C, 2), (f(*fshape), f(*fshape))
    cp, dp, fp = ap, ds, fs
    t0 = 0
    for T in LENGTHS:
        iq = torch.from_numpy(_carrier(rng, T, t0))
        ph = torch.from_numpy(rng.uniform(0, 2 * np.pi, (C, T))
                              .astype(np.float32))
        cos, sin = ph.cos(), ph.sin()
        t0 += T
        y0, *_ = sam_k.sam_sideband_plain(tp.ap_sos, tp.fade, ap, ds, fs,
                                          iq, cos, sin, sideband, False)
        y, ap, ds, fs = sam_k.sam_sideband_plain(tp.ap_sos, tp.fade, ap, ds,
                                                 fs, iq, cos, sin, sideband,
                                                 True)
        r0, r, cp, dp, fp = trace_sam.replaced_route(
            tp.ap_sos, tp.fade, cp, dp, fp, iq, cos, sin, sideband, True)
        assert _bits(r0, y0) and _bits(cp, ap) and _bits(dp, ds)
        vals = {"audio": snr_db(r, y), "dc": snr_db(fp[0], fs[0]),
                "dc_insert": snr_db(fp[1], fs[1])}
        print(f"\nfade leveler, sequential vs blocked, {sideband} {T}: "
              + ", ".join(f"{k} {v:.1f} dB" for k, v in vals.items()))
        assert min(vals.values()) >= FADE_DB, vals
        # continue both from the stage's fade state: the comparison is
        # per block
        fp = fs


@pytest.mark.parametrize("coeff_set", [0, 1])
def test_allpass_recurrence_is_the_df2t_cascade(coeff_set):
    """`allpass_plain` on SAM's rows [c, 0, 1, 0, c] equals
    `biquad_cascade_plain` bit for bit, streamed from a random state."""
    sos = torch.from_numpy(tsam.allpass_sos((tsam.C0, tsam.C1)[coeff_set]))
    rng = np.random.default_rng(24 + coeff_set)
    st = sp = torch.from_numpy(rng.standard_normal((7, 5, 2))
                               .astype(np.float32))
    c = sos[:, 0][:, None]
    for T in (300, 77):
        x = torch.from_numpy(rng.standard_normal((5, T)).astype(np.float32))
        y, st = sam_k.allpass_plain(c, st, x)
        yr, sp = iir_k.biquad_cascade_plain(sos, sp, x)
        assert _bits(yr, y) and _bits(sp, st)


def test_stage_refuses_other_rows_and_sidebands():
    tp = tsam.make_params(FS)
    st = tsam.init_state((C,))
    iq = torch.from_numpy(_carrier(np.random.default_rng(25), 64, 0))
    cs = torch.ones((C, 64))
    with pytest.raises(ValueError, match="sideband"):
        sam_k.sam_sideband(tp.ap_sos, tp.fade, st.ap_state, st.ds,
                           tuple(st.fade), iq, cs, cs, "both", True)
    bad = tp.ap_sos[0].clone()
    bad[2, 3] = 0.1
    with pytest.raises(ValueError, match="allpass"):
        sam_k.sam_sideband((bad, tp.ap_sos[1]), tp.fade, st.ap_state, st.ds,
                           tuple(st.fade), iq, cs, cs, "usb", True)
