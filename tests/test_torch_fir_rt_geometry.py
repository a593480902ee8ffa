"""K5's tile geometry (`cuda/fir.py::fir_rt_geometry`, the rule the
`kernels/front.cu` launcher applies to its stage-A-only instance) over
every shape the port sends K5.

The rule is pure Python, so it is checked here on the CPU: every AM, SAM
and FM row at 48, 96 and 192 kHz (decimation 1 to 16), on int16 and f32
planes, fits the shared memory with at least three blocks an SM, and a
shape past the buffers is refused with a ValueError before any launch.
The card checks that the library computes the same shared memory
(chip_smoke.py's K5 phase).
"""
from __future__ import annotations

import pytest
import torch

from uhsdr_tpu_torch.chain import filterpaths, rx
from uhsdr_tpu_torch.cuda import fir as fir_k

# an H100 SM's shared memory (228 KB), what each resident block reserves
# besides its own (1 KB), and the blocks of 4 warps K5 aims to keep
# resident on an SM
SM_SMEM = 228 * 1024
BLOCK_RESERVED = 1024
BLOCKS_AIM = 3


def _k5_shapes(rate: float) -> set:
    """{(taps, decim)} of every configuration whose front is K5 at
    `rate`."""
    shapes = set()
    for mode in ("am", "sam", "fm"):
        for p in filterpaths.paths_for_mode(mode):
            cfg = rx.RxConfig(mode=mode, bw_key=p.bw_key, path_name=p.name,
                              iq_rate=rate)
            try:
                rx.check_slice(cfg)
                stage_a, g = rx._front_design(cfg)
            except (NotImplementedError, KeyError):
                continue
            assert g is None and stage_a.dtype.kind == "f"   # real taps
            taps = rx._rate_adapt_front(stage_a, cfg.rate_mult,
                                        rate).shape[-1]
            shapes.add((taps, cfg.decim))
    return shapes


@pytest.mark.parametrize("rate,decims", [(48000.0, {1, 2, 4}),
                                         (96000.0, {2, 4, 8}),
                                         (192000.0, {4, 8, 16})])
def test_every_k5_shape_fits(rate, decims):
    shapes = _k5_shapes(rate)
    assert {d for _, d in shapes} == decims
    R = fir_k.FRONT_R
    for taps, decim in shapes:
        for size in (2, 4):
            geo = fir_k.fir_rt_geometry(taps, decim, size)
            # no stage-B buffers; three blocks of 4 warps share an SM
            assert geo.ze == 0 and geo.pb == 0
            assert geo.smem <= fir_k.FIR_RT_SMEM_AIM
            assert (BLOCKS_AIM * (geo.smem + BLOCK_RESERVED)
                    <= SM_SMEM)
            # whole chunks of R; the halo shorter than a tile, so its
            # copy never overlaps its source
            assert geo.t_tile % R == 0 and geo.e % R == 0
            assert geo.ap % R == 0 and geo.e >= -(-taps // decim)
            assert geo.t_tile > geo.e
            # the rows are split so that no thread takes a second item
            # where the block has threads to spare
            assert 1 <= geo.p <= decim
            assert geo.p == 1 or geo.p * (geo.t_tile // R) \
                <= fir_k.FRONT_THREADS


@pytest.mark.parametrize("cfg,want", [
    (rx.SAM_FLAGSHIP, (1024, 1, 64)),           # 239 taps, decim 4
    (rx.FM_FLAGSHIP, (2048, 1, 120)),           # 239 taps, decim 2
    (rx.RxConfig(mode="am", bw_key="2P3KHZ", path_name="AM/SAM",
                 iq_rate=192000.0), (256, 4, 32))])   # 479 taps, decim 16
def test_flagship_geometry(cfg, want):
    """The AM/SAM and FM flagships' tiles (int16): 4096 samples a plane
    and one row group, so each thread writes its outputs straight out;
    192 kHz narrow AM at decimation 16: the rows in four groups."""
    p = rx.make_params(cfg, "cpu")
    geo = fir_k.fir_rt_geometry(p.front_fir.shape[-1], cfg.decim, 2)
    assert (geo.t_tile, geo.p, geo.e) == want


@pytest.mark.parametrize("taps,decim,size", [
    (20000, 4, 2),          # polyphase rows past the buffers
    (60000, 16, 4),
    (239, 0, 2),            # no decimation
    (239, 4, 8)])           # 8-byte samples
def test_shapes_past_the_buffers_are_refused(taps, decim, size):
    with pytest.raises(ValueError):
        fir_k.fir_rt_geometry(taps, decim, size)


def test_wrapper_refuses_before_any_launch():
    """`fir_rt` on tensors off the CPU checks the geometry before it
    loads or launches anything: meta tensors stand in for the card's."""
    C, B, taps = 2, 64, 20000
    meta = dict(device="meta")
    h = torch.empty(taps, **meta)
    carry = torch.empty((C, taps - 1), dtype=torch.complex64, **meta)
    x = torch.empty((C, B), dtype=torch.int16, **meta)
    with pytest.raises(ValueError, match="shared memory"):
        fir_k.fir_rt(h, carry, x, x, 4)
    with pytest.raises(ValueError, match="decimation"):
        fir_k.fir_rt(h[:89], carry[:, :88], x, x, 0)
