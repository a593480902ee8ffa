"""K1's tile geometry (`cuda/fir.py::front_geometry`, the rule the
`kernels/front.cu` launcher applies) over every shape the port sends K1,
and K15's (`front_mt_geometry`: K1's with complex stage-A taps) over
every mono one.

The rule is pure Python, so it is checked here on the CPU: every narrow
SSB/CW row (usb, lsb, cw) and the two-channel modes (iq, ssbstereo) at 48,
96 and 192 kHz, on int16 and f32 planes, fits the shared memory, and a
shape past the buffers is refused with a ValueError before any launch.
The card checks that the library computes the same shared memory
(chip_smoke.py's K1 and K15 phases, tests/test_torch_cuda.py).
"""
from __future__ import annotations

import pytest

from uhsdr_tpu_torch.chain import filterpaths, rx
from uhsdr_tpu_torch.cuda import fir as fir_k


def _k1_shapes(rate: float) -> set:
    """{(taps, taps2, decim, nb, n_keep)} of every configuration whose
    front is K1 at `rate`."""
    shapes = set()
    for mode in ("usb", "lsb", "cw", "iq", "ssbstereo"):
        for p in filterpaths.paths_for_mode("usb" if mode == "iq" else mode):
            cfg = rx.RxConfig(mode=mode, bw_key=p.bw_key, path_name=p.name,
                              iq_rate=rate)
            try:
                rx.check_slice(cfg)
                stage_a, g = rx._front_design(cfg)
            except (NotImplementedError, KeyError):
                continue
            if g is None:                   # wide SSB: K6/K7, not K1
                continue
            taps = rx._rate_adapt_front(stage_a, cfg.rate_mult,
                                        rate).shape[-1]
            n_keep = taps - 1
            if cfg.front_pair:
                n_keep += cfg.decim * (g.shape[-1] - 1)
            shapes.add((taps, g.shape[-1], cfg.decim, g.ndim, n_keep))
    return shapes


@pytest.mark.parametrize("rate", [48000.0, 96000.0, 192000.0])
def test_every_k1_shape_fits(rate):
    shapes = _k1_shapes(rate)
    assert {nb for *_, nb, _ in shapes} == {1, 2}
    R = fir_k.FRONT_R
    for taps, taps2, decim, nb, n_keep in shapes:
        for size in (2, 4):
            geo = fir_k.front_geometry(taps, taps2, decim, nb, size, n_keep)
            assert geo.smem <= fir_k.FRONT_SMEM_MAX
            # whole chunks of R; halos shorter than a tile, so a halo
            # copy never overlaps its source
            assert geo.t_tile % R == 0 and geo.e % R == 0
            assert geo.ze % R == 0 and geo.ap % R == 0
            assert geo.e >= -(-taps // decim) and geo.ze >= taps2
            assert geo.t_tile > geo.e and geo.t_tile >= taps2 - 1
            # the rows and the stage-B taps are split so that no thread
            # takes a second item where the block has threads to spare
            assert 1 <= geo.p <= decim and 1 <= geo.pb
            items = geo.t_tile // R
            assert geo.p == 1 or geo.p * items <= fir_k.FRONT_THREADS
            assert geo.pb == 1 or geo.pb * items <= fir_k.FRONT_THREADS
            if nb == 1:
                # K15: K1's tiles, the stage-A taps two floats each
                mt = fir_k.front_mt_geometry(taps, taps2, decim, size,
                                             n_keep)
                assert mt.smem <= fir_k.FRONT_SMEM_MAX
                assert mt._replace(smem=geo.smem) == geo
                rows = decim * geo.ap
                assert mt.smem - geo.smem == 4 * (-(-2 * rows // 4) * 4
                                                  - -(-rows // 4) * 4)


def test_flagship_geometry():
    """The SSB flagship's tiles: 512 outputs (4096 int16 samples), the
    polyphase rows in two groups, the stage-B taps in two."""
    p = rx.make_params(rx.FLAGSHIP, "cpu")
    geo = fir_k.front_geometry(p.front_fir.shape[-1], p.front2.shape[-1],
                               rx.FLAGSHIP.decim, 1, 2)
    assert (geo.t_tile, geo.p, geo.pb, geo.e, geo.ze) == (512, 2, 2, 32, 200)


@pytest.mark.parametrize("taps,taps2,decim,nb,size,n_keep", [
    (20001, 199, 8, 1, 2, None),      # stage-A history past the buffers
    (227, 199, 8, 3, 2, None),        # three stage-B filters
    (227, 199, 8, 1, 2, 100),         # raw carry shorter than taps - 1
    (227, 199, 8, 1, 8, None)])       # 8-byte samples
def test_shapes_past_the_buffers_are_refused(taps, taps2, decim, nb, size,
                                             n_keep):
    with pytest.raises(ValueError):
        fir_k.front_geometry(taps, taps2, decim, nb, size, n_keep)


def test_k15_ring_refuses_long_histories():
    """K15's rule (`front_mt_geometry`, K1's tiles: K15 has no rings
    now) refuses a stage-A history past the shared memory as K1's does,
    and two stage-B filters; a stage B of 400 taps, past the old
    512-sample stage-B ring, fits."""
    with pytest.raises(ValueError):
        fir_k.front_mt_geometry(20001, 199, 8)
    with pytest.raises(ValueError):
        fir_k.front_geometry(227, 199, 8, 2, 2, cx=True)
    assert fir_k.front_mt_geometry(227, 400, 8).smem <= fir_k.FRONT_SMEM_MAX


def test_library_geometry_mismatch_raises(monkeypatch):
    """The wrapper holds the library's constants to cuda/fir.py's when it
    first loads it."""
    class Lib:                        # every getter reads 0
        def __getattr__(self, name):
            if not name.startswith("uhsdr_front_"):
                raise AttributeError(name)
            return lambda: 0

    lib = Lib()
    monkeypatch.setattr(fir_k.FRONT, "lib", lambda: lib)
    with pytest.raises(RuntimeError, match="geometry"):
        fir_k._front_lib()
    assert not getattr(lib, "geometry_checked", False)
