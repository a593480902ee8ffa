"""The port's synchronous-AM chains at 96 kHz on the CPU against the JAX
package's `rx.process_block`, for every sideband (both, usb, lsb) and
the fade leveler on and off (each route of `demod.sam.demod`; the
sideband and fade pairs not run here run at 48 kHz, and every pair at
the demodulator's level in tests/test_torch_sam.py): four streamed int16
blocks of 8 channels x 2048 samples from zero state, audio and every
state leaf compared after every block, and the stream handed over after block 2 in both directions
(tests/test_torch_rx.py::run_streamed_both_ways).  The 48 kHz chains are
in tests/test_torch_rx_sam48.py.

Tolerances.  At 96 kHz (5P0KHZ) the rate-lifted front has 239 taps whose
first ones are ~1e-9, so the chain's first decimated samples are far
below the signal: the JAX front (an FFT overlap-save on the CPU) returns
rounding noise there, the port's dot products the exact tiny values, and
the PLL's atan2 turns either into a full-scale phase.  The two loops
then pull in along different paths and meet again only as fast as the
1.4 s fade leveler and the AGC averages forget, so from zero state audio
and state are held to ZERO_DB only (`-s` prints the values: audio
32.1-38.2 dB and the worst leaf 20.8 dB in block 1, rising block by
block).  What shows that the port computes the
JAX chain's function at 96 kHz is the hand-over: from one state, in
either direction, blocks 3-4 hold 80 dB (measured: >= 104.6 dB).
"""
from __future__ import annotations

import pytest

from tests import test_torch_rx as common

ZERO_DB = 10.0


@pytest.mark.parametrize("sideband,fade", [
    ("both", True), ("both", False), ("usb", True), ("lsb", False)])
def test_sam_chain_matches_jax_streamed(sideband, fade):
    common.run_streamed_both_ways(
        dict(mode="sam", bw_key="5P0KHZ", iq_rate=96000.0,
             sam_sideband=sideband, fade_leveler=fade), ZERO_DB)
