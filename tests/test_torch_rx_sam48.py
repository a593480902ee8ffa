"""The port's synchronous-AM chains at 48 kHz on the CPU against the JAX
package's `rx.process_block`, for every sideband (both, usb, lsb), the
fade leveler on or off, on a row with the post anti-alias lattice
(3P6KHZ, 89 front taps): four streamed int16 blocks of 8 channels x 2048
samples from zero state, audio and every state leaf held to 80 dB after
every block, and the stream handed over after block 2 in both directions
at 80 dB (tests/test_torch_rx.py::run_streamed_both_ways).  The 96 kHz
chains, whose start from zero state is chaotic, are in
tests/test_torch_rx_sam.py.
"""
from __future__ import annotations

import pytest

from tests import test_torch_rx as common


@pytest.mark.parametrize("sideband,fade", [
    ("both", True), ("usb", False), ("lsb", True)])
def test_sam_chain_matches_jax_streamed(sideband, fade):
    common.run_streamed_both_ways(
        dict(mode="sam", bw_key="3P6KHZ", iq_rate=48000.0,
             sam_sideband=sideband, fade_leveler=fade), common.CHAIN_DB)
