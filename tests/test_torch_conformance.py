"""Conformance rows of the port's AM, SAM, wide-SSB and FM chains: `RxChain` on the CPU
(the kernels' plain torch versions) against the float64 firmware oracle
`tests/golden/ref_chain.py`, on the captures and with the metric of
tests/test_conformance_ref.py (two seconds at 48 kHz in 4096-sample
blocks, the first half second skipped), at the repo's bound of 50 dB for
the product chain (tests/test_conformance_ref.py:103-111).  The narrow
usb row is tests/test_torch_rx.py::test_conformance_vs_float64_oracle.
The JAX package's CPU rows read usb 10P0KHZ 108.2 dB and fm 3P6KHZ
95.4 dB (CONFORMANCE_r05.json).  `-s` prints the values.
"""
from __future__ import annotations

import numpy as np
import pytest

from tests import test_conformance_ref as conf
from tests.golden import ref_chain as gold
from uhsdr_tpu_torch.chain import rx as trx

CONFORMANCE_DB = 50.0


@pytest.mark.parametrize("mode,bw", [("am", "2P5KHZ"), ("sam", "2P3KHZ")])
def test_am_sam_conformance_vs_float64_oracle(mode, bw):
    iq = conf.make_iq(mode)
    ref, _ = gold.ref_rx_chain(iq, mode, bw)
    chain = trx.RxChain(trx.RxConfig(mode=mode, bw_key=bw, block_len=4096),
                        device="cpu")
    state = chain.init_state((1,))
    outs = []
    for s in range(0, len(iq), 4096):
        audio, state, _ = chain(state, iq=iq[s:s + 4096][None])
        outs.append(audio[0].numpy())
    s_db = conf.snr_db(ref, np.concatenate(outs))
    print(f"\n{mode} {bw} vs the float64 oracle: {s_db:.1f} dB")
    assert s_db >= CONFORMANCE_DB, s_db


@pytest.mark.parametrize("mode,bw", [("usb", "10P0KHZ"), ("fm", "3P6KHZ")])
def test_wide_fm_conformance_vs_float64_oracle(mode, bw):
    """The wide-SSB front (one complex-tap decimating FIR, K6/K7's plain
    version) and the FM chain (K5, the discriminator K12's plain version,
    squelch off) against the oracle."""
    iq = conf.make_iq(mode)
    ref, _ = gold.ref_rx_chain(iq, mode, bw)
    chain = trx.RxChain(trx.RxConfig(mode=mode, bw_key=bw, block_len=4096),
                        device="cpu")
    state = chain.init_state((1,))
    outs = []
    for s in range(0, len(iq), 4096):
        audio, state, _ = chain(state, iq=iq[s:s + 4096][None])
        outs.append(audio[0].numpy())
    s_db = conf.snr_db(ref, np.concatenate(outs))
    print(f"\n{mode} {bw} vs the float64 oracle: {s_db:.1f} dB")
    assert s_db >= CONFORMANCE_DB, s_db
