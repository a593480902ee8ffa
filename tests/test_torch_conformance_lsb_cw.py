"""Conformance rows of the port's lsb and cw chains: `RxChain` on the CPU
(the kernels' plain torch versions) against the float64 firmware oracle
`tests/golden/ref_chain.py`, on the captures and with the metric of
tests/test_conformance_ref.py (its PRODUCT_CASES rows lsb 2P3KHZ select
2 and cw 500HZ: two seconds at 48 kHz in 4096-sample blocks), at the
repo's bound of 50 dB.  The JAX package's CPU rows read 110.2 and
112.6 dB (CONFORMANCE_r05.json).  `-s` prints the values.
"""
from __future__ import annotations

import numpy as np
import pytest

from tests import test_conformance_ref as conf
from tests.golden import ref_chain as gold
from uhsdr_tpu_torch.chain import rx as trx

CONFORMANCE_DB = 50.0


@pytest.mark.parametrize("mode,bw,sel", [("lsb", "2P3KHZ", 2),
                                         ("cw", "500HZ", None)])
def test_lsb_cw_conformance_vs_float64_oracle(mode, bw, sel):
    iq = conf.make_iq(mode)
    ref, _ = gold.ref_rx_chain(iq, mode, bw, select_id=sel)
    chain = trx.RxChain(trx.RxConfig(mode=mode, bw_key=bw, ref_select_id=sel,
                                     block_len=4096), device="cpu")
    state = chain.init_state((1,))
    outs = []
    for s in range(0, len(iq), 4096):
        audio, state, _ = chain(state, iq=iq[s:s + 4096][None])
        outs.append(audio[0].numpy())
    s_db = conf.snr_db(ref, np.concatenate(outs))
    print(f"\n{mode} {bw} vs the float64 oracle: {s_db:.1f} dB")
    assert s_db >= CONFORMANCE_DB, s_db
