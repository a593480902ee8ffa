"""Conformance rows of the port's two-channel RX modes and TX chain on the
CPU (the kernels' plain torch versions) against the float64 firmware
oracles, with the repo's harnesses and bound of 50 dB:

* iq and ssbstereo 2P3KHZ (select 2) against `tests/golden/ref_chain.py`
  (its two-channel branch, the linked stereo AGC), as
  tests/test_conformance_ref.py::test_product_two_channel_modes runs the
  JAX chain (JAX CPU rows: 109.8 and 110.5 dB, CONFORMANCE_r05.json);
* TX usb, lsb and am against `tests/golden/ref_tx.py`, as
  tests/test_tx_conformance.py::test_tx_chain_matches_reference_math runs
  the JAX chain (JAX rows: 77.5, 77.5 and 87.3 dB).

`-s` prints the values.
"""
from __future__ import annotations

import numpy as np
import pytest

from tests import test_conformance_ref as conf
from tests import test_tx_conformance as txconf
from tests.golden import ref_chain as gold
from tests.golden import ref_tx as gold_tx
from uhsdr_tpu_torch.chain import rx as trx
from uhsdr_tpu_torch.chain import tx as ttx

CONFORMANCE_DB = 50.0


@pytest.mark.parametrize("mode", ["iq", "ssbstereo"])
def test_two_channel_conformance_vs_float64_oracle(mode):
    iq = conf.make_iq("usb")           # two-sided content: both channels
    ref, _ = gold.ref_rx_chain(iq, mode, "2P3KHZ", select_id=2)
    chain = trx.RxChain(trx.RxConfig(mode=mode, bw_key="2P3KHZ",
                                     ref_select_id=2, block_len=4096),
                        device="cpu")
    state = chain.init_state((1,))
    outs = []
    for s in range(0, len(iq), 4096):
        audio, state, _ = chain(state, iq=iq[s:s + 4096][None])
        outs.append(audio[0].numpy())                     # (2, T)
    s_db = conf.snr_db_2ch(ref, np.concatenate(outs, axis=-1))
    print(f"\n{mode} 2P3KHZ vs the float64 oracle: {s_db:.1f} dB")
    assert s_db >= CONFORMANCE_DB, s_db


@pytest.mark.parametrize("mode", ["usb", "lsb", "am"])
def test_tx_conformance_vs_float64_oracle(mode):
    audio_u = txconf.make_voice()
    ref_iq = gold_tx.ref_tx_chain(audio_u.astype(np.float64)
                                  * txconf.INT16_FS, mode)
    chain = ttx.TxChain(ttx.TxConfig(mode=mode, translate_hz=6000.0,
                                     block_len=txconf.BLOCK), device="cpu")
    state = chain.init_state((1,))
    outs = []
    for s in range(0, len(audio_u), txconf.BLOCK):
        i, q, state = chain(state, audio_u[None, s:s + txconf.BLOCK])
        outs.append(i[0].numpy() + 1j * q[0].numpy())
    s_db = txconf.snr_db(ref_iq, np.concatenate(outs) * txconf.INT16_FS)
    print(f"\nTX {mode} vs the float64 oracle: {s_db:.1f} dB")
    assert s_db >= CONFORMANCE_DB, s_db
