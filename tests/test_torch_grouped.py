"""K14, the grouped biquad scan: its plain version
(`cuda/iir.py::biquad_grouped_plain`, what `biquad_cascade(impl=
"grouped")` runs on CPU tensors) against the TPU kernel it replaces,
`uhsdr_tpu.pallas.iir.biquad_cascade_pallas(impl="grouped")` in interpret
mode, and against the sequential form (K11's plain version), on SAM's
two 7-section z^-2 allpass sets (`uhsdr_tpu.demod.sam._AP_COEFFS`) at 16
channels.

The TPU kernel scans 128-sample tiles (4 groups of 32 each, the carry
between tiles), the port a whole block (16 groups at T = 512): the two
differ only in rounding.  Held to SNR >= 90 dB on output and state over a
streamed split (two blocks of 256, and a ragged split 200 + 312 whose
first block ends inside a group); `-s` prints the values (measured
137-142 dB against the TPU kernel, 119-125 dB against the sequential
recurrence, which itself sits about 120 dB from float64 on these poles:
ROADMAP section C).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uhsdr_tpu.demod import sam as jsam
from uhsdr_tpu.pallas import iir as piir
from uhsdr_tpu_torch.cuda import iir as iir_k
from uhsdr_tpu_torch.metrics import snr_db

TOL_DB = 90.0
C, T = 16, 512


def _x(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((C, T)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("coeff_set", [0, 1])
def test_grouped_plain_matches_pallas_grouped(coeff_set):
    sos = np.asarray(jsam._AP_COEFFS[coeff_set], np.float32)
    S = sos.shape[0]
    x = _x(20 + coeff_set)
    sj = jnp.zeros((S, C, 2), jnp.float32)
    st = torch.zeros((S, C, 2))
    for a, b in ((0, 256), (256, T)):
        yj, sj = piir.biquad_cascade_pallas(sos, sj, jnp.asarray(x[:, a:b]),
                                            impl="grouped")
        yt, st = iir_k.biquad_cascade(torch.from_numpy(sos), st,
                                      torch.from_numpy(x[:, a:b]),
                                      impl="grouped")
        s_y, s_s = snr_db(np.asarray(yj), yt), snr_db(np.asarray(sj), st)
        print(f"\nallpass set {coeff_set}, samples {a}-{b}: K14 plain vs "
              f"the Pallas grouped kernel: output {s_y:.1f} dB, states "
              f"{s_s:.1f} dB")
        assert min(s_y, s_s) >= TOL_DB
    # a ragged split through the port against the kernel's whole block
    yj, sj = piir.biquad_cascade_pallas(sos, jnp.zeros((S, C, 2)),
                                        jnp.asarray(x), impl="grouped")
    st = torch.zeros((S, C, 2))
    ys = []
    for a, b in ((0, 200), (200, T)):
        y, st = iir_k.biquad_cascade(torch.from_numpy(sos), st,
                                     torch.from_numpy(x[:, a:b]),
                                     impl="grouped")
        ys.append(y)
    s_y, s_s = snr_db(np.asarray(yj), torch.cat(ys, -1)), snr_db(
        np.asarray(sj), st)
    print(f"allpass set {coeff_set}, ragged 200 + 312: output {s_y:.1f} dB, "
          f"states {s_s:.1f} dB")
    assert min(s_y, s_s) >= TOL_DB


@pytest.mark.parametrize("coeff_set,group_len", [(0, 32), (1, 32), (0, 16),
                                                 (1, 64)])
def test_grouped_plain_matches_sequential(coeff_set, group_len):
    """The two-level scan against K11's recurrence, from a nonzero state,
    at each group length K14 is built for."""
    sos = torch.from_numpy(np.asarray(jsam._AP_COEFFS[coeff_set],
                                      np.float32))
    S = sos.shape[0]
    rng = np.random.default_rng(30 + group_len)
    s0 = torch.from_numpy((rng.standard_normal((S, C, 2)) * 1e-2)
                          .astype(np.float32))
    x = torch.from_numpy(_x(40 + coeff_set))
    yg, sg = iir_k.biquad_cascade(sos, s0, x, impl="grouped",
                                  group_len=group_len)
    yq, sq = iir_k.biquad_cascade(sos, s0, x)
    s_y, s_s = snr_db(yq, yg), snr_db(sq, sg)
    print(f"\nallpass set {coeff_set}, L = {group_len}: K14 plain vs the "
          f"sequential recurrence: output {s_y:.1f} dB, states {s_s:.1f} dB")
    assert min(s_y, s_s) >= TOL_DB


def test_grouped_refuses_unknown_impl():
    sos = torch.from_numpy(np.asarray(jsam._AP_COEFFS[0], np.float32))
    with pytest.raises(ValueError, match="impl"):
        iir_k.biquad_cascade(sos, torch.zeros((7, C, 2)),
                             torch.zeros((C, 64)), impl="dilated")
