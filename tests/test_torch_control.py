"""The port's control plane (`uhsdr_tpu_torch.control`: cat, radio, meter,
osc, calibration, selftest) and profiling (`uhsdr_tpu_torch.utils.
profiling`) against the JAX package's, on the CPU.

These modules are copies (NumPy and the standard library; `cat` over
the port's `core.config`), so every result is held equal: the CAT
protocol's responses byte for byte to the same frame sequences, in
process and over TCP on port 0; the radio model's tuning, sequencing and
SNAP machine; the meters' readings; the oscillators' register writes;
the IQ calibration and soft TCXO; the twin-peaks monitor's decisions;
`EventProfiler.report` on a scripted clock.  `profiling.trace` writes a
`torch.profiler` Chrome trace.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from uhsdr_tpu.control import calibration as jcal
from uhsdr_tpu.control import cat as jcat
from uhsdr_tpu.control import meter as jmeter
from uhsdr_tpu.control import osc as josc
from uhsdr_tpu.control import radio as jradio
from uhsdr_tpu.control import selftest as jself
from uhsdr_tpu.utils import profiling as jprof
from uhsdr_tpu_torch.control import calibration as tcal
from uhsdr_tpu_torch.control import cat as tcat
from uhsdr_tpu_torch.control import meter as tmeter
from uhsdr_tpu_torch.control import osc as tosc
from uhsdr_tpu_torch.control import radio as tradio
from uhsdr_tpu_torch.control import selftest as tself
from uhsdr_tpu_torch.utils import profiling as tprof


def _frames(seed: int, n: int = 400) -> list[bytes]:
    """A seeded CAT session: every opcode the protocol knows, unknown
    ones, BCD frequencies, mode codes and EEPROM (FT-817 and config-id)
    reads and writes."""
    rng = np.random.default_rng(seed)
    ops = [jcat.SET_FREQ, jcat.GET_FREQ, jcat.MODE_SET, jcat.PTT_ON,
           jcat.PTT_OFF, jcat.SPLIT_ON, jcat.SPLIT_OFF, jcat.TOGGLE_VFO,
           jcat.PWR_ON, jcat.A7, jcat.READ_RX_STATE, jcat.READ_TX_STATE,
           jcat.PTT_STATE, jcat.EEPROM_READ, jcat.EEPROM_WRITE,
           jcat.UHSDR_ID, jcat.NOOP, 0x55, 0x99]
    ids = [e.eeprom_id for e in jcat.config_mod.REGISTRY]
    ids += [v + 3 for v in jcat.config_mod.BandMemories.IDS.values()]
    out = []
    for _ in range(n):
        op = int(rng.choice(ops))
        p = [int(x) for x in rng.integers(0, 256, 4)]
        if op == jcat.SET_FREQ:
            p = list(jcat._bcd_freq_encode(int(rng.integers(1_800_000,
                                                           30_000_000))))
        elif op == jcat.MODE_SET:
            p[0] = int(rng.choice([0, 1, 2, 3, 4, 8, 0x88, 0x0A, 0x0C, 7]))
        elif op in (jcat.EEPROM_READ, jcat.EEPROM_WRITE):
            if rng.random() < 0.6:
                vid = int(rng.choice(ids))
                p[0], p[1] = 0x80 | (vid >> 8), vid & 0xFF
            else:
                a = int(rng.integers(0, 0x1925))
                p[0], p[1] = a >> 8, a & 0xFF
        out.append(bytes(p + [op]))
    return out


def _radio_view(r) -> dict:
    return {"dial": r.dial_hz, "mode": r.mode, "cw_lsb": r.cw_lsb,
            "fm5": r.fm_dev5khz, "ptt": r.ptt, "split": r.split,
            "vfo_b": r.vfo_b, "cfg": r.config.to_dict(),
            "bands": r.config.band_memory.to_dict(),
            "ee": dict(r._ft817_eeprom)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cat_protocol_byte_equal(seed):
    jr, tr = jcat.Radio(), tcat.Radio()
    for r in (jr, tr):
        r.s_meter, r.fwd_pwr, r.vswr = 7.5, 4.2, 3.5
    jp, tp = jcat.CatProtocol(jr), tcat.CatProtocol(tr)
    for k, f in enumerate(_frames(seed)):
        if k == 200:
            jr.tx_disabled = tr.tx_disabled = True
        assert tp.handle_frame(f) == jp.handle_frame(f), (k, f.hex())
    assert _radio_view(tr) == _radio_view(jr)


def test_cat_bcd_and_tcp_round_trip(tmp_path):
    for f in (0, 10, 1_840_000, 14_074_010, 99_999_990):
        assert tcat._bcd_freq_encode(f) == jcat._bcd_freq_encode(f)
        assert (tcat._bcd_freq_decode(jcat._bcd_freq_encode(f))
                == jcat._bcd_freq_decode(jcat._bcd_freq_encode(f)))
    radio = tcat.Radio()
    srv = tcat.CatServer(radio, port=0).start()
    try:
        cli = tcat.CatClient(port=srv.port)
        assert cli.identify()
        cli.set_frequency(7_074_000)
        assert cli.get_frequency() == (7_074_000, "usb")
        assert cli.set_mode("lsb") and radio.mode == "lsb"
        cli.ptt(True)
        assert radio.ptt
        cli.ptt(False)
        entry = tcat.config_mod.entry_by_name("cw_speed_wpm")
        cli.write_config(entry.eeprom_id, 33)
        assert cli.read_config(entry.eeprom_id) == 33
        path = str(tmp_path / "backup.json")
        data = cli.backup_config(path)
        assert data["cw_speed_wpm"] == 33
        radio.config.set("cw_speed_wpm", 10)
        cli.restore_config(path)
        assert radio.config.get("cw_speed_wpm") == 33
        # the JAX package's client speaks to the port's server alike
        jc = jcat.CatClient(port=srv.port)
        assert jc.get_frequency() == (7_074_000, "lsb")
        jc.close()
        cli.close()
    finally:
        srv.stop()


def test_radio_model_equal():
    assert tradio.BANDS == jradio.BANDS and tradio.MODES == jradio.MODES
    assert tradio.TRANSLATE_OFFSETS == jradio.TRANSLATE_OFFSETS
    for f in np.linspace(100_000, 60_000_000, 97):
        assert tradio.band_for_freq(f) == jradio.band_for_freq(f)
        assert (tradio.default_sideband_for_freq(f)
                == jradio.default_sideband_for_freq(f))
        for m in ("auto", "usb", "lsb"):
            assert tradio.cw_is_lsb(f, m) == jradio.cw_is_lsb(f, m)
        for mode in ("usb", "fm", "digi", "xx"):
            assert (tradio.mode_applicable(mode, f)
                    == jradio.mode_applicable(mode, f))
        for mode, iqm in (("usb", 2), ("cw", 1), ("cw", 4), ("lsb", 0)):
            kw = dict(dial_hz=f, mode=mode, iq_freq_mode=iqm, rit_hz=120.0,
                      transverter_offset_hz=1e3, transverter_mult=2)
            assert (tradio.dial_to_tune(tradio.TuneState(**kw))
                    == jradio.dial_to_tune(jradio.TuneState(**kw)))
    for to_tx, split in ((True, None), (True, 7e6), (False, None)):
        a = jradio.switch_txrx(jradio.TrxState(), to_tx, split)
        b = tradio.switch_txrx(tradio.TrxState(), to_tx, split)
        assert (b[0].mode, b[0].muted, b[1]) == (a[0].mode, a[0].muted,
                                                 a[1])
    js, ts = jradio.SnapTuner(), tradio.SnapTuner()
    rng = np.random.default_rng(3)
    for k in range(300):
        est = float(rng.normal(40.0, 6.0 if k % 50 < 25 else 0.5))
        active = bool(k % 37)
        assert ts.update(est, active) == js.update(est, active)


def test_meter_equal():
    for adc in (0.0, 50.0, 150.0, 900.0, 3000.0):
        for null, coup in ((100, 100), (80, 120)):
            assert (tmeter.power_from_sensor(adc, null, coup)
                    == jmeter.power_from_sensor(adc, null, coup))
    rng = np.random.default_rng(4)
    for swap, thr in ((False, 1.0), (True, 2.0), (False, 1.5)):
        jm = jmeter.SwrMeter(swap_fwd_rev=swap, vswr_protection_threshold=thr)
        tm = tmeter.SwrMeter(swap_fwd_rev=swap, vswr_protection_threshold=thr)
        for _ in range(60):
            fwd, rev = (float(v) for v in rng.uniform(0, 3000, 2))
            assert tm.update(fwd, rev) == jm.update(fwd, rev)
            assert (tm.fwd_pwr, tm.rev_pwr, tm.fwd_dbm, tm.vswr,
                    tm.high_vswr_detected) == (
                jm.fwd_pwr, jm.rev_pwr, jm.fwd_dbm, jm.vswr,
                jm.high_vswr_detected)
    for mw in (0, 500, 5000, 8000):
        assert tmeter.power_factor_scale(mw) == jmeter.power_factor_scale(mw)
        for red in (False, True):
            assert (tmeter.band_power_factor(70, mw, red)
                    == jmeter.band_power_factor(70, mw, red))
    for f in (1.9e6, 3.5e6, 14e6, 28e6, 50e6):
        assert (tmeter.generic_band_power_factor(f, 40, 60, True)
                == jmeter.generic_band_power_factor(f, 40, 60, True))
    for level in tmeter.PA_LEVELS_MW:
        for mode in ("usb", "am", "sam", "cw"):
            for in_band, outside in ((True, False), (False, True),
                                     (False, False)):
                assert tmeter.resolve_power_level(
                    level, mode, in_band, outside) == \
                    jmeter.resolve_power_level(level, mode, in_band, outside)


def _osc_run(mod, kind):
    writes = []
    o = getattr(mod, kind)(lambda reg, data: writes.append((reg, bytes(data))))
    res = []
    for k, f in enumerate(np.concatenate([
            np.linspace(1.8e6, 30e6, 23), 14.074e6 + 137.0 * np.arange(9),
            [100.0, 4e8]])):
        r = o.prepare_next_frequency(float(f), temp_factor_hz=float(k % 3))
        res.append((r.name, o.is_next_step_large()))
        if r.name != "TUNE_IMPOSSIBLE":
            res.append(o.change_to_next_frequency().name)
            res.append(mod.planned_output_hz(o, float(f)))
    return res, writes, o.min_frequency_hz(), o.max_frequency_hz()


@pytest.mark.parametrize("kind", ["Si570", "Si5351"])
def test_osc_equal(kind):
    assert _osc_run(tosc, kind) == _osc_run(josc, kind)


def test_calibration_equal():
    jc, tc = jcal.IqCalibration(), tcal.IqCalibration()
    for c in (jc, tc):
        c.set_anchor(3.5e6, rx_gain=40.0, rx_phase=-12.0)
        c.set_anchor(14e6, rx_gain=-25.0, tx_gain=8.0, tx_phase=3.0)
        c.set_anchor(28e6, rx_phase=30.0)
        c.set_anchor(14e6 + 0.5, tx_phase=5.0)
    for f in np.linspace(1e6, 40e6, 41):
        assert tc.rx_adjustments(f) == jc.rx_adjustments(f)
        assert tc.tx_adjustments(f) == jc.tx_adjustments(f)
    temps = np.linspace(-10.0, 110.0, 50)
    np.testing.assert_array_equal(tcal.default_drift_curve(temps),
                                  jcal.default_drift_curve(temps))
    jt, tt = jcal.SoftTcxo(), tcal.SoftTcxo(step_c=1.0)
    for t in np.concatenate([temps, temps[::-1] + 0.3]):
        a, b = jt.update(t), tt.update(t)
        assert a == b
        assert tcal.SoftTcxo.apply(14e6, b[1]) == jcal.SoftTcxo.apply(14e6,
                                                                       a[1])


def test_selftest_equal():
    rng = np.random.default_rng(6)
    n = 12
    jm, tm = jself.TwinpeaksMonitor(n), tself.TwinpeaksMonitor(n)
    for k in range(1200):
        t3 = rng.normal(1.0, 0.1, n) * (np.arange(n) % 5 != 0)
        t1 = rng.normal(0.0, 0.05 + 0.1 * (np.arange(n) % 3), n)
        a = jm.update(t1, t3, blocks_elapsed=7)
        b = tm.update(t1, t3, blocks_elapsed=7)
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(tm.status, jm.status)
        if len(a) and k % 2:
            jm.acknowledge_restart(a)
            tm.acknowledge_restart(b)
    assert set(tm.status.tolist()) - {0}, tm.status


def test_profiler_report_equal(monkeypatch):
    def scripted(mod):
        ticks = iter(np.cumsum([0.0, 0.002, 0.001, 0.005, 0.0, 0.003,
                                0.004, 0.0, 0.010]))
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        p = mod.EventProfiler()
        with p.event("block"):
            p.start("nr")
            p.stop("nr")
        p.stop("never_started")
        with p.event("block"):
            pass
        p.start("nr")
        p.stop("nr")
        monkeypatch.undo()
        return p.report()
    a, b = scripted(jprof), scripted(tprof)
    assert b == a and b["block"]["count"] == 2
    for args in ((48000, 10, 1.0), (4096, 8192, 0.0123)):
        assert tprof.throughput(*args) == jprof.throughput(*args)


def test_profiling_trace_writes_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with tprof.trace(logdir) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum()
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert len(prof.key_averages()) > 0
    assert time.time() - os.path.getmtime(path) < 600
