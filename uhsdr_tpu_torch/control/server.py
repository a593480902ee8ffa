"""Live radio server — the entry-point/main-loop analog.

The reference firmware's top level (`src/uhsdr_main.c:388-494`) wires the
streaming DSP to the control surfaces and then loops forever:
`mchfMain` -> init -> `UhsdrHwI2s_Codec_StartDMA` -> `for(;;)
UiDriver_TaskHandler_MainTasks()` with CAT/UI events retuning the LO and
rebuilding the processing chain while the audio ISR keeps streaming.

`RadioServer` is that loop for the port, the counterpart of the JAX
package's: a pump thread streams an IQ capture through the RX chain on
the card block by block (the DMA/ISR role), while CAT clients
(`control/cat.py`, FT-817 protocol over TCP) retune, switch modes, and
key the transmitter:

  * dial steps ride the chain's `tune_offset_hz` (the reference's LO-only
    retune, `RadioManagement_ChangeFrequency` `radio_management.c:679`,
    where the DSP chain is untouched): the front kernel's NCO increment
    changes, nothing is rebuilt;
  * mode/bandwidth changes rebuild the chain between blocks — the
    `AudioDriver_SetProcessingChain` slow path, guarded in the reference
    by `ads.af_disabled` (`audio_driver.c:1095-1096`) and here by doing
    the swap on the pump thread itself;
  * PTT switches the pump to the TX chain (`RadioManagement_SwitchTxRx`
    `radio_management.c:910`): CW keys a sidetone-shaped carrier (or a
    queued text via the keyer), voice modes send a two-tone test signal;
    TX IQ power feeds the fwd-power telemetry
    (`RadioManagement_UpdatePowerAndVSWR` role, via `control/meter.py`);
  * the spectrum scope runs on the chain's pre-translate ``spectrum_iq``
    tap (the (i, q) planes) each block and publishes dBm / S-meter /
    SNAP-carrier telemetry for CAT readback
    (`UiSpectrum_CalculateDBm`/`CalculateSnap` roles).

The chains' and the scope's states stay on the device between blocks;
the pump copies to the host what the JAX server does: each block's audio,
the TX IQ and the three telemetry scalars (in one copy).  All device work
happens on the pump thread; CAT socket threads only write plain Python
attributes / enqueue pending reconfigurations.  An exception on the pump
stops it and is kept in ``error``, which every caller must check.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..chain import rx, tx
from ..io import ingest
from ..modems import cw_text
from ..spectrum import scope
from . import cat as cat_mod
from . import meter


@dataclass
class ServeConfig:
    iq_path: str = ""
    center_hz: float = 14_001_000.0   # RF frequency of the capture center
    fs: float = 48_000.0
    block_len: int = 4096
    mode: str = "usb"
    bw_key: str = "2P3KHZ"
    translate_hz: float = 6000.0
    agc_mode: str = "med"
    nr_enable: bool = False           # spectral NR in the live chain
    notch_enable: bool = False        # LMS auto-notch
    dial_hz: int = 0                  # 0 -> capture center
    loop: bool = True                 # wrap the capture (continuous RX)
    realtime: bool = False            # pace blocks at fs (else flat out)
    audio_keep_blocks: int = 64       # rolling demod-audio buffer
    tx_keep_blocks: int = 64
    audio_out: str = ""               # WAV path -> native AudioSink
                                      # (runtime/audio_sink.cpp, the
                                      # codec-DAC transport role)
    tx_power_level: str = "full"      # PA level policy (meter.PA_LEVELS_MW)
    cw_wpm: float = 20.0
    # software dBm calibration (the reference's "dBm calibrate" config,
    # `UiSpectrum_CalculateDBm`): chosen so a 0.4-amplitude float tone
    # reads ~= S9 (-73 dBm); adjust per capture full-scale convention
    dbm_cal: float = 112.0
    device: str = "cuda"              # "cpu" for the plain torch path


class RadioServer(cat_mod.Radio):
    """A running radio: IQ capture in, demod audio + telemetry out,
    CAT-controlled.  Use as a context manager or start()/stop().  Raises
    at construction where the config's device is CUDA and none is
    present."""

    def __init__(self, cfg: ServeConfig):
        super().__init__()
        self.serve_cfg = cfg
        self.device = rx.resolve_device(cfg.device)
        self.dial_hz = int(cfg.dial_hz or cfg.center_hz)
        self.mode = cfg.mode
        self._chain_mode = cfg.mode             # the mode the RX chain runs
        self._bw_key = cfg.bw_key
        self._pending_chain = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()           # guards pending config
        self.audio_blocks: deque = deque(maxlen=cfg.audio_keep_blocks)
        self.tx_iq_blocks: deque = deque(maxlen=cfg.tx_keep_blocks)
        self.blocks_processed = 0
        self.tx_blocks_processed = 0
        self.snap_freq_hz = 0.0
        self.dbm = -120.0
        self._tx_text: deque = deque()          # queued CW text (digi buffer)
        self._tx_keying: np.ndarray | None = None
        self._tx_key_pos = 0
        self.error: str | None = None

    # ---- CAT hooks (called from socket threads: attribute writes only) --
    def on_tune(self, dial_hz: int) -> None:
        self.dial_hz = int(dial_hz)

    def on_mode(self, mode: str) -> None:
        # the CAT protocol writes `mode` before it calls this hook, so the
        # test is against the mode the running chain was built for (the
        # JAX server compares with `mode` itself and never rebuilds)
        self.mode = mode
        if mode != self._chain_mode:
            self._pending_chain.set()

    def on_ptt(self, active: bool) -> None:
        self.ptt = bool(active)

    # ---- control-plane extras -------------------------------------------
    def set_bandwidth(self, bw_key: str) -> None:
        with self._lock:
            self._bw_key = bw_key
        self._pending_chain.set()

    def queue_tx_text(self, text: str) -> None:
        """CW text TX (the digi-buffer / USB-keyboard role)."""
        self._tx_text.append(text)

    # ---- pump ------------------------------------------------------------
    def _build_freedv(self):
        """FreeDV as a serve mode: the rate converter on the device, the
        modem on the host (the reference's PendSV role,
        `freedv_uhsdr.c:166-320`); the scope tap still sees the raw IQ."""
        from ..modems import freedv as fdv
        c = self.serve_cfg
        return fdv.FreeDvRadioMode(self.mode, c.block_len,
                                   translate_hz=c.translate_hz, fs=c.fs,
                                   device=self.device)

    def _build_rx(self):
        c = self.serve_cfg
        chain_mode = {"rtty": "usb", "psk": "usb",
                      "freedv1600": "usb",
                      "freedv700d": "usb"}.get(self.mode, self.mode)
        with self._lock:
            bw = self._bw_key
        self._chain_mode = self.mode
        cfg = rx.RxConfig(mode=chain_mode, bw_key=bw,
                          translate_hz=c.translate_hz,
                          agc_mode=c.agc_mode, block_len=c.block_len,
                          nr_enable=c.nr_enable,
                          notch_enable=c.notch_enable)
        chain = rx.RxChain(cfg, device=self.device)
        state = chain.init_state((1,))
        sc_params = scope.make_params(translate_hz=c.translate_hz,
                                      f_lo=cfg.path.audio_band[0],
                                      f_hi=cfg.path.audio_band[1],
                                      mode=chain_mode,
                                      dbm_constant=c.dbm_cal)
        sc_state = scope.init_state((1,), sc_params, device=self.device)
        return chain, state, sc_params, sc_state

    def _build_tx(self):
        c = self.serve_cfg
        mode = self.mode if self.mode in ("usb", "lsb", "am", "fm", "cw") \
            else "cw"
        cfg = tx.TxConfig(mode=mode, translate_hz=c.translate_hz,
                          block_len=c.block_len)
        chain = tx.TxChain(cfg, device=self.device)
        return chain, chain.init_state((1,))

    def _tx_source_block(self) -> np.ndarray:
        """Audio/keying input for one TX block (the mic/line/keyer mux,
        `tx_processor.c:936-947`)."""
        c = self.serve_cfg
        T = c.block_len
        if self.mode == "cw":
            if self._tx_keying is None and self._tx_text:
                self._tx_keying = cw_text.text_to_keying(
                    self._tx_text.popleft(), c.cw_wpm, c.fs)
                self._tx_key_pos = 0
            if self._tx_keying is not None:
                k = np.zeros(T, np.float32)
                n = min(T, len(self._tx_keying) - self._tx_key_pos)
                k[:n] = self._tx_keying[self._tx_key_pos:self._tx_key_pos + n]
                self._tx_key_pos += n
                if self._tx_key_pos >= len(self._tx_keying):
                    self._tx_keying = None
                return k
            return np.ones(T, np.float32)      # key-down (tune carrier)
        # voice modes: two-tone test signal (700 + 1900 Hz)
        t = (np.arange(T) + self.tx_blocks_processed * T) / c.fs
        return (0.45 * np.sin(2 * np.pi * 700.0 * t)
                + 0.45 * np.sin(2 * np.pi * 1900.0 * t)).astype(np.float32)

    def _planes(self, i_p: np.ndarray, q_p: np.ndarray):
        """A host block's (1, T) planes on the device."""
        return tuple(torch.from_numpy(np.ascontiguousarray(p[None]))
                     .to(self.device) for p in (i_p, q_p))

    def _telemetry(self, sc_out) -> None:
        """dBm, S-meter and SNAP from the scope's outputs, one copy."""
        dbm = sc_out["dbm"][:1]
        vals = torch.cat([dbm, scope.dbm_to_s_units(dbm),
                          sc_out["snap_freq"][:1]]).cpu().numpy()
        self.dbm, self.s_meter, self.snap_freq_hz = (float(v) for v in vals)

    def _pump(self):
        c = self.serve_cfg
        sink = None
        try:
            chain, state, sc_params, sc_state = self._build_rx()
            fdv_radio = (self._build_freedv()
                         if self.mode.startswith("freedv") else None)
            tx_chain = tx_state = None
            power_mw, _ = meter.resolve_power_level(
                c.tx_power_level, self.mode)
            if c.audio_out:
                sink = ingest.AudioSink(c.audio_out, fs=int(c.fs),
                                        block_samples=c.block_len)
            with ingest.IqIngest(c.iq_path, c.block_len,
                                 loop=c.loop) as src:
                while not self._stop.is_set():
                    t0 = time.perf_counter()
                    if self._pending_chain.is_set():
                        self._pending_chain.clear()
                        chain, state, sc_params, sc_state = self._build_rx()
                        fdv_radio = (self._build_freedv()
                                     if self.mode.startswith("freedv")
                                     else None)
                        tx_chain = tx_state = None
                        power_mw, _ = meter.resolve_power_level(
                            c.tx_power_level, self.mode)
                    if self.ptt and not self.tx_disabled:
                        if tx_chain is None:
                            tx_chain, tx_state = self._build_tx()
                        src_blk = self._tx_source_block()
                        i_p, q_p, tx_state = tx_chain(tx_state,
                                                      src_blk[None])
                        iq = torch.complex(i_p[0], q_p[0]).cpu().numpy()
                        self.tx_iq_blocks.append(iq)
                        # fwd power telemetry: IQ drive power scaled by the
                        # PA level policy (full scale = reference power),
                        # with decaying peak-hold ballistics so keyed-CW
                        # inter-element gaps don't blank the meter (the
                        # reference averages 5 ADC reads per measurement,
                        # radio_management.c:1738-1772)
                        drive = float(np.mean(iq.real**2 + iq.imag**2))
                        target_w = (power_mw or
                                    meter.PA_REFERENCE_POWER_MW) / 1000.0
                        self.fwd_pwr = max(2.0 * drive * target_w,
                                           0.8 * self.fwd_pwr)
                        self.tx_blocks_processed += 1
                    else:
                        blk = src.next_block()
                        if blk is None:
                            break
                        i_p, q_p = blk
                        offset = float(self.dial_hz - c.center_hz)
                        if fdv_radio is not None:
                            # digital-voice mode: the rate converter on
                            # the device, the modem on the host
                            audio_np = fdv_radio.rx_block(
                                i_p, q_p, extra_offset_hz=offset)
                            sc_out, sc_state = scope.process(
                                sc_params, sc_state, self._planes(i_p, q_p))
                            self.freedv_stats = fdv_radio.stats
                        else:
                            i_t, q_t = self._planes(i_p, q_p)
                            audio, state, taps = chain(
                                state, i=i_t, q=q_t, tune_offset_hz=offset)
                            sc_out, sc_state = scope.process(
                                sc_params, sc_state, taps["spectrum_iq"])
                            audio_np = audio[0].cpu().numpy()
                        if audio_np.size:   # freedv yields whole
                            self.audio_blocks.append(audio_np)  # frames
                            if sink is not None:
                                sink.push(audio_np)
                        self._telemetry(sc_out)
                        self.blocks_processed += 1
                    if c.realtime:
                        budget = c.block_len / c.fs
                        dt = time.perf_counter() - t0
                        if dt < budget:
                            time.sleep(budget - dt)
        except Exception as e:  # surfaced to callers through `error`
            self.error = f"{type(e).__name__}: {e}"
        finally:
            if sink is not None:
                self.audio_frames_written = sink.written
                self.audio_blocks_dropped = sink.dropped
                sink.close()
            self._stop.set()

    # ---- lifecycle --------------------------------------------------------
    def start(self) -> "RadioServer":
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="uhsdr-pump")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def wait_blocks(self, n: int, timeout: float = 120.0,
                    tx: bool = False) -> bool:
        """Block until n more RX (or TX) blocks have been pumped."""
        attr = "tx_blocks_processed" if tx else "blocks_processed"
        target = getattr(self, attr) + n
        t0 = time.monotonic()
        while getattr(self, attr) < target:
            if self._stop.is_set() or time.monotonic() - t0 > timeout:
                return False
            time.sleep(0.01)
        return True

    def audio(self) -> np.ndarray:
        blocks = list(self.audio_blocks)
        return (np.concatenate(blocks, axis=-1) if blocks
                else np.zeros(0, np.float32))

    def tx_iq(self) -> np.ndarray:
        blocks = list(self.tx_iq_blocks)
        return (np.concatenate(blocks, axis=-1) if blocks
                else np.zeros(0, np.complex64))

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()


def serve(cfg: ServeConfig, host: str = "127.0.0.1", port: int = 0
          ) -> tuple[RadioServer, cat_mod.CatServer]:
    """Start the radio + its CAT server; returns both (caller stops)."""
    radio = RadioServer(cfg).start()
    catsrv = cat_mod.CatServer(radio, host=host, port=port)
    catsrv.start()
    return radio, catsrv
