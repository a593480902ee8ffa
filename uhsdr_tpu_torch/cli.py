"""Command-line interface: receive/transmit on IQ captures, conformance.

The host-tool layer of the port, the counterpart of the JAX package's
(the reference's `support/python/` CAT client + config tool play this
role for the firmware): the same commands, arguments and JSON lines.
Every command that runs a chain runs it on the card; ``--device cpu``
runs the kernels' plain torch versions instead, and without it a machine
with no CUDA device raises.

Usage:
  python -m uhsdr_tpu_torch.cli rx --input cap.wav --mode usb --bw 2P3KHZ \
      --out audio.wav [--nr] [--notch] [--decode] [--device cpu]
      # always reports dBm + SNAP carrier estimate in the JSON metrics
  python -m uhsdr_tpu_torch.cli channelize --input wide.wav --channels 512
  python -m uhsdr_tpu_torch.cli tx --text "CQ CQ" --mode cw --out iq.wav
  python -m uhsdr_tpu_torch.cli serve --input cap.wav
  python -m uhsdr_tpu_torch.cli config show|save|backup|restore
  python -m uhsdr_tpu_torch.cli conformance
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

import numpy as np

# audio blocks held on the device before one copy to the host
_HOST_EVERY = 64


class _DeviceAudio:
    """Per-block audio tensors gathered on the device and copied to the
    host every `_HOST_EVERY` blocks (not once a block, which would hold
    the host up on the card each block)."""

    def __init__(self):
        self.pending, self.host = [], []

    def push(self, y) -> None:
        self.pending.append(y)
        if len(self.pending) >= _HOST_EVERY:
            self._flush()

    def _flush(self) -> None:
        import torch
        if self.pending:
            self.host.append(torch.cat(self.pending, dim=-1).cpu().numpy())
            self.pending = []

    def result(self, dtype=np.float32) -> np.ndarray:
        self._flush()
        return (np.concatenate(self.host, axis=-1) if self.host
                else np.zeros(0, dtype))


def _make_text_decoder(mode: str, fs_dec: float, device):
    """Digital decoder stack for `rx --decode` (the reference's 12 kHz
    decoder tap, audio_driver.c:2527-2556): the decoder of `mode` on the
    chain's ``audio_dec`` tap, its state and remainders on the device
    (`modems/tap.py`, the CLI's CW and RTTY parameters and PSK31).
    Returns (push, flush)."""
    from .modems import tap

    if mode not in tap.MODES:
        raise ValueError(f"no text decoder for mode {mode}")
    if fs_dec != tap.FS:
        raise ValueError(f"the decoders run at {tap.FS:.0f} Hz, the "
                         f"chain's tap at {fs_dec:.0f} Hz")
    dec = tap.DecoderTap(1, text_channels=(0,), device=device, modes=(mode,))

    def flush():
        return dec.flush()[mode][0]
    return dec.push, flush


def _cmd_rx_freedv(args) -> int:
    """FreeDV as a radio RX mode (`freedv_uhsdr.c:166-320` role): the
    48k capture is NCO-translated and rate-converted /6 to the 8 kHz modem
    on the card, demodulated on the host (FDMDV+Golay+vocoder or
    OFDM+LDPC+vocoder), and the recovered speech is interpolated x6 back
    to 48 kHz audio out."""
    from .io import ingest
    from .modems import freedv as fdv

    # the /6 modem rate conversion needs a block divisible by 6; the
    # generic default (4096) is not — fall back to 4800 (100 ms)
    block = args.block if args.block % 6 == 0 else 4800
    radio = fdv.FreeDvRadioMode(args.mode, block,
                                translate_hz=args.translate,
                                device=args.device)
    out = []
    nblocks = 0
    with ingest.IqIngest(args.input, block) as src:
        while True:
            blk = src.next_block()
            if blk is None:
                break
            audio = radio.rx_block(blk[0], blk[1])
            if audio.size:
                out.append(audio)
            nblocks += 1
            if args.max_blocks and nblocks >= args.max_blocks:
                break
    audio = (np.concatenate(out) if out else np.zeros(0, np.float32))
    if args.out:
        ingest.write_audio_wav(args.out, audio)
    metrics = {"blocks": nblocks, "samples": int(audio.size),
               "audio_rms": (float(np.sqrt(np.mean(audio ** 2)))
                             if audio.size else 0.0)}
    metrics.update(radio.stats)
    print(json.dumps(metrics))
    return 0


def cmd_rx(args) -> int:
    import torch

    from .chain import rx
    from .io import ingest
    from .spectrum import scope

    if args.mode in ("freedv1600", "freedv700d"):
        return _cmd_rx_freedv(args)

    # digital text modes ride the SSB chain with the decoder on the
    # decimated tap
    chain_mode = {"rtty": "usb", "psk": "usb",
                  "samstereo": "sam"}.get(args.mode, args.mode)
    cfg = rx.RxConfig(mode=chain_mode, bw_key=args.bw,
                      path_name=args.path or None,
                      translate_hz=args.translate,
                      sam_sideband="stereo" if args.mode == "samstereo"
                      else "both",
                      nr_enable=args.nr, notch_enable=args.notch,
                      agc_mode=args.agc, block_len=args.block)
    chain = rx.RxChain(cfg, device=args.device)
    state = chain.init_state((1,))
    decoder = None
    if args.decode:
        decoder = _make_text_decoder(args.mode, cfg.fs_dec, chain.device)
    scope_mode = {"samstereo": "sam", "iq": "sam",
                  "ssbstereo": "usb"}.get(args.mode, args.mode)
    sc_params = scope.make_params(translate_hz=args.translate,
                                  f_lo=cfg.path.audio_band[0],
                                  f_hi=cfg.path.audio_band[1],
                                  mode=scope_mode)
    sc_state = scope.init_state((1,), sc_params, device=chain.device)

    out = _DeviceAudio()
    nblocks = 0
    with ingest.IqIngest(args.input, args.block,
                         raw_i16=args.raw_i16) as src:
        while True:
            blk = src.next_block()
            if blk is None:
                break
            i_p, q_p = blk
            audio, state, taps = chain(state, i=i_p[None], q=q_p[None])
            sc_out, sc_state = scope.process(sc_params, sc_state,
                                             taps["spectrum_iq"])
            if decoder is not None and "audio_dec" in taps:
                decoder[0](taps["audio_dec"])
            out.push(audio[0])
            nblocks += 1
            if args.max_blocks and nblocks >= args.max_blocks:
                break
    audio = out.result()
    if args.out:
        ingest.write_audio_wav(args.out, audio)
    dbm = snap = None
    if nblocks:
        dbm, snap = (float(v) for v in torch.stack(
            [sc_out["dbm"][0], sc_out["snap_freq"][0]]).cpu().numpy())
    metrics = {
        "blocks": nblocks,
        "samples": int(audio.size),
        "audio_rms": float(np.sqrt(np.mean(audio ** 2))) if audio.size else 0,
        "dbm": dbm,
        "snap_freq_hz": snap,
    }
    if decoder is not None:
        metrics["text"] = decoder[1]()
    print(json.dumps(metrics))
    return 0


def cmd_channelize(args) -> int:
    """Split a WIDEBAND IQ capture (fs = channels * 48 kHz) into per-
    channel demodulated audio via the polyphase channelizer front end
    (`ops/channelizer.AnalysisPfb` + `parallel/fleet.WidebandFleet`)."""
    import torch

    from .chain import rx
    from .io import ingest
    from .parallel import fleet

    M = args.channels
    cfg = rx.RxConfig(mode=args.mode, bw_key=args.bw,
                      path_name=args.path or None,
                      translate_hz=args.translate,
                      agc_mode=args.agc, block_len=args.block)
    wf = fleet.WidebandFleet([cfg], [M], taps_per_branch=args.taps,
                             device=args.device)

    # streaming metrics (running per-channel sum of squares, on the
    # device) so captures of any length run in bounded memory; audio is
    # only accumulated when an output file was requested
    chunks = _DeviceAudio()
    sumsq = torch.zeros(M, dtype=torch.float64, device=wf.device)
    nsamp = 0
    nblocks = 0
    with ingest.IqIngest(args.input, wf.wideband_block) as src:
        while True:
            blk = src.next_block()
            if blk is None:
                break
            i_p, q_p = (torch.from_numpy(p).to(wf.device) for p in blk)
            audio_blk = torch.cat(wf.process_block_device(i_p, q_p))
            sumsq += audio_blk.to(torch.float64).square().sum(-1)
            nsamp += audio_blk.shape[-1]
            if args.out:
                chunks.push(audio_blk if args.channel < 0
                            else audio_blk[args.channel])
            nblocks += 1
            if args.max_blocks and nblocks >= args.max_blocks:
                break
    if args.out:
        audio = chunks.result()
        if not audio.size and args.channel < 0:
            audio = np.zeros((M, 0), np.float32)
        if args.channel >= 0:
            ingest.write_audio_wav(args.out, audio)
        else:
            np.save(args.out, audio)
    rms = np.sqrt(sumsq.cpu().numpy() / max(nsamp, 1))
    print(json.dumps({
        "blocks": nblocks,
        "channels": M,
        "samples_per_channel": nsamp,
        "rms_max": float(rms.max()),
        "rms_argmax": int(rms.argmax()),
        "active_channels": int((rms > 0.05 * max(rms.max(), 1e-12)).sum()),
    }))
    return 0


def _read_speech(path: str) -> np.ndarray:
    """A WAV's first channel as f32 at full scale 1."""
    import wave
    with wave.open(path) as w:
        raw = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        if w.getnchannels() == 2:
            raw = raw[0::2]
        return raw.astype(np.float32) / 32768.0


def cmd_tx(args) -> int:
    import torch

    from .chain import tx
    from .io import ingest
    from .modems import cw_text

    fs = 48000
    if args.mode in ("freedv1600", "freedv700d"):
        # digital voice TX (`tx_processor.c:601-714` role): 48k speech ->
        # /6 on the card -> vocoder+FEC+modem -> 8k IQ -> x6 -> translated
        # 48k IQ out
        from .modems import freedv as fdv
        if args.audio_in:
            speech = _read_speech(args.audio_in)
        else:
            t = np.arange(fs * 2) / fs
            speech = (0.3 * (np.sin(2 * np.pi * 700 * t)
                             + np.sin(2 * np.pi * 1200 * t))
                      ).astype(np.float32)
        radio = fdv.FreeDvRadioMode(args.mode, 4800,
                                    translate_hz=args.translate,
                                    device=args.device)
        iqs = []
        n = (len(speech) // 4800) * 4800
        for k in range(0, n, 4800):
            iq = radio.tx_block(speech[k:k + 4800])
            if iq.size:
                iqs.append(iq)
        iq = (np.concatenate(iqs) if iqs
              else np.zeros(0, np.complex64)) * 0.5
        ingest.write_iq_wav(args.out, iq.astype(np.complex64))
        print(json.dumps({"samples": int(iq.size), "out": args.out,
                          "mode": args.mode}))
        return 0
    if args.mode == "cw":
        # the firmware text-keyer's exact envelope (block timing +
        # sm_table edges, CwGen_ProcessIambic — cw_text docstring)
        env = cw_text.text_to_keying_ref(args.text or "CQ TEST",
                                         int(args.wpm), fs)
        audio = env.astype(np.float32)
        cfg = tx.TxConfig(mode="cw", translate_hz=args.translate)
    elif args.mode == "rtty":
        # Baudot AFSK at 48k, sent through the USB voice chain
        # (TxProcessor_Rtty routes modem tones the same way, :811);
        # the tone is the firmware modulator's exact waveform
        # (rtty_text.gen_tx_tone_ref: table DDS, framing quirks and all)
        from .modems import rtty_text
        text = args.text or "CQ CQ DE UHSDR"
        n = (len(text) + 6) * int(8 * round(fs / 45.45))
        tone = rtty_text.gen_tx_tone_ref(text, n, fs=int(fs))
        audio = (0.5 / 32767.0) * tone.astype(np.float32)
        cfg = tx.TxConfig(mode="usb", translate_hz=args.translate,
                          compressor=False)
    elif args.mode == "psk":
        from .modems import psk_text
        text = args.text or "cq cq de uhsdr"
        # preamble (1 s) + ~12 bits/char + postamble (1 s)
        n = int(fs * 2.5) + len(text) * int(12 * round(fs / 31.25))
        tone = psk_text.gen_tx_tone_ref(text, n, fs=int(fs))
        audio = (0.5 / 32767.0) * tone.astype(np.float32)
        cfg = tx.TxConfig(mode="usb", translate_hz=args.translate,
                          compressor=False)
    else:
        if args.audio_in:
            audio = _read_speech(args.audio_in)
        else:
            t = np.arange(fs * 2) / fs
            audio = (0.5 * np.sin(2 * np.pi * 700 * t)).astype(np.float32)
        cfg = tx.TxConfig(mode=args.mode, translate_hz=args.translate)
    chain = tx.TxChain(cfg, device=args.device)
    state = chain.init_state((1,))
    B = 4096
    n = (len(audio) // B) * B
    iqs = _DeviceAudio()
    for k in range(0, n, B):
        i_p, q_p, state = chain(state, audio[None, k:k + B])
        iqs.push(torch.complex(i_p[0], q_p[0]))
    iq = iqs.result(np.complex64) * 0.5
    ingest.write_iq_wav(args.out, iq.astype(np.complex64))
    print(json.dumps({"samples": int(iq.size), "out": args.out}))
    return 0


def cmd_conformance(args) -> int:
    """Run the port's conformance tests on the CPU: its chains against
    the JAX package's on synthetic signals (`tests/test_torch_
    conformance*.py`; they import the JAX package, which must be
    installed beside the port)."""
    import subprocess
    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted(str(p.relative_to(root)) for p in
                   (root / "tests").glob("test_torch_conformance*.py"))
    if not files:
        print("no conformance tests under tests/", file=sys.stderr)
        return 2
    return subprocess.call([sys.executable, "-m", "pytest", *files, "-q",
                            "--no-header"], cwd=root)


def cmd_config(args) -> int:
    """Config inspection, persistence and remote backup/restore — the
    `support/python/uhsdr_tool.py` role (EEPROM backup over CAT)."""
    from .core import config as config_mod

    if args.action == "show":
        if args.file and os.path.exists(args.file):
            cfg = config_mod.Config.load(args.file)
        else:
            cfg = config_mod.Config()
        print(json.dumps(cfg.to_dict(), indent=2, sort_keys=True))
        return 0
    if args.action == "save":
        cfg = config_mod.Config()
        for kv in args.set or []:
            k, v = kv.split("=", 1)
            entry = config_mod.entry_by_name(k)
            if entry is None:
                print(f"unknown config entry: {k}", file=sys.stderr)
                return 1
            cfg.set(k, entry.typ(v) if entry.typ is not str else v)
        cfg.save(args.file)
        print(json.dumps({"saved": args.file,
                          "entries": len(cfg.to_dict())}))
        return 0
    # remote backup/restore over the CAT TCP transport
    from .control import cat as cat_mod
    client = cat_mod.CatClient(host=args.host, port=args.port)
    if args.action == "backup":
        values = client.backup_config(args.file)
        print(json.dumps({"backed_up": args.file, "entries": len(values)}))
    else:
        client.restore_config(args.file)
        print(json.dumps({"restored": args.file}))
    return 0


def cmd_serve(args) -> int:
    """Run the live radio (`control/server.py`): stream an IQ capture
    through the RX chain forever under CAT control — the `mchfMain`
    main-loop role (`src/uhsdr_main.c:388-494`)."""
    import time as time_mod

    from .control import server as server_mod

    cfg = server_mod.ServeConfig(
        iq_path=args.input, center_hz=args.center, block_len=args.block,
        mode=args.mode, bw_key=args.bw, translate_hz=args.translate,
        agc_mode=args.agc, dial_hz=args.dial, loop=not args.no_loop,
        realtime=args.realtime, audio_out=args.audio_out,
        nr_enable=args.nr, notch_enable=args.notch, device=args.device)
    radio, catsrv = server_mod.serve(cfg, host=args.host, port=args.port)
    print(json.dumps({"cat_port": catsrv.port, "center_hz": args.center,
                      "dial_hz": radio.dial_hz, "mode": radio.mode}),
          flush=True)
    try:
        while not radio._stop.is_set():
            time_mod.sleep(args.status_every)
            print(json.dumps({
                "blocks": radio.blocks_processed,
                "tx_blocks": radio.tx_blocks_processed,
                "dial_hz": radio.dial_hz, "mode": radio.mode,
                "ptt": radio.ptt, "s_meter": round(radio.s_meter, 2),
                "dbm": round(radio.dbm, 1),
                "snap_hz": round(radio.snap_freq_hz, 1),
                "fwd_pwr_w": round(radio.fwd_pwr, 2)}), flush=True)
            if args.max_blocks and radio.blocks_processed >= args.max_blocks:
                break
    except KeyboardInterrupt:
        pass
    finally:
        radio.stop()
        catsrv.stop()
    if radio.error:
        print(json.dumps({"error": radio.error}), file=sys.stderr)
        return 1
    return 0


def _device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device the chains run on (cuda; cpu runs "
                        "the kernels' plain torch versions)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="uhsdr_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    rxp = sub.add_parser("rx", help="demodulate an IQ capture")
    rxp.add_argument("--input", required=True)
    rxp.add_argument("--out", default="")
    rxp.add_argument("--mode", default="usb",
                     choices=["usb", "lsb", "cw", "am", "sam", "fm",
                              "rtty", "psk", "iq", "ssbstereo", "samstereo",
                              "freedv1600", "freedv700d"])
    rxp.add_argument("--decode", action="store_true",
                     help="run the digital text decoder (cw/rtty/psk)")
    rxp.add_argument("--bw", default="2P3KHZ")
    rxp.add_argument("--path", default="")
    rxp.add_argument("--translate", type=float, default=6000.0)
    rxp.add_argument("--agc", default="med")
    rxp.add_argument("--nr", action="store_true")
    rxp.add_argument("--notch", action="store_true")
    rxp.add_argument("--block", type=int, default=4096)
    rxp.add_argument("--raw-i16", action="store_true",
                     help="keep the capture's int16 samples unconverted "
                          "through the native ring and front kernel")
    rxp.add_argument("--max-blocks", type=int, default=0)
    _device_arg(rxp)
    rxp.set_defaults(fn=cmd_rx)

    chp = sub.add_parser("channelize", help="split a wideband IQ capture "
                         "(fs = channels x 48 kHz) into demodulated "
                         "per-channel audio")
    chp.add_argument("--input", required=True, help="wideband IQ capture")
    chp.add_argument("--channels", type=int, required=True,
                     help="number of 48 kHz channels (= decimation M)")
    chp.add_argument("--out", default="", help=".wav (with --channel) or "
                     ".npy of (channels, samples) audio")
    chp.add_argument("--channel", type=int, default=-1,
                     help="write only this channel as WAV")
    chp.add_argument("--mode", default="usb",
                     choices=["usb", "lsb", "cw", "am", "sam", "fm"])
    chp.add_argument("--bw", default="2P3KHZ")
    chp.add_argument("--path", default="")
    chp.add_argument("--translate", type=float, default=6000.0)
    chp.add_argument("--agc", default="med")
    chp.add_argument("--taps", type=int, default=12,
                     help="prototype taps per polyphase branch")
    chp.add_argument("--block", type=int, default=4096,
                     help="per-channel block length")
    chp.add_argument("--max-blocks", type=int, default=0)
    _device_arg(chp)
    chp.set_defaults(fn=cmd_channelize)

    txp = sub.add_parser("tx", help="modulate to an IQ capture")
    txp.add_argument("--out", required=True)
    txp.add_argument("--mode", default="usb",
                     choices=["usb", "lsb", "am", "fm", "cw", "rtty",
                              "psk", "freedv1600", "freedv700d"])
    txp.add_argument("--text", default="")
    txp.add_argument("--wpm", type=float, default=20.0)
    txp.add_argument("--audio-in", default="")
    txp.add_argument("--translate", type=float, default=6000.0)
    _device_arg(txp)
    txp.set_defaults(fn=cmd_tx)

    cp = sub.add_parser("conformance", help="run conformance checks")
    cp.set_defaults(fn=cmd_conformance)

    sv = sub.add_parser("serve", help="live CAT-controlled radio on an "
                        "IQ capture (main-loop role)")
    sv.add_argument("--input", required=True, help="IQ capture (wav/raw)")
    sv.add_argument("--center", type=float, default=14_001_000.0,
                    help="RF frequency of the capture center, Hz")
    sv.add_argument("--dial", type=int, default=0,
                    help="initial dial frequency (0 = capture center)")
    sv.add_argument("--mode", default="usb",
                    choices=["usb", "lsb", "cw", "am", "sam", "fm",
                             "freedv1600", "freedv700d"])
    sv.add_argument("--bw", default="2P3KHZ")
    sv.add_argument("--translate", type=float, default=6000.0)
    sv.add_argument("--agc", default="med")
    sv.add_argument("--nr", action="store_true")
    sv.add_argument("--notch", action="store_true")
    sv.add_argument("--block", type=int, default=4096)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=7310)
    sv.add_argument("--audio-out", default="",
                    help="stream demod audio to this WAV via the native "
                    "sink (runtime/audio_sink.cpp)")
    sv.add_argument("--no-loop", action="store_true",
                    help="stop at capture end instead of wrapping")
    sv.add_argument("--realtime", action="store_true",
                    help="pace blocks at the sample rate")
    sv.add_argument("--status-every", type=float, default=2.0)
    sv.add_argument("--max-blocks", type=int, default=0)
    _device_arg(sv)
    sv.set_defaults(fn=cmd_serve)

    cfp = sub.add_parser("config",
                         help="config show/save + CAT backup/restore")
    cfp.add_argument("action", choices=["show", "save", "backup", "restore"])
    cfp.add_argument("--file", default="uhsdr_config.json")
    cfp.add_argument("--set", action="append", metavar="KEY=VALUE",
                     help="override entries when saving")
    cfp.add_argument("--host", default="127.0.0.1")
    cfp.add_argument("--port", type=int, default=7310)
    cfp.set_defaults(fn=cmd_config)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
