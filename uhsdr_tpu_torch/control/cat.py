"""CAT remote control — Yaesu FT-817 protocol with UHSDR extensions.

Reference: `drivers/cat/cat_driver.c` (`CatDriver_HandleProtocol:1325`,
dispatch `:1020-1324`, opcodes `:718-738`) — 5-byte frames (4 parameter
bytes + command), BCD frequency coding in 10 Hz units, plus the UHSDR
extension that maps FT-817 EEPROM addresses >= 0x8000 onto the 16-bit
config registry (the `uhsdr_tool.py` backup/restore path) and the 0x42
"UHSDR" identification opcode.

The reference speaks this over USB CDC; the framework exposes
the same frame protocol over a TCP socket (or in-process), driving the
control plane: dial frequency, demod mode, PTT (RX<->TX chain switch),
split/VFO, S-meter / power / SWR readback, and the config registry.

`CatClient` is the host-tool analog of `support/python/uhsdr.py`.

A copy of the JAX package's module of the same name (the port
imports nothing of that package): the same classes and decisions,
its imports re-pointed at the port's own modules.
"""
from __future__ import annotations

import json
import socket
import socketserver
import threading
from dataclasses import dataclass, field
from typing import Optional

from ..core import config as config_mod
from . import radio as radio_mod

# FT-817 opcodes (cat_driver.c:718-738)
SET_FREQ = 0x01
SPLIT_ON = 0x02
GET_FREQ = 0x03
MODE_SET = 0x07
PTT_ON = 0x08
PWR_ON = 0x0F
UHSDR_ID = 0x42
TOGGLE_VFO = 0x81
SPLIT_OFF = 0x82
PTT_OFF = 0x88
A7 = 0xA7
EEPROM_READ = 0xBB
EEPROM_WRITE = 0xBC
READ_TX_STATE = 0xBD
READ_RX_STATE = 0xE7
PTT_STATE = 0xF7
NOOP = 0xFF

# FT-817 mode codes <-> framework modes (cat_driver.c:1095-1165)
_MODE_TO_CODE = {"lsb": 0, "usb": 1, "cw": 2, "am": 4, "sam": 4, "fm": 8}
_CODE_TO_MODE = {0: "lsb", 1: "usb", 2: "cw", 3: "cw", 4: "am",
                 8: "fm", 0x88: "fm", 0x0A: "usb", 0x0C: "fm"}

FT817_EEPROM_TOP = 0x1925


@dataclass
class Radio:
    """The control-plane state a CAT session manipulates (the `ts.*`
    subset the reference protocol touches)."""
    dial_hz: int = 14_074_000
    mode: str = "usb"
    cw_lsb: bool = False
    fm_dev5khz: bool = True
    ptt: bool = False
    split: bool = False
    vfo_b: bool = False
    tx_disabled: bool = False
    s_meter: float = 0.0           # S-units (0..~9+)
    fwd_pwr: float = 0.0           # W
    vswr: float = 1.0
    config: config_mod.Config = field(default_factory=config_mod.Config)
    # FT-817 EEPROM emulation image (sparse)
    _ft817_eeprom: dict = field(default_factory=dict)

    # hooks the runtime installs (chain switch, retune)
    def on_ptt(self, active: bool) -> None:
        pass

    def on_tune(self, dial_hz: int) -> None:
        pass

    def on_mode(self, mode: str) -> None:
        pass


def _bcd_freq_decode(req: bytes) -> int:
    """4 BCD bytes, 10 Hz units (cat_driver.c:1047-1053)."""
    f = 0
    for b in req[:4]:
        f = f * 100 + (b >> 4) * 10 + (b & 0x0F)
    return f * 10


def _bcd_freq_encode(freq_hz: int) -> bytes:
    f = (freq_hz + 5) // 10
    digits = []
    for _ in range(8):
        digits.append(f % 10)
        f //= 10
    digits.reverse()
    out = bytearray(4)
    for i in range(4):
        out[i] = (digits[2 * i] << 4) | digits[2 * i + 1]
    return bytes(out)


def _limit4(x: float) -> int:
    return max(0, min(15, int(round(x))))


class CatProtocol:
    """Stateless-per-frame FT-817 command processor over a Radio."""

    def __init__(self, radio: Radio):
        self.radio = radio

    def handle_frame(self, frame: bytes) -> bytes:
        assert len(frame) == 5
        req, cmd = frame[:4], frame[4]
        r = self.radio

        if cmd == SET_FREQ:
            r.dial_hz = _bcd_freq_decode(req)
            r.on_tune(r.dial_hz)
            return b"\x00"
        if cmd == GET_FREQ:
            mode_code = _MODE_TO_CODE.get(r.mode, 1)
            if r.mode == "cw" and r.cw_lsb:
                mode_code = 3
            return _bcd_freq_encode(r.dial_hz) + bytes([mode_code])
        if cmd == MODE_SET:
            code = req[0]
            if code not in _CODE_TO_MODE:
                return b"\xFF"
            r.mode = _CODE_TO_MODE[code]
            r.cw_lsb = code in (2, 3)      # fork sets CW-L on CAT (":1137")
            if code == 8:
                r.fm_dev5khz = True
            elif code == 0x88:
                r.fm_dev5khz = False
            r.on_mode(r.mode)
            return b"\x00"
        if cmd == PTT_ON:
            was = r.ptt
            r.ptt = True
            r.on_ptt(True)
            return b"\xF0" if was else b"\x00"
        if cmd == PTT_OFF:
            was = r.ptt
            r.ptt = False
            r.on_ptt(False)
            return b"\x00" if was else b"\xF0"
        if cmd == SPLIT_ON:
            r.split = True
            return b"\x00"
        if cmd == SPLIT_OFF:
            r.split = False
            return b"\x00"
        if cmd == TOGGLE_VFO:
            r.vfo_b = not r.vfo_b
            return b"\x00"
        if cmd == PWR_ON:
            return b"\x00"
        if cmd == A7:
            return bytes([0xA7, 0x02, 0x00, 0x04, 0x67, 0xD8, 0xBF,
                          0xD8, 0xBF])
        if cmd == READ_RX_STATE:
            return bytes([max(0, min(255, int(round(r.s_meter * 0.5 * 2))))])
        if cmd == READ_TX_STATE:
            if r.tx_disabled or not r.ptt:
                return b"\x00"
            return bytes([(_limit4(r.fwd_pwr) << 4) | _limit4(r.vswr), 0x00])
        if cmd == PTT_STATE:
            if r.tx_disabled:
                return b"\xFF"
            if not r.ptt:
                return b"\x80"
            st = _limit4(r.fwd_pwr)
            if r.split:
                st |= 0x20
            if r.vswr > 3.0:
                st |= 0x40
            return bytes([st])
        if cmd == EEPROM_READ:
            addr = (req[0] << 8) | req[1]
            if addr < FT817_EEPROM_TOP:
                b0 = r._ft817_eeprom.get(addr, 0)
                b1 = r._ft817_eeprom.get(addr + 1, 0)
                return bytes([b0, b1])
            if addr > 0x7FFF:
                val = self._config_read(addr & 0x7FFF)
                return bytes([val & 0xFF, (val >> 8) & 0xFF])
            return b"\x00"
        if cmd == EEPROM_WRITE:
            addr = (req[0] << 8) | req[1]
            if addr < FT817_EEPROM_TOP:
                r._ft817_eeprom[addr] = req[2]
                r._ft817_eeprom[addr + 1] = req[3]
            elif addr > 0x7FFF:
                self._config_write(addr & 0x7FFF, req[2] | (req[3] << 8))
            return b"\x00"
        if cmd == UHSDR_ID:
            return b"UHSDR"
        if cmd == NOOP:
            return b""
        return b"\xFF"   # unknown

    # --- config registry via 16-bit variable ids (uhsdr extension) ---
    def _config_read(self, var_id: int) -> int:
        entry = config_mod.entry_by_id(var_id)
        if entry is not None:
            return entry.cat_encode(self.radio.config.get(entry.name))
        # band/VFO memory words (EEPROM_BAND0_MODE/FREQ_* id ranges,
        # ui_configuration.c:920-923)
        word = self.radio.config.band_memory.read_word(var_id)
        return word if word is not None else 0

    def _config_write(self, var_id: int, value: int) -> None:
        entry = config_mod.entry_by_id(var_id)
        if entry is not None:
            self.radio.config.set(entry.name, entry.cat_decode(value))
            return
        self.radio.config.band_memory.write_word(var_id, value)


class _CatTcpHandler(socketserver.BaseRequestHandler):
    def handle(self):
        proto: CatProtocol = self.server.protocol    # type: ignore
        buf = b""
        while True:
            data = self.request.recv(256)
            if not data:
                break
            buf += data
            while len(buf) >= 5:
                frame, buf = buf[:5], buf[5:]
                resp = proto.handle_frame(frame)
                if resp:
                    self.request.sendall(resp)


class CatServer:
    """TCP CAT server (the USB-CDC transport analog)."""

    def __init__(self, radio: Radio, host: str = "127.0.0.1", port: int = 0):
        self.protocol = CatProtocol(radio)
        self._srv = socketserver.ThreadingTCPServer((host, port),
                                                    _CatTcpHandler)
        self._srv.daemon_threads = True
        self._srv.protocol = self.protocol           # type: ignore
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()


class CatClient:
    """Host-side CAT client (`support/python/uhsdr.py` analog)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7310,
                 sock: Optional[socket.socket] = None):
        self.sock = sock or socket.create_connection((host, port), timeout=5)

    def _cmd(self, cmd: int, p=(0, 0, 0, 0), resp_len: int = 1) -> bytes:
        self.sock.sendall(bytes([*p, cmd]))
        out = b""
        while len(out) < resp_len:
            chunk = self.sock.recv(resp_len - len(out))
            if not chunk:
                break
            out += chunk
        return out

    def set_frequency(self, freq_hz: int) -> None:
        self._cmd(SET_FREQ, _bcd_freq_encode(freq_hz))

    def get_frequency(self) -> tuple[int, str]:
        resp = self._cmd(GET_FREQ, resp_len=5)
        freq = _bcd_freq_decode(resp)
        mode = {0: "lsb", 1: "usb", 2: "cw", 3: "cw", 4: "am",
                8: "fm"}.get(resp[4], "usb")
        return freq, mode

    def set_mode(self, mode: str, cw_reverse: bool = False) -> bool:
        code = {"lsb": 0, "usb": 1, "cw": 3 if cw_reverse else 2,
                "am": 4, "sam": 4, "fm": 8, "fmn": 0x88}[mode]
        return self._cmd(MODE_SET, (code, 0, 0, 0)) == b"\x00"

    def ptt(self, active: bool) -> None:
        self._cmd(PTT_ON if active else PTT_OFF)

    def identify(self) -> bool:
        return self._cmd(UHSDR_ID, resp_len=5) == b"UHSDR"

    def read_config(self, var_id: int) -> int:
        resp = self._cmd(EEPROM_READ,
                         (0x80 | (var_id >> 8), var_id & 0xFF, 0, 0),
                         resp_len=2)
        return resp[0] | (resp[1] << 8)

    def write_config(self, var_id: int, value: int) -> None:
        self._cmd(EEPROM_WRITE, (0x80 | (var_id >> 8), var_id & 0xFF,
                                 value & 0xFF, (value >> 8) & 0xFF))

    # --- uhsdr_tool.py analog: whole-config backup/restore ---
    def _band_memory_ids(self):
        bm = config_mod.BandMemories
        for base in bm.IDS.values():
            for i in range(bm.NUM_BANDS):
                yield base + i

    def backup_config(self, path: str) -> dict:
        data = {}
        for entry in config_mod.REGISTRY:
            data[entry.name] = self.read_config(entry.eeprom_id)
        # band/VFO memories cloned as raw words by EEPROM id
        data["__band_memory__"] = {
            str(vid): self.read_config(vid)
            for vid in self._band_memory_ids()}
        with open(path, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        return data

    def restore_config(self, path: str) -> None:
        with open(path) as f:
            data = json.load(f)
        by_name = {e.name: e for e in config_mod.REGISTRY}
        for name, value in data.items():
            if name == "__band_memory__":
                for vid, word in value.items():
                    self.write_config(int(vid), int(word))
            elif name in by_name:
                self.write_config(by_name[name].eeprom_id, int(value))

    def close(self):
        self.sock.close()
