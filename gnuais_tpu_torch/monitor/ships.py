"""Ship table + !AIVDM stream consumption — the gnuaisgui data layer.

Re-derivation of the reference GUI's consumer logic (src/gui/gui.c):

 - sentence scan for '!AIVDM' in a byte stream (gui.c:395-405);
 - multipart reassembly keyed on the sentence-number sequence
   (gui.c:407-434: part n is only accepted right after part n-1;
   part 1 resets the payload accumulator);
 - 6-bit payload re-expansion (aisdecode, gui.c:187-230);
 - position/static decode for types 1-5 (gui.c:97-182) — note the GUI
   decodes independently from the receiver and keeps its own quirks
   (type 4 latitude is NOT sign-extended there, gui.c:137-140; we keep
   the correct sign handling of the main parser and document the
   difference);
 - bounded ship table (MAXSHIPS=1000) updated for types 1-4
   (updateship, gui.c:298-329).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

import numpy as np

from gnuais_tpu_torch.ais import parser as parser_mod
from gnuais_tpu_torch.ais.bits import pad_payload

MAXSHIPS = 1000


@dataclass
class Ship:
    mmsi: int
    latitude: float = 0.0
    longitude: float = 0.0
    heading: float = 0.0
    course: float = 0.0
    speed: float = 0.0
    type: int = 0
    name: str = ""
    destination: str = ""
    last_seen: float = 0.0


def payload_chars_to_bits(payload: str) -> np.ndarray:
    """AIVDM payload chars -> bit array (inverse of the NMEA 6-bit
    encoding; aisdecode semantics, gui.c:199-212)."""
    bits = np.zeros(len(payload) * 6, dtype=np.uint8)
    for i, ch in enumerate(payload):
        v = ord(ch)
        v = v - 48 if v <= 87 else v - 56
        for k in range(6):
            bits[i * 6 + k] = (v >> (5 - k)) & 1
    return bits


class AivdmAssembler:
    """Streaming !AIVDM scanner + multipart reassembler.

    Feed raw socket bytes; yields complete payload bit arrays.  Follows
    the reference GUI's acceptance rule: a part is only chained when it
    directly follows its predecessor.
    """

    def __init__(self) -> None:
        self._pending = ""
        self._prev_part = 0
        self._letters = ""

    def feed(self, data: bytes) -> List[np.ndarray]:
        out: List[np.ndarray] = []
        text = self._pending + data.decode("ascii", errors="replace")
        # sentences start with '!'; split keeps stream robustness
        parts = text.split("!")
        # the final piece may be incomplete; keep it pending unless it
        # looks terminated (checksum present)
        self._pending = ""
        for i, p in enumerate(parts):
            if not p:
                continue
            if i == len(parts) - 1 and "*" not in p:
                self._pending = "!" + p
                break
            sentence = "!" + p
            bits = self._handle_sentence(sentence)
            if bits is not None:
                out.append(bits)
        return out

    def _handle_sentence(self, s: str) -> Optional[np.ndarray]:
        if not s.startswith("!AIVDM"):
            return None
        fields = s.split(",")
        if len(fields) < 7:
            return None
        try:
            sentences = int(fields[1])
            sentencenum = int(fields[2])
        except ValueError:
            return None
        payload = fields[5]
        if sentencenum > 1 and self._prev_part != sentencenum - 1:
            self._prev_part = sentencenum
            return None
        if sentencenum == 1:
            self._letters = ""
        self._letters += payload
        self._prev_part = sentencenum
        if sentencenum >= sentences:
            return payload_chars_to_bits(self._letters)
        return None


class ShipTable:
    """Bounded latest-state ship table fed by payload bits."""

    def __init__(self, max_ships: int = MAXSHIPS):
        self.max_ships = max_ships
        self.ships: Dict[int, Ship] = {}
        self.dropped = 0

    def update_from_bits(self, bits: np.ndarray) -> Optional[Ship]:
        rb = pad_payload(bits)
        msg = parser_mod.parse(rb, len(bits))
        if msg is None:
            return None
        ship = self.ships.get(msg.mmsi)
        if ship is None:
            if len(self.ships) >= self.max_ships:
                self.dropped += 1
                return None
            ship = Ship(mmsi=msg.mmsi)
            self.ships[msg.mmsi] = ship
        ship.type = msg.type
        ship.last_seen = time.time()
        for ev in msg.events:
            d = ev.data
            if ev.kind in ("position", "basestation"):
                ship.latitude = d["lat"]
                ship.longitude = d["lon"]
                if ev.kind == "position":
                    ship.heading = float(d["heading"])
                    ship.course = d["course"]
                    ship.speed = d["sog"]
            elif ev.kind in ("vesseldata", "vesselname"):
                ship.name = d.get("name", ship.name)
                ship.destination = d.get("destination", ship.destination)
        return ship

    def render_text(self, limit: int = 30) -> str:
        """Terminal rendering (the map-widget stand-in)."""
        rows = sorted(self.ships.values(), key=lambda s: -s.last_seen)
        lines = [f"{'MMSI':>10} {'TYPE':>4} {'LAT':>11} {'LON':>12} "
                 f"{'SOG':>5} {'COG':>6} {'NAME':<20} DEST"]
        for s in rows[:limit]:
            lines.append(
                f"{s.mmsi:>10} {s.type:>4} {s.latitude:>11.6f} "
                f"{s.longitude:>12.6f} {s.speed:>5.1f} {s.course:>6.1f} "
                f"{s.name:<20.20} {s.destination}")
        return "\n".join(lines)


def monitor_socket(path: str = "/tmp/gnuais.socket",
                   duration: Optional[float] = None,
                   render_every: float = 2.0) -> ShipTable:
    """Connect to the receiver's NMEA socket and track ships (the
    headless gnuaisgui main loop)."""
    import socket as socket_mod
    table = ShipTable()
    asm = AivdmAssembler()
    t0 = time.time()
    s = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
    s.connect(path)
    s.settimeout(0.5)
    last_render = 0.0
    try:
        while duration is None or time.time() - t0 < duration:
            try:
                data = s.recv(4096)
            except socket_mod.timeout:
                continue
            if not data:
                break
            for bits in asm.feed(data):
                table.update_from_bits(bits)
            now = time.time()
            if now - last_render >= render_every:
                last_render = now
                print("\033[2J\033[H" + table.render_text(), flush=True)
    finally:
        s.close()
    return table
