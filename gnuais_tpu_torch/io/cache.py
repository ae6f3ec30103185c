"""Per-MMSI vessel cache and JSON-AIS export.

Equivalent of the reference's splay-tree cache (cache.c) and the
60-second JSON-AIS uplink exporter (out_json.c), including:

 - swap-on-export rotation (cache_rotate, cache.c:143-157);
 - -1 sentinels for unset numeric fields (cache.c:184-194);
 - the vesseldatab/bb setters zeroing imo/draught (cache.c:290-330);
 - the JSON blob layout, field order, float formats and the
   got-position guard (out_json.c:211-338);
 - multipart/form-data POST with a "jsonais" field of content-type
   application/json (out_json.c:192-196).
"""

from __future__ import annotations

import logging
import threading
import time as time_mod
import urllib.request
import uuid
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional

from gnuais_tpu_torch.ais.parser import Event

log = logging.getLogger("gnuais")


@dataclass
class CacheEntry:
    mmsi: int = 0
    received_pos: int = 0
    received_data: int = 0
    received_persons: int = 0
    lat: float = 0.0
    lon: float = 0.0
    hdg: int = -1
    course: float = -1.0
    sog: float = -1.0
    navstat: int = -1
    rateofturn: int = 0
    imo: int = -1
    shiptype: int = -1
    callsign: Optional[str] = None
    name: Optional[str] = None
    destination: Optional[str] = None
    A: int = -1
    B: int = -1
    C: int = -1
    D: int = -1
    draught: float = 0.0
    persons_on_board: int = -1


class VesselCache:
    """Thread-safe latest-state store keyed by MMSI."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._map: Dict[int, CacheEntry] = {}

    def _get(self, mmsi: int) -> CacheEntry:
        e = self._map.get(mmsi)
        if e is None:
            e = CacheEntry()
            self._map[mmsi] = e
        return e

    def position(self, t: int, mmsi: int, navstat: int, lat: float,
                 lon: float, hdg: int, course: float, rateofturn: int,
                 sog: float) -> None:
        with self._lock:
            e = self._get(mmsi)
            e.mmsi = mmsi
            e.received_pos = t
            e.lat, e.lon = lat, lon
            e.hdg, e.course, e.sog, e.navstat = hdg, course, sog, navstat
            e.rateofturn = rateofturn

    def vesseldata(self, t: int, mmsi: int, imo: int, callsign: str,
                   name: str, destination: str, shiptype: int,
                   a: int, b: int, c: int, d: int, draught: float) -> None:
        with self._lock:
            e = self._get(mmsi)
            e.mmsi = mmsi
            e.imo = imo
            e.received_data = t
            e.callsign, e.name, e.destination = callsign, name, destination
            e.shiptype = shiptype
            e.A, e.B, e.C, e.D = a, b, c, d
            e.draught = draught

    def vesseldatab(self, t: int, mmsi: int, callsign: str, shiptype: int,
                    a: int, b: int, c: int, d: int) -> None:
        with self._lock:
            e = self._get(mmsi)
            e.mmsi = mmsi
            e.imo = 0       # quirk: type 24B overwrites imo with 0
            e.received_data = t
            e.callsign = callsign
            e.shiptype = shiptype
            e.A, e.B, e.C, e.D = a, b, c, d
            e.draught = 0.0  # quirk: and zeroes draught

    def vesseldatabb(self, t: int, mmsi: int, shiptype: int,
                     a: int, b: int, c: int, d: int) -> None:
        with self._lock:
            e = self._get(mmsi)
            e.mmsi = mmsi
            e.imo = 0
            e.received_data = t
            e.shiptype = shiptype
            e.A, e.B, e.C, e.D = a, b, c, d
            e.draught = 0.0

    def vesselname(self, t: int, mmsi: int, name: str,
                   destination: str) -> None:
        with self._lock:
            e = self._get(mmsi)
            e.mmsi = mmsi
            e.received_data = t
            e.name, e.destination = name, destination

    def vessel_persons(self, t: int, mmsi: int, persons: int) -> None:
        with self._lock:
            e = self._get(mmsi)
            e.mmsi = mmsi
            e.received_persons = t
            e.persons_on_board = persons

    def apply_event(self, ev: Event, received_t: int) -> None:
        """Route a parser sink event into the cache (the wiring done by
        the per-type decoders, protodec.c:390-776)."""
        d = ev.data
        if ev.kind == "position":
            self.position(received_t, ev.mmsi, d["navstat"], d["lat"],
                          d["lon"], d["heading"], d["course"],
                          d["rateofturn"], d["sog"])
        elif ev.kind == "basestation":
            self.position(received_t, ev.mmsi, 0, d["lat"], d["lon"],
                          0, 0.0, 0, 0.0)
        elif ev.kind == "vesseldata":
            self.vesseldata(received_t, ev.mmsi, d["imo"], d["callsign"],
                            d["name"], d["destination"], d["shiptype"],
                            d["A"], d["B"], d["C"], d["D"], d["draught"])
        elif ev.kind == "vesseldatab":
            self.vesseldatab(received_t, ev.mmsi, d["callsign"],
                             d["shiptype"], d["A"], d["B"], d["C"], d["D"])
        elif ev.kind == "vesseldatabb":
            self.vesseldatabb(received_t, ev.mmsi, d["shiptype"],
                              d["A"], d["B"], d["C"], d["D"])
        elif ev.kind == "vesselname":
            self.vesselname(received_t, ev.mmsi, d["name"], d["destination"])
        elif ev.kind == "persons":
            self.vessel_persons(received_t, ev.mmsi, d["persons"])

    def rotate(self) -> Dict[int, CacheEntry]:
        """Atomically swap in a fresh map; the old one goes to the
        exporter (cache_rotate semantics)."""
        with self._lock:
            old = self._map
            self._map = {}
        return old


def time_jsonais(t: int) -> str:
    """UTC YYYYMMDDHHMMSS (out_json.c:150-180)."""
    return time_mod.strftime("%Y%m%d%H%M%S", time_mod.gmtime(t))


def _f32(v: float) -> float:
    """The reference cache stores floats as C float (cache.h:33-37);
    printf then prints the float32-rounded value (60.15 -> 60.1500015
    at %.7f).  Reproduce that storage rounding."""
    import struct
    return struct.unpack("f", struct.pack("f", v))[0]


def export_json(entries: Dict[int, CacheEntry], mycall: str,
                now: Optional[int] = None) -> tuple[str, int]:
    """Build the JSON-AIS blob; returns (json, exported_count).

    Field order, separators and printf formats mirror jsonout_export
    (out_json.c:226-338) — byte-verified against the real reference
    exporter + libcurl POST path by tests/test_uplink_oracle.py.
    Iteration is ascending MMSI (the reference walks its key-ordered
    splay tree).  String presence follows C pointer semantics: an empty
    string is still set (prints ``"destination": ""``), only never-set
    fields (None) are omitted.
    """
    now = int(now if now is not None else time_mod.time())
    parts: List[str] = []
    parts.append(
        "{\n"
        "\t\"protocol\": \"jsonais\",\n"
        f"\t\"encodetime\": \"{time_jsonais(now)}\",\n"
        "\t\"groups\": [\n"
        "\t\t{\n"
        f"\t\t\t\"path\": [ {{ \"name\": \"{mycall}\" }} ],\n"
        "\t\t\t\"msgs\": [\n"
    )
    exported = 0

    def sep() -> str:
        return "" if exported == 0 else ",\n"

    for mmsi in sorted(entries):
        e = entries[mmsi]
        got_pos = ((e.lat > 0.0001 or e.lat < -0.0001)
                   and (e.lon > 0.0001 or e.lon < -0.0001))
        if e.mmsi and got_pos:
            s = (f"{sep()}{{\"msgtype\": 3, \"mmsi\": {e.mmsi}, "
                 f"\"rxtime\": \"{time_jsonais(e.received_pos)}\"")
            s += f", \"lat\": {_f32(e.lat):.7f}, \"lon\": {_f32(e.lon):.7f}"
            if e.course >= 0:
                s += f", \"course\": {_f32(e.course):.1f}"
            if e.hdg >= 0:
                s += f", \"heading\": {e.hdg}"
            if e.sog >= 0:
                s += f", \"speed\": {_f32(e.sog):.1f}"
            if e.navstat >= 0:
                s += f", \"status\": {e.navstat}"
            s += "}"
            parts.append(s)
            exported += 1
        if e.mmsi and e.name is not None:
            s = (f"{sep()}{{\"msgtype\": 5, \"mmsi\": {e.mmsi}, "
                 f"\"rxtime\": \"{time_jsonais(e.received_data)}\"")
            if e.imo >= 0:
                s += f", \"imo\": {e.imo}"
            if e.shiptype >= 0:
                s += f", \"shiptype\": {e.shiptype}"
            if e.callsign is not None:
                s += f", \"callsign\": \"{e.callsign}\""
            s += f", \"shipname\": \"{e.name}\""
            if e.destination is not None:
                s += f", \"destination\": \"{e.destination}\""
            if e.A >= 0 and e.B >= 0:
                s += f", \"length\": {e.A + e.B}, \"ref_front\": {e.A}"
            if e.draught >= 0:
                s += f", \"draught\": {_f32(e.draught):.1f}"
            if e.C >= 0 and e.D >= 0:
                s += f", \"width\": {e.C + e.D}, \"ref_left\": {e.C}"
            s += "}"
            parts.append(s)
            exported += 1
        if e.persons_on_board >= 0:
            parts.append(
                f"{sep()}{{\"msgtype\": 8, \"mmsi\": {e.mmsi}, "
                f"\"persons_on_board\": {e.persons_on_board}, "
                f"\"rxtime\": \"{time_jsonais(e.received_persons)}\"}}")
            exported += 1

    parts.append(
        "\n\n"
        "\t\t\t]\n"
        "\t\t}\n"
        "\t]\n"
        "}\n"
    )
    return "".join(parts), exported


def post_json(url: str, json_blob: str, timeout: float = 30.0) -> int:
    """Multipart POST of the blob as field "jsonais"
    (application/json), like the reference's libcurl form post."""
    boundary = uuid.uuid4().hex
    body = (
        f"--{boundary}\r\n"
        "Content-Disposition: form-data; name=\"jsonais\"\r\n"
        "Content-Type: application/json\r\n\r\n"
        f"{json_blob}\r\n"
        f"--{boundary}--\r\n"
    ).encode()
    req = urllib.request.Request(
        url, data=body,
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.status != 200:
            # jsonout_post_single: non-200 is an error, logged, and the
            # exporter carries on (out_json.c:135-140)
            raise RuntimeError(f"server for {url} returned {resp.status}")
        return resp.status


class JsonExporter:
    """Background 60 s exporter thread (jsonout_thread semantics:
    rotate, build, POST to every configured uplink)."""

    def __init__(self, cache: VesselCache, urls: List[str], mycall: str,
                 interval: float = 60.0, post_fn=post_json):
        self.cache = cache
        self.urls = urls
        self.mycall = mycall
        self.interval = interval
        self.post_fn = post_fn
        self._die = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # observability: consecutive POST failures per uplink URL (the
        # reference hlogs every curl/HTTP failure and carries on,
        # out_json.c:118-140 — silence here would hide a dead uplink)
        self.consecutive_failures: Dict[str, int] = {u: 0 for u in urls}

    def export_once(self, now: Optional[int] = None) -> Optional[str]:
        entries = self.cache.rotate()
        blob, exported = export_json(entries, self.mycall, now)
        if exported:
            for url in self.urls:
                try:
                    self.post_fn(url, blob)
                    self.consecutive_failures[url] = 0
                except Exception as e:
                    n = self.consecutive_failures.get(url, 0) + 1
                    self.consecutive_failures[url] = n
                    # log-and-carry-on per jsonout_post_single
                    log.error("JSON AIS export to %s failed: %s "
                              "(%d consecutive)", url, e, n)
            return blob
        return None

    def _run(self) -> None:
        while not self._die.wait(self.interval):
            self.export_once()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._die.set()
        if self._thread:
            self._thread.join(timeout=5)
