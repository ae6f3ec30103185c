"""AIS payload field extraction, message types 1-24.

Produces (a) display text byte-identical to the reference decoder's
stdout (reference: protodec.c:357-776 per-type decoders, :896-986
dispatcher) and (b) structured events for the sink layer (cache, DB,
range statistics).

Formatting notes (all deliberately preserved from the reference,
including its quirks — they are part of the observable contract):
 - floats go through a float32 cast before the double divide that
   printf sees (e.g. ``(float) latitude / 600000.0``);
 - type 1/2/3 ``navstat`` reads only 2 bits at offset 38 (the ITU field
   is 4 bits — reference reads 2: protodec.c:374);
 - type 19 prints a double space before ``width`` (protodec.c:668);
 - the DAC=1 FI=11 weather offsets follow the reference's commented-out
   field chain exactly (protodec.c:286-318);
 - rate-of-turn is narrowed to a signed char (protodec.c:361,373).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np

from .bits import get_string, henten, signed
from .constants import MAX_AIS_PACKET_TYPE


def _f32(x: float) -> float:
    """C ``(float)`` cast: round to float32, return as Python float."""
    return float(np.float32(x))


def _fmt(x: float, prec: int) -> str:
    """C ``printf("%.Nf", (double)x)``."""
    return f"{x:.{prec}f}"


def _schar(v: int) -> int:
    """Narrow to signed char (C ``char`` on x86)."""
    v &= 0xFF
    return v - 256 if v >= 128 else v


# ---------------------------------------------------------------------------
# Structured events for sinks
# ---------------------------------------------------------------------------

@dataclass
class Event:
    """Base sink event; ``kind`` selects the payload fields in ``data``."""
    kind: str
    mmsi: int
    data: dict = field(default_factory=dict)


@dataclass
class ParsedMessage:
    type: int
    mmsi: int
    text: str               # the per-type field text (after "mmsi ...:")
    events: List[Event]


APPID_IFM = {
    0: "text-telegram", 1: "application-ack", 2: "iai-fi-capab-interrogation",
    3: "iai-capabi-interrogation", 4: "capability-reply", 11: "tide-weather",
    16: "vts-targets", 17: "ship-waypoints", 18: "advice-of-waypoints",
    19: "extended-ship-data", 20: "berthing-data", 21: "weather-obs-report",
    22: "area-notice-bc", 23: "area-notice-addr", 24: "extended-ship-static",
    25: "dangerous-cargo-info", 26: "environmental", 27: "route-info-bc",
    28: "route-info-addr", 29: "text-description-bc", 30: "text-description-addr",
    40: "persons-on-board",
}


def appid_ifm(i: int) -> str:
    return APPID_IFM.get(i, "unknown")


# ---------------------------------------------------------------------------
# Binary sub-messages (DAC=1)
# ---------------------------------------------------------------------------

def _msg_11(rb: np.ndarray, ms: int) -> str:
    # Offsets reproduce the reference's executed chain (protodec.c:286-318):
    # several fields in the ITU layout are skipped by commented-out code,
    # so later reads land at these exact (non-standard) positions.
    latitude = henten(ms, 24, rb)
    longitude = henten(ms + 24, 25, rb)
    wind_speed = henten(ms + 40, 7, rb)
    wind_gust = henten(ms + 47, 7, rb)
    wind_dir = henten(ms + 54, 9, rb)
    wind_gust_dir = henten(ms + 63, 9, rb)
    air_temp = henten(ms + 72, 11, rb)
    rel_humid = henten(ms + 83, 7, rb)
    dew_point = henten(ms + 90, 10, rb)
    air_press = henten(ms + 100, 9, rb) + 800
    air_press_tend = henten(ms + 109, 2, rb)
    horiz_visib_nm = henten(ms + 111, 8, rb)
    water_level = henten(ms + 119, 9, rb)
    wave_height = henten(ms + 124, 8, rb)
    water_temp = henten(ms + 128, 10, rb)
    return (
        f" lat {_fmt(_f32(latitude) / 60000.0, 6)}"
        f" lon {_fmt(_f32(longitude) / 60000.0, 6)}"
        f" wind_speed {wind_speed}kt wind_gust {wind_gust}kt"
        f" wind_dir {wind_dir} wind_gust_dir {wind_gust_dir}"
        f" air_temp {_fmt(_f32(air_temp) / 10.0 - 60.0, 1)}C"
        f" rel_humid {rel_humid}%"
        f" dew_point {_fmt(_f32(dew_point) / 10.0 - 20.0, 1)}C"
        f" pressure {air_press} pressure_tend {air_press_tend}"
        f" visib {_fmt(_f32(horiz_visib_nm) / 10.0, 1)}NM"
        f" water_level {_fmt(_f32(water_level) / 10.0 - 10.0, 1)}m"
        f" wave_height {_fmt(_f32(wave_height) / 10.0, 1)}m"
        f" water_temp {_fmt(_f32(water_temp) / 10.0 - 10.0, 1)}C"
    )


def _msg_40(rb: np.ndarray, ms: int, mmsi: int, events: List[Event]) -> str:
    people = henten(ms, 13, rb)
    events.append(Event("persons", mmsi, {"persons": people}))
    return f" persons-on-board {people}"


def _msg_bin(rb: np.ndarray, fi: int, ms: int, mmsi: int, events: List[Event]) -> str:
    if fi == 11:
        return _msg_11(rb, ms)
    if fi == 40:
        return _msg_40(rb, ms, mmsi, events)
    return ""


# ---------------------------------------------------------------------------
# Per-type decoders
# ---------------------------------------------------------------------------

def _pos_text(latitude: int, longitude: int, course: int, sog: int,
              rateofturn: int, navstat: int, heading: int) -> str:
    return (
        f" lat {_fmt(_f32(latitude) / 600000.0, 6)}"
        f" lon {_fmt(_f32(longitude) / 600000.0, 6)}"
        f" course {_fmt(_f32(course) / 10.0, 0)}"
        f" speed {_fmt(_f32(sog) / 10.0, 1)}"
        f" rateofturn {rateofturn} navstat {navstat} heading {heading}"
    )


def _decode_pos(rb, mmsi, events):
    # types 1/2/3 (protodec_pos, protodec.c:357-401)
    longitude = signed(henten(61, 28, rb), 28)
    latitude = signed(henten(89, 27, rb), 27)
    course = henten(116, 12, rb)
    sog = henten(50, 10, rb)
    rateofturn = _schar(henten(40, 8, rb))
    navstat = henten(38, 2, rb)  # 2-bit read, reference quirk
    heading = henten(128, 9, rb)
    lat = _f32(latitude) / 600000.0
    lon = _f32(longitude) / 600000.0
    events.append(Event("position", mmsi, {
        "navstat": navstat, "lat": lat, "lon": lon, "heading": heading,
        "course": _f32(course) / 10.0, "rateofturn": rateofturn,
        "sog": _f32(sog) / 10.0,
    }))
    return _pos_text(latitude, longitude, course, sog, rateofturn, navstat, heading)


def _decode_4(rb, mmsi, events):
    year = henten(40, 12, rb)
    month = henten(52, 4, rb)
    day = henten(56, 5, rb)
    hour = henten(61, 5, rb)
    minute = henten(66, 6, rb)
    second = henten(72, 6, rb)
    longitude = signed(henten(79, 28, rb), 28)
    latitude = signed(henten(107, 27, rb), 27)
    # display path stores into a float before printf (protodec.c:419-424)
    longit = _f32(_f32(longitude) / 10000.0 / 60.0)
    latit = _f32(_f32(latitude) / 10000.0 / 60.0)
    events.append(Event("basestation", mmsi, {
        "lat": _f32(latitude) / 600000.0, "lon": _f32(longitude) / 600000.0,
    }))
    return (
        f" date {year}-{month}-{day}"
        f" time {hour:02d}:{minute:02d}:{second:02d}"
        f" lat {_fmt(latit, 6)} lon {_fmt(longit, 6)}"
    )


def _decode_5(rb, mmsi, events):
    imo = henten(40, 30, rb)
    callsign = get_string(rb, 70, 6)
    name = get_string(rb, 112, 20)
    destination = get_string(rb, 302, 20)
    shiptype = henten(232, 8, rb)
    a = henten(240, 9, rb)
    b = henten(249, 9, rb)
    c = henten(258, 6, rb)
    d = henten(264, 6, rb)
    draught = henten(294, 8, rb)
    events.append(Event("vesseldata", mmsi, {
        "imo": imo, "callsign": callsign, "name": name,
        "destination": destination, "shiptype": shiptype,
        "A": a, "B": b, "C": c, "D": d, "draught": draught / 10.0,
    }))
    return (
        f" name \"{name}\" destination \"{destination}\""
        f" type {shiptype} length {a + b} width {c + d}"
        f" draught {_fmt(_f32(draught) / 10.0, 1)}"
    )


def _decode_6(rb, mmsi, events):
    sequence = henten(38, 2, rb)
    dst_mmsi = henten(40, 30, rb)
    retransmitted = henten(70, 1, rb)
    appid = henten(72, 16, rb)
    appid_dac = henten(72, 10, rb)
    appid_fi = henten(82, 6, rb)
    text = (
        f" dst_mmsi {dst_mmsi:09d} seq {sequence}"
        f" retransmitted {retransmitted} appid {appid}"
        f" app_dac {appid_dac} app_fi {appid_fi}"
    )
    if appid_dac == 1:
        text += f"({appid_ifm(appid_fi)})"
        text += _msg_bin(rb, appid_fi, 88, mmsi, events)
    return text


def _decode_7_13(rb, mmsi, events, bufferlen):
    pos = 40
    text = f" buflen {bufferlen} pos+32 {pos + 32}"
    i = 0
    while i < 4 and pos + 32 <= bufferlen:
        dst_mmsi = henten(pos, 30, rb)
        sequence = henten(pos + 30, 2, rb)
        text += f" ack {i + 1} (to {dst_mmsi:09d} seq {sequence})"
        i += 1
        pos += 32
    return text


def _decode_8(rb, mmsi, events):
    appid = henten(40, 16, rb)
    appid_dac = henten(40, 10, rb)
    appid_fi = henten(50, 6, rb)
    text = f" appid {appid} app_dac {appid_dac} app_fi {appid_fi}"
    if appid_dac == 1:
        text += f"({appid_ifm(appid_fi)})"
        text += _msg_bin(rb, appid_fi, 56, mmsi, events)
    return text


def _decode_18(rb, mmsi, events):
    longitude = signed(henten(57, 28, rb), 28)
    latitude = signed(henten(85, 27, rb), 27)
    course = henten(112, 12, rb)
    sog = henten(46, 10, rb)
    rateofturn = 0   # not in class B
    navstat = 15     # not in class B
    heading = henten(124, 9, rb)
    lat = _f32(latitude) / 600000.0
    lon = _f32(longitude) / 600000.0
    events.append(Event("position", mmsi, {
        "navstat": navstat, "lat": lat, "lon": lon, "heading": heading,
        "course": _f32(course) / 10.0, "rateofturn": rateofturn,
        "sog": _f32(sog) / 10.0,
    }))
    return _pos_text(latitude, longitude, course, sog, rateofturn, navstat, heading)


def _decode_19(rb, mmsi, events):
    name = get_string(rb, 143, 20)
    shiptype = henten(263, 8, rb)
    a = henten(271, 9, rb)
    b = henten(280, 9, rb)
    c = henten(289, 6, rb)
    d = henten(295, 6, rb)
    events.append(Event("vesselname", mmsi, {"name": name, "destination": "CLASS B"}))
    events.append(Event("vesseldatabb", mmsi, {"shiptype": shiptype, "A": a, "B": b, "C": c, "D": d}))
    # double space before "width" is in the reference format string
    return f" name \"{name}\" type {shiptype} length {a + b}  width {c + d}"


def _decode_20(rb, mmsi, events, bufferlen):
    pos = 40
    text = ""
    i = 0
    while i < 4 and pos + 30 < bufferlen:
        ofs = henten(pos, 12, rb)
        slots = henten(pos + 12, 4, rb)
        timeout = henten(pos + 16, 3, rb)
        incr = henten(pos + 19, 11, rb)
        text += f" reserve {i + 1} (ofs {ofs} slots {slots} timeout {timeout} incr {incr})"
        i += 1
        pos += 30
    return text


def _decode_24(rb, mmsi, events):
    partnr = henten(38, 2, rb)
    text = ""
    if partnr == 0:
        name = get_string(rb, 40, 20)
        text = f" name \"{name}\""
        events.append(Event("vesselname", mmsi, {"name": name, "destination": "CLASS B"}))
    if partnr == 1:
        callsign = get_string(rb, 90, 6)
        shiptype = henten(40, 8, rb)
        a = henten(132, 9, rb)
        b = henten(141, 9, rb)
        c = henten(150, 6, rb)
        d = henten(156, 6, rb)
        text = f" callsign \"{callsign}\" type {shiptype} length {a + b} width {c + d}"
        events.append(Event("vesseldatab", mmsi, {
            "callsign": callsign, "shiptype": shiptype, "A": a, "B": b, "C": c, "D": d,
        }))
    return text


def parse(rbuffer: np.ndarray, bufferlen: int) -> Optional[ParsedMessage]:
    """Extract fields from a CRC-verified payload.

    ``rbuffer`` is the MSB-first payload bit array zero-padded past
    ``bufferlen`` (already 6-bit padded — the dispatcher pads before the
    per-type decoders run, protodec.c:909-915).  Returns None for types
    outside 1..24 (the dispatcher drops those before any output,
    protodec.c:898-900).
    """
    msg_type = henten(0, 6, rbuffer)
    if msg_type < 1 or msg_type > MAX_AIS_PACKET_TYPE:
        return None
    mmsi = henten(8, 30, rbuffer)
    events: List[Event] = []

    if msg_type in (1, 2, 3):
        text = _decode_pos(rbuffer, mmsi, events)
    elif msg_type == 4:
        text = _decode_4(rbuffer, mmsi, events)
    elif msg_type == 5:
        text = _decode_5(rbuffer, mmsi, events)
    elif msg_type == 6:
        text = _decode_6(rbuffer, mmsi, events)
    elif msg_type in (7, 13):
        text = _decode_7_13(rbuffer, mmsi, events, bufferlen)
    elif msg_type == 8:
        text = _decode_8(rbuffer, mmsi, events)
    elif msg_type == 18:
        text = _decode_18(rbuffer, mmsi, events)
    elif msg_type == 19:
        text = _decode_19(rbuffer, mmsi, events)
    elif msg_type == 24:
        text = _decode_24(rbuffer, mmsi, events)
    elif msg_type == 20:
        text = _decode_20(rbuffer, mmsi, events, bufferlen)
    else:
        text = ""

    return ParsedMessage(type=msg_type, mmsi=mmsi, text=text, events=events)
