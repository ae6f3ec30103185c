"""Database sink: ais_position / ais_vesseldata / ais_basestation /
ais_nmea tables with the reference writer semantics (out_mysql.c):

 - ``keepsmall``: UPDATE by mmsi first, INSERT only when no row matched
   (out_mysql.c:134-170);
 - ``oldlimit``: every 10th insert, DELETE rows older than N seconds
   (out_mysql.c:98-132);
 - the type-24B writer inserts only time/mmsi/A/B/C/D
   (myout_ais_vesseldatab, out_mysql.c:237-255) and the name writer only
   time/mmsi/name/destination (out_mysql.c:257-276).

Backend is sqlite3 (stdlib) by default — schema from create_table.sql —
with the same writer interface an external MySQL backend can implement.
"""

from __future__ import annotations

import sqlite3
import threading
import time as time_mod
from typing import Optional

from gnuais_tpu_torch.ais.parser import Event

SCHEMA = """
create table if not exists ais_nmea (
    id integer primary key autoincrement,
    time bigint, message varchar(200)
);
create table if not exists ais_position (
    id integer primary key autoincrement,
    time bigint, mmsi int,
    latitude float, longitude float,
    heading float, course float, speed float
);
create table if not exists ais_vesseldata (
    id integer primary key autoincrement,
    time bigint, mmsi int,
    name varchar(21), destination varchar(21),
    draught float, A int, B int, C int, D int
);
create table if not exists ais_basestation (
    id integer primary key autoincrement,
    time bigint, mmsi int,
    latitude float, longitude float
);
"""


class DbWriter:
    def __init__(self, path: str = ":memory:", keepsmall: bool = False,
                 oldlimit: int = 0):
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.conn.executescript(SCHEMA)
        self.keepsmall = keepsmall
        self.oldlimit = oldlimit
        self.inserts = 0
        self._lock = threading.Lock()

    def _maybe_prune(self, table: str, now: int) -> None:
        # every 10th insert, drop rows older than oldlimit seconds
        if not self.oldlimit:
            return
        self.inserts += 1
        if self.inserts % 10 == 0:
            self.conn.execute(
                f"DELETE FROM {table} WHERE time < ?",
                (now - self.oldlimit,))

    def _upsert(self, table: str, now: int, mmsi: int, update_sql: str,
                update_args, insert_sql: str, insert_args) -> None:
        with self._lock:
            if self.keepsmall:
                cur = self.conn.execute(update_sql, update_args)
                if cur.rowcount == 0:
                    self.conn.execute(insert_sql, insert_args)
            else:
                self.conn.execute(insert_sql, insert_args)
                self._maybe_prune(table, now)
            self.conn.commit()

    def position(self, t: int, mmsi: int, lat: float, lon: float,
                 heading: float, course: float, sog: float) -> None:
        self._upsert(
            "ais_position", t, mmsi,
            "UPDATE ais_position SET time=?, latitude=?, longitude=?, "
            "heading=?, course=?, speed=? WHERE mmsi=?",
            (t, lat, lon, heading, course, sog, mmsi),
            "INSERT INTO ais_position (time,mmsi,latitude,longitude,"
            "heading,course,speed) VALUES (?,?,?,?,?,?,?)",
            (t, mmsi, lat, lon, heading, course, sog))

    def basestation(self, t: int, mmsi: int, lat: float, lon: float) -> None:
        self._upsert(
            "ais_basestation", t, mmsi,
            "UPDATE ais_basestation SET time=?, latitude=?, longitude=? "
            "WHERE mmsi=?",
            (t, lat, lon, mmsi),
            "INSERT INTO ais_basestation (time,mmsi,latitude,longitude) "
            "VALUES (?,?,?,?)",
            (t, mmsi, lat, lon))

    def vesseldata(self, t: int, mmsi: int, name: str, destination: str,
                   draught: float, a: int, b: int, c: int, d: int) -> None:
        self._upsert(
            "ais_vesseldata", t, mmsi,
            "UPDATE ais_vesseldata SET time=?, name=?, destination=?, "
            "A=?, B=?, C=?, D=?, draught=? WHERE mmsi=?",
            (t, name, destination, a, b, c, d, draught, mmsi),
            "INSERT INTO ais_vesseldata (time,mmsi,name,destination,"
            "draught,A,B,C,D) VALUES (?,?,?,?,?,?,?,?,?)",
            (t, mmsi, name, destination, draught, a, b, c, d))

    def vesseldatab(self, t: int, mmsi: int, a: int, b: int, c: int,
                    d: int) -> None:
        self._upsert(
            "ais_vesseldata", t, mmsi,
            "UPDATE ais_vesseldata SET time=?, A=?, B=?, C=?, D=? "
            "WHERE mmsi=?",
            (t, a, b, c, d, mmsi),
            "INSERT INTO ais_vesseldata (time,mmsi,A,B,C,D) "
            "VALUES (?,?,?,?,?,?)",
            (t, mmsi, a, b, c, d))

    def vesselname(self, t: int, mmsi: int, name: str,
                   destination: str) -> None:
        self._upsert(
            "ais_vesseldata", t, mmsi,
            "UPDATE ais_vesseldata SET time=?, name=?, destination=? "
            "WHERE mmsi=?",
            (t, name, destination, mmsi),
            "INSERT INTO ais_vesseldata (time,mmsi,name,destination) "
            "VALUES (?,?,?,?)",
            (t, mmsi, name, destination))

    def nmea(self, t: int, sentence: str) -> None:
        # stored with leading '!' (myout_nmea, out_mysql.c:286)
        with self._lock:
            self.conn.execute(
                "INSERT INTO ais_nmea (time, message) VALUES (?,?)",
                (t, sentence))
            self._maybe_prune("ais_nmea", t)
            self.conn.commit()

    def apply_event(self, ev: Event, received_t: int) -> None:
        """Route a parser event like the per-type decoders do
        (myout_* calls in protodec.c:383-770)."""
        d = ev.data
        if ev.kind == "position":
            self.position(received_t, ev.mmsi, d["lat"], d["lon"],
                          float(d["heading"]), d["course"], d["sog"])
        elif ev.kind == "basestation":
            self.basestation(received_t, ev.mmsi, d["lat"], d["lon"])
        elif ev.kind == "vesseldata":
            self.vesseldata(received_t, ev.mmsi, d["name"],
                            d["destination"], d["draught"],
                            d["A"], d["B"], d["C"], d["D"])
        elif ev.kind in ("vesseldatab", "vesseldatabb"):
            self.vesseldatab(received_t, ev.mmsi,
                             d["A"], d["B"], d["C"], d["D"])
        elif ev.kind == "vesselname":
            self.vesselname(received_t, ev.mmsi, d["name"], d["destination"])

    def close(self) -> None:
        self.conn.close()
