"""MySQL sink: the reference's production database backend
(out_mysql.c) behind the same writer interface as io.db.DbWriter.

Uses any MySQLdb/PyMySQL-compatible DB-API driver (discovered at
runtime or injected via ``connector=``); no driver is bundled.  The
load-bearing behavior mirrored from the reference:

 - auto-reconnect on CR_SERVER_GONE_ERROR / CR_SERVER_LOST with a
   single retry of the failed statement (out_mysql.c:88-96,145-148,
   161-166: mysql_run_query reconnects and re-issues);
 - ``keepsmall``: UPDATE by mmsi, INSERT only when no row matched
   (out_mysql.c:134-170);
 - ``oldlimit``: every 10th insert, DELETE rows older than N seconds
   (out_mysql.c:98-132);
 - table shapes from create_table.sql:7-38.
"""

from __future__ import annotations

import threading
from typing import Optional

from gnuais_tpu_torch.ais.parser import Event

CR_SERVER_GONE_ERROR = 2006
CR_SERVER_LOST = 2013

SCHEMA = [
    """CREATE TABLE IF NOT EXISTS ais_nmea (
        id INT AUTO_INCREMENT PRIMARY KEY,
        time BIGINT, message VARCHAR(200))""",
    """CREATE TABLE IF NOT EXISTS ais_position (
        id INT AUTO_INCREMENT PRIMARY KEY,
        time BIGINT, mmsi INT,
        latitude FLOAT, longitude FLOAT,
        heading FLOAT, course FLOAT, speed FLOAT)""",
    """CREATE TABLE IF NOT EXISTS ais_vesseldata (
        id INT AUTO_INCREMENT PRIMARY KEY,
        time BIGINT, mmsi INT,
        name VARCHAR(21), destination VARCHAR(21),
        draught FLOAT, A INT, B INT, C INT, D INT)""",
    """CREATE TABLE IF NOT EXISTS ais_basestation (
        id INT AUTO_INCREMENT PRIMARY KEY,
        time BIGINT, mmsi INT,
        latitude FLOAT, longitude FLOAT)""",
]


def find_connector():
    """First available MySQL DB-API driver, or None."""
    for name in ("pymysql", "MySQLdb", "mysql.connector"):
        try:
            mod = __import__(name)
        except ImportError:
            continue
        if name == "mysql.connector":
            mod = mod.connector
        return mod
    return None


def _server_gone(exc: BaseException) -> bool:
    """CR_SERVER_GONE_ERROR / CR_SERVER_LOST in driver-agnostic form:
    DB-API errors carry (errno, msg) args or an .errno attribute."""
    errno = getattr(exc, "errno", None)
    if errno is None and exc.args and isinstance(exc.args[0], int):
        errno = exc.args[0]
    return errno in (CR_SERVER_GONE_ERROR, CR_SERVER_LOST)


class MySqlWriter:
    """Same public interface as io.db.DbWriter, MySQL wire semantics."""

    def __init__(self, host: str, db: str, user: str, password: str = "",
                 keepsmall: bool = False, oldlimit: int = 0,
                 connector=None, create_tables: bool = True):
        self.connector = connector or find_connector()
        if self.connector is None:
            raise RuntimeError(
                "no MySQL driver available (pymysql / MySQLdb / "
                "mysql-connector); install one or use the sqlite DbWriter")
        self._params = dict(host=host, user=user, password=password,
                            database=db)
        self.keepsmall = keepsmall
        self.oldlimit = oldlimit
        self.inserts = 0
        self.reconnects = 0
        self._lock = threading.Lock()
        self.conn = None
        self._connect()
        if create_tables:
            for ddl in SCHEMA:
                self._run(ddl, ())

    def _connect(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except Exception:
                pass
        self.conn = self.connector.connect(**self._params)

    def _run(self, sql: str, args):
        """Execute with the reference's reconnect-once semantics."""
        for attempt in (0, 1):
            try:
                cur = self.conn.cursor()
                cur.execute(sql, args)
                return cur
            except Exception as e:
                if attempt == 0 and _server_gone(e):
                    # out_mysql.c:88-96: reconnect, then retry the query
                    self.reconnects += 1
                    self._connect()
                    continue
                raise

    def _commit(self) -> None:
        try:
            self.conn.commit()
        except Exception:
            pass

    def _maybe_prune(self, table: str, now: int) -> None:
        if not self.oldlimit:
            return
        self.inserts += 1
        if self.inserts % 10 == 0:
            self._run(f"DELETE FROM {table} WHERE time < %s",
                      (now - self.oldlimit,))

    def _upsert(self, table: str, now: int, update_sql: str, update_args,
                insert_sql: str, insert_args) -> None:
        with self._lock:
            if self.keepsmall:
                cur = self._run(update_sql, update_args)
                if cur.rowcount == 0:
                    self._run(insert_sql, insert_args)
            else:
                self._run(insert_sql, insert_args)
                self._maybe_prune(table, now)
            self._commit()

    def position(self, t: int, mmsi: int, lat: float, lon: float,
                 heading: float, course: float, sog: float) -> None:
        self._upsert(
            "ais_position", t,
            "UPDATE ais_position SET time=%s, latitude=%s, longitude=%s, "
            "heading=%s, course=%s, speed=%s WHERE mmsi=%s",
            (t, lat, lon, heading, course, sog, mmsi),
            "INSERT INTO ais_position (time,mmsi,latitude,longitude,"
            "heading,course,speed) VALUES (%s,%s,%s,%s,%s,%s,%s)",
            (t, mmsi, lat, lon, heading, course, sog))

    def basestation(self, t: int, mmsi: int, lat: float, lon: float) -> None:
        self._upsert(
            "ais_basestation", t,
            "UPDATE ais_basestation SET time=%s, latitude=%s, "
            "longitude=%s WHERE mmsi=%s",
            (t, lat, lon, mmsi),
            "INSERT INTO ais_basestation (time,mmsi,latitude,longitude) "
            "VALUES (%s,%s,%s,%s)",
            (t, mmsi, lat, lon))

    def vesseldata(self, t: int, mmsi: int, name: str, destination: str,
                   draught: float, a: int, b: int, c: int, d: int) -> None:
        self._upsert(
            "ais_vesseldata", t,
            "UPDATE ais_vesseldata SET time=%s, name=%s, destination=%s, "
            "A=%s, B=%s, C=%s, D=%s, draught=%s WHERE mmsi=%s",
            (t, name, destination, a, b, c, d, draught, mmsi),
            "INSERT INTO ais_vesseldata (time,mmsi,name,destination,"
            "draught,A,B,C,D) VALUES (%s,%s,%s,%s,%s,%s,%s,%s,%s)",
            (t, mmsi, name, destination, draught, a, b, c, d))

    def vesseldatab(self, t: int, mmsi: int, a: int, b: int, c: int,
                    d: int) -> None:
        self._upsert(
            "ais_vesseldata", t,
            "UPDATE ais_vesseldata SET time=%s, A=%s, B=%s, C=%s, D=%s "
            "WHERE mmsi=%s",
            (t, a, b, c, d, mmsi),
            "INSERT INTO ais_vesseldata (time,mmsi,A,B,C,D) "
            "VALUES (%s,%s,%s,%s,%s,%s)",
            (t, mmsi, a, b, c, d))

    def vesselname(self, t: int, mmsi: int, name: str,
                   destination: str) -> None:
        self._upsert(
            "ais_vesseldata", t,
            "UPDATE ais_vesseldata SET time=%s, name=%s, destination=%s "
            "WHERE mmsi=%s",
            (t, name, destination, mmsi),
            "INSERT INTO ais_vesseldata (time,mmsi,name,destination) "
            "VALUES (%s,%s,%s,%s)",
            (t, mmsi, name, destination))

    def nmea(self, t: int, sentence: str) -> None:
        with self._lock:
            self._run("INSERT INTO ais_nmea (time, message) "
                      "VALUES (%s,%s)", (t, sentence))
            self._maybe_prune("ais_nmea", t)
            self._commit()

    # same event routing as the sqlite backend
    apply_event = None  # set below

    def close(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None


def _apply_event(self, ev: Event, received_t: int) -> None:
    d = ev.data
    if ev.kind == "position":
        self.position(received_t, ev.mmsi, d["lat"], d["lon"],
                      float(d["heading"]), d["course"], d["sog"])
    elif ev.kind == "basestation":
        self.basestation(received_t, ev.mmsi, d["lat"], d["lon"])
    elif ev.kind == "vesseldata":
        self.vesseldata(received_t, ev.mmsi, d["name"], d["destination"],
                        d["draught"], d["A"], d["B"], d["C"], d["D"])
    elif ev.kind in ("vesseldatab", "vesseldatabb"):
        self.vesseldatab(received_t, ev.mmsi, d["A"], d["B"], d["C"], d["D"])
    elif ev.kind == "vesselname":
        self.vesselname(received_t, ev.mmsi, d["name"], d["destination"])


MySqlWriter.apply_event = _apply_event
