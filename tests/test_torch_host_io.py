"""The port's copies of the JAX package's live input, database, uplink
and monitor modules (``io/live``, ``io/db``, ``io/mysql``, ``io/cache``,
``monitor/``) against their originals, on the same inputs: the blocks a
FIFO gives, the sqlite rows and MySQL statements of the fixture's
events, the vessel cache's JSON-AIS blob, the NMEA reassembly and ship
table of the fixture's sentences, and the web map's ``/ships.json``.
Exact equality throughout (the copies differ only in their import
lines); wall clock fields (``last_seen``) are left out."""

import dataclasses
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from gnuais_tpu.ais import dispatcher as jdisp
from gnuais_tpu.golden import model as jmodel
from gnuais_tpu.io import audio as jaudio
from gnuais_tpu.io import cache as jcache
from gnuais_tpu.io import db as jdb
from gnuais_tpu.io import live as jlive
from gnuais_tpu.io import mysql as jmysql
from gnuais_tpu.monitor import ships as jships
from gnuais_tpu.monitor import webmap as jwebmap
from gnuais_tpu_torch.ais import dispatcher as tdisp
from gnuais_tpu_torch.io import cache as tcache
from gnuais_tpu_torch.io import db as tdb
from gnuais_tpu_torch.io import live as tlive
from gnuais_tpu_torch.io import mysql as tmysql
from gnuais_tpu_torch.monitor import ships as tships
from gnuais_tpu_torch.monitor import webmap as twebmap

from test_mysql import FakeServer
from test_torch_cli import FIX

NOW = 1_700_000_000


@pytest.fixture(scope="module")
def messages():
    """The fixture's decoded messages through each package's dispatcher
    (the frames from the JAX package's golden receiver)."""
    audio, _ = jaudio.load_capture(FIX / "standard_capture.raw")
    rx = jmodel.GoldenReceiver("A")
    frames = []
    for block in jaudio.iter_blocks(audio, 1, None):
        frames.extend(rx.run_block(block))
    out = {}
    for key, mod in (("jax", jdisp), ("torch", tdisp)):
        d = mod.ChannelDispatcher("A")
        msgs = [d.dispatch(f.payload_bits, f.bufferlen) for f in frames]
        out[key] = [m for m in msgs if m is not None]
    assert len(out["jax"]) == len(out["torch"]) == 49
    return out


def _feed(writer, msgs):
    for i, msg in enumerate(msgs):
        for s in msg.nmea_sentences:
            writer.nmea(NOW + i, s)
        for ev in msg.events:
            writer.apply_event(ev, NOW + i)


def _fifo_blocks(mod, path, data, channels, block_frames):
    os.mkfifo(path)

    def write():
        with open(path, "wb") as f:
            for o in range(0, len(data), 7001):   # uneven pipe writes
                f.write(data[o:o + 7001])
    t = threading.Thread(target=write)
    t.start()
    live = mod.LiveInput(str(path), channels=channels,
                         block_frames=block_frames)
    try:
        blocks = list(live.blocks())
    finally:
        live.close()
        t.join()
    return blocks


@pytest.mark.parametrize("channels,block_frames", [(1, None), (2, 1000)])
def test_live_input_on_a_fifo(tmp_path, channels, block_frames):
    data = (FIX / "standard_capture.raw").read_bytes()
    got = [_fifo_blocks(mod, tmp_path / f"{name}.fifo", data, channels,
                        block_frames)
           for name, mod in (("jax", jlive), ("torch", tlive))]
    assert len(got[0]) == len(got[1]) > 1
    for a, b in zip(*got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert b"".join(b.tobytes() for b in got[1]) == \
        data[:len(data) // (2 * channels) * (2 * channels)]


@pytest.mark.parametrize("keepsmall,oldlimit", [(False, 0), (True, 0),
                                                (False, 5)])
def test_db_writer_rows(messages, keepsmall, oldlimit):
    rows = []
    for key, mod in (("jax", jdb), ("torch", tdb)):
        w = mod.DbWriter(":memory:", keepsmall=keepsmall, oldlimit=oldlimit)
        _feed(w, messages[key])
        rows.append({t: w.conn.execute(f"SELECT * FROM {t} ORDER BY id")
                     .fetchall()
                     for t in ("ais_nmea", "ais_position", "ais_vesseldata",
                               "ais_basestation")})
        w.close()
    assert rows[0] == rows[1]
    assert len(rows[1]["ais_position"]) > 0
    if not oldlimit:
        assert len(rows[1]["ais_nmea"]) == 55
        assert len(rows[1]["ais_vesseldata"]) > 0


@pytest.mark.parametrize("keepsmall", [False, True])
def test_mysql_writer_statements(messages, keepsmall):
    logs = []
    for key, mod in (("jax", jmysql), ("torch", tmysql)):
        server = FakeServer()
        w = mod.MySqlWriter("localhost", "ais", "gnuais", "pw",
                            keepsmall=keepsmall, oldlimit=3600,
                            connector=server)
        _feed(w, messages[key])
        w.close()
        logs.append(server.statements)
    assert logs[0] == logs[1]
    assert sum(s.startswith("INSERT INTO ais_nmea") for s, _ in logs[1]) == 55


def test_vessel_cache_and_export_json(messages):
    blobs, entries = [], []
    for key, mod in (("jax", jcache), ("torch", tcache)):
        cache = mod.VesselCache()
        for i, msg in enumerate(messages[key]):
            for ev in msg.events:
                cache.apply_event(ev, NOW + i)
        ent = cache.rotate()
        entries.append({k: dataclasses.asdict(v) for k, v in ent.items()})
        blobs.append(mod.export_json(ent, "TEST42", NOW + 100))
        posted = []
        cache2 = mod.VesselCache()
        for ev in messages[key][0].events:
            cache2.apply_event(ev, NOW)
        exp = mod.JsonExporter(cache2, ["http://uplink.invalid/a"], "TEST42",
                               post_fn=lambda url, blob: posted.append(url))
        exp.export_once(NOW)
        assert posted == ["http://uplink.invalid/a"]
    assert entries[0] == entries[1]
    assert blobs[0] == blobs[1]
    assert blobs[1][1] == 18


def _ship_state(table):
    return {m: {k: v for k, v in dataclasses.asdict(s).items()
                if k != "last_seen"} for m, s in table.ships.items()}


def test_aivdm_assembler_and_ship_table():
    data = (FIX / "standard_capture.nmea").read_text().replace("\n", "")
    states = []
    for mod in (jships, tships):
        asm, table = mod.AivdmAssembler(), mod.ShipTable(max_ships=20)
        bits = []
        for o in range(0, len(data), 97):           # split mid-sentence
            bits.extend(asm.feed(data[o:o + 97].encode()))
        for b in bits:
            table.update_from_bits(b)
        states.append(([b.tobytes() for b in bits], _ship_state(table),
                       table.dropped, table.render_text().splitlines()[0]))
    assert states[0] == states[1]
    assert len(states[1][0]) == 49 and states[1][2] > 0


def test_webmap_ships_json():
    data = (FIX / "standard_capture.nmea").read_bytes().replace(b"\n", b"")
    snaps = []
    for sh, wm in ((jships, jwebmap), (tships, twebmap)):
        asm, table = sh.AivdmAssembler(), sh.ShipTable()
        for b in asm.feed(data):
            table.update_from_bits(b)
        srv = wm.WebMapServer(table, port=0)
        srv.start()
        try:
            url = f"http://127.0.0.1:{srv.port}/ships.json"
            with urllib.request.urlopen(url, timeout=10) as r:
                body = json.loads(r.read())
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/", timeout=10) as r:
                page = r.read()
        finally:
            srv.stop()
        for s in body["ships"]:
            s.pop("last_seen")
        snaps.append((body, page))
    assert snaps[0] == snaps[1]
    assert len(snaps[1][0]["ships"]) > 20
