"""The port's command line in a subprocess, on the CPU (``--device
cpu``): the committed fixture decodes to the reference stdout byte for
byte, with the reference counters in the log.  No run binds the default
NMEA socket path (``/tmp/gnuais.socket``): other tests of a parallel
run use it."""

import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from uplink_recorder import UplinkRecorder, masked

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
SUMMARY = ("A: Received correctly: 49 packets, wrong CRC: 0 packets, "
           "wrong size: 0 packets")

# the CLI with its NMEA socket server on "nmea.sock" in the working
# directory: a relative path, which fits a Unix socket's 107 bytes
# wherever the test's directory lies
_MAIN = ("import functools, sys\n"
         "from gnuais_tpu_torch import cli\n"
         "from gnuais_tpu_torch.io import sinks\n"
         "cli.NmeaSocketServer = functools.partial(sinks.NmeaSocketServer, "
         "'nmea.sock')\n"
         "sys.exit(cli.main(sys.argv[1:]))\n")


def _cli(*args, cwd, stdin=None):
    """``gnuais-tpu-torch args`` in a subprocess that runs in ``cwd`` (a
    test's own directory, which holds its NMEA socket)."""
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + ([path] if path else [])))
    return subprocess.run(
        [sys.executable, "-c", _MAIN, *args], cwd=cwd, env=env, stdin=stdin,
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("backend", ["exact", "fast", "fused", "golden"])
def test_cli_decodes_fixture(backend, tmp_path):
    res = _cli("--device", "cpu", "--backend", backend,
               "-l", str(FIX / "standard_capture.raw"), cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout == (FIX / "standard_capture.stdout").read_text()
    assert SUMMARY in res.stderr


def test_cli_backend_from_config_file(tmp_path):
    """The ``backend`` directive of a config file that ``gnuais-tpu``
    reads selects the same backend here."""
    cfg = tmp_path / "gnuais.conf"
    cfg.write_text("soundchannels mono\nbackend fast\n")
    res = _cli("--device", "cpu", "-c", str(cfg),
               "-l", str(FIX / "standard_capture.raw"), cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout == (FIX / "standard_capture.stdout").read_text()
    assert SUMMARY in res.stderr


def test_cli_batch_replicated(tmp_path):
    res = _cli("--device", "cpu", "--backend", "fused", "--replicate", "2",
               "--batch", str(FIX / "standard_capture.raw"), cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    expected = (FIX / "standard_capture.stdout").read_text().splitlines()
    for i in range(2):
        tag = f"[s{i}:standard_capture.raw] "
        mine = [l[len(tag):] for l in res.stdout.splitlines()
                if l.startswith(tag)]
        assert mine == expected
    assert res.stderr.count("Received correctly: 49 packets, wrong CRC: 0 "
                            "packets, wrong size: 0 packets") == 2


def test_cli_batch_fast_backend(tmp_path):
    res = _cli("--device", "cpu", "--backend", "fast",
               "--batch", str(FIX / "standard_capture.raw"), cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    tag = "[s0:standard_capture.raw] "
    assert [l[len(tag):] for l in res.stdout.splitlines()] == \
        (FIX / "standard_capture.stdout").read_text().splitlines()
    assert SUMMARY[3:] in res.stderr


def test_cli_default_device_is_cuda(tmp_path):
    """Without --device the CLI decodes on cuda; where there is none it
    fails instead of using the CPU, and prints no message line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    res = _cli("-l", str(FIX / "standard_capture.raw"), cwd=tmp_path)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "torch.cuda.is_available() is False" in res.stderr


# case: the config lines (None: the cluster settings set on the Config
# itself, as the --cluster flag does, in a process that joined no group).
# Each was refused while the grid and the cluster were not ported
GRID_CASES = {
    "meshshape": "meshshape 2 4",
    "meshshape 1 2": "meshshape 1 2",
    "meshshape 2 1": "meshshape 2 1",
    "cluster": None,
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_cli_honours_grid_and_cluster_directives(case, tmp_path,
                                                 monkeypatch):
    """A grid of several devices (logical shards of the CPU here; a mono
    capture on 2 streams rows takes the grouped session) and the cluster
    settings decode the fixture to the JAX CLI's stdout and counters,
    which are the reference's (8192-sample shards keep the plain B2
    loop short)."""
    line = GRID_CASES[case]
    conf = (line + "\ntimeparblock 8192") if line else ""
    fields = ({} if line else dict(cluster_coordinator="localhost:1234",
                                   cluster_nprocs=2, cluster_procid=0))
    res = {pkg: station_run(pkg, conf, tmp_path / pkg, monkeypatch,
                            **fields) for pkg in ("jax", "torch")}
    (rc_j, out_j, nmea_j, log_j), (rc_t, out_t, nmea_t, log_t) = \
        res["jax"], res["torch"]
    assert rc_j == rc_t == 0, log_t[-800:]
    assert out_t == out_j == (FIX / "standard_capture.stdout").read_text()
    assert nmea_t == nmea_j
    assert SUMMARY in log_t and SUMMARY in log_j
    if line:
        s_ax, t_ax = map(int, line.split()[1:])
        assert f"Mesh decode: {s_ax}x{t_ax} devices" in log_t
        assert ("row segments" in log_t) == (s_ax > 1)


def test_cli_has_no_unhonoured_directives():
    """Every directive the JAX CLI honours has its path in the port: the
    refusal list and its helper are gone."""
    from gnuais_tpu_torch import cli
    assert not hasattr(cli, "UNHONOURED")
    assert not hasattr(cli, "_grid_devices")


class Sentences:
    """Stands in for the NMEA socket server: records what the CLI
    broadcasts (no socket, so nothing is bound at the shared default
    path)."""

    def __init__(self):
        self.sent = []

    def write(self, sentence):
        self.sent.append(sentence)

    def close(self):
        pass


class Clock:
    """A wall clock that advances 0.25 s a reading, so that a
    ``statsinterval`` of one second ticks during a short decode."""

    def __init__(self, t=1_700_000_000.0):
        self.t = t

    def time(self):
        self.t += 0.25
        return self.t


def station_run(pkg, conf_text, d, monkeypatch, backend="golden",
                level=logging.INFO, **fields):
    """The fixture through ``pkg``'s ``run_decode`` ("jax" or "torch")
    with the config ``conf_text`` (``{d}`` names the directory ``d`` of
    this run) and ``fields`` set on it, the NMEA socket replaced by a
    recorder.  Returns (rc, stdout, sentences, log text)."""
    import io
    from gnuais_tpu import cli as jcli
    from gnuais_tpu import config as jconfig
    from gnuais_tpu_torch import cli as tcli
    from gnuais_tpu_torch import config as tconfig
    d.mkdir(exist_ok=True)
    cli, config = (jcli, jconfig) if pkg == "jax" else (tcli, tconfig)
    conf = d / "gnuais.conf"
    conf.write_text(f"soundchannels mono\nbackend {backend}\n"
                    + conf_text.format(d=d) + "\n")
    cfg = config.read_config(str(conf))
    cfg.sound_in_file = str(FIX / "standard_capture.raw")
    for k, v in fields.items():
        setattr(cfg, k, v)
    rec = Sentences()
    monkeypatch.setattr(cli, "NmeaSocketServer", lambda: rec)
    out, logbuf = io.StringIO(), io.StringIO()
    handler = logging.StreamHandler(logbuf)
    logger = logging.getLogger("gnuais")
    old = logger.level
    logger.setLevel(level)
    logger.addHandler(handler)
    try:
        rc = (cli.run_decode(cfg, out_stream=out) if pkg == "jax"
              else cli.run_decode(cfg, "cpu", out_stream=out))
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old)
    return rc, out.getvalue(), rec.sent, logbuf.getvalue()


def _no_times(rows):
    """Rows or statement arguments with the wall clock's seconds masked."""
    return [tuple("T" if isinstance(v, int) and v > 1_600_000_000 else v
                  for v in row) for row in rows]


def _tables(path):
    import sqlite3
    conn = sqlite3.connect(str(path))
    try:
        return {t: _no_times(conn.execute(
            f"SELECT * FROM {t} ORDER BY id").fetchall())
            for t in ("ais_nmea", "ais_position", "ais_vesseldata",
                      "ais_basestation")}
    finally:
        conn.close()


def _fake_mysql(monkeypatch):
    """Both packages' MySQL writers get the fake DB-API driver of
    tests/test_mysql.py; returns the server of each package."""
    from gnuais_tpu.io import mysql as jmysql
    from gnuais_tpu_torch.io import mysql as tmysql
    from test_mysql import FakeServer
    servers = {"jax": FakeServer(), "torch": FakeServer()}
    monkeypatch.setattr(jmysql, "find_connector", lambda: servers["jax"])
    monkeypatch.setattr(tmysql, "find_connector", lambda: servers["torch"])
    return servers


# each honoured directive: its config line; the check of its effect gets
# the two runs' results and directories and the fake MySQL servers
MYSQL = "mysql_db ais\n"
HONOURED = {
    "checkpoint": "checkpoint {d}/ck\ncheckpointevery 8",
    "uplink": "uplink test json {url}\nmycall TEST42",
    "mysql_host": MYSQL + "mysql_host db.example",
    "mysql_db": MYSQL,
    "mysql_user": MYSQL + "mysql_user aisuser",
    "mysql_password": MYSQL + "mysql_password secret",
    "mysql_keepsmall": MYSQL + "mysql_keepsmall",
    "mysql_oldlimit": MYSQL + "mysql_oldlimit 3600",
    "dbpath": "dbpath {d}/ais.sqlite",
    "statsinterval": "statsinterval 1\nlatitude 59.9\nlongitude 10.7",
    "soundoutfile": "soundoutfile {d}/tee.raw",
    "serialport": "serialport {d}/tty",
}


@pytest.mark.parametrize("directive", sorted(HONOURED))
def test_cli_honours_directive(directive, tmp_path, monkeypatch):
    """A directive that was refused before its path was ported now
    decodes the fixture (rc 0, the reference stdout), does what it says,
    and does it as the JAX package's CLI does on the same capture."""
    from gnuais_tpu import cli as jcli
    from gnuais_tpu_torch import cli as tcli
    want = (FIX / "standard_capture.stdout").read_text()
    nmea = (FIX / "standard_capture.nmea").read_text().splitlines()
    line = HONOURED[directive]
    uplink = None
    if directive == "uplink":
        uplink = UplinkRecorder()
        line = line.replace("{url}", uplink.url)
    servers = _fake_mysql(monkeypatch)
    for mod in (jcli, tcli):
        monkeypatch.setattr(mod, "time_mod", Clock())
    dirs = {p: tmp_path / p for p in ("jax", "torch")}
    for d in dirs.values():
        d.mkdir()
        (d / "tty").write_bytes(b"")
    # the checkpoint needs a decoder with a carry: the port's exact chain
    # (its snapshot is read back with the JAX package's load_carry below;
    # tests/test_torch_checkpoint.py resumes each CLI's in the other)
    backend = {"jax": "golden",
               "torch": "exact" if directive == "checkpoint" else "golden"}
    try:
        res = {p: station_run(p, line, dirs[p], monkeypatch, backend[p])
               for p in ("jax", "torch")}
    finally:
        if uplink:
            uplink.close()
    for p, (rc, out, sent, _log) in res.items():
        assert rc == 0, (p, _log)
        assert out == want, p
        assert sent == nmea, p
    logs = {p: r[3] for p, r in res.items()}
    d = dirs["torch"]
    if directive == "checkpoint":
        from gnuais_tpu.runtime.checkpoint import load_carry
        _carry, meta = load_carry(f"{d}/ck.A.npz", 1)
        assert meta["samples_consumed"] == 74430
        assert meta["counters"] == [[49, 0, 0]]
        assert meta["extra"]["seqnr"] > 0
        assert not (d / "ck.A.npz.tmp.npz").exists()
    elif directive == "uplink":
        assert len(uplink.posts) == 2
        blobs = [masked(b) for b in uplink.posts]
        assert blobs[0] == blobs[1]
        assert '"name": "TEST42"' in blobs[1] and '"mmsi": 257012345' in blobs[1]
    elif directive.startswith("mysql"):
        st = {p: [(sql, _no_times([a])[0]) for sql, a in s.statements]
              for p, s in servers.items()}
        assert st["jax"] == st["torch"]
        assert sum(sql.startswith("INSERT INTO ais_nmea")
                   for sql, _ in st["torch"]) == 55
        params = {"mysql_host": ("host", "db.example"),
                  "mysql_db": ("database", "ais"),
                  "mysql_user": ("user", "aisuser"),
                  "mysql_password": ("password", "secret")}
        if directive in params:
            key, value = params[directive]
            seen = {}

            class Spy:
                def connect(self, **kw):
                    seen.update(kw)
                    return servers["torch"].connect(**kw)
            monkeypatch.setattr("gnuais_tpu_torch.io.mysql.find_connector",
                                lambda: Spy())
            station_run("torch", line, tmp_path / "spy", monkeypatch)
            assert seen[key] == value
        elif directive == "mysql_keepsmall":
            assert any(sql.startswith("UPDATE") for sql, _ in st["torch"])
        else:
            assert any(sql.startswith("DELETE") for sql, _ in st["torch"])
        # without a driver the CLI logs the failure and goes on decoding
        monkeypatch.setattr("gnuais_tpu_torch.io.mysql.find_connector",
                            lambda: None)
        rc, out, _s, text = station_run("torch", line, tmp_path / "none",
                                        monkeypatch)
        assert rc == 0 and out == want
        assert "Could not connect to MySQL" in text
    elif directive == "dbpath":
        tables = {p: _tables(dirs[p] / "ais.sqlite") for p in dirs}
        assert tables["jax"] == tables["torch"]
        assert len(tables["torch"]["ais_nmea"]) == 55
    elif directive == "statsinterval":
        ranges = {p: [l for l in logs[p].splitlines() if "Best range" in l]
                  for p in logs}
        assert ranges["jax"] == ranges["torch"] != []
    elif directive == "soundoutfile":
        tee = (d / "tee.raw").read_bytes()
        assert tee == (FIX / "standard_capture.raw").read_bytes()
        assert tee == (dirs["jax"] / "tee.raw").read_bytes()
    elif directive == "serialport":
        data = (d / "tty").read_bytes()
        assert data == "".join(s + "\r\n" for s in nmea).encode()
        assert data == (dirs["jax"] / "tty").read_bytes()


def test_cli_refuses_iq_input_in_a_subprocess(tmp_path, monkeypatch):
    """The reproduction of a repaired fault: float32 IQ bytes
    behind ``inputformat iq`` are never decoded as int16 audio.  Since
    the IQ front end is ported they go through it (the log says so, and
    the sample count is the IQ frames', not the bytes' over 2), and the
    modulated message comes out; on a 2 x 4 grid (logical shards of the
    CPU) too, with the JAX CLI's stdout and counters."""
    from gnuais_tpu_torch.golden import encoder as E
    audio = E.synthesize_capture([E.make_type18(258123456, 60.39, 5.32)])
    x = np.repeat(audio.astype(np.float64) / 32767.0, 4)
    phase = 2 * np.pi * np.cumsum(x * 2400.0) / (48000.0 * 4)
    iq = np.exp(1j * phase).astype(np.complex64)
    raw = np.empty(len(iq) * 2, dtype="<f4")
    raw[0::2], raw[1::2] = iq.real, iq.imag
    path = tmp_path / "x.iq"
    raw.tofile(path)
    conf = tmp_path / "iq.conf"
    conf.write_text("soundchannels mono\ninputformat iq\n")
    res = _cli("--device", "cpu", "--backend", "golden", "-c", str(conf),
               "-l", str(path), cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert "Streaming IQ from file" in res.stderr
    assert f"Processed {len(audio)} samples" in res.stderr
    assert "type 18 mmsi 258123456" in res.stdout
    conf.write_text("soundchannels mono\ninputformat iq\nmeshshape 2 4\n"
                    "timeparblock 4096\n")
    res = _cli("--device", "cpu", "--backend", "exact", "-c", str(conf),
               "-l", str(path), cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert "Mesh decode: 2x4 devices" in res.stderr
    assert "type 18 mmsi 258123456" in res.stdout
    # the JAX CLI on the same config and file, in this process
    import io
    from gnuais_tpu import cli as jcli
    from gnuais_tpu.config import read_config as jax_read_config
    cfg = jax_read_config(str(conf))
    cfg.sound_in_file = str(path)
    monkeypatch.setattr(jcli, "NmeaSocketServer", Sentences)
    out = io.StringIO()
    assert jcli.run_decode(cfg, out_stream=out) == 0
    assert res.stdout == out.getvalue()
    assert "A: Received correctly: 1 packets, wrong CRC: 0 packets, " \
        "wrong size: 0 packets" in res.stderr
