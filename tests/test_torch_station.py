"""The station path of the port's CLI on the CPU, each case held against
the JAX package's CLI on the same capture: live input from stdin (one
subprocess, with file logging) and from FIFOs (mono and two channels,
with the ``-s`` tee), the NMEA Unix socket with a connected client,
``--profile`` through torch.profiler, ``--monitor`` on a socket of the
test's own, and the first-run config.  No test binds the default socket
path (``/tmp/gnuais.socket``): other tests of the same run use it.  A
test's own sockets lie in its directory, named relative to it (a Unix
socket's path has room for 107 bytes)."""

import dataclasses
import functools
import json
import os
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from gnuais_tpu import cli as jcli
from gnuais_tpu.golden import encoder as E
from gnuais_tpu.io import sinks as jsinks
from gnuais_tpu.monitor import ships as jships
from gnuais_tpu_torch import cli as tcli
from gnuais_tpu_torch.io import sinks as tsinks
from gnuais_tpu_torch.monitor import ships as tships

from test_torch_cli import FIX, Sentences, _cli, station_run

WANT = (FIX / "standard_capture.stdout").read_text()
NMEA = (FIX / "standard_capture.nmea").read_text().splitlines()
CLIS = {"jax": (jcli, []), "torch": (tcli, ["--device", "cpu"])}


def _main(pkg, argv, capsys):
    cli, pre = CLIS[pkg]
    rc = cli.main([*pre, *argv])
    return rc, capsys.readouterr().out


def _feed_fifo(path, data):
    os.mkfifo(path)

    def write():
        with open(path, "wb") as f:
            for o in range(0, len(data), 4096):
                f.write(data[o:o + 4096])
    t = threading.Thread(target=write)
    t.start()
    return t


def _stereo(tmp_path):
    """Two channels: the fixture on A, a seeded encoder capture on B."""
    a = np.fromfile(FIX / "standard_capture.raw", dtype="<i2")
    rng = np.random.default_rng(3)
    b = E.synthesize_capture([E.random_payload(rng) for _ in range(6)])
    b = np.pad(b, (0, len(a) - len(b)))
    path = tmp_path / "stereo.raw"
    E.interleave_stereo(a, b).astype("<i2").tofile(path)
    conf = tmp_path / "both.conf"
    conf.write_text("soundchannels both\n")
    return path.read_bytes(), ["-c", str(conf)]


@pytest.mark.parametrize("channels", ["mono", "both"])
def test_fifo_live_input_and_tee(tmp_path, capsys, monkeypatch, channels):
    """``-l FIFO`` reads live blocks (``io/live``) and ``-s`` records
    them; stdout, the broadcast sentences and the tee equal the JAX
    CLI's on the same bytes (the file run's, for mono)."""
    if channels == "mono":
        data, extra = (FIX / "standard_capture.raw").read_bytes(), []
    else:
        data, extra = _stereo(tmp_path)
    got = {}
    for pkg in ("jax", "torch"):
        rec = Sentences()
        monkeypatch.setattr(CLIS[pkg][0], "NmeaSocketServer", lambda r=rec: r)
        fifo, tee = tmp_path / f"{pkg}.fifo", tmp_path / f"{pkg}.tee"
        writer = _feed_fifo(fifo, data)
        rc, out = _main(pkg, [*extra, "--backend", "golden", "-e", "err",
                              "-l", str(fifo), "-s", str(tee)], capsys)
        writer.join()
        assert rc == 0
        got[pkg] = (out, rec.sent, tee.read_bytes())
    assert got["jax"] == got["torch"]
    out, sent, tee = got["torch"]
    assert tee == data
    if channels == "mono":
        assert out == WANT and sent == NMEA
    else:
        chans = [line.split()[1] for line in out.splitlines()]
        assert chans.count("A") == 49 and chans.count("B") == 6


def test_stdin_live_input_in_a_subprocess(tmp_path, monkeypatch):
    """``-l -`` reads fd 0 (the fixture piped in) through the exact
    chain, logging to a file (``-o file -r DIR``); the NMEA socket is on
    a path of the test's own."""
    with open(FIX / "standard_capture.raw", "rb") as stdin:
        res = _cli("--device", "cpu", "--backend", "exact", "-l", "-", "-o",
                   "file", "-r", str(tmp_path), cwd=tmp_path, stdin=stdin)
    assert res.returncode == 0, res.stderr
    rc, out, sent, _log = station_run("jax", "", tmp_path / "jax",
                                      monkeypatch, backend="exact")
    assert res.stdout == out == WANT and sent == NMEA
    text = (tmp_path / "gnuais.log").read_text()
    assert "Reading live audio from stream: -" in text
    assert ("A: Received correctly: 49 packets, wrong CRC: 0 packets, "
            "wrong size: 0 packets") in text


def _collect(path, server):
    """A client of the NMEA socket at ``path``, connected before the
    decode starts; returns (thread, received bytes)."""
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(str(path))
    deadline = time.time() + 10
    while not server._clients and time.time() < deadline:
        time.sleep(0.01)
    buf = bytearray()

    def read():
        while True:
            chunk = c.recv(65536)
            if not chunk:
                break
            buf.extend(chunk)
        c.close()
    t = threading.Thread(target=read)
    t.start()
    return t, buf


def test_nmea_socket_sink(tmp_path, capsys, monkeypatch):
    """The Unix socket broadcast, with a connected client, carries the
    reference's sentence stream as the JAX CLI's does."""
    monkeypatch.chdir(tmp_path)
    got = {}
    for pkg, sinks in (("jax", jsinks), ("torch", tsinks)):
        path = Path(f"{pkg}.sock")
        srv = sinks.NmeaSocketServer(str(path))
        monkeypatch.setattr(CLIS[pkg][0], "NmeaSocketServer",
                            functools.partial(lambda s: s, srv))
        reader, buf = _collect(path, srv)
        rc, out = _main(pkg, ["--backend", "golden", "-e", "err", "-l",
                              str(FIX / "standard_capture.raw")], capsys)
        reader.join(timeout=30)
        assert rc == 0 and out == WANT
        assert not path.exists()            # the CLI closed the server
        got[pkg] = bytes(buf)
    assert got["jax"] == got["torch"] == "".join(NMEA).encode()


def test_profile_writes_a_torch_profiler_trace(tmp_path, capsys, caplog,
                                               monkeypatch):
    monkeypatch.setattr(tcli, "NmeaSocketServer", Sentences)
    prof = tmp_path / "prof"
    with caplog.at_level("INFO", logger="gnuais"):
        rc, out = _main("torch", ["--backend", "golden", "--profile",
                                  str(prof), "-l",
                                  str(FIX / "standard_capture.raw")], capsys)
    assert rc == 0 and out == WANT
    assert f"torch profiler trace -> {prof}" in caplog.text
    traces = sorted(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert len(events) > 0


def _serve_nmea(path, data):
    """A receiver's socket stand-in: accept one monitor, send the
    sentences in pieces, close."""
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(str(path))
    srv.listen(1)

    def run():
        c, _ = srv.accept()
        for o in range(0, len(data), 300):
            c.sendall(data[o:o + 300])
        c.close()
        srv.close()
    t = threading.Thread(target=run)
    t.start()
    return t


def test_monitor_on_a_socket(tmp_path, capsys, monkeypatch):
    """``--monitor`` consumes the NMEA socket into the ship table as the
    JAX CLI's monitor does."""
    monkeypatch.chdir(tmp_path)
    data = "".join(NMEA).encode()
    tables = {}
    for pkg, ships in (("jax", jships), ("torch", tships)):
        path = Path(f"{pkg}.sock")
        server = _serve_nmea(path, data)
        kept = []
        real = ships.monitor_socket

        def spy(real=real, path=path, kept=kept):
            kept.append(real(str(path), render_every=0.0))
            return kept[-1]
        monkeypatch.setattr(ships, "monitor_socket", spy)
        rc, out = _main(pkg, ["--monitor"], capsys)
        server.join()
        assert rc == 0 and "MMSI" in out
        tables[pkg] = {m: {k: v for k, v in dataclasses.asdict(s).items()
                           if k != "last_seen"}
                       for m, s in kept[0].ships.items()}
    assert tables["jax"] == tables["torch"]
    assert len(tables["torch"]) > 20


def test_first_run_installs_the_config(tmp_path, caplog, monkeypatch):
    """With neither -c nor -l the CLI installs ~/.config/gnuais/config
    from the packaged example and reads it; the example sets no input,
    so the run stops there, as the JAX CLI's does."""
    logs, confs = {}, {}
    for pkg in ("jax", "torch"):
        home = tmp_path / pkg
        monkeypatch.setenv("HOME", str(home))
        monkeypatch.setenv("XDG_CONFIG_HOME", str(home / ".config"))
        caplog.clear()
        with caplog.at_level("INFO", logger="gnuais"):
            cli, pre = CLIS[pkg]
            assert cli.main(pre) == 1
        logs[pkg] = [r.getMessage().replace(str(home), "~")
                     for r in caplog.records]
        confs[pkg] = (home / ".config" / "gnuais" / "config").read_text()
    assert logs["jax"] == logs["torch"]
    assert "Neither sound device or sound file configured." in logs["torch"]
    assert confs["jax"] == confs["torch"] != ""
