"""The port's command line in a subprocess, on the CPU (``--device
cpu``): the committed fixture decodes to the reference stdout byte for
byte, with the reference counters in the log."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
SUMMARY = ("A: Received correctly: 49 packets, wrong CRC: 0 packets, "
           "wrong size: 0 packets")


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "gnuais_tpu_torch.cli", *args], cwd=REPO,
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("backend", ["exact", "fast", "fused", "golden"])
def test_cli_decodes_fixture(backend):
    res = _cli("--device", "cpu", "--backend", backend,
               "-l", str(FIX / "standard_capture.raw"))
    assert res.returncode == 0, res.stderr
    assert res.stdout == (FIX / "standard_capture.stdout").read_text()
    assert SUMMARY in res.stderr


def test_cli_backend_from_config_file(tmp_path):
    """The ``backend`` directive of a config file that ``gnuais-tpu``
    reads selects the same backend here."""
    cfg = tmp_path / "gnuais.conf"
    cfg.write_text("soundchannels mono\nbackend fast\n")
    res = _cli("--device", "cpu", "-c", str(cfg),
               "-l", str(FIX / "standard_capture.raw"))
    assert res.returncode == 0, res.stderr
    assert res.stdout == (FIX / "standard_capture.stdout").read_text()
    assert SUMMARY in res.stderr


def test_cli_batch_replicated():
    res = _cli("--device", "cpu", "--backend", "fused", "--replicate", "2",
               "--batch", str(FIX / "standard_capture.raw"))
    assert res.returncode == 0, res.stderr
    expected = (FIX / "standard_capture.stdout").read_text().splitlines()
    for i in range(2):
        tag = f"[s{i}:standard_capture.raw] "
        mine = [l[len(tag):] for l in res.stdout.splitlines()
                if l.startswith(tag)]
        assert mine == expected
    assert res.stderr.count("Received correctly: 49 packets, wrong CRC: 0 "
                            "packets, wrong size: 0 packets") == 2


def test_cli_batch_fast_backend():
    res = _cli("--device", "cpu", "--backend", "fast",
               "--batch", str(FIX / "standard_capture.raw"))
    assert res.returncode == 0, res.stderr
    tag = "[s0:standard_capture.raw] "
    assert [l[len(tag):] for l in res.stdout.splitlines()] == \
        (FIX / "standard_capture.stdout").read_text().splitlines()
    assert SUMMARY[3:] in res.stderr


def test_cli_default_device_is_cuda():
    """Without --device the CLI decodes on cuda; where there is none it
    fails instead of using the CPU, and prints no message line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    res = _cli("-l", str(FIX / "standard_capture.raw"))
    assert res.returncode != 0
    assert res.stdout == ""
    assert "torch.cuda.is_available() is False" in res.stderr


# (directive as the log names it, its config line; None: set on the
# Config itself, as the JAX package's --cluster flag does)
REFUSED = {
    "inputformat iq": "inputformat iq",
    "streams": "streams 4",
    "meshshape": "meshshape 2 4",
    "checkpoint": "checkpoint /nonexistent/ckpt",
    "uplink": "uplink test json http://localhost:1/",
    "mysql_host": "mysql_host localhost",
    "mysql_db": "mysql_db ais",
    "mysql_user": "mysql_user ais",
    "mysql_password": "mysql_password secret",
    "mysql_keepsmall": "mysql_keepsmall",
    "mysql_oldlimit": "mysql_oldlimit 3600",
    "dbpath": "dbpath /nonexistent/ais.sqlite",
    "statsinterval": "statsinterval 10m",
    "soundoutfile": "soundoutfile /nonexistent/out.raw",
    "serialport": "serialport /dev/ttyFAKE",
    "cluster": None,
}


@pytest.mark.parametrize("directive", sorted(REFUSED))
def test_cli_refuses_unhonoured_directive(directive, tmp_path, caplog):
    """A config that sets a directive whose path is not ported is refused
    before anything is decoded: rc 1, the directive named in the log,
    no message line."""
    from gnuais_tpu_torch import cli
    from gnuais_tpu_torch.config import read_config
    assert directive in {name for name, _ in cli.UNHONOURED}
    conf = tmp_path / "gnuais.conf"
    conf.write_text("soundchannels mono\n" + (REFUSED[directive] or "") + "\n")
    cfg = read_config(str(conf))
    if REFUSED[directive] is None:
        cfg.cluster_coordinator, cfg.cluster_nprocs = "localhost:1234", 2
    cfg.sound_in_file = str(FIX / "standard_capture.raw")
    out = []

    class Sink:
        def write(self, text):
            out.append(text)

        def flush(self):
            pass

    with caplog.at_level("CRITICAL", logger="gnuais"):
        rc = cli.run_decode(cfg, "cpu", out_stream=Sink())
    assert rc == 1
    assert directive in caplog.text
    assert out == []


def test_cli_refuses_iq_input_in_a_subprocess(tmp_path):
    """The reproduction of the fault: float32 IQ bytes behind
    ``inputformat iq`` are no longer decoded as int16 audio."""
    conf = tmp_path / "iq.conf"
    conf.write_text("soundchannels mono\ninputformat iq\n")
    iq = tmp_path / "x.iq"
    iq.write_bytes(bytes(8 * 4800))
    res = _cli("--device", "cpu", "--backend", "exact", "-c", str(conf),
               "-l", str(iq))
    assert res.returncode == 1
    assert res.stdout == ""
    assert "inputformat iq" in res.stderr
