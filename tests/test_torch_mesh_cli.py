"""The port's CLI on grids of several devices against the JAX package's
CLI, both run in this process on the CPU: the JAX CLI on conftest's 8
virtual CPU devices, the port's (``device`` "cpu") on logical shards of
the CPU, kernel B2's plain version on each.  On the same captures made
from a seed with numpy, mirroring ``tests/test_timepar_cli.py``:
``meshshape 2 4`` on a stereo capture, ``1 8`` on a mono capture with a
wrong-CRC frame and a wrong-size stop, ``4 2`` on a mono capture (the
grouped session: one channel in 4 row segments, a short final block),
and ``--low-latency`` with ``1 2``.  Stdout and the counters must be
byte-equal to the JAX CLI's, and to the sequential session's."""

import contextlib
import io
import logging
import re

import numpy as np

from gnuais_tpu.golden import encoder as E
from gnuais_tpu_torch import captures

from test_torch_cli import Sentences
from test_torch_timepar_cli import _both, _noisy, _run


def _stereo(tmp_path, rng, n_a, n_b):
    """tests/test_timepar_cli.py's stereo capture: B's frames start after
    A's but some stop before them (emission order by stop position)."""
    a = E.synthesize_capture([E.random_payload(rng) for _ in range(n_a)],
                             gap_bits=700, lead_in_bits=64)
    b = E.synthesize_capture([E.random_payload(rng) for _ in range(n_b)],
                             gap_bits=640, lead_in_bits=900)
    n = max(len(a), len(b))
    a, b = (_noisy(np.pad(x, (0, n - len(x))), rng) for x in (a, b))
    cap = tmp_path / "stereo.raw"
    E.interleave_stereo(a, b).tofile(cap)
    return cap


def _against_sequential(conf_mesh, conf_seq, monkeypatch):
    """The grid's run in both packages (equal), and equal to the JAX
    package's sequential session (the golden backend).  Returns the
    port's (stdout, log text, counters)."""
    out, text, counters = _both(conf_mesh, monkeypatch)
    rc, seq, _t, c_seq = _run("jax", conf_seq + "\nbackend golden",
                              monkeypatch)
    assert rc == 0 and out == seq
    assert counters == c_seq
    return out, text, counters


def test_stereo_meshshape_2_4_matches_jax(tmp_path, monkeypatch):
    cap = _stereo(tmp_path, np.random.default_rng(43), 8, 8)
    seq = f"soundchannels both\nsoundinfile {cap}"
    _out, text, counters = _against_sequential(
        seq + "\nmeshshape 2 4\ntimeparblock 6144", seq, monkeypatch)
    assert "Mesh decode: 2x4 devices, 6144-sample shards" in text
    assert counters == {"A": (8, 0, 0), "B": (8, 0, 0)}


def test_mono_meshshape_1_8_wrong_crc_and_size(tmp_path, monkeypatch):
    """A wrong-CRC frame and a wrong-size stop (``captures.
    wrong_size_and_crc``) before noisy traffic with one inverted bit
    cell: both counters through the 1 x 8 grid equal the sequential
    session's, the wrong-size one gated to exactly one time shard."""
    rng = np.random.default_rng(47)
    payloads = [E.random_payload(rng) for _ in range(6)]
    audio = E.synthesize_capture(payloads, gap_bits=600).copy()
    cell = 3 * (len(audio) // len(payloads)) + 800
    audio[cell:cell + 5] = -audio[cell:cell + 5]
    x = np.concatenate([captures.wrong_size_and_crc(1, 9000, seed=5)[0],
                        _noisy(audio, rng)])
    cap = tmp_path / "mono.raw"
    x.tofile(cap)
    seq = f"soundchannels mono\nsoundinfile {cap}"
    _out, text, counters = _against_sequential(
        seq + "\nmeshshape 1 8\ntimeparblock 4096", seq, monkeypatch)
    assert "Mesh decode: 1x8 devices" in text
    received, wrong_crc, wrong_size = counters["A"]
    assert wrong_crc >= 1 and wrong_size == 1 and received >= 7


def test_mono_meshshape_4_2_grouped(tmp_path, monkeypatch):
    """One channel on a 4 x 2 grid: 4 row segments a push, no idle row,
    no warning; the final block (not a whole super-block) through the
    row-padded steps; a wrong-CRC frame deduped across the row seams."""
    rng = np.random.default_rng(71)
    payloads = [E.random_payload(rng) for _ in range(12)]
    audio = E.synthesize_capture(payloads, gap_bits=500).copy()
    bit = 64 + sum(len(E.frame_line_bits(p)) + 500 for p in payloads[:5])
    cell = (bit + 200) * 5
    audio[cell:cell + 5] = -audio[cell:cell + 5]
    audio = _noisy(audio, rng)
    assert len(audio) % 32768
    cap = tmp_path / "mono.raw"
    audio.tofile(cap)
    seq = f"soundchannels mono\nsoundinfile {cap}"
    _out, text, counters = _against_sequential(
        seq + "\nmeshshape 4 2\ntimeparblock 4096", seq, monkeypatch)
    assert "1 channel row(s) x 4 row segments" in text
    assert "idle" not in text
    assert counters["A"][1] >= 1


def _main(pkg, argv, monkeypatch):
    """``pkg``'s ``cli.main(argv)`` in this process, the NMEA socket
    replaced by a recorder.  Returns (rc, stdout, log text)."""
    from gnuais_tpu import cli as jcli
    from gnuais_tpu_torch import cli as tcli
    cli = jcli if pkg == "jax" else tcli
    monkeypatch.setattr(cli, "NmeaSocketServer", lambda: Sentences())
    out, logbuf = io.StringIO(), io.StringIO()
    handler = logging.StreamHandler(logbuf)
    logger = logging.getLogger("gnuais")
    old = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv + (["--device", "cpu"] if pkg == "torch"
                                  else []))
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old)
    return rc, out.getvalue(), logbuf.getvalue()


def test_low_latency_meshshape_1_2(tmp_path, monkeypatch):
    """``--low-latency`` takes the configured 16384-sample shards down to
    4096 on a 1 x 2 grid, in both CLIs alike."""
    rng = np.random.default_rng(79)
    audio = E.synthesize_capture(
        [E.random_payload(rng) for _ in range(8)], gap_bits=600)
    cap = tmp_path / "cap.raw"
    _noisy(audio, rng).tofile(cap)
    conf = tmp_path / "ll.conf"
    conf.write_text(f"soundchannels mono\nmeshshape 1 2\n"
                    f"timeparblock 16384\nsoundinfile {cap}\n")
    res = {pkg: _main(pkg, ["-c", str(conf), "--low-latency"], monkeypatch)
           for pkg in ("jax", "torch")}
    (rc_j, out_j, log_j), (rc_t, out_t, log_t) = res["jax"], res["torch"]
    assert rc_j == rc_t == 0, log_t[-800:]
    assert "4096-sample shards" in log_t
    assert out_t == out_j and len(out_t.splitlines()) == 8
    counters = [re.findall(r"(\w): Received correctly: (\d+) packets, "
                           r"wrong CRC: (\d+) packets, wrong size: (\d+)", t)
                for t in (log_j, log_t)]
    assert counters[0] == counters[1] == [("A", "8", "0", "0")]
