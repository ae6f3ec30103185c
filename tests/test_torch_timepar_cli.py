"""The port's CLI in its throughput modes against the JAX package's CLI,
both run in this process on the CPU (the port with ``device`` "cpu",
its kernels' plain versions) on the same captures made from a seed with
numpy: ``streams 4`` (the lanes), ``meshshape 1 1`` (the session),
``inputformat iq`` on the sequential, lane and mesh paths (a file and a
FIFO), the lanes' envelope-guard fallback, and a ``.mesh.npz``
checkpoint written by one package and resumed by the other.  Stdout and
the counters must be byte-equal."""

import io
import logging
import os
import re
import threading

import numpy as np
import pytest

from gnuais_tpu.golden import encoder as E

from test_torch_cli import Sentences
from test_torch_iq import _modulate, _write_iq


def _noisy(audio, rng, std=200):
    return np.clip(audio + rng.normal(0, std, len(audio)), -32768,
                   32767).astype(np.int16)


@pytest.fixture(scope="module")
def stereo(tmp_path_factory):
    """A stereo capture whose A and B frames interleave (B starts later
    but some B frames stop before concurrent A frames: the case that
    tells stop-position emission order from start order), as int16 audio
    and as a stereo IQ file at decim 4.  Returns (audio path, IQ path)."""
    rng = np.random.default_rng(41)
    a = E.synthesize_capture([E.random_payload(rng) for _ in range(4)],
                             gap_bits=700, lead_in_bits=64)
    b = E.synthesize_capture([E.random_payload(rng) for _ in range(4)],
                             gap_bits=640, lead_in_bits=900)
    n = max(len(a), len(b))
    a, b = (_noisy(np.pad(x, (0, n - len(x))), rng) for x in (a, b))
    d = tmp_path_factory.mktemp("stereo")
    E.interleave_stereo(a, b).tofile(d / "stereo.raw")
    _write_iq(d / "stereo.iq", [_modulate(a), _modulate(b)])
    return d / "stereo.raw", d / "stereo.iq"


def _run(pkg, conf_text, monkeypatch, block_iter=None, **fields):
    """``run_decode`` of ``pkg`` ("jax" or "torch") on the config
    ``conf_text`` with ``fields`` set on it, the NMEA socket replaced by
    a recorder.  ``block_iter`` replaces the package's
    ``audio.iter_blocks``.  Returns (rc, stdout, log text, counters)."""
    from gnuais_tpu import cli as jcli
    from gnuais_tpu import config as jconfig
    from gnuais_tpu_torch import cli as tcli
    from gnuais_tpu_torch import config as tconfig
    cli, config = (jcli, jconfig) if pkg == "jax" else (tcli, tconfig)
    cfg = config.Config()
    for line in conf_text.strip().splitlines():
        assert config.apply_directive(cfg, line), line
    for k, v in fields.items():
        setattr(cfg, k, v)
    monkeypatch.setattr(cli, "NmeaSocketServer", lambda: Sentences())
    if block_iter is not None:
        monkeypatch.setattr(cli.audio_io, "iter_blocks", block_iter)
    out, logbuf = io.StringIO(), io.StringIO()
    handler = logging.StreamHandler(logbuf)
    logger = logging.getLogger("gnuais")
    old = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    try:
        rc = (cli.run_decode(cfg, out_stream=out) if pkg == "jax"
              else cli.run_decode(cfg, "cpu", out_stream=out))
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old)
    text = logbuf.getvalue()
    counters = {m.group(1): tuple(int(m.group(i)) for i in (2, 3, 4))
                for m in re.finditer(
                    r"(\w): Received correctly: (\d+) packets, wrong CRC: "
                    r"(\d+) packets, wrong size: (\d+) packets", text)}
    return rc, out.getvalue(), text, counters


def _both(conf_text, monkeypatch, **fields):
    res = {p: _run(p, conf_text, monkeypatch, **fields)
           for p in ("jax", "torch")}
    for p, (rc, _out, text, _c) in res.items():
        assert rc == 0, (p, text[-800:])
    (_, out_j, _, c_j), (_, out_t, text_t, c_t) = res["jax"], res["torch"]
    assert out_j.splitlines(), "the capture decoded nothing"
    assert out_t == out_j
    assert c_t == c_j
    return out_t, text_t, c_t


def test_streams_lanes_match_jax(stereo, monkeypatch):
    raw, _iq = stereo
    out, text, counters = _both(f"soundchannels both\nstreams 4\n"
                                f"soundinfile {raw}", monkeypatch)
    assert "Time-parallel decode ch B: 4 lanes" in text
    assert counters == {"A": (4, 0, 0), "B": (4, 0, 0)}


def test_meshshape_1_1_matches_jax(stereo, monkeypatch):
    raw, _iq = stereo
    _out, text, _c = _both(f"soundchannels both\nmeshshape 1 1\n"
                           f"timeparblock 4096\nsoundinfile {raw}",
                           monkeypatch)
    assert "Mesh decode: 1x1 devices, 4096-sample shards" in text


@pytest.mark.parametrize("mode", ["sequential", "streams 4",
                                  "meshshape 1 1"])
def test_iq_input_matches_jax(stereo, mode, monkeypatch):
    """``inputformat iq`` from a file on each path (the sequential one
    with the golden backend: the front end and the readers are what
    differs from the audio paths)."""
    raw, iq = stereo
    extra = "" if mode == "sequential" else mode + "\ntimeparblock 8192\n"
    out, text, counters = _both(
        f"soundchannels both\ninputformat iq\niqdecim 4\nbackend golden\n"
        f"{extra}soundinfile {iq}", monkeypatch)
    assert "Streaming IQ from file" in text
    assert sum(c[0] for c in counters.values()) >= 6


def test_iq_fifo_mesh_equals_iq_file(stereo, tmp_path, monkeypatch):
    """The same IQ bytes through a FIFO (the live reader) on the mesh
    path give the JAX CLI's stdout on the file."""
    _raw, iq = stereo
    conf = ("soundchannels both\ninputformat iq\niqdecim 4\n"
            "meshshape 1 1\ntimeparblock 8192\nsoundinfile {src}")
    _rc, want, _t, c_want = _run("jax", conf.format(src=iq), monkeypatch)
    fifo = tmp_path / "live.fifo"
    os.mkfifo(fifo)
    data = iq.read_bytes()

    def feed():
        with open(fifo, "wb") as f:
            for o in range(0, len(data), 100_000):
                f.write(data[o:o + 100_000])

    t = threading.Thread(target=feed)
    t.start()
    try:
        rc, out, text, counters = _run("torch", conf.format(src=fifo),
                                       monkeypatch)
    finally:
        t.join(timeout=60)
    assert rc == 0, text[-800:]
    assert "Streaming IQ live from" in text
    assert out == want and want
    assert counters == c_want


def test_lanes_envelope_guard_falls_back_to_the_session(monkeypatch,
                                                         tmp_path):
    """A digitally silent gap longer than the lanes' resync overlap: both
    CLIs warn and decode through the 1 x 1 session instead; ``lanesguard
    off`` keeps the lanes."""
    rng = np.random.default_rng(59)
    a = E.synthesize_capture([E.random_payload(rng) for _ in range(3)],
                             gap_bits=600)
    b = E.synthesize_capture([E.random_payload(rng) for _ in range(3)],
                             gap_bits=600)
    x = np.concatenate([_noisy(a, rng), np.zeros(5000, np.int16),
                        _noisy(b, rng)])
    cap = tmp_path / "gap.raw"
    x.tofile(cap)
    conf = (f"soundchannels mono\nstreams 4\ntimeparblock 16384\n"
            f"soundinfile {cap}")
    out, text, counters = _both(conf, monkeypatch)
    assert "falling back to the exact streaming session" in text
    assert "Mesh decode: 1x1 devices" in text
    assert counters["A"][0] == 6
    _rc, out_off, text_off, _c = _run("torch", conf + "\nlanesguard off",
                                      monkeypatch)
    assert "Time-parallel decode ch A" in text_off
    assert "falling back" not in text_off


def _crashing(after: int):
    """An ``iter_blocks`` stand-in: blocks of 4096 frames, and a crash
    (RuntimeError) after ``after`` of them."""
    def iter_blocks(interleaved, channels, block_frames=None):
        step = 4096 * channels
        for k, off in enumerate(range(0, len(interleaved), step)):
            if k == after:
                raise RuntimeError("injected crash")
            yield interleaved[off:off + step]
    return iter_blocks


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_mesh_checkpoint_resumes_in_the_other_package(first, tmp_path,
                                                      monkeypatch):
    """A ``meshshape 1 1`` decode with ``--checkpoint`` crashes midway in
    one package; the other resumes from its ``.mesh.npz``: the lines
    before the snapshot and the resumed run's lines together are the
    uninterrupted run's, and the counters continue."""
    rng = np.random.default_rng(89)
    audio = E.synthesize_capture([E.random_payload(rng) for _ in range(8)],
                                 gap_bits=300)
    cap = tmp_path / "cap.raw"
    _noisy(audio, rng).tofile(cap)
    conf = (f"soundchannels mono\nmeshshape 1 1\ntimeparblock 4096\n"
            f"soundinfile {cap}")
    _rc, want, _t, c_want = _run("jax", conf, monkeypatch)
    ck = dict(checkpoint=str(tmp_path / "state"), checkpoint_every=1)
    with pytest.raises(RuntimeError, match="injected crash"):
        _run(first, conf, monkeypatch, block_iter=_crashing(4), **ck)
    data = np.load(tmp_path / "state.mesh.npz", allow_pickle=True)
    meta = data["meta"].item()
    assert meta["pushed"] >= 3
    assert not any(type(v).__module__.startswith(("torch", "jax"))
                   for v in data["sess"].item().values())
    second = "torch" if first == "jax" else "jax"
    rc, out, text, counters = _run(second, conf, monkeypatch, **ck)
    assert rc == 0, text[-800:]
    assert "Resuming mesh decode" in text
    lines = want.splitlines()
    assert lines[:meta["emitted_lines"]] + out.splitlines() == lines
    assert counters == c_want
    assert not (tmp_path / "state.mesh.npz").exists()


def test_flags_set_the_throughput_directives(monkeypatch):
    """``--streams N`` and ``--low-latency`` (4096-sample shards) reach
    the config as the JAX CLI's flags do."""
    from gnuais_tpu_torch import cli
    seen = {}

    def fake(cfg, device, out_stream=None):
        seen.update(streams=cfg.streams, block=cfg.timepar_block,
                    device=device)
        return 0

    monkeypatch.setattr(cli, "run_decode", fake)
    assert cli.main(["-l", "x.raw", "--device", "cpu", "--streams", "8",
                     "--low-latency"]) == 0
    assert seen == {"streams": 8, "block": 4096, "device": "cpu"}
