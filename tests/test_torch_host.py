"""The port's own copies of the JAX package's host modules (constants,
ais, golden, native, io, config, runtime.metrics, runtime.session)
against their originals, on the same inputs: every public constant,
arrays bitwise; the parser, dispatcher and NMEA lines on the fixture's
frames; ``read_config``; the native library on seeded random input; the
encoder on seeded payloads.  Exact equality throughout (the copies
differ only in their import lines)."""

import dataclasses
import io
import math

import numpy as np
import pytest

import gnuais_tpu
import gnuais_tpu_torch
from gnuais_tpu import config as jconfig
from gnuais_tpu import constants as jC
from gnuais_tpu import native as jnative
from gnuais_tpu.ais import bits as jbits
from gnuais_tpu.ais import dispatcher as jdisp
from gnuais_tpu.golden import encoder as jenc
from gnuais_tpu.golden import model as jmodel
from gnuais_tpu.io import audio as jaudio
from gnuais_tpu.io import sinks as jsinks
from gnuais_tpu.runtime import metrics as jmetrics
from gnuais_tpu.runtime import session as jsession
from gnuais_tpu_torch import config as tconfig
from gnuais_tpu_torch import constants as tC
from gnuais_tpu_torch import native as tnative
from gnuais_tpu_torch.ais import bits as tbits
from gnuais_tpu_torch.ais import dispatcher as tdisp
from gnuais_tpu_torch.golden import encoder as tenc
from gnuais_tpu_torch.golden import model as tmodel
from gnuais_tpu_torch.io import audio as taudio
from gnuais_tpu_torch.io import sinks as tsinks
from gnuais_tpu_torch.runtime import metrics as tmetrics
from gnuais_tpu_torch.runtime import session as tsession

from test_torch_cli import FIX, REPO

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _same(a, b, what):
    """Equal values of the same type; numpy arrays bitwise, dataclasses
    field by field (the two packages' classes are distinct)."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), what
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


def _payloads(mod, seed, n=12):
    rng = np.random.default_rng(seed)
    return [mod.random_payload(rng) for _ in range(n)]


def _fixture_frames():
    """The frames of the fixture capture, decoded by the JAX package's
    golden receiver."""
    audio, _ = jaudio.load_capture(FIX / "standard_capture.raw")
    rx = jmodel.GoldenReceiver("A")
    frames = []
    for block in jaudio.iter_blocks(audio, 1, None):
        frames.extend(rx.run_block(jaudio.deinterleave(block, 1, 0)))
    assert len(frames) > 40
    return frames


@case
def constants():
    names = [n for n in vars(jC) if not n.startswith("_")
             and not callable(getattr(jC, n))
             and type(getattr(jC, n)).__name__ != "module"]
    assert len(names) > 20
    assert sorted(names) == sorted(
        n for n in vars(tC) if not n.startswith("_")
        and not callable(getattr(tC, n))
        and type(getattr(tC, n)).__name__ != "module")
    for n in names:
        _same(getattr(jC, n), getattr(tC, n), n)


@case
def encoder():
    for seed in (1, 2):
        jp, tp = _payloads(jenc, seed), _payloads(tenc, seed)
        _same(jp, tp, "random_payload")
        _same(jenc.synthesize_capture(jp), tenc.synthesize_capture(tp),
              "synthesize_capture")
    fixed = [(jenc.make_type5(257099999), tenc.make_type5(257099999)),
             (jenc.make_type18(2579999, 59.9, 10.7),
              tenc.make_type18(2579999, 59.9, 10.7)),
             (jenc.make_type24b(2579998), tenc.make_type24b(2579998))]
    for a, b in fixed:
        _same(a, b, "make_type")
        _same(jenc.frame_line_bits(a), tenc.frame_line_bits(b),
              "frame_line_bits")


@case
def golden_model():
    x = jenc.synthesize_capture(_payloads(jenc, 3))
    out = []
    for mod in (jmodel, tmodel):
        rx = mod.GoldenReceiver("A")
        frames = rx.run_block(x[: len(x) // 2]) + rx.run_block(x[len(x) // 2:])
        out.append((frames, rx.counters))
    _same(*out, "GoldenReceiver")
    assert len(out[0][0]) == 12


@case
def parser_dispatcher_nmea():
    frames = _fixture_frames()
    out = []
    for mod in (jdisp, tdisp):
        d = mod.ChannelDispatcher("B", skip_type=[4])
        out.append([d.dispatch(f.payload_bits, f.bufferlen) for f in frames])
    _same(*out, "dispatch")
    lines = [m.stdout_line for m in out[1] if m is not None and m.stdout_line]
    assert len(lines) > 10
    for f in frames[:8]:
        rb = jbits.pad_payload(f.payload_bits)
        assert jbits.henten(0, 6, rb) == tbits.henten(0, 6, rb)
        _same(jbits.hdlc_bits_to_payload(f.payload_bits),
              tbits.hdlc_bits_to_payload(f.payload_bits), "bits")


@case
def session():
    audio, _ = jaudio.load_capture(FIX / "standard_capture.raw")
    out = []
    for sess, model in ((jsession, jmodel), (tsession, tmodel)):
        res = sess.DecodeSession(lambda n, m=model: m.GoldenReceiver(n)).run(
            audio)
        out.append(res)
    _same(*out, "SessionResult")
    assert "".join(line + "\n" for line in out[1].stdout_lines) == \
        (FIX / "standard_capture.stdout").read_text()


@case
def audio():
    path = FIX / "standard_capture.raw"
    _same(jaudio.load_capture(path), taudio.load_capture(path), "load")
    x, _ = jaudio.load_capture(path)
    stereo = jenc.interleave_stereo(x[:5000], x[5000:10000])
    for n in (None, 1000):
        a = list(jaudio.iter_blocks(stereo, 2, n))
        b = list(taudio.iter_blocks(stereo, 2, n))
        _same(a, b, "iter_blocks")
        _same(jaudio.deinterleave(a[0], 2, 1), taudio.deinterleave(b[0], 2, 1),
              "deinterleave")
    assert jaudio.reference_block_frames() == taudio.reference_block_frames()


@case
def config(tmp_path):
    conf = tmp_path / "gnuais.conf"
    conf.write_text("soundchannels both\nstreams 4\nskip_type 4 5\n"
                    "mycall TEST42\nlatitude 59.9\nlongitude 10.7\n"
                    "statsinterval 2h3m\nmeshshape 2 4\nbackend fast\n"
                    "uplink test json http://localhost:1/x\n")
    paths = [jconfig.packaged_example(), conf]
    assert paths[0] is not None
    assert tconfig.packaged_example() == paths[0]
    for p in paths:
        _same(jconfig.read_config(str(p)), tconfig.read_config(str(p)), str(p))
    for s in ("90", "2m", "3h", "1d"):
        assert jconfig.parse_interval(s) == tconfig.parse_interval(s)


@case
def native():
    assert jnative.available() and tnative.available()
    assert tnative._BUILD.parent == REPO / "gnuais_tpu_torch" / "native"
    rng = np.random.default_rng(7)
    s, f, w = 6, 5, 15
    words = rng.integers(0, 2**32, size=(s, f, w), dtype=np.uint32)
    lens = rng.integers(1, 441, size=(s, f), dtype=np.int32)
    counts = rng.integers(0, f + 2, size=(s,), dtype=np.int32)
    _same(jnative.drain_frames(words, lens, counts),
          tnative.drain_frames(words, lens, counts), "drain_frames")
    data = rng.integers(0, 256, size=300, dtype=np.uint8).tobytes()
    assert jnative.crc16_x25(data) == tnative.crc16_x25(data)
    bits = jenc.nrzi_encode(np.concatenate(
        [jenc.frame_line_bits(p) for p in _payloads(jenc, 8, 4)]))
    out = []
    for mod in (jnative, tnative):
        dec = mod.HdlcDecoder()
        out.append((dec.decode(bits), dec.counters))
    _same(*out, "HdlcDecoder")


@case
def metrics_and_sinks():
    a, b = (m.LevelMonitor("A", sound_levellog=5) for m in (jmetrics, tmetrics))
    for t, v in enumerate((100, 32000, 32767, 20, 31200, 5)):
        assert a.observe(v, now=7.0 * t) == b.observe(v, now=7.0 * t)
    ra, rb = (m.RangeTracker("A", 59.9, 10.7) for m in (jmetrics, tmetrics))
    for lat, lon in ((60.1, 11.0), (0.0, 0.0), (61.5, 5.2), (95.0, 1.0)):
        ra.update(lat, lon)
        rb.update(lat, lon)
    assert ra.best_range == rb.best_range > 0
    assert ra.log_and_reset() == rb.log_and_reset()
    assert jmetrics.maidenhead_km_distance(1.0, 0.2, 1.01, 0.3) == \
        tmetrics.maidenhead_km_distance(1.0, 0.2, 1.01, 0.3)
    outs = []
    for mod in (jsinks, tsinks):
        buf = io.StringIO()
        mod.StdoutSink(buf).write_line(
            "!AIVDM,1,1,,A,13u?etPv2;0n:dDPwUM1U1Cb069D,0*24")
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] != ""


@pytest.mark.parametrize("name", sorted(CASES))
def test_copy_agrees_with_original(name, tmp_path):
    fn = CASES[name]
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn(tmp_path)
    else:
        fn()


def test_copies_are_the_port_own():
    """Each copy is a module of the port, not the original re-exported."""
    from gnuais_tpu_torch import monitor as tmonitor
    from gnuais_tpu_torch.io import alsa, cache, db, live, mysql, pulse
    from gnuais_tpu_torch.monitor import ships, webmap
    for mod in (tconfig, tC, tnative, tbits, tdisp, tenc, tmodel, taudio,
                tsinks, tmetrics, tsession, live, alsa, pulse, db, mysql,
                cache, tmonitor, ships, webmap):
        assert mod.__name__.startswith("gnuais_tpu_torch.")
        assert mod.__file__.startswith(gnuais_tpu_torch.__path__[0])
        assert not mod.__file__.startswith(gnuais_tpu.__path__[0] + "/")
