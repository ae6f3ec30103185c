"""The port's tracer (``gnuais_tpu_torch.runtime.trace``) on the
``--batch`` path, on the CPU: nothing recorded, no clock read and no
annotation made without a profiler; under one, the spans' calls, the
counters' bytes and the ``gnuais.*`` annotations in the profiler's
trace; the CLI's ``--batch --profile``."""

import functools
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gnuais_tpu_torch import captures, cli
from gnuais_tpu_torch.ops import demod
from gnuais_tpu_torch.runtime import trace
from gnuais_tpu_torch.runtime.batch import BatchSession

STREAMS, SLOTS = 3, 8
BLOCK_SPANS = ("batch.assemble", "batch.deliver", "pipeline.upload",
               "pipeline.readback", "pipeline.unpack", "pipeline.account")
AIS_SPANS = ("ais.dispatch", "ais.nmea", "ais.parse")


@pytest.fixture(scope="module")
def capture():
    """A clean capture of one payload, and a block length that cuts it
    into two blocks."""
    audio, _ = captures.payload_capture(np.random.default_rng(15), 1)
    return audio, -(-len(audio) // 2)


def _run(capture):
    audio, block_len = capture
    sess = BatchSession([f"s{i}" for i in range(STREAMS)],
                        block_len=block_len, frame_slots=SLOTS,
                        backend="exact", device="cpu")
    return sess.run([audio] * STREAMS)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def traced(capture, tmp_path_factory):
    """One run under a CPU profiler: the result, the tracer's totals and
    counters, and the ``gnuais.*`` events of the exported trace."""
    trace.reset()
    with _cpu_profile() as prof:
        res = _run(capture)
    totals, counters = trace.totals(), trace.counters()
    trace.reset()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if str(e.get("name", "")).startswith(trace.PREFIX)
              and e.get("ph") == "X"]
    return res, totals, counters, events


def test_off_records_nothing_reads_no_clock_makes_no_annotation(
        capture, monkeypatch):
    clock, marks = [], []
    real_clock = time.perf_counter_ns

    def counted_clock():
        clock.append(1)
        return real_clock()

    class CountedMark:
        def __init__(self, name):
            marks.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(time, "perf_counter_ns", counted_clock)
    monkeypatch.setattr(torch.profiler, "record_function", CountedMark)
    trace.reset()
    res = _run(capture)
    assert len(res.messages) == STREAMS
    assert (clock, marks) == ([], [])
    assert trace.totals() == {} and trace.counters() == {}
    # under a profiler a span goes through both
    with _cpu_profile():
        with trace.span("batch.assemble", mark=True):
            pass
    assert len(clock) == 2 and marks == ["gnuais.batch.assemble"]
    trace.reset()


def test_batch_spans_and_counters_under_a_profiler(capture, traced):
    res, totals, counters, events = traced
    n_msg = len(res.messages)
    assert n_msg == STREAMS
    for name in BLOCK_SPANS:
        assert totals[name].calls == 2, name
        assert totals[name].ms > 0, name
    for name in AIS_SPANS:
        assert totals[name].calls == n_msg, name
    assert set(totals) == set(BLOCK_SPANS) | set(AIS_SPANS)
    audio, block_len = capture
    # the drain's six leaves, read back once a block
    leaves = demod.init_frames(STREAMS, SLOTS, "cpu")
    per_block = sum(getattr(leaves, k).numel() * 4 for k in (
        "words", "length", "count", "lost2", "dropped", "crcfail"))
    received = sum(c[0] for c in res.counters.values())
    assert counters == {"batch.blocks": 2,
                        "pipeline.h2d_bytes": 2 * STREAMS * block_len * 2,
                        "pipeline.d2h_reads": 2 * 6,
                        "pipeline.d2h_bytes": 2 * per_block,
                        "pipeline.frames": received,
                        "ais.messages": n_msg}
    assert received == n_msg
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"][len(trace.PREFIX):], []).append(e)
    # block spans annotated, a message's never
    assert set(by_name) == set(BLOCK_SPANS)
    assert all(len(v) == 2 for v in by_name.values())
    first = min(by_name["batch.assemble"], key=lambda e: e["ts"])
    upload = min(by_name["pipeline.upload"], key=lambda e: e["ts"])
    assert first["ts"] + first["dur"] <= upload["ts"]


def test_reset_clears_spans_and_counters():
    trace.reset()
    with _cpu_profile():
        with trace.span("pipeline.upload"):
            trace.count("batch.blocks", 2)
    assert trace.totals()["pipeline.upload"].calls == 1
    assert trace.counters() == {"batch.blocks": 2}
    assert trace.summary()[0].startswith("span pipeline.upload: 1 calls, ")
    assert trace.summary()[0].endswith(" ms a block")
    trace.reset()
    assert trace.totals() == {} and trace.counters() == {}
    assert trace.summary() == ["counters: none"]


def test_cli_batch_profile_writes_trace_and_summary(capture, tmp_path,
                                                    caplog, capsys,
                                                    monkeypatch):
    from gnuais_tpu_torch.runtime import batch
    audio, _ = capture
    raw = tmp_path / "cap.raw"
    audio.astype("<i2").tofile(raw)
    prof = tmp_path / "prof"
    # one short block in place of the default 49,152 samples (the CPU's
    # plain loops)
    monkeypatch.setattr(batch, "decode_files", functools.partial(
        batch.decode_files, block_len=2048))
    with caplog.at_level("INFO", logger="gnuais"):
        rc = cli.main(["--batch", str(raw), "--device", "cpu",
                       "--profile", str(prof)])
    assert rc == 0
    assert len(capsys.readouterr().out.splitlines()) == 1
    traces = sorted(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in
             json.loads(traces[0].read_text())["traceEvents"]}
    assert "gnuais.batch.assemble" in names
    assert "trace: span batch.assemble: 1 calls" in caplog.text
    assert "ms a block" in caplog.text
    assert "trace: counters: ais.messages 1, batch.blocks 1" in caplog.text
    trace.reset()
