"""The per-layer metrics read from the program's own tracer
(``gnuais_tpu_torch.runtime.trace``): ms or MB a block from the tracer's
totals, None where it recorded no block or the program has no tracer."""

from __future__ import annotations

import sys

import pytest

from portbench import spec

NEW = ("assemble_ms.archive", "deliver_ms.archive", "readback_ms.archive",
       "readback_mb.archive", "unpack_ms.archive", "account_ms.archive",
       "parse_ms.archive", "nmea_ms.archive")
BLOCKS = 4
TOTALS = {"batch.assemble": (4, 1200.0), "batch.deliver": (4, 400.0),
          "ais.dispatch": (1680, 280.0), "ais.nmea": (1680, 60.0),
          "ais.parse": (1680, 180.0), "pipeline.upload": (4, 260.0),
          "pipeline.readback": (4, 20.0), "pipeline.unpack": (4, 8.0),
          "pipeline.account": (4, 12.0)}
COUNTERS = {"batch.blocks": BLOCKS, "pipeline.d2h_bytes": 4 * 16_842_752,
            "pipeline.d2h_reads": 24, "pipeline.h2d_bytes": 4 * 402_653_184,
            "pipeline.frames": 1680, "ais.messages": 1680}
WANT = {"assemble_ms.archive": 300.0, "deliver_ms.archive": 30.0,
        "readback_ms.archive": 5.0, "readback_mb.archive": 16.842752,
        "unpack_ms.archive": 2.0, "account_ms.archive": 3.0,
        "parse_ms.archive": 45.0, "nmea_ms.archive": 15.0}


def _fill(monkeypatch, totals, counters):
    from gnuais_tpu_torch.runtime import trace
    monkeypatch.setattr(trace, "totals", lambda: {
        k: trace.SpanTotal(*v) for k, v in totals.items()})
    monkeypatch.setattr(trace, "counters", lambda: dict(counters))


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_its_value_a_block(name, monkeypatch):
    _fill(monkeypatch, TOTALS, COUNTERS)
    got = spec.load_module("metrics", name).read({})
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_none_without_a_block(name, monkeypatch):
    _fill(monkeypatch, TOTALS, {k: v for k, v in COUNTERS.items()
                                if k != "batch.blocks"})
    assert spec.load_module("metrics", name).read({}) is None
    _fill(monkeypatch, {}, {})
    assert spec.load_module("metrics", name).read({}) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_none_without_the_programs_tracer(name, monkeypatch):
    """A program without ``runtime.trace``, as before it had one."""
    import gnuais_tpu_torch.runtime as runtime
    monkeypatch.delattr(runtime, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "gnuais_tpu_torch.runtime.trace", None)
    assert spec.load_module("metrics", name).read({}) is None


def test_quiet_cell_lists_the_new_metrics():
    cell = spec.load_cell("archive-4096.quiet")
    names = [m["name"] for m in cell.per_layer]
    assert set(NEW) <= set(names)
    for m in cell.per_layer:
        if m["name"] in NEW:
            assert m["moves"] == "realtime_channels"
            assert m["better"] == "lower"
            assert m["workloads"] == ["archive-4096.quiet"]
