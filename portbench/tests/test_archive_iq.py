"""The raw-IQ archive cell (``drivers/archive_iq.py``) on the CPU at sizes
a test run holds: its modulation, its decode of a stream whose first
cycle differs, the ``frontend`` check and the control, the annotation
reader and the front end's bound."""

from __future__ import annotations

import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import annotations, checks, iqwork, run, spec
from portbench.drivers import archive_iq
from portbench.generators import slots
from portbench.reference import iq as ref_iq

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")
SEED = 2 ** 31 + 12_345   # beyond 32 signed bits, as the driver's are
CELL = "archive-iq-4096.quiet"


def small(traffic="busy-coastal", **over):
    """The IQ cell over ``traffic``, cut to a CPU test's size."""
    bench = json.loads(json.dumps(BENCH))
    name = f"archive-iq-4096.{traffic}"
    if name != CELL:
        bench["workloads"].append({"name": name, "config": "archive-iq-4096",
                                   "traffic": traffic, "chips": 1,
                                   "why": "a test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if CELL in m.get("workloads", ()):
                m["workloads"].append(name)
    cell = spec.load_cell(name, bench)
    size = dict(streams=6, block_len=4096, reference_streams=3)
    size.update(over)
    cell.config = dict(cell.config, **size)
    return cell


def test_modulation_closes_the_cycle_at_unit_amplitude():
    t = spec.load_json("traffic", "quiet-remote")
    tr = slots.build(t, 3, SEED, CPU)
    iq, offsets = archive_iq.modulate(tr.samples, t["amplitude"], 2400.0, 4,
                                      CPU)
    assert iq.shape == (2, 3, tr.cycle * 4) and iq.dtype == np.float32
    assert np.abs(offsets).max() < 0.5 / 5.12 + 1e-9
    assert np.allclose(iq[0] ** 2 + iq[1] ** 2, 1.0, atol=1e-6)
    z = iq[0].astype(np.float64) + 1j * iq[1]
    # the seam: the last sample at phase 0, the first one step after it
    assert np.allclose(z[:, -1], 1.0)
    step = np.angle(z[:, 0] * np.conj(z[:, -1]))
    want = (2 * math.pi * 2400 / t["amplitude"] / 192_000
            * tr.samples[:, 0] + 2 * math.pi * offsets / 192_000)
    assert np.allclose(step, want, atol=1e-5)
    # inside the cycle the discriminator reads the audio's frequency
    audio, _ = ref_iq.frontend(torch.from_numpy(iq[0]),
                               torch.from_numpy(iq[1]),
                               ref_iq.start(3, CPU), 4)
    lag = audio[:, 100:-100].numpy().astype(np.float64)
    level = tr.samples[:, 92:-108] * (2400 / t["amplitude"] / 96_000
                                      * 32767)
    assert np.corrcoef(lag.ravel(), level.ravel())[0, 1] > 0.99


def test_plain_decode_from_equals_plain_decode_on_a_periodic_stream():
    t = spec.load_json("traffic", "busy-coastal")
    tr = slots.build(t, 2, SEED, CPU)
    for total in (tr.cycle * 2 + 777, tr.cycle // 3):
        got = archive_iq.plain_decode_from(tr.samples[0], tr.samples[0],
                                           total)
        want = checks.plain_decode(tr.samples[0], total)
        assert got[1] == want[1]
        assert [(e, f.payload_bits.tolist()) for e, f in got[0]] == \
            [(e, f.payload_bits.tolist()) for e, f in want[0]]


def test_plain_decode_from_decodes_the_first_cycle_apart():
    """``first`` then ``cycle`` three times and a part: what one receiver
    decodes of the whole stream, block after block."""
    from portbench.reference.chain import PlainReceiver
    t = spec.load_json("traffic", "busy-coastal")
    tr = slots.build(t, 2, SEED, CPU)
    first, later = tr.samples[0], tr.samples[1]
    total = 3 * tr.cycle + 5000
    got, counters = archive_iq.plain_decode_from(first, later, total)
    rx = PlainReceiver()
    want = rx.run_block(first, None)
    for _ in range(2):
        want += rx.run_block(later, None)
    want += rx.run_block(later[:5000], None)
    assert [(e, f.payload_bits.tolist()) for e, f in got] == \
        [(e, f.payload_bits.tolist()) for e, f in want]
    assert counters == tuple(rx.counters) and len(want) > 0


def test_sound_run_is_correct_and_reports_its_metrics():
    c = small()
    res = run.execute(c, SEED, 2.0, False, CPU, t_start=time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["checks"]) == {"delivery", "counters", "reference",
                                  "frontend", "frontend_1lsb"}
    assert res["checks"]["frontend"]["value"] == 0
    assert set(res["metrics"]) == {m["name"] for m in c.metrics(False)}


@pytest.mark.parametrize("fault,check", [("drop", "delivery"),
                                         ("bf16", "frontend"),
                                         ("fp16", "frontend_1lsb")])
def test_faulty_run_is_not_correct(fault, check):
    """The control (a stream's last frame a step undelivered) and a front
    end rounded through a 16-bit float come out not correct, each by its
    check; bf16 moves samples by more than 1 LSB, fp16 (11 bits for
    values under 2048) by 1 on far more than one in 1000."""
    res = run.execute(small(), SEED, 2.0, False, CPU, fault,
                      t_start=time.perf_counter())
    assert res["correct"] is False
    c = res["checks"][check]
    assert c["value"] > c["limit"], res["checks"]
    if fault == "drop":
        assert res["failed"] > 0


def test_a_program_without_the_iq_session_fails_before_any_traffic(
        monkeypatch):
    from gnuais_tpu_torch.runtime import batch

    class Session:                       # the int16 session's parameters
        def __init__(self, names, block_len=49_152, frame_slots=64,
                     backend="exact", device="cuda",
                     message_callback=None):
            raise AssertionError("built")

    class Generator:
        @staticmethod
        def build(*a, **k):
            raise AssertionError("traffic made")

    monkeypatch.setattr(batch, "BatchSession", Session)
    with pytest.raises(RuntimeError, match="no IQ"):
        archive_iq.run(small(), Generator, SEED, 1.0, False, CPU, None,
                       time.perf_counter())


def _event(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_annotation_reader_counts_the_kernels_launched_inside():
    trace = {"traceEvents": [
        _event(archive_iq.FRONTEND, "user_annotation", 100, 50),
        _event(archive_iq.FRONTEND, "gpu_user_annotation", 100, 500,
               tid=9),
        _event("cudaLaunchKernel", "cuda_runtime", 110, 2, corr=1),
        _event("cudaLaunchKernel", "cuda_runtime", 140, 2, corr=2),
        _event("cudaLaunchKernel", "cuda_runtime", 160, 2, corr=3),
        _event("cudaLaunchKernel", "cuda_runtime", 120, 2, tid=2, corr=4),
        _event("k1", "kernel", 200, 30, tid=9, corr=1),
        _event("k2", "kernel", 240, 20, tid=9, corr=2),
        _event("k3", "kernel", 260, 40, tid=9, corr=3),
        _event("k4", "kernel", 300, 40, tid=9, corr=4)]}
    assert annotations.under(trace, archive_iq.FRONTEND) == (2, 50.0)
    ctx = {"blocks": 2, "profile": {"under": {archive_iq.FRONTEND:
                                              (2, 50.0)}},
           "frontend_bound_ms": 0.01}
    assert annotations.per_block(ctx, archive_iq.FRONTEND) == (1.0, 0.025)
    read = {n: spec.load_module("metrics", n).read(ctx) for n in
            ("frontend_ms.iq", "frontend_launches.iq",
             "frontend_roofline.iq")}
    assert read == pytest.approx({"frontend_ms.iq": 0.025,
                                  "frontend_launches.iq": 1.0,
                                  "frontend_roofline.iq": 20.0})
    for n in read:
        assert spec.load_module("metrics", n).read({"blocks": 2}) is None


def test_frontend_bound_at_the_cells_size():
    """4096 streams of a 49,152-sample block at decim 4: 6.85 GB at 3.35
    TB/s, longer than 32.4 GFLOP at 67 TFLOP/s."""
    ms = iqwork.frontend_bound_ms(4096, 49_152 * 4, 4)
    assert ms == pytest.approx(4096 * (8 * 196_608 + 2 * 49_152)
                               / 3.35e9)
    assert 2.0 < ms < 2.1


def test_cell_is_new_entries_and_lists_its_metrics():
    cell = spec.load_cell(CELL)
    assert cell.config["driver"] == "archive_iq" and cell.chips == 1
    names = {m["name"] for m in cell.per_layer}
    assert names == {"assemble_ms.iq", "upload_ms.iq", "frontend_ms.iq",
                     "frontend_launches.iq", "frontend_roofline.iq",
                     "step_ms.iq", "device_idle.iq"}
    assert {m["name"] for m in cell.end_to_end} == {"realtime_channels",
                                                    "setup_s"}
