"""The benchmark's own tests, on the CPU at sizes a test run holds:
``python -m pytest portbench/tests``.  The program runs its kernels'
plain versions here; nothing is timed against a limit."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import checks, faults, guard, run, spec
from portbench.generators import slots
from portbench.reference.chain import PlainReceiver

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# the busy mix has no cell in BENCHMARK.json (PERF.md: its host-bound
# rate spreads too widely between runs for a bound); the tests run it as
# a cell of their own, with the quiet cell's metrics
BUSY = {"name": "archive-4096.busy", "config": "archive-4096",
        "traffic": "busy-coastal", "chips": 1, "why": "the tests' busy cell"}


def with_busy(bench: dict) -> dict:
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append(BUSY)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "archive-4096.quiet" in m.get("workloads", ()):
            m["workloads"].append(BUSY["name"])
    return bench


TEST_BENCH = with_busy(BENCH)
CPU = torch.device("cpu")
SEED = 2 ** 31 + 12_345   # beyond 32 signed bits, as the driver's are


def traffic(name):
    return spec.load_json("traffic", name)


def small(cell_name, **over):
    """A cell of BENCHMARK.json cut to a CPU test's size."""
    cell = spec.load_cell(cell_name, TEST_BENCH)
    size = dict(streams=6 if "busy" in cell_name else 64, block_len=4096,
                reference_streams=3)
    size.update(over)
    cell.config = dict(cell.config, **size)
    return cell


# ---------------------------------------------------------------- generator

@pytest.mark.parametrize("name,rate", [("busy-coastal", 10.0),
                                       ("quiet-remote", 0.1)])
def test_generator_slots_rate_and_period(name, rate):
    t = traffic(name)
    tr = slots.build(t, 128, SEED, CPU)
    slot = t["slot_bits"] * t["samples_per_bit"]
    assert slot == 1280 and tr.cycle == t["cycle_slots"] * slot == 245_760
    assert tr.samples.shape == (128, tr.cycle)
    starts = [f.start for fs in tr.pool for f in fs]
    assert all(s % slot == 0 for s in starts)          # slot boundaries
    assert all(int(s) % slot == 0 for s in tr.shift)  # whole slots
    n = sum(len(tr.frames(i, tr.cycle * 3, damaged=d))
            for i in range(128) for d in (False, True))
    per_channel_second = n / 128 / (3 * tr.cycle / t["sample_rate"])
    assert abs(per_channel_second - rate) / rate < 0.05
    damaged = sum(f.damaged for fs in tr.pool for f in fs)
    total = sum(len(fs) for fs in tr.pool)
    assert damaged == round(total * t["damaged_share"]) > 0
    static = sum(f.msg_type == 5 for fs in tr.pool for f in fs)
    pos = sum(f.msg_type != 5 for fs in tr.pool for f in fs)
    assert static == round((static + pos) / 37)
    # the same seed gives the same input; another seed other frames but
    # the same amount of work
    again = slots.build(t, 128, SEED, CPU)
    assert np.array_equal(again.samples, tr.samples)
    other = slots.build(t, 128, SEED + 1, CPU)
    assert not np.array_equal(other.samples, tr.samples)
    assert sum(len(fs) for fs in other.pool) == len(starts)


def test_generator_period_has_no_seam():
    """The clean signal of every schedule repeats without a level jump:
    the noise-free stream of two cycles is the cycle twice."""
    t = dict(traffic("busy-coastal"), noise_sigma=0.0)
    tr = slots.build(t, 8, SEED, CPU)
    lv = np.sign(tr.samples.astype(np.int32))
    assert (lv[:, 0] == lv[:, -1]).all()


@pytest.mark.parametrize("name", ["busy-coastal", "quiet-remote"])
def test_reference_decodes_the_encoded_frames(name):
    """The plain reference decoder gets the encoded payloads from the
    generated samples, four cycles long, in order, and counts each
    damaged frame as a wrong CRC.  On the quiet mix it loses some frames
    that come after long idle from a cold start, as gnuais does, and
    none after it has decoded one; on the busy mix it loses none."""
    tr = slots.build(traffic(name), 64, SEED, CPU)
    end = 4 * tr.cycle
    lost = 0
    for i in range(0, 64, 3 if "busy" in name else 1):
        frames, counters = checks.plain_decode(tr.samples[i], end)
        want = tr.frames(i, end)
        got = [(e, fr.payload_bits[:fr.bufferlen]) for e, fr in frames]
        k = 0
        for st, last, payload in want:
            if (k < len(got) and last < got[k][0] < last + checks.GUARD
                    and np.array_equal(got[k][1], payload)):
                k += 1
            else:
                lost += 1
                assert k == 0, "a frame lost after the first decoded one"
        assert k == len(got) == counters[0]
        damaged = tr.frames(i, end, damaged=True)
        assert counters[2] == 0 and counters[1] <= len(damaged)
        if k and not lost:
            assert counters[1] == len(damaged)
    assert (lost > 0) == ("quiet" in name)


def test_reference_fir_and_dpll_equal_their_plain_forms():
    """The reference's FIR rounds each product and sum to float32 in
    the C loop's order, and its DPLL, a run of equal decisions at a
    time, gives what the DPLL a sample at a time gives."""
    from portbench.reference import chain
    rng = np.random.default_rng(3)
    x = rng.normal(0, 4000, 5000).astype(np.int16)
    fir = chain.GoldenFir()
    got = np.concatenate([fir.run(x[:1234]), fir.run(x[1234:])])
    xs = np.concatenate([np.zeros(36, np.float32), x.astype(np.float32)])
    want = np.zeros(len(x), np.float32)
    for i, tap in enumerate(fir.taps):
        want = (want + xs[i:i + len(x)] * tap).astype(np.float32)
    assert np.array_equal(got, want)
    a, b = chain.GoldenDpll(), chain.GoldenDpll()
    for part in np.array_split(want, 7):
        ra, rb = a.run(part), b.run_per_sample(part)
        assert np.array_equal(ra[0], rb[0]) and np.array_equal(ra[1], rb[1])
        assert a.state == b.state


def test_plain_decode_shortcut_equals_full_decode():
    tr = slots.build(traffic("quiet-remote"), 4, SEED, CPU)
    total = 6 * tr.cycle + 12_345
    for i in range(4):
        fast, c_fast = checks.plain_decode(tr.samples[i], total)
        rx = PlainReceiver()
        full = []
        for _ in range(6):
            full += rx.run_block(tr.samples[i])
        full += rx.run_block(tr.samples[i][:12_345])
        assert [e for e, _ in fast] == [e for e, _ in full]
        assert c_fast == rx.counters


# ------------------------------------------------------ the checks' numbers

def _msg(payload):
    from portbench.reference.dispatch import ChannelDispatcher
    return ChannelDispatcher("A").dispatch(payload, len(payload))


def test_stream_delivery_counts_missed_extra_and_due():
    rng = np.random.default_rng(0)
    from portbench import encoder as E
    pays = [E.position_report(rng, 1, 257_000_000 + k) for k in range(4)]
    # four frames, one a 2000-sample block, delivered in their block
    expected = [(k * 2000 + 100, k * 2000 + 1200, p)
                for k, p in enumerate(pays)]
    msgs = [_msg(p) for p in pays]
    ok = checks.stream_delivery(msgs[:3], [0, 1, 2], expected, [],
                                (3, 0, 0), 6000, 2000)
    assert ok == {"due": 3, "missed": [], "extra": 0, "counters_ok": True}
    late = checks.stream_delivery(msgs[:1], [0], expected, [], (1, 0, 0),
                                  6000, 2000)
    assert late["missed"] == [1, 2] and late["counters_ok"]
    lost = checks.stream_delivery([msgs[0], msgs[2]], [0, 2], expected, [],
                                  (2, 0, 0), 6000, 2000)
    assert lost["missed"] == [1] and lost["extra"] == 0
    swapped = checks.stream_delivery([msgs[1], msgs[0]], [1, 1], expected,
                                     [], (2, 0, 0), 6000, 2000)
    assert swapped["extra"] == 1 and swapped["missed"] == [0, 2]
    twice = checks.stream_delivery([msgs[0], msgs[0], msgs[1]], [0, 0, 1],
                                   expected, [], (3, 0, 0), 6000, 2000)
    assert twice["extra"] == 1 and twice["missed"] == [2]
    # a repeated payload pairs with the copy of the block it came in
    again = expected[:1] + [(4100, 5200, pays[0])]
    late_copy = checks.stream_delivery([msgs[0]], [2], again, [], (1, 0, 0),
                                       6000, 2000)
    assert late_copy["missed"] == [0] and late_copy["extra"] == 0
    # a damaged frame due has to be counted as a wrong CRC; one in the
    # last GUARD samples may be
    bad = [(3000, 3100, pays[3]), (5990, 5995, pays[3])]
    assert checks.stream_delivery(msgs[:3], [0, 1, 2], expected, bad,
                                  (3, 1, 0), 6000, 2000)["counters_ok"]
    assert checks.stream_delivery(msgs[:3], [0, 1, 2], expected, bad,
                                  (3, 2, 0), 6000, 2000)["counters_ok"]
    assert not checks.stream_delivery(msgs[:3], [0, 1, 2], expected, bad,
                                      (3, 0, 0), 6000, 2000)["counters_ok"]
    assert not checks.stream_delivery(msgs[:3], [0, 1, 2], expected, [],
                                      (2, 0, 0), 6000, 2000)["counters_ok"]


def test_judged_delivery_excuses_only_the_references_losses():
    """A stream on which the reference loses a frame from its cold start:
    the program that delivers what the reference decodes falls short of
    the encoded frames, and is sound against the reference; leaving out
    one frame more is not."""
    t = traffic("quiet-remote")
    tr = slots.build(t, 64, SEED, CPU)
    bl, end = 4096, 4 * tr.cycle
    for i in range(64):
        expected = tr.frames(i, end)
        frames, counters = checks.plain_decode(tr.samples[i], end)
        if expected and len(frames) < len(expected):
            break
    else:
        pytest.fail("no stream loses a frame")
    msgs = [_msg(fr.payload_bits[:fr.bufferlen]) for _, fr in frames]
    blocks = [e // bl for e, _ in frames]
    damaged = tr.frames(i, end, damaged=True)
    short = checks.stream_delivery(msgs, blocks, expected, damaged,
                                   counters, end, bl)
    assert short["missed"] and short["extra"] == 0
    slot = t["slot_bits"] * t["samples_per_bit"]
    free = ((t["cycle_slots"] - 1) * slot + int(tr.shift[i])) % tr.cycle
    cut = free + 2 * tr.cycle
    sound = checks.judged_delivery(msgs, blocks, tr.samples[i], expected,
                                   damaged, counters, end, bl, cut)
    assert sound["missed"] == [] and sound["extra"] == 0
    assert sound["counters_ok"] and sound["lost_by_both"] == len(
        short["missed"])
    less = checks.judged_delivery(msgs[:-1], blocks[:-1], tr.samples[i],
                                  expected, damaged,
                                  (counters[0] - 1,) + counters[1:], end,
                                  bl, cut)
    assert len(less["missed"]) == 1


def test_tally_counts_only_what_the_program_loses():
    """A run's ``attempted`` and ``failed`` (``checks.tally``) on the
    quiet mix, where the reference loses frames of some streams from
    their idle cold start and a sound program delivers what the
    reference decodes: ``failed`` reads 0 and ``attempted`` the
    reference's frames due, at 4 cycles and at 12, where ``attempted``
    grows by the frames of the 8 cycles more alone.  One frame left out
    of a stream the reference lost a frame of reads ``failed`` 1; with no
    budget for the reference, every miss against the encoded frames
    counts."""
    t = traffic("quiet-remote")
    tr = slots.build(t, 64, SEED, CPU)
    bl, slot = 4096, t["slot_bits"] * t["samples_per_bit"]
    free = (t["cycle_slots"] - 1) * slot
    got = {}
    for cycles in (4, 12):
        end = cycles * tr.cycle
        delivered, blocks, counters, ref_due, enc_due = [], [], [], 0, 0
        for i in range(64):
            frames, c = checks.plain_decode(tr.samples[i], end)
            delivered.append([_msg(fr.payload_bits[:fr.bufferlen])
                              for _, fr in frames])
            blocks.append([e // bl for e, _ in frames])
            counters.append(c)
            ref_due += sum(1 for e, _ in frames if e - 1 < end - checks.GUARD)
            enc_due += sum(1 for e in tr.frames(i, end)
                           if e[1] < end - checks.GUARD)

        def tally(delivered=delivered, blocks=blocks, counters=counters,
                  budget=3072):
            return checks.tally(tr, delivered, blocks, counters, end, bl,
                                free, budget, np.random.default_rng(SEED))
        sound = tally()
        assert sound["failed"] == sound["counters"] == 0, sound
        assert sound["attempted"] == ref_due
        assert sound["lost_by_both"] == enc_due - ref_due > 0
        assert sound["short"] > 0 and sound["unjudged"] == 0
        got[cycles] = sound, enc_due
        # one frame more left out of a stream the reference lost one of
        i = next(i for i in range(64) if delivered[i] and (
            len(delivered[i]) < len(tr.frames(i, end))))
        less = tally(
            delivered[:i] + [delivered[i][:-1]] + delivered[i + 1:],
            blocks[:i] + [blocks[i][:-1]] + blocks[i + 1:],
            counters[:i] + [(counters[i][0] - 1,) + counters[i][1:]]
            + counters[i + 1:])
        assert less["failed"] == 1 and less["attempted"] == ref_due
        unjudged = tally(budget=0)
        assert unjudged["unjudged"] == sound["short"]
        assert unjudged["attempted"] == enc_due
        assert unjudged["failed"] == enc_due - ref_due
    (s4, e4), (s12, e12) = got[4], got[12]
    assert s12["attempted"] - s4["attempted"] == e12 - e4 > 0
    assert s12["lost_by_both"] == s4["lost_by_both"]


def test_stall_lowers_rate(monkeypatch):
    """A stall inside the window lowers ``realtime_channels``, measured
    by the driver itself."""
    from gnuais_tpu_torch.runtime.batch import BatchSession

    def e2e(cell, seconds):
        res = run.execute(cell, SEED, seconds, False, CPU,
                          t_start=time.perf_counter())
        assert res["correct"]
        return res["metrics"]["realtime_channels"]["value"]

    archive = small("archive-4096.busy")
    base = e2e(archive, 2.0)
    orig, calls = BatchSession.run, []

    def stalled(self, *a, **k):
        calls.append(1)
        if len(calls) == 2:                 # the window's second block
            time.sleep(3.0)
        return orig(self, *a, **k)
    monkeypatch.setattr(BatchSession, "run", stalled)
    assert e2e(archive, 2.0) < 0.8 * base


# ---------------------------------------------------- correct and its faults

@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", ["archive-4096.busy"])
def test_faulty_timed_path_is_not_correct(cell, fault):
    """The rest of a run, the chip look skipped, with the timed path
    broken underneath: ``correct`` comes out false; sound, true.  The
    control is ``drop``: one frame a step not delivered."""
    res = run.execute(small(cell), SEED, 2.0, False, CPU, fault,
                      t_start=time.perf_counter())
    assert res["correct"] is False, res["checks"]
    if fault == "drop":
        assert res["failed"] > 0, res
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", ["archive-4096.busy", "archive-4096.quiet"])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct_and_reports_its_metrics(cell, trace):
    c = small(cell)
    res = run.execute(c, SEED, 2.0, trace, CPU, t_start=time.perf_counter())
    assert res["correct"], res["checks"]
    # the quiet mix sends a frame a channel about every 10 s: a short
    # window of a few channels may hold none
    assert res["failed"] == 0
    assert res["attempted"] > 0 or "quiet" in cell
    want = {m["name"] for m in c.metrics(trace)}
    got = set(res["metrics"])
    if trace:
        # device numbers come from a card only
        assert got <= want and not any(
            n.startswith(("b2_roofline", "device_idle", "step_ms"))
            for n in got)
        assert got, "a traced run reports its host spans"
        assert "breakdown" in res
    else:
        assert got == want
    assert json.loads(json.dumps(res)) == res


# --------------------------------------------------------- the import guard

def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["gnuais_tpu_torch", "gnuais_tpu_torch.cli",
                                    "jaxtyping", "flaxen"]) == []
    assert guard.forbidden_modules(["jax", "jax.numpy", "gnuais_tpu.ops",
                                    "jaxlib", "flax.linen"]) == [
        "flax.linen", "gnuais_tpu.ops", "jax", "jax.numpy", "jaxlib"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_harness_and_reference_imports():
    files = sorted((ROOT / "portbench").rglob("*.py"))
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & set(guard.FORBIDDEN), f
        if "reference" in f.parts or f.name in ("encoder.py", "checks.py"):
            assert "gnuais_tpu_torch" not in tops, f


def test_a_run_loads_no_forbidden_module():
    code = ("import sys, time, torch; sys.argv = ['x'];"
            "from portbench import run, spec, guard;"
            f"c = spec.load_cell('archive-4096.busy', {TEST_BENCH!r});"
            "c.config = dict(c.config, streams=2, block_len=4096,"
            " reference_streams=1);"
            "r = run.execute(c, 7, 0.5, False, torch.device('cpu'),"
            " t_start=time.perf_counter());"
            "print(guard.forbidden_modules(), r['correct'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.stdout.strip().splitlines()[-1] == "[] True", out.stderr


def test_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          "archive-4096.quiet", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert out.returncode != 0 and out.stdout.strip() == ""


# -------------------------------------------------------- BENCHMARK.json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_names_units_and_files():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in b["configs"]] \
        + [w["name"] for w in b["workloads"]]
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cfg = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert cfg["reduced"] == configs[w["config"]]["reduced"] == []
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        cell = spec.load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported
    assert len(json.dumps(b)) < 64 * 1024


def test_new_cell_and_mix_are_files_and_entries_only(tmp_path, monkeypatch):
    """A new traffic mix and a cell over it, added as a new file and a
    new entry, run without a change to any file that is there."""
    before = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    mix = dict(traffic("busy-coastal"), frames_per_channel_second=3.0)
    path = ROOT / "portbench" / "traffic" / "test-moderate.json"
    path.write_text(json.dumps(mix))
    try:
        bench = json.loads(json.dumps(BENCH))
        bench["workloads"].append({"name": "archive-4096.moderate",
                                   "config": "archive-4096",
                                   "traffic": "test-moderate", "chips": 1,
                                   "why": "a test"})
        bench["end_to_end"][0]["workloads"].append("archive-4096.moderate")
        cell = spec.load_cell("archive-4096.moderate", bench)
        assert cell.traffic["frames_per_channel_second"] == 3.0
        cell.config = dict(cell.config, streams=4, block_len=4096,
                           reference_streams=2)
        res = run.execute(cell, SEED, 1.0, False, CPU,
                          t_start=time.perf_counter())
        assert res["correct"] and "realtime_channels" in res["metrics"]
    finally:
        path.unlink()
    after = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert after == before


@pytest.mark.cuda
def test_control_on_the_card_is_not_correct():
    """The control at a cut size on the card: one frame a step left
    undelivered comes out not correct (the full-size runs are in
    PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = small("archive-4096.busy", streams=256, block_len=49_152)
    res = run.execute(c, SEED, 2.0, False, torch.device("cuda", 0), "drop",
                      t_start=time.perf_counter())
    assert res["correct"] is False
