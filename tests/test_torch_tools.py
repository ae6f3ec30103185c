"""The port's measurement tools (``diag_strip``, ``profile_flagship``,
``latency_bench``, ``diag_shard``, the counterparts of the JAX system's
``tools/``) on the CPU: each imports without CUDA and refuses the card
when there is none; the profile's trace parser on a ``torch.profiler``
trace taken on the CPU; the latency computation against the port's CLI
on the CPU (``--device cpu --backend golden``); ``diag_strip``'s
arguments, the TPU kernel's Mosaic knobs and ``landing=`` refused by
name."""

import importlib
import time

import pytest
import torch

from gnuais_tpu_torch import diag_strip, latency_bench, profile_flagship

TOOLS = ("diag_strip", "profile_flagship", "latency_bench", "diag_shard")


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_refuses_the_card_without_one(tool, capsys):
    mod = importlib.import_module(f"gnuais_tpu_torch.{tool}")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert mod.main([]) == 1
    err = capsys.readouterr().err
    assert tool in err and "cuda" in err


def test_profile_parser_reads_a_cpu_trace(tmp_path):
    """profile_window's trace of a few CPU ops, read back by parse_trace:
    with the CPU ops as the busy track the idle share lies in [0, 1];
    with the device categories (none on the CPU) the window is idle."""
    x = torch.randn(256, 256)
    prof, wall = profile_flagship.profile_window(
        lambda: (x @ x).relu_().sum(), 3, tmp_path, torch.device("cpu"))
    assert (tmp_path / "trace.json").exists() and wall > 0
    assert prof["by_name"] == {} and prof["idle_share"] == 1.0
    cpu = profile_flagship.parse_trace(tmp_path / "trace.json",
                                       device_cats=("cpu_op",),
                                       hand_written=("aten::mm",))
    assert cpu["count"]["aten::mm"] == 3
    assert 0 < cpu["hand_us"] <= sum(cpu["by_name"].values())
    assert 0.0 <= cpu["idle_share"] <= 1.0
    assert 0 < cpu["busy_us"] <= cpu["wall_us"]


def test_parse_trace_window_is_the_calls_and_the_device_work():
    """The wall spans the annotated calls and the device events, early
    ones included, and no other event of the trace (such as one that
    covers a guard)."""
    mark = profile_flagship.CALL_MARK

    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    trace = {"traceEvents": [
        ev("user_annotation", "ProfilerStep#1", 0.0, 500.0),
        ev("cuda_runtime", "cudaGetDeviceCount", 10.0, 5.0),
        ev("kernel", "pipeline_kernel<2>", 90.0, 60.0),
        ev("user_annotation", mark, 100.0, 100.0),
        ev("user_annotation", mark, 250.0, 100.0),
        ev("kernel", "pipeline_kernel<2>", 255.0, 80.0),
        ev("cuda_runtime", "cudaDeviceSynchronize", 340.0, 5.0),
        ev("overhead", "Activity Buffer Request", 480.0, 10.0)]}
    prof = profile_flagship.parse_trace(trace)
    assert prof["count"] == {"pipeline_kernel<2>": 2}
    assert prof["busy_us"] == 140.0 and prof["wall_us"] == 260.0
    assert prof["idle_share"] == 1.0 - 140.0 / 260.0


def test_profile_window_guards_stay_out_of_the_wall(tmp_path):
    """The guards at the window's ends are idle host time: neither the
    host wall nor the trace's wall holds them."""
    x = torch.randn(64, 64)
    guard = 0.2
    t0 = time.perf_counter()
    prof, wall = profile_flagship.profile_window(
        lambda: (x @ x).sum(), 2, tmp_path, torch.device("cpu"),
        guard_s=guard)
    elapsed = (time.perf_counter() - t0) * 1e3
    assert 0 < wall <= elapsed - 2e3 * guard
    # the traced ops lie inside the host wall (1 ms for the two clocks)
    assert 0 < prof["wall_us"] <= 1e3 * (wall + 1.0)


def test_latency_against_the_cli_on_the_cpu():
    """The sequential station of the port's CLI fed a 5-payload capture
    through a FIFO: every message decoded, each latency the samples fed
    at its line less the frame's end, at most the capture's length."""
    stream, ends, mmsis = latency_bench.build_capture(5)
    rows = latency_bench.run("seq", device="cpu", backend="golden",
                             n_payloads=5)
    (r,) = rows
    assert not r["refused"] and r["decoded"] == r["total"] == 5
    assert 0 < r["p50"] <= r["p90"] <= len(stream)
    assert "decoded" in latency_bench.format_row(r)


@pytest.mark.parametrize("knob", ["unguarded", "unroll=64", "SL=32",
                                  "landing=slot"])
def test_diag_strip_refuses_mosaic_knobs(knob, capsys):
    assert diag_strip.main(["strip=snap", knob]) == 1
    assert knob in capsys.readouterr().err
    opts = diag_strip.parse(["strip=shift,snap", "fir=lobe", "K=2",
                             "pretiled", "prefiltered"])
    assert opts == dict(strip="shift,snap", fir="lobe", n_blocks=2,
                        pretiled=True, prefiltered=True, device="cuda")
    with pytest.raises(ValueError, match="nope"):
        diag_strip.parse(["strip=nope"])
