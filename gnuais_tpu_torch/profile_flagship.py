"""Device time by kernel of the flagship dispatch, and the device's idle
share, by ``torch.profiler``: the counterpart of
``tools/profile_flagship.py``:

    python -m gnuais_tpu_torch.profile_flagship [--superblock 12] \\
        [--streams 4096] [--block-len 49152] [--iters 3] \\
        [--outdir build/profile_flagship] [--device cuda]

The flagship superblock as ``chip_smoke.py``'s Path M runs it (the JAX
bench's CONFIGS[0]): K blocks of the JAX bench's 4-payload batch
(``captures.build_batch``, seed 0) tiled time-major into one
[K * T, S] int16 input (``fused.tile_superblock``), decoded by one
``decode_block(pretiled_streams=S, fused_pipeline, kernel_compact,
mxu_fir, assume_full, frame_slots=64)``: one launch of kernel B1 with the
mxu FIR over the K blocks (64 slots for the superblock's 4 K frames a
stream), then the dense frames' CRC.  Two warm dispatches, each
verified (every stream decodes every payload K times), then a warm-up
dispatch and ``--iters`` dispatches under ``torch.profiler`` (CPU and
CUDA activities, the warm-up's trace dropped, a 50 ms guard at each end
of the window: ``profile_window``), each verified and synchronised.  The
trace goes to ``--outdir`` as Chrome JSON; ``parse_trace`` reads it
back: device time by kernel name, split into the hand-written kernels
(``HAND_WRITTEN``) and the rest (copies, fills, the CRC product,
compaction), and the device's idle share of the traced window: 1 - the
union of the device's busy intervals over the window's wall (the span
of the traced calls and of the device's work).  Prints the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path
from typing import Callable, Iterable, Optional

import torch

REPO = Path(__file__).resolve().parents[1]
# the trace categories of device work in torch.profiler's Chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# idle host time between the traced window's bounds and its calls, and
# the annotation of each call (profile_window)
GUARD_S = 0.05
CALL_MARK = "profile_window.call"
# frame slots of the superblock's one decode_block call (phase 7's)
FRAME_SLOTS = 64
# the device kernels written for this port (csrc/): their names contain
# one of these
HAND_WRITTEN = ("pipeline_kernel", "frontend_kernel", "dpll_kernel",
                "hdlc_kernel", "fir_probe_kernel", "chain_kernel",
                "stream_kernel")


def _union_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def parse_trace(trace, device_cats: Iterable[str] = DEVICE_CATS,
                hand_written: Iterable[str] = HAND_WRITTEN) -> dict:
    """A Chrome trace (a path, or the loaded dict) of ``torch.profiler``:
    {"by_name": {name: us}, "count": {name: n} of the events whose
    category is in ``device_cats``, "hand_us" and "other_us" (their sum
    split by ``hand_written``), "busy_us" (the union of their intervals),
    "wall_us" (the span of those events and of the ``CALL_MARK``
    annotations: ``profile_window``'s calls),
    "idle_share" (1 - busy / wall; 1.0 for an empty window)}."""
    if not isinstance(trace, dict):
        trace = json.loads(Path(trace).read_text())
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    cats = set(device_cats)
    dev = [e for e in events if e.get("cat") in cats]
    by_name = collections.Counter()
    count = collections.Counter()
    for e in dev:
        by_name[e["name"]] += float(e["dur"])
        count[e["name"]] += 1
    hand = sum(us for n, us in by_name.items()
               if any(h in n for h in hand_written))
    busy = _union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in dev)
    spans = dev + [e for e in events if e.get("name") == CALL_MARK]
    if spans:
        wall = (max(float(e["ts"]) + float(e["dur"]) for e in spans)
                - min(float(e["ts"]) for e in spans))
    else:
        wall = 0.0
    return {"by_name": dict(by_name), "count": dict(count),
            "hand_us": hand, "other_us": sum(by_name.values()) - hand,
            "busy_us": busy, "wall_us": wall,
            "idle_share": 1.0 - busy / wall if wall > 0 else 1.0}


def profile_window(fn: Callable[[], None], iters: int, outdir,
                   device: torch.device,
                   warmup: Optional[Callable[[], None]] = None,
                   guard_s: float = GUARD_S) -> tuple:
    """``fn`` called ``iters`` times under ``torch.profiler`` (the CUDA
    activity on a card) after one warm-up call (``warmup``, or ``fn``)
    that the profiler traces and drops (its schedule's warm-up step: the
    tracer's start-up costs land there), the trace exported to
    ``outdir`` as ``trace.json``; returns (its ``parse_trace``, the
    traced calls' wall ms on the host clock).

    The tracer keeps only the device events whose timestamps, moved onto
    the host clock, fall inside the window it opened, and that move can
    be off by milliseconds: on an H100 one window in 20 without a margin
    lost the first call's kernels, whose timestamps came out 3.5 ms
    early.  So the window opens ``guard_s`` before the first traced call
    and closes ``guard_s`` after the last.  Each traced call, with its
    synchronisation, runs under the annotation ``CALL_MARK``, so that
    ``parse_trace``'s wall, like the returned one, leaves the guards
    out."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    path = outdir / "trace.json"
    sync()
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=iters, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))
                 ) as prof:
        (warmup or fn)()
        sync()
        prof.step()
        time.sleep(guard_s)
        t0, wall = time.perf_counter(), 0.0
        for i in range(iters):
            with record_function(CALL_MARK):
                fn()
                sync()
            if i == iters - 1:
                wall = (time.perf_counter() - t0) * 1e3
                time.sleep(guard_s)
            prof.step()
    return parse_trace(path), wall


def flagship(n_streams: int, block_len: int, superblock: int, device):
    """(step, frames expected a stream): ``step()`` runs one flagship
    dispatch and raises unless every stream decoded them all."""
    from . import captures
    from .ops import fused
    from .runtime.pipeline import decode_block, init_carry
    batch, n_pay = captures.build_batch(n_streams, block_len, 4, seed=0)
    x = torch.from_numpy(batch).to(device)
    tiled = fused.tile_superblock(x.repeat(1, superblock), 1)[0]
    del x
    total = block_len * superblock
    want = n_pay * superblock
    state = {"carry": init_carry(n_streams, device)}

    def step():
        carry, frames, _ = decode_block(
            tiled, total, state["carry"], frame_slots=FRAME_SLOTS,
            fused_pipeline=True, kernel_compact=True, mxu_fir=True,
            assume_full=True, with_peak=False, pretiled_streams=n_streams)
        state["carry"] = carry
        if not bool((frames.count == want).all()):
            raise RuntimeError(f"a stream decoded {int(frames.count.min())}"
                               f" frames, {want} sent")
    return step, want


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--superblock", type=int, default=12)
    ap.add_argument("--streams", type=int, default=4096)
    ap.add_argument("--block-len", type=int, default=49_152)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--outdir", default=str(REPO / "build" /
                                            "profile_flagship"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from . import card
    from .device import resolve_device
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"profile_flagship: {e}", file=sys.stderr)
        return 1
    res = run(args.streams, args.block_len, args.superblock, args.iters,
              args.outdir, dev)
    print(f"warm; verified {res['frames']} frames a stream per dispatch")
    print(f"traced {args.iters} dispatches in {res['wall_ms']:.1f} ms: "
          f"{res['gsamp_s']:.2f} Gsamp/s (host clock, synchronised)")
    print(format_profile(res["profile"], args.iters))
    print(card.smi() if dev.type == "cuda" else "cpu")
    return 0


def run(n_streams: int = 4096, block_len: int = 49_152, superblock: int = 12,
        iters: int = 3, outdir=None, device="cuda") -> dict:
    """The tool's protocol; returns {"profile": parse_trace of the window,
    "wall_ms", "gsamp_s", "frames"}."""
    device = torch.device(device)
    outdir = outdir or REPO / "build" / "profile_flagship"
    step, want = flagship(n_streams, block_len, superblock, device)
    for _ in range(2):
        step()
    prof, wall = profile_window(step, iters, outdir, device)
    n = iters * n_streams * block_len * superblock
    return {"profile": prof, "wall_ms": wall, "gsamp_s": n / wall / 1e6,
            "frames": want}


def format_profile(prof: dict, iters: int, top: int = 20) -> str:
    """The device time by kernel, the split and the idle share, as
    lines."""
    total = sum(prof["by_name"].values())
    lines = [f"device time {total / 1e3:.3f} ms over {iters} calls: "
             f"hand-written kernels {prof['hand_us'] / 1e3:.3f} ms, the rest "
             f"{prof['other_us'] / 1e3:.3f} ms; busy {prof['busy_us'] / 1e3:.3f}"
             f" of {prof['wall_us'] / 1e3:.3f} ms traced: idle share "
             f"{prof['idle_share']:.4f}",
             f"{'kernel':<64} {'ms':>9} {'%':>6} {'n':>5}"]
    for name, us in sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"{name[:64]:<64} {us / 1e3:>9.3f} "
                     f"{100 * us / max(total, 1e-9):>5.1f}% "
                     f"{prof['count'][name]:>5}")
    return "\n".join(lines)


if __name__ == "__main__":
    sys.exit(main())
