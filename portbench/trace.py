"""What a traced run (``--trace 1``) records: spans of the benchmark's
own wrappers around calls into the program's layers, and the device's
work from ``torch.profiler``.

``parse_trace`` and ``union_us`` are copies of the port's
``profile_flagship.parse_trace`` arithmetic (device time by kernel name,
busy time as the union of the device's intervals, the idle share of
the traced window); ``idle_gaps`` adds which of the benchmark's coarse
host spans was open in each gap between device work.
"""

from __future__ import annotations

import collections
import gc
import json
import os
import resource
import tempfile
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_MARK = "portbench.window"
SPAN_PREFIX = "portbench."
GUARD_S = 0.05


class Spans:
    """Host spans by name: a running total for the current unit of work
    (a block), closed into a list by ``close_unit``.  With
    ``mark`` the span is also a ``record_function`` annotation, so that
    the profiler's trace holds it on its own clock (coarse spans only:
    an annotation costs microseconds)."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.sync = sync or (lambda: None)
        self.current: Dict[str, float] = collections.defaultdict(float)
        self.units: List[Dict[str, float]] = []

    def add(self, name: str, ms: float) -> None:
        self.current[name] += ms

    def wrap(self, fn: Callable, name: str, sync: bool = False,
             mark: bool = False) -> Callable:
        """``fn`` with its host time added to ``name`` (after a device
        synchronisation where ``sync``)."""
        def wrapped(*args, **kwargs):
            ctx = (torch.profiler.record_function(SPAN_PREFIX + name) if mark
                   else _null())
            with ctx:
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if sync:
                    self.sync()
                self.current[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapped

    def close_unit(self) -> None:
        self.units.append(dict(self.current))
        self.current = collections.defaultdict(float)

    def mean(self, name: str) -> Optional[float]:
        """``name``'s mean over the closed units (None where no unit
        has it)."""
        if not any(name in u for u in self.units):
            return None
        return sum(u.get(name, 0.0) for u in self.units) / len(self.units)


@contextmanager
def _null():
    yield


def union_us(intervals) -> float:
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


def _merged(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def parse_trace(trace: dict) -> dict:
    """Device time by kernel name and its count, busy time (the union of
    the device's intervals), the window's wall (the ``WINDOW_MARK``
    annotation's span) and the idle share of it, and the ten longest
    idle gaps inside the window with the innermost benchmark span that
    was open over each."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    by_name = collections.Counter()
    count = collections.Counter()
    for e in dev:
        by_name[e["name"]] += float(e["dur"])
        count[e["name"]] += 1
    marks = [e for e in events if e.get("name") == WINDOW_MARK]
    if marks:
        lo = min(float(e["ts"]) for e in marks)
        hi = max(float(e["ts"]) + float(e["dur"]) for e in marks)
    elif dev:
        lo = min(float(e["ts"]) for e in dev)
        hi = max(float(e["ts"]) + float(e["dur"]) for e in dev)
    else:
        lo = hi = 0.0
    busy_iv = [(max(lo, float(e["ts"])),
                min(hi, float(e["ts"]) + float(e["dur"]))) for e in dev]
    busy_iv = [(a, b) for a, b in busy_iv if b > a]
    busy = union_us(busy_iv)
    wall = hi - lo
    spans = [e for e in events if str(e.get("name", "")).startswith(
        SPAN_PREFIX) and e.get("name") != WINDOW_MARK]
    gaps = []
    edges = [lo] + [x for iv in _merged(busy_iv) for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a <= 0:
            continue
        mid = (a + b) / 2
        open_ = [e for e in spans
                 if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        name = (min(open_, key=lambda e: float(e["dur"]))["name"][
            len(SPAN_PREFIX):] if open_ else "between calls")
        gaps.append((name, (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return {"by_name": dict(by_name), "count": dict(count),
            "busy_us": busy, "wall_us": wall,
            "idle_share": 1.0 - busy / wall if wall > 0 else 1.0,
            "idle_gaps": gaps[:10]}


@contextmanager
def profiled(device: torch.device, out: dict):
    """Run the body under ``torch.profiler`` (CPU and, on a card, CUDA
    activities) inside one ``WINDOW_MARK`` annotation, with ``GUARD_S``
    of quiet at each end (the tracer moves device timestamps onto the
    host clock, off by milliseconds); fills ``out`` with
    ``parse_trace`` of the trace.  The trace file lives in a temporary
    directory only while it is read."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=acts) as prof:
            time.sleep(GUARD_S)
            with record_function(WINDOW_MARK):
                yield
            time.sleep(GUARD_S)
        prof.export_chrome_trace(path)
        with open(path) as f:
            out.update(parse_trace(json.load(f)))


class GcPauses:
    """While entered, the time Python's cyclic garbage collector runs,
    and its collections by generation (``gc.callbacks``)."""

    def __init__(self):
        self.seconds = 0.0
        self.collections = [0, 0, 0]
        self._t = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.collections[info["generation"]] += 1
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def __str__(self):
        return (f"the garbage collector ran {1e3 * self.seconds:.1f} ms in "
                f"{'/'.join(map(str, self.collections))} collections "
                f"(generation 0/1/2)")


class HostShare:
    """While entered, the seconds the host took from this machine's CPUs
    (``steal`` in /proc/stat, summed over them) and this process's
    involuntary context switches: how far the host and other processes
    held the run back."""

    def __init__(self):
        self.steal_s = self.switches = None

    @staticmethod
    def _steal():
        try:
            with open("/proc/stat") as f:
                fields = f.readline().split()
            return int(fields[8]) / os.sysconf("SC_CLK_TCK")
        except (OSError, ValueError, IndexError):
            return None

    def __enter__(self):
        self._s0 = self._steal()
        self._c0 = resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw
        return self

    def __exit__(self, *exc):
        s1 = self._steal()
        if s1 is not None and self._s0 is not None:
            self.steal_s = s1 - self._s0
        self.switches = (resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw
                         - self._c0)

    def __str__(self):
        steal = ("not read" if self.steal_s is None
                 else f"{self.steal_s:.2f} s")
        return (f"the host's steal time {steal}, {self.switches} "
                f"involuntary context switches")
