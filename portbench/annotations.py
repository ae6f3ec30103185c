"""The device work under the program's own annotations in a traced run:
``profiled`` is ``trace.profiled`` with, besides ``trace.parse_trace``'s
numbers, the kernels launched inside each named host annotation
(``under``).

A kernel belongs to an annotation when the runtime call that launched it
(``cudaLaunchKernel`` and the like, paired with the kernel by the
profiler's correlation id) lies inside one of the annotation's host
intervals on the same thread.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import trace as tr

HOST_CATS = ("user_annotation", "cpu_op")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def under(trace: dict, name: str) -> Tuple[int, float]:
    """(kernels, their device us) launched inside the host annotation
    ``name`` over the whole trace."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    marks: Dict[tuple, list] = {}
    for e in events:
        if e.get("name") == name and e.get("cat") in HOST_CATS:
            marks.setdefault((e.get("pid"), e.get("tid")), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    for iv in marks.values():
        iv.sort()
    ids = set()
    for e in events:
        corr = e.get("args", {}).get("correlation")
        iv = marks.get((e.get("pid"), e.get("tid")))
        if e.get("cat") not in LAUNCH_CATS or corr is None or not iv:
            continue
        ts = float(e["ts"])
        k = bisect.bisect_right(iv, (ts, float("inf"))) - 1
        if k >= 0 and iv[k][0] <= ts <= iv[k][1]:
            ids.add(corr)
    kernels = [float(e["dur"]) for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in ids]
    return len(kernels), sum(kernels)


def per_block(ctx: dict, name: str) -> Optional[Tuple[float, float]]:
    """(kernels, device ms) a block under the annotation ``name`` in a
    traced run's window; None where the run launched none there."""
    prof, blocks = ctx.get("profile"), ctx.get("blocks")
    got = (prof or {}).get("under", {}).get(name)
    if not blocks or not got or not got[0]:
        return None
    return got[0] / blocks, got[1] / 1e3 / blocks


@contextmanager
def profiled(device: torch.device, out: dict, names: Sequence[str]):
    """``trace.profiled``, its trace read also for ``out["under"]``:
    ``under`` of each of ``names``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=acts) as prof:
            time.sleep(tr.GUARD_S)
            with record_function(tr.WINDOW_MARK):
                yield
            time.sleep(tr.GUARD_S)
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        out.update(tr.parse_trace(trace))
        out["under"] = {n: under(trace, n) for n in names}
