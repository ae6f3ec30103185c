"""Run one cell of the benchmark once:

    python3 -m portbench --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell
asks for.  The last line of standard output is one JSON object:
``correct``, ``attempted`` (the frames due in the window that the plain
reference decodes), ``failed`` (those of them the program did not deliver
exactly once and as encoded, and its messages that match no frame),
``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number that decides ``correct`` with its limit, also printed as the last
lines of standard error.  Exits non-zero, printing no result, without
enough CUDA devices, or when a module of JAX or of the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import guard, spec


def process_start() -> float:
    """The ``time.perf_counter`` reading at which this process started
    (Linux's /proc; elsewhere the time this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - ticks
                                      / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_START = process_start()


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device, fault: str = None, t_start: float = None) -> dict:
    """One run of ``cell`` on ``device``: the result object."""
    driver = spec.load_module("drivers", cell.config["driver"])
    generator = spec.load_module("generators", cell.traffic["generator"])
    out = driver.run(cell, generator, seed, seconds, trace, device, fault,
                     T_START if t_start is None else t_start)
    metrics = {}
    for m in cell.metrics(trace):
        value = spec.load_module("metrics", m["name"]).read(out["ctx"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = out["checks"]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": out["device_kind"], "count": 1,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    prof = out["ctx"].get("profile")
    if trace and prof is not None:
        dev["busy_s"] = prof["busy_us"] / 1e6
        dev["window_s"] = prof["wall_us"] / 1e6
        top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {
            "device_ops": [[n, us / 1e6] for n, us in top],
            "idle_gaps": [[n, s] for n, s in prof["idle_gaps"]]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # breaks one guarantee where the program produces its output: the
    # control and the fault tests (faults.py); never in a measured run
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    root = spec.ROOT
    # every cache of the program and of the libraries inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    try:
        cell = spec.load_cell(args.workload)
    except (KeyError, ValueError, FileNotFoundError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), args.fault)
    bad = guard.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
