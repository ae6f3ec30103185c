"""Device time of the kernel wrappers, one block each, by
``torch.profiler``, on one NVIDIA GPU:

    python -m gnuais_tpu_torch.profile_kernels [--streams 4096] \\
        [--block 49152] [--rounds 3] [--only NAME ...]

The wrappers are B1 (``pipeline_fused_compact``, 32 frame slots) and B2
(``pipeline_fused``), each with the exact, the lobe and the mxu FIR, B2
also on the block's exact FIR (``prefiltered``), B3
(``frontend_fused``, and ``frontend_codes``, the kernel as the card
route calls it) and B4 (``dpll_fused`` and ``dpll_codes``, on the exact
FIR of the same block), and the deframer (``hdlc_fused``) on B3's group
codes and on B4's sample codes of the block (``--only``: the wrappers
whose names contain one of the given strings).  The block is ``captures.mixed`` of 32 rows, repeated over
the streams.  Each wrapper runs once to warm up (and to build the
kernels), then in the order listed and back again, ``rounds`` times,
each call under a profiler of its own.  For each wrapper the script
prints every device kernel of its calls (its hand-written kernel and the
copies and decodes around it) with its mean device time over the calls
whose trace holds it, their sum, and the card's name and power limit;
for B1 and B2 also the launch shape (``fused.pipeline_shape``: producer
warps P, ring stages N, warps a block).  Run it in a process of its
own: nothing else may use the card meanwhile.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys

import numpy as np
import torch

from . import captures
from .ops import fir, fused
from .runtime.pipeline import init_carry


def wrappers(n_streams: int, block: int):
    """name -> a call of that wrapper on one block at the given size."""
    rows = captures.mixed(32, block, seed=1)
    x = torch.from_numpy(np.tile(rows, (-(-n_streams // 32), 1))[:n_streams]
                         ).cuda()
    c = init_carry(n_streams, "cuda")
    filtered, _ = fir.fir_exact(x, c.history)
    group, _, _ = fused.frontend_codes(x, block, c.history, c.dpll)
    sample, _ = fused.dpll_codes(filtered, block, c.dpll)
    return {
        "B1 pipeline_fused_compact": lambda: fused.pipeline_fused_compact(
            x, block, c.history, c.dpll, c.hdlc, frame_slots=32),
        "B1 pipeline_fused_compact lobe": lambda: fused.pipeline_fused_compact(
            x, block, c.history, c.dpll, c.hdlc, frame_slots=32,
            fir_mode="lobe"),
        "B1 pipeline_fused_compact mxu": lambda: fused.pipeline_fused_compact(
            x, block, c.history, c.dpll, c.hdlc, frame_slots=32,
            fir_mode="mxu"),
        "B2 pipeline_fused": lambda: fused.pipeline_fused(
            x, block, c.history, c.dpll, c.hdlc),
        "B2 pipeline_fused lobe": lambda: fused.pipeline_fused(
            x, block, c.history, c.dpll, c.hdlc, fir_mode="lobe"),
        "B2 pipeline_fused mxu": lambda: fused.pipeline_fused(
            x, block, c.history, c.dpll, c.hdlc, fir_mode="mxu"),
        "B2 pipeline_fused prefiltered": lambda: fused.pipeline_fused(
            filtered, block, c.history, c.dpll, c.hdlc, prefiltered=True),
        "B3 frontend_fused": lambda: fused.frontend_fused(
            x, block, c.history, c.dpll),
        "B3 frontend_codes": lambda: fused.frontend_codes(
            x, block, c.history, c.dpll),
        "B4 dpll_fused": lambda: fused.dpll_fused(filtered, block, c.dpll),
        "B4 dpll_codes": lambda: fused.dpll_codes(filtered, block, c.dpll),
        "hdlc_fused group": lambda: fused.hdlc_fused(c.hdlc, group, "group"),
        "hdlc_fused sample": lambda: fused.hdlc_fused(c.hdlc, sample,
                                                      "sample"),
    }


def profile(fns, rounds: int):
    """name -> {kernel: [device ms per call]}, the calls interleaved."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    names = list(fns)
    order = (names + names[::-1]) * rounds
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    per_call = {n: collections.defaultdict(list) for n in names}
    for name in order:
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            fns[name]()
            torch.cuda.synchronize()
        ms = collections.Counter()
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                ms[ev.name] += ev.time_range.elapsed_us() / 1e3
        for kernel, t in ms.items():
            per_call[name][kernel].append(t)
    return per_call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=4096)
    ap.add_argument("--block", type=int, default=49_152)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", nargs="+", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    fns = {name: fn for name, fn in wrappers(args.streams, args.block).items()
           if args.only is None or any(o in name for o in args.only)}
    per_call = profile(fns, args.rounds)
    print(f"S={args.streams} T={args.block}, {2 * args.rounds} calls per "
          f"wrapper; mean device ms per call (torch.profiler); {card}")
    calls = 2 * args.rounds
    for name, kernels in per_call.items():
        # each kernel's mean over the calls whose trace holds it: the
        # profiler may drop a call's events (it warns that it clears
        # them at the end of each cycle)
        mean = {k: sum(v) / len(v) for k, v in kernels.items()}
        shape = ""
        if name.startswith(("B1", "B2")):
            mode = name.split()[-1]
            sh = fused.pipeline_shape(mode if mode in fused.FIR_MODES
                                      else "vpu", mode == "prefiltered")
            shape = (f" (P={sh['producers']} N={sh['stages']} "
                     f"warps/block={sh['warps']})")
        print(f"{name}: {sum(mean.values()):.3f} ms on the device{shape}")
        for kernel, ms in sorted(mean.items(), key=lambda kv: -kv[1]):
            print(f"  {ms:9.3f} ms  {len(kernels[kernel])}/{calls} calls  "
                  f"{kernel[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
