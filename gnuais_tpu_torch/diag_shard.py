"""The cost of the stream-sharded wrapper on one card, the counterpart of
``tools/diag_shard.py``:

    python -m gnuais_tpu_torch.diag_shard [--superblock 12] \\
        [--streams 4096] [--iters 16] [--device cuda]

Pairs the direct superblock step, ``decode_superblock(K blocks,
fused_pipeline, lobe_fir, frame_slots=32)`` (K launches of kernel B2
with the lobe FIR), with the same step through ``make_sharded_decode``
on a one-shard stream mesh (``parallel.mesh.make_stream_mesh(1)``: the
rows and carry split into one shard, launched and gathered back), on
one input variant (the JAX bench's 4-payload batch,
``captures.build_batch``, repeated K times), each carried from its own
previous call.  After one call of each (the build and warm-up), the two
run interleaved ``--iters`` times (at least 16 pairs), each call on the
host clock until its frame count is read back and checked.  Prints the
min, median and max of each, their ratio (direct over sharded, the JAX
tool's "efficiency") and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

BLOCK = 49_152


def _count(frames) -> int:
    return int(frames.count.sum())


def run(superblock: int = 12, n_streams: int = 4096, iters: int = 16,
        block_len: int = BLOCK, device="cuda") -> dict:
    """The tool's protocol; returns {"direct_ms": [...], "sharded_ms":
    [...], "efficiency": median direct / median sharded, "min_ratio"}."""
    from . import captures
    from .parallel.mesh import make_stream_mesh
    from .parallel.sharded import make_sharded_decode
    from .runtime.pipeline import decode_superblock, init_carry
    dev = torch.device(device)
    if iters < 16:
        raise ValueError(f"{iters} pairs: the protocol takes at least 16")
    kflags = dict(lobe_fir=True)
    batch, n_pay = captures.build_batch(n_streams, block_len, 4, seed=0)
    x = torch.from_numpy(batch).to(dev).repeat(1, superblock)
    nv = block_len * superblock
    want = n_pay * n_streams * superblock

    def direct(c):
        return decode_superblock(x, nv, c, superblock, frame_slots=32,
                                 exact_fir=True, fused_pipeline=True,
                                 **kflags)

    mesh = make_stream_mesh(1, device=dev.type)
    sharded = make_sharded_decode(mesh, frame_slots=32, fused_pipeline=True,
                                  superblock=superblock, **kflags)
    c1 = c2 = init_carry(n_streams, dev)

    def timed(fn, c):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        c, frames, _ = fn(c)
        n = _count(frames)
        ms = (time.perf_counter() - t0) * 1e3
        if n != want:
            raise RuntimeError(f"a dispatch counted {n} frames, {want} sent")
        return c, ms

    c1, first_direct = timed(direct, c1)
    c2, first_sharded = timed(lambda c: sharded(x, nv, c), c2)
    td, ts = [], []
    for _ in range(iters):
        c1, ms = timed(direct, c1)
        td.append(ms)
        c2, ms = timed(lambda c: sharded(x, nv, c), c2)
        ts.append(ms)
    return {"direct_ms": td, "sharded_ms": ts, "first_ms": (first_direct,
                                                            first_sharded),
            "efficiency": statistics.median(td) / statistics.median(ts),
            "min_ratio": min(td) / min(ts),
            "samples": n_streams * block_len * superblock}


def stats(ms, n: int) -> str:
    a = sorted(ms)
    med = statistics.median(a)
    return (f"min {a[0]:7.1f} ms  med {med:7.1f} ms  max {a[-1]:7.1f} ms  "
            f"sps(med) {n / med / 1e6:6.2f} G")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--superblock", type=int, default=12)
    ap.add_argument("--streams", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from . import card
    from .device import resolve_device
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"diag_shard: {e}", file=sys.stderr)
        return 1
    r = run(args.superblock, args.streams, args.iters, device=dev)
    n = r["samples"]
    print(f"first calls (build, warm-up): direct {r['first_ms'][0]:.1f} ms, "
          f"sharded {r['first_ms'][1]:.1f} ms")
    print("direct :", stats(r["direct_ms"], n))
    print("sharded:", stats(r["sharded_ms"], n))
    print("per-iter direct  :", " ".join(f"{t:.0f}" for t in r["direct_ms"]))
    print("per-iter sharded :", " ".join(f"{t:.0f}" for t in r["sharded_ms"]))
    print(f"efficiency(med) = {r['efficiency']:.3f}   min-based = "
          f"{r['min_ratio']:.3f}")
    print(card.smi() if dev.type == "cuda" else "cpu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
