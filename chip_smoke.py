#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gnuais_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it passes; any failure raises and exits non-zero:

1. Device: the card's name, and its name and power limit from nvidia-smi.
2. Build: nvcc compiles gnuais_tpu_torch/csrc (registers and spills
   printed).
3. Kernel against its plain PyTorch version on the card, bitwise, every
   output and carry leaf: S = 1, 37, 256 at T = 4096 on encoder captures
   with noise, garbage rows, minimal back-to-back frames, wrong-size and
   CRC-reject frames; n_valid = T-333 and 20; a lost2 window;
   frame_slots = 3 (overflow); three blocks chained through the carry.
4. Main path at full size: BatchPipeline(4096 streams, 49,152-sample
   blocks, 32 frame slots, fused kernel, CRC on the device) over three
   chained blocks; every stream's decoded payloads equal the encoded
   ones in every block.
5. End to end: the command line (``gnuais-tpu-torch -l
   tests/fixtures/standard_capture.raw --backend fused``) reproduces the
   capture's stdout byte for byte with counters (49, 0, 0).
6. The first fleet block at full size through the kernel and through
   its plain version: bitwise equal on every output and carry leaf, and
   the kernel's carry equal to the main path's.  Times of one full block
   (the kernel, the whole decode_block step and the plain version) and
   the kernel's launch count over phases 4 and 5, as one JSON line; a
   check that no JAX module was imported; then the result line
   {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is available or
when run outside a checkout of the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 20261016
FLEET_STREAMS = 4096
FLEET_BLOCK = 49_152
FLEET_SLOTS = 32
FLEET_BLOCKS = 3
VARIANTS = 32            # distinct captures per block, cycled over streams


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def leaves(out) -> list:
    """The fused step's outputs as a flat list of tensors."""
    flat = []
    for v in out:
        flat.extend(leaves(v) if isinstance(v, tuple) else [v])
    return flat


def compare(a, b, what: str) -> float:
    """Bitwise equality of two output lists; returns the max abs error."""
    import torch
    la, lb = leaves(a), leaves(b)
    check(len(la) == len(lb), f"{what}: {len(la)} vs {len(lb)} leaves")
    err = 0.0
    for i, (x, y) in enumerate(zip(la, lb)):
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"{what}: leaf {i} {x.shape}/{x.dtype} vs {y.shape}/{y.dtype}")
        bits = ((x.view(torch.int32) != y.view(torch.int32)).any()
                if x.dtype == torch.float32 else (x != y).any())
        err = max(err, float((x.double() - y.double()).abs().max()) if x.numel() else 0.0)
        check(not bool(bits), f"{what}: leaf {i} differs (max abs err {err})")
    return err


def phase_device():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{name}", flush=True)
    print(card, flush=True)
    return name, card


def phase_build():
    from gnuais_tpu_torch.ops import _build
    t0 = time.time()
    path = _build.build(verbose=True)
    _build.library()
    info = [l for l in _build.build_log.splitlines() if "registers" in l
            or "spill" in l]
    print(f"[2 build] {path.relative_to(REPO)} in {time.time() - t0:.1f} s",
          flush=True)
    for line in info:
        print("  " + line.strip(), flush=True)


def run_pair(x_np, nv, carry, fs, base=0, window=(None, None),
             plain_carry=None):
    """The kernel and its plain version on the same device inputs (the
    plain version from ``plain_carry`` when given)."""
    import torch
    from gnuais_tpu_torch.ops import fused
    x = torch.from_numpy(x_np).cuda()
    lo, hi = window
    kw = dict(frame_slots=fs, block_base=base, lost2_lo=lo, lost2_hi=hi)
    k = fused.pipeline_fused_compact(x, nv, carry.history, carry.dpll,
                                     carry.hdlc, **kw)
    torch.cuda.synchronize()
    pc = carry if plain_carry is None else plain_carry
    p = fused.pipeline_fused_compact_reference(x, nv, pc.history, pc.dpll,
                                               pc.hdlc, **kw)
    torch.cuda.synchronize()
    return k, p


def phase_parity() -> float:
    from gnuais_tpu_torch import captures
    from gnuais_tpu_torch.runtime.pipeline import PipelineCarry, init_carry
    t = 4096
    cases = [
        ("S=1 frames", captures.noisy_frames(1, t, seed=1), t, 8, 0, None),
        ("S=37 mixed n_valid=T-333", captures.mixed(37, t, seed=2), t - 333,
         8, 77, None),
        ("S=37 mixed n_valid=20", captures.mixed(37, t, seed=3), 20, 8, 0, None),
        ("S=256 mixed lost2 window", captures.mixed(256, t, seed=4), t, 8,
         1000, (1000 + 2600, 1000 + 3600)),
        ("S=256 minimal frames, 3 slots", captures.minimal_frames(256, t, seed=5),
         t, 3, 0, None),
        ("S=37 garbage", captures.garbage(37, t, seed=6), t, 8, 0, None),
        ("S=256 wrong-size and CRC rejects",
         captures.wrong_size_and_crc(256, t, seed=7), t, 24, 0, None),
    ]
    err = 0.0
    for name, x, nv, fs, base, window in cases:
        k, p = run_pair(x, nv, init_carry(x.shape[0], "cuda"), fs, base,
                        window or (None, None))
        err = max(err, compare(k, p, name))
        print(f"[3 parity] {name}: bitwise equal, frames "
              f"{int(k[0].sum())}, dropped {int((k[0] - fs).clamp(min=0).sum())}, "
              f"lost2 {int(k[5].sum())}, over {int(k[6].sum())}", flush=True)
    # three blocks chained through each side's own carry
    x = captures.mixed(37, 3 * t, seed=8)
    ck = cp = init_carry(37, "cuda")
    for b in range(3):
        nv = t if b < 2 else t - 333
        xb = np.ascontiguousarray(x[:, b * t:(b + 1) * t])
        k, p = run_pair(xb, nv, ck, 8, base=b * t, plain_carry=cp)
        err = max(err, compare(k, p, f"chained block {b}"))
        ck = PipelineCarry(*k[7:])
        cp = PipelineCarry(*p[7:])
        print(f"[3 parity] chained block {b}: bitwise equal, frames "
              f"{int(k[0].sum())}", flush=True)
    return err


def fleet_blocks():
    """FLEET_BLOCKS blocks of [4096, 49152] int16 (on the host), and per
    block and stream the encoded payloads.  Stream s plays variant
    s % VARIANTS of the block, shifted within the block so that its
    frames stay inside it, plus Gaussian noise (made on the card from
    SEED)."""
    import torch
    from gnuais_tpu_torch import captures
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    s = torch.arange(FLEET_STREAMS, device="cuda")
    tt = torch.arange(FLEET_BLOCK, device="cuda")
    blocks, expected = [], []
    for b in range(FLEET_BLOCKS):
        base = np.empty((VARIANTS, FLEET_BLOCK), dtype=np.int16)
        lens, pays = [], []
        for v in range(VARIANTS):
            audio, payloads = captures.payload_capture(
                np.random.default_rng([SEED, b, v]), 8, gap_bits=64)
            check(len(audio) < FLEET_BLOCK // 2, "variant too long")
            base[v] = audio[-1]                 # idle level after the last frame
            base[v, :len(audio)] = audio
            lens.append(len(audio))
            pays.append(payloads)
        # the bit grid stays aligned with the stream's absolute sample
        # index (shifts of whole 5-sample bits, after the block start's
        # own offset): at some sub-bit phases against the carried DPLL
        # phase the reference receiver itself misses frames of these
        # rectangular synthetic pulses (the golden model agrees), which
        # would make "decoded == encoded" a property of the input
        room = (FLEET_BLOCK - max(lens)) // 5 - 1
        shift = 5 * ((s // VARIANTS * 97 + b * 13) % room) \
            + (-b * FLEET_BLOCK) % 5
        var = s % VARIANTS
        dev = torch.from_numpy(base).cuda()[var]                   # [S, T]
        idx = (tt[None, :] - shift[:, None]) % FLEET_BLOCK
        x = torch.gather(dev, 1, idx).to(torch.float32)
        x += 300.0 * torch.randn(x.shape, generator=g, device="cuda")
        x = x.round_().clamp_(-32768, 32767).to(torch.int16)
        blocks.append(x.cpu().numpy())
        expected.append([pays[int(v)] for v in var.tolist()])
        del dev, idx, x
    return blocks, expected


def phase_main_path():
    import torch
    from gnuais_tpu_torch.runtime.pipeline import BatchPipeline
    blocks, expected = fleet_blocks()
    pipe = BatchPipeline(FLEET_STREAMS, block_len=FLEET_BLOCK,
                         frame_slots=FLEET_SLOTS, fused_pipeline=True,
                         device_crc=True, device="cuda")
    carry0 = pipe.carry
    times, carry1 = [], None
    for b, x in enumerate(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_stream = pipe.process(x)
        times.append(time.perf_counter() - t0)
        if b == 0:
            carry1 = pipe.carry
        n_frames = 0
        for i, (got, want) in enumerate(zip(per_stream, expected[b])):
            check(len(got) == len(want),
                  f"block {b} stream {i}: {len(got)} frames, {len(want)} sent")
            for fr, pay in zip(got, want):
                check(np.array_equal(fr.payload_bits[:fr.bufferlen], pay),
                      f"block {b} stream {i}: payload differs")
            n_frames += len(got)
        print(f"[4 main path] block {b}: {FLEET_STREAMS} streams x "
              f"{FLEET_BLOCK} samples, {n_frames} frames, all payloads equal "
              f"the encoded ones, process() {times[-1] * 1e3:.1f} ms",
              flush=True)
    for i, c in enumerate(pipe.counters):
        check((c.receivedframes, c.lostframes, c.lostframes2)
              == (sum(len(e[i]) for e in expected), 0, 0),
              f"stream {i} counters {c}")
    print(f"[4 main path] counters: every stream (received, wrong CRC, wrong "
          f"size) = ({8 * FLEET_BLOCKS}, 0, 0); median block "
          f"{statistics.median(times) * 1e3:.1f} ms", flush=True)
    return blocks[0], carry0, carry1, statistics.median(times)


def phase_end_to_end():
    """The command line as a user runs it (``gnuais-tpu-torch -l
    capture.raw --backend fused``, on cuda by default), in this process
    so that its kernel launches are counted."""
    import contextlib
    import io
    import logging
    from gnuais_tpu_torch import cli
    fix = REPO / "tests" / "fixtures"
    out, summary = io.StringIO(), io.StringIO()
    handler = logging.StreamHandler(summary)
    log = logging.getLogger("gnuais")
    log.setLevel(logging.INFO)
    log.addHandler(handler)
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["-l", str(fix / "standard_capture.raw"),
                           "--backend", "fused"])
    finally:
        log.removeHandler(handler)
    want = (fix / "standard_capture.stdout").read_text()
    check(rc == 0, f"cli exit code {rc}")
    check(out.getvalue() == want, "fixture stdout differs")
    counters = ("A: Received correctly: 49 packets, wrong CRC: 0 packets, "
                "wrong size: 0 packets")
    check(counters in summary.getvalue(),
          f"cli summary lacks {counters!r}: {summary.getvalue()!r}")
    print(f"[5 end to end] gnuais-tpu-torch -l standard_capture.raw --backend "
          f"fused: {len(want.splitlines())} stdout lines byte for byte, "
          f"counters (49, 0, 0)", flush=True)


def phase_full_block(x0, carry0, carry1):
    """The kernel against its plain version on the main path's first
    block at full size, every output and carry leaf, and the kernel's
    carry against the main path's; with the times of the kernel, the
    whole step and the plain version (not part of the counted main
    path)."""
    import torch
    from gnuais_tpu_torch.ops import fused
    from gnuais_tpu_torch.runtime.pipeline import decode_block

    def device_ms(fn, n=5):
        """Median of n timed calls after one warm-up, by CUDA events, and
        the last call's result."""
        fn()
        ms = []
        for _ in range(n):
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            a.record()
            res = fn()
            e.record()
            e.synchronize()
            ms.append(a.elapsed_time(e))
        return statistics.median(ms), res

    x = torch.from_numpy(x0).cuda()
    args = (x, FLEET_BLOCK, carry0.history, carry0.dpll, carry0.hdlc)
    ms, k = device_ms(lambda: fused.pipeline_fused_compact(
        *args, frame_slots=FLEET_SLOTS))
    step_ms, _ = device_ms(lambda: decode_block(
        x, FLEET_BLOCK, carry0, frame_slots=FLEET_SLOTS, fused_pipeline=True,
        device_crc=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = fused.pipeline_fused_compact_reference(*args, frame_slots=FLEET_SLOTS)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    what = f"block 0 at S={FLEET_STREAMS} T={FLEET_BLOCK} F={FLEET_SLOTS}"
    err = compare(k, p, f"{what}, kernel vs plain")
    err = max(err, compare(k[7:], tuple(carry1),
                           f"{what}, kernel carry vs main path carry"))
    print(f"[6 full block] {what}: kernel == plain on all {len(leaves(k))} "
          f"output and carry leaves ({int(k[0].sum())} frames), and == the "
          f"main path's carry, bitwise", flush=True)
    print(f"[6 full block] S={FLEET_STREAMS} T={FLEET_BLOCK}: kernel wrapper "
          f"{ms:.3f} ms, decode_block step (kernel, CRC filter, compaction) "
          f"{step_ms:.3f} ms (medians of 5, CUDA events); plain version "
          f"{plain_ms:.1f} ms (one run, host clock)", flush=True)
    return err, ms, plain_ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from gnuais_tpu_torch.ops import fused

    name, card = phase_device()
    phase_build()
    err = phase_parity()

    fused.pipeline_fused_compact.launches = 0
    x0, carry0, carry1, block_s = phase_main_path()
    phase_end_to_end()
    launches = fused.pipeline_fused_compact.launches
    check(launches >= FLEET_BLOCKS, f"kernel launched {launches} times")
    print(f"[5 end to end] kernel launches on the main path: {launches}; "
          f"median full-size block process() {block_s * 1e3:.1f} ms on "
          f"{card}", flush=True)

    err2, ms, plain_ms = phase_full_block(x0, carry0, carry1)
    jax_loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib")))
    check(not jax_loaded, f"JAX was imported: {jax_loaded[:5]}")
    print(json.dumps({"kernels": [{
        "name": "pipeline_compact",
        "route": "cuda",
        "source": "gnuais_tpu_torch/csrc/pipeline_compact.cu",
        "replaces": "gnuais_tpu/ops/fused.py:1261",
        "launches": launches,
        "max_abs_err": max(err, err2),
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(f"{card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
