#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gnuais_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it passes with its wall time; any failure
raises and exits non-zero:

1. Device: the card's name, and its name and power limit from nvidia-smi.
2. Build: one nvcc per kernel source of gnuais_tpu_torch/csrc, the three
   started together, linked into one library (registers and spills
   printed per kernel).
3. Kernel B1 against its plain PyTorch version on the card, bitwise,
   every output and carry leaf: S = 1, 37, 256 at T = 4096 on encoder
   captures with noise, garbage rows, minimal back-to-back frames,
   wrong-size and CRC-reject frames; n_valid = T-333 and 20; a lost2
   window; frame_slots = 3 (overflow); three blocks chained through the
   carry.  Then kernels B3 (frontend) and B4 (DPLL) against theirs:
   S = 1, 37, 256 at T = 4096 on mixed, noisy-frame and garbage
   captures, n_valid = T, T-333, 35, 1 and 0, nonzero block bases and
   history, three blocks chained through each side's own state (B4 on
   the exact FIR of the same captures).  Then all three on every block
   the fixture gives the command line (phases 5 and 10): S = 1, T =
   1024, n_valid 1020 and a 990-sample tail, 73 blocks chained.
4. Main path at full size: BatchPipeline(4096 streams, 49,152-sample
   blocks, 32 frame slots, fused kernel B1, CRC on the device) over
   three chained blocks; every stream's decoded payloads equal the
   encoded ones in every block.
5. End to end: the command line (``gnuais-tpu-torch -l
   tests/fixtures/standard_capture.raw --backend fused``) reproduces the
   capture's stdout byte for byte with counters (49, 0, 0).
6. The first fleet block at full size through B1 and through its plain
   version: bitwise equal on every output and carry leaf, and B1's carry
   equal to the main path's; times of one full block (the kernel, the
   whole decode_block step and the plain version).
7. Path S: PipelinedDecoder(4096 streams, 49,152-sample blocks,
   fused_frontend, depth 2) over the fleet blocks: kernel B3 and the
   plain deframer; every payload equal to the encoded ones, counters
   (8 x blocks, 0, 0).
8. B3 and B4 on the first fleet block at full size against their plain
   versions, bitwise; their times, and Path S's split of one block
   (kernel, hdlc_scan, drain).
9. Path S with B1: PipelinedDecoder(fused_pipeline, device_crc,
   depth 2) over the three fleet blocks one by one, and with superblock
   3 as one submission; frames and counters equal phase 4's; wall times.
10. Path F: ``gnuais-tpu-torch -l tests/fixtures/standard_capture.raw
   --backend fast`` (kernel B4) reproduces the stdout byte for byte
   with counters (49, 0, 0).
Then one JSON line of the three kernels (launch counts from their own
paths: B1 over phases 4-5, B3 over phase 7, B4 over phase 10; times at
the fleet size), a check that no JAX module was imported, the card's
name and power limit, and the result line {"ok": true, "device": {...}}.

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
CLI_BLOCK = 1020         # the CLI's file-mode block: 1024 in whole 5-sample bits
KERNEL_BLOCK = 1024      # the kernel backends pad it to a multiple of 512
FIXTURE_SLOTS = 32       # the config's default frameslots


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


def device_ms(fn, n=5):
    """Median of n timed calls after one warm-up, by CUDA events, and the
    last call's result."""
    import torch
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


def host_ms(fn):
    """One call of fn on the host clock, the device synchronised before
    and after, and its result."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, res


def payloads(per_stream) -> list:
    return [[f.payload_bits[:f.bufferlen].tobytes() for f in lst]
            for lst in per_stream]


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
    path = _build.build()
    _build.library()
    info = [l for l in _build.build_log.splitlines() if "registers" in l
            or "spill" in l or "entry function" in l]
    print(f"[2 build] {path.relative_to(REPO)} from "
          f"{len(sorted((REPO / 'gnuais_tpu_torch' / 'csrc').glob('*.cu')))} "
          f".cu files in {time.time() - t0:.1f} s", flush=True)
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
    got = [[] for _ in range(FLEET_STREAMS)]
    for b, x in enumerate(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_stream = pipe.process(x)
        times.append(time.perf_counter() - t0)
        if b == 0:
            carry1 = pipe.carry
        n_frames = 0
        for i, (frames, want) in enumerate(zip(per_stream, expected[b])):
            check(len(frames) == len(want),
                  f"block {b} stream {i}: {len(frames)} frames, "
                  f"{len(want)} sent")
            for fr, pay in zip(frames, want):
                check(np.array_equal(fr.payload_bits[:fr.bufferlen], pay),
                      f"block {b} stream {i}: payload differs")
            n_frames += len(frames)
        for i, lst in enumerate(payloads(per_stream)):
            got[i].extend(lst)
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
    counters = [vars(c) for c in pipe.counters]
    return blocks, expected, carry0, carry1, statistics.median(times), \
        (got, counters)


def phase_end_to_end(backend: str, label: str):
    """The command line as a user runs it (``gnuais-tpu-torch -l
    capture.raw --backend <backend>``, on cuda by default), in this
    process so that its kernel launches are counted."""
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
                           "--backend", backend])
    finally:
        log.removeHandler(handler)
    want = (fix / "standard_capture.stdout").read_text()
    check(rc == 0, f"cli exit code {rc}")
    check(out.getvalue() == want, "fixture stdout differs")
    counters = ("A: Received correctly: 49 packets, wrong CRC: 0 packets, "
                "wrong size: 0 packets")
    check(counters in summary.getvalue(),
          f"cli summary lacks {counters!r}: {summary.getvalue()!r}")
    print(f"[{label}] gnuais-tpu-torch -l standard_capture.raw --backend "
          f"{backend}: {len(want.splitlines())} stdout lines byte for byte, "
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

    x = torch.from_numpy(x0).cuda()
    args = (x, FLEET_BLOCK, carry0.history, carry0.dpll, carry0.hdlc)
    ms, k = device_ms(lambda: fused.pipeline_fused_compact(
        *args, frame_slots=FLEET_SLOTS))
    step_ms, _ = device_ms(lambda: decode_block(
        x, FLEET_BLOCK, carry0, frame_slots=FLEET_SLOTS, fused_pipeline=True,
        device_crc=True))
    plain_ms, p = host_ms(lambda: fused.pipeline_fused_compact_reference(
        *args, frame_slots=FLEET_SLOTS))
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


def phase_parity_front():
    """Kernels B3 and B4 against their plain versions at small shapes;
    returns the max abs error of each."""
    import torch
    from gnuais_tpu_torch import captures
    from gnuais_tpu_torch.ops import fir, fused
    from gnuais_tpu_torch.runtime.pipeline import init_carry
    t = 4096
    makers = {"mixed": captures.mixed, "noisy_frames": captures.noisy_frames,
              "garbage": captures.garbage}
    cases = [(s, m, t) for s in (1, 37, 256) for m in makers]
    cases += [(s, "mixed", nv) for s in (1, 37, 256)
              for nv in (t - 333, 35, 1, 0)]
    err3 = err4 = 0.0
    for i, (s, m, nv) in enumerate(cases):
        x = torch.from_numpy(makers[m](s, t, seed=30 + i)).cuda()
        hist = torch.from_numpy(captures.garbage(s, 36, seed=i)
                                .astype(np.float32)).cuda()
        dpll = init_carry(s, "cuda").dpll
        base = 2**31 - 1000 if i % 2 else 77 * i
        what = f"S={s} {m} n_valid={nv} base={base}"
        k = fused.frontend_fused(x, nv, hist, dpll, base)
        p = fused.frontend_fused_reference(x, nv, hist, dpll, base)
        torch.cuda.synchronize()
        err3 = max(err3, compare(k, p, f"B3 {what}"))
        filtered, _ = fir.fir_exact(x, hist, n_valid=nv)
        k4 = fused.dpll_fused(filtered, nv, dpll)
        p4 = fused.dpll_fused_reference(filtered, nv, dpll)
        torch.cuda.synchronize()
        err4 = max(err4, compare(k4, p4, f"B4 {what}"))
        print(f"[3 parity B3/B4] {what}: both bitwise equal, "
              f"{int(k[1].sum())} bit slots", flush=True)
    # three blocks chained through each side's own state
    s = 37
    x = captures.mixed(s, 3 * t, seed=8)
    c = init_carry(s, "cuda")
    kh = ph = c.history
    kd = pd = kd4 = pd4 = c.dpll
    for b in range(3):
        xb = torch.from_numpy(np.ascontiguousarray(
            x[:, b * t:(b + 1) * t])).cuda()
        nv = t if b < 2 else t - 333
        k = fused.frontend_fused(xb, nv, kh, kd, 2**31 - t + b * t)
        p = fused.frontend_fused_reference(xb, nv, ph, pd, 2**31 - t + b * t)
        err3 = max(err3, compare(k, p, f"B3 chained block {b}"))
        kh, kd, ph, pd = k[3], k[4], p[3], p[4]
        filtered, _ = fir.fir_exact(xb, torch.zeros_like(kh), n_valid=nv)
        k4 = fused.dpll_fused(filtered, nv, kd4)
        p4 = fused.dpll_fused_reference(filtered, nv, pd4)
        err4 = max(err4, compare(k4, p4, f"B4 chained block {b}"))
        kd4, pd4 = k4[2], p4[2]
        print(f"[3 parity B3/B4] chained block {b}: both bitwise equal",
              flush=True)
    return err3, err4


def phase_parity_fixture(dev: str = "cuda"):
    """B1, B3 and B4 against their plain versions on every block that
    the command line's kernel backends (phases 5 and 10) give them for
    the fixture: S = 1, blocks of CLI_BLOCK samples padded to
    KERNEL_BLOCK with zeros and the short tail, each side chained
    through its own state from block to block and at block_base 0, as
    ``BatchPipeline.process`` runs them.  B4 takes the exact FIR of each
    block, the FIR history carried.  Returns the max abs error of each."""
    import torch
    from gnuais_tpu_torch.ops import fir, fused
    from gnuais_tpu_torch.runtime.pipeline import PipelineCarry, init_carry
    audio = np.fromfile(REPO / "tests" / "fixtures" / "standard_capture.raw",
                        dtype="<i2")
    c = init_carry(1, dev)
    ck = cp = c                                  # B1
    kh, kd, ph, pd = c.history, c.dpll, c.history, c.dpll   # B3
    fh, kd4, pd4 = c.history, c.dpll, c.dpll     # B4, FIR history shared
    err1 = err3 = err4 = 0.0
    n_valid, frames, bits = [], 0, 0
    for b, off in enumerate(range(0, len(audio), CLI_BLOCK)):
        blk = audio[off:off + CLI_BLOCK]
        nv = len(blk)
        n_valid.append(nv)
        xb = np.zeros((1, KERNEL_BLOCK), dtype=np.int16)
        xb[0, :nv] = blk
        x = torch.from_numpy(xb).to(dev)
        what = f"fixture block {b} (n_valid {nv})"
        args = dict(frame_slots=FIXTURE_SLOTS)
        k = fused.pipeline_fused_compact(x, nv, ck.history, ck.dpll, ck.hdlc,
                                         **args)
        p = fused.pipeline_fused_compact_reference(x, nv, cp.history, cp.dpll,
                                                   cp.hdlc, **args)
        err1 = max(err1, compare(k, p, f"B1 {what}"))
        ck, cp = PipelineCarry(*k[7:]), PipelineCarry(*p[7:])
        frames += int(k[0].sum())
        k = fused.frontend_fused(x, nv, kh, kd)
        p = fused.frontend_fused_reference(x, nv, ph, pd)
        err3 = max(err3, compare(k, p, f"B3 {what}"))
        kh, kd, ph, pd = k[3], k[4], p[3], p[4]
        filtered, fh = fir.fir_exact(x, fh, n_valid=nv)
        k4 = fused.dpll_fused(filtered, nv, kd4)
        p4 = fused.dpll_fused_reference(filtered, nv, pd4)
        err4 = max(err4, compare(k4, p4, f"B4 {what}"))
        kd4, pd4 = k4[2], p4[2]
        bits += int(k4[0].sum())
    print(f"[3 parity fixture] B1, B3 and B4 == plain, bitwise, on all "
          f"{len(n_valid)} chained blocks of the fixture at S=1 "
          f"T={KERNEL_BLOCK} (n_valid {n_valid[0]} x {len(n_valid) - 1}, "
          f"then {n_valid[-1]}): {frames} frames, {bits} bits", flush=True)
    return err1, err3, err4


def phase_path_s(blocks, expected):
    """Path S: the pipelined streaming decoder through kernel B3 and the
    plain deframer, at full width.  Runs two blocks instead of three when
    three would take more than about 90 s."""
    from gnuais_tpu_torch.runtime.streaming import PipelinedDecoder
    dec = PipelinedDecoder(FLEET_STREAMS, block_len=FLEET_BLOCK,
                           frame_slots=FLEET_SLOTS, fused_frontend=True,
                           depth=2, device="cuda")
    t0 = time.perf_counter()
    results, n_run = [], 0
    for b, x in enumerate(blocks):
        r = dec.submit(x)
        if r is not None:
            results.append(r)
        n_run += 1
        spent = time.perf_counter() - t0
        if n_run == 2 and spent * 3 / 2 > 90:
            break
    results.extend(dec.flush())
    wall = time.perf_counter() - t0
    check(len(results) == n_run, f"{len(results)} results for {n_run} blocks")
    for b, per_stream in enumerate(results):
        for i, (frames, want) in enumerate(zip(per_stream, expected[b])):
            check(len(frames) == len(want),
                  f"path S block {b} stream {i}: {len(frames)} frames, "
                  f"{len(want)} sent")
            for fr, pay in zip(frames, want):
                check(np.array_equal(fr.payload_bits[:fr.bufferlen], pay),
                      f"path S block {b} stream {i}: payload differs")
    for i, c in enumerate(dec.counters):
        check((c.receivedframes, c.lostframes, c.lostframes2)
              == (8 * n_run, 0, 0), f"path S stream {i} counters {c}")
    note = "" if n_run == len(blocks) else (
        f" (two chained blocks, not three: three would take "
        f"{wall * 3 / 2:.0f} s through the plain deframer)")
    print(f"[7 path S] PipelinedDecoder(fused_frontend, depth 2): "
          f"{n_run} blocks of {FLEET_STREAMS} x {FLEET_BLOCK}, every payload "
          f"equals the encoded ones, counters ({8 * n_run}, 0, 0) on every "
          f"stream; {wall:.1f} s in all, {wall / n_run * 1e3:.1f} ms per "
          f"block{note}", flush=True)
    return wall / n_run


def phase_front_full(x0):
    """B3 on the first fleet block and B4 on its exact FIR, at full size,
    against their plain versions; their times, and the rest of Path S's
    block: the plain deframer and the host drain."""
    import torch
    from gnuais_tpu_torch.ops import demod, fir, fused
    from gnuais_tpu_torch.runtime.pipeline import BatchPipeline, init_carry
    x = torch.from_numpy(x0).cuda()
    c = init_carry(FLEET_STREAMS, "cuda")
    what = f"block 0 at S={FLEET_STREAMS} T={FLEET_BLOCK}"
    args3 = (x, FLEET_BLOCK, c.history, c.dpll, 0)
    ms3, k = device_ms(lambda: fused.frontend_fused(*args3))
    plain3, p = host_ms(lambda: fused.frontend_fused_reference(*args3))
    err3 = compare(k, p, f"B3 {what}")
    filtered, _ = fir.fir_exact(x, c.history)
    ms4, k4 = device_ms(lambda: fused.dpll_fused(filtered, FLEET_BLOCK,
                                                 c.dpll))
    plain4, p4 = host_ms(lambda: fused.dpll_fused_reference(
        filtered, FLEET_BLOCK, c.dpll))
    err4 = compare(k4, p4, f"B4 {what}")
    print(f"[8 full block] {what}: B3 == plain on all {len(leaves(k))} "
          f"outputs ({int(k[1].sum())} bit slots), B4 == plain on all "
          f"{len(leaves(k4))} outputs ({int(k4[0].sum())} bits), bitwise",
          flush=True)
    print(f"[8 full block] B3 wrapper {ms3:.3f} ms, B4 wrapper {ms4:.3f} ms "
          f"(medians of 5, CUDA events); plain versions {plain3:.1f} ms and "
          f"{plain4:.1f} ms (one run each, host clock)", flush=True)
    hdlc_ms, (_, frames) = host_ms(lambda: demod.hdlc_scan(
        k[0], k[1], c.hdlc, demod.init_frames(FLEET_STREAMS, FLEET_SLOTS,
                                              "cuda"), k[2]))
    pipe = BatchPipeline(FLEET_STREAMS, block_len=FLEET_BLOCK,
                         frame_slots=FLEET_SLOTS, device="cuda")
    drain_ms, per_stream = host_ms(lambda: pipe.drain(frames))
    n = sum(len(lst) for lst in per_stream)
    print(f"[8 full block] path S split of {what}: B3 {ms3:.3f} ms, plain "
          f"deframer hdlc_scan {hdlc_ms:.1f} ms, host drain {drain_ms:.1f} ms "
          f"({n} frames); hdlc_scan is "
          f"{100 * hdlc_ms / (ms3 + hdlc_ms + drain_ms):.1f} % of the three",
          flush=True)
    return err3, ms3, plain3, err4, ms4, plain4


def phase_superblock(blocks, main_result, block_s):
    """The pipelined decoder with kernel B1 over the three fleet blocks,
    block by block (depth 2) and as one superblock submission; frames
    and counters equal the main path's.  Wall times include the first
    use of each decoder's pinned buffers."""
    from gnuais_tpu_torch.runtime.streaming import PipelinedDecoder
    want, want_counters = main_result
    runs = (("per block", 1, list(blocks)),
            ("superblock 3", len(blocks), [np.concatenate(blocks, axis=1)]))
    walls = []
    for what, sb, subs in runs:
        dec = PipelinedDecoder(FLEET_STREAMS, block_len=FLEET_BLOCK,
                               frame_slots=FLEET_SLOTS, fused_pipeline=True,
                               device_crc=True, depth=2, superblock=sb,
                               device="cuda")
        t0 = time.perf_counter()
        results = dec.run(subs)
        walls.append(time.perf_counter() - t0)
        check(len(results) == len(subs),
              f"{what}: {len(results)} results for {len(subs)} submissions")
        merged = [sum(per, []) for per in zip(*map(payloads, results))]
        check(merged == want, f"{what}: frames differ from the main path's")
        check([vars(c) for c in dec.counters] == want_counters,
              f"{what}: counters differ from the main path's")
        print(f"[9 superblock] PipelinedDecoder(fused_pipeline, device_crc, "
              f"depth 2, {what}) over {len(blocks)} blocks of "
              f"[{FLEET_STREAMS}, {FLEET_BLOCK}]: frames and counters == "
              f"phase 4's; wall {walls[-1] * 1e3:.1f} ms (one run)",
              flush=True)
    print(f"[9 superblock] beside phase 4's median process() "
          f"{block_s * 1e3:.1f} ms per block, "
          f"{len(blocks) * block_s * 1e3:.1f} ms for {len(blocks)}",
          flush=True)
    return walls


def timed(label: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[{label}] phase wall time {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from gnuais_tpu_torch.ops import fused
    t_start = time.perf_counter()

    name, card = timed("1 device", phase_device)
    timed("2 build", phase_build)
    err = timed("3 parity", phase_parity)
    err3, err4 = timed("3 parity B3/B4", phase_parity_front)
    err1f, err3f, err4f = timed("3 parity fixture", phase_parity_fixture)

    fused.pipeline_fused_compact.launches = 0
    blocks, expected, carry0, carry1, block_s, main_result = timed(
        "4 main path", phase_main_path)
    timed("5 end to end", phase_end_to_end, "fused", "5 end to end")
    launches = fused.pipeline_fused_compact.launches
    check(launches >= FLEET_BLOCKS, f"kernel launched {launches} times")
    print(f"[5 end to end] kernel B1 launches on the main path: {launches}; "
          f"median full-size block process() {block_s * 1e3:.1f} ms on "
          f"{card}", flush=True)

    err2, ms, plain_ms = timed("6 full block", phase_full_block, blocks[0],
                               carry0, carry1)

    fused.frontend_fused.launches = 0
    timed("7 path S", phase_path_s, blocks, expected)
    launches3 = fused.frontend_fused.launches
    check(launches3 >= 2, f"kernel B3 launched {launches3} times on path S")
    print(f"[7 path S] kernel B3 launches on path S: {launches3}", flush=True)

    err3b, ms3, plain3, err4b, ms4, plain4 = timed(
        "8 full block B3/B4", phase_front_full, blocks[0])
    timed("9 superblock", phase_superblock, blocks, main_result, block_s)

    fused.dpll_fused.launches = 0
    timed("10 path F", phase_end_to_end, "fast", "10 path F")
    launches4 = fused.dpll_fused.launches
    check(launches4 > 0, f"kernel B4 launched {launches4} times on path F")
    print(f"[10 path F] kernel B4 launches on path F: {launches4}",
          flush=True)

    jax_loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib")))
    check(not jax_loaded, f"JAX was imported: {jax_loaded[:5]}")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    src = "gnuais_tpu_torch/csrc/"
    print(json.dumps({"kernels": [{
        "name": "pipeline_compact",
        "route": "cuda",
        "source": src + "pipeline_compact.cu",
        "replaces": "gnuais_tpu/ops/fused.py:1261",
        "launches": launches,
        "max_abs_err": max(err, err1f, err2),
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "frontend",
        "route": "cuda",
        "source": src + "frontend.cu",
        "replaces": "gnuais_tpu/ops/fused.py:346",
        "launches": launches3,
        "max_abs_err": max(err3, err3f, err3b),
        "ms": ms3,
        "plain_ms": plain3,
    }, {
        "name": "dpll",
        "route": "cuda",
        "source": src + "dpll.cu",
        "replaces": "gnuais_tpu/ops/fused.py:129",
        "launches": launches4,
        "max_abs_err": max(err4, err4f, err4b),
        "ms": ms4,
        "plain_ms": plain4,
    }]}), flush=True)
    print(f"{card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
