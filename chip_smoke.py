#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gnuais_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it passes with its wall time; any failure
raises and exits non-zero:

1. Device: the card's name, and its name and power limit from nvidia-smi.
2. Build: one nvcc per kernel source of gnuais_tpu_torch/csrc (B1
   pipeline_compact.cu, B2 pipeline_fused.cu (its prefiltered mode
   too), B3 frontend.cu, B4 dpll.cu, the deframer hdlc.cu, the mxu probe fir_probe.cu, R1 and
   R2 roofline.cu), all started together, linked into one library
   (registers and spills printed per kernel); B2's strip variants
   (pipeline_strip.cu) are not in it (phase 22).
3. Parity at small shapes, each kernel against its plain PyTorch version
   on the card, bitwise on every output and carry leaf.  B2 and B1 (the
   exact FIR): S = 1, 37, 256 at T = 4096 (and T = 1000) on encoder
   captures with noise, garbage rows, minimal back-to-back frames,
   wrong-size and CRC-reject frames; n_valid = T-333 and 20; a lost2
   window; frame_slots = 3 (overflow); three blocks chained through the
   carry.  B2 and B1 with the lobe FIR at S = 4096, T = 8192.  B3
   (frontend), B4 (DPLL) and the deframer (on B3's group codes and on
   B4's sample codes, with a lost2 window): S = 1, 37, 256 at T = 4096
   on mixed, noisy-frame, garbage and wrong-size/CRC-reject captures,
   n_valid = T, T-333, 35, 1 and 0, nonzero block bases and history,
   three chained blocks (B4 on the exact FIR of the same captures).
   Then B2, B1, B3, B4 and the deframer on every block the fixture
   gives the command line (phases 5 and 12): S = 1, T = 1024, n_valid
   1020 and a 990-sample tail, 73 blocks chained; B4 and the deframer
   on sample codes also as the exact backend feeds them, T = 1020 and
   the tail padded to 1020.
   B2 and B1 with the mxu FIR (tensor cores) against their plain
   versions at the small shapes above, every leaf, and B1 mxu against
   B1 with the exact FIR: the same frames and carry on every capture
   row; on rows of noise alone the same CRC-passing frames, the rows
   whose carry differs counted.  Then the edges of the producer and
   consumer ring, B2 and B1 in every FIR mode from row-major and from
   time-major input against one plain run: S = 1, 31, 33, 37, 4096; T =
   1000, 1024, 8192; n_valid 0, 1, 20, 31, 32, 33, T-333 and T over
   chained blocks.  B1 at the lanes' shapes (F = 64 slots, T = 56,320
   and 72,704) and B2 at the session's (T = 56,320), S = 33, against
   their plain versions run in a CPU child (below), bitwise.
4. Main path at full size: BatchPipeline(4096 streams, 49,152-sample
   blocks, 32 frame slots, fused_pipeline, CRC on the device), which runs
   kernel B2 and the candidate compaction, over three chained blocks;
   every stream's decoded payloads equal the encoded ones in every block.
5. End to end: the command line (``gnuais-tpu-torch -l
   tests/fixtures/standard_capture.raw --backend fused``, kernel B2)
   reproduces the capture's stdout byte for byte with counters (49, 0,
   0).
6. The first fleet block at full size through B2 and B1, with the exact
   and with the lobe FIR, row-major and pretiled (time-major, as phase
   7's input), and through their plain versions: bitwise equal on
   every output and carry leaf, B2's candidates compacted equal
   to B1's dense slots, B2's carry equal to the main path's; times of
   each wrapper, of the decode_block step and of the plain versions, and
   each kernel's bound; B2 also from a row-major view of the block with
   an odd pitch (no 16-byte copies), equal to the contiguous block's.
7. Flagship: bench.py's bit-exact flagship configuration at full width,
   12 copies of a 4-payload fleet block tiled time-major into one
   [589,824, 4096] int16 input and decoded by one pretiled decode_block
   call with kernel_compact (one launch of B1); frames and carry equal
   the row-major path's 12 chained blocks, every payload equals the
   encoded one.
   6 mxu: the same for B2 and B1 with the mxu FIR, and B1 mxu's frames
   and carry against B1 exact's on the block.
7m. Path M: bench.py's headline configurations, which run the mxu FIR
   (CONFIGS[0..2]), at full width on 12 copies of a 4-payload fleet
   block, [589,824, 4096]: one pretiled decode_block with kernel_compact
   (1 launch of B1), the same with B2 (1 launch), and the row-major
   decode_superblock (12 launches of B2); the same frames from all
   three, every payload equal to the encoded one, no CRC reject.  The
   first 64 streams of CONFIGS[0] and [1] at their full length against
   the plain version (frames and carry, bitwise), which a child process
   runs on the CPU during phases 8m-14 and which is read after them.
8. Lobe paths: BatchPipeline(fused_pipeline, device_crc, lobe_fir) over
   the three fleet blocks with B2 and with kernel_compact (B1); every
   payload equals the encoded one.  8m: the same with mxu_fir.
9. Path S: PipelinedDecoder(4096 streams, 49,152-sample blocks,
   fused_frontend, depth 2) over the three fleet blocks: kernel B3 and
   the deframer kernel; every payload equal to the encoded ones,
   counters (8 x blocks, 0, 0).
10. B3, B4 and the deframer (on B3's and on B4's codes) on the first
   fleet block at full size against their plain versions, bitwise;
   their times and bounds, and Path S's split of one block (B3, the
   deframer and compaction, the host drain).
11. PipelinedDecoder(fused_pipeline, device_crc, depth 2), kernel B2,
   over the three fleet blocks one by one, and with superblock 3 as one
   submission; frames and counters equal phase 4's; wall times.
12. Path F: ``gnuais-tpu-torch -l tests/fixtures/standard_capture.raw
   --backend fast`` and ``--backend exact`` (the exact FIR, kernel B4
   and the deframer kernel) reproduce the stdout byte for byte with
   counters (49, 0, 0).
13. Probe: the mxu producer stage of B1/B2 alone (fir_mxu_probe: the
   same producer warps and ring, a consumer that writes the values out)
   on the first fleet block, within fused.MXU_BOUND of the exact FIR;
   its error, time and bound.
14. Path R: the roofline tool's kernels R1 and R2 in every mode against
   their plain versions at S = 64, bitwise, and at S = 4096 (timed);
   then the tool's table (python -m gnuais_tpu_torch.roofline) at 4096
   and 16,384 streams, beside B1's ns a sample from phase 6.
15. Station: the command line as a station runs it, on the card, for
   --backend fused (B2) and exact (B4 and the deframer kernel); every
   run's NMEA socket on a temporary path, never the default one.  The
   fixture fed live through a FIFO with every sink on (the NMEA socket
   with a client, sqlite, the JSON-AIS uplink to a local HTTP server,
   the soundoutfile tee): stdout byte for byte with counters (49, 0, 0),
   the socket's sentences, one ais_nmea row a sentence, the tee's bytes,
   the uplink's JSON equal to the golden model's.  The station's time:
   three runs on the fixture looped 16 times (24.8 s of audio), fed as
   fast as the CLI reads, every sink on, checked against the fixture's
   lines; the set-up, the block loop (its real-time factor) and the
   close apart, and each process_block call's host time.  Then at the
   pace of real time with statsinterval 1s (range lines) and --profile
   (the torch.profiler trace names each kernel the backend launches);
   the checkpoint seam (--checkpoint over the first half, then the
   whole capture: the lines together equal the fixture's); and
   soundchannels both (the fixture on A, a seeded capture on B) equal to
   the golden model's lines and counters on each channel.
16. Supervised fleet: SupervisedDecoder over phase 4's BatchPipeline (B2)
   on the three fleet blocks, a checkpoint after every block, a failure
   injected in the second block's process(): frames and counters equal
   phase 4's; a new decoder over the snapshot after two blocks resumes
   at 2 x 49,152 samples and decodes block 3 equal to phase 4's; the
   checkpoint's write and read times at 4096 streams and the recovery's
   wall time.
17. IQ: a stereo IQ capture at decim 4 (channel A fleet rows 0-29 of
   block 0 laid end to end, B rows 30-59, each row rolled 0-4 samples
   onto the free-running DPLL's grid; FM-modulated; 94 MB of float32)
   through the command line with inputformat iq, sequential (--backend
   fused, B2), streams 8 (the lanes, B1) and meshshape 1 1 (the
   session, B2): each channel's stdout lines those of its encoded
   payloads in order, counters (240, 0, 0) a channel, the lanes' and
   the session's stdout the same bytes (the sequential path's A/B
   interleaving follows its reader-block framing: the moved lines
   counted).  The card's int16 audio of the first 8 reader blocks
   against the front end on the CPU (at most 1 in 1000 samples off by
   1); the front end's ms a 65,536-frame block.
18. Lanes: time_parallel_decode (B1, F = 64) over all 4096 rows of
   fleet block 0 end to end (rolled as in 17), 201,326,592 samples:
   3072 lanes of T = 72,704 (the slot drain) and the first 512 rows
   (384 lanes, the dense drain); every payload in row order, no other
   frame; the gather, B1 and drain times.  B1 on the first 64 lanes
   against its plain version in the CPU child.  Then the command line
   with streams 4096 on the stream as a 403 MB raw file: its stdout
   the lines of the 32,768 encoded payloads, counters (32768, 0, 0).
   Last, the rows end to end without the roll through the lanes and a
   one-stream session (64 super-blocks, B2): each one's frame loss
   printed and bounded (the shared fault, ROADMAP section 3 item 8).
19. Session: TimeParSession on a 1 x 1 grid of the card, 4096 rows,
   super-blocks of 49,152 (B2 at T = 56,320) over phase 4's three fleet
   blocks: per stream the frames of phase 4; a snapshot after block 1
   written as the CLI's .mesh.npz holds it, read back into a new
   session that continues identically; ms a push, the snapshot's size
   and times, a block's upload pageable and through pinned memory.  B2
   on the first 64 rows of block 1's window against its plain version
   in the CPU child.
20. Grids: the visible cards, each repeated round-robin to fill a grid
   of 4 shards (each grid's cards printed, torch's name and nvidia-smi's
   name and power limit, and the cards' peer access).
   dryrun_multichip(4) (the stream-sharded step, then the 2 x 2 step
   with a frame across the first shard boundary); TimeParSession on a
   2 x 2 grid, 4096 rows, super-blocks of 49,152 (t_loc 24,576, B2 at
   T = 31,744 on each shard) over phase 4's three fleet blocks: stream
   by stream phase 19's frames, equal counters; GroupedTimeParSession
   on a 4 x 1 grid, 1024 channels each of 4 fleet rows of block 0 and
   then of block 1 end to end (rolled as in phase 18; group 4,
   super-blocks of 196,608 a channel): every channel's frames those of
   its rows in phase 4 at their rows' positions; make_sharded_decode on
   the 4 shards over block 0 four times, each bitwise one decode_block's
   (the median of the last three timed); ms a push beside phase 19's.
21. The command line on grids and the cluster, on phase 17's stereo IQ
   capture: meshshape 2 2 and meshshape 4 1 (grouped, 2 row segments a
   channel) through cli.main, stdout and counters those of phase 17's
   meshshape 1 1 run (with fewer than 4 cards: each refused with rc 1);
   then two spawned ranks, --cluster 127.0.0.1:<port> 2 <r> with
   meshshape 2 1, each on its own card where there are two
   (CUDA_VISIBLE_DEVICES), else both on card 0: rank 0's stdout that of
   the meshshape 1 1 run, rank 1's empty, both ranks' counters equal;
   each rank counts its own launches, which this process adds up.
22. Kernel B2's other modes and the measurement tools, on fleet block 0
   (4096 x 49,152).  (a) B2 prefiltered (the kernel filters nothing) on
   the block's fir_exact: against its plain version on every leaf,
   row-major and time-major, bitwise, the history handed back; its
   frames and carry those of phase 6's B2 vpu on the raw block; on the
   block's fir_conv every payload equal to the encoded one.  (d) The
   strip libraries (pipeline_strip.cu, one nvcc a strip set, all
   started together, nothing else running); each strip flag in vpu and
   mxu held by its invariant against the unstripped kernel
   (gnuais_tpu_torch.diag_strip.check_strip).  (b) The FIR split:
   fir_conv and prefiltered B2 beside B2 in every FIR mode (CUDA
   events).  Then, with the counts of B2's modes set to 0: (d)
   diag_strip's protocol at K = 2 for every strip variant in vpu and
   mxu and on prefiltered input (a table of ms and ns a step);
   (e) python -m gnuais_tpu_torch.profile_flagship --iters 2 in a
   process of its own (device time by kernel, the idle share; its trace
   must hold the 2 launches of B1) and its parser on 3 process() calls
   of the main path after a warm-up call (3 launches of B2); (f)
   latency_bench on 1x1:4096 and the sequential station (p50/p90 in
   samples); (g) diag_shard, 16 pairs.  B2's prefiltered mode and strip
   variants must each have launched there (diag_strip's runs).
The plain versions of phase 3's lane and session shapes and of phases
18 and 19 run after phase 22 (no timed phase shares the host with
them), each in a spawned CPU process of its own, and are held against
the kernels' outputs.
Then one JSON line of the fourteen kernel modes (launch counts from their
own paths, each count set to 0 just before its path: B2 over phases
4-5, 15, 16, 17 (sequential and mesh), 19, 20 and 21 (the ranks' too),
B1 in phase 7's pretiled
call and phases 17 (lanes) and 18, B2 lobe and B1 lobe over
phase 8, B1 mxu and B2 mxu over phases 7m and 8m, B3 over phase 9, B4
over phases 12 and 15, the deframer on group codes over phase 9 and on
sample codes over phases 12 and 15, R1 and R2 over phase 14's table,
B2 prefiltered over diag_strip's runs in phase 22;
times and bounds at the fleet size, R1's and R2's at 4096 streams and
4096 steps), a check
that neither JAX nor the JAX package was imported, the card's name and
power limit, and the result line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is available or
when run outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import os
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
PATH_S_BLOCKS = FLEET_BLOCKS  # Path S's depth
VARIANTS = 32            # distinct captures per block, cycled over streams
CLI_BLOCK = 1020         # the CLI's file-mode block: 1024 in whole 5-sample bits
KERNEL_BLOCK = 1024      # the kernel backends pad it to a multiple of 512
FIXTURE_SLOTS = 32       # the config's default frameslots
ROOFLINE_STEPS = 1 << 22  # R1's steps a call (R2: 2^17, 32 passes)
ROOFLINE_ITERS = 3
FLAGSHIP_COPIES = 12     # bench.py's bit-exact flagship: superblock 12,
FLAGSHIP_PAYLOADS = 4    # 4 payloads per stream and block,
FLAGSHIP_SLOTS = 64      # 64 frame slots over the superblock
PATH_M_CHECKED = 64      # Path M's streams held against the plain version
# operations per valid sample of each FIR that the function needs: the
# exact FIR's 36 float32 multiplies and 35 adds, the lobe FIR's 8 pair
# adds, 8 multiplies and 7 adds; the mxu FIR's 36 taps in 3 TF32 passes
# (3xTF32), 108 tensor-core multiply-adds or 216 operations (the kernel
# issues 168 multiply-adds a sample, the band's zeros in its tiles
# included, which the bound does not count); the integer DPLL and
# deframer work is not counted.  The rates: gnuais_tpu_torch.card.
FIR_FLOPS = {"vpu": 71, "lobe": 23, "mxu": 216}
# below the time of any copy of a fleet block (403 MB of int16 read and
# written: 0.24 ms at 3.35 TB/s): the limit on each kernel that B3's and
# B4's wrappers launch beside their own
COPY_MS = 0.1


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


def device_kernels(fn) -> dict:
    """{device kernel name: ms} of one call of fn, by torch.profiler."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = collections.Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms[ev.name] += ev.time_range.elapsed_us() / 1e3
    return dict(ms)


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
    print(f"[2 build] {path.relative_to(REPO)} from {len(_build._sources()[0])} "
          f".cu files in {time.time() - t0:.1f} s", flush=True)
    for line in info:
        print("  " + line.strip(), flush=True)
    from gnuais_tpu_torch.ops import fused
    for mode in fused.FIR_MODES:
        print(f"  B1/B2 {mode}: {fused.pipeline_shape(mode)}", flush=True)


def run_both(x, nv, carry, fs, base=0, window=(None, None),
             plain_carry=None, fir_mode="vpu"):
    """Kernels B2 and B1 and their plain versions on the same device
    inputs (the plain versions from ``plain_carry`` when given): B2's
    plain version is ``pipeline_fused_reference``, B1's that run's
    ``compact_slots``.  Returns (B2, B2 plain, B1, B1 plain)."""
    import torch
    from gnuais_tpu_torch.ops import fused
    lo, hi = window
    kw = dict(block_base=base, fir_mode=fir_mode, lost2_lo=lo, lost2_hi=hi)
    k2 = fused.pipeline_fused(x, nv, carry.history, carry.dpll, carry.hdlc,
                              **kw)
    k1 = fused.pipeline_fused_compact(x, nv, carry.history, carry.dpll,
                                      carry.hdlc, frame_slots=fs, **kw)
    torch.cuda.synchronize()
    pc = carry if plain_carry is None else plain_carry
    p2 = fused.pipeline_fused_reference(x, nv, pc.history, pc.dpll, pc.hdlc,
                                        **kw)
    p1 = fused.compact_slots(p2, fs)
    torch.cuda.synchronize()
    return k2, p2, k1, p1


def phase_parity():
    """B2 and B1 against their plain versions at small shapes; returns
    the max abs error of each."""
    import torch
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
        ("S=37 mixed T=1000", captures.mixed(37, 1000, seed=9), 1000, 8, 5,
         None),
    ]
    err2 = err1 = 0.0
    for name, x, nv, fs, base, window in cases:
        k2, p2, k1, p1 = run_both(torch.from_numpy(x).cuda(), nv,
                                  init_carry(x.shape[0], "cuda"), fs, base,
                                  window or (None, None))
        err2 = max(err2, compare(k2, p2, f"B2 {name}"))
        err1 = max(err1, compare(k1, p1, f"B1 {name}"))
        print(f"[3 parity] {name}: B2 and B1 bitwise equal to plain, "
              f"candidates {int(k2[0].sum())} of {k2[0].numel()} slots, frames "
              f"{int(k1[0].sum())}, dropped {int((k1[0] - fs).clamp(min=0).sum())}, "
              f"lost2 {int(k1[5].sum())}, over {int(k1[6].sum())}", flush=True)
    # three blocks chained through each side's own carry
    x = captures.mixed(37, 3 * t, seed=8)
    # (the kernels from the kernels' carry, the plain versions from theirs)
    ck = cp = init_carry(37, "cuda")
    for b in range(3):
        nv = t if b < 2 else t - 333
        xb = torch.from_numpy(np.ascontiguousarray(x[:, b * t:(b + 1) * t])).cuda()
        k2, p2, k1, p1 = run_both(xb, nv, ck, 8, base=b * t, plain_carry=cp)
        err2 = max(err2, compare(k2, p2, f"B2 chained block {b}"))
        err1 = max(err1, compare(k1, p1, f"B1 chained block {b}"))
        compare(k1[7:], k2[7:], f"B1 carry vs B2 carry, chained block {b}")
        ck, cp = PipelineCarry(*k2[7:]), PipelineCarry(*p2[7:])
        print(f"[3 parity] chained block {b}: B2 and B1 bitwise equal to "
              f"plain, frames {int(k1[0].sum())}", flush=True)
    return err2, err1


# (S, T, n_valid of each chained block) of the ring's edges
RING_EDGES = [(1, 1000, (1000, 0, 1)), (31, 1024, (20, 31, 1024)),
              (33, 8192, (8192 - 333,)), (37, 1000, (33, 1, 1000 - 333)),
              (4096, 1024, (1024, 32, 1024 - 333))]


def phase_parity_edges():
    """B2 and B1 around the ring's edges (``RING_EDGES``), in every FIR
    mode, from row-major and time-major input, against their plain
    versions, bitwise on every leaf, chained each through its own carry
    (the row-major kernels' and the plain run's).  Returns {fir_mode:
    (B2's max abs error, B1's)}."""
    import torch
    from gnuais_tpu_torch import captures
    from gnuais_tpu_torch.ops import fused
    from gnuais_tpu_torch.runtime.pipeline import PipelineCarry, init_carry
    errs = {}
    for mode in fused.FIR_MODES:
        e2 = e1 = 0.0
        for s, t, nvs in RING_EDGES:
            x = captures.mixed(s, len(nvs) * t, seed=s + t)
            ck = ct = cp = init_carry(s, "cuda")
            for b, nv in enumerate(nvs):
                xb = torch.from_numpy(np.ascontiguousarray(
                    x[:, b * t:(b + 1) * t])).cuda()
                kw = dict(block_base=b * t + 5, fir_mode=mode)
                what = f"{mode} S={s} T={t} block {b} n_valid={nv}"
                p2 = fused.pipeline_fused_reference(
                    xb, nv, cp.history, cp.dpll, cp.hdlc, **kw)
                p1 = fused.compact_slots(p2, 5)
                for layout, xin, c, tiled in (
                        ("row-major", xb, ck, {}),
                        ("time-major", xb.t().contiguous(), ct,
                         dict(pretiled_streams=s))):
                    k2 = fused.pipeline_fused(xin, nv, c.history, c.dpll,
                                              c.hdlc, **kw, **tiled)
                    k1 = fused.pipeline_fused_compact(
                        xin, nv, c.history, c.dpll, c.hdlc, frame_slots=5,
                        **kw, **tiled)
                    e2 = max(e2, compare(k2, p2, f"B2 {what} {layout}"))
                    e1 = max(e1, compare(k1, p1, f"B1 {what} {layout}"))
                    if tiled:
                        ct = PipelineCarry(*k2[7:])
                    else:
                        ck = PipelineCarry(*k2[7:])
                cp = PipelineCarry(*p2[7:])
        errs[mode] = (e2, e1)
        print(f"[3 parity edges] {mode}: B2 and B1, row-major and "
              f"time-major, bitwise equal to plain at (S, T, n_valid) "
              f"{RING_EDGES}", flush=True)
    return errs


def phase_parity_lobe():
    """(c) B2 and B1 with the lobe FIR against their plain versions at
    S = 4096, T = 8192 (the plain version's cost grows with T, not S),
    from a carried history of noise; returns the max abs error of each."""
    import torch
    from gnuais_tpu_torch import captures
    from gnuais_tpu_torch.runtime.pipeline import init_carry
    s, t = FLEET_STREAMS, 8192
    rows = np.concatenate([captures.mixed(64, t, seed=60 + i)
                           for i in range(s // 64)])
    x = torch.from_numpy(rows).cuda()
    c = init_carry(s, "cuda")
    c = c._replace(history=torch.from_numpy(
        captures.garbage(s, 36, seed=61).astype(np.float32)).cuda())
    k2, p2, k1, p1 = run_both(x, t - 333, c, 16, base=12345,
                              window=(12345 + 2000, 12345 + 6000),
                              fir_mode="lobe")
    err2 = compare(k2, p2, "B2 lobe S=4096 T=8192")
    err1 = compare(k1, p1, "B1 lobe S=4096 T=8192")
    print(f"[3 parity lobe] S={s} T={t} n_valid=T-333: B2 lobe and B1 lobe "
          f"bitwise equal to plain, frames {int(k1[0].sum())}, lost2 "
          f"{int(k1[5].sum())}", flush=True)
    return err2, err1


def fleet_block(b: int, n_payloads: int, g):
    """Block ``b`` of the fleet, [4096, 49152] int16 on the card, and per
    stream the encoded payloads.  Stream s plays variant s % VARIANTS of
    the block (an encoder capture of ``n_payloads`` random payloads),
    shifted within the block so that its frames stay inside it, plus
    Gaussian noise from the generator ``g``."""
    import torch
    from gnuais_tpu_torch import captures
    s = torch.arange(FLEET_STREAMS, device="cuda")
    tt = torch.arange(FLEET_BLOCK, device="cuda")
    base = np.empty((VARIANTS, FLEET_BLOCK), dtype=np.int16)
    lens, pays = [], []
    for v in range(VARIANTS):
        audio, payloads = captures.payload_capture(
            np.random.default_rng([SEED, b, v]), n_payloads, gap_bits=64)
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
    del dev, idx
    x += 300.0 * torch.randn(x.shape, generator=g, device="cuda")
    x = x.round_().clamp_(-32768, 32767).to(torch.int16)
    return x, [pays[int(v)] for v in var.tolist()]


def fleet_blocks():
    """FLEET_BLOCKS fleet blocks of 8 payloads per stream, on the host,
    and their encoded payloads (noise made on the card from SEED)."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    blocks, expected = [], []
    for b in range(FLEET_BLOCKS):
        x, want = fleet_block(b, 8, g)
        blocks.append(x.cpu().numpy())
        expected.append(want)
    return blocks, expected


def check_payloads(per_stream, want, what: str) -> int:
    """Every stream's decoded payloads equal its encoded ones, in order;
    returns the number of frames."""
    n = 0
    for i, (frames, pays) in enumerate(zip(per_stream, want)):
        check(len(frames) == len(pays),
              f"{what} stream {i}: {len(frames)} frames, {len(pays)} sent")
        for fr, pay in zip(frames, pays):
            check(np.array_equal(fr.payload_bits[:fr.bufferlen], pay),
                  f"{what} stream {i}: payload differs")
        n += len(frames)
    return n


def phase_main_path():
    """The main path: BatchPipeline with the fused step (kernel B2, the
    candidate compaction and the CRC filter on the device) over the
    three fleet blocks."""
    import torch
    from gnuais_tpu_torch.runtime.pipeline import BatchPipeline
    blocks, expected = fleet_blocks()
    pipe = BatchPipeline(FLEET_STREAMS, block_len=FLEET_BLOCK,
                         frame_slots=FLEET_SLOTS, fused_pipeline=True,
                         device_crc=True, device="cuda")
    carry0 = pipe.carry
    times, carry1, per_block = [], None, []
    got = [[] for _ in range(FLEET_STREAMS)]
    for b, x in enumerate(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_stream = pipe.process(x)
        times.append(time.perf_counter() - t0)
        if b == 0:
            carry1 = pipe.carry
        n_frames = check_payloads(per_stream, expected[b], f"block {b}")
        per_block.append(payloads(per_stream))
        for i, lst in enumerate(per_block[-1]):
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
        (got, counters), per_block


def phase_end_to_end(backend: str, label: str):
    """The command line as a user runs it (``gnuais-tpu-torch -l
    capture.raw --backend <backend>``, on cuda by default), in this
    process so that its kernel launches are counted, its NMEA socket in
    a temporary directory."""
    import contextlib
    import io
    import logging
    import tempfile
    fix = REPO / "tests" / "fixtures"
    out, summary = io.StringIO(), io.StringIO()
    handler = logging.StreamHandler(summary)
    log = logging.getLogger("gnuais")
    log.setLevel(logging.INFO)
    log.addHandler(handler)
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                own_socket(short_path(Path(tmp) / "nmea.sock")) as cli, \
                contextlib.redirect_stdout(out):
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


def bound(tensors, flops: float, tensor_cores: bool = False):
    """The least time the card could take for a call (``card.bound_ms``):
    the larger of the bytes of ``tensors`` (its inputs and outputs, each
    counted once) over the HBM rate and ``flops`` operations over the
    float32 rate outside the tensor cores, or with ``tensor_cores`` the
    TF32 rate.  Returns (ms, "bytes" or "operations")."""
    import torch
    from gnuais_tpu_torch import card
    nbytes = sum(t.numel() * t.element_size() for t in leaves(tensors)
                 if isinstance(t, torch.Tensor))
    return card.bound_ms(nbytes, (flops, card.TF32_TFLOPS if tensor_cores
                                  else card.F32_TFLOPS))


def phase_full_block(x0, carry0, carry1, fir_mode):
    """(a, b) Kernels B2 and B1 with the ``fir_mode`` FIR against their
    plain versions on the main path's first block at full size, every
    output and carry leaf, from the row-major block and from the same
    block pretiled (time-major, the layout of phase 7's flagship input,
    assume_full); B1 against B2's candidates compacted; for
    "vpu" B2's carry against the main path's.  With the times of both
    wrappers, the fused decode_block step and the plain versions (one
    run of B2's plain version; B1's adds its compaction), and each
    kernel's bound.  Returns {kernel: dict of the kernels line}."""
    import torch
    from gnuais_tpu_torch.ops import fused
    from gnuais_tpu_torch.runtime.pipeline import decode_block

    x = torch.from_numpy(x0).cuda()
    args = (x, FLEET_BLOCK, carry0.history, carry0.dpll, carry0.hdlc)
    ms2, k2 = device_ms(lambda: fused.pipeline_fused(*args, fir_mode=fir_mode))
    ms1, k1 = device_ms(lambda: fused.pipeline_fused_compact(
        *args, frame_slots=FLEET_SLOTS, fir_mode=fir_mode))
    # the same block time-major, as the pretiled flagship feeds B1
    tiled = fused.tile_superblock(x, 1)[0]
    pre = dict(fir_mode=fir_mode, assume_full=True,
               pretiled_streams=FLEET_STREAMS)
    targs = (tiled,) + args[1:]
    pre2_ms, t2 = device_ms(lambda: fused.pipeline_fused(*targs, **pre))
    pre1_ms, t1 = device_ms(lambda: fused.pipeline_fused_compact(
        *targs, frame_slots=FLEET_SLOTS, **pre))
    step_ms, _ = device_ms(lambda: decode_block(
        x, FLEET_BLOCK, carry0, frame_slots=FLEET_SLOTS, fused_pipeline=True,
        device_crc=True, lobe_fir=fir_mode == "lobe",
        mxu_fir=fir_mode == "mxu"))
    plain2, p2 = host_ms(lambda: fused.pipeline_fused_reference(
        *args, fir_mode=fir_mode))
    compact_ms, p1 = host_ms(lambda: fused.compact_slots(p2, FLEET_SLOTS))
    what = (f"{fir_mode} block 0 at S={FLEET_STREAMS} T={FLEET_BLOCK} "
            f"F={FLEET_SLOTS}")
    err2 = max(compare(k2, p2, f"{what}, B2 vs plain"),
               compare(t2, p2, f"{what}, pretiled B2 vs plain"))
    err1 = max(compare(k1, p1, f"{what}, B1 vs plain"),
               compare(t1, p1, f"{what}, pretiled B1 vs plain"))
    compare(fused.compact_slots(k2, FLEET_SLOTS), k1,
            f"{what}, B2's candidates compacted vs B1")
    # a row-major view with an odd pitch: the kernel copies sample by
    # sample where it cannot copy 16 bytes at a time
    wide = torch.zeros((FLEET_STREAMS, FLEET_BLOCK + 5), dtype=torch.int16,
                       device="cuda")
    wide[:, 3:3 + FLEET_BLOCK] = x
    compare(fused.pipeline_fused(wide[:, 3:3 + FLEET_BLOCK], *args[1:],
                                 fir_mode=fir_mode), k2,
            f"{what}, B2 from an odd-pitch view vs the contiguous block")
    del wide
    if carry1 is not None:
        compare(k2[7:], tuple(carry1), f"{what}, B2 carry vs main path carry")
    print(f"[6 full block] {what}: B2 == plain on all {len(leaves(k2))} output "
          f"and carry leaves ({int(k2[0].sum())} candidates in "
          f"{k2[0].shape[1]} slots per stream), B1 == plain on all "
          f"{len(leaves(k1))} ({int(k1[0].sum())} frames), both also from "
          f"the pretiled [{FLEET_BLOCK}, {FLEET_STREAMS}] block, B2 also "
          f"from an odd-pitch view, B2's candidates compacted == B1's "
          f"dense slots"
          + (", B2's carry == the main path's" if carry1 is not None else "")
          + ", bitwise", flush=True)
    flops = FIR_FLOPS[fir_mode] * FLEET_STREAMS * FLEET_BLOCK
    out = {}
    for name, ms, k, plain_ms, err in (("B2", ms2, k2, plain2, err2),
                                       ("B1", ms1, k1, plain2 + compact_ms,
                                        err1)):
        b_ms, b_by = bound((args, k), flops, fir_mode == "mxu")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, pretiled_ms=(
                             pre2_ms if name == "B2" else pre1_ms))
    out["B1"]["out"] = k1
    out["B2"]["out"], out["B2"]["plain"] = k2, p2
    print(f"[6 full block] {fir_mode} S={FLEET_STREAMS} T={FLEET_BLOCK}: B2 "
          f"wrapper {ms2:.3f} ms (bound {out['B2']['bound_ms']:.3f} ms by "
          f"{out['B2']['bound_by']}), B1 wrapper {ms1:.3f} ms (bound "
          f"{out['B1']['bound_ms']:.3f} ms by {out['B1']['bound_by']}), "
          f"decode_block step (B2, compaction, CRC filter) {step_ms:.3f} ms, "
          f"pretiled wrappers (no transpose) B2 {pre2_ms:.3f} ms and B1 "
          f"{pre1_ms:.3f} ms (medians of 5, CUDA events); plain B2 "
          f"{plain2:.1f} ms, its "
          f"compaction to B1's slots {compact_ms:.1f} ms (one run, host "
          f"clock)", flush=True)
    return out


def hdlc_both(codes, form, state, base=0, window=(None, None)):
    """The deframer kernel (``hdlc_fused``) on ``codes`` (B3's group codes
    or B4's sample codes, ``form``) and its plain version on the same
    input, and the max abs error between them (bitwise equal, or the run
    fails).  Returns (kernel's output, error)."""
    import torch
    from gnuais_tpu_torch.ops import fused
    lo, hi = window
    kw = dict(block_base=base, lost2_lo=lo, lost2_hi=hi)
    k = fused.hdlc_fused(state, codes, form, **kw)
    p = fused.hdlc_fused_reference(state, codes, form, **kw)
    torch.cuda.synchronize()
    return k, compare(k, p, f"deframer {form} S={codes.shape[1]} "
                            f"rows={codes.shape[0]} base={base}")


def phase_parity_front():
    """Kernels B3, B4 and the deframer against their plain versions at
    small shapes (the deframer on B3's group codes and on B4's sample
    codes, with a lost2 window); returns the max abs error of B3, of B4
    and of the deframer on each form ({form: error})."""
    import torch
    from gnuais_tpu_torch import captures
    from gnuais_tpu_torch.ops import fir, fused
    from gnuais_tpu_torch.runtime.pipeline import init_carry
    t = 4096
    makers = {"mixed": captures.mixed, "noisy_frames": captures.noisy_frames,
              "garbage": captures.garbage,
              "wrong_size_and_crc": captures.wrong_size_and_crc}
    cases = [(s, m, t) for s in (1, 37, 256) for m in makers]
    cases += [(s, "mixed", nv) for s in (1, 37, 256)
              for nv in (t - 333, 35, 1, 0)]
    err3 = err4 = 0.0
    err_h = {"group": 0.0, "sample": 0.0}
    for i, (s, m, nv) in enumerate(cases):
        x = torch.from_numpy(makers[m](s, t, seed=30 + i)).cuda()
        hist = torch.from_numpy(captures.garbage(s, 36, seed=i)
                                .astype(np.float32)).cuda()
        c = init_carry(s, "cuda")
        dpll = c.dpll
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
        window = (base + 500, base + 3000)
        codes, _, _ = fused.frontend_codes(x, nv, hist, dpll)
        h, e = hdlc_both(codes, "group", c.hdlc, base, window)
        err_h["group"] = max(err_h["group"], e)
        scodes, _ = fused.dpll_codes(filtered, nv, dpll)
        err_h["sample"] = max(err_h["sample"], hdlc_both(
            scodes, "sample", c.hdlc, base, window)[1])
        print(f"[3 parity B3/B4/deframer] {what}: all three bitwise equal, "
              f"{int(k[1].sum())} bit slots, {int(h[1].valid.sum())} frame "
              f"candidates, lost2 {int(h[1].lost2.sum())}", flush=True)
    # three blocks chained through each side's own state
    s = 37
    x = captures.mixed(s, 3 * t, seed=8)
    c = init_carry(s, "cuda")
    kh = ph = c.history
    kd = pd = kd4 = pd4 = c.dpll
    kq = pq = kq4 = pq4 = c.hdlc
    for b in range(3):
        xb = torch.from_numpy(np.ascontiguousarray(
            x[:, b * t:(b + 1) * t])).cuda()
        nv = t if b < 2 else t - 333
        base = 2**31 - t + b * t
        k = fused.frontend_fused(xb, nv, kh, kd, base)
        codes, _, _ = fused.frontend_codes(xb, nv, kh, kd)
        p = fused.frontend_fused_reference(xb, nv, ph, pd, base)
        err3 = max(err3, compare(k, p, f"B3 chained block {b}"))
        kh, kd, ph, pd = k[3], k[4], p[3], p[4]
        hk = fused.hdlc_fused(kq, codes, "group", block_base=base)
        hp = fused.hdlc_fused_reference(pq, codes, "group", block_base=base)
        err_h["group"] = max(err_h["group"], compare(
            hk, hp, f"deframer group chained block {b}"))
        kq, pq = hk[0], hp[0]
        filtered, _ = fir.fir_exact(xb, torch.zeros_like(kh), n_valid=nv)
        k4 = fused.dpll_fused(filtered, nv, kd4)
        scodes, _ = fused.dpll_codes(filtered, nv, kd4)
        p4 = fused.dpll_fused_reference(filtered, nv, pd4)
        err4 = max(err4, compare(k4, p4, f"B4 chained block {b}"))
        kd4, pd4 = k4[2], p4[2]
        hk = fused.hdlc_fused(kq4, scodes, "sample", block_base=base)
        hp = fused.hdlc_fused_reference(pq4, scodes, "sample", block_base=base)
        err_h["sample"] = max(err_h["sample"], compare(
            hk, hp, f"deframer sample chained block {b}"))
        kq4, pq4 = hk[0], hp[0]
        print(f"[3 parity B3/B4/deframer] chained block {b}: all three "
              f"bitwise equal", flush=True)
    return err3, err4, err_h


def phase_parity_fixture(dev: str = "cuda"):
    """B2, B1, B3, B4 and the deframer against their plain versions on
    every block
    that the command line's kernel backends (phases 5 and 12) give them
    for the fixture: S = 1, at block_base 0, each side chained through
    its own state from block to block, as ``BatchPipeline.process`` runs
    them.  The kernel backends' blocks are CLI_BLOCK samples padded to
    KERNEL_BLOCK with zeros and the short tail: B1 (the command line's
    fused step before B2, and ``kernel_compact``'s) lands the frames at
    the running count in FIXTURE_SLOTS slots; B4 takes the exact FIR of
    each block, the FIR history carried; the deframer B3's group codes
    and B4's sample codes, each chained through its own carry.  The
    ``exact`` backend's blocks are CLI_BLOCK wide, the tail padded to
    CLI_BLOCK (T = 1020: 255 slots, a partial tile), and B4 and the
    deframer run on them as well.  Returns the max abs error of each
    kernel, the deframer's by form ({form: error})."""
    import torch
    from gnuais_tpu_torch.ops import fir, fused
    from gnuais_tpu_torch.runtime.pipeline import PipelineCarry, init_carry
    audio = np.fromfile(REPO / "tests" / "fixtures" / "standard_capture.raw",
                        dtype="<i2")
    c = init_carry(1, dev)
    ck = cp = ck1 = c                            # B2, its plain version, B1
    kh, kd, ph, pd = c.history, c.dpll, c.history, c.dpll   # B3
    kq = pq = c.hdlc                             # the deframer on B3's codes
    err2 = err1 = err3 = err4 = 0.0
    err_h = {"group": 0.0, "sample": 0.0}

    def fir_b4_deframer(x, nv, st, what):
        """The exact FIR of ``x``, B4 on it and the deframer on B4's
        sample codes, B4 and the deframer against their plain versions;
        ``st`` is (FIR history, B4's state, its plain version's, the
        deframer's, its plain version's).  Returns (st', bits, frame
        candidates)."""
        nonlocal err4
        fh, kd4, pd4, kq4, pq4 = st
        filtered, fh = fir.fir_exact(x, fh, n_valid=nv)
        scodes, _ = fused.dpll_codes(filtered, nv, kd4)
        k4 = fused.dpll_fused(filtered, nv, kd4)
        p4 = fused.dpll_fused_reference(filtered, nv, pd4)
        err4 = max(err4, compare(k4, p4, f"B4 {what}"))
        hk = fused.hdlc_fused(kq4, scodes, "sample")
        hp = fused.hdlc_fused_reference(pq4, scodes, "sample")
        err_h["sample"] = max(err_h["sample"], compare(
            hk, hp, f"deframer sample {what}"))
        return ((fh, k4[2], p4[2], hk[0], hp[0]), int(k4[0].sum()),
                int(hk[1].valid.sum()))

    st4 = (c.history, c.dpll, c.dpll, c.hdlc, c.hdlc)
    n_valid, frames, bits, framed = [], 0, 0, [0, 0]
    for b, off in enumerate(range(0, len(audio), CLI_BLOCK)):
        blk = audio[off:off + CLI_BLOCK]
        nv = len(blk)
        n_valid.append(nv)
        xb = np.zeros((1, KERNEL_BLOCK), dtype=np.int16)
        xb[0, :nv] = blk
        x = torch.from_numpy(xb).to(dev)
        what = f"fixture block {b} (n_valid {nv})"
        k = fused.pipeline_fused(x, nv, ck.history, ck.dpll, ck.hdlc)
        p = fused.pipeline_fused_reference(x, nv, cp.history, cp.dpll, cp.hdlc)
        err2 = max(err2, compare(k, p, f"B2 {what}"))
        k1 = fused.pipeline_fused_compact(x, nv, ck1.history, ck1.dpll,
                                          ck1.hdlc, frame_slots=FIXTURE_SLOTS)
        err1 = max(err1, compare(k1, fused.compact_slots(p, FIXTURE_SLOTS),
                                 f"B1 {what}"))
        ck, cp = PipelineCarry(*k[7:]), PipelineCarry(*p[7:])
        ck1 = PipelineCarry(*k1[7:])
        frames += int(k[0].sum())
        codes, _, _ = fused.frontend_codes(x, nv, kh, kd)
        k = fused.frontend_fused(x, nv, kh, kd)
        p = fused.frontend_fused_reference(x, nv, ph, pd)
        err3 = max(err3, compare(k, p, f"B3 {what}"))
        kh, kd, ph, pd = k[3], k[4], p[3], p[4]
        hk = fused.hdlc_fused(kq, codes, "group")
        hp = fused.hdlc_fused_reference(pq, codes, "group")
        err_h["group"] = max(err_h["group"], compare(
            hk, hp, f"deframer group {what}"))
        kq, pq = hk[0], hp[0]
        framed[0] += int(hk[1].valid.sum())
        st4, n_bits, n_framed = fir_b4_deframer(x, nv, st4, what)
        bits += n_bits
        framed[1] += n_framed
    check(framed == [frames, frames], f"deframer frames {framed}, B2 {frames}")
    # the exact backend's blocks (TorchReceiver's block_len 1020)
    st4 = (c.history, c.dpll, c.dpll, c.hdlc, c.hdlc)
    bits_x = framed_x = 0
    for b, off in enumerate(range(0, len(audio), CLI_BLOCK)):
        blk = audio[off:off + CLI_BLOCK]
        xb = np.zeros((1, CLI_BLOCK), dtype=np.int16)
        xb[0, :len(blk)] = blk
        st4, n_bits, n_framed = fir_b4_deframer(
            torch.from_numpy(xb).to(dev), len(blk), st4,
            f"exact backend's fixture block {b} (T {CLI_BLOCK}, n_valid "
            f"{len(blk)})")
        bits_x += n_bits
        framed_x += n_framed
    check((bits_x, framed_x) == (bits, frames),
          f"at T={CLI_BLOCK}: {bits_x} bits, {framed_x} frame candidates; at "
          f"T={KERNEL_BLOCK}: {bits}, {frames}")
    print(f"[3 parity fixture] B2, B1, B3, B4 and the deframer (on B3's and "
          f"on B4's codes) == plain, bitwise, on all "
          f"{len(n_valid)} chained blocks of the fixture at S=1 "
          f"T={KERNEL_BLOCK} (n_valid {n_valid[0]} x {len(n_valid) - 1}, "
          f"then {n_valid[-1]}): {frames} frames, {bits} bits; B4 and the "
          f"deframer on sample codes also at the exact backend's T="
          f"{CLI_BLOCK}, the same bits and frames", flush=True)
    return err2, err1, err3, err4, err_h


def phase_path_s(blocks, expected):
    """Path S: the pipelined streaming decoder through kernel B3 and the
    deframer kernel, at full width, over the first PATH_S_BLOCKS fleet
    blocks.  Returns its wall time a block."""
    from gnuais_tpu_torch.runtime.streaming import PipelinedDecoder
    dec = PipelinedDecoder(FLEET_STREAMS, block_len=FLEET_BLOCK,
                           frame_slots=FLEET_SLOTS, fused_frontend=True,
                           depth=2, device="cuda")
    n_run = PATH_S_BLOCKS
    t0 = time.perf_counter()
    results = dec.run(blocks[:n_run])
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
    print(f"[9 path S] PipelinedDecoder(fused_frontend, depth 2): "
          f"{n_run} chained blocks of {FLEET_STREAMS} x {FLEET_BLOCK}, every "
          f"payload equals the encoded ones, counters ({8 * n_run}, 0, 0) on "
          f"every stream; {wall:.1f} s in all, {wall / n_run * 1e3:.1f} ms "
          f"per block", flush=True)
    return wall / n_run


def hdlc_bound(codes, form, cand, state):
    """The deframer's bound (``card.bound_ms``): its bytes (the codes
    read, the carry read and written, the candidate slots written), and
    the integer operations this run's slots need: 10 a valid slot (the
    hunt state's step, as roofline.CHAIN_OPS counts it) and 45 for each
    bit a completed frame appended to the register (3 for each of 15
    words)."""
    import torch
    from gnuais_tpu_torch import card
    from gnuais_tpu_torch.ops import fused
    _, valid, _ = fused._hdlc_slots_of(form, codes, None, None, None, 0)
    new_state, c = cand
    nbytes = sum(t.numel() * t.element_size()
                 for t in leaves((codes, state, new_state, c)))
    appended = int((c.length[c.valid].to(torch.int64) + 22).sum())
    ops = 10 * int(valid.sum()) + 45 * appended
    return card.bound_ms(nbytes, (ops, card.INT32_TOPS))


def phase_front_full(x0):
    """B3 and the deframer on the first fleet block, B4 on its exact FIR,
    at full size, against their plain versions (the deframer on B3's
    group codes and on B4's sample codes); their times and bounds, and
    Path S's split of one block: B3, the deframer and the candidates'
    compaction, the host drain."""
    import torch
    from gnuais_tpu_torch.ops import demod, fir, fused
    from gnuais_tpu_torch.runtime.pipeline import BatchPipeline, init_carry
    x = torch.from_numpy(x0).cuda()
    c = init_carry(FLEET_STREAMS, "cuda")
    what = f"block 0 at S={FLEET_STREAMS} T={FLEET_BLOCK}"
    args3 = (x, FLEET_BLOCK, c.history, c.dpll)
    ms3, (codes, h3, d3) = device_ms(lambda: fused.frontend_codes(*args3))
    ms3w, k = device_ms(lambda: fused.frontend_fused(*args3, 0))
    plain3, p = host_ms(lambda: fused.frontend_fused_reference(*args3, 0))
    err3 = compare(k, p, f"B3 {what}")
    compare((*fused._group_slots(codes, 0), h3, d3), p,
            f"B3's codes {what}")
    filtered, _ = fir.fir_exact(x, c.history)
    ms4, (scodes, d4) = device_ms(lambda: fused.dpll_codes(
        filtered, FLEET_BLOCK, c.dpll))
    ms4w, k4 = device_ms(lambda: fused.dpll_fused(filtered, FLEET_BLOCK,
                                                  c.dpll))
    plain4, p4 = host_ms(lambda: fused.dpll_fused_reference(
        filtered, FLEET_BLOCK, c.dpll))
    err4 = compare(k4, p4, f"B4 {what}")
    print(f"[10 full block] {what}: B3 == plain on all {len(leaves(k))} "
          f"outputs ({int(k[1].sum())} bit slots), B4 == plain on all "
          f"{len(leaves(k4))} outputs ({int(k4[0].sum())} bits), bitwise",
          flush=True)
    n = FLEET_STREAMS * FLEET_BLOCK
    bound3, by3 = bound((args3, codes, h3, d3), FIR_FLOPS["vpu"] * n)
    bound4, by4 = bound((filtered, c.dpll, scodes, d4), n)  # a compare a sample
    print(f"[10 full block] B3 frontend_codes {ms3:.3f} ms (bound "
          f"{bound3:.3f} ms by {by3}; with the [S, T/4] returns of "
          f"frontend_fused {ms3w:.3f} ms), B4 dpll_codes {ms4:.3f} ms "
          f"(bound {bound4:.3f} ms by {by4}; dpll_fused {ms4w:.3f} ms) "
          f"(medians of 5, CUDA events); plain versions {plain3:.1f} ms and "
          f"{plain4:.1f} ms (one run each, host clock)", flush=True)
    # the wrappers on the card routes launch no copy of the block: every
    # device kernel of a call beside the hand-written one is short
    for name, fn, kernel in (
            ("B3 frontend_codes", lambda: fused.frontend_codes(*args3),
             "frontend_kernel"),
            ("B4 dpll_codes", lambda: fused.dpll_codes(
                filtered, FLEET_BLOCK, c.dpll), "dpll_kernel")):
        ms = device_kernels(fn)
        mine = {k: v for k, v in ms.items() if kernel in k}
        other = {k[:60]: round(v, 4) for k, v in ms.items() if kernel not in k}
        check(len(mine) == 1, f"{name}: kernels {sorted(ms)}")
        longest = max(other.values(), default=0.0)
        check(longest < COPY_MS,
              f"{name}: a kernel of {longest} ms beside {kernel}: {other}")
        print(f"[10 full block] {name} on the device (torch.profiler): "
              f"{kernel} {sum(mine.values()):.3f} ms; the {len(other)} other "
              f"kernels each < {COPY_MS} ms, no copy of the block: {other}",
              flush=True)
    # the deframer on both kinds of codes, against its plain version
    hdlc = {}
    for form, cd in (("group", codes), ("sample", scodes)):
        ms_h, kh = device_ms(lambda: fused.hdlc_fused(c.hdlc, cd, form))
        plain_h, ph = host_ms(lambda: fused.hdlc_fused_reference(
            c.hdlc, cd, form))
        err_h = compare(kh, ph, f"deframer {form} {what}")
        b_ms, b_by = hdlc_bound(cd, form, kh, c.hdlc)
        hdlc[form] = dict(max_abs_err=err_h, ms=ms_h, plain_ms=plain_h,
                          bound_ms=b_ms, bound_by=b_by, out=kh)
        print(f"[10 full block] deframer on {form} codes "
              f"[{cd.shape[0]}, {cd.shape[1]}]: == plain on all "
              f"{len(leaves(kh))} outputs ({int(kh[1].valid.sum())} "
              f"candidates), bitwise; {ms_h:.3f} ms (bound {b_ms:.4f} ms by "
              f"{b_by}; median of 5, CUDA events), plain {plain_h:.1f} ms "
              f"(one run, host clock)", flush=True)
    compare(hdlc["group"]["out"], hdlc["sample"]["out"],
            "deframer on B3's codes vs on B4's")

    def deframe():
        st, cand = fused.hdlc_fused(c.hdlc, codes, "group")
        return demod.compact_candidates(
            demod.init_frames(FLEET_STREAMS, FLEET_SLOTS, "cuda"), cand.valid,
            cand.words, cand.length, cand.start, cand.end, lost2=cand.lost2,
            over=cand.over)
    hdlc_ms, frames = host_ms(deframe)
    pipe = BatchPipeline(FLEET_STREAMS, block_len=FLEET_BLOCK,
                         frame_slots=FLEET_SLOTS, device="cuda")
    drain_ms, per_stream = host_ms(lambda: pipe.drain(frames))
    n = sum(len(lst) for lst in per_stream)
    total = ms3 + hdlc_ms + drain_ms
    print(f"[10 full block] path S split of {what}: B3 {ms3:.3f} ms, the "
          f"deframer kernel and compaction {hdlc_ms:.3f} ms, host drain "
          f"{drain_ms:.1f} ms ({n} frames); the drain is "
          f"{100 * drain_ms / total:.1f} % of the three", flush=True)
    del hdlc["group"]["out"], hdlc["sample"]["out"]
    return (dict(max_abs_err=err3, ms=ms3, plain_ms=plain3, bound_ms=bound3,
                 bound_by=by3),
            dict(max_abs_err=err4, ms=ms4, plain_ms=plain4, bound_ms=bound4,
                 bound_by=by4),
            hdlc["group"], hdlc["sample"])


def phase_superblock(blocks, main_result, block_s):
    """The pipelined decoder with kernel B2 over the three fleet blocks,
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
        print(f"[11 superblock] PipelinedDecoder(fused_pipeline, device_crc, "
              f"depth 2, {what}) over {len(blocks)} blocks of "
              f"[{FLEET_STREAMS}, {FLEET_BLOCK}]: frames and counters == "
              f"phase 4's; wall {walls[-1] * 1e3:.1f} ms (one run)",
              flush=True)
    print(f"[11 superblock] beside phase 4's median process() "
          f"{block_s * 1e3:.1f} ms per block, "
          f"{len(blocks) * block_s * 1e3:.1f} ms for {len(blocks)}",
          flush=True)
    return walls


def concat_frames(per_block, slots: int):
    """Per-block FrameBatches of one stream set, their frames laid one
    block after the other into ``slots`` dense slots per stream: the
    FrameBatch one call over the blocks would give."""
    import torch
    from gnuais_tpu_torch.ops import demod
    s = per_block[0].count.shape[0]
    out = demod.init_frames(s, slots, "cuda")
    off = torch.zeros((s,), dtype=torch.int64, device="cuda")
    rows = torch.arange(s, device="cuda")[:, None]
    for f in per_block:
        j = torch.arange(f.words.shape[1], device="cuda")[None, :]
        dst = off[:, None] + j
        m = (j < f.count[:, None]) & (dst < slots)
        r = rows.expand_as(dst)[m]
        d = dst[m]
        out.words[r, d] = f.words[m]
        for name in ("length", "start", "end"):
            getattr(out, name)[r, d] = getattr(f, name)[m]
        off += f.count
    return out._replace(
        count=off.clamp(max=slots).to(torch.int32),
        lost2=sum(f.lost2 for f in per_block),
        dropped=(sum(f.dropped for f in per_block)
                 + (off - slots).clamp(min=0).to(torch.int32)),
        crcfail=sum(f.crcfail for f in per_block))


def phase_flagship():
    """(d) The bench's bit-exact flagship configuration at full width:
    FLAGSHIP_COPIES copies of a fleet block of FLAGSHIP_PAYLOADS payloads
    per stream, tiled time-major by tile_superblock into one [12 T, S]
    int16 input, decoded by one decode_block(pretiled_streams=S,
    fused_pipeline, kernel_compact, assume_full, with_peak=False) call:
    kernel B1 over 589,824 samples per stream.  Its frames equal the
    row-major path's (12 blocks through decode_block with kernel_compact,
    chained), and every payload equals the encoded one, 12 times.
    Returns B1's launches in the pretiled call, its time and its
    frames."""
    import torch
    from gnuais_tpu_torch.ops import fused
    from gnuais_tpu_torch.runtime.pipeline import (decode_block,
                                                   extract_frames, init_carry)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 1)
    x, want = fleet_block(FLEET_BLOCKS, FLAGSHIP_PAYLOADS, g)
    total = FLAGSHIP_COPIES * FLEET_BLOCK
    torch.cuda.reset_peak_memory_stats()
    tiled = fused.tile_superblock(x.repeat(1, FLAGSHIP_COPIES), 1)[0]
    check(tuple(tiled.shape) == (total, FLEET_STREAMS), f"tiled {tiled.shape}")
    flags = dict(frame_slots=FLAGSHIP_SLOTS, fused_pipeline=True,
                 kernel_compact=True, assume_full=True, with_peak=False)
    carry0 = init_carry(FLEET_STREAMS, "cuda")
    fused.pipeline_fused_compact.launches = 0
    wall, (carry, frames, _) = host_ms(lambda: decode_block(
        tiled, total, carry0, pretiled_streams=FLEET_STREAMS, **flags))
    launches = fused.pipeline_fused_compact.launches
    check(launches == 1, f"pretiled decode launched B1 {launches} times")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del tiled
    # the row-major path: the same block 12 times, chained
    c, per_block = carry0, []
    for k in range(FLAGSHIP_COPIES):
        c, f, _ = decode_block(x, FLEET_BLOCK, c, block_base=k * FLEET_BLOCK,
                               **flags)
        per_block.append(f)
    compare(tuple(frames), tuple(concat_frames(per_block, FLAGSHIP_SLOTS)),
            "pretiled frames vs the row-major blocks'")
    compare(tuple(carry), tuple(c), "pretiled carry vs the row-major blocks'")
    n = FLAGSHIP_COPIES * FLAGSHIP_PAYLOADS
    check(bool((frames.count == n).all()), "pretiled frame counts")
    per_stream = extract_frames(frames)
    check(all(f.crc_ok for lst in per_stream for f in lst), "CRC rejects")
    n_frames = check_payloads(per_stream, [w * FLAGSHIP_COPIES for w in want],
                              "flagship")
    print(f"[7 flagship] decode_block(pretiled_streams={FLEET_STREAMS}, "
          f"kernel_compact, assume_full, frame_slots={FLAGSHIP_SLOTS}) on one "
          f"[{total}, {FLEET_STREAMS}] int16 input: 1 launch of B1, "
          f"{wall:.1f} ms (host clock, synchronised), peak device memory "
          f"{peak_gb:.1f} GB; frames and carry == the row-major path's 12 "
          f"chained blocks, bitwise; all {n_frames} payloads equal the "
          f"encoded ones ({n} per stream)", flush=True)
    return launches, wall, frames


def phase_fir_paths(blocks, expected, fir_mode: str, label: str):
    """The lobe or mxu FIR on the fleet: BatchPipeline(fused_pipeline,
    device_crc, lobe_fir or mxu_fir) over the three fleet blocks, once
    with kernel B2 and once with kernel_compact (B1); every payload equal
    to the encoded ones (both modes are held to packet parity) and the
    counters clean.  Returns each kernel's launches on its path (the
    counts are not reset here)."""
    from gnuais_tpu_torch.ops import fused
    from gnuais_tpu_torch.runtime.pipeline import BatchPipeline
    launches = {}
    for name, wrapper, compact in (("B2", fused.pipeline_fused, False),
                                   ("B1", fused.pipeline_fused_compact, True)):
        before = wrapper.launches
        pipe = BatchPipeline(FLEET_STREAMS, block_len=FLEET_BLOCK,
                             frame_slots=FLEET_SLOTS, fused_pipeline=True,
                             device_crc=True, kernel_compact=compact,
                             device="cuda", **{f"{fir_mode}_fir": True})
        t0 = time.perf_counter()
        n = sum(check_payloads(pipe.process(x), want,
                               f"{name} {fir_mode} block {b}")
                for b, (x, want) in enumerate(zip(blocks, expected)))
        wall = time.perf_counter() - t0
        launches[name] = wrapper.launches - before
        check(launches[name] == len(blocks),
              f"{name} {fir_mode} launched {launches[name]} times")
        for i, c in enumerate(pipe.counters):
            check((c.lostframes, c.lostframes2) == (0, 0),
                  f"{name} {fir_mode} stream {i} counters {c}")
        print(f"[{label}] BatchPipeline(fused_pipeline, device_crc, "
              f"{fir_mode}_fir, kernel_compact={compact}): {len(blocks)} "
              f"blocks, {n} frames, all payloads equal the encoded ones, "
              f"counters clean; kernel {name} {fir_mode} launches "
              f"{launches[name]}; {wall:.1f} s", flush=True)
    return launches


def mxu_against(k1, v1, strict, what: str) -> int:
    """B1's mxu outputs ``k1`` against another B1 run ``v1`` (the exact
    FIR's, or the mxu FIR's on other tiles): on the rows ``strict``
    (encoder captures) every frame leaf (count_raw, words, length,
    start, end) and the carry (history, DPLL, deframer) equal; on the
    other rows (noise alone) the CRC-passing frames equal.  Returns how
    many of the other rows' carries differ, for the caller to print."""
    import torch
    from gnuais_tpu_torch.ops import crc
    def row_differs(a, b):
        d = a != b
        return d.flatten(1).any(dim=1) if d.dim() > 1 else d

    rows = torch.nonzero(strict).flatten()
    for i, (a, b) in enumerate(zip(leaves(k1[:5]) + leaves(k1[7:]),
                                   leaves(v1[:5]) + leaves(v1[7:]))):
        bad = row_differs(a[rows], b[rows])
        check(not bool(bad.any()),
              f"{what}: leaf {i} differs on {int(bad.sum())} capture rows, "
              f"the first {rows[bad][:5].tolist()}")
    other = torch.nonzero(~strict).flatten()
    if not len(other):
        return 0
    f = k1[1].shape[1]

    def passing(o):
        n = o[0][other].clamp(max=f)
        present = torch.arange(f, device=n.device)[None, :] < n[:, None]
        ok = crc.crc_check_frames_linear(
            o[1][other].reshape(-1, o[1].shape[-1]),
            o[2][other].reshape(-1)).reshape(len(other), f)
        keep = present & ok
        return [o[j][other][keep] for j in range(1, 5)]

    for x, y in zip(passing(k1), passing(v1)):
        check(torch.equal(x, y), f"{what}: CRC-passing frames differ on the "
                                 f"rows of noise")
    differ = torch.zeros(len(other), dtype=torch.bool, device=other.device)
    for a, b in zip(leaves(k1[7:]), leaves(v1[7:])):
        differ |= row_differs(a[other], b[other])
    return int(differ.sum())


def noise_rows(maker: str, s: int):
    """Which rows of a capture are noise alone: every row of
    ``garbage``, every fourth (from row 1) of ``mixed``."""
    import torch
    r = torch.arange(s, device="cuda")
    if maker == "garbage":
        return torch.ones(s, dtype=torch.bool, device="cuda")
    if maker == "mixed":
        return r % 4 == 1
    return torch.zeros(s, dtype=torch.bool, device="cuda")


def phase_parity_mxu():
    """B2 and B1 with the mxu FIR against their plain versions on the
    card at small shapes (S = 1, 37, 256; T = 4096 and 1000; n_valid
    T-333 and 20; frame_slots 3; three chained blocks), every output
    and carry leaf; and B1 mxu against B1 with the exact FIR
    (``mxu_against``).  Returns the max abs error of each against its
    plain version."""
    import torch
    from gnuais_tpu_torch import captures
    from gnuais_tpu_torch.ops import fused
    from gnuais_tpu_torch.runtime.pipeline import PipelineCarry, init_carry
    t = 4096
    cases = [
        ("S=1 frames", "frames", captures.noisy_frames(1, t, seed=1), t, 8, 0),
        ("S=37 mixed n_valid=T-333", "mixed", captures.mixed(37, t, seed=2),
         t - 333, 8, 77),
        ("S=37 mixed n_valid=20", "mixed", captures.mixed(37, t, seed=3), 20,
         8, 0),
        ("S=256 minimal frames, 3 slots", "frames",
         captures.minimal_frames(256, t, seed=5), t, 3, 0),
        ("S=37 garbage", "garbage", captures.garbage(37, t, seed=6), t, 8, 0),
        ("S=256 wrong-size and CRC rejects", "frames",
         captures.wrong_size_and_crc(256, t, seed=7), t, 24, 0),
        ("S=37 mixed T=1000", "mixed", captures.mixed(37, 1000, seed=9), 1000,
         8, 5),
    ]
    err2 = err1 = 0.0
    noisy_differ = 0
    for name, maker, xn, nv, fs, base in cases:
        x = torch.from_numpy(xn).cuda()
        c = init_carry(x.shape[0], "cuda")
        k2, p2, k1, p1 = run_both(x, nv, c, fs, base, fir_mode="mxu")
        err2 = max(err2, compare(k2, p2, f"B2 mxu {name}"))
        err1 = max(err1, compare(k1, p1, f"B1 mxu {name}"))
        v1 = fused.pipeline_fused_compact(x, nv, c.history, c.dpll, c.hdlc,
                                          frame_slots=fs, block_base=base)
        strict = ~noise_rows(maker, x.shape[0])
        noisy_differ += mxu_against(k1, v1, strict, f"B1 mxu vs vpu {name}")
        print(f"[3 parity mxu] {name}: B2 mxu and B1 mxu bitwise equal to "
              f"plain, frames {int(k1[0].sum())} == the exact FIR's on "
              f"{int(strict.sum())} capture rows", flush=True)
    x = captures.mixed(37, 3 * t, seed=8)
    strict = ~noise_rows("mixed", 37)
    ck = cp = cv = init_carry(37, "cuda")
    for b in range(3):
        nv = t if b < 2 else t - 333
        xb = torch.from_numpy(np.ascontiguousarray(x[:, b * t:(b + 1) * t])).cuda()
        k2, p2, k1, p1 = run_both(xb, nv, ck, 3, base=b * t, plain_carry=cp,
                                  fir_mode="mxu")
        err2 = max(err2, compare(k2, p2, f"B2 mxu chained block {b}"))
        err1 = max(err1, compare(k1, p1, f"B1 mxu chained block {b}"))
        v1 = fused.pipeline_fused_compact(xb, nv, cv.history, cv.dpll,
                                          cv.hdlc, frame_slots=3,
                                          block_base=b * t)
        noisy_differ += mxu_against(k1, v1, strict,
                                    f"B1 mxu vs vpu chained block {b}")
        ck, cp, cv = (PipelineCarry(*k2[7:]), PipelineCarry(*p2[7:]),
                      PipelineCarry(*v1[7:]))
        print(f"[3 parity mxu] chained block {b}, 3 slots: B2 mxu and B1 mxu "
              f"bitwise equal to plain, frames {int(k1[0].sum())}",
              flush=True)
    print(f"[3 parity mxu] rows of noise alone whose carry differs between "
          f"the mxu and the exact FIR: {noisy_differ}", flush=True)
    return err2, err1


def phase_probe(x0):
    """The mxu FIR alone (``fir_mxu_probe``) on the first fleet block at
    full size, from a history of noise: within MXU_BOUND of the exact
    FIR and twice that of the plain ``fir.fir_mxu``; its time, the plain
    product's and the bound."""
    import torch
    from gnuais_tpu_torch import captures
    from gnuais_tpu_torch.ops import fir, fused
    x = torch.from_numpy(x0).cuda()
    h = torch.from_numpy(captures.garbage(FLEET_STREAMS, 36, seed=62)
                         .astype(np.float32)).cuda()
    ms, k = device_ms(lambda: fused.fir_mxu_probe(x, h))
    plain_ms, (p, _) = device_ms(lambda: fir.fir_mxu(x, h))
    e, _ = fir.fir_exact(x, h)
    # the taps are all >= 0, so sum_i |taps[i] x[i]| is the FIR of |x|
    mag, _ = fir.fir_exact(x.to(torch.float32).abs(), h.abs())
    lim = fused.MXU_BOUND[0] * mag + fused.MXU_BOUND[1]
    d_exact, d_plain = (k - e).abs(), (k - p).abs()
    ratio = float((d_exact / lim).max())
    check(ratio <= 1.0, f"probe exceeds the mxu bound against fir_exact: "
                        f"{ratio} of it")
    check(bool((d_plain <= 2 * lim).all()), "probe far from fir_mxu")
    n = FLEET_STREAMS * FLEET_BLOCK
    b_ms, b_by = bound((x, h, k), FIR_FLOPS["mxu"] * n, tensor_cores=True)
    print(f"[13 probe] fir_mxu_probe at S={FLEET_STREAMS} T={FLEET_BLOCK}: "
          f"max |probe - fir_exact| {float(d_exact.max())} (at most "
          f"{ratio:.4f} of MXU_BOUND), max |probe - fir_mxu| "
          f"{float(d_plain.max())}, max |fir_mxu - fir_exact| "
          f"{float((p - e).abs().max())}, values up to "
          f"{float(e.abs().max()):.1f}; probe {ms:.3f} ms (bound {b_ms:.3f} "
          f"ms by {b_by}), plain fir_mxu {plain_ms:.3f} ms (medians of 5, "
          f"CUDA events)", flush=True)
    return float(d_exact.max())


def phase_full_mxu(x0, carry0, vpu_b1):
    """B2 and B1 with the mxu FIR on the first fleet block at full size
    (``phase_full_block``: against their plain versions, row-major and
    pretiled), and B1 mxu's frames and carry against B1 with the exact
    FIR's (every row is an encoder capture)."""
    out = phase_full_block(x0, carry0, None, "mxu")
    import torch
    strict = torch.ones(FLEET_STREAMS, dtype=torch.bool, device="cuda")
    mxu_against(out["B1"]["out"], vpu_b1, strict,
                "full block, B1 mxu vs B1 exact")
    print(f"[6 full block mxu] B1 mxu's frames and carry == B1 exact's on "
          f"all {FLEET_STREAMS} streams", flush=True)
    return out


def plain_path_m(tiled: np.ndarray, total: int):
    """Run in a child process: the plain version of Path M's CONFIGS[0]
    step on the CPU, one pretiled decode_block(kernel_compact, mxu_fir)
    over ``tiled`` ([total, n] int16, some of Path M's streams) from the
    initial carry.  Returns (its carry and frames as a list of arrays,
    seconds)."""
    import torch
    torch.set_num_threads(1)
    from gnuais_tpu_torch.runtime.pipeline import decode_block, init_carry
    t0 = time.perf_counter()
    n = tiled.shape[1]
    carry, frames, _ = decode_block(
        torch.from_numpy(tiled), total, init_carry(n, "cpu"),
        pretiled_streams=n, frame_slots=FLAGSHIP_SLOTS, fused_pipeline=True,
        kernel_compact=True, mxu_fir=True, assume_full=True, with_peak=False)
    return ([t.numpy() for t in leaves((carry, frames))],
            time.perf_counter() - t0)


def phase_path_m(flagship_frames):
    """Path M, the JAX bench's headline configurations with the mxu FIR
    (bench.py CONFIGS[0..2]) at full width, on phase 7's input (12
    copies of a 4-payload fleet block, [589,824 x 4096] int16).
    CONFIGS[0]: one pretiled decode_block with kernel_compact (one
    launch of B1); CONFIGS[1]: the same with B2 and compaction (one
    launch of B2); CONFIGS[2]: the row-major superblock through
    decode_superblock (12 launches of B2).  The three give the same
    frames as phase 7's exact FIR (``flagship_frames``), every payload
    equals the encoded one and none is a CRC reject.  The first
    PATH_M_CHECKED streams of CONFIGS[0] and [1], all 589,824 samples,
    go to their plain version in a child process on the CPU, which runs
    while the later phases do.  Returns ({config: host ms}, a function
    that waits for the child and holds both configs' frames and carry on
    those streams to it, bitwise, returning {kernel: max abs error})."""
    import multiprocessing
    import torch
    from gnuais_tpu_torch.ops import fused
    from gnuais_tpu_torch.runtime.pipeline import (decode_block,
                                                   decode_superblock,
                                                   extract_frames, init_carry)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 1)
    x, want = fleet_block(FLEET_BLOCKS, FLAGSHIP_PAYLOADS, g)   # phase 7's
    total = FLAGSHIP_COPIES * FLEET_BLOCK
    n = FLAGSHIP_COPIES * FLAGSHIP_PAYLOADS
    flags = dict(frame_slots=FLAGSHIP_SLOTS, fused_pipeline=True,
                 mxu_fir=True, with_peak=False)
    carry0 = init_carry(FLEET_STREAMS, "cuda")
    x12 = x.repeat(1, FLAGSHIP_COPIES)
    tiled = fused.tile_superblock(x12, 1)[0]
    head = tiled[:, :PATH_M_CHECKED].contiguous().cpu().numpy()
    walls, frames, checked = {}, {}, {}
    for cfg, compact in (("CONFIGS[0]", True), ("CONFIGS[1]", False)):
        wrapper = (fused.pipeline_fused_compact if compact
                   else fused.pipeline_fused)
        before = wrapper.launches
        walls[cfg], (carry, f, _) = host_ms(lambda: decode_block(
            tiled, total, carry0, pretiled_streams=FLEET_STREAMS,
            kernel_compact=compact, assume_full=True, **flags))
        check(wrapper.launches == before + 1, f"{cfg} launched "
              f"{wrapper.launches - before} kernels")
        frames[cfg] = f
        checked[cfg] = tuple(t[:PATH_M_CHECKED].cpu()
                             for t in leaves((carry, f)))
    del tiled
    compare(tuple(frames["CONFIGS[0]"]), tuple(frames["CONFIGS[1]"]),
            "CONFIGS[0] frames vs CONFIGS[1]'s")
    before = fused.pipeline_fused.launches
    walls["CONFIGS[2]"], (c2, f2, _) = host_ms(lambda: decode_superblock(
        x12, total, carry0, FLAGSHIP_COPIES, **flags))
    check(fused.pipeline_fused.launches == before + FLAGSHIP_COPIES,
          "CONFIGS[2] launches")
    del x12
    per_block = [type(frames["CONFIGS[0]"])(*(leaf[k] for leaf in f2))
                 for k in range(FLAGSHIP_COPIES)]
    compare(tuple(frames["CONFIGS[0]"]),
            tuple(concat_frames(per_block, FLAGSHIP_SLOTS)),
            "CONFIGS[0] frames vs CONFIGS[2]'s 12 blocks")
    compare(tuple(carry), tuple(c2), "pretiled carry vs the superblock's")
    f0 = frames["CONFIGS[0]"]
    compare(tuple(f0), tuple(flagship_frames),
            "CONFIGS[0] frames vs phase 7's exact FIR")
    check(bool((f0.count == n).all()), "Path M frame counts")
    per_stream = extract_frames(f0)
    check(all(fr.crc_ok for lst in per_stream for fr in lst), "CRC rejects")
    n_frames = check_payloads(per_stream, [w * FLAGSHIP_COPIES for w in want],
                              "path M")
    print(f"[7m path M] mxu_fir at [{total}, {FLEET_STREAMS}]: CONFIGS[0] "
          f"(pretiled, kernel_compact, 1 launch of B1 mxu) "
          f"{walls['CONFIGS[0]']:.1f} ms, CONFIGS[1] (pretiled, 1 launch of "
          f"B2 mxu and compaction) {walls['CONFIGS[1]']:.1f} ms, CONFIGS[2] "
          f"(row-major decode_superblock, 12 launches of B2 mxu) "
          f"{walls['CONFIGS[2]']:.1f} ms (host clock, synchronised); the "
          f"three give the same frames bitwise, and the same as phase 7's "
          f"exact FIR; all {n_frames} payloads "
          f"equal the encoded ones ({n} per stream), no CRC reject",
          flush=True)
    # started after the timed calls, so that sending it the input does
    # not hold the host clock of CONFIGS[0..2]
    pool = multiprocessing.get_context("spawn").Pool(1)
    pending = pool.apply_async(plain_path_m, (head, total))

    def against_plain():
        try:
            arrays, secs = pending.get(timeout=1000)
        finally:
            pool.terminate()
            pool.join()
        plain = tuple(torch.from_numpy(a) for a in arrays)
        err = {kernel: compare(checked[cfg], plain,
                               f"{cfg} streams 0..{PATH_M_CHECKED - 1} vs "
                               f"the plain version")
               for kernel, cfg in (("B1", "CONFIGS[0]"), ("B2", "CONFIGS[1]"))}
        print(f"[7m path M] CONFIGS[0] (B1 mxu) and CONFIGS[1] (B2 mxu) on "
              f"streams 0..{PATH_M_CHECKED - 1}, all {total} samples: frames "
              f"and carry ({len(plain)} leaves) == the plain version's "
              f"(run on the CPU in {secs:.1f} s), bitwise", flush=True)
        return err

    return walls, against_plain


def phase_path_r(b1_ms):
    """Path R, the roofline tool (``gnuais_tpu_torch.roofline``): R1 and
    R2 in every mode against their plain versions at S = 64 (plain on
    the CPU), bitwise; R1 dpll+hdlc+shift and R2
    stream+fir+dpll+hdlc+shift at S = 4096 against their plain versions
    on the card, timed; then the tool's table at 4096 and 16,384
    streams, beside B1's ns a sample from phase 6.  Returns ({kernel:
    dict of the kernels line}, launches of R1 and R2 in the table)."""
    import torch
    from gnuais_tpu_torch import captures
    from gnuais_tpu_torch import roofline as R
    rng = np.random.default_rng(SEED)

    def seeds(s):
        return torch.from_numpy(rng.integers(1, 2**31 - 1, s, dtype=np.int32))

    def same(a, b, what):
        fa = [t for t in leaves(a) if t is not None]
        fb = [t for t in leaves(b) if t is not None]
        compare(tuple(t.cpu() for t in fa), tuple(t.cpu() for t in fb), what)

    sd = seeds(64)
    for mode in R.CHAIN_MODES:
        same(R.chain(sd.cuda(), 4096, mode), R.chain(sd, 4096, mode),
             f"R1 {mode} S=64")
    xs = torch.from_numpy(captures.mixed(64, 4096, seed=63).T.copy())
    dummy = torch.arange(R.N_DUMMY * 64, dtype=torch.int32).reshape(-1, 64)
    for mode in R.STREAM_MODES:
        same(R.stream(xs.cuda(), mode, 2, dummy.cuda()),
             R.stream(xs, mode, 2, dummy), f"R2 {mode} S=64")
    print(f"[14 path R] S=64: R1 in {len(R.CHAIN_MODES)} modes (4096 steps) "
          f"and R2 in {len(R.STREAM_MODES)} modes (4096 steps, 2 passes, on "
          f"frames, minimal frames, rejects and noise) bitwise equal to their "
          f"plain versions", flush=True)
    line = {}
    s, steps = FLEET_STREAMS, 4096
    sd = seeds(s).cuda()
    m1 = "dpll+hdlc+shift"
    ms, k = device_ms(lambda: R.chain(sd, steps, m1))
    plain_ms, p = host_ms(lambda: R.chain_reference(sd, steps, m1))
    same(k, p, f"R1 {m1} S={s}")
    b_ms, b_by = R.bound_ms(m1, s, steps)
    line["R1"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by)
    m2 = "stream+fir+dpll+hdlc+shift"
    xr = R.build_input(sd, steps)
    ms, k = device_ms(lambda: R.stream(xr, m2, 2))
    plain_ms, p = host_ms(lambda: R.stream_reference(xr, m2, 2))
    same(k, p, f"R2 {m2} S={s}")
    b_ms, b_by = R.bound_ms(m2, s, steps, 2)
    line["R2"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by)
    print(f"[14 path R] S={s}, {steps} steps: R1 {m1} {line['R1']['ms']:.3f} "
          f"ms (plain {line['R1']['plain_ms']:.1f} ms), R2 {m2} x 2 passes "
          f"{line['R2']['ms']:.3f} ms (plain {line['R2']['plain_ms']:.1f} ms), "
          f"bitwise equal", flush=True)
    R.chain.launches = R.stream.launches = 0
    for streams in (FLEET_STREAMS, 4 * FLEET_STREAMS):
        rows = R.table(streams, ROOFLINE_STEPS, ROOFLINE_ITERS)
        print(f"[14 path R] roofline table at {streams} streams "
              f"(python -m gnuais_tpu_torch.roofline; median of "
              f"{ROOFLINE_ITERS}, launch floor {rows[0]['floor_ms']:.4f} ms):",
              flush=True)
        for r in rows:
            print(R.format_row(r), flush=True)
    launches = {"R1": R.chain.launches, "R2": R.stream.launches}
    check(min(launches.values()) > 0, f"roofline launches {launches}")
    print(f"[14 path R] beside them B1 (phase 6, S={FLEET_STREAMS}, "
          f"T={FLEET_BLOCK}): "
          + ", ".join(f"{m} {ms * 1e6 / FLEET_BLOCK:.1f} ns a sample a stream"
                      for m, ms in b1_ms.items()), flush=True)
    return line, launches


STATION_BACKENDS = {"fused": ("B2",), "exact": ("B4", "deframer")}
STATION_KERNELS = {"B2": "pipeline_kernel", "B4": "dpll_kernel",
                   "deframer": "hdlc_kernel"}
STATION_PAYLOADS = 6      # the second channel's payloads in phase 15
STATION_LOOPS = 16        # the fixture repeated: 24.8 s of audio a timed run
STATION_RUNS = 3          # timed runs a backend


def station_wrappers():
    """Each kernel of the station path and the wrapper that counts its
    launches."""
    from gnuais_tpu_torch.ops import fused
    return {"B2": fused.pipeline_fused, "B4": fused.dpll_fused,
            "deframer": fused.hdlc_fused}


def short_path(path: Path) -> str:
    """``path`` absolute or relative to the working directory, whichever
    is shorter (a Unix socket's path has room for 107 bytes)."""
    import os
    return min(str(path), os.path.relpath(path), key=len)


@contextlib.contextmanager
def own_socket(path: str):
    """A context in which the port's CLI opens its NMEA socket server at
    ``path`` rather than at its default, ``/tmp/gnuais.socket``: a fixed
    path outside the checkout that any other process on the machine may
    bind.  Yields the CLI module."""
    import functools
    from gnuais_tpu_torch import cli
    from gnuais_tpu_torch.io import sinks
    real = cli.NmeaSocketServer
    cli.NmeaSocketServer = functools.partial(sinks.NmeaSocketServer, path)
    try:
        yield cli
    finally:
        cli.NmeaSocketServer = real


def uplink_recorder():
    """The tests' local JSON-AIS uplink (tests/uplink_recorder.py): an
    HTTP server on 127.0.0.1 that keeps the JSON of every POST."""
    sys.path.insert(0, str(REPO / "tests"))
    try:
        import uplink_recorder
    finally:
        sys.path.remove(str(REPO / "tests"))
    return uplink_recorder


class StationRun:
    """One ``cli.main`` call of ``station_cli``: its exit code, stdout,
    log text and the NMEA socket's bytes; ``t0`` and ``t1`` (host clock)
    bracket the call, ``blocks`` holds (start, end) of each
    ``DecodeSession.process_block`` call within it."""

    def __init__(self, rc, out, log, nmea, t0, t1, blocks):
        self.rc, self.out, self.log, self.nmea = rc, out, log, nmea
        self.t0, self.t1, self.blocks = t0, t1, blocks
        self.wall = t1 - t0


def station_cli(argv, sock, data=None, fifo=None, pace=False,
                collect=False):
    """``gnuais-tpu-torch argv`` in this process (its launches counted),
    its stdout captured, its NMEA socket at ``sock``; with ``data``, a
    writer thread feeds the bytes into the FIFO ``fifo`` (at the rate of
    real time with ``pace``); with ``collect``, a client connected before
    the call collects the socket's sentences.  Returns a StationRun."""
    import contextlib
    import fcntl
    import io
    import logging
    import os
    import socket
    import threading
    from gnuais_tpu_torch.io import sinks
    from gnuais_tpu_torch.runtime.session import DecodeSession
    threads, nmea, blocks = [], bytearray(), []
    if data is not None:
        os.mkfifo(fifo)

        def write():
            # 0.1 s of mono audio a write; with pace, 0.1 s between writes
            # into a one-page pipe, so that the reader gets the audio at
            # the rate of real time from its first read on
            step = 2 * 4800
            with open(fifo, "wb") as f:
                if pace:
                    fcntl.fcntl(f, fcntl.F_SETPIPE_SZ, 4096)
                for o in range(0, len(data), step):
                    f.write(data[o:o + step])
                    f.flush()
                    if pace:
                        time.sleep(0.1)
        threads.append(threading.Thread(target=write))
    with own_socket(sock) as cli:
        if collect:
            srv = sinks.NmeaSocketServer(sock)
            client = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            client.connect(sock)
            deadline = time.time() + 30
            while not srv._clients and time.time() < deadline:
                time.sleep(0.01)
            check(bool(srv._clients), "the NMEA socket took no client")

            def read():
                while chunk := client.recv(65536):
                    nmea.extend(chunk)
                client.close()
            threads.append(threading.Thread(target=read))
            cli.NmeaSocketServer = lambda: srv
        out, summary = io.StringIO(), io.StringIO()
        handler = logging.StreamHandler(summary)
        log = logging.getLogger("gnuais")
        log.setLevel(logging.INFO)
        log.addHandler(handler)
        process_block = DecodeSession.process_block

        def timed_block(self, *args):
            t = time.perf_counter()
            res = process_block(self, *args)
            blocks.append((t, time.perf_counter()))
            return res
        DecodeSession.process_block = timed_block
        for t in threads:
            t.start()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv)
            t1 = time.perf_counter()
        finally:
            DecodeSession.process_block = process_block
            log.removeHandler(handler)
            for t in threads:
                t.join(timeout=60)
    return StationRun(rc, out.getvalue(), summary.getvalue(), bytes(nmea),
                      t0, t1, blocks)


def golden_stdout(interleaved, channels):
    """The port's golden model's stdout lines and NMEA sentences on a
    capture, and the JSON-AIS blob of its events (host only)."""
    from gnuais_tpu_torch.golden.model import GoldenReceiver
    from gnuais_tpu_torch.io.cache import VesselCache, export_json
    from gnuais_tpu_torch.runtime.session import DecodeSession
    res = DecodeSession(lambda n: GoldenReceiver(n),
                        sound_channels=channels).run(interleaved)
    cache = VesselCache()
    for m in res.messages:
        for ev in m.events:
            cache.apply_event(ev, 0)
    return res.stdout_lines, res.counters, export_json(cache.rotate(), "CHIP")[0]


def no_seqnr(text: str) -> str:
    """Message lines with each multipart sentence's sequence id and
    checksum masked: they go on counting where a capture repeats."""
    import re
    return re.sub(r"(!AIVDM,\d,\d,)\d(,[^*]*\*)[0-9A-F]{2}", r"\1S\2CS", text)


def station_counters(n: int) -> str:
    return (f"A: Received correctly: {n} packets, wrong CRC: 0 packets, "
            "wrong size: 0 packets")


def phase_station(tmp: Path):
    """Phase 15: the station path through the port's command line on the
    card, the fixture fed live through a FIFO, with every sink on, for
    each backend; the station's time over the fixture looped; then the
    checkpoint seam and two channels.  Returns ({kernel: launches},
    {backend: the station's times})."""
    import re
    import sqlite3
    from gnuais_tpu_torch import constants as C
    from gnuais_tpu_torch.golden import encoder as E
    recorder = uplink_recorder()
    fix = REPO / "tests" / "fixtures"
    raw = (fix / "standard_capture.raw").read_bytes()
    want = (fix / "standard_capture.stdout").read_text()
    want_nmea = (fix / "standard_capture.nmea").read_text().splitlines()
    audio = np.frombuffer(raw, dtype="<i2")
    _, _, want_blob = golden_stdout(audio, C.SOUND_CHANNELS_MONO)
    counters = station_counters(49)
    wrappers = station_wrappers()
    launches = {k: 0 for k in wrappers}
    times = {}

    def counted(kernels, fn):
        for k in kernels:
            wrappers[k].launches = 0
        res = fn()
        for k in kernels:
            check(wrappers[k].launches > 0, f"kernel {k} was not launched")
            launches[k] += wrappers[k].launches
        return res

    def sinks_conf(d, backend, uplink, tag):
        return (f"soundchannels mono\nbackend {backend}\n"
                f"dbpath {d / f'{tag}.sqlite'}\n"
                f"uplink chip json {uplink.url}\nmycall CHIP\n"
                f"soundoutfile {d / f'{tag}.tee'}\n")

    for backend, kernels in STATION_BACKENDS.items():
        d = tmp / backend
        d.mkdir()
        sock = short_path(d / "nmea.sock")
        uplink = recorder.UplinkRecorder()
        conf = d / "station.conf"
        conf.write_text(sinks_conf(d, backend, uplink, "ais"))
        try:
            run = counted(kernels, lambda: station_cli(
                ["-c", str(conf), "-l", str(d / "in.fifo")], sock, raw,
                d / "in.fifo", collect=True))
        finally:
            uplink.close()
        check(run.rc == 0 and run.out == want,
              f"{backend}: station stdout differs")
        check(counters in run.log, f"{backend}: counters: {run.log!r}")
        check(run.nmea == "".join(want_nmea).encode(),
              f"{backend}: the socket's sentences differ")
        check((d / "ais.tee").read_bytes() == raw, f"{backend}: tee differs")
        conn = sqlite3.connect(str(d / "ais.sqlite"))
        rows = [r[0] for r in conn.execute(
            "SELECT message FROM ais_nmea ORDER BY id")]
        conn.close()
        check(rows == want_nmea, f"{backend}: ais_nmea rows differ")
        check(len(uplink.posts) == 1 and recorder.masked(uplink.posts[0])
              == recorder.masked(want_blob),
              f"{backend}: the uplink's JSON differs")
        mmsis = {int(m) for m in re.findall(r'"mmsi": (\d+)', uplink.posts[0])}
        check(bool(mmsis) and mmsis <= {int(m) for m in re.findall(
            r"mmsi (\d+)", want)},
              f"{backend}: the uplink's MMSIs {sorted(mmsis)[:5]}")
        print(f"[15 station] {backend} ({', '.join(kernels)}), fed live "
              f"through a FIFO: stdout byte for byte, counters (49, 0, 0); "
              f"the NMEA socket's {len(want_nmea)} sentences, {len(rows)} "
              f"ais_nmea rows, the tee's {len(raw)} bytes and the uplink's "
              f"JSON ({len(mmsis)} MMSIs) equal the reference; the whole "
              f"call {run.wall * 1e3:.1f} ms for {len(audio) / 48000.0:.3f} "
              f"s of audio", flush=True)

        # the station's time: the fixture looped to tens of seconds, fed
        # as fast as the CLI reads it, every sink on; the set-up (from
        # the call to its first block), the loop over the blocks and the
        # close (from the last block to the return) apart
        looped = raw * STATION_LOOPS
        seconds = len(looped) / 2 / 48000.0
        times[backend] = []
        for r in range(STATION_RUNS):
            uplink = recorder.UplinkRecorder()
            conf.write_text(sinks_conf(d, backend, uplink, f"t{r}"))
            fifo = d / f"t{r}.fifo"
            try:
                run = counted(kernels, lambda: station_cli(
                    ["-c", str(conf), "-l", str(fifo)], sock, looped, fifo,
                    collect=True))
            finally:
                uplink.close()
            check(run.rc == 0 and no_seqnr(run.out)
                  == no_seqnr(want) * STATION_LOOPS,
                  f"{backend}: the looped stdout differs")
            check(station_counters(49 * STATION_LOOPS) in run.log,
                  f"{backend}: looped counters: {run.log[-300:]!r}")
            check(len(run.nmea) == len("".join(want_nmea)) * STATION_LOOPS,
                  f"{backend}: the looped socket's bytes")
            check((d / f"t{r}.tee").read_bytes() == looped,
                  f"{backend}: the looped tee differs")
            per = [(e - s) * 1e3 for s, e in run.blocks]
            q = statistics.quantiles(per, n=10)
            loop_s = run.blocks[-1][1] - run.blocks[0][0]
            t = dict(setup_ms=(run.blocks[0][0] - run.t0) * 1e3,
                     loop_s=loop_s,
                     close_ms=(run.t1 - run.blocks[-1][1]) * 1e3,
                     n=len(per), block_ms=statistics.median(per),
                     p10_ms=q[0], p90_ms=q[-1], max_ms=max(per),
                     gap_ms=(loop_s * 1e3 - sum(per)) / len(per),
                     rtf=seconds / loop_s, rtf_call=seconds / run.wall)
            times[backend].append(t)
            print(f"[15 station] {backend} timed run {r + 1} of "
                  f"{STATION_RUNS}: the fixture x {STATION_LOOPS} "
                  f"({seconds:.3f} s of audio, stdout, counters "
                  f"({49 * STATION_LOOPS}, 0, 0), socket and tee checked), "
                  f"every sink on: set-up {t['setup_ms']:.1f} ms; "
                  f"{t['n']} blocks in {loop_s * 1e3:.1f} ms = "
                  f"{t['rtf']:.2f}x real time; process_block median "
                  f"{t['block_ms']:.3f} ms (p10 {t['p10_ms']:.3f}, p90 "
                  f"{t['p90_ms']:.3f}, max {t['max_ms']:.3f}), between "
                  f"blocks {t['gap_ms']:.3f} ms; close {t['close_ms']:.1f} "
                  f"ms; the whole call {run.wall * 1e3:.1f} ms = "
                  f"{t['rtf_call']:.2f}x (host clock)", flush=True)

        # at the pace of real time, range statistics each second and the
        # torch profiler's trace of the card
        prof = d / "prof"
        conf.write_text(f"soundchannels mono\nbackend {backend}\n"
                        "statsinterval 1s\nlatitude 59.9\nlongitude 10.7\n")
        run = counted(kernels, lambda: station_cli(
            ["-c", str(conf), "-l", str(d / "rt.fifo"), "--profile",
             str(prof)], sock, raw, d / "rt.fifo", pace=True))
        check(run.rc == 0 and run.out == want,
              f"{backend}: real-time stdout differs")
        ranges = [line for line in run.log.splitlines()
                  if "Best range ch A" in line]
        check(1 <= len(ranges) <= run.wall, f"{backend}: {len(ranges)} range "
              f"lines in {run.wall:.2f} s")
        check("torch profiler trace" in run.log, "no profiler log line")
        traces = sorted(prof.glob("*.pt.trace.json"))
        check(len(traces) == 1, f"{backend}: traces {traces}")
        trace = traces[0].read_text()
        for k in kernels:
            check(STATION_KERNELS[k] in trace,
                  f"{backend}: the trace lacks {STATION_KERNELS[k]}")
        print(f"[15 station] {backend} at the pace of real time: "
              f"{len(ranges)} range lines ('{ranges[0].split(': ', 1)[1]}') "
              f"in {run.wall:.2f} s; the torch profiler's trace "
              f"({traces[0].stat().st_size} bytes) names "
              f"{', '.join(STATION_KERNELS[k] for k in kernels)}", flush=True)

        # the checkpoint seam: the first half, then the whole capture
        half = d / "half.raw"
        half.write_bytes(raw[: len(raw) // 4 * 2])
        conf.write_text(f"soundchannels mono\nbackend {backend}\n")
        ck = ["-c", str(conf), "--checkpoint", str(d / "ck")]
        run1 = counted(kernels, lambda: station_cli([*ck, "-l", str(half)],
                                                    sock))
        run2 = counted(kernels, lambda: station_cli(
            [*ck, "-l", str(fix / "standard_capture.raw")], sock))
        check(run1.rc == run2.rc == 0 and run1.out + run2.out == want
              and run1.out and run2.out,
              f"{backend}: the checkpoint seam's lines differ")
        check("Resuming from checkpoint" in run2.log and counters in run2.log,
              f"{backend}: resume: {run2.log!r}")
        print(f"[15 station] {backend} checkpoint seam: "
              f"{len(run1.out.splitlines())} + {len(run2.out.splitlines())} "
              f"lines == the fixture's, counters (49, 0, 0) after the "
              f"resume", flush=True)

        # two channels: the fixture on A, a seeded capture on B
        rng = np.random.default_rng([SEED, 15])
        pays = [E.random_payload(rng) for _ in range(STATION_PAYLOADS)]
        b = E.synthesize_capture(pays, gap_bits=64)
        b = np.concatenate([b, np.full(len(audio) - len(b), b[-1], b.dtype)])
        stereo = E.interleave_stereo(audio, b)
        lines, ctr, _ = golden_stdout(stereo, C.SOUND_CHANNELS_BOTH)
        check(ctr == {"A": (49, 0, 0), "B": (STATION_PAYLOADS, 0, 0)},
              f"golden stereo counters {ctr}")
        conf.write_text(f"soundchannels both\nbackend {backend}\n")
        run = counted(kernels, lambda: station_cli(
            ["-c", str(conf), "-l", str(d / "st.fifo")], sock,
            stereo.astype("<i2").tobytes(), d / "st.fifo"))
        check(run.rc == 0 and run.out.splitlines() == lines,
              f"{backend}: stereo stdout differs")
        check(counters in run.log and "B: Received correctly: "
              f"{STATION_PAYLOADS} packets, wrong CRC: 0 packets, wrong "
              "size: 0 packets" in run.log, f"{backend}: stereo counters")
        print(f"[15 station] {backend} soundchannels both: {len(lines)} "
              f"lines == the golden model's (A 49, B {STATION_PAYLOADS}, "
              f"each payload on its channel), counters (49, 0, 0) and "
              f"({STATION_PAYLOADS}, 0, 0)", flush=True)
    print(f"[15 station] launches: " + ", ".join(
        f"{k} {n}" for k, n in launches.items()), flush=True)
    return launches, times


def phase_supervised(tmp: Path, blocks, per_block, main_counters):
    """Phase 16: SupervisedDecoder over phase 4's BatchPipeline (B2) at
    full width on the three fleet blocks, a snapshot after every block,
    one failure injected in the second block's process(); then a fresh
    decoder resumes from the snapshot after two blocks.  Returns B2's
    launches and the times."""
    import shutil
    import torch
    from gnuais_tpu_torch.ops import fused
    from gnuais_tpu_torch.runtime import checkpoint as ckpt
    from gnuais_tpu_torch.runtime.pipeline import BatchPipeline
    from gnuais_tpu_torch.runtime.supervisor import SupervisedDecoder
    calls = [0]

    class Flaky(BatchPipeline):
        def process(self, samples):
            calls[0] += 1
            if calls[0] == 2:
                raise RuntimeError("injected failure in block 1")
            return super().process(samples)

    def make():
        return Flaky(FLEET_STREAMS, block_len=FLEET_BLOCK,
                     frame_slots=FLEET_SLOTS, fused_pipeline=True,
                     device_crc=True, device="cuda")

    path, restart = tmp / "fleet.npz", tmp / "restart.npz"
    events = []

    def on_event(kind, detail):
        events.append(kind)
        if kind == "checkpoint" and detail["blocks"] == 2:
            shutil.copyfile(path, restart)

    fused.pipeline_fused.launches = 0
    sup = SupervisedDecoder(make, path, checkpoint_every=1,
                            retry_backoff=0.0, on_event=on_event)
    walls = []
    for b, x in enumerate(blocks):
        ms, per_stream = host_ms(lambda: sup.process(x))
        walls.append(ms)
        check(payloads(per_stream) == per_block[b],
              f"supervised block {b}: frames differ from phase 4's")
    check([vars(c) for c in sup.counters] == main_counters,
          "supervised counters differ from phase 4's")
    check(events.count("failure") == 1 and "recovered" in events,
          f"events {events}")
    check(sup.pipe.device.type == "cuda", "the rebuilt pipeline left the card")
    launches = fused.pipeline_fused.launches
    check(launches == len(blocks), f"B2 launched {launches} times")
    # a new process's decoder over the snapshot taken after two blocks
    fused.pipeline_fused.launches = 0
    ms_open, sup2 = host_ms(lambda: SupervisedDecoder(
        lambda: BatchPipeline(FLEET_STREAMS, block_len=FLEET_BLOCK,
                              frame_slots=FLEET_SLOTS, fused_pipeline=True,
                              device_crc=True, device="cuda"), restart))
    offset = sup2.resume_offset()
    check(offset == 2 * FLEET_BLOCK, f"resume_offset {offset}")
    per_stream = sup2.process(blocks[2])
    check(payloads(per_stream) == per_block[2],
          "the resumed block 2 differs from phase 4's")
    check([vars(c) for c in sup2.counters] == main_counters,
          "the resumed counters differ from phase 4's")
    launches += fused.pipeline_fused.launches
    # the snapshot's own times at full width
    pipe = sup2.pipe
    ms_save = statistics.median(host_ms(lambda: ckpt.save_pipeline(
        tmp / "t.npz", pipe, 3 * FLEET_BLOCK))[0] for _ in range(5))
    ms_load = statistics.median(host_ms(lambda: ckpt.restore_pipeline(
        tmp / "t.npz", pipe))[0] for _ in range(5))
    size = (tmp / "t.npz").stat().st_size
    torch.cuda.synchronize()
    print(f"[16 supervised] SupervisedDecoder(BatchPipeline({FLEET_STREAMS}, "
          f"{FLEET_BLOCK}, {FLEET_SLOTS} slots, fused_pipeline, device_crc), "
          f"checkpoint_every 1, no backoff): a failure injected in block 1's "
          f"process(), recovered (rebuild, restore, replay); frames of "
          f"every block and the counters == phase 4's; process() per block "
          f"{', '.join(f'{w:.1f}' for w in walls)} ms (block 1 with the "
          f"recovery)", flush=True)
    print(f"[16 supervised] a new decoder over the snapshot after two "
          f"blocks: resume_offset {offset} == 2 x "
          f"{FLEET_BLOCK}, opened in {ms_open:.1f} ms; block 2 == phase 4's; "
          f"checkpoint of {FLEET_STREAMS} streams ({size} bytes): write "
          f"{ms_save:.2f} ms, read {ms_load:.2f} ms (medians of 5, host "
          f"clock); B2 launches {launches}", flush=True)
    return launches, dict(recovery_ms=walls[1], block_ms=walls[0],
                          save_ms=ms_save, load_ms=ms_load)


# ---------------------------------------------------------------------------
# Phases 17-19: the throughput modes (the IQ front end, the lanes, the
# one-card session)
# ---------------------------------------------------------------------------

LANE_SLOTS = 64          # the lanes' frame slots: max(frameslots, 64)
LANE_SHAPES = (56_320, 72_704)  # B1's T on the lanes: streams 4096 over
#                          the 70-minute stream, and the default chunk_len
SESSION_T = 4096 + FLEET_BLOCK + 3072  # B2's T in the 1 x 1 session
PLAIN_CHECKED = 64       # lanes / rows of phases 18-19 held against plain
UNROLLED_SB = 3 << 20    # phase 18's one-stream session: 64 super-blocks
#                          over the 201,326,592 samples of the fleet rows,
UNROLLED_SLOTS = 1024    # and frame slots for the 8 payloads of each of
#                          the 65 rows that a window reaches into
UNROLLED_LOSS = 0.01     # the share of frames either may lose there, ten
#                          times the 0.05 % and 0.09 % read on an H100
IQ_ROWS = 30             # fleet rows a channel of phase 17's capture
IQ_DECIM = 4
IQ_BLOCK = 1 << 16       # the IQ reader's block: 65,536 output frames
IQ_CHECKED_BLOCKS = 8    # reader blocks held against the CPU front end
# the decoder FIR's group delay (36 symmetric taps) and the IQ front end's
# (64 taps at 48 kHz x IQ_DECIM), in samples at 48 kHz
DECODER_DELAY = (36 - 1) / 2
FRONT_END_DELAY = (64 - 1) / 2 / IQ_DECIM


def grid_offset(pos: int, delay: float) -> int:
    """The roll, 0..4 samples, that puts the bit edges of a fleet row laid
    at absolute sample ``pos`` (on multiples of 5 within the row) where a
    free-running DPLL expects them once filtered (``delay`` samples
    later): at the phase PLL_CENTER.  A lane or session window cold-starts
    its DPLL at the free-run phase PLL_INC*b mod 2^16 of its base b
    (``parallel.timepar._lane_carry``), which drifts a 65536th of a bit
    per bit from a 5-sample grid; a row laid without this roll may sit
    up to half a bit from it, too far for a preamble after a lead overlap
    without transitions (the rows' idle level) to pull in.  The fleet
    block makes the same choice for the carried DPLL of its blocks."""
    from gnuais_tpu_torch import constants as C
    return min(range(5), key=lambda o: abs(
        (C.PLL_INC * (pos + o + delay)) % 65536 - C.PLL_CENTER))


def end_to_end(rows: np.ndarray, delay: float) -> np.ndarray:
    """Fleet rows [R, T] laid end to end as one stream, each rolled by
    ``grid_offset`` at its position (its first and last samples are
    idle, so the roll moves idle samples only)."""
    t = rows.shape[1]
    return np.concatenate([np.roll(row, grid_offset(r * t, delay))
                           for r, row in enumerate(rows)])


def fm_modulate(audio: np.ndarray, decim: int) -> np.ndarray:
    """FM-modulate int16 audio into complex64 baseband IQ at 48 kHz *
    decim (the inverse of the discriminator; tests/test_iq_streaming.py's
    modulator)."""
    x = np.repeat(audio.astype(np.float64) / 32767.0, decim)
    phase = 2 * np.pi * np.cumsum(x * 2400.0) / (48000.0 * decim)
    return np.exp(1j * phase).astype(np.complex64)


def expected_lines(payloads, chan: str) -> list:
    """The stdout lines of a channel that decodes ``payloads`` in order
    (the port's dispatcher; its NMEA seqnr rolls per channel)."""
    from gnuais_tpu_torch.ais.dispatcher import ChannelDispatcher
    disp = ChannelDispatcher(chan)
    out = []
    for p in payloads:
        msg = disp.dispatch(np.asarray(p, dtype=np.uint8), len(p))
        if msg is not None and msg.stdout_line:
            out.append(msg.stdout_line)
    return out


def cli_run(argv, sock):
    """``gnuais-tpu-torch argv`` in this process (its launches counted),
    its NMEA socket at ``sock``.  Returns (rc, stdout, log text, host
    seconds)."""
    import io
    import logging
    out, summary = io.StringIO(), io.StringIO()
    handler = logging.StreamHandler(summary)
    log = logging.getLogger("gnuais")
    log.setLevel(logging.INFO)
    log.addHandler(handler)
    try:
        with own_socket(sock) as cli, contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            rc = cli.main(argv)
            secs = time.perf_counter() - t0
    finally:
        log.removeHandler(handler)
    return rc, out.getvalue(), summary.getvalue(), secs


def cli_counters(text: str) -> dict:
    import re
    return {m.group(1): tuple(int(m.group(i)) for i in (2, 3, 4))
            for m in re.finditer(r"(\w): Received correctly: (\d+) packets, "
                                 r"wrong CRC: (\d+) packets, wrong size: "
                                 r"(\d+) packets", text)}


def plain_job(kind: str, x: np.ndarray, nv: int, carry, kw: dict):
    """Run in a child process on the CPU: the plain version of B1
    (``kind`` "B1", ``pipeline_fused_compact_reference``) or B2 ("B2",
    ``pipeline_fused_reference``) on ``x`` [S, T] int16 from ``carry`` (a
    list of numpy leaves in ``convert`` order).  Returns (its outputs as
    numpy arrays, seconds)."""
    import torch
    torch.set_num_threads(1)
    from gnuais_tpu_torch import convert
    from gnuais_tpu_torch.ops import fused
    t0 = time.perf_counter()
    c = convert.carry_from_numpy(carry, "cpu")
    fn = (fused.pipeline_fused_compact_reference if kind == "B1"
          else fused.pipeline_fused_reference)
    out = fn(torch.from_numpy(x), nv, c.history, c.dpll, c.hdlc, **kw)
    return [t.numpy() for t in leaves(out)], time.perf_counter() - t0


class PlainChild:
    """``plain_job``s collected while the phases run and run by ``held``
    once the timed phases are over, each in a spawned CPU process of its
    own (so that no host time of a timed phase goes to them); ``held``
    compares each with the kernel's outputs (``check``), bitwise."""

    def __init__(self):
        self.jobs = []

    def submit(self, what: str, kind: str, x, nv, carry, kw, kernel_out):
        """Queue the plain version of ``kind`` on x (a CUDA or CPU int16
        tensor [S, T]) from ``carry`` (a PipelineCarry), to be held
        against ``kernel_out`` (the kernel's outputs on those rows)."""
        from gnuais_tpu_torch import convert
        self.jobs.append((what, kind, (kind, x.cpu().contiguous().numpy(),
                                       nv, convert.carry_to_numpy(carry), kw),
                          [t.cpu() for t in leaves(kernel_out)]))

    def held(self) -> dict:
        """Run every job, wait for it and hold it against its kernel
        outputs; returns {kind: max abs error} (0: bitwise, or the run
        fails)."""
        import multiprocessing
        import torch
        errs = {}
        procs = min(len(self.jobs), os.cpu_count() or 1)
        pool = multiprocessing.get_context("spawn").Pool(procs)
        try:
            running = [(what, kind, pool.apply_async(plain_job, args), kernel)
                       for what, kind, args, kernel in self.jobs]
            for what, kind, job, kernel in running:
                arrays, secs = job.get(timeout=1000)
                plain = [torch.from_numpy(a) for a in arrays]
                errs[kind] = max(errs.get(kind, 0.0),
                                 compare(kernel, plain, what))
                print(f"[plain child] {what}: == the plain version on the "
                      f"CPU ({secs:.1f} s), bitwise", flush=True)
        finally:
            pool.terminate()
            pool.join()
        return errs


def phase_parity_lanes_shapes(child: PlainChild):
    """B1 at the lanes' shapes (F = 64 frame slots, T = 56,320 and
    72,704) and B2 at the session's (T = 56,320), at S = 33 (one stream
    past a 32-stream block), n_valid T and T-333, a nonzero base, from
    a carried history of noise, against their plain versions run in the
    CPU child (``child``), bitwise, when it is read."""
    import torch
    from gnuais_tpu_torch import captures
    from gnuais_tpu_torch.ops import fused
    from gnuais_tpu_torch.runtime.pipeline import init_carry
    s = 33
    cases = [("B1", LANE_SHAPES[0], LANE_SHAPES[0] - 333),
             ("B1", LANE_SHAPES[1], LANE_SHAPES[1]),
             ("B2", SESSION_T, SESSION_T - 333)]
    for kind, t, nv in cases:
        x = torch.from_numpy(captures.mixed(s, t, seed=t + 1)).cuda()
        c = init_carry(s, "cuda")
        c = c._replace(history=torch.from_numpy(
            captures.garbage(s, 36, seed=t).astype(np.float32)).cuda())
        kw = dict(block_base=4097, lost2_lo=4097 + 4096,
                  lost2_hi=4097 + t - 3072)
        if kind == "B1":
            out = fused.pipeline_fused_compact(x, nv, c.history, c.dpll,
                                               c.hdlc, frame_slots=LANE_SLOTS,
                                               **kw)
            kw["frame_slots"] = LANE_SLOTS
        else:
            out = fused.pipeline_fused(x, nv, c.history, c.dpll, c.hdlc, **kw)
        child.submit(f"{kind} S={s} T={t} n_valid={nv}"
                     + (f" F={LANE_SLOTS}" if kind == "B1" else ""),
                     kind, x, nv, c, kw, out)
        print(f"[3 parity lanes] {kind} at S={s} T={t} n_valid={nv} ran on "
              f"the card: {int(out[0].sum())} "
              f"{'frames' if kind == 'B1' else 'candidates'}; held against "
              f"the plain version in the CPU child", flush=True)


def phase_iq(tmp: Path, blocks, expected):
    """Phase 17: a stereo IQ capture at decim 4 (channel A: fleet rows
    0-29 of block 0 end to end, B: rows 30-59, ``end_to_end`` with the
    front end's delay too, FM-modulated, interleaved float32) through
    ``cli.main`` with ``inputformat iq`` sequential (``--backend fused``,
    B2), ``streams 8`` (the lanes, B1) and ``meshshape 1 1`` (the
    session, B2): the same stdout and counters, each channel's lines
    those of its encoded payloads in order.  The card's int16 audio of
    the first IQ_CHECKED_BLOCKS reader blocks against the port's front
    end on the CPU (the ±1 differences counted and bounded); the front
    end's ms a block.  Returns ({kernel: launches}, its times)."""
    import torch
    from gnuais_tpu_torch.io.iq import IqStreamReader
    from gnuais_tpu_torch.ops import fused
    delay = DECODER_DELAY + FRONT_END_DELAY
    chans = [end_to_end(blocks[0][r0:r0 + IQ_ROWS], delay)
             for r0 in (0, IQ_ROWS)]
    pays = [[p for r in range(r0, r0 + IQ_ROWS) for p in expected[0][r]]
            for r0 in (0, IQ_ROWS)]
    want = {ch: expected_lines(p, ch) for ch, p in zip("AB", pays)}
    iq = [fm_modulate(a, IQ_DECIM) for a in chans]
    raw = np.empty((len(iq[0]), 2, 2), dtype="<f4")
    for c in range(2):
        raw[:, c, 0], raw[:, c, 1] = iq[c].real, iq[c].imag
    path = tmp / "fleet.iq"
    raw.tofile(path)
    del raw, iq
    n = len(chans[0])
    print(f"[17 iq] stereo IQ capture at decim {IQ_DECIM}: {IQ_ROWS} fleet "
          f"rows a channel, {n} frames ({n / 48000:.1f} s), "
          f"{path.stat().st_size} bytes of float32", flush=True)

    # the front end on the card against its plain run on the CPU
    card = IqStreamReader(path, channels=2, decim=IQ_DECIM,
                          block_frames=IQ_BLOCK, device="cuda")
    cpu = IqStreamReader(path, channels=2, decim=IQ_DECIM,
                         block_frames=IQ_BLOCK, device="cpu")
    walls, diffs, n_cmp = [], 0, 0
    it_card, it_cpu = card.blocks(), cpu.blocks()
    for _ in range(IQ_CHECKED_BLOCKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = next(it_card)
        walls.append((time.perf_counter() - t0) * 1e3)
        d = a.astype(np.int32) - next(it_cpu).astype(np.int32)
        check(np.abs(d).max() <= 1, "IQ audio differs by more than 1")
        diffs += int(np.count_nonzero(d))
        n_cmp += d.size
    check(diffs <= n_cmp // 1000, f"{diffs} of {n_cmp} IQ audio samples "
          "differ from the CPU front end's (bound: 1 in 1000)")
    ms = statistics.median(walls[1:])
    print(f"[17 iq] the front end on the card (FM discriminator, 64-tap "
          f"decimator, int16 rounding) on {IQ_CHECKED_BLOCKS} blocks of "
          f"{IQ_BLOCK} frames x 2 channels: {diffs} of {n_cmp} samples "
          f"differ by 1 from the plain front end on the CPU (atan2's last "
          f"bit), none by more; {ms:.2f} ms a block (median of "
          f"{len(walls) - 1} after the first, host clock, upload and "
          f"read-back included): {IQ_BLOCK / 48000 / (ms / 1e3):.0f}x real "
          f"time", flush=True)

    runs, launches = {}, {}
    modes = {"sequential": ("", ["--backend", "fused"]),
             "streams 8": ("streams 8\n", []),
             "meshshape 1 1": ("meshshape 1 1\n", [])}
    for mode, (line, extra) in modes.items():
        conf = tmp / "iq.conf"
        conf.write_text(f"soundchannels both\ninputformat iq\n"
                        f"iqdecim {IQ_DECIM}\n{line}")
        fused.pipeline_fused.launches = 0
        fused.pipeline_fused_compact.launches = 0
        rc, out, text, secs = cli_run(
            ["-c", str(conf), "-l", str(path), *extra],
            short_path(tmp / f"iq{len(runs)}.sock"))
        launches[mode] = (fused.pipeline_fused.launches,
                          fused.pipeline_fused_compact.launches)
        check(rc == 0, f"iq {mode}: rc {rc}: {text[-500:]}")
        lines = out.splitlines()
        for ch in "AB":
            got = [l for l in lines if l.startswith(f"ch {ch} ")]
            check(got == want[ch], f"iq {mode} channel {ch}: {len(got)} lines, "
                  f"{len(want[ch])} from the encoded payloads")
        runs[mode] = (out, cli_counters(text))
        check(runs[mode][1] == {ch: (len(p), 0, 0) for ch, p in
                                zip("AB", pays)},
              f"iq {mode} counters {runs[mode][1]}")
        print(f"[17 iq] cli inputformat iq, {mode}: {len(lines)} stdout "
              f"lines, each channel's those of its {len(pays[0])} encoded "
              f"payloads in order; counters {runs[mode][1]}; launches B2 "
              f"{launches[mode][0]}, B1 {launches[mode][1]}; "
              f"{secs:.1f} s", flush=True)
    # the lanes and the session emit in the 1020-frame block framing; the
    # sequential path cuts each 65,536-frame reader block into 1020-frame
    # blocks (a 256-frame block at each seam, as the JAX CLI does), so its
    # A/B interleaving may differ while each channel's lines do not
    check(runs["streams 8"][0] == runs["meshshape 1 1"][0],
          "the lanes' and the session's IQ stdout differ")
    seq, lanes = (runs[m][0].splitlines() for m in ("sequential", "streams 8"))
    moved = sum(a != b for a, b in zip(seq, lanes))
    print(f"[17 iq] the lanes' and the session's stdout are the same bytes; "
          f"the sequential path's has each channel's lines in the same "
          f"order, {moved} of {len(seq)} lines at other places in the A/B "
          f"interleaving (its reader-block framing)", flush=True)
    check(launches["sequential"][0] > 0 and launches["meshshape 1 1"][0] > 0
          and launches["streams 8"] == (0, 2),
          f"IQ launches {launches}")
    return ({"B2": launches["sequential"][0] + launches["meshshape 1 1"][0],
             "B1": launches["streams 8"][1]},
            dict(front_end_ms=ms, mesh=runs["meshshape 1 1"]))


def phase_lanes(tmp: Path, blocks, expected, child: PlainChild):
    """Phase 18: time_parallel_decode (kernel B1) on one mono stream, all
    4096 rows of fleet block 0 end to end (``end_to_end``), 201,326,592
    samples: the default chunk_len (3072 lanes, T = 72,704, more frames
    than the dense buffer: the slot drain) and the first 512 rows (384
    lanes: the dense drain); every row's payloads in row order, no other
    frame, counters 0.  B1's FrameBatch and carry on the first
    PLAIN_CHECKED lanes against the plain version in the CPU child.  Then
    ``cli.main`` with ``streams 4096`` on the stream written as a raw
    file: one stdout line per line the encoded payloads give, counters
    (32,768, 0, 0).  Last, ``unrolled_loss`` on the rows as they are.
    Returns (B1's launches, B2's launches, the times)."""
    import torch
    from gnuais_tpu_torch.ops import fused
    from gnuais_tpu_torch.parallel import timepar
    from gnuais_tpu_torch.runtime import pipeline as pl
    stream = end_to_end(blocks[0], DECODER_DELAY)
    pays = [p.tobytes() for row in expected[0] for p in row]
    drains = []
    real_extract = pl.extract_dense

    def counted(*a, **k):
        drains.append("dense")
        return real_extract(*a, **k)

    launches, times, dense_used = 0, {}, {}
    pl.extract_dense = counted
    try:
        for rows in (FLEET_STREAMS, FLEET_STREAMS // 8):
            label = f"{rows} rows"
            x = stream[:rows * FLEET_BLOCK]
            fused.pipeline_fused_compact.launches = 0
            drains.clear()
            timings = {}
            t0 = time.perf_counter()
            res = timepar.time_parallel_decode(x, frame_slots=LANE_SLOTS,
                                               device="cuda", timings=timings)
            wall = time.perf_counter() - t0
            launches += fused.pipeline_fused_compact.launches
            check(fused.pipeline_fused_compact.launches == 1,
                  f"lanes {label}: B1 launched "
                  f"{fused.pipeline_fused_compact.launches} times")
            got = [f.payload_bits[:f.bufferlen].tobytes() for f in res.frames]
            n_want = rows * 8
            check(got == pays[:n_want], f"lanes {label}: {len(got)} frames, "
                  f"{n_want} encoded (in row order)")
            check(len(set(res.starts)) == len(res.starts), "duplicate starts")
            check((res.wrong_crc, res.wrong_size) == (0, 0),
                  f"lanes {label}: counters {res.wrong_crc}, {res.wrong_size}")
            times[label] = dict(wall_ms=wall * 1e3, **timings)
            dense_used[label] = bool(drains)
            print(f"[18 lanes] time_parallel_decode of {len(x)} samples "
                  f"({len(x) / 48000 / 60:.1f} min), {label}: {res.chunks} "
                  f"lanes of 65536 (T = {4096 + 65536 + 3072}, F = "
                  f"{LANE_SLOTS}), 1 launch of B1, the "
                  f"{'dense' if drains else 'slot'} drain; all {n_want} "
                  f"payloads in row order, no duplicate, counters (0, 0); "
                  f"gather {timings['gather_ms']:.1f} ms, B1 "
                  f"{timings['decode_ms']:.1f} ms, drain "
                  f"{timings['drain_ms']:.1f} ms (host clock, device "
                  f"synchronised); {wall * 1e3:.1f} ms in all", flush=True)
        # the dense buffer holds 8192 frames: the whole block overflows it
        # (the slot drain), an eighth of it does not
        check(dense_used == {f"{r} rows": r * 8 <= 8192 for r in
                             (FLEET_STREAMS, FLEET_STREAMS // 8)},
              f"the drains taken: dense {dense_used}")
    finally:
        pl.extract_dense = real_extract

    # B1 on the same lanes (one more launch, not the path's) against the
    # plain version on the first PLAIN_CHECKED lanes
    chunk = 65_536
    k = -(-len(stream) // chunk)
    win = LANE_SHAPES[1]
    lanes = timepar._gather_lanes(torch.from_numpy(stream).cuda(), k, win,
                                  chunk, 4096)
    carry = timepar._lane_carry(k, chunk, 4096, torch.device("cuda"))
    kw = dict(block_base=0, lost2_lo=4096, lost2_hi=4096 + chunk)
    args = (lanes, win, carry.history, carry.dpll, carry.hdlc)
    ms, out = device_ms(lambda: fused.pipeline_fused_compact(
        *args, frame_slots=LANE_SLOTS, **kw))
    b_ms, b_by = bound((args, out), FIR_FLOPS["vpu"] * k * win)
    times["b1_ms"], times["b1_bound_ms"] = ms, b_ms
    print(f"[18 lanes] B1 alone on the {k} lanes of T = {win} (F = "
          f"{LANE_SLOTS}), read in place from the gather's view: {ms:.3f} "
          f"ms (median of 5, CUDA events; bound {b_ms:.3f} ms by {b_by}), "
          f"{ms * 1e6 / win:.1f} ns a sample of a lane", flush=True)
    head = pl.PipelineCarry(carry.history[:PLAIN_CHECKED],
                            type(carry.dpll)(*(v[:PLAIN_CHECKED]
                                               for v in carry.dpll)),
                            type(carry.hdlc)(*(v[:PLAIN_CHECKED]
                                               for v in carry.hdlc)))
    child.submit(f"18 lanes: B1 on lanes 0..{PLAIN_CHECKED - 1} of {k} "
                 f"(T = {win}, F = {LANE_SLOTS})", "B1",
                 lanes[:PLAIN_CHECKED], win, head,
                 dict(kw, frame_slots=LANE_SLOTS),
                 [t[:PLAIN_CHECKED] for t in leaves(out)])
    del lanes, out

    # the CLI: streams 4096 on the stream as a raw file
    raw = tmp / "fleet70.raw"
    stream.astype("<i2").tofile(raw)
    conf = tmp / "lanes.conf"
    conf.write_text(f"soundchannels mono\nstreams {FLEET_STREAMS}\n")
    fused.pipeline_fused_compact.launches = 0
    rc, out, text, secs = cli_run(["-c", str(conf), "-l", str(raw)],
                                  short_path(tmp / "lanes.sock"))
    cli_launches = fused.pipeline_fused_compact.launches
    launches += cli_launches
    raw.unlink()
    check(rc == 0, f"streams {FLEET_STREAMS}: rc {rc}: {text[-500:]}")
    want_lines = expected_lines([p for row in expected[0] for p in row], "A")
    check(out.splitlines() == want_lines,
          f"streams {FLEET_STREAMS}: {len(out.splitlines())} stdout lines, "
          f"{len(want_lines)} from the encoded payloads")
    check(cli_counters(text) == {"A": (len(pays), 0, 0)},
          f"streams {FLEET_STREAMS} counters {cli_counters(text)}")
    check(cli_launches == 1, f"the CLI launched B1 {cli_launches} times")
    times["cli_s"] = secs
    print(f"[18 lanes] cli streams {FLEET_STREAMS} on the {len(stream) * 2} "
          f"byte raw file: {FLEET_STREAMS} lanes (T = "
          f"{4096 + FLEET_BLOCK + 3072}), 1 launch of B1; "
          f"{len(want_lines)} stdout lines, those of the {len(pays)} encoded "
          f"payloads in order; counters ({len(pays)}, 0, 0); {secs:.1f} s "
          f"(host clock, the envelope scan and the dispatch included)",
          flush=True)
    b1, b2, times["unrolled"] = unrolled_loss(blocks[0], expected[0])
    return launches + b1, b2, times


def unrolled_loss(rows: np.ndarray, row_payloads: list):
    """The lanes' shared frame loss (ROADMAP section 3, item 8) at full
    width: the fleet rows [R, T] laid end to end as they are, without
    ``end_to_end``'s roll, through ``time_parallel_decode`` (3072 lanes,
    one launch of B1) and through a one-stream ``TimeParSession`` (the
    same stream in UNROLLED_SB super-blocks, B2 once a super-block),
    which decodes as the sequential chain does.  Each decoded frame is
    placed by its start's row and its payload among the row's
    (``row_payloads``): no frame that is not, none twice.  Frames are
    lost after idle stretches, where a DPLL free-runs off the next row's
    bit grid: the session's carried one (as the reference's chain does)
    mostly at a row's first frame, the lanes' cold ones also after their
    lead overlaps.  Prints the losses, and bounds each at UNROLLED_LOSS
    (the session's against the encoded payloads, the lanes' against the
    session's frames), so that a growth of the shared fault shows.
    Returns (B1's launches, B2's launches, the counts)."""
    import collections
    from gnuais_tpu_torch.ops import fused
    from gnuais_tpu_torch.parallel import timepar
    from gnuais_tpu_torch.parallel.mesh import make_grid_mesh
    stream = rows.reshape(-1)
    t = rows.shape[1]
    chunk = 65_536
    fused.pipeline_fused_compact.launches = 0
    t0 = time.perf_counter()
    res = timepar.time_parallel_decode(stream, frame_slots=LANE_SLOTS,
                                       device="cuda")
    lanes_s = time.perf_counter() - t0
    b1 = fused.pipeline_fused_compact.launches
    check(b1 == 1, f"unrolled lanes: B1 launched {b1} times")

    fused.pipeline_fused.launches = 0
    t0 = time.perf_counter()
    sess = timepar.TimeParSession(make_grid_mesh(1, 1, device="cuda"), 1,
                                  UNROLLED_SB, frame_slots=UNROLLED_SLOTS)
    ses = []
    pushes = -(-len(stream) // UNROLLED_SB)
    padded = np.zeros(pushes * UNROLLED_SB, np.int16)
    padded[:len(stream)] = stream
    for b in range(pushes):
        out = sess.push(padded[None, b * UNROLLED_SB:(b + 1) * UNROLLED_SB])
        ses += out[0] if out else []
    ses += sess.flush(n_valid=len(stream) - (pushes - 1) * UNROLLED_SB)[0]
    ses_s = time.perf_counter() - t0
    b2 = fused.pipeline_fused.launches
    check(b2 == pushes, f"unrolled session: B2 launched {b2} times")

    index = [{p.tobytes(): i for i, p in enumerate(row)}
             for row in row_payloads]

    def placed(starts, frames):
        """{(row, index in the row): start} of the decoded frames, and
        how many are no payload of their row or come twice."""
        out, bad = {}, 0
        for st, f in zip(starts, frames):
            r = st // t
            i = (index[r].get(f.payload_bits[:f.bufferlen].tobytes())
                 if 0 <= r < len(index) else None)
            if i is None or (r, i) in out:
                bad += 1
            else:
                out[(r, i)] = st
        return out, bad

    got_s, bad_s = placed([st for st, _e, _f in ses], [f for *_x, f in ses])
    got_l, bad_l = placed(res.starts, res.frames)
    encoded = {(r, i) for r, row in enumerate(row_payloads)
               for i in range(len(row))}
    lost_s = encoded - set(got_s)
    lost_l = encoded - set(got_l)
    only_s = set(got_s) - set(got_l)       # the lanes' loss against it
    only_l = set(got_l) - set(got_s)
    row_max = max(collections.Counter(r for r, _i in lost_s).values(),
                  default=0)
    lane_max = max(collections.Counter(got_s[k] // chunk
                                       for k in only_s).values(), default=0)
    counts = dict(
        encoded=len(encoded), session=len(got_s), lanes=len(got_l),
        session_lost=len(lost_s), lanes_lost=len(lost_l),
        lanes_lost_vs_session=len(only_s), session_lost_vs_lanes=len(only_l),
        session_lost_first=sum(i == 0 for _r, i in lost_s),
        lanes_lost_first=sum(i == 0 for _r, i in lost_l),
        session_counters=(sess.wrong_crc[0], sess.wrong_size[0]),
        lanes_counters=(res.wrong_crc, res.wrong_size),
        lanes_s=lanes_s, session_s=ses_s)
    print(f"[18 lanes] unrolled (the rows end to end without the roll, "
          f"{len(stream)} samples, {len(encoded)} payloads encoded): the "
          f"session ({pushes} super-blocks of {UNROLLED_SB}, {b2} launches "
          f"of B2, {ses_s:.1f} s) decodes {len(got_s)}, loses "
          f"{len(lost_s)} ({counts['session_lost_first']} a row's first, "
          f"at most {row_max} a row), wrong CRC "
          f"{sess.wrong_crc[0]}, wrong size {sess.wrong_size[0]}; the "
          f"lanes ({res.chunks} of {chunk}, 1 launch of B1, {lanes_s:.2f} s) "
          f"decode {len(got_l)}, lose {len(lost_l)} "
          f"({counts['lanes_lost_first']} a row's first), wrong CRC "
          f"{res.wrong_crc}, wrong size {res.wrong_size}; the lanes lose "
          f"{len(only_s)} of the session's frames ({len(only_s) / max(len(got_s), 1):.4%}"
          f", at most {lane_max} a lane) and decode "
          f"{len(only_l)} it loses (host clock)", flush=True)
    check(bad_s == 0 and bad_l == 0,
          f"unrolled: frames that are no payload of their row or come "
          f"twice: session {bad_s}, lanes {bad_l}")
    check(len(lost_s) <= UNROLLED_LOSS * len(encoded),
          f"unrolled session: lost {len(lost_s)} of {len(encoded)} frames")
    check(len(only_s) <= UNROLLED_LOSS * len(got_s),
          f"unrolled lanes: lost {len(only_s)} of the session's "
          f"{len(got_s)} frames")
    return b1, b2, counts


def phase_session(tmp: Path, blocks, per_block, child: PlainChild):
    """Phase 19: TimeParSession on a 1 x 1 grid of the card, 4096 rows,
    super-blocks of 49,152 samples, over phase 4's three fleet blocks
    (kernel B2 at T = 56,320): per stream the union of its frames equals
    phase 4's.  A snapshot after block 1 restored into a new session
    continues identically.  A block's upload timed as the session makes
    it and as a prefetch would (pinned staging, then ``non_blocking``).
    B2 on the first PLAIN_CHECKED rows of the second push's window
    against the plain version in the CPU child.  Returns (B2's
    launches, the times)."""
    import torch
    from gnuais_tpu_torch import constants as C
    from gnuais_tpu_torch.ops import fused
    from gnuais_tpu_torch.parallel.mesh import make_grid_mesh
    from gnuais_tpu_torch.parallel.timepar import TimeParSession
    from gnuais_tpu_torch.runtime.pipeline import init_carry
    mesh = make_grid_mesh(1, 1, device="cuda")
    path = tmp / "session.npz"

    def session():
        return TimeParSession(mesh, FLEET_STREAMS, FLEET_BLOCK)

    def collect(got, out):
        if out:
            for i, lst in enumerate(out):
                got[i] += [f.payload_bits[:f.bufferlen].tobytes()
                           for _s, _e, f in lst]

    fused.pipeline_fused.launches = 0
    sess = session()
    got = [[] for _ in range(FLEET_STREAMS)]
    push_ms = []
    for b, x in enumerate(blocks):
        ms, out = host_ms(lambda: sess.push(x))
        push_ms.append(ms)
        collect(got, out)
        if b == 1:
            # the snapshot as the CLI's .mesh.npz holds it, written at once
            # (its lists go on changing in the session)
            ms_save, _ = host_ms(lambda: np.savez(
                path, sess=np.array(sess.snapshot(), dtype=object)))
            after_snap = [list(g) for g in got]
    ms, out = host_ms(lambda: sess.flush())
    push_ms.append(ms)
    collect(got, out)
    launches = fused.pipeline_fused.launches
    check(launches == len(blocks), f"the session launched B2 {launches} times")
    want = [sum((per_block[b][i] for b in range(len(blocks))), [])
            for i in range(FLEET_STREAMS)]
    check(got == want, "the session's frames differ from phase 4's")
    total = sum(map(len, got))
    check((sum(sess.received), sum(sess.wrong_crc), sum(sess.wrong_size))
          == (total, 0, 0), "the session's counters")
    # the snapshot read back into a new session
    ms_load, loaded = host_ms(lambda: np.load(path, allow_pickle=True)[
        "sess"].item())
    size = path.stat().st_size
    path.unlink()
    fused.pipeline_fused.launches = 0
    again = session()
    again.restore(loaded)
    cont = [list(g) for g in after_snap]
    collect(cont, again.push(blocks[2]))
    collect(cont, again.flush())
    launches += fused.pipeline_fused.launches
    check(cont == got, "the restored session's continuation differs")
    check((again.received, again.wrong_crc, again.wrong_size)
          == (sess.received, sess.wrong_crc, sess.wrong_size),
          "the restored session's counters")
    # what an upload prefetch could hide: a block's upload as the session
    # makes it (pageable ``.to``) against a copy into pinned memory and a
    # ``non_blocking`` copy from there, which a prefetch would overlap
    # with the step; in turn, five times each
    pinned = torch.empty(blocks[1].shape, dtype=torch.int16, pin_memory=True)
    up_ms, stage_ms, h2d_ms = [], [], []
    for _ in range(5):
        up_ms.append(host_ms(lambda: torch.from_numpy(blocks[1]).cuda())[0])
        stage_ms.append(host_ms(lambda: np.copyto(pinned.numpy(),
                                                  blocks[1]))[0])
        h2d_ms.append(host_ms(lambda: pinned.to("cuda", non_blocking=True))[0])
    up = {k: statistics.median(v) for k, v in
          (("pageable_ms", up_ms), ("stage_ms", stage_ms), ("h2d_ms", h2d_ms))}
    print(f"[19 session] a block's upload ({blocks[1].nbytes} bytes, medians "
          f"of 5 in turn, host clock): pageable {up['pageable_ms']:.1f} ms (the "
          f"session's); into pinned memory {up['stage_ms']:.1f} ms, then "
          f"non_blocking to the card {up['h2d_ms']:.1f} ms", flush=True)
    # B2 on the second push's window (one more launch, not the path's)
    # against the plain version on its first PLAIN_CHECKED rows
    prev = torch.from_numpy(blocks[0][:, -4096:]).cuda()
    head = torch.from_numpy(blocks[2][:, :3072]).cuda()
    win = torch.cat([prev, torch.from_numpy(blocks[1]).cuda(), head], dim=1)
    base = FLEET_BLOCK - 4096
    c = init_carry(FLEET_STREAMS, "cuda")
    c = c._replace(dpll=c.dpll._replace(pll=torch.full(
        (FLEET_STREAMS,), C.PLL_INC * (base % 65536) % 65536,
        dtype=torch.int32, device="cuda")))
    kw = dict(block_base=base, lost2_lo=FLEET_BLOCK,
              lost2_hi=2 * FLEET_BLOCK)
    args = (win, SESSION_T, c.history, c.dpll, c.hdlc)
    ms_b2, out = device_ms(lambda: fused.pipeline_fused(*args, **kw))
    b_ms, b_by = bound((args, out),
                       FIR_FLOPS["vpu"] * FLEET_STREAMS * SESSION_T)
    print(f"[19 session] B2 alone on block 1's window [{FLEET_STREAMS}, "
          f"{SESSION_T}]: {ms_b2:.3f} ms (median of 5, CUDA events; bound "
          f"{b_ms:.3f} ms by {b_by})", flush=True)
    n = PLAIN_CHECKED
    child.submit(f"19 session: B2 on rows 0..{n - 1} of push 2's window "
                 f"(T = {SESSION_T})", "B2", win[:n], SESSION_T,
                 type(c)(c.history[:n], type(c.dpll)(*(v[:n] for v in c.dpll)),
                         type(c.hdlc)(*(v[:n] for v in c.hdlc))),
                 kw, [t[:n] for t in leaves(out)])
    print(f"[19 session] TimeParSession(1 x 1 on the card, {FLEET_STREAMS} "
          f"rows, super-block {FLEET_BLOCK}, T = {SESSION_T}) over the "
          f"{len(blocks)} fleet blocks: {total} frames, per stream those of "
          f"phase 4; counters ({total}, 0, 0); push "
          + ", ".join(f"{m:.1f}" for m in push_ms[:-1])
          + f" ms, flush {push_ms[-1]:.1f} ms (host clock, synchronised; "
          f"the first push holds its block); a snapshot after block 1 "
          f"({size} bytes: write {ms_save:.1f} ms, read {ms_load:.1f} ms) "
          f"restored into a new session continues identically; B2 launches "
          f"{launches}", flush=True)
    return launches, dict(push_ms=push_ms, save_ms=ms_save, load_ms=ms_load,
                          size=size, b2_ms=ms_b2, b2_bound_ms=b_ms, frames=got,
                          counters=(sess.received, sess.wrong_crc,
                                    sess.wrong_size), **up)


# ---------------------------------------------------------------------------
# Phases 20-21: grids of several devices and the cluster
# ---------------------------------------------------------------------------

GRID_T_LOC = FLEET_BLOCK // 2   # phase 20's 2 x 2 session: two time shards
GROUP_ROWS = 4                  # fleet rows a channel of the grouped session
GROUP_CHANNELS = FLEET_STREAMS // GROUP_ROWS
CLUSTER_TIMEOUT = 300           # seconds a spawned rank may take

# one rank of phase 21's cluster: the port's CLI with its NMEA socket at
# argv[1]; its kernel launches written as JSON to argv[2]
RANK_MAIN = (
    "import functools, json, sys\n"
    "from gnuais_tpu_torch import cli\n"
    "from gnuais_tpu_torch.io import sinks\n"
    "from gnuais_tpu_torch.ops import fused\n"
    "cli.NmeaSocketServer = functools.partial(sinks.NmeaSocketServer, "
    "sys.argv[1])\n"
    "try:\n"
    "    rc = cli.main(sys.argv[3:])\n"
    "finally:\n"
    "    with open(sys.argv[2], 'w') as f:\n"
    "        json.dump({'B2': fused.pipeline_fused.launches,\n"
    "                   'B1': fused.pipeline_fused_compact.launches}, f)\n"
    "sys.exit(rc)\n")


def sync_all():
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def all_ms(fn):
    """One call of fn on the host clock, every card synchronised before
    and after, and its result."""
    sync_all()
    t0 = time.perf_counter()
    res = fn()
    sync_all()
    return (time.perf_counter() - t0) * 1e3, res


def smi_cards() -> list:
    """nvidia-smi's "name, power limit" of each card, by index."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()


def print_grid_cards(label: str, devices) -> None:
    """The cards a grid ran on, each on a line of its own: torch's name,
    and nvidia-smi's name and power limit."""
    import torch
    smi = smi_cards()
    for i in sorted({torch.device(d).index for d in devices}):
        n = sum(torch.device(d).index == i for d in devices)
        print(f"[20 grids] {label}: cuda:{i} ({n} shard{'s' * (n > 1)}) "
              f"{torch.cuda.get_device_name(i)}; nvidia-smi: "
              f"{smi[i] if i < len(smi) else 'not listed'}", flush=True)


def grouped_channels(blocks):
    """Phase 20's grouped input: channel c is fleet rows 4c..4c+3 of block
    0 and then of block 1 laid end to end, each rolled onto the free-
    running DPLL's grid at its position (``grid_offset``, as phase 18
    does): [1024, 8 x 49,152] int16, two grouped super-blocks a
    channel."""
    n = 2 * GROUP_ROWS
    x = np.empty((len(blocks[0]) // GROUP_ROWS, n * FLEET_BLOCK), np.int16)
    for j in range(n):
        rows = blocks[j // GROUP_ROWS][j % GROUP_ROWS::GROUP_ROWS]
        x[:, j * FLEET_BLOCK:(j + 1) * FLEET_BLOCK] = np.roll(
            rows, grid_offset(j * FLEET_BLOCK, DECODER_DELAY), axis=1)
    return x


def phase_grids(blocks, per_block, session):
    """Phase 20: the grids on the visible cards, each repeated round-robin
    to fill a grid.  ``dryrun_multichip(4)``; TimeParSession on a 2 x 2
    grid (4096 rows, super-blocks of 49,152, t_loc 24,576: kernel B2 at
    T = 31,744 on each shard) over the three fleet blocks, its frames and
    counters equal to phase 19's 1 x 1 session (``session``) stream by
    stream; GroupedTimeParSession on a 4 x 1 grid, 1024 channels of 4
    fleet rows end to end (``grouped_channels``; group 4, super-blocks of
    196,608 a channel), two pushes (the grouped step, then the row-padded
    flush), every channel's frames those of its rows in phase 4 at their
    rows' positions; make_sharded_decode on 4 shards over block 0, four
    calls, each against one decode_block, every leaf bitwise.  Returns
    (B2's launches, the times)."""
    import torch
    from gnuais_tpu_torch.dryrun import dryrun_multichip, round_robin
    from gnuais_tpu_torch.ops import fused
    from gnuais_tpu_torch.parallel import mesh as M
    from gnuais_tpu_torch.parallel.sharded import make_sharded_decode
    from gnuais_tpu_torch.parallel.timepar import (GroupedTimeParSession,
                                                   TimeParSession)
    from gnuais_tpu_torch.runtime.pipeline import (decode_block, init_carry,
                                                   extract_frames)
    n_cards = torch.cuda.device_count()
    devs = round_robin(4, "cuda")
    peers = {(i, j): torch.cuda.can_device_access_peer(i, j)
             for i in range(n_cards) for j in range(n_cards) if i != j}
    print(f"[20 grids] {n_cards} visible card(s); the grids' 4 shards on "
          f"{', '.join(map(str, devs))}; peer access "
          + (", ".join(f"{i}->{j} {'yes' if v else 'no'}"
                       for (i, j), v in peers.items()) or "n/a (one card)"),
          flush=True)
    print_grid_cards("every grid", devs)
    fused.pipeline_fused.launches = 0

    ms_dry, _ = all_ms(lambda: dryrun_multichip(4, "cuda", devices=devs))
    check(fused.pipeline_fused.launches == 8,
          f"the dry run launched B2 {fused.pipeline_fused.launches} times")
    print(f"[20 grids] dryrun_multichip(4): the 1-D step on 4 shards and "
          f"the 2 x 2 step with the frame across the first shard boundary, "
          f"payload bits byte-equal; {ms_dry:.0f} ms", flush=True)

    # TimeParSession on a 2 x 2 grid against phase 19's 1 x 1 session
    launches = fused.pipeline_fused.launches
    fused.pipeline_fused.launches = 0
    sess = TimeParSession(M.make_grid_mesh(2, 2, devices=devs),
                          FLEET_STREAMS, FLEET_BLOCK)
    got = [[] for _ in range(FLEET_STREAMS)]
    push_ms = []
    for x in list(blocks) + [None]:
        ms, out = all_ms(lambda: sess.push(x) if x is not None
                         else sess.flush())
        push_ms.append(ms)
        for i, lst in enumerate(out or []):
            got[i] += [f.payload_bits[:f.bufferlen].tobytes()
                       for _s, _e, f in lst]
    n_sess = fused.pipeline_fused.launches
    check(n_sess == 4 * len(blocks),
          f"the 2 x 2 session launched B2 {n_sess} times")
    check(got == session["frames"],
          "the 2 x 2 session's frames differ from phase 19's 1 x 1 session")
    check((sess.received, sess.wrong_crc, sess.wrong_size)
          == session["counters"], "the 2 x 2 session's counters differ")
    total = sum(map(len, got))
    print(f"[20 grids] TimeParSession(2 x 2, {FLEET_STREAMS} rows, "
          f"super-block {FLEET_BLOCK}, t_loc {GRID_T_LOC}: B2 at T = "
          f"{4096 + GRID_T_LOC + 3072}) over the {len(blocks)} fleet blocks: "
          f"{total} frames, stream by stream those of phase 19's 1 x 1 "
          f"session, counters equal; B2 launches {n_sess}; push "
          + ", ".join(f"{m:.1f}" for m in push_ms[:-1])
          + f" ms, flush {push_ms[-1]:.1f} ms (host clock, every card "
          f"synchronised; the first push holds its block); phase 19's "
          f"1 x 1 push " + ", ".join(f"{m:.1f}" for m in session["push_ms"][:-1])
          + " ms", flush=True)
    launches += n_sess

    # GroupedTimeParSession on a 4 x 1 grid: 1024 channels of 4 rows
    x = grouped_channels(blocks)
    sb = GROUP_ROWS * FLEET_BLOCK
    fused.pipeline_fused.launches = 0
    gs = GroupedTimeParSession(M.make_grid_mesh(4, 1, devices=devs),
                               GROUP_CHANNELS, GROUP_ROWS, FLEET_BLOCK)
    got_g = [[] for _ in range(GROUP_CHANNELS)]
    grouped_ms = []
    for k in range(x.shape[1] // sb):
        ms, out = all_ms(lambda: gs.push(x[:, k * sb:(k + 1) * sb]))
        grouped_ms.append(ms)
        for c, lst in enumerate(out or []):
            got_g[c] += lst
    ms, out = all_ms(gs.flush)
    grouped_ms.append(ms)
    for c, lst in enumerate(out):
        got_g[c] += lst
    n_grouped = fused.pipeline_fused.launches
    check(n_grouped == 4 + 4 * GROUP_ROWS,
          f"the grouped session launched B2 {n_grouped} times")
    del x
    frames_g = 0
    for c in range(GROUP_CHANNELS):
        want = [(j, p) for j in range(2 * GROUP_ROWS)
                for p in per_block[j // GROUP_ROWS][GROUP_ROWS * c
                                                    + j % GROUP_ROWS]]
        mine = [(st // FLEET_BLOCK, f.payload_bits[:f.bufferlen].tobytes())
                for st, _en, f in got_g[c]]
        check(mine == want, f"grouped channel {c}: {len(mine)} frames, "
              f"{len(want)} in its rows (phase 4), or at other rows")
        frames_g += len(mine)
    check((sum(gs.received), sum(gs.wrong_crc), sum(gs.wrong_size))
          == (frames_g, 0, 0), "the grouped session's counters")
    print(f"[20 grids] GroupedTimeParSession(4 x 1, {GROUP_CHANNELS} "
          f"channels x {GROUP_ROWS} row segments, super-block {sb} a "
          f"channel): 2 pushes of fleet rows end to end (rolled onto the "
          f"DPLL grid), {frames_g} frames, every channel's those of its "
          f"rows in phase 4 at their rows' positions; counters ({frames_g}, "
          f"0, 0); B2 launches {n_grouped}; grouped push "
          f"{grouped_ms[1]:.1f} ms, row-padded flush {grouped_ms[-1]:.1f} "
          f"ms ({GROUP_ROWS} steps)", flush=True)
    launches += n_grouped

    # make_sharded_decode on 4 shards against one decode_block
    flags = dict(frame_slots=FLEET_SLOTS, fused_pipeline=True,
                 device_crc=True)
    x0 = torch.from_numpy(blocks[0]).cuda()
    ref = decode_block(x0, FLEET_BLOCK, init_carry(FLEET_STREAMS, "cuda"),
                       **flags)
    fused.pipeline_fused.launches = 0
    step = make_sharded_decode(M.make_stream_mesh(4, devices=devs), **flags)
    # the first call pays each card's first use of the CRC filter's
    # product; the median of the next three is the step's time
    sd_ms = []
    for _ in range(4):
        ms, out = all_ms(lambda: step(x0, FLEET_BLOCK,
                                      init_carry(FLEET_STREAMS, "cuda")))
        sd_ms.append(ms)
        compare(out, ref, "make_sharded_decode on 4 shards vs decode_block")
    ms_sd = statistics.median(sd_ms[1:])
    n_sd = fused.pipeline_fused.launches
    check(n_sd == 4 * 4, f"the stream-sharded step launched B2 {n_sd} times")
    n_frames = sum(map(len, extract_frames(out[1])))
    print(f"[20 grids] make_sharded_decode(4 shards, {FLEET_STREAMS} "
          f"streams) over block 0, 4 calls: every carry and frame leaf "
          f"bitwise that of one decode_block ({n_frames} frames); "
          f"{ms_sd:.1f} ms (median of the last 3; the first "
          f"{sd_ms[0]:.1f} ms; host clock, every card synchronised); B2 "
          f"launches {n_sd}", flush=True)
    launches += n_sd
    return launches, dict(push_ms=push_ms, grouped_ms=grouped_ms,
                          sharded_ms=ms_sd, cards=n_cards,
                          peers=any(peers.values()))


def phase_cluster(tmp: Path, iq_mesh):
    """Phase 21: the command line on grids and across processes, on phase
    17's stereo IQ capture (``tmp/fleet.iq``).  ``meshshape 2 2`` and
    ``meshshape 4 1`` (the grouped session, 2 row segments a channel)
    through ``cli.main``: stdout and counters equal phase 17's
    ``meshshape 1 1`` run (``iq_mesh``: its stdout and counters); with
    fewer than 4 cards the CLI must refuse each with rc 1.  Then two
    spawned ranks, ``--cluster 127.0.0.1:<port> 2 <r>`` with ``meshshape
    2 1``, each on its own card where there are two (CUDA_VISIBLE_DEVICES)
    or both on card 0: rank 0's stdout equal to the 1 x 1 run's, rank 1's
    empty, both ranks' counters equal.  Returns (B2's launches, in this
    process and in the ranks, the times)."""
    import socket
    import torch
    from gnuais_tpu_torch.ops import fused
    n_cards = torch.cuda.device_count()
    path = tmp / "fleet.iq"
    check(path.exists(), "phase 17's IQ capture is gone")
    want_out, want_counters = iq_mesh
    launches, times = 0, {}
    for shape in ("2 2", "4 1"):
        conf = tmp / "grid.conf"
        conf.write_text(f"soundchannels both\ninputformat iq\n"
                        f"iqdecim {IQ_DECIM}\nmeshshape {shape}\n")
        fused.pipeline_fused.launches = 0
        rc, out, text, secs = cli_run(["-c", str(conf), "-l", str(path)],
                                      short_path(tmp / "grid.sock"))
        n = fused.pipeline_fused.launches
        if n_cards < 4:
            check(rc == 1 and out == "" and "needs 4 devices" in text,
                  f"meshshape {shape} on {n_cards} card(s): rc {rc}, "
                  f"{text[-300:]}")
            print(f"[21 cluster] cli meshshape {shape}: refused with rc 1 on "
                  f"{n_cards} card(s), as it must be: the run needs 4 cards "
                  f"({[l for l in text.splitlines() if 'needs' in l][0]})",
                  flush=True)
            continue
        check(rc == 0, f"meshshape {shape}: rc {rc}: {text[-500:]}")
        check(out == want_out, f"meshshape {shape}: stdout differs from "
              "phase 17's meshshape 1 1")
        check(cli_counters(text) == want_counters,
              f"meshshape {shape} counters {cli_counters(text)}")
        check(n > 0, f"meshshape {shape} launched no B2")
        launches += n
        times[shape] = secs
        print(f"[21 cluster] cli inputformat iq, meshshape {shape} on 4 "
              f"cards: stdout ({len(out.splitlines())} lines) and counters "
              f"{cli_counters(text)} those of phase 17's meshshape 1 1; B2 "
              f"launches {n}; {secs:.1f} s", flush=True)

    conf = tmp / "cluster.conf"
    conf.write_text(f"soundchannels both\ninputformat iq\n"
                    f"iqdecim {IQ_DECIM}\nmeshshape 2 1\n")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + ([os.environ["PYTHONPATH"]]
                       if os.environ.get("PYTHONPATH") else [])))
    procs = []
    t0 = time.perf_counter()
    for r in range(2):
        card = r if n_cards >= 2 else 0
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN, short_path(tmp / f"r{r}.sock"),
             str(tmp / f"rank{r}.json"), "-c", str(conf), "-l", str(path),
             "--cluster", f"127.0.0.1:{port}", "2", str(r)],
            env=dict(env, CUDA_VISIBLE_DEVICES=str(card)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(REPO)))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CLUSTER_TIMEOUT)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    secs = time.perf_counter() - t0
    for r, (rc, _out, err) in enumerate(outs):
        check(rc == 0, f"cluster rank {r}: rc {rc}: {err[-1500:]}")
        check(f"Cluster: process {r}/2" in err, f"rank {r} joined no cluster")
    check(outs[0][1] == want_out,
          "cluster rank 0's stdout differs from phase 17's meshshape 1 1")
    check(outs[1][1] == "", "cluster rank 1 wrote to stdout")
    c0, c1 = (cli_counters(o[2]) for o in outs)
    check(c0 == c1 == want_counters, f"cluster counters {c0}, {c1}")
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(2)]
    check(all(k["B2"] > 0 for k in ranks), f"rank launches {ranks}")
    launches += sum(k["B2"] for k in ranks)
    times["cluster_s"] = secs
    print(f"[21 cluster] two ranks, --cluster 127.0.0.1:{port} 2 <r>, "
          f"meshshape 2 1, "
          + ("each on its own card (CUDA_VISIBLE_DEVICES 0 and 1)"
             if n_cards >= 2 else "both on card 0")
          + f": rank 0's stdout ({len(outs[0][1].splitlines())} lines) that "
          f"of phase 17's meshshape 1 1, rank 1's empty, counters {c0} on "
          f"both; B2 launches rank 0 {ranks[0]['B2']}, rank 1 "
          f"{ranks[1]['B2']}; {secs:.1f} s for the pair (start-up "
          f"included)", flush=True)
    return launches, times


# ---------------------------------------------------------------------------
# Phase 22: kernel B2's other modes and the measurement tools
# ---------------------------------------------------------------------------

STRIP_VARIANTS = ("", "fir", "hdlc", "book", "shift", "snap", "flush")
STRIP_BLOCKS = 2           # diag_strip's K in phase 22
STRIP_MODES = ("vpu", "mxu")
SHARD_PAIRS = 16
LATENCY_CONFIGS = "1x1:4096 seq"
MAIN_PATH_CALLS = 3        # process() calls profiled in 22(e)


def candidate_frames(out, slots: int):
    """B2's candidates compacted into ``slots`` dense slots and drained
    on the host, CRC-checked (``pipeline.extract_frames``)."""
    import torch
    from gnuais_tpu_torch.ops import demod, fused
    from gnuais_tpu_torch.runtime.pipeline import extract_frames
    count, words, length, start, end, lost2, over, *_ = fused.compact_slots(
        out, slots)
    return extract_frames(demod.FrameBatch(
        words, length, start, end, count.clamp(max=slots), lost2,
        over + (count - slots).clamp(min=0), torch.zeros_like(count)))


def phase_prefiltered(x0, want0, carry0, b2_vpu):
    """22(a) Prefiltered B2 on fleet block 0 at full size: on the exact
    FIR of the block (fir.fir_exact), kernel against plain version on
    all 10 leaves, row-major and time-major, bitwise, the history handed
    back as it went in; its frames and DPLL/HDLC carry those of phase 6's
    B2 vpu on the raw block (``b2_vpu``), bitwise; on fir.fir_conv of the
    block, every stream's payloads the encoded ones.  Returns (the
    exact-FIR input, the fir_conv input, {max_abs_err, plain_ms})."""
    import torch
    from gnuais_tpu_torch.ops import fir, fused
    x = torch.from_numpy(x0).cuda()
    c = carry0
    filt, _ = fir.fir_exact(x, c.history)
    args = (filt, FLEET_BLOCK, c.history, c.dpll, c.hdlc)
    k = fused.pipeline_fused(*args, prefiltered=True)
    kt = fused.pipeline_fused(filt.t().contiguous(), *args[1:],
                              prefiltered=True, assume_full=True,
                              pretiled_streams=FLEET_STREAMS)
    plain_ms, p = host_ms(lambda: fused.pipeline_fused_reference(
        *args, prefiltered=True))
    err = max(compare(k, p, "prefiltered B2 vs plain"),
              compare(kt, p, "time-major prefiltered B2 vs plain"))
    check(k[7] is c.history and kt[7] is c.history,
          "prefiltered B2 did not hand the history back")
    compare(k[:7] + k[8:], b2_vpu[:7] + b2_vpu[8:],
            "prefiltered B2 on fir_exact vs B2 vpu on the raw block")
    conv, _ = fir.fir_conv(x, c.history)
    kc = fused.pipeline_fused(conv, *args[1:], prefiltered=True)
    n = check_payloads(candidate_frames(kc, FLEET_SLOTS), want0,
                       "prefiltered B2 on fir_conv")
    print(f"[22a prefiltered] B2 prefiltered on fir_exact of block 0 "
          f"({FLEET_STREAMS} x {FLEET_BLOCK} float32), row-major and "
          f"time-major: == plain on all {len(leaves(k))} leaves, the history "
          f"handed back; frames and carry == phase 6's B2 vpu on the raw "
          f"block, bitwise ({int(k[0].sum())} candidates); on fir_conv: all "
          f"{n} payloads equal the encoded ones; plain {plain_ms:.1f} ms",
          flush=True)
    return filt, conv, dict(max_abs_err=err, plain_ms=plain_ms)


def phase_strip_checks(x0, carry0):
    """22(d), first half: every strip variant of STRIP_VARIANTS in
    STRIP_MODES on fleet block 0 against the unstripped
    kernel, held by its invariant (``diag_strip.check_strip``; ``fir``
    against prefiltered B2 on the raw samples cast to float32)."""
    import torch
    from gnuais_tpu_torch import diag_strip
    from gnuais_tpu_torch.ops import fused
    x = torch.from_numpy(x0).cuda()
    c = carry0
    raw = x.to(torch.float32)
    for mode in STRIP_MODES:
        ref = fused.pipeline_fused(x, FLEET_BLOCK, c.history, c.dpll, c.hdlc,
                                   fir_mode=mode)
        for strip in STRIP_VARIANTS[1:]:
            out = fused.pipeline_fused(x, FLEET_BLOCK, c.history, c.dpll,
                                       c.hdlc, fir_mode=mode, strip=strip)
            rest = ",".join(f for f in strip.split(",") if f != "fir")
            fir_ref = fused.pipeline_fused(
                raw, FLEET_BLOCK, c.history, c.dpll, c.hdlc,
                prefiltered=True, strip=rest) if "fir" in strip else None
            diag_strip.check_strip(strip, out, ref, c, fir_ref)
    print(f"[22d strips] {', '.join(STRIP_VARIANTS[1:])} in "
          f"{', '.join(STRIP_MODES)} on block 0: each held by "
          f"its invariant (the DPLL carry; fir == prefiltered B2 on the raw "
          f"samples; the HDLC state; the counts)", flush=True)


def phase_fir_split(x0, conv, filt, carry0, card):
    """22(b) The FIR split on fleet block 0 (CUDA events, each a median of
    5 after a warm-up): fir_conv and prefiltered B2 on its output, fir_exact
    and prefiltered B2 on its output, beside B2 in every FIR mode.
    Returns the ms by name."""
    import torch
    from gnuais_tpu_torch.ops import fir, fused
    x = torch.from_numpy(x0).cuda()
    c = carry0
    args = (FLEET_BLOCK, c.history, c.dpll, c.hdlc)
    ms = {}
    ms["fir_conv"], _ = device_ms(lambda: fir.fir_conv(x, c.history))
    ms["fir_exact"], _ = device_ms(lambda: fir.fir_exact(x, c.history))
    ms["prefiltered"], _ = device_ms(lambda: fused.pipeline_fused(
        filt, *args, prefiltered=True))
    ms["prefiltered conv"], _ = device_ms(lambda: fused.pipeline_fused(
        conv, *args, prefiltered=True))
    for mode in fused.FIR_MODES:
        ms[mode], _ = device_ms(lambda: fused.pipeline_fused(
            x, *args, fir_mode=mode))
    print(f"[22b FIR split] block 0 ({FLEET_STREAMS} x {FLEET_BLOCK}), medians "
          f"of 5 by CUDA events: fir_conv {ms['fir_conv']:.3f} ms + B2 "
          f"prefiltered {ms['prefiltered conv']:.3f} ms = "
          f"{ms['fir_conv'] + ms['prefiltered conv']:.3f} ms; B2 prefiltered "
          f"on fir_exact {ms['prefiltered']:.3f} ms (fir_exact in torch ops "
          f"{ms['fir_exact']:.3f}); B2 vpu {ms['vpu']:.3f}, lobe "
          f"{ms['lobe']:.3f}, mxu {ms['mxu']:.3f}; {card}", flush=True)
    return ms


def phase_tools(tmp: Path, blocks, expected, card):
    """22(d), (e), (f), (g): the four tools on their paths.  (d)
    diag_strip's protocol at K = STRIP_BLOCKS for every strip variant in
    STRIP_MODES and on prefiltered input; (e) profile_flagship with 2
    traced dispatches, and its trace parser on MAIN_PATH_CALLS process()
    calls of the main path; (f) latency_bench on LATENCY_CONFIGS; (g)
    diag_shard with SHARD_PAIRS pairs.  Returns the measurements."""
    import torch
    from gnuais_tpu_torch import diag_shard, diag_strip, latency_bench
    from gnuais_tpu_torch import profile_flagship as pf
    from gnuais_tpu_torch.runtime.pipeline import BatchPipeline
    size = dict(n_streams=FLEET_STREAMS, block=FLEET_BLOCK, device="cuda")
    rows = []
    for mode in STRIP_MODES:
        for strip in STRIP_VARIANTS:
            r = diag_strip.run(strip, mode, STRIP_BLOCKS, **size)
            rows.append((mode, strip or "-", "raw", r))
    r = diag_strip.run("", "vpu", STRIP_BLOCKS, prefiltered=True, **size)
    rows.append(("none", "-", "filtered", r))
    print(f"[22d strips] diag_strip's protocol, K = {STRIP_BLOCKS} blocks of "
          f"{FLEET_STREAMS} x {FLEET_BLOCK}, 8 timed dispatches "
          f"(host clock, the count read back), {card}:", flush=True)
    print(f"  {'fir':<4} {'strip':<6} {'input':<8} {'median ms':>9} "
          f"{'best ms':>8} {'ns/step':>8} {'Gsamp/s':>8} counts", flush=True)
    for mode, strip, kind, r in rows:
        print(f"  {mode:<4} {strip:<6} {kind:<8} {r['median_ms']:>9.3f} "
              f"{r['best_ms']:>8.3f} {r['ns_step']:>8.2f} "
              f"{r['gsamp_s']:>8.2f} "
              f"{'checked' if r['checked'] else 'not checked'}", flush=True)

    # the tool as a user runs it, in a process of its own
    tool = subprocess.run(
        [sys.executable, "-m", "gnuais_tpu_torch.profile_flagship",
         "--iters", "2", "--streams", str(FLEET_STREAMS), "--block-len",
         str(FLEET_BLOCK), "--superblock", str(FLAGSHIP_COPIES), "--outdir",
         str(tmp / "profile_flagship"), "--device", "cuda"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    check(tool.returncode == 0, f"profile_flagship exited {tool.returncode}: "
                                f"{tool.stderr[-2000:]}")
    flag = pf.parse_trace(tmp / "profile_flagship" / "trace.json")
    b1 = sum(n for k, n in flag["count"].items() if "pipeline_kernel" in k)
    check(b1 == 2, f"the flagship trace holds {b1} B1 launches, not 2")
    print(f"[22e profile] python -m gnuais_tpu_torch.profile_flagship "
          f"--iters 2 (the flagship superblock, {FLAGSHIP_COPIES} x "
          f"{FLEET_BLOCK}, {FLEET_STREAMS} streams, pretiled, mxu, one B1 "
          f"launch a dispatch):\n" + tool.stdout.strip(), flush=True)
    pipe = BatchPipeline(FLEET_STREAMS, block_len=FLEET_BLOCK,
                         frame_slots=FLEET_SLOTS, fused_pipeline=True,
                         device_crc=True, device="cuda")
    warm = BatchPipeline(FLEET_STREAMS, block_len=FLEET_BLOCK,
                         frame_slots=FLEET_SLOTS, fused_pipeline=True,
                         device_crc=True, device="cuda")
    todo = iter(range(MAIN_PATH_CALLS))

    def process():
        b = next(todo)
        check_payloads(pipe.process(blocks[b]), expected[b],
                       f"profiled process() block {b}")

    main_prof, main_wall = pf.profile_window(
        process, MAIN_PATH_CALLS, tmp / "profile_main", torch.device("cuda"),
        warmup=lambda: check_payloads(warm.process(blocks[0]), expected[0],
                                      "warm-up process()"))
    b2 = sum(n for k, n in main_prof["count"].items()
             if "pipeline_kernel" in k)
    check(b2 == MAIN_PATH_CALLS, f"the main path's trace holds {b2} B2 "
                                 f"launches, not {MAIN_PATH_CALLS}")
    print(f"[22e profile] the main path, {MAIN_PATH_CALLS} process() calls "
          f"(B2, compaction, CRC, the host drain) in {main_wall:.1f} ms "
          f"under the profiler after a warm-up call; {card}\n"
          + pf.format_profile(main_prof, MAIN_PATH_CALLS, top=8), flush=True)

    lat = latency_bench.run(LATENCY_CONFIGS, device="cuda")
    print(f"[22f latency] latency_bench on the card (40 type-1 frames, fed "
          f"4096 samples at a time; p50/p90 in samples from frame end to "
          f"stdout line, the first 80 %), {card}:", flush=True)
    for r in lat:
        # the sequential station decodes every frame; a session's count is
        # printed as it is (a shared fault, ROADMAP section 3 item 8)
        check(r["config"] != "seq" or r["decoded"] == r["total"],
              f"the sequential station decoded {r['decoded']} of "
              f"{r['total']}")
        check(not r["refused"], f"latency config {r['config']} refused")
        print("  " + latency_bench.format_row(r), flush=True)

    shard = diag_shard.run(FLAGSHIP_COPIES, FLEET_STREAMS, SHARD_PAIRS,
                           FLEET_BLOCK, device="cuda")
    print(f"[22g shard] diag_shard, {SHARD_PAIRS} pairs of {FLAGSHIP_COPIES} "
          f"blocks x "
          f"{FLEET_STREAMS} streams (lobe, B2): direct "
          f"{diag_shard.stats(shard['direct_ms'], shard['samples'])}; "
          f"sharded on a one-shard mesh "
          f"{diag_shard.stats(shard['sharded_ms'], shard['samples'])}; "
          f"efficiency(med) {shard['efficiency']:.3f}, min-based "
          f"{shard['min_ratio']:.3f}; {card}", flush=True)
    return dict(strips=rows, flagship=flag, main=main_prof, latency=lat,
                shard=shard)


def phase_modes(tmp: Path, blocks, expected, carry0, full, card):
    """Phase 22: B2's prefiltered mode and strip variants against their
    references, the FIR split, then the tools on their paths with the
    counts of B2's modes set to 0 just before and read just after.
    Returns the kernels line's row of the prefiltered mode."""
    import torch
    from gnuais_tpu_torch.ops import _build, fused
    x0 = blocks[0]
    filt, conv, pre = phase_prefiltered(x0, expected[0], carry0,
                                        full["B2"]["out"])
    masks = [fused.strip_mask(s) for s in STRIP_VARIANTS[1:]]
    build_ms, _ = host_ms(lambda: _build.build_strips(masks))
    print(f"[22d strips] {len(masks)} strip libraries ({_build.STRIP_SOURCE}) "
          f"built in {build_ms / 1e3:.1f} s", flush=True)
    phase_strip_checks(x0, carry0)
    ms = phase_fir_split(x0, conv, filt, carry0, card)
    torch.cuda.synchronize()
    fused.pipeline_fused.mode_launches.clear()
    phase_tools(tmp, blocks, expected, card)
    launches = dict(fused.pipeline_fused.mode_launches)
    for key in ("prefiltered", "strip"):
        check(launches.get(key, 0) > 0,
              f"B2's {key} mode was not launched on the tools' paths")
    print(f"[22 modes] launches on the tools' paths: B2 prefiltered "
          f"{launches['prefiltered']}, strip variants {launches['strip']}",
          flush=True)
    out = fused.pipeline_fused(filt, FLEET_BLOCK, carry0.history, carry0.dpll,
                               carry0.hdlc, prefiltered=True)
    pre_bound = bound(((filt, carry0), out), 0)
    print(f"[22 modes] B2 prefiltered {ms['prefiltered']:.3f} ms (bound "
          f"{pre_bound[0]:.4f} ms by {pre_bound[1]}); {card}", flush=True)
    return dict(max_abs_err=pre["max_abs_err"], ms=ms["prefiltered"],
                plain_ms=pre["plain_ms"], bound_ms=pre_bound[0],
                bound_by=pre_bound[1], launches=launches["prefiltered"])


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
    err2, err1 = timed("3 parity", phase_parity)
    err2l, err1l = timed("3 parity lobe", phase_parity_lobe)
    err3, err4, err_h = timed("3 parity B3/B4/deframer", phase_parity_front)
    err2f, err1f, err3f, err4f, err_hf = timed("3 parity fixture",
                                               phase_parity_fixture)
    err2m, err1m = timed("3 parity mxu", phase_parity_mxu)
    edges = timed("3 parity edges", phase_parity_edges)
    err2, err1 = max(err2, edges["vpu"][0]), max(err1, edges["vpu"][1])
    err2l, err1l = max(err2l, edges["lobe"][0]), max(err1l, edges["lobe"][1])
    err2m, err1m = max(err2m, edges["mxu"][0]), max(err1m, edges["mxu"][1])
    # the plain versions of phases 3 (the lanes' and the session's
    # shapes), 18 and 19 run in CPU children after the timed phases
    child = PlainChild()
    timed("3 parity lanes", phase_parity_lanes_shapes, child)

    # the main path: BatchPipeline and the command line, kernel B2
    fused.pipeline_fused.launches = 0
    blocks, expected, carry0, carry1, block_s, main_result, per_block = \
        timed("4 main path", phase_main_path)
    timed("5 end to end", phase_end_to_end, "fused", "5 end to end")
    launches2 = fused.pipeline_fused.launches
    check(launches2 >= FLEET_BLOCKS, f"kernel B2 launched {launches2} times")
    print(f"[5 end to end] kernel B2 launches on the main path: {launches2}; "
          f"median full-size block process() {block_s * 1e3:.1f} ms on "
          f"{card}", flush=True)

    full = timed("6 full block", phase_full_block, blocks[0], carry0, carry1,
                 "vpu")
    full_lobe = timed("6 full block lobe", phase_full_block, blocks[0],
                      carry0, None, "lobe")
    full_mxu = timed("6 full block mxu", phase_full_mxu, blocks[0], carry0,
                     full["B1"]["out"])
    launches1, _, flagship_frames = timed("7 flagship", phase_flagship)
    lobe_launches = timed("8 lobe paths", phase_fir_paths, blocks, expected,
                          "lobe", "8 lobe paths")
    # Path M: the bench's mxu configurations and the mxu BatchPipeline
    fused.pipeline_fused.launches = fused.pipeline_fused_compact.launches = 0
    _, path_m_plain = timed("7m path M", phase_path_m, flagship_frames)
    timed("8m mxu paths", phase_fir_paths, blocks, expected, "mxu",
          "8m mxu paths")
    mxu_launches = {"B2": fused.pipeline_fused.launches,
                    "B1": fused.pipeline_fused_compact.launches}
    print(f"[8m mxu paths] launches on Path M and the mxu BatchPipeline: "
          f"B1 mxu {mxu_launches['B1']}, B2 mxu {mxu_launches['B2']}",
          flush=True)

    fused.frontend_fused.launches = fused.hdlc_fused.launches = 0
    timed("9 path S", phase_path_s, blocks, expected)
    launches3 = fused.frontend_fused.launches
    launches_h = fused.hdlc_fused.launches
    check(launches3 == PATH_S_BLOCKS and launches_h == PATH_S_BLOCKS,
          f"path S launched B3 {launches3} and the deframer {launches_h} "
          f"times for {PATH_S_BLOCKS} blocks")
    print(f"[9 path S] launches on path S: kernel B3 {launches3}, the "
          f"deframer kernel {launches_h}", flush=True)

    front3, front4, front_hg, front_hs = timed(
        "10 full block B3/B4/deframer", phase_front_full, blocks[0])
    timed("11 superblock", phase_superblock, blocks, main_result, block_s)

    fused.dpll_fused.launches = fused.hdlc_fused.launches = 0
    timed("12 path F", phase_end_to_end, "fast", "12 path F")
    timed("12 path F exact", phase_end_to_end, "exact", "12 path F exact")
    launches4 = fused.dpll_fused.launches
    check(launches4 > 0 and fused.hdlc_fused.launches == launches4,
          f"path F and the exact backend launched B4 {launches4} and the "
          f"deframer {fused.hdlc_fused.launches} times")
    launches_hs = fused.hdlc_fused.launches
    print(f"[12 path F] launches on path F and the exact backend: kernel B4 "
          f"{launches4}, the deframer kernel {fused.hdlc_fused.launches}",
          flush=True)

    timed("13 probe", phase_probe, blocks[0])
    roof, roof_launches = timed(
        "14 path R", phase_path_r,
        {"B1 vpu": full["B1"]["pretiled_ms"],
         "B1 mxu": full_mxu["B1"]["pretiled_ms"]})
    err_m = timed("7m path M against plain", path_m_plain)

    # the station path and the supervised fleet (after Path M's child
    # process has ended, so that the host's cores are the CLI's)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        station, station_times = timed("15 station", phase_station,
                                       Path(tmp))
        sup_launches, sup = timed("16 supervised", phase_supervised,
                                  Path(tmp), blocks, per_block,
                                  main_result[1])
        # the throughput modes, each with its counts set to 0 before it
        # and read after it
        iq_launches, iq_times = timed("17 iq", phase_iq, Path(tmp), blocks,
                                      expected)
        lane_launches, lane_b2, lane_times = timed(
            "18 lanes", phase_lanes, Path(tmp), blocks, expected, child)
        ses_launches, ses_times = timed("19 session", phase_session,
                                        Path(tmp), blocks, per_block, child)
        # grids of several devices and the cluster, each count set to 0
        # just before its path and read after it
        grid_launches, grid_times = timed("20 grids", phase_grids, blocks,
                                          per_block, ses_times)
        cl_launches, cl_times = timed("21 cluster", phase_cluster,
                                      Path(tmp), iq_times["mesh"])
        # B2's other modes and the measurement tools, their counts set to
        # 0 just before the tools' paths and read after them
        modes = timed("22 kernel modes and tools", phase_modes, Path(tmp),
                      blocks, expected, carry0, full, card)
    launches2 += station["B2"] + sup_launches
    launches4 += station["B4"]
    launches_hs += station["deframer"]
    print(f"[16 supervised] on {card}: station real-time factors of the "
          f"block loop over {STATION_RUNS} runs (set-up; process_block "
          "median) "
          + ", ".join(f"{b} " + "/".join(f"{t['rtf']:.2f}" for t in ts)
                      + "x (" + "/".join(f"{t['setup_ms']:.0f}" for t in ts)
                      + " ms; " + "/".join(f"{t['block_ms']:.3f}" for t in ts)
                      + " ms)" for b, ts in station_times.items())
          + f"; recovery {sup['recovery_ms']:.1f} ms (a block "
          f"{sup['block_ms']:.1f} ms); checkpoint write {sup['save_ms']:.2f} "
          f"ms, read {sup['load_ms']:.2f} ms; launches with phases 15-16: "
          f"B2 {launches2}, B4 {launches4}, the deframer on sample codes "
          f"{launches_hs}", flush=True)
    err_child = timed("3, 18, 19 against plain", child.held)
    launches2 += iq_launches["B2"] + lane_b2 + ses_launches
    launches1 += iq_launches["B1"] + lane_launches
    lanes_full = lane_times[f"{FLEET_STREAMS} rows"]
    print(f"[19 session] on {card}: the IQ front end "
          f"{iq_times['front_end_ms']:.2f} ms a {IQ_BLOCK}-frame block; the "
          f"lanes over {FLEET_STREAMS} rows: gather "
          f"{lanes_full['gather_ms']:.1f} ms, B1 "
          f"{lanes_full['decode_ms']:.1f} ms, drain "
          f"{lanes_full['drain_ms']:.1f} ms; the CLI's streams "
          f"{FLEET_STREAMS} {lane_times['cli_s']:.1f} s; the session "
          f"{statistics.median(ses_times['push_ms'][1:-1]):.1f} ms a push; "
          f"launches with phases 17-19: B2 {launches2}, B1 {launches1}",
          flush=True)
    launches2 += grid_launches + cl_launches
    print(f"[21 cluster] on {card} ({grid_times['cards']} visible): the 2 x "
          f"2 session {statistics.median(grid_times['push_ms'][1:-1]):.1f} "
          f"ms a push beside the 1 x 1 session's "
          f"{statistics.median(ses_times['push_ms'][1:-1]):.1f}; the grouped "
          f"4 x 1 push {grid_times['grouped_ms'][1]:.1f} ms; the stream-"
          f"sharded step {grid_times['sharded_ms']:.1f} ms; the cluster pair "
          f"{cl_times['cluster_s']:.1f} s; B2 launches with phases 20-21 "
          f"{launches2}", flush=True)

    loaded = sorted(m for m in sys.modules
                    if m in ("jax", "gnuais_tpu")
                    or m.startswith(("jax.", "jaxlib", "gnuais_tpu.")))
    check(not loaded, f"JAX or the JAX package was imported: {loaded[:5]}")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    src = "gnuais_tpu_torch/csrc/"
    rows = [
        ("pipeline_fused", "pipeline_fused.cu", "gnuais_tpu/ops/fused.py:1031",
         launches2, full["B2"], max(err2, err2f, err_child.get("B2", 0.0))),
        ("pipeline_fused_lobe", "pipeline_fused.cu",
         "gnuais_tpu/ops/fused.py:1031", lobe_launches["B2"],
         full_lobe["B2"], err2l),
        ("pipeline_compact", "pipeline_compact.cu",
         "gnuais_tpu/ops/fused.py:1261", launches1, full["B1"],
         max(err1, err1f, err_child.get("B1", 0.0))),
        ("pipeline_compact_lobe", "pipeline_compact.cu",
         "gnuais_tpu/ops/fused.py:1261", lobe_launches["B1"],
         full_lobe["B1"], err1l),
        ("frontend", "frontend.cu", "gnuais_tpu/ops/fused.py:346", launches3,
         front3, max(err3, err3f)),
        ("dpll", "dpll.cu", "gnuais_tpu/ops/fused.py:129", launches4, front4,
         max(err4, err4f)),
        ("hdlc_scan", "hdlc.cu", "gnuais_tpu/ops/demod.py:213", launches_h,
         front_hg, max(err_h["group"], err_hf["group"])),
        ("hdlc_scan_sample", "hdlc.cu", "gnuais_tpu/ops/demod.py:213",
         launches_hs, front_hs, max(err_h["sample"], err_hf["sample"])),
        ("pipeline_fused_mxu", "pipeline_fused.cu",
         "gnuais_tpu/ops/fused.py:1031", mxu_launches["B2"], full_mxu["B2"],
         max(err2m, err_m["B2"])),
        ("pipeline_compact_mxu", "pipeline_compact.cu",
         "gnuais_tpu/ops/fused.py:1261", mxu_launches["B1"], full_mxu["B1"],
         max(err1m, err_m["B1"])),
        ("roofline_chain", "roofline.cu", "tools/roofline.py:52",
         roof_launches["R1"], roof["R1"], 0.0),
        ("roofline_stream", "roofline.cu", "tools/roofline.py:148",
         roof_launches["R2"], roof["R2"], 0.0),
        ("pipeline_fused_prefiltered", "pipeline_fused.cu",
         "gnuais_tpu/ops/fused.py:1031", modes["launches"], modes, 0.0),
    ]
    kernels = []
    for kname, source, replaces, launches, m, err in rows:
        kernels.append({
            "name": kname, "route": "cuda", "source": src + source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(err, m["max_abs_err"]), "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"{card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
