"""Raw-IQ archive re-decode: the archive cell (``archive.py``) with every
channel kept as complex baseband I/Q, float32, at 48 kHz x ``iq_decim``,
through the CLI's ``--batch`` path with ``inputformat iq``:
``runtime.batch.BatchSession(iq=True)`` stages each block's I and Q
rails, uploads them, FM-demodulates them on the device
(``ops.discriminator``) and hands the int16 audio to ``BatchPipeline``
there; one block a call, blocks back to back (a closed loop).

Set-up makes the traffic's int16 audio from the seed (the cell's
generator), then its I/Q on the device, a chunk of streams at a time,
into pageable host memory (``modulate``): the audio sample-held x
``iq_decim``, the traffic's level mapped to the configuration's peak
deviation, phase-integrated in float64 at unit amplitude, with a carrier
offset a stream (under 1 Hz) that closes the phase over the 5-block
cycle, so that the recording repeats without a seam.  It builds the
session and warms the front end's pieces and the step.  The window,
``realtime_channels``, ``attempted``, ``failed`` and the run's log are
the archive cell's; a program whose ``BatchSession`` takes no IQ fails
at once, before any traffic is made.

After the window (each number's limit beside it, ``correct`` needs all):

- ``frontend`` and ``frontend_1lsb``: the program's audio of the sampled
  streams, read on the device after each block of the window, against
  the plain reference front end's (``reference.iq``) on the same I/Q:
  the samples that differ by more than 1 LSB (limit 0) and those that
  differ by 1 (limit one in 1000 of the samples compared).  A float32
  ``atan2`` or a 64-term sum that rounds in another order can move a
  value across a half, and so by 1 LSB; a 16-bit front end, or a tap
  dropped, moves many by more.
- ``delivery``, ``counters`` and ``reference``: ``checks.tally``'s and
  ``checks.against_reference``'s, with the plain reference decoder run
  on the reference front end's audio.  A stream's front end starts cold,
  so its first cycle's audio differs from the later ones' in its first
  samples (``plain_decode_from``).
"""

from __future__ import annotations

import copy
import inspect
import math
import statistics
import time
from contextlib import nullcontext

import numpy as np
import torch

from .. import annotations, checks, faults, iqwork
from .. import trace as tr
from ..reference import iq as ref_iq
from ..reference.chain import PlainReceiver
from ..run import log
from .archive import _instrument

FRONTEND = "gnuais.iq.frontend"
# a 16-bit float front end, for the tests of the ``frontend`` check: the
# program's float audio rounded through it before the int16 rounding
ROUNDED = {"bf16": torch.bfloat16, "fp16": torch.float16}


def modulate(samples: np.ndarray, level: float, deviation_hz: float,
             decim: int, device: torch.device, rows: int = 256):
    """int16 audio [S, C] at 48 kHz, one cycle a stream -> its I/Q rails,
    float32 [2, S, C x decim] in pageable host memory, and each stream's
    carrier offset in Hz.  ``level`` maps to ``deviation_hz``."""
    s, c = samples.shape
    fs = 48_000 * decim
    out = np.empty((2, s, c * decim), np.float32)
    offsets = np.empty(s)
    # each chunk comes back through one page-locked buffer (a DMA), then
    # one host copy into the recording
    bounce = torch.empty((2, min(rows, s), c * decim), dtype=torch.float32,
                         pin_memory=device.type == "cuda")
    for r0 in range(0, s, rows):
        r1 = min(r0 + rows, s)
        a = torch.from_numpy(samples[r0:r1]).to(device, torch.float64)
        step = (2 * math.pi * deviation_hz / level / fs) * a
        turns = step.sum(dim=1) * decim / (2 * math.pi)
        close = -(turns - torch.round(turns)) * 2 * math.pi / (c * decim)
        phase = torch.cumsum(step.repeat_interleave(decim, dim=1)
                             + close[:, None], dim=1)
        # the last sample at phase 0: the next cycle's first follows it
        # by its own step
        phase -= phase[:, -1:].clone()
        bounce[0, :r1 - r0] = torch.cos(phase).to(torch.float32)
        bounce[1, :r1 - r0] = torch.sin(phase).to(torch.float32)
        out[:, r0:r1] = bounce[:, :r1 - r0].numpy()
        offsets[r0:r1] = (close * fs / (2 * math.pi)).cpu().numpy()
        del a, step, phase
    return out, offsets


def reference_audio(iq: np.ndarray, rows, decim: int, device):
    """The plain reference front end's audio of streams ``rows`` of the
    recording ``iq`` (one cycle a stream, repeated): its first cycle,
    from the cold start, and every later one, int16 [len(rows), C] each
    on ``device``."""
    i = torch.from_numpy(iq[0, rows]).to(device)
    q = torch.from_numpy(iq[1, rows]).to(device)
    first, state = ref_iq.frontend(i, q, ref_iq.start(len(rows), device),
                                   decim)
    later, _ = ref_iq.frontend(i, q, state, decim)
    return first, later


def plain_decode_from(first: np.ndarray, cycle: np.ndarray, total: int):
    """``checks.plain_decode`` of a stream that plays ``first`` once and
    then repeats ``cycle`` (of the same length, equal to it past its
    first samples); the repeat shortcut holds from the second cycle on."""
    n = len(cycle)
    full, rem = divmod(total, n)
    rx = PlainReceiver()
    seen = {}
    snaps, frames, counts = [], [], []
    steady = None
    for c in range(full):
        before = rx.counters
        if c == 1:
            steady = rx.fir.run(cycle)
        frames.append(rx.run_block(first if c == 0 else cycle, steady))
        counts.append(tuple(a - b for a, b in zip(rx.counters, before)))
        snaps.append(copy.deepcopy(rx))
        key = rx.state()
        if key in seen:
            start = seen[key] + 1
            period = c + 1 - start
            break
        seen[key] = c
    else:
        start, period = len(frames), 0
    out = [f for fs in frames for f in fs]
    counters = np.sum(counts, axis=0, dtype=np.int64) if counts else \
        np.zeros(3, np.int64)
    last = len(frames) - 1
    for c in range(len(frames), full):
        k = start + (c - start) % period
        out += [(e + (c - k) * n, fr) for e, fr in frames[k]]
        counters = counters + counts[k]
        last = k
    if rem:
        rx = copy.deepcopy(snaps[last]) if full else PlainReceiver()
        rx.position = full * n
        before = rx.counters
        out += rx.run_block((cycle if full else first)[:rem],
                            None if steady is None else steady[:rem])
        counters = counters + np.subtract(rx.counters, before)
    return out, tuple(int(v) for v in counters)


def tally(traffic, decode, delivered, blocks, counters, end: int,
          block_len: int, free: int, budget: float, rng) -> dict:
    """``checks.tally``, a stream that falls short judged against
    ``decode(i, cut)``: the plain reference's (frames, counters) over
    the first ``cut`` samples of stream i's own audio."""
    cycle = traffic.cycle
    attempted = failed = bad_counters = lost = 0
    short = []
    for i in range(len(delivered)):
        expected = traffic.frames(i, end)
        damaged = traffic.frames(i, end, damaged=True)
        d = checks.stream_delivery(delivered[i], blocks[i], expected,
                                   damaged, counters[i], end, block_len)
        if not d["counters_ok"]:
            short.append((i, end, expected, damaged, d))
        elif d["missed"]:
            at = (free + int(traffic.shift[i])) % cycle
            reach = max(2 * cycle, max(expected[k][1] for k in d["missed"])
                        + checks.GUARD)
            cut = min(end, at + -(-(reach - at) // cycle) * cycle)
            short.append((i, cut, expected, damaged, d))
        else:
            attempted += d["due"]
            failed += d["extra"]
    unjudged = 0
    for k in rng.permutation(len(short)).tolist():
        i, cut, expected, damaged, d = short[k]
        if cut / cycle <= budget:
            budget -= cut / cycle
            ref, ref_counters = decode(i, cut)
            want = [(e - 1, e - 1, fr.payload_bits[:fr.bufferlen])
                    for e, fr in ref]
            want += [e for e in expected if e[0] >= cut]
            d = checks.stream_delivery(
                delivered[i], blocks[i], want,
                [e for e in damaged if e[0] >= cut], counters[i], end,
                block_len, ref_counters[1:])
            lost += sum(1 for e in expected if e[0] < cut) - len(ref)
        else:
            unjudged += 1
        attempted += d["due"]
        failed += len(d["missed"]) + d["extra"]
        bad_counters += int(not d["counters_ok"])
    return {"attempted": attempted, "failed": failed,
            "counters": bad_counters, "lost_by_both": lost,
            "short": len(short), "unjudged": unjudged}


def run(cell, generator, seed, seconds, trace, device, fault, t_start):
    from gnuais_tpu_torch.runtime import batch
    from gnuais_tpu_torch.runtime import pipeline as pl
    if "iq" not in inspect.signature(batch.BatchSession).parameters:
        raise RuntimeError("this program's BatchSession takes no IQ "
                           "streams")
    from gnuais_tpu_torch.ops import discriminator as disc

    cfg = cell.config
    n, bl, d = cfg["streams"], cfg["block_len"], cfg["iq_decim"]
    t_gen = time.perf_counter()
    traffic = generator.build(cell.traffic, n, seed, device)
    if traffic.cycle % bl:
        raise ValueError(f"a {traffic.cycle}-sample cycle is no whole "
                         f"number of {bl}-sample blocks")
    iq, offsets = modulate(traffic.samples, cell.traffic["amplitude"],
                           cfg["peak_deviation_hz"], d, device)
    log(f"traffic made in {time.perf_counter() - t_gen:.3f} s: "
        f"{iq.nbytes} bytes of I/Q, carrier offsets within "
        f"{np.abs(offsets).max():.4f} Hz")
    per_cycle = traffic.cycle // bl
    names = [f"s{i}" for i in range(n)]
    rng = np.random.default_rng([seed, 0xC4EC])
    sample = sorted(rng.choice(n, min(n, cfg["reference_streams"]),
                               replace=False).tolist())
    delivered = [[] for _ in range(n)]
    when = [[] for _ in range(n)]
    whole = set(sample)
    now = [0]

    def on_message(i, m):
        delivered[i].append(m if i in whole else (m.bufferlen,
                                                  m.payload_bits))
        when[i].append(now[0])

    sess = batch.BatchSession(names, block_len=bl,
                              frame_slots=cfg["frame_slots"],
                              backend=cfg["backend"], device=device,
                              message_callback=on_message, iq=True,
                              decim=d)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    spans = tr.Spans(sync) if trace else None
    undo = _instrument(sess, spans, device, pl) if trace else (lambda: None)
    front = disc.iq_frontend
    if fault in ROUNDED:
        def rounded(*args, **kwargs):
            audio, state = front(*args, **kwargs)
            return audio.to(ROUNDED[fault]).to(torch.float32), state
        disc.iq_frontend = rounded
    elif fault == "stale":
        sess.pipe.step = faults.stale_state(sess.pipe, ("carry",),
                                            sess.pipe.step)
    elif fault:
        sess.pipe.drain = faults.output_fault(fault, sess.pipe.drain)
    lines, last, rows = [], {}, []
    picked = torch.tensor(sample, device=device)
    span = bl * d

    def block(b):
        now[0] = b
        off = (b % per_cycle) * span
        res = sess.run([(iq[0, i, off:off + span], iq[1, i, off:off + span])
                        for i in range(n)])
        rows.append(sess.audio.index_select(0, picked))
        lines.extend(res.lines)
        last["counters"] = res.counters

    try:
        # set-up: the front end's kernels at its piece's shape, the
        # allocator's block for the rails, and every kernel and shape of
        # the step and the native drain on a pipeline of the session's
        # own configuration; the session starts the streams in the window
        piece = min(getattr(batch, "IQ_CHUNK", span), span)
        z = torch.zeros((n, piece), device=device)
        disc.iq_to_int16_audio(z, z, disc.init_iq(n, ref_iq.NTAPS, device),
                               sess.taps, d)
        del z
        rails = torch.empty((2, n, span), device=device)
        del rails
        warm = pl.BatchPipeline(n, block_len=bl,
                                frame_slots=cfg["frame_slots"],
                                device=device,
                                **batch.BACKENDS[cfg["backend"]])
        warm.process(torch.from_numpy(traffic.samples[:, :bl]).to(device))
        del warm
        sync()
        if spans:
            spans.units.clear()
            spans.current.clear()
        profile = {}
        pauses = tr.GcPauses()
        host = tr.HostShare()
        with annotations.profiled(device, profile, (FRONTEND,)) if trace \
                else nullcontext(), pauses, host:
            t0, c0 = time.perf_counter(), time.process_time()
            m0 = time.thread_time()
            blocks, t_end, c_end, stamps, cpu = 0, t0, c0, [], []
            while time.perf_counter() - t0 < seconds:
                block(blocks)
                blocks += 1
                stamps.append(time.perf_counter() - t_end)
                cpu.append(time.process_time() - c_end)
                t_end, c_end = time.perf_counter(), time.process_time()
                if spans:
                    spans.close_unit()
            m_end = time.thread_time()
    finally:
        undo()
        disc.iq_frontend = front
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    del sess
    if device.type == "cuda":
        torch.cuda.empty_cache()

    for clock, times, total in (("", stamps, t_end - t0),
                                ("CPU ", cpu, c_end - c0)):
        q = statistics.quantiles(times, n=4) if len(times) > 1 else [0] * 3
        log(f"window, {clock}seconds: {blocks} blocks in {total:.3f}; a "
            f"block {', '.join(f'{s:.3f}' for s in times)}; median "
            f"{q[1]:.3f}, quartiles "
            f"{100 * (q[2] - q[0]) / q[1] if q[1] else 0:.1f} % apart")
    log(f"window: the main thread's CPU {m_end - m0:.3f} s; {pauses}; "
        f"{host}")
    t_ref = time.perf_counter()
    end = blocks * bl
    first, later = reference_audio(iq, sample, d, device)
    over = at_one = compared = 0
    for b, got in enumerate(rows):
        pos = b * bl
        src = first if pos < traffic.cycle else later
        want = src[:, pos % traffic.cycle:pos % traffic.cycle + bl]
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        over += int((diff > 1).sum())
        at_one += int((diff == 1).sum())
        compared += diff.numel()
    first, later = first.cpu().numpy(), later.cpu().numpy()
    counters = last["counters"]

    def decode(i, cut):
        f, c = reference_audio(iq, [i], d, device)
        return plain_decode_from(f[0].cpu().numpy(), c[0].cpu().numpy(), cut)

    t = tally(traffic, decode, delivered, when,
              [counters[name] for name in names], end, bl,
              (cell.traffic["cycle_slots"] - 1) * cell.traffic["slot_bits"]
              * cell.traffic["samples_per_bit"], cfg["reference_cycles"],
              rng)
    printed = {i: [] for i in sample}
    tags = {f"[{names[i]}] ": i for i in sample}
    for line in lines:
        i = tags.get(line[:line.find("]") + 2])
        if i is not None:
            printed[i].append(line)
    ref = 0
    for k, i in enumerate(sample):
        frames, ref_counters = plain_decode_from(first[k], later[k], end)
        ref += checks.against_reference(
            delivered[i], printed[i], counters[names[i]], frames,
            ref_counters, "A", end, prefix=f"[{names[i]}] ")
    log(f"checked in {time.perf_counter() - t_ref:.3f} s: front end "
        f"{compared} samples compared, {at_one} off by 1, {over} by more; "
        f"{t['short']} streams fell short, {t['unjudged']} of them past "
        f"the reference's budget; frames lost by both the program and the "
        f"reference: {t['lost_by_both']}")
    ctx = {"setup_s": t0 - t_start, "window_s": t_end - t0,
           "blocks": blocks, "streams": n, "block_len": bl,
           "spans": spans, "profile": profile if trace else None,
           "gc_s": pauses.seconds,
           "frontend_bound_ms": blocks * iqwork.frontend_bound_ms(n, span,
                                                                  d)}
    return {"ctx": ctx, "attempted": t["attempted"], "failed": t["failed"],
            "checks": {"delivery": (t["failed"], 0),
                       "counters": (t["counters"], 0),
                       "reference": (ref, 0),
                       "frontend": (over, 0),
                       "frontend_1lsb": (at_one, compared // 1000)},
            "device_kind": kind, "memory_peak_bytes": peak}
