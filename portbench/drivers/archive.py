"""Archive re-decode: many recorded mono channels through the CLI's
``--batch`` path, ``runtime.batch.BatchSession`` over ``BatchPipeline``,
one block a call, blocks back to back (a closed loop).

Set-up makes the configuration's streams from the seed, builds the
session, and decodes their first block once on a pipeline of the same
configuration (every kernel, shape and the native drain warm).  The
window then decodes the streams from their start, block after block of
the traffic's cycle (the streams repeat it without a seam), while it
lasts; the block running at the deadline is finished and counted.
``realtime_channels`` is the channels' samples of every block decoded in
the window over 48,000 and over the window.  After the window,
``attempted`` is the frames due that the plain reference decodes and
``failed`` the ones of them that the program did not deliver, with its
messages that match no frame (``checks.tally``); the frames that both
lose after a stream's idle cold start are logged apart.  Every run logs
the blocks' times on the host's clock and in the process's CPU seconds,
the garbage collector's time, and the host's steal time and the
process's involuntary context switches: whether a slow window was time
the host took away or a slower CPU.

A traced run wraps the program's layers: ``BatchSession.run`` (a block),
``pipeline._upload`` (synchronised after), ``BatchPipeline.step``
(synchronised after; CUDA events around it), ``BatchPipeline.drain``,
each stream's ``ChannelDispatcher.dispatch``, and kernel B2's calls (its
bound from their shapes), under ``torch.profiler``.
"""

from __future__ import annotations

import statistics
import time
from contextlib import nullcontext

import numpy as np
import torch

from .. import card, checks, faults
from .. import trace as tr
from ..run import log


def _instrument(sess, spans: tr.Spans, device, pl):
    """Wrap the program's layers of ``sess`` for a traced run; returns a
    function that undoes the module-level wraps."""
    sess.run = spans.wrap(sess.run, "session", mark=True)
    orig_upload, orig_b2 = pl._upload, pl.pipeline_fused
    pl._upload = spans.wrap(orig_upload, "upload", sync=True, mark=True)
    pipe = sess.pipe
    step = pipe.step

    def timed_step(*args, **kwargs):
        if device.type != "cuda":
            return step(*args, **kwargs)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step(*args, **kwargs)
        e1.record()
        e1.synchronize()
        spans.add("step_device", e0.elapsed_time(e1))
        return out

    pipe.step = spans.wrap(timed_step, "step", sync=True, mark=True)
    pipe.drain = spans.wrap(pipe.drain, "drain", mark=True)
    for d in sess.disp:
        d.dispatch = spans.wrap(d.dispatch, "dispatch")

    def b2(samples, n_valid, history, dpll, hdlc, **kw):
        out = orig_b2(samples, n_valid, history, dpll, hdlc, **kw)
        if device.type == "cuda":
            spans.add("b2_bound_ms", card.b2_bound_ms(
                samples, n_valid, (history, dpll, hdlc), out))
        return out

    pl.pipeline_fused = b2

    def undo():
        pl._upload, pl.pipeline_fused = orig_upload, orig_b2
    return undo


def run(cell, generator, seed, seconds, trace, device, fault, t_start):
    from gnuais_tpu_torch.runtime import pipeline as pl
    from gnuais_tpu_torch.runtime.batch import BACKENDS, BatchSession

    cfg = cell.config
    n, bl = cfg["streams"], cfg["block_len"]
    t_gen = time.perf_counter()
    traffic = generator.build(cell.traffic, n, seed, device)
    log(f"traffic made in {time.perf_counter() - t_gen:.3f} s")
    if traffic.cycle % bl:
        raise ValueError(f"a {traffic.cycle}-sample cycle is no whole "
                         f"number of {bl}-sample blocks")
    per_cycle = traffic.cycle // bl
    names = [f"s{i}" for i in range(n)]
    rng = np.random.default_rng([seed, 0xC4EC])
    sample = sorted(rng.choice(n, min(n, cfg["reference_streams"]),
                               replace=False).tolist())
    # each message with the block in whose call it came; the sampled
    # streams keep the whole message, the others its bits alone, so that
    # the harness holds no more of the program's objects than a run of
    # the CLI does
    delivered = [[] for _ in range(n)]
    when = [[] for _ in range(n)]
    whole = set(sample)
    now = [0]

    def on_message(i, m):
        delivered[i].append(m if i in whole else (m.bufferlen,
                                                  m.payload_bits))
        when[i].append(now[0])

    sess = BatchSession(names, block_len=bl, frame_slots=cfg["frame_slots"],
                        backend=cfg["backend"], device=device,
                        message_callback=on_message)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    spans = tr.Spans(sync) if trace else None
    undo = _instrument(sess, spans, device, pl) if trace else (lambda: None)
    if fault == "stale":
        sess.pipe.step = faults.stale_state(sess.pipe, ("carry",),
                                            sess.pipe.step)
    elif fault:
        sess.pipe.drain = faults.output_fault(fault, sess.pipe.drain)
    lines, last = [], {}

    def block(b):
        now[0] = b
        off = (b % per_cycle) * bl
        res = sess.run([traffic.samples[i, off:off + bl] for i in range(n)])
        lines.extend(res.lines)
        last["counters"] = res.counters

    try:
        # set-up: every kernel and shape of the step and the native drain,
        # on a pipeline of the session's own configuration; the session
        # starts the stream in the window
        warm = pl.BatchPipeline(n, block_len=bl,
                                frame_slots=cfg["frame_slots"],
                                device=device, **BACKENDS[cfg["backend"]])
        warm.process(traffic.samples[:, :bl])
        del warm
        sync()
        if spans:
            spans.units.clear()
            spans.current.clear()
        profile = {}
        pauses = tr.GcPauses()
        host = tr.HostShare()
        with tr.profiled(device, profile) if trace else nullcontext(), \
                pauses, host:
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
    counters = last["counters"]
    # the last slot of each schedule is free; the streams that fell short
    # are judged against the plain reference in an order drawn from the
    # seed
    t = checks.tally(traffic, delivered, when,
                     [counters[name] for name in names], end, bl,
                     (cell.traffic["cycle_slots"] - 1)
                     * cell.traffic["slot_bits"]
                     * cell.traffic["samples_per_bit"],
                     cfg["reference_cycles"], rng)
    printed = {i: [] for i in sample}
    tags = {f"[{names[i]}] ": i for i in sample}
    for line in lines:
        i = tags.get(line[:line.find("]") + 2])
        if i is not None:
            printed[i].append(line)
    ref = 0
    for i in sample:
        frames, ref_counters = checks.plain_decode(traffic.samples[i], end)
        ref += checks.against_reference(
            delivered[i], printed[i], counters[names[i]], frames,
            ref_counters, "A", end, prefix=f"[{names[i]}] ")
    log(f"checked in {time.perf_counter() - t_ref:.3f} s: {t['short']} "
        f"streams fell short, {t['unjudged']} of them past the reference's "
        f"budget; frames lost by both the program and the reference: "
        f"{t['lost_by_both']}")
    ctx = {"setup_s": t0 - t_start, "window_s": t_end - t0,
           "blocks": blocks, "streams": n, "block_len": bl,
           "spans": spans, "profile": profile if trace else None,
           "gc_s": pauses.seconds}
    return {"ctx": ctx, "attempted": t["attempted"], "failed": t["failed"],
            "checks": {"delivery": (t["failed"], 0),
                       "counters": (t["counters"], 0),
                       "reference": (ref, 0)},
            "device_kind": kind, "memory_peak_bytes": peak}
