"""Command line: the receiver on the GPU (or the CPU).

    gnuais-tpu-torch [-c cfgfile] [-l <inputsoundfile>|-] [-s <recordsoundfile>]
                     [-e <loglevel>] [-n <logname>] [-o stderr|file|syslog]
                     [-r logdir] [-f] [--pidfile PATH] [--streams N]
                     [--backend exact|fast|fused|golden] [--device cuda|cpu]
                     [--profile DIR] [--checkpoint PATH] [--checkpoint-every N]
                     [--low-latency] [--cluster COORDINATOR NPROCS PROCID]
    gnuais-tpu-torch --monitor [--map [--port N] [--tile-dir DIR] [--tile-fetch]]
    gnuais-tpu-torch [-c cfgfile] --batch FILE... [--replicate N]
                     [--backend exact|fast|fused] [--profile DIR]

The station path of ``gnuais-tpu`` (``gnuais_tpu/cli.py``).  Input is a
capture file, stdin (``-l -``), a FIFO, or the configured sound device
(ALSA or PulseAudio), with one or two AIS channels; with ``inputformat
iq`` it is raw float32 I/Q at 48 kHz x ``iqdecim`` (a file, a FIFO or
stdin), FM-demodulated and decimated on the device (``io.iq``).  Message
lines go to stdout in the reference format; NMEA sentences to the Unix
socket, the serial port and the database (sqlite or MySQL); the JSON-AIS
uplink posts the vessel cache on its interval; ``statsinterval`` logs
the range statistics; ``soundoutfile`` (``-s``) records the input; the
per-channel "Received correctly / wrong CRC / wrong size" summary goes
to the log (stderr).  The backend comes from ``--backend`` or the
config's ``backend`` directive: ``exact`` runs the exact chain in
reference-sized blocks (on the card: the exact FIR, the DPLL kernel B4
and the deframer kernel); ``fast`` runs the same kernels in 1024-sample
blocks with the CRC on the host; ``fused`` runs the fused kernel B2 and
the candidate compaction in 1024-sample blocks with the CRC filter on
the device, as the JAX package's ``--backend fused`` does; ``golden``
runs the golden model (``golden.model``) on the host.  ``--checkpoint``
snapshots each channel's decoder for an exact resume.

The throughput modes: ``streams N`` (``--streams``) decodes a whole
capture as overlapped chunk lanes through kernel B1
(``parallel.timepar.time_parallel_decode``), falling back to the exact
streaming session when a constant-level gap outruns the lanes' resync
overlap (``lanesguard``); ``meshshape s t`` streams super-blocks through
``parallel.timepar.TimeParSession`` on a grid of s x t devices (kernel
B2 on every shard, the halos between time shards, the exact carry
hand-off at the seams), or ``GroupedTimeParSession`` when the channels
are fewer than the streams axis (each channel's super-block split into
row segments), with its ``<checkpoint>.mesh.npz`` snapshot and
``--low-latency`` (4096-sample shards).  On ``cuda`` a grid takes
distinct cards and a grid larger than the visible cards is refused (rc
1); on ``cpu`` its shards are logical shards of the CPU.  ``--cluster
COORDINATOR NPROCS PROCID`` runs one decode across processes (the same
command with each rank; ``parallel.cluster``): the grid spans every
process's devices, each process decodes its own shards, and rank 0
alone writes the output.  ``--batch`` decodes each file as its own mono
stream in lock-step blocks (``runtime.batch``); of its config it takes
``inputformat iq``, ``iqdecim`` and ``soundchannels`` (raw I/Q files of
one or two AIS channels, channel A decoded).  The device defaults to
``cuda``; ``cpu`` must be asked for.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import stat as stat_mod
import sys
import time as time_mod
from typing import List, Optional

import numpy as np
import torch

from . import constants as C
from .ais.dispatcher import DecodedMessage
from .config import Config, read_config
from .io import audio as audio_io
from .io.cache import JsonExporter, VesselCache
from .io.db import DbWriter
from .io.sinks import NmeaSocketServer, SerialSink, StdoutSink
from .runtime import trace
from .runtime.metrics import LevelMonitor, RangeTracker
from .runtime.session import DecodeSession, SessionResult

log = logging.getLogger("gnuais")

LOG_LEVELS = {"emerg": logging.CRITICAL, "alert": logging.CRITICAL,
              "crit": logging.CRITICAL, "err": logging.ERROR,
              "warning": logging.WARNING, "notice": logging.INFO,
              "info": logging.INFO, "debug": logging.DEBUG}

BACKENDS = ("exact", "fast", "fused", "golden")


def make_receiver_factory(cfg: Config, device: str):
    if cfg.backend not in BACKENDS:
        raise SystemExit(f"unknown backend: {cfg.backend} "
                         f"(this port has {', '.join(BACKENDS)})")
    if cfg.backend == "golden":
        from .golden.model import GoldenReceiver
        return lambda name: GoldenReceiver(name)
    from .runtime.pipeline import TorchReceiver
    fast = cfg.backend == "fast"
    fused = cfg.backend == "fused"
    # the kernels take 512-multiple blocks
    block = 1024 if fast or fused else audio_io.reference_block_frames()

    def factory(name):
        # always attached: the >95 % overload warning fires even without
        # a SoundLevelLog interval (receiver.c:137-147)
        ckpt = f"{cfg.checkpoint}.{name}.npz" if cfg.checkpoint else None
        return TorchReceiver(name, block_len=block,
                             frame_slots=cfg.frameslots, fast_dpll=fast,
                             fused_pipeline=fused, device_crc=fused,
                             level_monitor=LevelMonitor(name,
                                                        cfg.sound_levellog),
                             checkpoint_path=ckpt,
                             checkpoint_every=cfg.checkpoint_every,
                             device=device)
    return factory


def _open_sound_device(cfg: Config, channels: int):
    """Live capture per the SoundDevice directive (ais.c:150-172):
    ``pulse`` selects PulseAudio, anything else is an ALSA PCM name."""
    if cfg.sound_device == "pulse":
        from .io.pulse import PulseInput
        live = PulseInput(channels=channels)
        log.info("Opened PulseAudio record stream")
    else:
        from .io.alsa import AlsaInput
        live = AlsaInput(cfg.sound_device, channels=channels)
        log.info("Opened ALSA capture device %s", cfg.sound_device)
    return live


def _open_db(cfg: Config):
    if cfg.mysql_db:
        # the reference's production sink (out_mysql.c): MySQL with
        # server-gone auto-reconnect
        from .io.mysql import MySqlWriter
        try:
            return MySqlWriter(cfg.mysql_host or "localhost", cfg.mysql_db,
                               cfg.mysql_user or "gnuais",
                               cfg.mysql_password or "",
                               keepsmall=cfg.mysql_keepsmall,
                               oldlimit=cfg.mysql_oldlimit)
        except Exception as e:
            log.error("Could not connect to MySQL: %s", e)
            return None
    if cfg.db_path:
        return DbWriter(cfg.db_path, keepsmall=cfg.mysql_keepsmall,
                        oldlimit=cfg.mysql_oldlimit)
    return None


def _resume(cfg: Config, sess: DecodeSession) -> int:
    """The checkpoint resume of a file decode: the samples per channel a
    previous run consumed (0 for a fresh run), with each channel's NMEA
    seqnr restored and snapshotted beside the decoder carry."""
    if not cfg.checkpoint or not hasattr(sess.rx_a, "resume_offset"):
        return 0
    off = sess.rx_a.resume_offset()
    if sess.rx_b is not None:
        off_b = sess.rx_b.resume_offset()
        if off_b != off:
            # channel snapshots from different block counts (crash
            # between the A and B saves): exact resume is impossible —
            # restart both channels fresh
            log.warning("Checkpoint offsets differ (A=%d B=%d): "
                        "restarting from 0", off, off_b)
            off = 0
            for rx in (sess.rx_a, sess.rx_b):
                rx.pipe.reset()
    if off:
        log.info("Resuming from checkpoint: skipping %d samples/channel", off)
    # without the dispatcher's rolling NMEA seqnr, resumed multipart
    # sentences would renumber from 0 (protodec.c:922-926)
    for rx, disp in ((sess.rx_a, sess.disp_a), (sess.rx_b, sess.disp_b)):
        if rx is None:
            continue
        rx.pipe.extra_meta = lambda d=disp: {"seqnr": d.seqnr}
        if off and rx.pipe.restored_extra:
            disp.seqnr = int(rx.pipe.restored_extra.get("seqnr", 0))
    return off


@contextlib.contextmanager
def _profiler(profile_dir: str, device: str):
    """``--profile``: a torch.profiler trace of the decode (host
    timeline with the port's block spans, ``gnuais.*``, and the card's
    kernels and copies when decoding on it) written into ``profile_dir``
    (view with tensorboard or perfetto); at its end one log line for
    each of the port's spans (calls, total ms, ms a block) and one for
    its counters (``runtime.trace``)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    log.info("torch profiler trace -> %s", profile_dir)
    trace.reset()
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(profile_dir)):
        yield
    for line in trace.summary():
        log.info("trace: %s", line)
    log.info("Profiler trace written to %s", profile_dir)


def _active_channels(sound_channels):
    """(channel name, interleave offset) rows in the reference's
    processing order — A fully before B within each block
    (ais.c:236-248; runtime.session.DecodeSession.process_block)."""
    if sound_channels == C.SOUND_CHANNELS_MONO:
        return [("A", 0)]
    if sound_channels == C.SOUND_CHANNELS_BOTH:
        return [("A", 0), ("B", 1)]
    if sound_channels == C.SOUND_CHANNELS_RIGHT:
        return [("A", 0)]
    return [("B", 1)]       # SOUND_CHANNELS_LEFT


class _TimeParDispatcher:
    """Dispatch time-parallel-decoded frames in the reference's exact
    emission order.

    The reference prints a frame while its per-bit loop processes the
    frame's stop-flag sample, and within every file-read block channel A
    is processed before channel B (ais.c:214-248), so the global order
    key is (file block of the stop sample, channel index, stop sample).
    The decode paths record the stop position per frame
    (FrameBatch.end), which makes this key exact.

    ``emit_until(watermark)`` releases only file blocks that lie wholly
    before the watermark (the absolute sample count already drained):
    blocks touching it wait for the next drain.
    """

    def __init__(self, chans, skip_type, on_message,
                 block_frames: Optional[int] = None):
        from .ais.dispatcher import ChannelDispatcher
        self.chans = chans
        self.disp = [ChannelDispatcher(name, skip_type) for name, _ in chans]
        self.on_message = on_message
        self.bf = block_frames or audio_io.reference_block_frames()
        self.pending = []         # (file_block, ch_idx, end, Frame)
        self.emitted_lines = 0    # stdout lines dispatched so far

    def add(self, ch_idx: int, items) -> None:
        """items: iterable of (start, end, Frame), CRC-passing."""
        for _st, en, fr in items:
            self.pending.append((en // self.bf, ch_idx, en, fr))

    def emit_until(self, watermark: Optional[int]) -> None:
        self.pending.sort(key=lambda p: (p[0], p[1], p[2]))
        limit = None if watermark is None else watermark // self.bf - 1
        keep = []
        for item in self.pending:
            blk, ci, _en, fr = item
            if limit is not None and blk > limit:
                keep.append(item)
                continue
            msg = self.disp[ci].dispatch(fr.payload_bits, fr.bufferlen)
            if msg is not None:
                self.on_message(msg)
                if msg.stdout_line:
                    self.emitted_lines += 1
        self.pending = keep

    # checkpoint support: the frames not yet released and the
    # per-channel NMEA seqnr (protodec.c:922-926) are part of the
    # resumable state; emitted_lines lets a resumed consumer splice the
    # interrupted run's output at the snapshot point
    def snapshot(self) -> dict:
        return {
            "pending": [(blk, ci, en, fr.payload_bits, fr.bufferlen)
                        for blk, ci, en, fr in self.pending],
            "seqnr": [d.seqnr for d in self.disp],
            "emitted_lines": self.emitted_lines,
        }

    def restore(self, st: dict) -> None:
        from .golden.model import Frame
        self.pending = [(int(blk), int(ci), int(en),
                         Frame(np.asarray(bits), int(blen), True))
                        for blk, ci, en, bits, blen in st["pending"]]
        for d, s in zip(self.disp, st["seqnr"]):
            d.seqnr = int(s)
        self.emitted_lines = int(st["emitted_lines"])


def _grid_mesh(meshshape, device: str):
    """The grid ``meshshape s t`` asks for: s x t distinct cards on
    ``cuda``, logical shards on ``cpu``; under ``--cluster`` the grid over
    every process's devices (its visible cards, or its share of the
    logical shards).  Raises ValueError when the devices are too few."""
    from .parallel import cluster
    from .parallel import mesh as M
    s_ax, t_ax = (tuple(meshshape) + (1, 1))[:2]
    world = cluster.process_count()
    if world == 1:
        return M.make_grid_mesh(s_ax, t_ax, device=device)
    return cluster.make_cluster_mesh(
        t_ax, streams=s_ax, devices=cluster.local_devices(
            device, -(-(s_ax * t_ax) // world)))


def _mesh_decode(cfg: Config, chans, nch: int, block_iter, dispatcher,
                 tee, mesh, level_mons=None, stats_tick=None) -> tuple:
    """Streaming mesh decode: ``meshshape s t`` runs every channel row
    across the streams x time grid ``mesh`` through ``TimeParSession``
    (kernel B2 on every shard on the card): O(super_block) host memory,
    the exact carry hand-off between super-blocks, files and live inputs
    alike.  Returns (per-channel counters, samples per channel).

    level_mons: per-channel LevelMonitor list fed with the step's input
    peak (receiver.c:137-147).  stats_tick: called once per input block
    for StatsInterval range logging (ais.c:250-262)."""
    from .parallel.timepar import GroupedTimeParSession, TimeParSession

    s_ax, t_ax = mesh.streams, mesh.time
    n_rows = len(chans)
    t_loc = max(4096, -(-cfg.timepar_block // 512) * 512)
    sb_row = t_ax * t_loc
    if s_ax > n_rows and s_ax % n_rows == 0:
        # fewer channel rows than the streams axis: split each channel's
        # super-block into `group` consecutive row segments (overlap-
        # resync sequence parallelism along the streams axis), so that
        # every row of the grid decodes real data — a mono capture on
        # meshshape 4 2 keeps 8 shards busy
        group = s_ax // n_rows
        sb = group * sb_row
        sess = GroupedTimeParSession(mesh, n_rows, group, sb_row,
                                     frame_slots=max(cfg.frameslots, 32))
        buf_rows = n_rows
        log.info("Mesh decode: %dx%d devices, %d-sample shards, "
                 "%d channel row(s) x %d row segments "
                 "(%d-sample super-blocks)",
                 s_ax, t_ax, t_loc, n_rows, group, sb)
    else:
        s_rows = -(-n_rows // s_ax) * s_ax   # zero-pad to shardable S
        if s_rows > n_rows:
            log.warning(
                "meshshape streams axis (%d) does not divide into the "
                "%d channel row(s): %d mesh rows idle",
                s_ax, n_rows, s_rows - n_rows)
        sb = sb_row
        sess = TimeParSession(mesh, s_rows, sb,
                              frame_slots=max(cfg.frameslots, 32))
        buf_rows = s_rows
        log.info("Mesh decode: %dx%d devices, %d-sample shards, "
                 "%d-sample super-blocks, %d channel row(s)",
                 s_ax, t_ax, t_loc, sb, n_rows)

    buf = np.zeros((buf_rows, sb), np.int16)
    state = {"fill": 0, "pushed": 0, "samples": 0, "skip": 0}

    # checkpoint/resume (SURVEY section 5): the session's cross-push
    # state and the dispatcher's pending queue, snapshotted together at
    # push boundaries as numpy and Python values (the JAX CLI's format:
    # either package resumes the other's); a resume skips the consumed
    # input and continues byte for byte
    ckpt = f"{cfg.checkpoint}.mesh.npz" if cfg.checkpoint else None
    # checkpoint_every counts reference file blocks (~1020 frames); one
    # push consumes a whole super-block: pushes at the same cadence
    ckpt_every = max(1, ((cfg.checkpoint_every or 1)
                         * audio_io.reference_block_frames()) // sb)
    layout = [s_ax, t_ax, sb, buf_rows, nch]
    if ckpt and os.path.exists(ckpt):
        try:
            data = np.load(ckpt, allow_pickle=True)
            meta = data["meta"].item()
            if meta["layout"] != layout:
                log.warning("Mesh checkpoint layout mismatch %s != %s: "
                            "starting fresh", meta["layout"], layout)
            else:
                sess.restore(data["sess"].item())
                dispatcher.restore(data["disp"].item())
                state["pushed"] = int(meta["pushed"])
                state["skip"] = int(meta["consumed"])
                state["samples"] = int(meta["consumed"])
                log.info("Resuming mesh decode from checkpoint: "
                         "skipping %d samples/channel", state["skip"])
        except Exception as e:
            log.warning("Could not load mesh checkpoint %s: %s", ckpt, e)

    def save_ckpt():
        if not ckpt or state["pushed"] % ckpt_every:
            return
        meta = {"layout": layout, "pushed": state["pushed"],
                "consumed": state["pushed"] * sb,
                "emitted_lines": dispatcher.emitted_lines}
        tmp = ckpt + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, meta=np.array(meta, dtype=object),
                     sess=np.array(sess.snapshot(), dtype=object),
                     disp=np.array(dispatcher.snapshot(), dtype=object))
        os.replace(tmp, ckpt)

    def drain(per_stream, idx):
        if per_stream is None:
            return
        if level_mons:
            for ci in range(n_rows):
                level_mons[ci].observe(sess.last_peak[ci])
        for ci in range(n_rows):
            dispatcher.add(ci, per_stream[ci])
        dispatcher.emit_until((idx + 1) * sb)

    def push_buffer(final: bool = False):
        out = sess.push(buf.copy())
        drain(out, state["pushed"] - 1)
        state["pushed"] += 1
        state["fill"] = 0
        buf[:] = 0
        # the final zero-padded partial push must not snapshot: consumed
        # = pushed*sb would count the padding, and a resume would decode
        # it as samples (a crash there resumes from the previous one)
        if not final:
            save_ckpt()

    for block in block_iter:
        if stats_tick:
            stats_tick()
        if tee:
            tee.write(np.asarray(block, dtype="<i2").tobytes())
        nf = len(block) // nch
        state["samples"] += nf
        off = 0
        if state["skip"] > 0:
            # resume: discard input a previous run already consumed
            sk = min(state["skip"], nf)
            state["skip"] -= sk
            state["samples"] -= sk        # already counted at restore
            off = sk
        while off < nf:
            take = min(sb - state["fill"], nf - off)
            f0 = state["fill"]
            for r, (_name, ofs) in enumerate(chans):
                seg = (block[(off * nch + ofs):((off + take) * nch):nch]
                       if nch > 1 else block[off:off + take])
                buf[r, f0:f0 + take] = seg
            state["fill"] += take
            off += take
            if state["fill"] == sb:
                push_buffer()

    last_valid = None
    if state["fill"] > 0:
        last_valid = state["fill"]
        push_buffer(final=True)
    if state["pushed"] > 0:
        out = sess.flush(n_valid=last_valid)
        drain(out, state["pushed"] - 1)
    dispatcher.emit_until(None)
    if ckpt and os.path.exists(ckpt):
        os.remove(ckpt)          # complete: a rerun starts fresh

    counters = {name: (sess.received[ci], sess.wrong_crc[ci],
                       sess.wrong_size[ci])
                for ci, (name, _ofs) in enumerate(chans)}
    return counters, state["samples"]


def _max_constant_run(x: np.ndarray) -> int:
    """Longest run of consecutive equal samples (host scan, O(n))."""
    n = len(x)
    if n < 2:
        return n
    idx = np.flatnonzero(np.diff(np.asarray(x)) != 0)
    if idx.size == 0:
        return n
    edges = np.concatenate([[-1], idx, [n - 1]])
    return int(np.diff(edges).max())


def _lanes_envelope_gap(interleaved, nch: int, chans) -> int:
    """Largest constant-level run across the active channels: whether
    the lanes' overlap-resync envelope holds (a constant-level gap
    longer than the lead overlap leaves the DPLL phase a path-dependent
    walk that no bounded window reproduces; parallel/timepar.py)."""
    worst = 0
    for _name, ofs in chans:
        stream = interleaved[ofs::nch] if nch > 1 else interleaved
        worst = max(worst, _max_constant_run(stream))
    return worst


def _lanes_decode(cfg: Config, chans, nch: int, interleaved: np.ndarray,
                  dispatcher, tee, device: str, level_mons=None) -> tuple:
    """Whole-capture lane decode: ``streams N`` splits each channel's
    stream into N overlap-resync chunk lanes, decoded by one kernel B1
    call (``parallel.timepar.time_parallel_decode``)."""
    from .parallel.timepar import time_parallel_decode

    if tee:
        tee.write(np.asarray(interleaved, dtype="<i2").tobytes())
    n = len(interleaved) // nch
    chunk = max(4096, -(-(-(-n // cfg.streams)) // 512) * 512)
    counters = {}
    for ci, (name, ofs) in enumerate(chans):
        stream = (np.ascontiguousarray(interleaved[ofs::nch])
                  if nch > 1 else np.asarray(interleaved))
        res = time_parallel_decode(stream, chunk_len=chunk,
                                   frame_slots=max(cfg.frameslots, 64),
                                   device=device)
        if level_mons:
            # whole-capture peak through the same reference semantics
            level_mons[ci].observe(res.peak)
        dispatcher.add(ci, zip(res.starts, res.ends, res.frames))
        counters[name] = (len(res.frames), res.wrong_crc, res.wrong_size)
        log.info("Time-parallel decode ch %s: %d lanes of %d samples",
                 name, res.chunks, chunk)
    dispatcher.emit_until(None)
    return counters, n


def _timepar_decode(cfg: Config, device: str, mesh, live, iq_reader,
                    interleaved, nch: int, on_message, ranges, tee) -> tuple:
    """The throughput modes (``streams N``, ``meshshape s t`` on the grid
    ``mesh``): both map channels A/B onto stream rows and replay the
    reference's emission order through the recorded stop positions.
    Returns (per-channel counters, samples per channel)."""
    chans = _active_channels(cfg.sound_channels)
    disp = _TimeParDispatcher(chans, cfg.skip_type, on_message)
    # the step's input peak feeds per-channel level monitors;
    # StatsInterval range logging ticks once an input block
    level_mons = [LevelMonitor(name, cfg.sound_levellog) for name, _ in chans]
    stats_state = {"last": time_mod.time()}

    def stats_tick():
        if not cfg.stats_interval:
            return
        now = time_mod.time()
        if now - stats_state["last"] >= cfg.stats_interval:
            stats_state["last"] = now
            for rt in ranges.values():
                rt.log_and_reset()

    if cfg.meshshape:
        block_iter = (live.blocks() if live is not None
                      else iq_reader.blocks() if iq_reader is not None
                      else audio_io.iter_blocks(interleaved, nch, 1 << 16))
        return _mesh_decode(cfg, chans, nch, block_iter, disp, tee, mesh,
                            level_mons=level_mons, stats_tick=stats_tick)
    if iq_reader is not None:
        # whole-capture lane decode: only the demodulated audio is held
        # (8*decim/channels times smaller than the memmapped IQ file)
        interleaved = iq_reader.read_all()
    # envelope guard: lanes resync through the lead overlap, so
    # constant-level (squelched or zeroed) gaps longer than the overlap
    # are outside the exactness envelope — scan once and fall back to
    # the exact carry-hand-off session
    from .parallel.timepar import DEFAULT_OVERLAP
    gap = _lanes_envelope_gap(interleaved, nch, chans) if cfg.lanes_guard \
        else 0
    if gap >= DEFAULT_OVERLAP:
        log.warning(
            "Capture contains a constant-level run of %d samples (>= the "
            "%d-sample lane resync overlap): lane decode cannot guarantee "
            "exact parity past such gaps — falling back to the exact "
            "streaming session (disable with `lanesguard off`)",
            gap, DEFAULT_OVERLAP)
        from .parallel.mesh import make_grid_mesh
        return _mesh_decode(cfg, chans, nch,
                            audio_io.iter_blocks(interleaved, nch, 1 << 16),
                            disp, tee, make_grid_mesh(1, 1, device=device),
                            level_mons=level_mons, stats_tick=stats_tick)
    return _lanes_decode(cfg, chans, nch, interleaved, disp, tee, device,
                         level_mons=level_mons)


def run_decode(cfg: Config, device: str, out_stream=None) -> int:
    if not cfg.sound_in_file and not cfg.sound_device:
        log.critical("Neither sound device or sound file configured.")
        return 1
    mesh = None
    if cfg.meshshape:
        # the grid first: a grid of more cards than there are is refused
        # before anything is opened
        try:
            mesh = _grid_mesh(cfg.meshshape, device)
        except ValueError as e:
            log.critical("Cannot decode meshshape %s on %s: %s",
                         " ".join(map(str, cfg.meshshape)), device, e)
            return 1

    nch_cfg = 1 if cfg.sound_channels == C.SOUND_CHANNELS_MONO else 2
    live = None
    interleaved = None
    iq_reader = None
    src = cfg.sound_in_file
    is_stream = bool(src) and (src == "-" or (
        os.path.exists(src) and not stat_mod.S_ISREG(os.stat(src).st_mode)))
    try:
        if not src:
            live = _open_sound_device(cfg, nch_cfg)
        elif cfg.input_format == "iq":
            # raw interleaved float32 I/Q (1-2 AIS channels) at 48 kHz *
            # iq_decim: the front end demodulates on the device block by
            # block with an explicit carry (io.iq); a FIFO, stream or
            # stdin takes the live reader, byte for byte the file
            # reader's audio on the same bytes
            from .io.iq import IqLiveReader, IqStreamReader
            reader = IqLiveReader if is_stream else IqStreamReader
            try:
                iq_reader = reader(src, channels=nch_cfg,
                                   decim=cfg.iq_decim, device=device)
            except RuntimeError as e:     # no such device
                log.critical("Could not open IQ input %s on %s: %s", src,
                             device, e)
                return 1
            log.info("Streaming IQ %s %s (decim %d, %d ch)",
                     "live from" if is_stream else "from file:", src,
                     cfg.iq_decim, nch_cfg)
        elif is_stream:
            from .io.live import LiveInput
            live = LiveInput(src, channels=nch_cfg)
            log.info("Reading live audio from stream: %s", src)
        else:
            # raw files map lazily; block iteration reads through the
            # map on demand
            interleaved, _nch = audio_io.open_capture_lazy(
                src, channels=nch_cfg)
            log.info("Reading audio from file: %s", src)
    except OSError as e:
        log.critical("Could not open sound file %s: %s",
                     cfg.sound_in_file, e.strerror or e)
        return 1
    except RuntimeError as e:
        log.critical("Could not open sound device %s: %s",
                     cfg.sound_device, e)
        return 1

    # a cluster's ranks all drain the identical global frame stream
    # (``parallel.sharded``), so the ranks above 0 run the dispatcher for
    # exact counters but open no sink: one process emits, and the
    # cluster's output is byte for byte a single process's
    quiet_rank = cfg.cluster_nprocs > 1 and cfg.cluster_procid > 0
    if quiet_rank:
        out_stream = open(os.devnull, "w")
    stdout_sink = StdoutSink(out_stream)
    socket_srv: Optional[NmeaSocketServer] = None
    if not quiet_rank:
        try:
            socket_srv = NmeaSocketServer()
        except OSError as e:
            log.error("Could not open Unix Domain Socket: %s", e)
    serial_sink = (SerialSink(cfg.serial_port)
                   if cfg.serial_port and not quiet_rank else None)
    db = None if quiet_rank else _open_db(cfg)
    cache = VesselCache() if cfg.uplinks and not quiet_rank else None
    exporter = None
    if cache:
        exporter = JsonExporter(cache, [u.url for u in cfg.uplinks],
                                cfg.mycall)
        exporter.start()

    mylat = cfg.mylat if cfg.have_my_loc else None
    mylng = cfg.mylng if cfg.have_my_loc else None
    ranges = {name: RangeTracker(name, mylat, mylng) for name in ("A", "B")}

    def on_message(msg: DecodedMessage) -> None:
        now = int(time_mod.time())
        if msg.stdout_line:
            stdout_sink.write_line(msg.stdout_line)
        for s in msg.nmea_sentences:
            if socket_srv:
                socket_srv.write(s)
            if serial_sink:
                serial_sink.write(s)
            if db:
                db.nmea(now, s)
        for ev in msg.events:
            if cache:
                cache.apply_event(ev, now)
            if db:
                db.apply_event(ev, now)
            if ev.kind in ("position", "basestation"):
                rt = ranges.get(msg.chanid)
                if rt:
                    rt.update(ev.data["lat"], ev.data["lon"])

    tee = open(cfg.sound_out_file, "wb") if cfg.sound_out_file else None
    sess = None
    timepar_counters = None
    n_samples = 0
    want_timepar = bool(cfg.meshshape) or cfg.streams > 1
    if want_timepar and live is not None and not cfg.meshshape:
        log.warning("streams > 1 lane decode needs a whole capture; "
                    "live input decodes sequentially (use meshshape "
                    "for streaming)")
        want_timepar = False
    try:
        with (_profiler(cfg.profile_dir, device) if cfg.profile_dir
              else contextlib.nullcontext()):
            t0 = time_mod.time()
            if want_timepar:
                timepar_counters, n_samples = _timepar_decode(
                    cfg, device, mesh, live, iq_reader, interleaved,
                    nch_cfg, on_message, ranges, tee)
            else:
                n_samples, sess = _sequential_decode(
                    cfg, device, live, iq_reader, interleaved, on_message,
                    ranges, tee)
            dt = time_mod.time() - t0
    finally:
        # the orderly close of every sink, on every exit path
        if live is not None:
            live.close()
        if iq_reader is not None:
            iq_reader.close()
        if tee:
            tee.close()
        if exporter:
            try:
                exporter.export_once()
            finally:
                exporter.stop()
        if socket_srv:
            socket_srv.close()
        if serial_sink:
            serial_sink.close()
        if db:
            db.close()
        if quiet_rank:
            out_stream.close()
    if sess is not None:
        counters = [(name, rx.counters)
                    for name, rx in (("A", sess.rx_a), ("B", sess.rx_b))
                    if rx is not None and hasattr(rx, "counters")]
    else:
        # the throughput modes give the sequential session's accounting
        # (ais.c:296-310), with the all-zero line of a channel that
        # exists but never ran (left/right modes, ais.c:139-149)
        counters = [(name, timepar_counters.get(name, (0, 0, 0)))
                    for name in (("A",) if nch_cfg == 1 else ("A", "B"))]
    for name, (r, l, l2) in counters:
        log.info("%s: Received correctly: %d packets, "
                 "wrong CRC: %d packets, wrong size: %d packets",
                 name, r, l, l2)
    log.info("Processed %d samples in %.2fs (%.0fx real time) on %s",
             n_samples, dt, n_samples / 48000.0 / dt if dt else 0, device)
    return 0


def _sequential_decode(cfg: Config, device: str, live, iq_reader,
                       interleaved, on_message, ranges, tee) -> tuple:
    """The sequential session: each channel through its receiver, block
    by block.  Returns (samples per channel, the DecodeSession)."""
    sess = DecodeSession(make_receiver_factory(cfg, device),
                         sound_channels=cfg.sound_channels,
                         skip_type=cfg.skip_type,
                         message_callback=on_message)
    result = SessionResult()
    nchs = sess.nch
    if live is not None:
        block_iter = live.blocks()
    else:
        # checkpoint resume: skip samples a previous run already
        # consumed — the restored carry continues exactly
        off = _resume(cfg, sess)
        if iq_reader is not None:
            # the IQ front end's carry at the resume offset is rebuilt
            # exactly from the file (or evolved through a re-fed
            # stream); its large blocks are cut to the session's
            # reference block framing (ais.c:179-182)
            step = audio_io.reference_block_frames() * nchs
            block_iter = (blk[o:o + step]
                          for blk in iq_reader.blocks(skip_frames=off)
                          for o in range(0, len(blk), step))
        else:
            block_iter = audio_io.iter_blocks(interleaved[off * nchs:], nchs)
    n_samples = 0
    last_stats = time_mod.time()
    for block in block_iter:
        n_samples += len(block) // nchs
        if tee:
            tee.write(np.asarray(block, dtype="<i2").tobytes())
        sess.process_block(block, result)
        if cfg.stats_interval:
            now = time_mod.time()
            if now - last_stats >= cfg.stats_interval:
                last_stats = now
                for rt in ranges.values():
                    rt.log_and_reset()
    if cfg.checkpoint:
        # final snapshot: a clean exit resumes exactly once (a crash
        # resumes from the last periodic snapshot, re-emitting the tail
        # blocks' frames — at least once)
        for rx in (sess.rx_a, sess.rx_b):
            if rx is not None and hasattr(rx, "pipe") \
                    and hasattr(rx.pipe, "checkpoint"):
                rx.pipe.checkpoint()
    return n_samples, sess


def run_batch(paths: List[str], replicate: int, backend: str,
              device: str, cfg: Optional[Config] = None) -> int:
    """``--batch``: the files as mono streams; with ``cfg``'s ``inputformat
    iq``, raw I/Q files at 48 kHz x ``iqdecim`` of its ``soundchannels``."""
    from .runtime.batch import BACKENDS as BATCH_BACKENDS, decode_files
    if backend not in BATCH_BACKENDS:
        raise SystemExit(f"--batch has no {backend} backend (it has "
                         f"{', '.join(BATCH_BACKENDS)})")
    iq = cfg is not None and cfg.input_format == "iq"
    res = decode_files(
        paths, replicate=replicate, backend=backend, device=device,
        iq_decim=cfg.iq_decim if iq else None,
        iq_channels=(1 if not iq or cfg.sound_channels
                     == C.SOUND_CHANNELS_MONO else 2))
    for line in res.lines:
        print(line)
    for name, (r, l, l2) in res.counters.items():
        log.info("%s: Received correctly: %d packets, wrong CRC: %d "
                 "packets, wrong size: %d packets", name, r, l, l2)
    log.info("Batch: %d streams, %.1f Msamples in %.2fs (%.0fx real time) "
             "on %s", len(res.counters), res.samples / 1e6, res.seconds,
             res.samples_per_sec / 48000.0, device)
    return 0


def _setup_logging(args) -> None:
    fmt = "%(asctime)s " + args.logname + "[%(process)d]: %(message)s"
    if args.logdest == "file" and args.logdir:
        logging.basicConfig(
            filename=os.path.join(args.logdir, args.logname + ".log"),
            level=LOG_LEVELS[args.loglevel], format=fmt)
    elif args.logdest == "syslog":
        from logging.handlers import SysLogHandler
        h = SysLogHandler(address="/dev/log") \
            if os.path.exists("/dev/log") else logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            args.logname + "[%(process)d]: %(message)s"))
        logging.basicConfig(level=LOG_LEVELS[args.loglevel], handlers=[h])
    else:
        logging.basicConfig(stream=sys.stderr,
                            level=LOG_LEVELS[args.loglevel], format=fmt)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="gnuais-tpu-torch",
        description="AIS receiver decode on PyTorch and CUDA")
    p.add_argument("-c", dest="cfgfile", help="configuration file")
    p.add_argument("-l", dest="soundinfile",
                   help="input capture (raw S16/WAV), a FIFO, or - for stdin")
    p.add_argument("-s", dest="soundoutfile", help="record input to file")
    p.add_argument("-n", dest="logname", default="gnuais")
    p.add_argument("-e", dest="loglevel", default="info",
                   choices=sorted(LOG_LEVELS))
    p.add_argument("-o", dest="logdest", default="stderr")
    p.add_argument("-r", dest="logdir")
    p.add_argument("-f", dest="fork", action="store_true",
                   help="fork to background (writes pidfile)")
    p.add_argument("--pidfile", default=None)
    p.add_argument("--streams", type=int,
                   help="time-parallel lanes a channel (whole captures)")
    p.add_argument("--backend", choices=BACKENDS)
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (default: cuda)")
    p.add_argument("--monitor", action="store_true",
                   help="run the live ship monitor (NMEA socket consumer)")
    p.add_argument("--map", action="store_true",
                   help="with --monitor: serve the self-contained web "
                        "map view (local tile cache; works offline)")
    p.add_argument("--port", type=int, default=8787,
                   help="web map HTTP port")
    p.add_argument("--tile-dir", default=None,
                   help="map tile cache directory (z/x/y.png layout; "
                        "default ~/.cache/gnuais-tpu/tiles)")
    p.add_argument("--tile-fetch", action="store_true",
                   help="fetch missing map tiles from the OSM tile "
                        "service into the cache (needs network)")
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler trace of the decode "
                        "(--batch too) to DIR, with the port's block "
                        "spans (gnuais.*) on the card's clock (view with "
                        "tensorboard or perfetto), and log one line a "
                        "span (calls, ms, ms a block) and one of the "
                        "counters")
    p.add_argument("--checkpoint", metavar="PATH",
                   help="checkpoint decoder state (per channel) for "
                        "exact crash recovery / resume")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   metavar="N", help="blocks between checkpoints")
    p.add_argument("--low-latency", action="store_true",
                   help="minimize capture-to-NMEA latency on the mesh "
                        "streaming path: the smallest shard (4096 "
                        "samples, the resync overlap's floor); one "
                        "super-block is held for the exact seam "
                        "hand-off; costs throughput")
    p.add_argument("--cluster", nargs=3,
                   metavar=("COORDINATOR", "NPROCS", "PROCID"),
                   help="one decode across processes: run the same "
                        "command in every process with its rank (e.g. "
                        "--cluster head:9999 2 0); meshshape spans every "
                        "process's devices (its visible cards), each "
                        "process decodes its own shards, the frame "
                        "outputs go to every process and rank 0 emits")
    p.add_argument("--batch", nargs="+", metavar="CAPTURE",
                   help="batch-decode N independent capture files (raw "
                        "I/Q with -c's inputformat iq)")
    p.add_argument("--replicate", type=int, default=1,
                   help="tile --batch inputs to this many copies")
    args = p.parse_args(argv)
    # full float32 products on the card (PyTorch's default; the CRC check
    # is exact either way, see ops.crc)
    torch.backends.cuda.matmul.allow_tf32 = False
    _setup_logging(args)

    if args.monitor:
        if args.map:
            from .monitor.webmap import monitor_socket_with_map
            monitor_socket_with_map(port=args.port, tile_dir=args.tile_dir,
                                    tile_fetch=args.tile_fetch)
        else:
            from .monitor.ships import monitor_socket
            monitor_socket()
        return 0

    if args.batch:
        cfg = read_config(args.cfgfile) if args.cfgfile else None
        with (_profiler(args.profile, args.device) if args.profile
              else contextlib.nullcontext()):
            return run_batch(args.batch, args.replicate,
                             args.backend or "exact", args.device, cfg)

    if args.fork:
        from .io.live import daemonize
        daemonize(args.pidfile)

    from .config import resolve_config
    cfg = Config()
    if args.cfgfile:
        cfg = read_config(args.cfgfile, cfg)
    elif not args.soundinfile:
        # no -c and no -l: reference first-run behavior — auto-install
        # ~/.config/gnuais/config from the packaged example
        # (cfgfile.c:341-422) and read it
        cfg = resolve_config(None, cfg, log)
    if args.soundinfile:
        cfg.sound_in_file = args.soundinfile
        cfg.sound_device = None
    if args.soundoutfile:
        cfg.sound_out_file = args.soundoutfile
    if args.streams:
        cfg.streams = args.streams
    if args.backend:
        cfg.backend = args.backend
    if args.cluster:
        cfg.cluster_coordinator = args.cluster[0]
        cfg.cluster_nprocs = int(args.cluster[1])
        cfg.cluster_procid = int(args.cluster[2])
    if cfg.cluster_nprocs > 1:
        # shield the machine-readable AIS stdout from native-library
        # chatter: gloo writes connection banners to fd 1 from C++.  The
        # decode writes to a private dup of the real stdout, and fd 1
        # points at stderr, so no foreign write can interleave with the
        # output (the reference's stdout carries only decoded text,
        # ais.c:934/984; consumers parse it line by line)
        real_out = os.dup(1)
        os.dup2(2, 1)
        sys.stdout = os.fdopen(real_out, "w", buffering=1)
        from .parallel.cluster import ClusterConfig, initialize
        initialize(ClusterConfig(cfg.cluster_coordinator,
                                 cfg.cluster_nprocs, cfg.cluster_procid))
        log.info("Cluster: process %d/%d via %s", cfg.cluster_procid,
                 cfg.cluster_nprocs, cfg.cluster_coordinator)
    if args.profile:
        cfg.profile_dir = args.profile
    if args.checkpoint:
        cfg.checkpoint = args.checkpoint
    if args.checkpoint_every is not None:
        cfg.checkpoint_every = args.checkpoint_every
    if args.low_latency:
        # the shard floor is the resync overlap (parallel.timepar
        # DEFAULT_OVERLAP): smaller shards would shrink the lead overlap
        # below the DPLL relock + max frame margin
        cfg.timepar_block = 4096
    try:
        return run_decode(cfg, args.device)
    finally:
        from .parallel.cluster import shutdown
        shutdown()


if __name__ == "__main__":
    sys.exit(main())
