"""Command line: the receiver on the GPU (or the CPU).

    gnuais-tpu-torch [-c cfgfile] [-l <inputsoundfile>|-] [-s <recordsoundfile>]
                     [-e <loglevel>] [-n <logname>] [-o stderr|file|syslog]
                     [-r logdir] [-f] [--pidfile PATH]
                     [--backend exact|fast|fused|golden] [--device cuda|cpu]
                     [--profile DIR] [--checkpoint PATH] [--checkpoint-every N]
    gnuais-tpu-torch --monitor [--map [--port N] [--tile-dir DIR] [--tile-fetch]]
    gnuais-tpu-torch --batch FILE... [--replicate N]
                     [--backend exact|fast|fused]

The station path of ``gnuais-tpu`` (``gnuais_tpu/cli.py``).  Input is a
capture file, stdin (``-l -``), a FIFO, or the configured sound device
(ALSA or PulseAudio), with one or two AIS channels.  Message lines go to
stdout in the reference format; NMEA sentences to the Unix socket, the
serial port and the database (sqlite or MySQL); the JSON-AIS uplink
posts the vessel cache on its interval; ``statsinterval`` logs the
range statistics; ``soundoutfile`` (``-s``) records the input; the
per-channel "Received correctly / wrong CRC / wrong size" summary goes
to the log (stderr).  The backend comes from ``--backend`` or the
config's ``backend`` directive: ``exact`` runs the exact chain in
reference-sized blocks (on the card: the exact FIR, the DPLL kernel B4
and the deframer kernel); ``fast`` runs the same kernels in 1024-sample
blocks with the CRC on the host; ``fused`` runs the fused kernel B2 and
the candidate compaction in 1024-sample blocks with the CRC filter on
the device, as the JAX package's ``--backend fused`` does; ``golden``
runs the golden model (``golden.model``) on the host.  ``--checkpoint``
snapshots each channel's decoder for an exact resume.  The device
defaults to ``cuda``; ``cpu`` must be asked for.  A config that sets a
directive of a path not ported yet (``UNHONOURED``) is refused with
rc 1.
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
from .runtime.metrics import LevelMonitor, RangeTracker
from .runtime.session import DecodeSession, SessionResult

log = logging.getLogger("gnuais")

LOG_LEVELS = {"emerg": logging.CRITICAL, "alert": logging.CRITICAL,
              "crit": logging.CRITICAL, "err": logging.ERROR,
              "warning": logging.WARNING, "notice": logging.INFO,
              "info": logging.INFO, "debug": logging.DEBUG}

BACKENDS = ("exact", "fast", "fused", "golden")

# Directives whose paths the port does not have yet, each with a test of
# whether a config sets it: run_decode refuses such a config (log and
# rc 1) rather than decode without the directive.
UNHONOURED = (
    ("inputformat iq", lambda c: c.input_format != "audio"),
    ("streams", lambda c: c.streams > 1),
    ("meshshape", lambda c: bool(c.meshshape)),
    ("cluster", lambda c: (c.cluster_coordinator is not None
                           or c.cluster_nprocs > 0 or c.cluster_procid >= 0)),
)


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


def _profiler(profile_dir: str, device: str):
    """``--profile``: a torch.profiler trace of the decode (host
    timeline, and the card's kernels when decoding on it) written into
    ``profile_dir`` (view with tensorboard or perfetto)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


def run_decode(cfg: Config, device: str, out_stream=None) -> int:
    for directive, is_set in UNHONOURED:
        if is_set(cfg):
            log.critical("The %s directive is not supported by this port "
                         "yet.", directive)
            return 1
    if not cfg.sound_in_file and not cfg.sound_device:
        log.critical("Neither sound device or sound file configured.")
        return 1

    nch_cfg = 1 if cfg.sound_channels == C.SOUND_CHANNELS_MONO else 2
    live = None
    interleaved = None
    src = cfg.sound_in_file
    try:
        if not src:
            live = _open_sound_device(cfg, nch_cfg)
        elif src == "-" or (os.path.exists(src)
                            and not stat_mod.S_ISREG(os.stat(src).st_mode)):
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

    stdout_sink = StdoutSink(out_stream)
    socket_srv: Optional[NmeaSocketServer] = None
    try:
        socket_srv = NmeaSocketServer()
    except OSError as e:
        log.error("Could not open Unix Domain Socket: %s", e)
    serial_sink = SerialSink(cfg.serial_port) if cfg.serial_port else None
    db = _open_db(cfg)
    cache = VesselCache() if cfg.uplinks else None
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
    n_samples = 0
    try:
        with (_profiler(cfg.profile_dir, device) if cfg.profile_dir
              else contextlib.nullcontext()):
            if cfg.profile_dir:
                log.info("torch profiler trace -> %s", cfg.profile_dir)
            t0 = time_mod.time()
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
                block_iter = audio_io.iter_blocks(interleaved[off * nchs:],
                                                  nchs)
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
                # final snapshot: a clean exit resumes exactly once (a
                # crash resumes from the last periodic snapshot,
                # re-emitting the tail blocks' frames — at least once)
                for rx in (sess.rx_a, sess.rx_b):
                    if rx is not None and hasattr(rx, "pipe") \
                            and hasattr(rx.pipe, "checkpoint"):
                        rx.pipe.checkpoint()
            dt = time_mod.time() - t0
    finally:
        # the orderly close of every sink, on every exit path
        if live is not None:
            live.close()
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
    if cfg.profile_dir:
        log.info("Profiler trace written to %s", cfg.profile_dir)

    for name, rx in (("A", sess.rx_a), ("B", sess.rx_b)):
        if rx is not None and hasattr(rx, "counters"):
            r, l, l2 = rx.counters
            log.info("%s: Received correctly: %d packets, "
                     "wrong CRC: %d packets, wrong size: %d packets",
                     name, r, l, l2)
    log.info("Processed %d samples in %.2fs (%.0fx real time) on %s",
             n_samples, dt, n_samples / 48000.0 / dt if dt else 0, device)
    return 0


def run_batch(paths: List[str], replicate: int, backend: str,
              device: str) -> int:
    from .runtime.batch import BACKENDS as BATCH_BACKENDS, decode_files
    if backend not in BATCH_BACKENDS:
        raise SystemExit(f"--batch has no {backend} backend (it has "
                         f"{', '.join(BATCH_BACKENDS)})")
    res = decode_files(paths, replicate=replicate, backend=backend,
                       device=device)
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
                   help="write a torch.profiler trace of the decode to "
                        "DIR (view with tensorboard or perfetto)")
    p.add_argument("--checkpoint", metavar="PATH",
                   help="checkpoint decoder state (per channel) for "
                        "exact crash recovery / resume")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   metavar="N", help="blocks between checkpoints")
    p.add_argument("--batch", nargs="+", metavar="CAPTURE",
                   help="batch-decode N independent capture files")
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
        return run_batch(args.batch, args.replicate,
                         args.backend or "exact", args.device)

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
    if args.backend:
        cfg.backend = args.backend
    if args.profile:
        cfg.profile_dir = args.profile
    if args.checkpoint:
        cfg.checkpoint = args.checkpoint
    if args.checkpoint_every is not None:
        cfg.checkpoint_every = args.checkpoint_every
    return run_decode(cfg, args.device)


if __name__ == "__main__":
    sys.exit(main())
