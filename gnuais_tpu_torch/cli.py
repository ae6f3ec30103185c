"""Command line: decode a capture file on the GPU (or the CPU).

    gnuais-tpu-torch [-c cfgfile] -l <capture.raw|.wav>
                     [--backend exact|fast|fused|golden] [--device cuda|cpu]
    gnuais-tpu-torch --batch FILE... [--replicate N]
                     [--backend exact|fast|fused]

The file-decode slice of ``gnuais-tpu`` (``gnuais_tpu/cli.py``): message
lines go to stdout in the reference format, the per-channel "Received
correctly / wrong CRC / wrong size" summary to the log (stderr).  The
backend comes from ``--backend`` or the config's ``backend`` directive:
``exact`` runs the exact chain in reference-sized blocks (on the card:
the exact FIR, the DPLL kernel B4 and the deframer kernel); ``fast``
runs the same kernels in 1024-sample blocks with the CRC on the host;
``fused`` runs the fused kernel B2 and the candidate compaction in
1024-sample blocks with the CRC filter on the device, as the JAX
package's ``--backend fused`` does; ``golden`` runs the golden model
(``golden.model``) on the host.  The device defaults to ``cuda``;
``cpu`` must be asked for.  A config that sets a directive of a path not
ported yet (``UNHONOURED``) is refused with rc 1.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time as time_mod
from typing import List, Optional

import torch

from . import constants as C
from .config import Config, read_config
from .io import audio as audio_io
from .io.sinks import StdoutSink
from .runtime.metrics import LevelMonitor
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
    ("checkpoint", lambda c: c.checkpoint is not None),
    ("uplink", lambda c: bool(c.uplinks)),
    ("mysql_host", lambda c: c.mysql_host is not None),
    ("mysql_db", lambda c: c.mysql_db is not None),
    ("mysql_user", lambda c: c.mysql_user is not None),
    ("mysql_password", lambda c: c.mysql_password is not None),
    ("mysql_keepsmall", lambda c: c.mysql_keepsmall),
    ("mysql_oldlimit", lambda c: c.mysql_oldlimit != 0),
    ("dbpath", lambda c: c.db_path is not None),
    ("statsinterval", lambda c: c.stats_interval > 0),
    ("soundoutfile", lambda c: c.sound_out_file is not None),
    ("serialport", lambda c: c.serial_port is not None),
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
        return TorchReceiver(name, block_len=block,
                             frame_slots=cfg.frameslots, fast_dpll=fast,
                             fused_pipeline=fused, device_crc=fused,
                             level_monitor=LevelMonitor(name,
                                                        cfg.sound_levellog),
                             device=device)
    return factory


def run_decode(cfg: Config, device: str, out_stream=None) -> int:
    for directive, is_set in UNHONOURED:
        if is_set(cfg):
            log.critical("The %s directive is not supported by this port "
                         "yet.", directive)
            return 1
    if not cfg.sound_in_file:
        log.critical("No sound file configured (live input is not "
                     "ported yet).")
        return 1
    try:
        interleaved, _nch = audio_io.open_capture_lazy(
            cfg.sound_in_file,
            channels=1 if cfg.sound_channels == C.SOUND_CHANNELS_MONO else 2)
    except OSError as e:
        log.critical("Could not open sound file %s: %s",
                     cfg.sound_in_file, e.strerror or e)
        return 1
    log.info("Reading audio from file: %s", cfg.sound_in_file)
    sink = StdoutSink(out_stream)

    def on_message(msg) -> None:
        if msg.stdout_line:
            sink.write_line(msg.stdout_line)

    sess = DecodeSession(make_receiver_factory(cfg, device),
                         sound_channels=cfg.sound_channels,
                         skip_type=cfg.skip_type, message_callback=on_message)
    result = SessionResult()
    t0 = time_mod.time()
    n_samples = 0
    for block in audio_io.iter_blocks(interleaved, sess.nch):
        n_samples += len(block) // sess.nch
        sess.process_block(block, result)
    dt = time_mod.time() - t0
    for name, rx in (("A", sess.rx_a), ("B", sess.rx_b)):
        if rx is not None:
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


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="gnuais-tpu-torch",
        description="AIS receiver decode on PyTorch and CUDA")
    p.add_argument("-c", dest="cfgfile", help="configuration file")
    p.add_argument("-l", dest="soundinfile", help="input capture (raw S16/WAV)")
    p.add_argument("-n", dest="logname", default="gnuais")
    p.add_argument("-e", dest="loglevel", default="info",
                   choices=sorted(LOG_LEVELS))
    p.add_argument("--backend", choices=BACKENDS)
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (default: cuda)")
    p.add_argument("--batch", nargs="+", metavar="CAPTURE",
                   help="batch-decode N independent capture files")
    p.add_argument("--replicate", type=int, default=1,
                   help="tile --batch inputs to this many copies")
    args = p.parse_args(argv)
    # full float32 products on the card (PyTorch's default; the CRC check
    # is exact either way, see ops.crc)
    torch.backends.cuda.matmul.allow_tf32 = False

    logging.basicConfig(
        stream=sys.stderr, level=LOG_LEVELS[args.loglevel],
        format="%(asctime)s " + args.logname + "[%(process)d]: %(message)s")

    if args.batch:
        return run_batch(args.batch, args.replicate,
                         args.backend or "exact", args.device)
    cfg = Config()
    if args.cfgfile:
        cfg = read_config(args.cfgfile, cfg)
    if args.soundinfile:
        cfg.sound_in_file = args.soundinfile
        cfg.sound_device = None
    if args.backend:
        cfg.backend = args.backend
    return run_decode(cfg, args.device)


if __name__ == "__main__":
    sys.exit(main())
