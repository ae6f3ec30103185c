"""Capture-to-NMEA latency of the port's live decode, the counterpart of
``tools/latency_bench.py``:

    python -m gnuais_tpu_torch.latency_bench \\
        [--configs "1x8:6144 1x8:4096 1x4:4096 1x2:4096 1x1:4096"] \\
        [--device cuda] [--backend fused]

Feeds a live FIFO 4096 samples at a time to the port's CLI (``python -m
gnuais_tpu_torch.cli -c <conf>``, on ``--device``, the card by default)
and records, for every decoded message, how many samples had been fed
when its stdout line appeared.  The capture (``build_capture``): 40
type-1 payloads from seed 3, 800-bit gaps, Gaussian noise of sigma 200.
Latency in samples is the count fed at the line minus the frame's last
sample: while the decoder keeps up with the feed (4096 samples every
10 ms, 8.5 times real time) it does not depend on the feed rate (the
mesh path buffers a super-block, plus one held for the seam hand-off),
so at real time

    latency_s = latency_samples / 48000 + compute time;

a decoder slower than the feed adds its backlog to the count.

Each config ``RxT:B`` runs ``meshshape R T`` with ``timeparblock B`` (the
``--low-latency`` knob is ``timeparblock 4096``); ``seq`` runs the
sequential station (no ``meshshape``).  Prints p50 and p90 over the
first 80 % of the sorted latencies (the last frames are emitted by the
end-of-file flush), and p50 in seconds at 48 kHz.  A grid larger than
the visible cards is refused by the CLI (rc 1): printed as refused, not
as a result.  The CLI runs in a temporary directory that holds its
FIFO, config and NMEA socket.
"""

from __future__ import annotations

import argparse
import os
import re
import selectors
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from .golden import encoder as E

REPO = Path(__file__).resolve().parents[1]
CONFIGS = "1x8:6144 1x8:4096 1x4:4096 1x2:4096 1x1:4096"
RATE = 48_000
# the CLI with its NMEA socket on "nmea.sock" in its working directory
_MAIN = ("import functools, sys\n"
         "from gnuais_tpu_torch import cli\n"
         "from gnuais_tpu_torch.io import sinks\n"
         "cli.NmeaSocketServer = functools.partial(sinks.NmeaSocketServer, "
         "'nmea.sock')\n"
         "sys.exit(cli.main(sys.argv[1:]))\n")


def build_capture(n_payloads: int = 40, seed: int = 3, gap_bits: int = 800,
                  noise: float = 200.0):
    """(int16 capture, each frame's last sample, each payload's MMSI)."""
    rng = np.random.default_rng(seed)
    payloads = [E.random_payload(rng, msg_type=1) for _ in range(n_payloads)]
    audio = E.synthesize_capture(payloads, gap_bits=gap_bits)
    noisy = np.clip(audio + rng.normal(0, noise, len(audio)),
                    -32768, 32767).astype(np.int16)
    ends, mmsis = [], []
    bit = 64                             # the encoder's lead-in
    for p in payloads:
        fl = len(E.frame_line_bits(p))
        ends.append((bit + fl) * 5)
        mmsis.append(int("".join(str(b) for b in p[8:38]), 2))
        bit += fl + gap_bits
    return noisy, ends, mmsis


def run_config(stream: np.ndarray, ends, mmsis, meshshape: Optional[str],
               tb: int, chunk: int = 4096, device: str = "cuda",
               backend: Optional[str] = None, timeout: float = 300.0):
    """One CLI run fed ``stream`` through a FIFO ``chunk`` samples at a
    time.  Returns (latencies in samples, sorted and cut to their first
    80 %; messages decoded; the CLI's exit code; its stderr)."""
    tmp = tempfile.mkdtemp(prefix="latency_bench.")
    try:
        fifo = os.path.join(tmp, "live.fifo")
        os.mkfifo(fifo)
        conf = os.path.join(tmp, "m.conf")
        with open(conf, "w") as f:
            f.write("soundchannels mono\n")
            if meshshape is not None:
                f.write(f"meshshape {meshshape}\ntimeparblock {tb}\n")
            f.write(f"soundinfile {fifo}\n")
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ, XDG_CONFIG_HOME=tmp, PYTHONUNBUFFERED="1",
                   PYTHONPATH=os.pathsep.join([str(REPO)]
                                              + ([path] if path else [])))
        cmd = [sys.executable, "-c", _MAIN, "-c", conf, "-e", "err",
               "--device", device]
        if backend is not None:
            cmd += ["--backend", backend]
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, env=env,
                             cwd=tmp)
        fed = {"n": 0}
        raw = stream.astype("<i2").tobytes()

        def feed():
            try:
                with open(fifo, "wb") as f:
                    for off in range(0, len(stream), chunk):
                        f.write(raw[off * 2:(off + chunk) * 2])
                        f.flush()
                        fed["n"] = min(off + chunk, len(stream))
                        time.sleep(0.01)   # let the decoder drain
            except BrokenPipeError:
                pass                       # the CLI stopped reading

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        err_lines = []
        drain = threading.Thread(target=lambda: err_lines.extend(p.stderr),
                                 daemon=True)
        drain.start()
        sel = selectors.DefaultSelector()
        sel.register(p.stdout, selectors.EVENT_READ)
        emit_at = {}
        t_end = time.time() + timeout
        # every line up to the CLI's end of output (or the time limit)
        while time.time() < t_end:
            if not sel.select(timeout=0.5):
                continue
            line = p.stdout.readline()
            if not line:
                break
            m = re.search(r"mmsi (\d+)", line)
            if m:
                emit_at.setdefault(int(m.group(1)), fed["n"])
        try:
            rc = p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        if t.is_alive():
            # nobody reads the FIFO any more: open and close it, so that
            # the feeder's open or write returns
            os.close(os.open(fifo, os.O_RDONLY | os.O_NONBLOCK))
            t.join(timeout=30)
        drain.join(timeout=30)
        sel.close()
        lat = sorted(emit_at[mm] - end for end, mm in zip(ends, mmsis)
                     if mm in emit_at)
        # frames decoded only at the end-of-file flush carry the capture's
        # tail as latency: keep the first 80 %
        return (lat[:max(1, int(len(lat) * 0.8))] if lat else [],
                len(emit_at), rc, "".join(err_lines))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def percentiles(lat) -> tuple:
    """(p50, p90) of sorted latencies, as the JAX tool picks them."""
    return lat[len(lat) // 2], lat[max(int(len(lat) * 0.9) - 1, 0)]


def parse_config(text: str):
    """"RxT:B" -> ("R T", B), "seq" -> (None, 0)."""
    if text == "seq":
        return None, 0
    shape, _, tb = text.partition(":")
    r, _, t = shape.partition("x")
    return f"{int(r)} {int(t)}", int(tb)


def run(configs: str = CONFIGS, device: str = "cuda",
        backend: Optional[str] = None, n_payloads: int = 40) -> list:
    """Every config of ``configs``; returns one dict a config: "config",
    "meshshape", "tb", "sb" (super-block), "decoded", "p50", "p90" (in
    samples; None if refused or nothing decoded), "refused"."""
    stream, ends, mmsis = build_capture(n_payloads)
    rows = []
    for text in configs.split():
        ms, tb = parse_config(text)
        sb = int(ms.split()[1]) * tb if ms else 0
        lat, n, rc, err = run_config(stream, ends, mmsis, ms, tb,
                                     device=device, backend=backend)
        refused = rc != 0 and "needs" in err and "devices" in err
        if rc and not refused:
            raise RuntimeError(f"{text}: the CLI exited {rc}: {err[-2000:]}")
        p50, p90 = percentiles(lat) if lat and not refused else (None, None)
        rows.append(dict(config=text, meshshape=ms, tb=tb, sb=sb, decoded=n,
                         total=len(mmsis), p50=p50, p90=p90, refused=refused))
    return rows


def format_row(r: dict) -> str:
    head = f"{r['config']:>10} {r['tb']:>6} {r['sb']:>7} |"
    if r["refused"]:
        return f"{head} refused by the CLI (a grid larger than the cards)"
    if r["p50"] is None:
        return f"{head} no frames decoded"
    return (f"{head} {r['p50']:>12} {r['p90']:>9} | "
            f"{r['p50'] / RATE:>9.2f}s   ({r['decoded']}/{r['total']} "
            f"decoded)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default=CONFIGS,
                    help='"RxT:timeparblock ..."; "seq" is the sequential '
                         'station')
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    from . import card
    from .device import resolve_device
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"latency_bench: {e}", file=sys.stderr)
        return 1
    rows = run(args.configs, args.device, args.backend)
    where = card.smi() if dev.type == "cuda" else "cpu"
    print(f"capture: {len(build_capture()[0])} samples, 40 frames "
          f"(sample-domain latency; seconds at the 48 kHz real-time rate); "
          f"{where}")
    print(f"{'meshshape':>10} {'tb':>6} {'sb':>7} | "
          f"{'p50 samples':>12} {'p90':>9} | {'p50 @48kHz':>10}")
    for r in rows:
        print(format_row(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
