"""Live capture input.

The reference reads soundcards via ALSA/PulseAudio (input.c,
pulseaudio.c).  In this framework the live-capture contract is a
*blocking block-stream*: anything that can deliver interleaved S16LE
PCM at 48 kHz works — a FIFO fed by an SDR chain (``rtl_fm ... |``),
stdin, a character device, or a socket.  This covers the reference's
capture surface without binding to a kernel sound API; an ALSA/Pulse
reader can implement the same interface where those libraries exist.

Recovery semantics mirror the reference: a short read is processed as
is, EOF ends the session (ais.c:215-230), transient errors retry like
the ALSA overrun path (input.c:113-121).
"""

from __future__ import annotations

import os
import sys
from typing import Iterator, Optional

import numpy as np

from gnuais_tpu_torch.io.audio import reference_block_frames


class LiveInput:
    """Blocking reader of interleaved S16LE frames from an fd/stream."""

    def __init__(self, source: str, channels: int = 1,
                 block_frames: Optional[int] = None):
        self.channels = channels
        self.block_frames = block_frames or reference_block_frames()
        if source == "-":
            self.fd = sys.stdin.buffer.fileno()
            self._close = False
        else:
            self.fd = os.open(source, os.O_RDONLY)
            self._close = True

    def read_block(self) -> Optional[np.ndarray]:
        """One interleaved block; None on EOF.  Short reads at stream
        end are returned (truncated to whole frames)."""
        want = self.block_frames * self.channels * 2
        buf = bytearray()
        while len(buf) < want:
            try:
                chunk = os.read(self.fd, want - len(buf))
            except InterruptedError:
                continue
            except OSError:
                if buf:
                    break
                return None
            if not chunk:
                break
            buf.extend(chunk)
        if not buf:
            return None
        n = (len(buf) // (2 * self.channels)) * (2 * self.channels)
        return np.frombuffer(bytes(buf[:n]), dtype="<i2")

    def blocks(self) -> Iterator[np.ndarray]:
        while True:
            b = self.read_block()
            if b is None or len(b) == 0:
                return
            yield b

    def close(self) -> None:
        if self._close:
            os.close(self.fd)


def daemonize(pidfile: Optional[str] = None) -> None:
    """Classic double-fork daemon + pidfile (ais.c:95-112,
    hlog.c:364-386)."""
    pid = os.fork()
    if pid > 0:
        os._exit(0)
    os.setsid()
    pid = os.fork()
    if pid > 0:
        os._exit(0)
    if pidfile:
        with open(pidfile, "w") as f:
            f.write(f"{os.getpid()}\n")
