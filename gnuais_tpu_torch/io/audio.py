"""Audio capture input: raw interleaved S16 files, WAV, and block
iteration matching the reference main-loop framing.

The reference reads 1020-frame blocks in file mode (1024 rounded down
to a multiple of 5 samples/bit, ais.c:179-182) and processes whatever a
short final read returns.  Block framing is observable (it decides the
interleaving order of channel A/B output lines), so the default mirrors
it exactly.
"""

from __future__ import annotations

import io
import os
import struct
import wave
from pathlib import Path
from typing import Iterator, Optional, Tuple, Union

import numpy as np

from gnuais_tpu_torch.constants import SAMPLES_PER_BIT


def reference_block_frames(requested: int = 1024) -> int:
    """File/pulse-mode block size: round down to a samples-per-bit
    multiple (ais.c:156-158,179-181)."""
    return requested - (requested % SAMPLES_PER_BIT)


def read_raw_s16(path: Union[str, Path], channels: int = 1) -> np.ndarray:
    """Read a raw interleaved little-endian S16 capture.

    Returns the interleaved int16 array (length truncated to a whole
    number of frames).
    """
    data = np.fromfile(str(path), dtype="<i2")
    n = (len(data) // channels) * channels
    return data[:n]


def read_wav(path: Union[str, Path]) -> Tuple[np.ndarray, int, int]:
    """Read a 16-bit PCM WAV file -> (interleaved int16, channels, rate)."""
    with wave.open(str(path), "rb") as w:
        nch = w.getnchannels()
        rate = w.getframerate()
        if w.getsampwidth() != 2:
            raise ValueError("only 16-bit PCM WAV supported")
        raw = w.readframes(w.getnframes())
    return np.frombuffer(raw, dtype="<i2"), nch, rate


def write_raw_s16(path: Union[str, Path], interleaved: np.ndarray) -> None:
    np.asarray(interleaved, dtype="<i2").tofile(str(path))


def write_wav(path: Union[str, Path], interleaved: np.ndarray,
              channels: int = 1, rate: int = 48_000) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(interleaved, dtype="<i2").tobytes())


def load_capture(path: Union[str, Path], channels: int = 1) -> Tuple[np.ndarray, int]:
    """Load .wav or raw S16; returns (interleaved int16, channels)."""
    p = str(path)
    if p.lower().endswith(".wav"):
        data, nch, rate = read_wav(p)
        if rate != 48_000:
            raise ValueError(f"expected 48 kHz capture, got {rate}")
        return data, nch
    return read_raw_s16(p, channels), channels


def open_capture_lazy(path: Union[str, Path],
                      channels: int = 1) -> Tuple[np.ndarray, int]:
    """Like load_capture, but raw S16 files come back as a read-only
    np.memmap — the streaming decode paths then hold O(super_block)
    host memory regardless of capture size.  WAV falls back to a full
    read (header parsing owns the offset)."""
    p = str(path)
    if p.lower().endswith(".wav"):
        return load_capture(p, channels)
    if os.path.getsize(p) == 0:
        # np.memmap raises ValueError on empty files, which the CLI's
        # OSError handler would not catch; the eager reader returns an
        # empty array and keeps the reference's clean error path
        return load_capture(p, channels)
    mm = np.memmap(p, dtype="<i2", mode="r")
    n = (len(mm) // channels) * channels
    return mm[:n], channels


def iter_blocks(interleaved: np.ndarray, channels: int,
                block_frames: Optional[int] = None) -> Iterator[np.ndarray]:
    """Yield interleaved blocks of block_frames frames (last may be
    short), mirroring the reference fread loop."""
    bf = block_frames or reference_block_frames()
    step = bf * channels
    for off in range(0, len(interleaved), step):
        blk = interleaved[off : off + step]
        if len(blk) == 0:
            break
        # truncate trailing partial frame like fread's whole-item count
        n = (len(blk) // channels) * channels
        if n:
            yield blk[:n]


def deinterleave(block: np.ndarray, channels: int, ch_ofs: int) -> np.ndarray:
    """Extract one channel from an interleaved block (filter_run_buf's
    step/offset walk, filter.c:106-137)."""
    return block[ch_ofs::channels]
