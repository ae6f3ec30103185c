"""PulseAudio capture via ctypes -> libpulse-simple.

Equivalent of the reference's pulseaudio.c:31-66: a pa_simple record
stream, S16 native-endian, 48 kHz, 1-2 channels, selected by the
``SoundDevice pulse`` directive (ais.c:151).  Same blocking
block-stream contract as io.live.LiveInput / io.alsa.AlsaInput.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Iterator, Optional

import numpy as np

PA_STREAM_RECORD = 2
PA_SAMPLE_S16LE = 3        # == S16NE on little-endian


class _PaSampleSpec(ctypes.Structure):
    _fields_ = [("format", ctypes.c_int),
                ("rate", ctypes.c_uint32),
                ("channels", ctypes.c_uint8)]


def load_libpulse():
    for name in (ctypes.util.find_library("pulse-simple"),
                 "libpulse-simple.so.0", "libpulse-simple.so"):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.pa_simple_new.restype = ctypes.c_void_p
        lib.pa_simple_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int)]
        lib.pa_strerror.restype = ctypes.c_char_p
        return lib
    return None


def available() -> bool:
    return load_libpulse() is not None


class PulseInput:
    """Blocking PulseAudio record stream (pulseaudio.c:31-55)."""

    def __init__(self, channels: int = 1, rate: int = 48_000,
                 block_frames: int = 1024, app_name: str = "gnuais-tpu"):
        lib = load_libpulse()
        if lib is None:
            raise RuntimeError("libpulse-simple not available")
        self._lib = lib
        self.channels = channels
        self.block_frames = block_frames
        spec = _PaSampleSpec(PA_SAMPLE_S16LE, rate, channels)
        err = ctypes.c_int(0)
        self._s = lib.pa_simple_new(
            None, app_name.encode(), PA_STREAM_RECORD, None,
            b"record", ctypes.byref(spec), None, None, ctypes.byref(err))
        if not self._s:
            raise RuntimeError(
                f"pa_simple_new: {lib.pa_strerror(err).decode()}")
        self._buf = np.zeros(block_frames * channels, dtype="<i2")

    def read_block(self) -> Optional[np.ndarray]:
        err = ctypes.c_int(0)
        rc = self._lib.pa_simple_read(
            self._s, self._buf.ctypes.data_as(ctypes.c_void_p),
            self._buf.nbytes, ctypes.byref(err))
        if rc < 0:
            return None
        return self._buf.copy()

    def blocks(self) -> Iterator[np.ndarray]:
        while True:
            b = self.read_block()
            if b is None:
                return
            yield b

    def close(self) -> None:
        if getattr(self, "_s", None):
            self._lib.pa_simple_free(self._s)
            self._s = None
