"""Streaming raw-IQ input: a memmapped float32 I/Q file, a FIFO or stdin
-> interleaved int16 audio blocks at 48 kHz, demodulated on the device
in O(block) host memory (counterpart of ``gnuais_tpu/io/iq.py``).

The front end (``ops.discriminator``) runs once a block with its
explicit carry (the last IQ sample and the decimation FIR's history), so
the decode paths see IQ input exactly like a soundcard stream.

File layout: raw little-endian float32, frames of ``channels`` complex
pairs — mono: [I Q]*, stereo (AIS channels A and B): [Ia Qa Ib Qb]*.
Output blocks are interleaved int16 like a recorded soundcard capture
(channel A at offset 0).

Block-wise demodulation equals a one-shot call bit for bit: every
output sample is the same sum either way.  ``blocks(skip_frames=...)``
of the file reader rebuilds the carry exactly from the samples before
the resume point (``_state_at``).
"""

from __future__ import annotations

import functools
import os
import sys
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..ops.discriminator import (IqState, design_decim_fir, fm_discriminate,
                                 init_iq, iq_to_int16_audio)


@functools.lru_cache(maxsize=None)
def _taps(decim: int, ntaps: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(design_decim_fir(decim, ntaps)).to(device)


def _iq_step(decim: int, ntaps: int, device: torch.device):
    """The front end step the file and live readers share (the same
    taps, the same arithmetic): host rails in, int16 audio [ch, n] on
    the host and the new state (on ``device``) out."""
    taps = _taps(decim, ntaps, device)

    def step(ii: np.ndarray, qq: np.ndarray, state: IqState):
        audio, state = iq_to_int16_audio(
            torch.from_numpy(ii).to(device), torch.from_numpy(qq).to(device),
            state, taps, decim)
        return audio.cpu().numpy(), state

    return step


def _interleave(a: np.ndarray, channels: int) -> np.ndarray:
    """[ch, n] int16 -> the interleaved block (mono: row 0 itself)."""
    if channels == 1:
        return a[0]
    out = np.empty(a.shape[1] * channels, np.int16)
    for c in range(channels):
        out[c::channels] = a[c]
    return out


def _rails(raw: np.ndarray, channels: int):
    """Interleaved float32 frames -> split (i, q) rails, each [ch, n]."""
    fr = raw.reshape(-1, channels, 2)
    return (np.ascontiguousarray(fr[:, :, 0].T),
            np.ascontiguousarray(fr[:, :, 1].T))


def channel_rails(path: str, channels: int = 1, decim: int = 4):
    """The (I, Q) rails of channel A of a raw IQ capture file of
    ``channels`` AIS channels, as strided views of its memory map, cut to
    whole groups of ``decim`` samples (fread's whole items)."""
    if os.path.getsize(path) == 0:
        mm = np.zeros((0,), dtype="<f4")
    else:
        mm = np.memmap(path, dtype="<f4", mode="r")
    vpf = 2 * channels * decim
    fr = mm[:len(mm) // vpf * vpf].reshape(-1, channels, 2)
    return fr[:, 0, 0], fr[:, 0, 1]


class IqLiveReader:
    """Live raw-IQ input: a blocking FIFO, stream or stdin source of the
    same interleaved float32 I/Q frames as ``IqStreamReader``.

    The front end's carry (``IqState``) chains across reads, so the
    audio is byte for byte that of decoding the same bytes from a file.
    Reads block until whole groups of ``decim`` IQ samples arrive; EOF
    drops a trailing partial group, like the file reader's whole-item
    semantics."""

    NTAPS = 64

    def __init__(self, source: str, channels: int = 1, decim: int = 4,
                 block_frames: int = 1 << 16,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.channels = channels
        self.decim = decim
        self.block_frames = block_frames
        self._vpf = 2 * channels * decim         # f32 values per frame
        if source == "-":
            self._fd = sys.stdin.buffer.fileno()
            self._close_fd = False
        else:
            self._fd = os.open(source, os.O_RDONLY)
            self._close_fd = True

    def _read_frames(self, want_frames: int):
        """Blocking read of up to want_frames output frames' worth of IQ
        bytes; returns (i_rails, q_rails) float32 [ch, n*decim] or None
        at EOF."""
        want = want_frames * self._vpf * 4
        buf = bytearray()
        while len(buf) < want:
            try:
                chunk = os.read(self._fd, want - len(buf))
            except InterruptedError:
                continue
            except OSError:
                if buf:
                    break
                return None
            if not chunk:
                break
            buf.extend(chunk)
        nf = len(buf) // (self._vpf * 4)
        if nf == 0:
            return None
        raw = np.frombuffer(bytes(buf[:nf * self._vpf * 4]), dtype="<f4")
        return _rails(raw, self.channels)

    def blocks(self, skip_frames: int = 0) -> Iterator[np.ndarray]:
        """Yield interleaved int16 audio blocks.  skip_frames: decode and
        discard that many output frames first (resume: the carry evolves
        through the skipped data, which is exact for a re-fed stream)."""
        step = _iq_step(self.decim, self.NTAPS, self.device)
        state = init_iq(self.channels, self.NTAPS, self.device)
        to_skip = skip_frames
        while True:
            rails = self._read_frames(self.block_frames)
            if rails is None:
                return
            a, state = step(*rails, state)                # [ch, nf]
            if to_skip:
                drop = min(to_skip, a.shape[1])
                a = a[:, drop:]
                to_skip -= drop
                if a.shape[1] == 0:
                    continue
            yield _interleave(a, self.channels)

    def read_all(self, skip_frames: int = 0) -> np.ndarray:
        parts = list(self.blocks(skip_frames))
        if not parts:
            return np.zeros((0,), np.int16)
        return np.concatenate(parts)

    def close(self):
        if self._close_fd:
            os.close(self._fd)
            self._close_fd = False


class IqStreamReader:
    """Iterate demodulated int16 audio blocks from a raw IQ capture file.

    channels: 1 or 2 AIS channels (independent IQ streams, interleaved a
    frame at a time).  decim: input rate = 48 kHz * decim.  block_frames:
    output audio frames a yielded block.  The front end runs on
    ``device``.
    """

    NTAPS = 64

    def __init__(self, path: str, channels: int = 1, decim: int = 4,
                 block_frames: int = 1 << 16,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.path = str(path)
        self.channels = channels
        self.decim = decim
        self.block_frames = block_frames
        if os.path.getsize(self.path) == 0:
            self._mm = np.zeros((0,), dtype="<f4")
        else:
            self._mm = np.memmap(self.path, dtype="<f4", mode="r")
        vpf = 2 * channels * decim          # f32 values per output frame
        # fread whole-item semantics: trailing partial frames dropped
        self.n_frames = len(self._mm) // vpf
        self._vpf = vpf

    def _iq_slice(self, f0: int, f1: int):
        """Split I/Q rails (i, q), each float32 [channels, (f1-f0)*decim],
        for output frames [f0, f1)."""
        lo, hi = f0 * self._vpf, f1 * self._vpf
        return _rails(np.asarray(self._mm[lo:hi], dtype=np.float32),
                      self.channels)

    def _state_at(self, frame: int) -> IqState:
        """The exact front end carry for a resume at output frame
        ``frame``: last_iq is the preceding IQ sample; the decimator's
        history is the discriminated audio of the NTAPS preceding
        high-rate samples (from NTAPS+1 IQ samples), zero-padded at the
        stream's start — as if streamed from sample 0."""
        st = init_iq(self.channels, self.NTAPS, self.device)
        if frame <= 0:
            return st
        dev = self.device
        pos = frame * self.decim                 # high-rate sample index
        lo = max(pos - self.NTAPS, 0)            # history covers [lo, pos)
        lo_f = max(lo - 1, 0) // self.decim
        base = lo_f * self.decim
        ii, qq = self._iq_slice(lo_f, frame)     # abs samples [base, pos)
        if lo == 0:
            # stream start: the discriminator's initial sample is 1+0j
            pi0, pq0 = st.last_i, st.last_q
        else:
            pi0 = torch.from_numpy(ii[:, lo - 1 - base].copy()).to(dev)
            pq0 = torch.from_numpy(qq[:, lo - 1 - base].copy()).to(dev)
        wi = np.ascontiguousarray(ii[:, lo - base:])          # [lo, pos)
        wq = np.ascontiguousarray(qq[:, lo - base:])
        audio_hi, _li, _lq = fm_discriminate(
            torch.from_numpy(wi).to(dev), torch.from_numpy(wq).to(dev),
            pi0, pq0)
        hist = torch.zeros((self.channels, self.NTAPS), dtype=torch.float32,
                           device=dev)
        hist[:, self.NTAPS - audio_hi.shape[1]:] = audio_hi
        return st._replace(
            last_i=torch.from_numpy(ii[:, -1].copy()).to(dev),
            last_q=torch.from_numpy(qq[:, -1].copy()).to(dev),
            fir_history=hist)

    def blocks(self, skip_frames: int = 0) -> Iterator[np.ndarray]:
        """Yield interleaved int16 audio blocks of block_frames frames
        (the last may be short), from output frame ``skip_frames`` on,
        with the carry rebuilt exactly."""
        if skip_frames >= self.n_frames:
            return
        step = _iq_step(self.decim, self.NTAPS, self.device)
        state = self._state_at(skip_frames)
        f = skip_frames
        while f < self.n_frames:
            f1 = min(f + self.block_frames, self.n_frames)
            a, state = step(*self._iq_slice(f, f1), state)   # [ch, f1-f]
            yield _interleave(a, self.channels)
            f = f1

    def read_all(self, skip_frames: int = 0) -> np.ndarray:
        """The whole demodulated audio (for the whole-capture lane
        decode; it is 8*decim/channels times smaller than the IQ file,
        which stays memmapped)."""
        parts = list(self.blocks(skip_frames))
        if not parts:
            return np.zeros((0,), np.int16)
        return np.concatenate(parts)

    def close(self):
        self._mm = None
