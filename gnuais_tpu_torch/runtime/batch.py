"""Many-stream batch decoding (counterpart of
``gnuais_tpu/runtime/batch.py``): each capture is an independent mono
stream, all are decoded in lock-step blocks by one ``BatchPipeline``,
and messages are dispatched per stream with their own NMEA sequence
state.  Output lines carry a stream tag.

A session takes int16 audio at 48 kHz or, with ``iq``, raw float32 I/Q
rails at 48 kHz x ``decim``, FM-demodulated on the pipeline's device
(``ops.discriminator``) and handed to the pipeline there.
"""

from __future__ import annotations

import time as time_mod
import weakref
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ais.dispatcher import ChannelDispatcher, DecodedMessage
from ..io.audio import load_capture
from ..io.iq import channel_rails
from ..ops.discriminator import design_decim_fir, init_iq, iq_to_int16_audio

from . import trace
from .pipeline import BatchPipeline

# backend -> BatchPipeline flags
BACKENDS = {
    "exact": dict(),
    "fast": dict(fast_dpll=True),
    "fused": dict(fused_pipeline=True, device_crc=True),
}
# the IQ front end's decimator taps, and the IQ samples a stream of one
# front-end call: its float32 temporaries stay [N, IQ_CHUNK] (1 GiB each
# for 4096 streams) whatever the block
IQ_TAPS = 64
IQ_CHUNK = 1 << 16
# the threads that stage a block's IQ rails, each a range of streams
IQ_STAGING_THREADS = 4


@dataclass
class BatchResult:
    lines: List[str] = field(default_factory=list)
    messages: List[DecodedMessage] = field(default_factory=list)
    counters: Dict[str, tuple] = field(default_factory=dict)
    samples: int = 0
    seconds: float = 0.0

    @property
    def samples_per_sec(self) -> float:
        return self.samples / self.seconds if self.seconds else 0.0


class BatchSession:
    """Decode N independent mono streams in lock-step blocks.

    The session owns one staging buffer, made here and kept for every
    ``run``: int16 [N, block_len] for audio, or with ``iq`` float32
    [2, N, block_len x decim] for the I and Q rails; page-locked
    (``pin_memory``, the default ``cudaHostAlloc`` flags) when the
    pipeline's device is CUDA, so that the upload is a DMA from it, and a
    plain array otherwise.  It takes N x block_len x 2 bytes for audio
    (402,653,184 for 4096 streams at the default block) and 16 x decim
    times that for IQ, whatever the streams' lengths.

    With ``iq`` each stream is a pair of float32 rails (I, Q) at 48 kHz x
    ``decim``, of a whole number of ``decim`` groups.  The front end's
    carry (``ops.discriminator.IqState``) is kept per stream across
    ``run`` calls, so that block-wise audio equals one-shot audio bit for
    bit; each block's int16 audio goes to the pipeline on the device and
    stays there as ``audio`` until the next block."""

    def __init__(self, names: Sequence[str], block_len: int = 49_152,
                 frame_slots: int = 64, backend: str = "exact",
                 device: torch.device | str = "cuda",
                 message_callback: Optional[Callable] = None,
                 iq: bool = False, decim: int = 4):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if iq and decim < 1:
            raise ValueError(f"decim {decim} < 1")
        self.names = list(names)
        n = len(self.names)
        self.pipe = BatchPipeline(n, block_len=block_len,
                                  frame_slots=frame_slots, device=device,
                                  **BACKENDS[backend])
        self.disp = [ChannelDispatcher("A") for _ in range(n)]
        self.message_callback = message_callback
        self.pinned = self.pipe.device.type == "cuda"
        self.iq = iq
        self.decim = decim
        shape, dtype = (((2, n, block_len * decim), torch.float32) if iq
                        else ((n, block_len), torch.int16))
        if self.pinned:
            self.staging = torch.empty(shape, dtype=dtype,
                                       pin_memory=True).numpy()
        else:
            self.staging = np.empty(shape, dtype=np.float32 if iq
                                    else np.int16)
        self.audio: Optional[torch.Tensor] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        if iq:
            dev = self.pipe.device
            self.iq_state = init_iq(n, IQ_TAPS, dev)
            self.taps = torch.from_numpy(
                design_decim_fir(decim, IQ_TAPS)).to(dev)

    def _length(self, stream) -> int:
        """A stream's length in audio samples."""
        if not self.iq:
            return len(stream)
        i, q = stream
        if len(i) != len(q) or len(i) % self.decim:
            raise ValueError(f"IQ rails of {len(i)} and {len(q)} samples: "
                             f"not equal whole groups of {self.decim}")
        return len(i) // self.decim

    def run(self, streams: Sequence) -> BatchResult:
        """Decode ``streams`` (one array each, any lengths; with ``iq`` one
        (I, Q) pair of rails each) block by block.  Each block, min(
        block_len, samples left) wide, is assembled in place into the
        session's staging buffer: a stream's samples, then zeros to the
        block's width for a stream that ends inside it (the buffer still
        holds the last block's).  The buffer goes to
        ``BatchPipeline.process`` whole at the full width, else as its
        first columns (padded there); the upload inside is synchronous, so
        the buffer is free again once ``process`` returns.  With ``iq``
        the buffer's rails are uploaded and demodulated here instead
        (``_demodulate``), a short stream's audio zeroed past its end as
        the int16 path pads, and the device audio goes to ``process``.
        Traced (``runtime.trace``): each block's assembly
        (``batch.assemble``), with ``iq`` its upload (``iq.upload``) and
        front end (``iq.frontend``), and everything after its decode
        returns, the messages, the lines, the callback and, after the
        last block, the counters table (``batch.deliver``);
        ``batch.blocks`` counts the blocks, ``batch.staged_pinned`` those
        uploaded straight from the pinned buffer (full blocks on CUDA),
        ``iq.h2d_bytes`` the rails' bytes uploaded and ``iq.samples`` the
        IQ samples demodulated."""
        n = len(self.names)
        if len(streams) != n:
            raise ValueError(f"{len(streams)} streams for {n} names")
        lengths = [self._length(s) for s in streams]
        total = max(lengths, default=0)
        bl = self.pipe.block_len
        buf = self.staging
        res = BatchResult()
        t0 = time_mod.time()
        for off in range(0, total, bl):
            with trace.span("batch.assemble", mark=True):
                width = min(bl, total - off)
                if self.iq:
                    block = self._assemble_iq(streams, off, width)
                else:
                    for i, s in enumerate(streams):
                        seg = s[off:off + bl]
                        buf[i, :len(seg)] = seg
                        if len(seg) < width:
                            buf[i, len(seg):width] = 0
                    block = buf if width == bl else buf[:, :width]
            if self.iq:
                self._demodulate(block, [ln - off for ln in lengths], width)
                per_stream = self.pipe.process(self.audio)
            else:
                per_stream = self.pipe.process(block)
            with trace.span("batch.deliver", mark=True):
                self._deliver(per_stream, res)
                res.samples += n * width
                if off + bl >= total:
                    self._tabulate(res)
            trace.count("batch.blocks")
            if self.pinned and block is buf:
                trace.count("batch.staged_pinned")
        if not total:
            self._tabulate(res)
        res.seconds = time_mod.time() - t0
        return res

    def _assemble_iq(self, streams, off: int, width: int) -> np.ndarray:
        """The rails of audio samples [off, off + width) of every stream
        into the staging buffer; zeros past a stream's end.  The streams
        are split into ``IQ_STAGING_THREADS`` ranges, each copied by a
        thread of the session's pool (numpy's copies release the GIL)."""
        buf, d = self.staging, self.decim
        lo, w = off * d, width * d

        def rows(a: int, b: int) -> None:
            for k in range(a, b):
                i, q = streams[k]
                seg = i[lo:lo + w]
                buf[0, k, :len(seg)] = seg
                buf[1, k, :len(seg)] = q[lo:lo + w]
                if len(seg) < w:
                    buf[:, k, len(seg):w] = 0

        n = len(streams)
        threads = min(IQ_STAGING_THREADS, n)
        if threads > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    threads, thread_name_prefix="iq-staging")
                weakref.finalize(self, self._pool.shutdown, wait=False)
            edges = np.linspace(0, n, threads + 1).astype(int).tolist()
            for f in [self._pool.submit(rows, a, b)
                      for a, b in zip(edges[:-1], edges[1:])]:
                f.result()
        else:
            rows(0, n)
        return buf if w == buf.shape[2] else buf[:, :, :w]

    def _demodulate(self, block: np.ndarray, left: Sequence[int],
                    width: int) -> None:
        """Upload the staged rails ``block`` [2, N, width x decim] and run
        the front end over them in ``IQ_CHUNK`` pieces, advancing the
        carry; ``audio`` becomes the block's int16 [N, width] on the
        device, each stream's columns from ``left`` (its samples left)
        on zeroed."""
        d = self.decim
        with trace.span("iq.upload", mark=True):
            # a copy on the CPU too: the carry must not alias the buffer
            rails = torch.from_numpy(block).to(self.pipe.device, copy=True)
            trace.count("iq.h2d_bytes", block.nbytes)
        with trace.span("iq.frontend", mark=True):
            step = max(d, IQ_CHUNK - IQ_CHUNK % d)
            pieces = []
            for lo in range(0, width * d, step):
                audio, self.iq_state = iq_to_int16_audio(
                    rails[0, :, lo:lo + step], rails[1, :, lo:lo + step],
                    self.iq_state, self.taps, d)
                pieces.append(audio)
            audio = pieces[0] if len(pieces) == 1 else torch.cat(pieces, 1)
            for k, ln in enumerate(left):
                if ln < width:
                    audio[k, max(ln, 0):] = 0
            trace.count("iq.samples", rails[0].numel())
        self.audio = audio

    def _deliver(self, per_stream, res: BatchResult) -> None:
        for i, frames in enumerate(per_stream):
            for fr in frames:
                msg = self.disp[i].dispatch(fr.payload_bits, fr.bufferlen)
                if msg is None:
                    continue
                res.messages.append(msg)
                if msg.stdout_line:
                    res.lines.append(f"[{self.names[i]}] {msg.stdout_line}")
                if self.message_callback:
                    self.message_callback(i, msg)

    def _tabulate(self, res: BatchResult) -> None:
        for i, name in enumerate(self.names):
            c = self.pipe.counters[i]
            res.counters[name] = (c.receivedframes, c.lostframes,
                                  c.lostframes2)


def decode_files(paths: Sequence[str], replicate: int = 1,
                 block_len: int = 49_152, backend: str = "exact",
                 device: torch.device | str = "cuda",
                 iq_decim: Optional[int] = None,
                 iq_channels: int = 1) -> BatchResult:
    """Load capture files (mono raw/WAV) and batch-decode them.
    ``replicate`` tiles the file list to simulate larger fleets.  With
    ``iq_decim`` the files are raw float32 I/Q at 48 kHz x ``iq_decim``
    of ``iq_channels`` AIS channels (``io.iq``'s layout), mapped and
    demodulated on the device; of a multi-channel file, as of audio, the
    batch decodes channel A."""
    streams: List = []
    names: List[str] = []
    loaded = {}
    for _ in range(replicate):
        for p in paths:
            if p not in loaded and iq_decim is not None:
                loaded[p] = channel_rails(p, iq_channels, iq_decim)
            elif p not in loaded:
                data, nch = load_capture(p, channels=1)
                if nch != 1:
                    data = data[0::nch]   # channel A of multi-channel files
                loaded[p] = data
            streams.append(loaded[p])
            # names key the per-stream counters, so they must be unique
            names.append(f"s{len(names)}:{p.rsplit('/', 1)[-1]}")
    sess = BatchSession(names, block_len=block_len, backend=backend,
                        device=device, iq=iq_decim is not None,
                        decim=iq_decim or 4)
    return sess.run(streams)
