"""Many-stream batch decoding (counterpart of
``gnuais_tpu/runtime/batch.py``): each capture is an independent mono
stream, all are decoded in lock-step blocks by one ``BatchPipeline``,
and messages are dispatched per stream with their own NMEA sequence
state.  Output lines carry a stream tag.
"""

from __future__ import annotations

import time as time_mod
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ais.dispatcher import ChannelDispatcher, DecodedMessage
from ..io.audio import load_capture

from . import trace
from .pipeline import BatchPipeline

# backend -> BatchPipeline flags
BACKENDS = {
    "exact": dict(),
    "fast": dict(fast_dpll=True),
    "fused": dict(fused_pipeline=True, device_crc=True),
}


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

    The session owns one int16 [N, block_len] staging buffer, made here
    and kept for every ``run``: page-locked (``pin_memory``, the default
    ``cudaHostAlloc`` flags) when the pipeline's device is CUDA, so that
    the upload is a DMA from it, and a plain array otherwise.  It takes
    N x block_len x 2 bytes whatever the streams' lengths (402,653,184
    for 4096 streams at the default block)."""

    def __init__(self, names: Sequence[str], block_len: int = 49_152,
                 frame_slots: int = 64, backend: str = "exact",
                 device: torch.device | str = "cuda",
                 message_callback: Optional[Callable] = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.names = list(names)
        n = len(self.names)
        self.pipe = BatchPipeline(n, block_len=block_len,
                                  frame_slots=frame_slots, device=device,
                                  **BACKENDS[backend])
        self.disp = [ChannelDispatcher("A") for _ in range(n)]
        self.message_callback = message_callback
        self.pinned = self.pipe.device.type == "cuda"
        if self.pinned:
            self.staging = torch.empty((n, block_len), dtype=torch.int16,
                                       pin_memory=True).numpy()
        else:
            self.staging = np.empty((n, block_len), dtype=np.int16)

    def run(self, streams: Sequence[np.ndarray]) -> BatchResult:
        """Decode ``streams`` (one array each, any lengths) block by
        block.  Each block, min(block_len, samples left) wide, is
        assembled in place into the session's staging buffer: a stream's
        samples, then zeros to the block's width for a stream that ends
        inside it (the buffer still holds the last block's).  The buffer
        goes to ``BatchPipeline.process`` whole at the full width, else as
        its first columns (padded there); the upload inside is
        synchronous, so the buffer is free again once ``process``
        returns.  Traced (``runtime.trace``): each block's
        assembly (``batch.assemble``) and everything after its decode
        returns, the messages, the lines, the callback and, after the
        last block, the counters table (``batch.deliver``);
        ``batch.blocks`` counts the blocks and ``batch.staged_pinned``
        those uploaded straight from the pinned buffer (full blocks on
        CUDA)."""
        n = len(self.names)
        if len(streams) != n:
            raise ValueError(f"{len(streams)} streams for {n} names")
        total = max(len(s) for s in streams)
        bl = self.pipe.block_len
        buf = self.staging
        res = BatchResult()
        t0 = time_mod.time()
        for off in range(0, total, bl):
            with trace.span("batch.assemble", mark=True):
                width = min(bl, total - off)
                for i, s in enumerate(streams):
                    seg = s[off:off + bl]
                    buf[i, :len(seg)] = seg
                    if len(seg) < width:
                        buf[i, len(seg):width] = 0
                block = buf if width == bl else buf[:, :width]
            per_stream = self.pipe.process(block)
            with trace.span("batch.deliver", mark=True):
                self._deliver(per_stream, res)
                res.samples += block.shape[0] * block.shape[1]
                if off + bl >= total:
                    self._tabulate(res)
            trace.count("batch.blocks")
            if self.pinned and block is buf:
                trace.count("batch.staged_pinned")
        if not total:
            self._tabulate(res)
        res.seconds = time_mod.time() - t0
        return res

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
                 device: torch.device | str = "cuda") -> BatchResult:
    """Load capture files (mono raw/WAV) and batch-decode them.
    ``replicate`` tiles the file list to simulate larger fleets."""
    streams: List[np.ndarray] = []
    names: List[str] = []
    loaded = {}
    for _ in range(replicate):
        for p in paths:
            if p not in loaded:
                data, nch = load_capture(p, channels=1)
                if nch != 1:
                    data = data[0::nch]   # channel A of multi-channel files
                loaded[p] = data
            streams.append(loaded[p])
            # names key the per-stream counters, so they must be unique
            names.append(f"s{len(names)}:{p.rsplit('/', 1)[-1]}")
    sess = BatchSession(names, block_len=block_len, backend=backend,
                        device=device)
    return sess.run(streams)
