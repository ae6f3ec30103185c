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
    """Decode N independent mono streams in lock-step blocks."""

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

    def run(self, streams: Sequence[np.ndarray]) -> BatchResult:
        """Decode ``streams`` (one array each, any lengths) block by
        block.  Traced (``runtime.trace``): each block's assembly
        (``batch.assemble``) and everything after its decode returns,
        the messages, the lines, the callback and, after the last block,
        the counters table (``batch.deliver``); ``batch.blocks`` counts
        the blocks."""
        n = len(self.names)
        if len(streams) != n:
            raise ValueError(f"{len(streams)} streams for {n} names")
        total = max(len(s) for s in streams)
        bl = self.pipe.block_len
        res = BatchResult()
        t0 = time_mod.time()
        for off in range(0, total, bl):
            with trace.span("batch.assemble", mark=True):
                block = np.zeros((n, min(bl, total - off)), dtype=np.int16)
                for i, s in enumerate(streams):
                    seg = s[off:off + bl]
                    block[i, :len(seg)] = seg
            per_stream = self.pipe.process(block)
            with trace.span("batch.deliver", mark=True):
                self._deliver(per_stream, res)
                res.samples += block.shape[0] * block.shape[1]
                if off + bl >= total:
                    self._tabulate(res)
            trace.count("batch.blocks")
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
