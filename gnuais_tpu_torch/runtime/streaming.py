"""Pipelined streaming decode: overlap device work with host ingest and
drain (counterpart of ``gnuais_tpu/runtime/streaming.py``).

``PipelinedDecoder`` keeps up to ``depth`` blocks in flight: ``submit``
enqueues a block and returns at once, and completed blocks drain lazily,
so the card decodes block k+1 while the host unpacks block k's frames.

On ``cuda`` everything runs in order on the device's current stream.
Each block is copied into one of ``depth + 1`` pinned host buffers and
from there to the card with ``non_blocking=True``; a buffer is refilled
only after an event says the copy that read it has finished.  The step
follows on the same stream, so the carry it reads is the one the
previous block's step wrote.  The block's frames are copied back into
pinned memory right after its step, and an event is recorded after those
copies; the drain waits on that event and reads the host copies, so
draining block k never waits for block k+1's step.  On ``cpu`` (asked
for explicitly) there are no pinned buffers or events.

On the card every step (``fused_pipeline``, and ``fused_frontend``,
``fast_dpll`` and the exact chain, which run B3 or B4 and the deframer
kernel there) is left running when ``submit`` returns.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Iterable, List, Optional

import numpy as np
import torch

from ..golden.model import Frame

from ..ops import demod
from .pipeline import BatchPipeline


class PipelinedDecoder:
    """``BatchPipeline`` with a submit/drain split and a bounded
    in-flight queue.  Results come out in submission order.

    ``superblock`` > 1 lets each ``submit`` carry up to that many
    ``block_len`` blocks, decoded by one ``step_superblock``."""

    def __init__(self, n_streams: int, block_len: int = 49_152,
                 frame_slots: int = 32, fast_dpll: bool = False,
                 fused_frontend: bool = False, fused_pipeline: bool = False,
                 device_crc: bool = False, depth: int = 2,
                 superblock: int = 1,
                 device: torch.device | str = "cuda"):
        self.pipe = BatchPipeline(n_streams, block_len=block_len,
                                  frame_slots=frame_slots,
                                  fast_dpll=fast_dpll,
                                  fused_frontend=fused_frontend,
                                  fused_pipeline=fused_pipeline,
                                  device_crc=device_crc, device=device)
        self.depth = depth
        self.superblock = max(1, superblock)
        # (frames, n_blocks or 0 for one unstacked block, event or None)
        self._pending: Deque = deque()
        # pinned host buffers, made at first use, and for each the event
        # recorded after the copy that last read it
        self._ring: List[Optional[torch.Tensor]] = [None] * (depth + 1)
        self._copied: List[Optional[torch.cuda.Event]] = [None] * (depth + 1)
        self._next = 0

    @property
    def counters(self):
        return self.pipe.counters

    def _upload(self, samples: np.ndarray, total: int) -> torch.Tensor:
        """``samples`` [S, n] zero-padded to [S, total] on the device."""
        s, n = samples.shape
        if self.pipe.device.type != "cuda":
            padded = np.zeros((s, total), dtype=np.int16)
            padded[:, :n] = samples
            return torch.from_numpy(padded)
        i = self._next
        self._next = (i + 1) % len(self._ring)
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        if self._ring[i] is None:
            self._ring[i] = torch.empty(
                s * self.superblock * self.pipe.block_len, dtype=torch.int16,
                pin_memory=True)
        host = self._ring[i][:s * total].view(s, total)
        buf = host.numpy()
        buf[:, :n] = samples
        buf[:, n:] = 0
        dev = host.to(self.pipe.device, non_blocking=True)
        self._copied[i] = torch.cuda.Event()
        self._copied[i].record(torch.cuda.current_stream(self.pipe.device))
        return dev

    def _dispatch(self, samples: np.ndarray):
        p = self.pipe
        s, n = samples.shape
        if s != p.n_streams or n > self.superblock * p.block_len:
            raise ValueError(f"block {samples.shape} does not fit "
                             f"[{p.n_streams}, <= "
                             f"{self.superblock * p.block_len}]")
        if self.superblock > 1:
            k = max(1, -(-n // p.block_len))
            frames, _peak = p.step_superblock(
                self._upload(samples, k * p.block_len), n, k)
        else:
            k = 0
            frames, _peak = p.step(self._upload(samples, p.block_len), n)
        if p.device.type != "cuda":
            return frames, k, None
        host = demod.FrameBatch(*(x.to("cpu", non_blocking=True)
                                  for x in frames))
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(p.device))
        return host, k, done

    def _drain_one(self) -> List[List[Frame]]:
        frames, k, done = self._pending.popleft()
        if done is not None:
            done.synchronize()
        return self.pipe.drain(frames, k)

    def submit(self, samples: np.ndarray) -> Optional[List[List[Frame]]]:
        """Enqueue a (super)block [S, n]; returns the oldest one's
        per-stream frames once more than ``depth`` are in flight, else
        None."""
        self._pending.append(self._dispatch(samples))
        if len(self._pending) > self.depth:
            return self._drain_one()
        return None

    def flush(self) -> List[List[List[Frame]]]:
        """Drain every block in flight (call at the end of the stream)."""
        out = []
        while self._pending:
            out.append(self._drain_one())
        return out

    def run(self, blocks: Iterable[np.ndarray]) -> List[List[List[Frame]]]:
        """Pump [S, n] blocks through the pipeline; returns per-block
        per-stream frames in order."""
        results: List[List[List[Frame]]] = []
        for b in blocks:
            r = self.submit(b)
            if r is not None:
                results.append(r)
        results.extend(self.flush())
        return results
