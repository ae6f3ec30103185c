"""Failure detection and automatic mid-run recovery.

The reference's recovery surface is reactive and local: ALSA overrun
re-prepare (input.c:113-121), MySQL reconnect (out_mysql.c:88-96) and a
swallowed SIGPIPE (ais.c:58-61) — a crash loses all in-flight decoder
state (SURVEY.md §5).  Here the whole decoder is a small explicit carry
pytree, so recovery can be *exact*: the supervisor checkpoints the
carry + counters every N blocks (atomic rename), keeps the undelivered
blocks since the last checkpoint in a replay buffer, and on any decode
failure (device error, wedged transfer, ...) rebuilds the pipeline,
restores the checkpoint and replays — producing bit-for-bit the output
of an uninterrupted run.  A process crash recovers the same way via
``resume_offset()`` (re-seek the input and go).

Deliver-once semantics: replayed blocks that were already delivered
before the failure are decoded again (the carry needs their samples)
but their frames are suppressed; only the failed block's frames are
returned.

On CUDA a rebuild recovers from a failure raised as a Python exception
(an out-of-memory error, a failed launch, a wedged host read), as on
the TPU.  It cannot clear a sticky CUDA error: after an illegal address
or a device-side assert the context is lost for the whole process, and
every retry raises again until ``DecodeFailure``.  The process then
recovers by ``resume_offset()`` in a new process.  The rebuild uses the
same factory, so it stays on the pipeline's device: nothing falls back
to the CPU.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Callable, List, Optional, Union

import numpy as np

from ..golden.model import Frame
from .checkpoint import restore_pipeline, save_pipeline
from .pipeline import BatchPipeline, init_carry


class DecodeFailure(RuntimeError):
    """Raised when a block cannot be decoded within max_retries."""


class SupervisedDecoder:
    """Wraps a BatchPipeline with checkpoint/replay crash recovery.

    make_pipeline: zero-arg factory returning a fresh BatchPipeline —
    called once at start and again after every failure (a rebuild drops
    the pipeline's device tensors; the kernel library stays loaded, which
    makes this cheap).
    checkpoint_every: blocks between snapshots.  The replay buffer holds
    up to that many blocks in host memory (S * block_len * 2 bytes
    each — size checkpoint_every accordingly at large S).
    on_event: optional callback(kind: str, detail: dict) for
    observability ("checkpoint", "failure", "recovered", "resumed").
    """

    def __init__(self, make_pipeline: Callable[[], BatchPipeline],
                 checkpoint_path: Union[str, Path],
                 checkpoint_every: int = 16,
                 max_retries: int = 3,
                 retry_backoff: float = 0.5,
                 on_event: Optional[Callable[[str, dict], None]] = None):
        self.make_pipeline = make_pipeline
        self.path = Path(checkpoint_path)
        self.every = max(1, checkpoint_every)
        self.max_retries = max_retries
        self.backoff = retry_backoff
        self.on_event = on_event
        self.pipe = make_pipeline()
        self.blocks_done = 0           # blocks fully decoded + delivered
        self._ckpt_blocks = 0          # blocks covered by the checkpoint
        self._samples_done = 0
        self._replay: List[np.ndarray] = []
        # hook: () -> dict of extra downstream state to snapshot (e.g.
        # the NMEA dispatcher's rolling seqnr); restored copy exposed in
        # ``restored_extra`` for the caller to reinstall
        self.extra_meta: Optional[Callable[[], dict]] = None
        self.restored_extra: dict = {}
        if self.path.exists():
            # blocks_done stays 0: it is only the checkpoint-cadence /
            # event counter, relative to this process's start
            self._samples_done, self.restored_extra = \
                restore_pipeline(self.path, self.pipe)
            self._emit("resumed", {"samples_consumed": self._samples_done})

    # -- public -----------------------------------------------------------

    def resume_offset(self) -> int:
        """Samples already consumed (0 for a fresh run): seek the input
        here before feeding blocks."""
        return self._samples_done

    def reset(self) -> None:
        """Discard the restored state and start fresh (used when a
        multi-channel resume is inconsistent: channel checkpoints taken
        at different offsets cannot resume exactly)."""
        self.pipe = self.make_pipeline()
        self.blocks_done = self._ckpt_blocks = 0
        self._samples_done = 0
        self._replay.clear()
        self.restored_extra = {}

    @property
    def counters(self):
        return self.pipe.counters

    def process(self, samples: np.ndarray) -> List[List[Frame]]:
        """Decode one [S, n] block with automatic recovery.  Returns the
        block's per-stream CRC-passing frames exactly once."""
        self._replay.append(np.asarray(samples, dtype=np.int16))
        attempt = 0
        while True:
            try:
                # after a failure the whole recovery (rebuild + restore +
                # replay) runs under the same retry budget
                out = self.pipe.process(samples) if attempt == 0 \
                    else self._recover()
                break
            except KeyboardInterrupt:
                raise
            except Exception as e:              # noqa: BLE001 — any decode
                attempt += 1                    # failure is recoverable
                self._emit("failure", {"block": self.blocks_done,
                                       "attempt": attempt,
                                       "error": repr(e)})
                if attempt > self.max_retries:
                    raise DecodeFailure(
                        f"block {self.blocks_done} failed after "
                        f"{self.max_retries} retries") from e
                time.sleep(self.backoff * attempt)
        if attempt:
            self._emit("recovered", {"block": self.blocks_done,
                                     "attempt": attempt})
        self.blocks_done += 1
        self._samples_done += samples.shape[1]
        if self.blocks_done - self._ckpt_blocks >= self.every:
            self.checkpoint()
        return out

    def checkpoint(self) -> None:
        """Snapshot now (also called automatically every N blocks)."""
        tmp = self.path.with_suffix(self.path.suffix + ".tmp.npz")
        save_pipeline(tmp, self.pipe, self._samples_done,
                      extra=self.extra_meta() if self.extra_meta else None)
        # np.savez appends .npz when missing; with_suffix above keeps it
        os.replace(tmp, self.path)
        self._ckpt_blocks = self.blocks_done
        self._replay.clear()
        self._emit("checkpoint", {"blocks": self.blocks_done,
                                  "samples": self._samples_done})

    # -- internals --------------------------------------------------------

    def _recover(self) -> List[List[Frame]]:
        """Rebuild the pipeline, restore the last checkpoint and replay
        the buffered blocks; returns the current (last) block's frames."""
        self.pipe = self.make_pipeline()
        if self.path.exists():
            restore_pipeline(self.path, self.pipe)
        else:
            self.pipe.carry = init_carry(self.pipe.n_streams, self.pipe.device)
        # counters were reset to their checkpoint values by the restore,
        # so replaying EVERY buffered block (delivered ones included)
        # re-advances them exactly once — no correction needed.  Frames
        # of already-delivered blocks are suppressed; only the failed
        # (last) block's frames are returned.
        out: List[List[Frame]] = [[] for _ in range(self.pipe.n_streams)]
        for i, blk in enumerate(self._replay):
            res = self.pipe.process(blk)
            if i == len(self._replay) - 1:
                out = res
        return out

    def _emit(self, kind: str, detail: dict) -> None:
        if self.on_event is not None:
            self.on_event(kind, detail)
