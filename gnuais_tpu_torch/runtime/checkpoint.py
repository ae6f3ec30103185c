"""Checkpoint/resume of streaming decoder state (counterpart of
``gnuais_tpu/runtime/checkpoint.py``).

The whole decoder is a small explicit carry (FIR history, DPLL phase,
HDLC state and shift register), so a snapshot is exact: resuming from
(carry, input offset) reproduces the remaining output bit for bit.

The format is the JAX package's: an .npz of the carry's leaves
``leaf_{i}`` in the JAX ``PipelineCarry`` leaf order (``convert``), the
register as ``uint32``, plus a ``__meta__`` JSON blob.  A checkpoint
written by either package resumes in the other.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..convert import carry_from_numpy, carry_to_numpy
from .pipeline import BatchPipeline, PipelineCarry, init_carry


def save_carry(path: Union[str, Path], carry: PipelineCarry,
               meta: Optional[Dict[str, Any]] = None) -> None:
    arrays = {f"leaf_{i}": a for i, a in enumerate(carry_to_numpy(carry))}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(str(path), **arrays)


def load_carry(path: Union[str, Path], n_streams: int,
               device: torch.device | str
               ) -> Tuple[PipelineCarry, Dict[str, Any]]:
    """The carry of ``path`` on ``device`` and the saver's metadata;
    raises ValueError when it was taken with another stream count."""
    data = np.load(str(path))
    template = carry_to_numpy(init_carry(n_streams, "cpu"))
    loaded = []
    for i, tmpl in enumerate(template):
        arr = data[f"leaf_{i}"]
        if arr.shape != tmpl.shape:
            raise ValueError(
                f"carry leaf {i} shape {arr.shape} != expected {tmpl.shape}"
                f" (checkpoint taken with different stream count?)")
        loaded.append(arr.astype(tmpl.dtype))
    meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data else {}
    return carry_from_numpy(loaded, device), meta


def save_pipeline(path: Union[str, Path], pipe: BatchPipeline,
                  samples_consumed: int,
                  extra: Optional[Dict[str, Any]] = None) -> None:
    meta = {
        "samples_consumed": samples_consumed,
        "n_streams": pipe.n_streams,
        "block_len": pipe.block_len,
        "counters": [(c.receivedframes, c.lostframes, c.lostframes2)
                     for c in pipe.counters],
        "extra": extra or {},
    }
    save_carry(path, pipe.carry, meta)


def restore_pipeline(path: Union[str, Path], pipe: BatchPipeline
                     ) -> Tuple[int, Dict[str, Any]]:
    """Restores carry + counters into ``pipe`` (the carry on the
    pipeline's device); returns (input offset to resume from, the saver's
    ``extra`` metadata — e.g. downstream dispatcher state like the NMEA
    seqnr)."""
    carry, meta = load_carry(path, pipe.n_streams, pipe.device)
    pipe.carry = carry
    for c, (r, l, l2) in zip(pipe.counters, meta.get("counters", [])):
        c.receivedframes, c.lostframes, c.lostframes2 = r, l, l2
    return int(meta.get("samples_consumed", 0)), meta.get("extra", {})
