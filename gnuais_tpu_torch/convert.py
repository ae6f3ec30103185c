"""Decoder state and frames across the package boundary, as numpy.

The leaf order is the JAX ``PipelineCarry`` order
(``gnuais_tpu/runtime/pipeline.py``: history, the three DPLL leaves, the
eight HDLC variables, the register), so the leaves of
``jax.tree.leaves(carry)`` resume in this package and the other way
round.  The register and frame words are ``uint32`` in numpy and the
same bit patterns as ``int32`` here; they cross with ``view``, never a
value cast.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .ops.demod import DpllState, FrameBatch, HdlcState
from .runtime.pipeline import PipelineCarry

N_LEAVES = 1 + len(DpllState._fields) + len(HdlcState._fields)


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def _to_numpy(t: torch.Tensor, as_uint32: bool = False) -> np.ndarray:
    a = t.detach().cpu().contiguous().numpy()
    return a.view(np.uint32) if as_uint32 else a


def carry_from_numpy(leaves: Sequence[np.ndarray],
                     device: torch.device | str) -> PipelineCarry:
    """A ``PipelineCarry`` on ``device`` from the JAX carry's leaves."""
    if len(leaves) != N_LEAVES:
        raise ValueError(f"expected {N_LEAVES} carry leaves, got {len(leaves)}")
    t = [_to_torch(np.asarray(a), device) for a in leaves]
    return PipelineCarry(history=t[0], dpll=DpllState(*t[1:4]),
                         hdlc=HdlcState(*t[4:]))


def carry_to_numpy(carry: PipelineCarry) -> List[np.ndarray]:
    """The carry's leaves in the JAX order; the register as uint32."""
    leaves = [carry.history, *carry.dpll, *carry.hdlc]
    out = [_to_numpy(x) for x in leaves[:-1]]
    out.append(_to_numpy(leaves[-1], as_uint32=True))
    return out


def candidates_to_numpy(out: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The candidate outputs of ``ops.fused.pipeline_fused`` (its first
    seven: cand_valid, cw, cl, cs, ce, lost2, over) as numpy, cw as
    uint32 (the layout of the JAX function's)."""
    return [_to_numpy(x, as_uint32=(i == 1)) for i, x in enumerate(out[:7])]


def frames_to_numpy(frames: FrameBatch) -> FrameBatch:
    """A FrameBatch of numpy arrays, words as uint32 (the layout of the
    JAX FrameBatch)."""
    return FrameBatch(*(_to_numpy(x, as_uint32=(name == "words"))
                        for name, x in zip(FrameBatch._fields, frames)))
