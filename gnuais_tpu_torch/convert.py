"""Decoder state and frames across the package boundary, as numpy.

The leaf order is the JAX ``PipelineCarry`` order
(``gnuais_tpu/runtime/pipeline.py``: history, the three DPLL leaves, the
eight HDLC variables, the register), so the leaves of
``jax.tree.leaves(carry)`` resume in this package and the other way
round.  The register and frame words are ``uint32`` in numpy and the
same bit patterns as ``int32`` here; they cross with ``view``, never a
value cast.  The IQ front end's carry crosses as the JAX ``IqState``
leaves (last_i, last_q, fir_history), and a ``TimeParSession`` snapshot
as numpy arrays and Python values under the JAX class's keys.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch

from .ops.demod import DpllState, FrameBatch, HdlcState
from .ops.discriminator import IqState
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


def iq_state_to_numpy(state: IqState) -> List[np.ndarray]:
    """The IQ front end's carry as the JAX ``IqState`` leaves (last_i
    [S], last_q [S], fir_history [S, ntaps], float32)."""
    return [_to_numpy(x) for x in state]


def iq_state_from_numpy(leaves: Sequence[np.ndarray],
                        device: torch.device | str) -> IqState:
    """An ``IqState`` on ``device`` from the JAX ``IqState``'s leaves."""
    if len(leaves) != len(IqState._fields):
        raise ValueError(f"expected {len(IqState._fields)} IqState leaves, "
                         f"got {len(leaves)}")
    return IqState(*(_to_torch(np.asarray(a, dtype=np.float32), device)
                     for a in leaves))


def _plain(v: Any) -> Any:
    """A snapshot value as numpy or Python: arrays (tensors, JAX arrays)
    as numpy, lists as lists of Python ints, the rest as it is."""
    if isinstance(v, torch.Tensor):
        return _to_numpy(v)
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    if hasattr(v, "__array__") and not isinstance(v, np.ndarray):
        return np.asarray(v)
    if isinstance(v, np.integer):
        return int(v)
    return v


def snapshot_to_numpy(snapshot: dict) -> dict:
    """A ``TimeParSession.snapshot()`` of either package with nothing in
    it but numpy arrays and Python values, under the same keys: what a
    ``.mesh.npz`` holds, and what either package's ``restore`` takes."""
    return {k: _plain(v) for k, v in snapshot.items()}
