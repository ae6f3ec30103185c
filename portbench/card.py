"""The yardstick's table of peaks and the work of kernel B2: a copy of
the port's ``card.py`` arithmetic (one H100 SXM at its 700 W power
limit, NVIDIA's data sheet) and of the bound that ``chip_smoke.py``
gives B2.

B2 (``ops.fused.pipeline_fused``, fir_mode ``vpu``) needs, for every
valid sample of every stream, the exact 36-tap FIR's 36 float32
multiplies and 35 adds: 71 operations; the integer DPLL and deframer
work is not counted.  Its bytes are its input and output tensors, each
counted once.  The bound is the larger of the two times.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

HBM_TB_S = 3.35          # HBM3
F32_TFLOPS = 67.0        # float32, outside the tensor cores
B2_OPS_PER_SAMPLE = 71


def bound_ms(nbytes: float, ops: float, rate_tops: float = F32_TFLOPS
             ) -> Tuple[float, str]:
    """The least time of a call that moves ``nbytes`` and does ``ops``
    operations at ``rate_tops`` tera-operations a second.  Returns (ms,
    "bytes" or "operations")."""
    by_bytes = nbytes / (HBM_TB_S * 1e9)
    by_ops = ops / (rate_tops * 1e9)
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def tensor_bytes(tree) -> int:
    """The bytes of every tensor in a nested tuple of them."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (tuple, list)):
        return sum(tensor_bytes(x) for x in tree)
    return 0


def b2_bound_ms(samples: torch.Tensor, n_valid: int, inputs: Iterable,
                outputs) -> float:
    """B2's bound for one call: ``samples`` [S, T] row-major, ``n_valid``
    valid samples a stream, the call's other tensor ``inputs`` (the
    carry) and its ``outputs``."""
    s, t = samples.shape
    ops = B2_OPS_PER_SAMPLE * s * min(max(int(n_valid), 0), t)
    nbytes = tensor_bytes(samples) + tensor_bytes(tuple(inputs)) \
        + tensor_bytes(outputs)
    return bound_ms(nbytes, ops)[0]
