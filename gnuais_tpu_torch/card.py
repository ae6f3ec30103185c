"""The card's peak rates behind every kernel bound of the port (one H100
SXM at its 700 W power limit, NVIDIA's data sheet), and the bound.

The 32-bit integer rate is 64 operations a clock on each of 132 SMs at
the 1.98 GHz behind the data sheet's float32 rate (CUDA programming
guide, throughput of arithmetic instructions, compute capability 9.0).
"""

from __future__ import annotations

import subprocess
from typing import Tuple

HBM_TB_S = 3.35          # HBM3
F32_TFLOPS = 67.0        # float32, outside the tensor cores
TF32_TFLOPS = 495.0      # dense TF32 on the tensor cores
INT32_TOPS = F32_TFLOPS / 4


def bound_ms(nbytes: float, *work: Tuple[float, float]) -> Tuple[float, str]:
    """The least time of a call that moves ``nbytes`` (each input read
    once, each output written once) and does, for each ``(ops, rate)`` of
    ``work``, ``ops`` operations at ``rate`` tera-operations a second, each
    kind on its own pipe: the larger of nbytes over HBM_TB_S and the
    slowest kind.  Returns (ms, "bytes" or "operations")."""
    by_bytes = nbytes / (HBM_TB_S * 1e9)
    by_ops = max((ops / (rate * 1e9) for ops, rate in work), default=0.0)
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def smi() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    first card), to print beside every number a tool measures."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]
