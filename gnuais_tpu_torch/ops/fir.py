"""Batched FIR band filter, exact order (counterpart of
``gnuais_tpu/ops/fir.py``).

36 explicit float32 multiplies and adds in the reference's
accumulation order: each product and each partial sum is rounded to
float32 once, with no fused multiply-add.  Subnormal products are kept,
as in the reference C code (the JAX package on CPU and TPU flushes
them; see ``ROADMAP.md`` section 3).

Note the one-sample delay: out[n] covers x[n-36 .. n-1].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gnuais_tpu.constants import FIR_LEN, FIR_TAPS


def init_history(n_streams: int, device: torch.device | str) -> torch.Tensor:
    return torch.zeros((n_streams, FIR_LEN), dtype=torch.float32,
                       device=device)


def fir_exact(samples: torch.Tensor, history: torch.Tensor,
              n_valid: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """samples: int16/float32 [S, T]; history: float32 [S, 36] (the last
    36 inputs of the previous block); ``n_valid``: how many samples of a
    padded final block are real (the carried history advances only over
    those).  Returns (filtered [S, T] float32, new_history [S, 36])."""
    taps = torch.as_tensor(FIR_TAPS, device=samples.device)
    x = torch.cat([history, samples.to(torch.float32)], dim=1)
    t = samples.shape[1]
    # out[:, n] = sum_i taps[i] * x[:, n + i], one rounding per product
    # and per partial sum (a separate multiply and add, never addcmul)
    out = x[:, 0:t] * taps[0]
    for i in range(1, FIR_LEN):
        out = out + x[:, i:i + t] * taps[i]
    end = t if n_valid is None else int(n_valid)
    return out, x[:, end:end + FIR_LEN].clone()


def block_peak(samples: torch.Tensor) -> torch.Tensor:
    """Per-stream positive peak of the raw int16 block (the reference's
    level meter tracks only values above a running max that starts at
    0)."""
    return samples.max(dim=1).values.clamp(min=0).to(torch.int32)
