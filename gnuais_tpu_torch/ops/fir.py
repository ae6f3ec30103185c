"""Batched FIR band filter (counterpart of ``gnuais_tpu/ops/fir.py``).

Four forms, all with the one-sample delay (out[n] covers
x[n-36 .. n-1]) and a carried [S, 36] history:

- ``fir_exact``: 36 explicit float32 multiplies and adds in the
  reference's accumulation order: each product and each partial sum is
  rounded to float32 once, with no fused multiply-add.  Subnormal
  products are kept, as in the reference C code (the JAX package on CPU
  and TPU flushes them; see ``ROADMAP.md`` section 3).
- ``fir_lobe``: the main-lobe FIR of the fused kernels' ``lobe`` mode,
  taps ``LOBE_LO..LOBE_HI`` only, each symmetric pair of samples added
  before its one multiply; a packet-parity mode, not the exact rounding.
- ``fir_mxu``: the fused kernels' ``mxu`` mode, the block cut into
  chunks of ``MXU_UNROLL`` samples and each chunk filtered by one
  product of the banded taps matrix (``band_matrix``) with its window;
  a packet-parity mode, not the exact rounding.
- ``fir_conv``: a convolution (``conv1d``), the JAX package's
  ``exact_fir=False`` throughput form; its summation order is the
  library's, so it is not bit-exact either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import FIR_LEN, FIR_TAPS

# The main lobe of the Gaussian taps (gnuais_tpu/ops/fused.py LOBE_LO,
# LOBE_HI): outside it every tap is below 1.3e-13.
LOBE_LO, LOBE_HI = 10, 25

# Samples per chunk of the mxu FIR: the JAX package's default
# ``kernel_unroll``.  The chunking changes only the rounding, so the
# port fixes it (the kernel's tiles are cut for it).
MXU_UNROLL = 32


def init_history(n_streams: int, device: torch.device | str) -> torch.Tensor:
    return torch.zeros((n_streams, FIR_LEN), dtype=torch.float32,
                       device=device)


def _window(samples: torch.Tensor, history: torch.Tensor,
            n_valid: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """[history | samples] as float32 [S, 36 + T], and the new history:
    the 36 inputs before sample ``n_valid`` (T when None), so a padded
    final block's carry advances only over its real samples."""
    x = torch.cat([history, samples.to(torch.float32)], dim=1)
    end = samples.shape[1] if n_valid is None else int(n_valid)
    return x, x[:, end:end + FIR_LEN].clone()


def fir_exact(samples: torch.Tensor, history: torch.Tensor,
              n_valid: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """samples: int16/float32 [S, T]; history: float32 [S, 36] (the last
    36 inputs of the previous block); ``n_valid``: how many samples of a
    padded final block are real (the carried history advances only over
    those).  Returns (filtered [S, T] float32, new_history [S, 36])."""
    taps = torch.as_tensor(FIR_TAPS, device=samples.device)
    x, new_history = _window(samples, history, n_valid)
    t = samples.shape[1]
    # out[:, n] = sum_i taps[i] * x[:, n + i], one rounding per product
    # and per partial sum (a separate multiply and add, never addcmul)
    out = x[:, 0:t] * taps[0]
    for i in range(1, FIR_LEN):
        out = out + x[:, i:i + t] * taps[i]
    return out, new_history


def fir_lobe(samples: torch.Tensor, history: torch.Tensor,
             n_valid: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernels' ``lobe`` FIR: for i = 10..17,
    (x[n+i] + x[n+35-i]) * taps[i], summed from i = 10 up, each add and
    multiply rounded to float32 (the pair sums of int16 values are
    exact).  Same arguments and returns as ``fir_exact``."""
    taps = torch.as_tensor(FIR_TAPS, device=samples.device)
    x, new_history = _window(samples, history, n_valid)
    t = samples.shape[1]
    out = None
    for i in range(LOBE_LO, (LOBE_LO + LOBE_HI + 1) // 2):
        j = FIR_LEN - 1 - i
        term = (x[:, i:i + t] + x[:, j:j + t]) * taps[i]
        out = term if out is None else out + term
    return out, new_history


def band_matrix(unroll: int) -> torch.Tensor:
    """The banded taps matrix A [unroll, FIR_LEN + unroll] float32 with
    A[k, k + i] = taps[i] (gnuais_tpu/ops/fused.py ``_fir_band_matrix``),
    so that (A @ win)[k] filters sample k of a window ``win`` of
    FIR_LEN history and ``unroll`` new samples."""
    a = np.zeros((unroll, FIR_LEN + unroll), dtype=np.float32)
    taps = np.asarray(FIR_TAPS, dtype=np.float32)
    for k in range(unroll):
        a[k, k:k + FIR_LEN] = taps
    return torch.from_numpy(a)


def fir_mxu(samples: torch.Tensor, history: torch.Tensor,
            n_valid: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernels' ``mxu`` FIR: [history | samples]
    cut into chunks of MXU_UNROLL samples aligned to sample 0 of the
    block (the last one zero-padded), each chunk's outputs the float32
    product of ``band_matrix(MXU_UNROLL)`` with the FIR_LEN + MXU_UNROLL
    inputs from its start, as the TPU kernel's body does.  Same
    arguments and returns as ``fir_exact``; not the exact chain's
    rounding (the sum runs in the matrix product's order).

    On the card TF32 is off for the product and the caller's setting is
    restored after it."""
    x, new_history = _window(samples, history, n_valid)
    s, t = samples.shape
    u = MXU_UNROLL
    n_chunks = -(-t // u)
    x = torch.nn.functional.pad(x, (0, n_chunks * u - t))
    win = x.unfold(1, FIR_LEN + u, u)                  # [S, chunks, 36 + u]
    a = band_matrix(u).to(samples.device)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = torch.matmul(win, a.t())                 # [S, chunks, u]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return out.reshape(s, n_chunks * u)[:, :t].contiguous(), new_history


def fir_conv(samples: torch.Tensor, history: torch.Tensor,
             n_valid: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convolution-form FIR (``exact_fir=False``): the 36 taps as one
    ``conv1d`` over [history | samples] in float32.  Not bit-exact
    against the reference's accumulation order.  Same arguments and
    returns as ``fir_exact``.

    On the card a float32 convolution goes through cuDNN, which takes
    TF32 (about three decimal digits) unless told otherwise; the JAX
    package asks for ``Precision.HIGHEST``, so TF32 is off for this call
    and the caller's setting is restored after it."""
    x, new_history = _window(samples, history, n_valid)
    t = samples.shape[1]
    # conv1d correlates: out[n] = sum_i w[i] * x[n + i] (the taps are
    # palindromic, so the flip JAX writes out changes nothing)
    w = torch.as_tensor(FIR_TAPS, device=samples.device).view(1, 1, FIR_LEN)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = torch.nn.functional.conv1d(x[:, None, :], w)[:, 0, :t]
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return out.contiguous(), new_history


def block_peak(samples: torch.Tensor) -> torch.Tensor:
    """Per-stream positive peak of the raw int16 block (the reference's
    level meter tracks only values above a running max that starts at
    0)."""
    return samples.max(dim=1).values.clamp(min=0).to(torch.int32)
