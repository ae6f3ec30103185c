"""The plain reference of the IQ front end: complex baseband I/Q at 48 kHz
x ``decim`` in, int16 audio at 48 kHz out, in plain ``torch`` float32,
written from the formula.  It imports nothing of the program.

- Discriminator: z[n] = I[n] + jQ[n], z[-1] = 1 + 0j;
  d[n] = z[n] conj(z[n-1]), so Re d = I[n] I[n-1] + Q[n] Q[n-1] and
  Im d = Q[n] I[n-1] - I[n] Q[n-1]; a[n] = atan2(Im d, Re d) 32767 / pi,
  a swing of pi radians a sample being int16 full scale.
- Decimator: h, a 64-tap Hamming-windowed sinc low-pass with its cutoff
  at 0.45 x 24 kHz of the input rate, normalised to unit gain at DC
  (``decim_taps``).  Output j is the full 64-term sum
  sum_k h[k] a[j decim - 1 - k]: the window of the 64 discriminator
  samples that ends just before sample j decim, a[n] = 0 before the
  stream's first sample.  (This is the program's and its JAX original's
  indexing: one output sample later than a window ending before
  (j + 1) decim.)  The terms are summed oldest sample first.
- Rounded half to even, clipped to int16.

Block by block with its carry (the last IQ sample and the last 64
discriminator samples) it equals one call over the whole stream bit for
bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

NTAPS = 64
AUDIO_RATE = 48_000


def decim_taps(decim: int, ntaps: int = NTAPS) -> torch.Tensor:
    """The decimator's taps, designed in float64, as float32 [ntaps]."""
    fc = 0.45 * (AUDIO_RATE / 2) / (AUDIO_RATE * decim)
    n = torch.arange(ntaps, dtype=torch.float64) - (ntaps - 1) / 2
    h = 2 * fc * torch.sinc(2 * fc * n) * torch.hamming_window(
        ntaps, periodic=False, dtype=torch.float64)
    return (h / h.sum()).to(torch.float32)


class State(NamedTuple):
    last_i: torch.Tensor   # [S] the last IQ sample's I
    last_q: torch.Tensor   # [S] and its Q
    tail: torch.Tensor     # [S, NTAPS] the last discriminator samples


def start(streams: int, device) -> State:
    """The state before a stream's first sample."""
    return State(torch.ones(streams, device=device),
                 torch.zeros(streams, device=device),
                 torch.zeros(streams, NTAPS, device=device))


def frontend(i: torch.Tensor, q: torch.Tensor, state: State, decim: int
             ) -> Tuple[torch.Tensor, State]:
    """I and Q float32 [S, T] (T a multiple of ``decim``) after ``state``
    -> the int16 audio [S, T / decim] and the state after them."""
    i, q = i.to(torch.float32), q.to(torch.float32)
    t = i.shape[1]
    prev_i = torch.cat([state.last_i[:, None], i[:, :-1]], dim=1)
    prev_q = torch.cat([state.last_q[:, None], q[:, :-1]], dim=1)
    re = i * prev_i + q * prev_q
    im = q * prev_i - i * prev_q
    a = torch.atan2(im, re) * (32767 / math.pi)
    x = torch.cat([state.tail, a], dim=1)       # x[m] = a[m - NTAPS]
    h = decim_taps(decim).to(i.device)
    n_out = t // decim
    # output j: sum over m of h[NTAPS - 1 - m] x[j decim + m], m = 0 the
    # window's oldest sample
    y = None
    for m in range(NTAPS):
        term = h[NTAPS - 1 - m] * x[:, m:m + n_out * decim:decim]
        y = term if y is None else y + term
    audio = torch.clamp(torch.round(y), -32768, 32767).to(torch.int16)
    return audio, State(i[:, -1], q[:, -1], x[:, t:].contiguous())
