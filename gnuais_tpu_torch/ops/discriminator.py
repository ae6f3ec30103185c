"""Raw-IQ front end: FM discriminator and decimation on the device
(counterpart of ``gnuais_tpu/ops/discriminator.py``).

Complex baseband IQ (an AIS channel mixed to 0 Hz) at an integer
multiple of 48 kHz is FM-demodulated (phase-difference discriminator)
and decimated to the 48 kHz audio the decode chain takes.  Batched over
[streams, time]; the carry is the last IQ sample (for the phase
difference) and the decimation FIR's history.

As in the JAX package the I and Q rails are separate float32 tensors and
the anti-alias decimator is a polyphase sum of strided slices, each term
a separate multiply and add in the JAX function's order (no fused
multiply-add, no convolution), so that the two packages round alike.
These are plain PyTorch ops in both packages' sense: the JAX functions
are XLA ops, not Pallas kernels, and run here on whatever device the
tensors are on.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..constants import SAMPLE_RATE


def design_decim_fir(decim: int, ntaps: int = 64) -> np.ndarray:
    """Hamming-windowed sinc low-pass at 0.45*(48 kHz/2) of the input
    rate, for anti-alias filtering ahead of ``decim``:1 decimation."""
    fs_in = SAMPLE_RATE * decim
    cutoff = 0.45 * (SAMPLE_RATE / 2)
    n = np.arange(ntaps) - (ntaps - 1) / 2.0
    fc = cutoff / fs_in
    h = 2 * fc * np.sinc(2 * fc * n)
    h *= np.hamming(ntaps)
    h /= h.sum()
    return h.astype(np.float32)


class IqState(NamedTuple):
    last_i: torch.Tensor       # [S] float32 — previous IQ sample, I rail
    last_q: torch.Tensor       # [S] float32 — previous IQ sample, Q rail
    fir_history: torch.Tensor  # [S, ntaps] float32 — decimator history


def init_iq(n_streams: int, ntaps: int = 64,
            device: torch.device | str = "cuda") -> IqState:
    # the discriminator's "before stream start" sample is 1+0j
    return IqState(
        last_i=torch.ones((n_streams,), dtype=torch.float32, device=device),
        last_q=torch.zeros((n_streams,), dtype=torch.float32, device=device),
        fir_history=torch.zeros((n_streams, ntaps), dtype=torch.float32,
                                device=device),
    )


def fm_discriminate(i: torch.Tensor, q: torch.Tensor,
                    last_i: torch.Tensor, last_q: torch.Tensor,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase-difference FM discriminator on split rails.

    i/q: float32 [S, T].  d = z[n] * conj(z[n-1]); audio =
    atan2(Im d, Re d), scaled so that a pi rad/sample swing maps to int16
    full scale.  Returns (audio [S, T] float32, new last_i, new last_q).
    """
    if scale is None:
        scale = 32767.0 / np.pi
    pi_ = torch.cat([last_i[:, None], i[:, :-1]], dim=1)
    pq_ = torch.cat([last_q[:, None], q[:, :-1]], dim=1)
    re = i * pi_ + q * pq_
    im = q * pi_ - i * pq_
    audio = torch.atan2(im, re) * scale
    return audio.to(torch.float32), i[:, -1], q[:, -1]


def decimate(x: torch.Tensor, history: torch.Tensor, taps: torch.Tensor,
             decim: int, chunk: int = 16384
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anti-alias FIR and decim:1 downsampling (polyphase slice form).

    x: float32 [S, T] (T divisible by decim); history: [S, ntaps].
    out[j] = sum_m taps_rev[m] * xx[j*decim + m] over the ntaps window
    ending just before position (j+1)*decim.  Returns ([S, T//decim],
    new history).

    Long inputs go in ``chunk``-sample pieces cut on the decimation grid
    (``step = chunk - chunk % decim``): a piece that decim does not
    divide would emit floor(piece/decim) samples yet advance the history
    by the whole piece.  Each output sample is the same sum either way;
    the pieces bound the [S, T/decim] temporaries of the ntaps terms."""
    ntaps = taps.shape[0]
    t = x.shape[1]
    step = max(decim, chunk - (chunk % decim))
    if t > step:
        outs = []
        h = history
        for off in range(0, t, step):
            y, h = decimate(x[:, off:off + step], h, taps, decim,
                            chunk=chunk)
            outs.append(y)
        return torch.cat(outs, dim=1), h
    xx = torch.cat([history, x], dim=1)
    t_out = t // decim
    rev = taps.flip(0)
    y = None
    for m in range(ntaps):
        term = rev[m] * xx[:, m:m + t_out * decim:decim]
        y = term if y is None else y + term
    return y, xx[:, t:t + ntaps].contiguous()


def iq_frontend(i: torch.Tensor, q: torch.Tensor, state: IqState,
                taps: torch.Tensor, decim: int
                ) -> Tuple[torch.Tensor, IqState]:
    """The whole front end: I/Q rails [S, T_iq] -> int16-range float
    audio [S, T_iq/decim] at 48 kHz, and the new state."""
    audio_hi, li, lq = fm_discriminate(i, q, state.last_i, state.last_q)
    audio, fir_hist = decimate(audio_hi, state.fir_history, taps, decim)
    return audio, IqState(li, lq, fir_hist)


def iq_to_int16_audio(i: torch.Tensor, q: torch.Tensor, state: IqState,
                      taps: torch.Tensor, decim: int
                      ) -> Tuple[torch.Tensor, IqState]:
    """``iq_frontend`` rounded (half to even) and clipped to int16, so
    that the audio is byte-compatible with a recorded soundcard
    capture."""
    audio, st = iq_frontend(i, q, state, taps, decim)
    return torch.clamp(torch.round(audio), -32768, 32767).to(torch.int16), st
