"""Synthetic int16 capture batches for parity checks, made with numpy
from a seed through the encoder (``golden.encoder``).

``payload_capture`` gives one clean capture and the payloads it carries.
Each other function returns an ``[S, T]`` int16 array whose rows are
independent streams.  They cover what the decode step must get right:
ordinary frames in noise, garbage audio, back-to-back minimal frames
(the densest completions the deframer permits), wrong-size stop flags
(the lost2 counter) and corrupted frames (CRC rejects).  The tests and
``chip_smoke.py`` share them.
"""

from __future__ import annotations

import numpy as np

from .golden import encoder as E

_PREAMBLE = [0, 1] * 12
_FLAG = [0, 1, 1, 1, 1, 1, 1, 0]


def _audio(bits, rng, noise: float) -> np.ndarray:
    audio = E.levels_to_audio(E.nrzi_encode(np.asarray(bits, dtype=np.uint8)))
    if noise:
        audio = np.clip(audio + rng.normal(0, noise, len(audio)),
                        -32768, 32767).astype(np.int16)
    return audio


def _fit(rows, t: int, rng, noise: float) -> np.ndarray:
    """Rows cut or padded to t samples; padding is noise, never digital
    silence."""
    out = np.clip(rng.normal(0, max(noise, 1.0), (len(rows), t)),
                  -32768, 32767).astype(np.int16)
    for i, r in enumerate(rows):
        n = min(len(r), t)
        out[i, :n] = r[:n]
    return out


def payload_capture(rng, n_payloads: int, gap_bits: int = 48):
    """A clean capture of ``n_payloads`` random AIS payloads, and the
    payloads (uint8 bit arrays) in the order they were sent."""
    payloads = [E.random_payload(rng) for _ in range(n_payloads)]
    return E.synthesize_capture(payloads, gap_bits=gap_bits), payloads


def noisy_frames(s: int, t: int, seed: int = 0, n_payloads: int = 3,
                 gap_bits: int = 48, noise: float = 300.0) -> np.ndarray:
    """Random AIS payloads framed by the encoder, each row shifted by
    13 samples more than the previous one, plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    audio, _ = payload_capture(rng, n_payloads, gap_bits)
    n = min(len(audio), t)
    x = np.zeros((s, t), dtype=np.int16)
    for i in range(s):
        x[i, :n] = np.roll(audio[:n], i * 13)
    return np.clip(x + rng.normal(0, noise, x.shape),
                   -32768, 32767).astype(np.int16)


def garbage(s: int, t: int, seed: int = 0, std: float = 6000.0) -> np.ndarray:
    """Pure noise rows."""
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(0, std, (s, t)), -32768, 32767).astype(np.int16)


def minimal_frames(s: int, t: int, seed: int = 0,
                   noise: float = 150.0) -> np.ndarray:
    """Back-to-back minimal frames (1-byte payloads, no gap between
    frames), the lead-in growing by 8 line bits from row to row so the
    stop flags fall at every phase of the 64-slot chunks."""
    rng = np.random.default_rng(seed)
    tiny = list(E.frame_line_bits(np.zeros(8, dtype=np.uint8)))
    rows = []
    for i in range(s):
        bits = [1] * (16 + 8 * (i % 8)) + tiny * 12 + [1] * 32
        rows.append(_audio(bits, rng, noise))
    return _fit(rows, t, rng, noise)


def wrong_size_and_crc(s: int, t: int, seed: int = 0,
                       noise: float = 150.0) -> np.ndarray:
    """Per row: a good frame, a frame with one payload bit flipped (a CRC
    reject), a wrong-size stop (preamble, flag, 8 data bits, flag: the
    deframer stops with flen = -8, counted in lost2) and another good
    frame, at a row-dependent offset."""
    rng = np.random.default_rng(seed)
    wrong = _PREAMBLE + _FLAG + [1, 0, 1, 0, 1, 0, 1, 0] + _FLAG
    rows = []
    for i in range(s):
        good = list(E.frame_line_bits(E.random_payload(rng)))
        bad = E.frame_line_bits(E.random_payload(rng)).copy()
        # flip a 1 whose preceding five bits hold a 0: the flip can
        # neither create nor absorb a stuffed bit
        for j in range(80, len(bad) - 8):
            if bad[j] == 1 and 0 in bad[j - 5:j]:
                bad[j] = 0
                break
        alt = [0, 1] * (8 + 4 * (i % 16))
        bits = (alt + good + [0, 1] * 16 + list(bad) + [0, 1] * 16 + wrong
                + [0, 1] * 16 + list(E.frame_line_bits(E.random_payload(rng)))
                + [1] * 32)
        rows.append(_audio(bits, rng, noise))
    return _fit(rows, t, rng, noise)


def mixed(s: int, t: int, seed: int = 0) -> np.ndarray:
    """Rows cycling through the functions above: noisy frames, garbage,
    minimal frames, wrong-size and CRC-reject frames."""
    makers = (noisy_frames, garbage, minimal_frames, wrong_size_and_crc)
    x = np.empty((s, t), dtype=np.int16)
    for k, build in enumerate(makers):
        rows = np.arange(k, s, len(makers))
        if len(rows):
            x[rows] = build(len(rows), t, seed=seed + k)
    return x


def build_batch(n_streams: int, block_len: int, frames_per_stream: int = 4,
                seed: int = 0):
    """The JAX bench's batch (``bench.py`` ``build_batch``, the port's
    copy): ``frames_per_stream`` random payloads encoded 8 times with
    lead-ins of 64 + 16 v bits, capture v on streams v, v + 8, ..., each
    at the start of an int16 [S, block_len] block of zeros.  Returns
    (batch, payloads per stream)."""
    rng = np.random.default_rng(seed)
    payloads = [E.random_payload(rng) for _ in range(frames_per_stream)]
    variants = []
    for v in range(min(8, n_streams)):
        a = E.synthesize_capture(payloads, gap_bits=64,
                                 lead_in_bits=64 + 16 * v)
        if len(a) > block_len:
            raise ValueError(f"capture of {len(a)} samples exceeds the "
                             f"block of {block_len}")
        variants.append(a)
    batch = np.zeros((n_streams, block_len), dtype=np.int16)
    for s in range(n_streams):
        a = variants[s % len(variants)]
        batch[s, :len(a)] = a
    return batch, len(payloads)
