"""The byte-table CRC helpers (``ops.crc.frames_to_line_bits``,
``crc_check_frames``, ``extract_payload_bits``) and ``demod.compact_bits``
of the PyTorch port against ``gnuais_tpu``'s on the same numpy inputs,
bitwise (tolerance 0: integer functions).  Frames: the register words of
encoder frames decoded by the exact chain, the same words with a bit
flipped inside and outside each frame, random words, and lengths that
are short (0, negative, a few bits), full (payload + 22 = 480 register
bits) and over-long (past the register).  Bit rows: seeded emissions
with more bits than ``max_bits`` in some rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnuais_tpu.golden import encoder as E
from gnuais_tpu.ops import crc as jcrc
from gnuais_tpu.ops import demod as jdemod
from gnuais_tpu.runtime import pipeline as jpipe
from gnuais_tpu_torch.ops import crc as tcrc
from gnuais_tpu_torch.ops import demod as tdemod

REG_BITS = tdemod.REG_BITS
FULL = REG_BITS - 22          # payload bits that fill the register


@pytest.fixture(scope="module")
def frames():
    """(words uint32 [F, 15], payload lengths int32 [F]): four encoder
    frames as the JAX exact chain decodes them, each also with a bit
    flipped inside and outside it, random words at short, full and
    over-long lengths."""
    rng = np.random.default_rng(11)
    audio = E.synthesize_capture([E.random_payload(rng) for _ in range(4)],
                                 gap_bits=48)
    _, jf, _ = jpipe.decode_block(jnp.asarray(audio[None, :]),
                                  jnp.int32(len(audio)), jpipe.init_carry(1),
                                  frame_slots=8)
    n = int(np.asarray(jf.count)[0])
    assert n == 4
    words = np.asarray(jf.words)[0, :n]
    length = np.asarray(jf.length)[0, :n]
    rows, lens = [words], [length]
    for inside in (True, False):
        w = words.copy()
        for r in range(n):
            nbits = int(length[r]) + 22
            p = int(rng.integers(6, nbits) if inside
                    else rng.integers(nbits, REG_BITS))
            w[r, 14 - p // 32] ^= np.uint32(1 << (p % 32))
        rows.append(w)
        lens.append(length)
    rows.append(rng.integers(0, 2**32, (8, 15), dtype=np.uint32))
    lens.append(np.array([0, -3, 5, 9, FULL - 1, FULL, FULL + 40, 600],
                         np.int32))
    return np.concatenate(rows), np.concatenate(lens)


def _bit_rows(seed: int):
    """(bit_valid [S, T], bits [S, T]) with about one emission in 5
    samples, stream 2 emitting at every sample."""
    rng = np.random.default_rng(seed)
    valid = rng.random((5, 600)) < 0.2
    valid[2] = True
    bits = rng.integers(0, 2, (5, 600)).astype(np.int32)
    return valid, bits


@pytest.mark.parametrize("fn", ["frames_to_line_bits", "crc_check_frames",
                                "extract_payload_bits", "compact_bits"])
def test_helper_matches_jax(frames, fn):
    if fn == "compact_bits":
        for seed, max_bits, base in ((1, 128, 77), (2, 600, 0),
                                     (3, 40, 2**31 - 300)):
            valid, bits = _bit_rows(seed)
            j = jdemod.compact_bits(jnp.asarray(valid), jnp.asarray(bits),
                                    max_bits, base)
            t = tdemod.compact_bits(torch.from_numpy(valid),
                                    torch.from_numpy(bits), max_bits, base)
            for a, b in zip(j, t):
                a = np.asarray(a)
                assert a.dtype == b.numpy().dtype
                np.testing.assert_array_equal(a, b.numpy())
            assert int(t[2].max()) > max_bits or max_bits == 600
        return
    words, length = frames
    tw, tl = torch.from_numpy(words.view(np.int32)), torch.from_numpy(length)
    if fn == "frames_to_line_bits":
        total = length + 22
        j = jcrc.frames_to_line_bits(jnp.asarray(words), jnp.asarray(total))
        t = tcrc.frames_to_line_bits(tw, torch.from_numpy(total))
    else:
        j = getattr(jcrc, fn)(jnp.asarray(words), jnp.asarray(length))
        t = getattr(tcrc, fn)(tw, tl)
    j = np.asarray(j)
    assert j.dtype == t.numpy().dtype and j.shape == tuple(t.shape)
    np.testing.assert_array_equal(j, t.numpy())
    if fn == "crc_check_frames":
        ok = t.numpy()
        assert ok[:4].all() and not ok[4:8].any() and ok[8:12].all()
        np.testing.assert_array_equal(
            ok, tcrc.crc_check_frames_linear(tw, tl).numpy())
