"""Bit-level helpers for AIS payload handling.

AIS payload bits live in "rbuffer order": one bit per array element,
MSB-first within each original HDLC byte (the HDLC line order is
LSB-first per byte; the receiver re-expands bytes MSB-first for field
extraction — reference: protodec.c:150-162).
"""

from __future__ import annotations

import numpy as np

from .constants import DEMOD_BUFFER_LEN


def henten(from_: int, size: int, frame: np.ndarray) -> int:
    """Big-endian bit gather: frame[from:from+size] -> unsigned int.

    Semantics of ``protodec_henten`` (protodec.c:205-214).  ``frame``
    must be 0-padded so out-of-range reads yield 0 (the reference
    rbuffer is zeroed to 450 entries).
    """
    v = 0
    for i in range(size):
        v |= int(frame[from_ + i]) << (size - 1 - i)
    return v


def sixbit_to_ascii(sixbit: int) -> str:
    """6-bit AIS char -> ASCII (protodec_decode_sixbit_ascii,
    protodec.c:190-203)."""
    if 1 <= sixbit <= 31:
        return chr(sixbit + 64)
    if 32 <= sixbit <= 63:
        return chr(sixbit)
    return " "


def get_string(frame: np.ndarray, pos: int, nchars: int) -> str:
    """Extract an AIS 6-bit string and strip trailing spaces
    (remove_trailing_spaces semantics: only a trailing run of
    spaces/NULs is removed — protodec.c:173-184)."""
    chars = []
    for k in range(nchars):
        chars.append(sixbit_to_ascii(henten(pos, 6, frame)))
        pos += 6
    s = "".join(chars)
    # strip only trailing spaces and NULs
    return s.rstrip(" \x00")


def pad_payload(payload_bits: np.ndarray) -> np.ndarray:
    """Zero-pad payload bits to DEMOD_BUFFER_LEN so out-of-range field
    reads return 0, matching the zeroed reference rbuffer."""
    out = np.zeros(DEMOD_BUFFER_LEN + 8, dtype=np.uint8)
    n = len(payload_bits)
    out[:n] = payload_bits
    return out


def hdlc_bits_to_payload(frame_bits: np.ndarray) -> np.ndarray:
    """Convert HDLC line-order bits (LSB-first per byte) to AIS payload
    order (MSB-first per byte), truncating to whole bytes.

    Mirrors the byte pack/unpack round-trip in protodec_calculate_crc
    (protodec.c:133-162): only ``len//8`` whole bytes are re-expanded.
    """
    nbytes = len(frame_bits) // 8
    b = np.asarray(frame_bits[: nbytes * 8], dtype=np.uint8).reshape(nbytes, 8)
    return b[:, ::-1].reshape(-1)  # reverse bit order within each byte


def pack_lsb_first(bits: np.ndarray) -> bytes:
    """Pack line-order bits into bytes LSB-first (protodec.c:138-143)."""
    n = len(bits) // 8
    b = np.asarray(bits[: n * 8], dtype=np.uint8).reshape(n, 8)
    weights = (1 << np.arange(8)).astype(np.uint8)
    return (b * weights).sum(axis=1).astype(np.uint8).tobytes()


def signed(value: int, bits: int) -> int:
    """Sign-extend a ``bits``-wide field (cf. protodec.c:363-369)."""
    if value & (1 << (bits - 1)):
        value -= 1 << bits
    return value
