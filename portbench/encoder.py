"""The benchmark's own frozen copy of the AIS frame encoder: payload
builders of the two message types the traffic sends, CRC, bit stuffing
and flags, NRZI and the 5-samples-a-bit audio levels.  It imports
nothing of the program; the CRC is the plain reference's.

Field layout per ITU-R M.1371-5 (types 1-3: 168 bits; type 5: 424).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .reference.constants import crc16_x25

PREAMBLE = np.array([(i + 1) % 2 for i in range(24)], np.uint8)  # 0101...
FLAG = np.array([0, 1, 1, 1, 1, 1, 1, 0], np.uint8)
SIXBIT = "@ABCDEFGHIJKLMNOPQRSTUVWXYZ[\\]^_ !\"#$%&'()*+,-./0123456789:;<=>?"
TEXT = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 "


class BitWriter:
    """MSB-first bit accumulator."""

    def __init__(self) -> None:
        self.bits: List[int] = []

    def put(self, value: int, nbits: int) -> "BitWriter":
        if value < 0:
            value += 1 << nbits  # two's complement
        for i in range(nbits - 1, -1, -1):
            self.bits.append((value >> i) & 1)
        return self

    def put_string(self, s: str, nchars: int) -> "BitWriter":
        for ch in s.upper().ljust(nchars)[:nchars]:
            self.put(SIXBIT.index(ch), 6)
        return self

    def array(self) -> np.ndarray:
        return np.array(self.bits, dtype=np.uint8)


def position_report(rng: np.random.Generator, msg_type: int,
                    mmsi: int) -> np.ndarray:
    """A class A position report (type 1, 2 or 3) of a vessel underway,
    every field in its range, from ``rng``."""
    w = BitWriter()
    w.put(msg_type, 6).put(0, 2).put(mmsi, 30)
    w.put(int(rng.integers(0, 9)), 4)              # navigational status
    w.put(int(rng.integers(-126, 127)), 8)         # rate of turn
    w.put(int(rng.integers(0, 300)), 10)           # speed, 0.1 kn
    w.put(int(rng.integers(0, 2)), 1)              # position accuracy
    w.put(int(rng.integers(-108_000_000, 108_000_001)), 28)  # lon, 1/10000'
    w.put(int(rng.integers(-54_000_000, 54_000_001)), 27)    # lat
    w.put(int(rng.integers(0, 3600)), 12)          # course, 0.1 degree
    w.put(int(rng.integers(0, 360)), 9)            # true heading
    w.put(int(rng.integers(0, 60)), 6)             # time stamp
    w.put(0, 2).put(0, 3).put(0, 1)                # manoeuvre, spare, RAIM
    w.put(int(rng.integers(0, 1 << 19)), 19)       # radio status
    bits = w.array()
    assert len(bits) == 168
    return bits


def static_voyage(rng: np.random.Generator, mmsi: int) -> np.ndarray:
    """A class A static and voyage related data message (type 5)."""

    def text(n):
        k = int(rng.integers(1, n + 1))
        return "".join(TEXT[int(i)] for i in rng.integers(0, len(TEXT), k))

    w = BitWriter()
    w.put(5, 6).put(0, 2).put(mmsi, 30)
    w.put(0, 2)                                    # AIS version
    w.put(int(rng.integers(1_000_000, 9_999_999)), 30)   # IMO number
    w.put_string(text(7), 7).put_string(text(20), 20)    # call sign, name
    w.put(int(rng.integers(20, 100)), 8)           # ship and cargo type
    w.put(int(rng.integers(1, 300)), 9).put(int(rng.integers(1, 100)), 9)
    w.put(int(rng.integers(1, 40)), 6).put(int(rng.integers(1, 40)), 6)
    w.put(1, 4)                                    # EPFD
    w.put(int(rng.integers(1, 13)), 4).put(int(rng.integers(1, 29)), 5)
    w.put(int(rng.integers(0, 24)), 5).put(int(rng.integers(0, 60)), 6)
    w.put(int(rng.integers(1, 200)), 8)            # draught, 0.1 m
    w.put_string(text(20), 20)                     # destination
    w.put(0, 1).put(0, 1)                          # DTE, spare
    bits = w.array()
    assert len(bits) == 424, len(bits)
    return bits


def frame_line_bits(payload_bits: np.ndarray,
                    flip: Optional[int] = None) -> np.ndarray:
    """payload (MSB-first) -> the line bits of one frame: training
    sequence, start flag, stuffed payload and FCS (LSB-first a byte;
    the FCS is the complemented CRC-16/X.25, low byte first), end flag.
    ``flip``: the payload bit sent inverted, after the FCS was made."""
    data = np.packbits(payload_bits).tobytes()
    fcs = crc16_x25(data) ^ 0xFFFF
    if flip is not None:
        sent = payload_bits.copy()
        sent[flip] ^= 1
        data = np.packbits(sent).tobytes()
    wire = np.frombuffer(data + bytes([fcs & 0xFF, fcs >> 8]), np.uint8)
    line = ((wire[:, None] >> np.arange(8)) & 1).astype(np.uint8).ravel()
    stuffed: List[int] = []
    ones = 0
    for b in line.tolist():
        stuffed.append(b)
        ones = ones + 1 if b else 0
        if ones == 5:
            stuffed.append(0)
            ones = 0
    return np.concatenate([PREAMBLE, FLAG, np.array(stuffed, np.uint8),
                           FLAG])


def nrzi_levels(data_bits: np.ndarray, start_level: int = 1) -> np.ndarray:
    """NRZI: a data 0 toggles the line level, a 1 keeps it."""
    toggles = np.cumsum(data_bits == 0) & 1
    return (start_level ^ toggles).astype(np.uint8)
