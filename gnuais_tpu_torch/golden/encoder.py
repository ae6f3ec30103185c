"""Synthetic AIS capture generator.

Builds valid AIS frames (payload -> FCS -> bit-stuffing -> flags ->
NRZI -> 5-samples-per-bit FM-discriminator-style audio at 48 kHz) so the
decode chain can be tested end-to-end without recorded captures.  The
inverse of the receiver; shares the CRC/bit-order contracts with
gnuais_tpu.constants.

The reference ships no test fixtures (its example config references a
capture file that is not in the tree), so synthetic captures are the
primary parity vector: the same raw file is fed to the reference binary
(file-input mode, ais.c:173-186) and to this framework, and outputs are
diffed packet-for-packet.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np

from gnuais_tpu_torch import constants as C


class BitWriter:
    """MSB-first bit accumulator for AIS payload construction."""

    def __init__(self) -> None:
        self.bits: List[int] = []

    def put(self, value: int, nbits: int) -> "BitWriter":
        if value < 0:
            value += 1 << nbits  # two's complement
        for i in range(nbits - 1, -1, -1):
            self.bits.append((value >> i) & 1)
        return self

    def put_string(self, s: str, nchars: int) -> "BitWriter":
        """AIS 6-bit string, space padded."""
        s = s.upper().ljust(nchars)
        for ch in s[:nchars]:
            v = ord(ch)
            if 64 <= v <= 95:     # '@'..'_' -> 0..31
                v -= 64
            elif 32 <= v <= 63:   # ' '..'?' -> 32..63
                pass
            else:
                v = 32
            self.put(v, 6)
        return self

    def array(self) -> np.ndarray:
        return np.array(self.bits, dtype=np.uint8)


# ---------------------------------------------------------------------------
# Payload builders (field layout per ITU-R M.1371, as read by the parser)
# ---------------------------------------------------------------------------

def make_type123(msg_type: int, mmsi: int, lat: float, lon: float,
                 sog10: int = 123, course10: int = 2345, heading: int = 77,
                 navstat: int = 0, rot: int = 0) -> np.ndarray:
    w = BitWriter()
    w.put(msg_type, 6).put(0, 2).put(mmsi, 30)
    w.put(navstat, 4)
    w.put(rot, 8)
    w.put(sog10, 10)
    w.put(1, 1)  # position accuracy
    w.put(int(round(lon * 600000.0)), 28)
    w.put(int(round(lat * 600000.0)), 27)
    w.put(course10, 12)
    w.put(heading, 9)
    w.put(31, 6)   # timestamp
    w.put(0, 2)    # maneuver... (pad out to 168)
    w.put(0, 3)
    w.put(0, 1)
    w.put(0, 19)
    bits = w.array()
    assert len(bits) == 168
    return bits


def make_type4(mmsi: int, lat: float, lon: float,
               y: int = 2026, mo: int = 8, d: int = 17, h: int = 12,
               mi: int = 34, s: int = 56) -> np.ndarray:
    w = BitWriter()
    w.put(4, 6).put(0, 2).put(mmsi, 30)
    w.put(y, 14 - 2)  # year 12 bits per parser read @40
    w.put(mo, 4).put(d, 5).put(h, 5).put(mi, 6).put(s, 6)
    w.put(1, 1)  # fix quality
    w.put(int(round(lon * 600000.0)), 28)
    w.put(int(round(lat * 600000.0)), 27)
    w.put(0, 36)  # pad to 168
    bits = w.array()
    assert len(bits) == 168
    return bits


def make_type5(mmsi: int, name: str = "TEST VESSEL", dest: str = "HARBOR",
               callsign: str = "LA1B", imo: int = 9311581,
               shiptype: int = 70, a: int = 100, b: int = 30, c: int = 10,
               d: int = 12, draught10: int = 65) -> np.ndarray:
    w = BitWriter()
    w.put(5, 6).put(0, 2).put(mmsi, 30)
    w.put(0, 2)           # AIS version
    w.put(imo, 30)
    w.put_string(callsign, 7)
    w.put_string(name, 20)
    w.put(shiptype, 8)
    w.put(a, 9).put(b, 9).put(c, 6).put(d, 6)
    w.put(1, 4)           # epfd
    w.put(8, 4).put(17, 5).put(12, 5).put(0, 6)  # eta month/day/hour/min
    w.put(draught10, 8)
    w.put_string(dest, 20)
    w.put(0, 1)           # dte
    w.put(0, 1)           # spare
    bits = w.array()
    assert len(bits) == 424, len(bits)
    return bits


def make_type18(mmsi: int, lat: float, lon: float, sog10: int = 88,
                course10: int = 1800, heading: int = 180) -> np.ndarray:
    w = BitWriter()
    w.put(18, 6).put(0, 2).put(mmsi, 30)
    w.put(0, 8)   # reserved
    w.put(sog10, 10)
    w.put(1, 1)   # accuracy
    w.put(int(round(lon * 600000.0)), 28)
    w.put(int(round(lat * 600000.0)), 27)
    w.put(course10, 12)
    w.put(heading, 9)
    w.put(60, 6)  # timestamp
    w.put(0, 2)   # reserved
    w.put(0, 27)  # flags + radio, pad to 168
    bits = w.array()
    assert len(bits) == 168
    return bits


def make_type24a(mmsi: int, name: str = "CLASSB BOAT") -> np.ndarray:
    w = BitWriter()
    w.put(24, 6).put(0, 2).put(mmsi, 30)
    w.put(0, 2)  # part A
    w.put_string(name, 20)
    w.put(0, 8)
    bits = w.array()
    assert len(bits) == 168
    return bits


def make_type24b(mmsi: int, callsign: str = "LN5C", shiptype: int = 37,
                 a: int = 8, b: int = 4, c: int = 2, d: int = 3) -> np.ndarray:
    w = BitWriter()
    w.put(24, 6).put(0, 2).put(mmsi, 30)
    w.put(1, 2)  # part B
    w.put(shiptype, 8)
    w.put(0, 42)  # vendor id
    w.put_string(callsign, 7)
    w.put(a, 9).put(b, 9).put(c, 6).put(d, 6)
    w.put(0, 6)
    bits = w.array()
    assert len(bits) == 168
    return bits


def random_payload(rng: np.random.Generator, msg_type: Optional[int] = None) -> np.ndarray:
    """A random syntactically-valid payload (whole-byte length)."""
    if msg_type is None:
        msg_type = int(rng.integers(1, 25))
    nbits = int(rng.choice([72, 96, 168, 168, 168, 312, 424]))
    w = BitWriter()
    w.put(msg_type, 6).put(0, 2).put(int(rng.integers(0, 10**9)), 30)
    rest = nbits - 38
    for _ in range(rest):
        w.bits.append(int(rng.integers(0, 2)))
    return w.array()


# ---------------------------------------------------------------------------
# Payload -> HDLC line bits
# ---------------------------------------------------------------------------

def payload_to_bytes(payload_bits: np.ndarray) -> bytes:
    assert len(payload_bits) % 8 == 0
    b = payload_bits.reshape(-1, 8)
    weights = (1 << np.arange(7, -1, -1)).astype(np.uint8)
    return (b * weights).sum(axis=1).astype(np.uint8).tobytes()


def frame_line_bits(payload_bits: np.ndarray) -> np.ndarray:
    """payload (MSB-first) -> stuffed HDLC line bits with flags/preamble.

    Line order is LSB-first per byte; FCS is the one's complement of
    CRC-16/X.25, appended low byte first (the receiver's accept rule
    crc==0x0f47 after complement is the standard X.25 residue).
    """
    data = payload_to_bytes(payload_bits)
    crc = C.crc16_x25(data)
    fcs = crc ^ 0xFFFF
    wire = data + bytes([fcs & 0xFF, (fcs >> 8) & 0xFF])

    # bytes -> LSB-first line bits
    arr = np.frombuffer(wire, dtype=np.uint8)
    line = ((arr[:, None] >> np.arange(8)) & 1).astype(np.uint8).reshape(-1)

    # bit stuffing: insert 0 after five consecutive 1s
    stuffed: List[int] = []
    ones = 0
    for b in line:
        stuffed.append(int(b))
        if b == 1:
            ones += 1
            if ones == 5:
                stuffed.append(0)
                ones = 0
        else:
            ones = 0

    preamble = [(i + 1) % 2 for i in range(24)]  # 0101...01 starting with 0
    flag = [0, 1, 1, 1, 1, 1, 1, 0]
    return np.array(preamble + flag + stuffed + flag, dtype=np.uint8)


def nrzi_encode(data_bits: np.ndarray, start_level: int = 1) -> np.ndarray:
    """NRZI-S: data 1 -> keep level, data 0 -> toggle level."""
    levels = np.empty(len(data_bits), dtype=np.uint8)
    lvl = start_level
    for i, b in enumerate(data_bits):
        if b == 0:
            lvl ^= 1
        levels[i] = lvl
    return levels


# ---------------------------------------------------------------------------
# Line levels -> audio samples
# ---------------------------------------------------------------------------

def levels_to_audio(levels: np.ndarray, amplitude: int = 8000,
                    noise_std: float = 0.0,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Each NRZI level -> SAMPLES_PER_BIT rectangular samples (int16)."""
    x = (levels.astype(np.float64) * 2.0 - 1.0) * amplitude
    audio = np.repeat(x, C.SAMPLES_PER_BIT)
    if noise_std > 0:
        rng = rng or np.random.default_rng(0)
        audio = audio + rng.normal(0.0, noise_std, size=len(audio))
    return np.clip(np.round(audio), -32768, 32767).astype(np.int16)


def synthesize_capture(payloads: Sequence[np.ndarray],
                       gap_bits: int = 64,
                       amplitude: int = 8000,
                       noise_std: float = 0.0,
                       lead_in_bits: int = 64,
                       seed: int = 0) -> np.ndarray:
    """Full mono capture: idle gaps + framed payloads -> int16 samples.

    Idle is constant NRZI data '1' (no transitions), which keeps the
    deframer in its hunt state.
    """
    rng = np.random.default_rng(seed)
    data_bits: List[int] = [1] * lead_in_bits
    for p in payloads:
        data_bits.extend(frame_line_bits(p).tolist())
        data_bits.extend([1] * gap_bits)
    levels = nrzi_encode(np.array(data_bits, dtype=np.uint8))
    return levels_to_audio(levels, amplitude, noise_std, rng)


def interleave_stereo(ch_a: np.ndarray, ch_b: np.ndarray) -> np.ndarray:
    """Interleave two mono captures into the reference's stereo layout
    (frame = [right=ch A(ofs 0), left=ch B(ofs 1)], ais.c:141-143)."""
    n = min(len(ch_a), len(ch_b))
    out = np.empty(n * 2, dtype=np.int16)
    out[0::2] = ch_a[:n]
    out[1::2] = ch_b[:n]
    return out
