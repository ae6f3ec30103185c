"""The plain reference decoder of the benchmark: a frozen copy of the
port's golden model of the decode chain (pure NumPy/Python), which
imports nothing of the program.  Each stage mirrors the reference C
decoder gnuais exactly (citations inline):

  int16 samples -> FIR (float32, C accumulation order, 1-sample delay)
                -> DPLL clock recovery (16-bit integer phase)
                -> NRZI decode -> HDLC state machine w/ destuffing
                -> CRC-16/X.25 residue check -> payload frames

Added to the copy: the sample at which each frame is emitted
(``PlainReceiver``), and the receiver's whole state as a value, so that
a caller can see when a periodic input has brought it back to a state
it had before.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from . import constants as C
from .bits import hdlc_bits_to_payload, pack_lsb_first


# ---------------------------------------------------------------------------
# FIR (filter.c:106-143, receiver.c:39-49)
# ---------------------------------------------------------------------------

class GoldenFir:
    """36-tap FIR with float32 accumulation in C order.

    The reference writes the new sample at buffer[pointer] and MACs over
    buffer[pointer-36 .. pointer-1]; i.e. out[n] excludes x[n] and
    covers x[n-36..n-1]:  out[n] = sum_i taps[i] * x[n-36+i].
    History (the last 36 inputs) carries across blocks.
    """

    def __init__(self, taps: np.ndarray = C.FIR_TAPS):
        self.taps = np.asarray(taps, dtype=np.float32)
        self.history = np.zeros(len(self.taps), dtype=np.float32)

    def run(self, samples: np.ndarray) -> np.ndarray:
        """samples: int16 [n]; returns float32 [n] filtered output."""
        x = np.concatenate([self.history, samples.astype(np.float32)])
        n = len(samples)
        L = len(self.taps)
        out = np.zeros(n, dtype=np.float32)
        term = np.empty(n, dtype=np.float32)
        # Accumulate tap-by-tap in the same order as the C loop
        # (filter_mac, filter.c:43-53): each product and partial sum is
        # rounded to float32, vectorized over output positions.
        for i in range(L):
            np.multiply(x[i : i + n], self.taps[i], out=term)
            np.add(out, term, out=out)
        self.history = x[n : n + L].copy()
        return out


# ---------------------------------------------------------------------------
# DPLL + slicer + NRZI (receiver.c:87-135)
# ---------------------------------------------------------------------------

@dataclass
class DpllState:
    pll: int = 0
    prev: int = 0      # previous sample's sign bit
    lastbit: int = 0   # previous sliced bit (for NRZI)


class GoldenDpll:
    """16-bit phase-accumulator DPLL: one sliced+NRZI-decoded bit out
    per phase wrap (nominally every 5 samples)."""

    def __init__(self) -> None:
        self.state = DpllState()

    def run(self, filtered: np.ndarray):
        """``run_per_sample``'s result, a run of equal slicer decisions
        at a time: only a transition nudges the phase, so between two
        transitions it advances by PLL_INC a sample and the samples at
        which it wraps follow in closed form."""
        s = self.state
        curr = (filtered > 0).astype(np.int64)
        n = len(curr)
        if n == 0:
            return np.zeros(0, np.uint8), np.zeros(0, np.int64)
        prevs = np.concatenate([[s.prev], curr[:-1]])
        moves = np.flatnonzero(curr != prevs)
        edges = np.union1d(moves, [0, n]).tolist()
        moving = set(moves.tolist())
        pll, lastbit = s.pll, s.lastbit
        bits: List[int] = []
        where: List[int] = []
        values = dict(zip(edges[:-1], curr[edges[:-1]].tolist()))
        inc = C.PLL_INC
        for a, b in zip(edges[:-1], edges[1:]):
            c = values[a]
            if a in moving:
                pll += C.PLL_NUDGE if pll < C.PLL_CENTER else -C.PLL_NUDGE
            total = pll + inc * (b - a)
            wraps = total >> 16
            if wraps:
                # wrap k comes at the sample where pll + inc * (j + 1)
                # reaches k * 2^16
                if wraps < 32:
                    where += [a - 1 - (pll - k * 0x10000) // inc
                              for k in range(1, wraps + 1)]
                else:
                    k = np.arange(1, wraps + 1, dtype=np.int64)
                    where += (a - 1 - (pll - k * 0x10000) // inc).tolist()
                bits.append(0 if c ^ lastbit else 1)          # NRZI decode
                bits += [1] * (wraps - 1)
                lastbit = c
            pll = total & 0xFFFF
        s.pll, s.prev, s.lastbit = pll, int(curr[-1]), lastbit
        return np.array(bits, np.uint8), np.array(where, np.int64)

    def run_per_sample(self, filtered: np.ndarray):
        """filtered: float32 [n]; returns (uint8 array of NRZI-decoded
        bits, int64 array of the sample index within ``filtered`` at
        which each bit was sliced)."""
        s = self.state
        bits: List[int] = []
        where: List[int] = []
        pll, prev, lastbit = s.pll, s.prev, s.lastbit
        for n, out in enumerate(filtered.tolist()):
            curr = 1 if out > 0 else 0
            if curr ^ prev:
                if pll < C.PLL_CENTER:
                    pll += C.PLL_NUDGE
                else:
                    pll -= C.PLL_NUDGE
            prev = curr
            pll += C.PLL_INC
            if pll > 0xFFFF:
                bit = curr
                bits.append(0 if (bit ^ lastbit) else 1)  # NRZI decode
                where.append(n)
                lastbit = bit
                pll &= 0xFFFF
        s.pll, s.prev, s.lastbit = pll, prev, lastbit
        return np.array(bits, dtype=np.uint8), np.array(where, np.int64)


# ---------------------------------------------------------------------------
# HDLC deframer (protodec.c:988-1122)
# ---------------------------------------------------------------------------

@dataclass
class Frame:
    """One CRC-checked frame in HDLC line order."""
    payload_bits: np.ndarray   # MSB-first AIS order, len = bufferlen
    bufferlen: int             # payload bits (no FCS)
    crc_ok: bool


@dataclass
class HdlcState:
    state: int = C.ST_SKURR
    nskurr: int = 0
    ndata: int = 0
    npreamble: int = 0
    nstartsign: int = 0
    nstopsign: int = 0
    antallpreamble: int = 0
    antallenner: int = 0
    last: int = 0
    bitstuff: int = 0
    bufferpos: int = 0
    buffer: np.ndarray = field(
        default_factory=lambda: np.zeros(C.DEMOD_BUFFER_LEN, dtype=np.uint8))
    # stats counters (protodec.h:58-60)
    receivedframes: int = 0
    lostframes: int = 0
    lostframes2: int = 0


def crc_check_and_extract(buffer: np.ndarray, length_bits: int):
    """protodec_calculate_crc semantics (protodec.c:120-167):

    pack ``length_bits//8 + 2`` bytes LSB-first from the line-order bit
    buffer (payload truncated to whole bytes, plus the next 16 bits as
    FCS), CRC them, and accept iff the complemented CRC equals 0x0f47.
    Returns (ok, payload_bits_msb_first).
    """
    if length_bits <= 0:
        return False, None
    length_bytes = length_bits // 8
    buflen = length_bytes + 2
    data = pack_lsb_first(buffer[: buflen * 8])
    crc = C.crc16_x25(data)
    ok = ((~crc) & 0xFFFF) == C.CRC_MAGIC_RESIDUE
    payload = hdlc_bits_to_payload(buffer[: length_bytes * 8])
    return ok, payload


class GoldenHdlc:
    """The reference's 5-state bit-level deframer, exactly."""

    def __init__(self) -> None:
        self.s = HdlcState()

    def _reset(self) -> None:
        s = self.s
        s.state = C.ST_SKURR
        s.nskurr = 0
        s.ndata = 0
        s.npreamble = 0
        s.nstartsign = 0
        s.nstopsign = 0
        s.antallpreamble = 0
        s.antallenner = 0
        s.last = 0
        s.bitstuff = 0
        s.bufferpos = 0

    def run(self, bits: np.ndarray, per_bit: bool = False) -> List[tuple]:
        """Returns (bit index within ``bits`` of the emission, Frame) for
        each CRC-passing frame.  In the hunt state a run of bits equal
        to the last one only counts (``nskurr``): unless ``per_bit``,
        such a run is taken at once."""
        frames: List[tuple] = []
        s = self.s
        seq = bits.tolist()
        n = len(seq)
        change = np.flatnonzero(np.diff(bits.astype(np.int8))) + 1
        i = 0
        while i < n:
            b = seq[i]
            if not per_bit and s.state == C.ST_SKURR and b == s.last:
                k = np.searchsorted(change, i, side="right")
                j = int(change[k]) if k < len(change) else n
                s.antallpreamble = 0
                s.nskurr += j - i
                i = j
                continue
            if s.state == C.ST_DATA:
                if s.bitstuff:
                    if b == 1:
                        s.state = C.ST_STOPSIGN
                        s.ndata = 0
                        s.bitstuff = 0
                    else:
                        s.ndata += 1
                        s.last = b
                        s.bitstuff = 0
                else:
                    if b == s.last and b == 1:
                        s.antallenner += 1
                        if s.antallenner == 4:
                            s.bitstuff = 1
                            s.antallenner = 0
                    else:
                        s.antallenner = 0
                    s.buffer[s.bufferpos] = b
                    s.bufferpos += 1
                    s.ndata += 1
                    if s.bufferpos >= C.MAX_FRAME_DATA_BITS:
                        self._reset()

            elif s.state == C.ST_SKURR:
                if b != s.last:
                    s.antallpreamble += 1
                else:
                    s.antallpreamble = 0
                s.last = b
                if s.antallpreamble > 14 and b == 0:
                    s.state = C.ST_PREAMBLE
                    s.nskurr = 0
                    s.antallpreamble = 0
                s.nskurr += 1

            elif s.state == C.ST_PREAMBLE:
                if b != s.last and s.nstartsign == 0:
                    s.antallpreamble += 1
                else:
                    if b == 1:
                        if s.nstartsign == 0:
                            s.nstartsign = 3
                            s.last = b
                        elif s.nstartsign == 5:
                            s.nstartsign += 1
                            s.npreamble = 0
                            s.antallpreamble = 0
                            s.state = C.ST_STARTSIGN
                        else:
                            s.nstartsign += 1
                    else:
                        if s.nstartsign == 0:
                            s.nstartsign = 1
                        else:
                            self._reset()
                s.npreamble += 1

            elif s.state == C.ST_STARTSIGN:
                if s.nstartsign >= 7:
                    if b == 0:
                        s.state = C.ST_DATA
                        s.nstartsign = 0
                        s.antallenner = 0
                        s.buffer[:] = 0
                        s.bufferpos = 0
                    else:
                        self._reset()
                elif b == 0:
                    self._reset()
                s.nstartsign += 1

            elif s.state == C.ST_STOPSIGN:
                bufferlength = s.bufferpos - C.FRAME_TAIL_BITS
                if b == 0 and bufferlength > 0:
                    ok, payload = crc_check_and_extract(s.buffer, bufferlength)
                    if ok:
                        s.receivedframes += 1
                        frames.append((i, Frame(payload, bufferlength,
                                                True)))
                    else:
                        s.lostframes += 1
                else:
                    s.lostframes2 += 1
                self._reset()

            s.last = b
            i += 1
        return frames


# ---------------------------------------------------------------------------
# Full per-channel receiver
# ---------------------------------------------------------------------------

class PlainReceiver:
    """One AIS channel: FIR + DPLL + HDLC chained with carried state,
    mirroring receiver_run (receiver.c:87-148), fed block after block.
    ``position`` counts the samples fed so far."""

    def __init__(self):
        self.fir = GoldenFir()
        self.dpll = GoldenDpll()
        self.hdlc = GoldenHdlc()
        self.position = 0

    def run_block(self, samples: np.ndarray,
                  filtered: np.ndarray = None) -> List[tuple]:
        """samples: int16 [n].  Returns (absolute sample index of the
        emission, Frame) for each CRC-passing frame, in order.
        ``filtered``: the FIR's output for ``samples``, where the caller
        has it already (the FIR then keeps its history)."""
        if filtered is None:
            filtered = self.fir.run(samples)
        bits, where = self.dpll.run(filtered)
        out = [(self.position + int(where[i]), fr)
               for i, fr in self.hdlc.run(bits)]
        self.position += len(samples)
        return out

    @property
    def counters(self):
        s = self.hdlc.s
        return (s.receivedframes, s.lostframes, s.lostframes2)

    def state(self) -> tuple:
        """Everything that decides what the receiver does with its next
        samples, as a comparable value (no counters, no position)."""
        h = self.hdlc.s
        d = self.dpll.state
        return (self.fir.history.tobytes(), d.pll, d.prev, d.lastbit,
                h.state, h.nskurr, h.ndata, h.npreamble, h.nstartsign,
                h.nstopsign, h.antallpreamble, h.antallenner, h.last,
                h.bitstuff, h.bufferpos, h.buffer[:h.bufferpos].tobytes())
