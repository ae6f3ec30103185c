"""The comparison that decides ``correct``.

Every stream: the messages that the program delivered, each with the
block in whose call it came, against the frames the generator encoded on
it, payload bit for bit (``stream_delivery``).  A stream whose delivery
falls short is judged against the plain reference decoder
(``reference.chain``) instead, as far as the shortfall reaches
(``judged_delivery``): where a frame due was not delivered, the program
has to deliver exactly the frames the reference decodes up to a free
slot after the last one missed, and every encoded frame after it; where
its counters are off (a damaged frame that the reference does not count
either), exactly what the reference decodes, and count what it counts,
over the whole input.  The reference, as gnuais, loses a frame that
comes after long idle at some phases of its free-running clock: those
frames are lost by both, and counted apart.

A sample of streams drawn from the seed: the reference decodes their
whole input again, and the reference's copy of the dispatcher formats
its frames; the program's messages, stdout lines and NMEA sentences and
its counters have to equal them.

Each of the three numbers is exact, its limit 0: ``delivery`` (the
frames due that the program did not deliver, or delivered where the
reference has none, and the messages that match no frame),
``counters`` (the streams whose counters are off) and ``reference``.
A run's ``attempted`` is the frames due that the reference decodes, and
its ``failed`` the ``delivery`` number (``tally``): the frames lost by
both are in neither, since the program has to lose them too and their
number follows the seed, not the window's length.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence

import numpy as np

from .reference.chain import PlainReceiver
from .reference.dispatch import ChannelDispatcher

GUARD = 64


def same_payload(msg, payload: np.ndarray) -> bool:
    """A delivered message (the program's ``DecodedMessage``, or its
    ``(bufferlen, payload_bits)``) carries ``payload``: its bits, then
    the zero fill to a multiple of 6."""
    length, bits = ((msg.bufferlen, msg.payload_bits)
                    if hasattr(msg, "bufferlen") else msg)
    n = len(payload)
    return (length == n + (-n) % 6 and np.array_equal(bits[:n], payload)
            and not bits[n:length].any())


def match(delivered: Sequence, expected: Sequence,
          lookahead: int = 64) -> Dict[int, int]:
    """In order, each delivered message to the next encoded frame
    ((start, last sample, payload)) at most ``lookahead`` frames on that
    carries its payload.  Returns {frame index: message index}; a
    message that matches none (altered, spurious, repeated, out of
    order) is left out."""
    pairs: Dict[int, int] = {}
    j = 0
    for d, msg in enumerate(delivered):
        for k in range(j, min(j + lookahead, len(expected))):
            if same_payload(msg, expected[k][2]):
                pairs[k] = d
                j = k + 1
                break
    return pairs


def timed_match(delivered: Sequence, blocks: Sequence[int],
                expected: Sequence, block_len: int) -> Dict[int, int]:
    """``match`` where message d came in the call of block
    ``blocks[d]``: it pairs only with a frame whose last sample lies in
    [block start - GUARD, block end), in order.  A stream's cycle
    repeats its payloads, so the block says which copy came."""
    pairs: Dict[int, int] = {}
    j = 0
    for d, msg in enumerate(delivered):
        lo, hi = blocks[d] * block_len - GUARD, (blocks[d] + 1) * block_len
        while j < len(expected) and expected[j][1] < lo:
            j += 1
        for k in range(j, len(expected)):
            if expected[k][1] >= hi:
                break
            if same_payload(msg, expected[k][2]):
                pairs[k] = d
                j = k + 1
                break
    return pairs


def stream_delivery(delivered: Sequence, blocks: Sequence[int],
                    expected: Sequence, damaged: Sequence, counters,
                    end: int, block_len: int, prefix_crc=(0, 0)) -> dict:
    """One stream's delivery after ``end`` samples were decoded, against
    ``expected`` ((start, last sample, payload) in order), with
    ``damaged`` frames ((start, last, payload), wrong CRC) sent besides.
    ``missed``: the frames due (last sample before ``end - GUARD``) not
    delivered, by index; ``extra``: the messages that match no frame;
    ``counters_ok``: (received, wrong CRC, wrong size) read (delivered,
    the damaged frames due plus ``prefix_crc``[0], ``prefix_crc``[1]),
    a damaged frame in the last ``GUARD`` samples counted or not."""
    pairs = timed_match(delivered, blocks, expected, block_len)
    missed = [k for k, e in enumerate(expected)
              if e[1] < end - GUARD and k not in pairs]
    crc_lo = prefix_crc[0] + sum(1 for e in damaged if e[1] < end - GUARD)
    crc_hi = prefix_crc[0] + len(damaged)
    ok = (counters[0] == len(delivered) and crc_lo <= counters[1] <= crc_hi
          and counters[2] == prefix_crc[1])
    return {"due": sum(1 for e in expected if e[1] < end - GUARD),
            "missed": missed, "extra": len(delivered) - len(pairs),
            "counters_ok": ok}


def judged_delivery(delivered: Sequence, blocks: Sequence[int], cycle,
                    expected: Sequence, damaged: Sequence, counters,
                    end: int, block_len: int, cut: int) -> dict:
    """``stream_delivery`` of a stream that fell short, with the plain
    reference's own decode of its first ``cut`` samples (``cycle``
    repeated) in place of the encoded frames before ``cut``: a free
    slot, where no frame is on the air.  Adds ``lost_by_both``: the
    encoded frames before ``cut`` that the reference lacks too."""
    ref, ref_counters = plain_decode(cycle, cut)
    # a reference frame's last sample lies before its emission
    want = [(e - 1, e - 1, fr.payload_bits[:fr.bufferlen]) for e, fr in ref]
    want += [e for e in expected if e[0] >= cut]
    out = stream_delivery(delivered, blocks, want,
                          [e for e in damaged if e[0] >= cut], counters,
                          end, block_len, ref_counters[1:])
    before = sum(1 for e in expected if e[0] < cut)
    out["lost_by_both"] = before - len(ref)
    return out


def tally(traffic, delivered: Sequence, blocks: Sequence, counters: Sequence,
          end: int, block_len: int, free: int, budget: float, rng) -> dict:
    """Every stream's delivery after ``end`` samples of ``traffic`` (its
    ``samples``, ``cycle``, ``shift`` and ``frames``), with
    ``delivered``, ``blocks`` and ``counters`` given a stream each.

    A stream that falls short is judged against the plain reference
    (``judged_delivery``): where it missed frames, up to the first free
    slot (``free``: its sample in the unshifted cycle) two cycles in and
    past the last miss; where its counters are off, over the whole input.
    The streams that fell short are judged in an order drawn from
    ``rng`` while ``budget`` reference cycles last; past that, a stream's
    misses against the encoded frames count.

    Returns ``attempted``, the frames due that the reference decodes: a
    stream's encoded frames due, or, where it was judged, the
    reference's frames before the cut and the encoded frames after it;
    ``failed``, what the program got wrong: the frames due it did not
    deliver and its messages that match no frame (the ``delivery``
    check); ``counters``, the streams whose counters are off;
    ``lost_by_both``; ``short``; and ``unjudged``."""
    cycle = traffic.cycle
    attempted = failed = bad_counters = lost = 0
    short = []
    for i in range(len(delivered)):
        expected = traffic.frames(i, end)
        damaged = traffic.frames(i, end, damaged=True)
        d = stream_delivery(delivered[i], blocks[i], expected, damaged,
                            counters[i], end, block_len)
        if not d["counters_ok"]:
            # a count that no frame of the stream places: the reference
            # decodes the whole of it
            short.append((i, end, expected, damaged, d))
        elif d["missed"]:
            at = (free + int(traffic.shift[i])) % cycle
            reach = max(2 * cycle, max(expected[k][1] for k in d["missed"])
                        + GUARD)
            cut = min(end, at + -(-(reach - at) // cycle) * cycle)
            short.append((i, cut, expected, damaged, d))
        else:
            attempted += d["due"]
            failed += d["extra"]
    unjudged = 0
    for k in rng.permutation(len(short)).tolist():
        i, cut, expected, damaged, d = short[k]
        if cut / cycle <= budget:
            budget -= cut / cycle
            d = judged_delivery(delivered[i], blocks[i], traffic.samples[i],
                                expected, damaged, counters[i], end,
                                block_len, cut)
            # the reference, as gnuais, loses some frames after long idle
            # from a cold start, all in a stream's first cycle, and the
            # program has to lose the same ones: they say nothing of the
            # program and their number follows the seed, not the
            # window's length, so they are in neither ``attempted`` nor
            # ``failed`` but counted apart
            lost += d["lost_by_both"]
        else:
            unjudged += 1
        attempted += d["due"]
        failed += len(d["missed"]) + d["extra"]
        bad_counters += int(not d["counters_ok"])
    return {"attempted": attempted, "failed": failed,
            "counters": bad_counters, "lost_by_both": lost,
            "short": len(short), "unjudged": unjudged}


def plain_decode(cycle: np.ndarray, total: int):
    """The plain reference decoder over the first ``total`` samples of a
    stream that repeats ``cycle``.  Returns ((emission sample, Frame) in
    order, (received, wrong CRC, wrong size)).

    Decoding is deterministic, so once the receiver's state at the end
    of a cycle equals its state at the end of an earlier one, the cycles
    in between repeat for the rest of the stream: those are extended
    without decoding them again.  After the first cycle the FIR's
    history is the cycle's tail, so its output repeats too."""
    n = len(cycle)
    full, rem = divmod(total, n)
    rx = PlainReceiver()
    seen = {}
    snaps, frames, counts = [], [], []
    steady = None     # the FIR's output for a cycle after a cycle
    for c in range(full):
        before = rx.counters
        if c == 1:
            steady = rx.fir.run(cycle)
        frames.append(rx.run_block(cycle, steady))
        counts.append(tuple(a - b for a, b in zip(rx.counters, before)))
        snaps.append(copy.deepcopy(rx))
        key = rx.state()
        if key in seen:
            first = seen[key] + 1        # the cycles first .. c repeat
            period = c + 1 - first
            break
        seen[key] = c
    else:
        first, period = len(frames), 0
    out = [f for fs in frames for f in fs]
    counters = np.sum(counts, axis=0, dtype=np.int64) if counts else \
        np.zeros(3, np.int64)
    last = len(frames) - 1
    for c in range(len(frames), full):
        k = first + (c - first) % period
        out += [(e + (c - k) * n, fr) for e, fr in frames[k]]
        counters = counters + counts[k]
        last = k
    if rem:
        rx = copy.deepcopy(snaps[last]) if full else PlainReceiver()
        rx.position = full * n
        before = rx.counters
        out += rx.run_block(cycle[:rem],
                            None if steady is None else steady[:rem])
        counters = counters + np.subtract(rx.counters, before)
    return out, tuple(int(v) for v in counters)


def reference_messages(frames, chanid: str) -> List:
    """The reference dispatcher's messages for the reference's frames."""
    disp = ChannelDispatcher(chanid)
    return [disp.dispatch(fr.payload_bits, fr.bufferlen) for _, fr in frames]


def against_reference(delivered: Sequence, printed, counters: tuple,
                      ref_frames, ref_counters: tuple, chanid: str,
                      due_end: int, prefix: str = "") -> int:
    """One sampled stream against the plain reference: the reference's
    frames due by ``due_end`` (emitted before it, less the guard) that
    the program did not deliver (``match``), the program's messages that
    match no reference frame, and the matched messages whose stdout line
    or NMEA sentences differ from the reference dispatcher's (or, where
    ``printed``, the lines the program printed for this stream, is
    given, whose printed line is not ``prefix`` and the reference's
    line); plus 1 where ``counters`` differ from ``ref_counters``."""
    ref_msgs = reference_messages(ref_frames, chanid)
    want = [(None, e, fr.payload_bits[:fr.bufferlen]) for e, fr in ref_frames]
    pairs = match(delivered, want)
    bad = int(tuple(counters) != tuple(ref_counters))
    bad += len(delivered) - len(pairs)
    if printed is not None:
        bad += abs(len(printed) - len(delivered))
    for k, d in pairs.items():
        msg, ref = delivered[d], ref_msgs[k]
        if (msg.stdout_line != ref.stdout_line
                or msg.nmea_sentences != ref.nmea_sentences
                or (printed is not None and d < len(printed)
                    and printed[d] != prefix + ref.stdout_line)):
            bad += 1
    return bad + sum(1 for k, (e, _) in enumerate(ref_frames)
                     if e < due_end - GUARD and k not in pairs)
