"""Time-parallel decode: sequence parallelism over one long stream
(counterpart of ``gnuais_tpu/parallel/timepar.py``).

The DPLL/HDLC recurrence is sequential, but it forgets: the DPLL
re-locks within a few dozen transitions and the deframer re-arms at the
next preamble, so a decoder cold-started inside an overlap region
converges to the continuous decoder's trajectory before real frames
appear.  That turns time into a parallel axis:

    chunk k decodes samples [k*L - O, (k+1)*L + E)
      O (lead overlap)  >= DPLL lock + max frame
      E (tail extension) >= max frame

    a frame is kept iff its data-start sample lies in the own region
    [k*L, (k+1)*L): each frame is owned by exactly one chunk, so the
    union is duplicate-free and ordered by start position.

``time_parallel_decode`` runs the chunks as the batch lanes of one
``decode_block`` call: kernel B1 (``kernel_compact``) on the card, its
plain version on the CPU.  ``TimeParSession`` streams super-blocks
through the streams x time step of ``sharded`` (kernel B2 on every
shard of the grid) with the exact hand-off of the edges between them;
``GroupedTimeParSession`` does the same for fewer channels than the
grid's streams axis, each channel's super-block split into row
segments.

Operating envelope: resync needs transitions.  With a noise floor the
DPLL locks within any lead overlap and the lanes give the sequential
chain's frames; across digitally silent gaps longer than the overlap
the continuous chain's phase depends on its whole history, and frames
right after such a gap may be lost.  The grid-phase lane init below
makes stream starts and all-silent prefixes exact; the CLI's envelope
guard falls back to ``TimeParSession`` (exact carry hand-off) for
captures with such gaps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from ..device import resolve_device
from ..golden.model import Frame, crc_check_and_extract
from ..ops import demod
from ..runtime import pipeline as pl
from ..runtime import trace
from . import sharded as sh
from .sharded import DEFAULT_EXTENSION, DEFAULT_OVERLAP, OWN_MARGIN

@dataclass
class TimeParallelResult:
    frames: List[Frame]
    starts: List[int]            # absolute data-start sample per frame
    chunks: int
    ends: List[int] = None       # absolute stop-flag (emission) sample
    wrong_crc: int = 0           # deframed, owned, CRC-failed (deduped)
    wrong_size: int = 0          # bad stop flags in own regions (the
    #                              reference's lostframes2)
    peak: int = 0                # input |sample| peak over the capture


def _gather_lanes(stream: torch.Tensor, k: int, win: int, chunk_len: int,
                  overlap: int) -> torch.Tensor:
    """[n] -> [K, win] overlapped chunk windows, on the stream's device.

    Row i covers stream[i*chunk_len - overlap : + win] (zeros outside).
    The stride is static, so the windows come from pad + reshape +
    concat: pad so that row starts align to chunk_len, view as
    consecutive chunk_len blocks, and glue m adjacent blocks side by
    side.  Returns a view of the concat with unit stride along time,
    which the kernels read in place."""
    n = stream.shape[0]
    m = -(-win // chunk_len)             # blocks covering one window
    total = (k + m) * chunk_len
    p = torch.nn.functional.pad(stream, (overlap, total - overlap - n))
    q = p.reshape(k + m, chunk_len)
    return torch.cat([q[j:j + k] for j in range(m)], dim=1)[:, :win]


def _lane_carry(k: int, chunk_len: int, overlap: int,
                device: torch.device) -> pl.PipelineCarry:
    """The lanes' initial carry with the DPLL grid-phase init: a
    free-running DPLL advances exactly PLL_INC a sample (its wrap is mod
    2^16), so a lane whose window starts at absolute position b would,
    decoded from sample 0 through silence, hold phase PLL_INC*b mod 2^16
    at its first sample.  A cold phase of 0 leaves an offset that a
    silent lead overlap never corrects.  Lane 0's base is -overlap: the
    product is reduced in int64 with Python's (floored) modulo."""
    carry = pl.init_carry(k, device)
    bases = torch.arange(k, dtype=torch.int64) * chunk_len - overlap
    pll0 = torch.remainder(C.PLL_INC * bases, 65536).to(torch.int32)
    return carry._replace(dpll=carry.dpll._replace(pll=pll0.to(device)))


def time_parallel_decode(stream, chunk_len: int = 65_536,
                         overlap: int = DEFAULT_OVERLAP,
                         extension: int = DEFAULT_EXTENSION,
                         frame_slots: int = 64,
                         dense_cap: Optional[int] = 8192,
                         device: torch.device | str = "cuda"
                         ) -> TimeParallelResult:
    """Decode one int16 stream (numpy or a tensor) with K parallel chunk
    lanes on ``device``.

    Returns the CRC-passing frames ordered by absolute start position.
    The lanes go through the fused step with in-kernel compaction:
    kernel B1 on the card, its plain version on the CPU.  dense_cap:
    frames are compacted across lanes on the device and only occupied
    slots travel back; when a call holds more than dense_cap frames the
    per-lane slot drain runs instead.  None disables.  Traced
    (``runtime.trace``, host time, the device never synchronised): the
    gather (``lanes.gather``), the decode (``lanes.decode``) and the
    drain (``lanes.drain``)."""
    dev = resolve_device(device)
    n = len(stream)
    k = max(1, -(-n // chunk_len))          # lanes
    win = -(-(overlap + chunk_len + extension) // 512) * 512

    with trace.span("lanes.gather", mark=True):
        if not isinstance(stream, torch.Tensor):
            stream = np.ascontiguousarray(stream, dtype=np.int16)
            # a read-only map (a raw capture file) is copied once on the
            # host
            x = torch.from_numpy(stream if stream.flags.writeable
                                 else stream.copy())
        else:
            x = stream
        lanes = _gather_lanes(x.to(dev), k, win, chunk_len, overlap)
    with trace.span("lanes.decode", mark=True):
        # lost2 gate: every lane's own region is [overlap, overlap +
        # chunk_len) in window coordinates (block_base=0), so the bounds
        # gate wrong-size stops to exactly one owning lane each
        carry, frames, peak = pl.decode_block(
            lanes, win, _lane_carry(k, chunk_len, overlap, dev),
            frame_slots=frame_slots, exact_fir=True, fused_pipeline=True,
            kernel_compact=True, block_base=0, lost2_lo=overlap,
            lost2_hi=overlap + chunk_len)
    with trace.span("lanes.drain", mark=True):
        return _drain_lanes(frames, peak, k, chunk_len, overlap, dense_cap)


def _drain_lanes(frames: demod.FrameBatch, peak: torch.Tensor, k: int,
                 chunk_len: int, overlap: int, dense_cap: Optional[int]
                 ) -> TimeParallelResult:
    """The lanes' frames on the host: each kept by the lane that owns
    its start, in absolute positions."""
    # lane max == stream max (overlap duplicates and zero padding cannot
    # raise a maximum); both read back in one copy
    wrong_size, peak_val = pl._readback(torch.stack(
        [frames.lost2.sum().to(torch.int64),
         peak.max().to(torch.int64)]))[0].tolist()

    def finish(ok_items, bad_starts):
        """ok_items: (abs_start, abs_end, Frame); bad_starts: absolute
        starts of owned CRC-failed frames, deduped by proximity
        (boundary-jitter duplicates, sharded.OWN_MARGIN)."""
        ok_items.sort(key=lambda p: p[0])
        bad_starts.sort()
        n_bad = 0
        last = -(10 ** 9)
        for st in bad_starts:
            if st <= last + 2 * OWN_MARGIN:
                continue
            n_bad += 1
            last = st
        return TimeParallelResult(
            frames=[f for _, _, f in ok_items],
            starts=[s for s, _, _ in ok_items],
            ends=[e for _, e, _ in ok_items],
            chunks=k, wrong_crc=n_bad, wrong_size=wrong_size,
            peak=peak_val)

    def own(i, st):
        return (overlap if i > 0 else 0) <= st < overlap + chunk_len

    if dense_cap is not None:
        dense = demod.dense_frames(frames, dense_cap)
        over, total = pl._readback(
            torch.stack([dense.over, dense.total]))[0].tolist()
        if over == 0:
            out2: List[Tuple[int, int, Frame]] = []
            bad2: List[int] = []
            for i, lst in enumerate(pl.extract_dense(dense, k, total=total)):
                base = i * chunk_len - overlap
                for st, en, fr in lst:
                    if not own(i, st):
                        continue
                    if fr.crc_ok:
                        out2.append((base + st, base + en, fr))
                    else:
                        bad2.append(base + st)
            return finish(out2, bad2)
        # fall through: more frames than dense_cap — the slot drain

    start, end, words, length, count = pl._readback(
        frames.start, frames.end, frames.words, frames.length, frames.count)
    words = words.view(np.uint32)
    from .. import native
    use_native = native.available()
    per_stream = pl._unpack(words, length, count) if use_native else None
    out: List[Tuple[int, int, Frame]] = []
    bad: List[int] = []
    for i in range(k):
        base = i * chunk_len - overlap
        n_frames = len(per_stream[i]) if use_native else int(count[i])
        for f in range(n_frames):
            st = int(start[i, f])
            if not own(i, st):
                continue
            if use_native:
                frame = per_stream[i][f]
                if not frame.crc_ok:
                    bad.append(base + st)
                    continue
            else:
                # filter first, bit-unpack only the own-region frames
                flen = int(length[i, f])
                raw = pl._reg_to_bits(words[i, f], flen + C.FRAME_TAIL_BITS)
                ok, payload = crc_check_and_extract(raw, flen)
                if not ok:
                    bad.append(base + st)
                    continue
                frame = Frame(payload, flen, True)
            out.append((base + st, base + int(end[i, f]), frame))
    return finish(out, bad)


def _int32(v: int) -> int:
    """``v`` as an int32 position, raising OverflowError outside int32
    as ``jnp.int32`` does in the JAX session (ROADMAP section 3: a
    stream position past 2^31 samples stops both packages' sessions)."""
    v = int(v)
    if not -2 ** 31 <= v < 2 ** 31:
        raise OverflowError(f"Python integer {v} out of bounds for int32")
    return v


class TimeParSession:
    """Streams super-blocks through the streams x time step
    (``sharded.make_multichip_step``) with the exact hand-off of their
    edges.

    Each pushed block is held until its successor arrives, so that it
    decodes with a real ``next_head`` (frames that start near its end
    complete with the successor's first samples): one super-block of
    latency, no packet lost at the seams.  Duplicates across seams are
    removed through the last kept frame start per stream
    (``sharded.dedup_by_start``).  A block goes to the device when its
    step runs (``.to(device)``; a pinned, side-stream prefetch measured
    no faster on the card, ``chip_smoke.py`` phase 19).
    ``snapshot``/``restore`` keep the JAX class's keys as numpy arrays
    and Python values, so a snapshot crosses packages."""

    def __init__(self, mesh, n_streams: int, super_block: int,
                 frame_slots: int = 32,
                 overlap: int = DEFAULT_OVERLAP,
                 extension: int = DEFAULT_EXTENSION):
        self.step = sh.make_multichip_step(
            mesh, frame_slots=frame_slots, overlap=overlap,
            extension=extension)
        self.n_streams = n_streams
        self.super_block = super_block
        self.frame_slots = frame_slots
        self.overlap = overlap
        self.extension = extension
        self._held: Optional[np.ndarray] = None
        self._held_base = 0
        self._prev_tail = np.zeros((n_streams, overlap), np.int16)
        self._base = 0
        self._last_starts: Optional[List[int]] = None
        self._last_bad: Optional[List[int]] = None
        # reference per-channel accounting (ais.c:296-310): index =
        # stream row
        self.received = [0] * n_streams
        self.wrong_crc = [0] * n_streams
        self.wrong_size = [0] * n_streams
        self.last_peak = [0] * n_streams

    def _run(self, block: np.ndarray, base: int, next_head: np.ndarray,
             valid_end: int):
        valid_end, base = _int32(valid_end), _int32(base)
        tp = self.step(block, valid_end, base, self._prev_tail, next_head)
        (per_stream, bad_counts, bad_last,
         l2, pk) = sh.drain_timepar_frames(
            tp, self.frame_slots, prev_starts=self._last_starts,
            with_stats=True, prev_bad_starts=self._last_bad)
        # per-stream input peak of this push (max over time shards): the
        # reference's per-block level diagnostic (receiver.c:137-147)
        self.last_peak = [int(v) for v in pk.max(axis=1)]
        self._last_starts = [
            (lst[-1][0] if lst else
             (self._last_starts[i] if self._last_starts else -10 ** 9))
            for i, lst in enumerate(per_stream)]
        self._last_bad = bad_last
        lost2 = l2.sum(axis=1)
        for i, lst in enumerate(per_stream):
            self.received[i] += len(lst)
            self.wrong_crc[i] += bad_counts[i]
            self.wrong_size[i] += int(lost2[i])
        self._prev_tail = np.asarray(block[:, -self.overlap:])
        return per_stream

    # checkpoint/resume: the session's cross-push state is small and
    # explicit — a snapshot after any push, restored, continues byte for
    # byte (the decode is deterministic; the dedup chains and counters
    # are part of the state)
    _SNAP_KEYS = ("_held", "_held_base", "_prev_tail", "_base",
                  "_last_starts", "_last_bad", "received", "wrong_crc",
                  "wrong_size")

    def snapshot(self) -> dict:
        return {k: getattr(self, k) for k in self._SNAP_KEYS}

    def restore(self, state: dict) -> None:
        for k in self._SNAP_KEYS:
            v = state[k]
            if isinstance(getattr(self, k, None), list) \
                    and not isinstance(v, list):
                v = list(np.asarray(v).ravel())
            setattr(self, k, v)

    def push(self, samples: np.ndarray):
        """samples: int16 [S, super_block].  Returns the PREVIOUS
        super-block's per-stream (start, end, Frame) lists, or None for
        the first push."""
        s, t = samples.shape
        assert s == self.n_streams and t == self.super_block, (s, t)
        out = None
        samples = np.asarray(samples, dtype=np.int16)
        if self._held is not None:
            # real data extends through the successor's head
            next_head = np.asarray(samples[:, :self.extension])
            out = self._run(self._held, self._held_base, next_head,
                            self._base + self.extension)
        self._held = samples
        self._held_base = self._base
        self._base += t
        return out

    def flush(self, n_valid: Optional[int] = None):
        """Decode the held final block (optionally short: ``n_valid``
        real samples).  Returns its per-stream (start, end, Frame)
        lists."""
        if self._held is None:
            return [[] for _ in range(self.n_streams)]
        end = self._held_base + (n_valid if n_valid is not None
                                 else self._held.shape[1])
        out = self._run(self._held, self._held_base,
                        np.zeros((self.n_streams, self.extension),
                                 np.int16), end)
        self._held = None
        return out


class GroupedTimeParSession:
    """The grid's session for channel counts below the ``streams`` axis:
    no idle rows.

    Each channel's super-block is split into ``group`` consecutive row
    segments mapped onto that many rows of the grid (overlap-resync
    sequence parallelism along the streams axis, composed with the
    step's time shards), where ``TimeParSession`` would decode rows of
    zeros.  The step is unchanged: a row segment's lead overlap and tail
    extension are the per-row ``prev_tail``/``next_head`` the step
    takes, and within one push they come from the neighbouring row's
    samples on the host.  Only the last row of a channel needs the
    successor super-block's head: the one super-block of latency that
    ``TimeParSession`` pays too.

    Positions: the step runs in local row coordinates (global_base 0:
    every row has the same window geometry, so ownership and the lost2
    gate stay exact) with each row's DPLL grid phase offset by its
    absolute segment base (``row_phase``); the host drain offsets each
    row's frames by that base and merges the rows of a channel, deduping
    the seams' duplicates by proximity as at time-shard seams
    (``sharded.dedup_by_start``, chained across pushes).

    The final held block (real data may end mid-row, which one scalar
    valid_end cannot say per row) is decoded in ``group`` sequential
    row-padded steps of one row segment a channel with the exact
    absolute valid_end, so the counters match the sequential chain.
    ``snapshot``/``restore`` keep the JAX class's keys as numpy arrays
    and Python values, so a snapshot crosses packages."""

    def __init__(self, mesh, n_channels: int, group: int, sb_row: int,
                 frame_slots: int = 32, overlap: int = DEFAULT_OVERLAP,
                 extension: int = DEFAULT_EXTENSION):
        self.n_channels = n_channels
        self.group = group
        self.sb_row = sb_row
        self.super_block = group * sb_row     # a channel's, a push
        self.n_rows = n_channels * group
        self.frame_slots = frame_slots
        self.overlap = overlap
        self.extension = extension
        self.step = sh.make_multichip_step(
            mesh, frame_slots=frame_slots, overlap=overlap,
            extension=extension)
        self._held: Optional[np.ndarray] = None   # [n_ch, group*sb_row]
        self._held_base = 0                        # abs channel sample
        self._base = 0
        # per-channel chains and counters
        self._prev_tail_ch = np.zeros((n_channels, overlap), np.int16)
        self._last_starts: List[int] = [-(10 ** 9)] * n_channels
        self._last_bad: List[int] = [-(10 ** 9)] * n_channels
        self.received = [0] * n_channels
        self.wrong_crc = [0] * n_channels
        self.wrong_size = [0] * n_channels
        self.last_peak = [0] * n_channels

    def _account(self, ci: int, ok, bad, lost2: int):
        """Dedup channel ``ci``'s merged (start, end, Frame) and (bad
        start,) lists against its chains, count them and return the kept
        frames."""
        kept = sh.dedup_by_start(ok, self._last_starts[ci])
        bad_kept = sh.dedup_by_start(bad, self._last_bad[ci])
        if kept:
            self._last_starts[ci] = kept[-1][0]
        if bad_kept:
            self._last_bad[ci] = bad_kept[-1][0]
        self.received[ci] += len(kept)
        self.wrong_crc[ci] += len(bad_kept)
        self.wrong_size[ci] += lost2
        return kept

    def _drain_grouped(self, tp, base: int):
        """Offset each row's local frames to channel-absolute positions,
        merge the rows of each channel in segment order, dedup across
        row seams and pushes, update the counters."""
        ok_rows, bad_rows, l2, pk = sh.drain_timepar_frames(
            tp, self.frame_slots, raw=True)
        lost2 = l2.sum(axis=1)
        g = self.group
        self.last_peak = [int(pk[ci * g:(ci + 1) * g].max())
                          for ci in range(self.n_channels)]
        out = []
        for ci in range(self.n_channels):
            merged, merged_bad, l2_ch = [], [], 0
            for r in range(g):
                row = ci * g + r
                off = base + r * self.sb_row
                merged += [(off + st, off + en, fr)
                           for st, en, fr in ok_rows[row]]
                merged_bad += [(off + st,) for (st,) in bad_rows[row]]
                l2_ch += int(lost2[row])
            out.append(self._account(ci, merged, merged_bad, l2_ch))
        return out

    def _run_grouped(self, block: np.ndarray, base: int,
                     next_first_head: np.ndarray):
        """A full grouped push: every row fully valid, extensions real."""
        g, sbr, ov, ext = (self.group, self.sb_row, self.overlap,
                           self.extension)
        rows = block.reshape(self.n_channels * g, sbr)
        prev_tail = np.empty((self.n_rows, ov), np.int16)
        next_head = np.empty((self.n_rows, ext), np.int16)
        for ci in range(self.n_channels):
            for r in range(g):
                row = ci * g + r
                prev_tail[row] = (rows[row - 1, -ov:] if r > 0
                                  else self._prev_tail_ch[ci])
                next_head[row] = (rows[row + 1, :ext] if r < g - 1
                                  else next_first_head[ci])
        # per-row absolute phase offsets: local coordinates hide each
        # segment's true position from the step's grid-phase DPLL init
        row_abs = base + np.tile(np.arange(g, dtype=np.int64) * sbr,
                                 self.n_channels)
        phase = ((C.PLL_INC * (row_abs % 65536)) % 65536).astype(np.int32)
        tp = self.step(rows, _int32(sbr + ext), 0, prev_tail, next_head,
                       row_phase=phase)
        out = self._drain_grouped(tp, base)
        self._prev_tail_ch = np.asarray(
            rows[np.arange(self.n_channels) * g + (g - 1), -ov:])
        return out

    def _run_fallback(self, block: np.ndarray, base: int, n_valid: int):
        """The final held block: ``group`` sequential row-padded steps
        with the exact absolute valid_end (data may end mid-row)."""
        g, sbr, ov, ext = (self.group, self.sb_row, self.overlap,
                           self.extension)
        data_end = base + n_valid
        out = [[] for _ in range(self.n_channels)]
        prev_tail = np.zeros((self.n_rows, ov), np.int16)
        for r in range(g):
            seg_base = base + r * sbr
            if seg_base >= data_end and r > 0:
                break
            seg = np.zeros((self.n_rows, sbr), np.int16)
            head = np.zeros((self.n_rows, ext), np.int16)
            for ci in range(self.n_channels):
                seg[ci] = block[ci, r * sbr:(r + 1) * sbr]
                if r < g - 1:
                    head[ci] = block[ci, (r + 1) * sbr:(r + 1) * sbr + ext]
                prev_tail[ci] = (block[ci, r * sbr - ov:r * sbr]
                                 if r > 0 else self._prev_tail_ch[ci])
            tp = self.step(seg, _int32(min(data_end, seg_base + sbr + ext)),
                           _int32(seg_base), prev_tail, head)
            ok_rows, bad_rows, l2, pk = sh.drain_timepar_frames(
                tp, self.frame_slots, raw=True)
            lost2 = l2.sum(axis=1)
            self.last_peak = [int(pk[ci].max())
                              for ci in range(self.n_channels)]
            for ci in range(self.n_channels):
                out[ci] += self._account(ci, ok_rows[ci], bad_rows[ci],
                                         int(lost2[ci]))
            for ci in range(self.n_channels):
                self._prev_tail_ch[ci] = seg[ci, -ov:]
        return out

    # checkpoint/resume: the same contract as TimeParSession.snapshot
    _SNAP_KEYS = ("_held", "_held_base", "_prev_tail_ch", "_base",
                  "_last_starts", "_last_bad", "received", "wrong_crc",
                  "wrong_size")
    snapshot = TimeParSession.snapshot
    restore = TimeParSession.restore

    def push(self, samples: np.ndarray):
        """samples: int16 [n_channels, group*sb_row].  Returns the
        PREVIOUS super-block's per-channel (start, end, Frame) lists, or
        None for the first push."""
        s, t = samples.shape
        assert s == self.n_channels and t == self.super_block, (s, t)
        out = None
        if self._held is not None:
            next_first_head = np.asarray(samples[:, :self.extension])
            out = self._run_grouped(self._held, self._held_base,
                                    next_first_head)
        self._held = np.asarray(samples, dtype=np.int16)
        self._held_base = self._base
        self._base += t
        return out

    def flush(self, n_valid: Optional[int] = None):
        if self._held is None:
            return [[] for _ in range(self.n_channels)]
        nv = n_valid if n_valid is not None else self._held.shape[1]
        out = self._run_fallback(self._held, self._held_base, nv)
        self._held = None
        return out
