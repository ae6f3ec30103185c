"""The streams x time decode step by overlap-resync (counterpart of
``gnuais_tpu/parallel/sharded.py``'s ``make_multichip_step`` and its
host drain).

Every time shard decodes its own extended window [lead overlap | local
block | tail extension] alone; the overlap and extension are raw
samples from its neighbours (the halos), and each completed frame is
kept by exactly one shard: the one whose own region holds the frame's
data start.  The DPLL re-locks within a few dozen transitions and the
deframer re-arms at the next preamble, so a decoder cold-started
``overlap`` samples before its own region has converged before any
owned frame's preamble; the extension lets frames that start near the
region's end run to completion.

``timepar_body`` is the step of one shard ``ti`` of ``nt``, with its
halos passed in.  ``make_multichip_step`` runs it on a 1 x 1 grid
(``mesh.GridMesh``), where the halos are the caller's ``prev_tail`` and
``next_head``; the exchange of halos between devices is not ported yet.
On the card the step is kernel B2 (``decode_block(fused_pipeline=True)``)
and ``demod.compact_candidates`` over the owned slots.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from .. import constants as C
from ..golden.model import Frame, crc_check_and_extract
from ..ops import demod
from ..runtime import pipeline as pl
from .mesh import GridMesh

DEFAULT_OVERLAP = 4096      # lead overlap: DPLL lock + max frame
DEFAULT_EXTENSION = 3072    # tail extension: > max frame

# A resynced DPLL can lock a sample or two off the continuous chain's
# emission phase, so a frame's recorded data start jitters by +-2
# samples between the two shards that both decode it.  Ownership keeps
# a margin around the own region and the drain dedups by proximity:
# distinct frames are >= ~235 samples apart (>= 47 bit slots), so a
# 2*OWN_MARGIN window is unambiguous.
OWN_MARGIN = 16


class TimeParFrames(NamedTuple):
    """Owned-frame outputs of one streams x time step.

    The slot axis is time-shard-major: stream ``s``'s frames from time
    shard ``j`` occupy slots ``[j*F, j*F + count[s, j])`` in arrival
    order, so reading the shards' blocks left to right gives frames in
    start order."""
    words: torch.Tensor   # [S, nt*F, REG_WORDS] int32 (uint32 bits)
    length: torch.Tensor  # [S, nt*F] int32 payload bit count
    start: torch.Tensor   # [S, nt*F] int32 absolute data-start sample
    end: torch.Tensor     # [S, nt*F] int32 absolute stop-flag sample
    count: torch.Tensor   # [S, nt] int32 owned frames per time shard
    lost2: torch.Tensor   # [S, nt] int32 bad stop flags in the own region
    peak: torch.Tensor    # [S, nt] int32 raw-sample peak per shard


def timepar_body(samples: torch.Tensor, valid_end: int, global_base: int,
                 left: torch.Tensor, right: torch.Tensor, ti: int = 0,
                 nt: int = 1, *, frame_slots: int = 32,
                 overlap: int = DEFAULT_OVERLAP,
                 extension: int = DEFAULT_EXTENSION) -> TimeParFrames:
    """The step of time shard ``ti`` of ``nt``: decode
    [left | samples | right] and keep the frames the shard owns.

    samples: int16 [S, t_loc] (t_loc >= overlap, extension), the shard's
    block, at absolute position ``global_base + ti * t_loc``; left:
    int16 [S, overlap], the samples before it (``prev_tail`` for shard
    0); right: int16 [S, extension], the samples after it
    (``next_head`` for the last shard); valid_end: the absolute sample
    count that is real data (later window positions are masked).
    Returns the shard's ``TimeParFrames`` (nt = 1)."""
    s_loc, t_loc = samples.shape
    if t_loc < overlap or t_loc < extension:
        raise ValueError(f"shard of {t_loc} samples is shorter than the "
                         f"overlap {overlap} or the extension {extension}")
    dev = samples.device
    win = torch.cat([left, samples, right], dim=1)
    base = global_base + ti * t_loc - overlap       # abs pos of win[:, 0]
    local_nv = min(max(valid_end - base, 0), win.shape[1])

    carry0 = pl.init_carry(s_loc, dev)
    # DPLL grid-phase init (timepar.time_parallel_decode): the free-run
    # phase at absolute position b is PLL_INC*b mod 2^16; the base is
    # reduced first, as the JAX function does to stay in int32
    pll0 = torch.full((s_loc,), C.PLL_INC * (base % 65536) % 65536,
                      dtype=torch.int32, device=dev)
    carry0 = carry0._replace(dpll=carry0.dpll._replace(pll=pll0))
    # lost2 position gate: each shard counts the wrong-size stops in its
    # margin-free own region; the regions tile the timeline, so the
    # union counts each event once, like the sequential chain
    _carry, frames, peak = pl.decode_block(
        win, local_nv, carry0, frame_slots=frame_slots, exact_fir=True,
        fused_pipeline=True, block_base=base,
        lost2_lo=global_base + ti * t_loc,
        lost2_hi=global_base + (ti + 1) * t_loc)

    # ownership: frames whose data start lies in the own region (with
    # the jitter margin; the drain dedups boundary duplicates)
    own_lo = global_base + ti * t_loc - OWN_MARGIN
    own_hi = global_base + (ti + 1) * t_loc + OWN_MARGIN
    slots = torch.arange(frames.start.shape[1], device=dev)
    present = slots[None, :] < frames.count[:, None]
    owned = present & (frames.start >= own_lo) & (frames.start < own_hi)
    out = demod.compact_candidates(
        demod.init_frames(s_loc, frame_slots, dev), owned, frames.words,
        frames.length, frames.start, frames.end, lost2=frames.lost2,
        over=frames.dropped)
    return TimeParFrames(out.words, out.length, out.start, out.end,
                         out.count[:, None], out.lost2[:, None],
                         peak[:, None])


def make_multichip_step(mesh: GridMesh, frame_slots: int = 32,
                        overlap: int = DEFAULT_OVERLAP,
                        extension: int = DEFAULT_EXTENSION) -> Callable:
    """The streams x time step on ``mesh``: returns ``step(samples,
    valid_end, global_base, prev_tail, next_head) -> TimeParFrames``
    with

      samples     int16 [S, Tg] (host or device)
      valid_end   the absolute sample count that is real data
      global_base the absolute position of samples[:, 0]
      prev_tail   int16 [S, overlap]: the samples before samples[:, 0]
                  (zeros at stream start)
      next_head   int16 [S, extension]: the samples after the block
                  (zeros at stream end)

    A streaming caller chains super-blocks by handing each block's
    edges on (``timepar.TimeParSession``).  The step is the fused
    pipeline: kernel B2 on the card and its plain version on the CPU,
    which decode as the exact chain does (the JAX function's default,
    which its CLI leaves off the TPU).  Only a 1 x 1 grid is supported:
    raises NotImplementedError for more devices."""
    if mesh.streams * mesh.time != 1:
        raise NotImplementedError(
            f"meshshape {mesh.streams} x {mesh.time}: the exchange of "
            "halos between devices is not ported yet (1 x 1 only)")
    dev = mesh.device
    nt = mesh.shape["time"]

    def on_device(x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int16)) \
            .to(dev)

    def step(samples, valid_end, global_base, prev_tail,
             next_head) -> TimeParFrames:
        return timepar_body(
            on_device(samples), int(valid_end), int(global_base),
            on_device(prev_tail), on_device(next_head), 0, nt,
            frame_slots=frame_slots, overlap=overlap, extension=extension)

    return step


def dedup_by_start(seq: List[tuple],
                   prev_start: int | None = None) -> List[tuple]:
    """Drop boundary duplicates: a frame whose start (item[0]) is within
    2*OWN_MARGIN of the previously kept frame is the same frame decoded
    by the neighbouring shard (distinct frames are >= ~235 samples
    apart).  ``prev_start`` chains the dedup across super-blocks."""
    out: List[tuple] = []
    last = prev_start if prev_start is not None else -(10 ** 9)
    for item in seq:
        st = item[0]
        if st <= last + 2 * OWN_MARGIN:
            continue
        out.append(item)
        last = st
    return out


def _pack_timepar(tp: TimeParFrames) -> torch.Tensor:
    """Every TimeParFrames leaf in one flat int32 tensor, so that the
    host drain costs one device-to-host copy instead of seven."""
    return torch.cat([leaf.reshape(-1).to(torch.int32) for leaf in tp])


def _unpack_timepar(tp: TimeParFrames) -> List[np.ndarray]:
    """``_pack_timepar``'s buffer on the host, split back into numpy
    arrays shaped like the leaves (words as uint32)."""
    flat = _pack_timepar(tp).cpu().numpy()
    out = []
    off = 0
    for leaf in tp:
        n = leaf.numel()
        out.append(flat[off:off + n].reshape(tuple(leaf.shape)))
        off += n
    out[0] = out[0].view(np.uint32)
    return out


def drain_timepar_frames(tp: TimeParFrames, frame_slots: int,
                         prev_starts: List[int] | None = None,
                         with_stats: bool = False,
                         prev_bad_starts: List[int] | None = None):
    """Host drain of a TimeParFrames: per stream, CRC-passing frames as
    (absolute_start, absolute_end, Frame) in start order, boundary
    duplicates removed.  ``end`` is the stop-flag sample, the
    reference's emission point.  The (stream, shard) pairs go through
    the native drain as pseudo-streams.  ``prev_starts`` (per stream)
    chains the dedup across streamed super-blocks.

    with_stats=True also returns per-stream deduped wrong-CRC counts
    (the reference's lostframes), the last bad start per stream (for
    ``prev_bad_starts``) and the lost2 and peak arrays [S, nt]."""
    words, length, start, end, count, _l2, _pk = _unpack_timepar(tp)
    s, nt = count.shape
    w = words.reshape(s * nt, frame_slots, words.shape[-1])
    ln = length.reshape(s * nt, frame_slots)
    ct = count.reshape(s * nt)

    out: List[List[Tuple[int, int, Frame]]] = [[] for _ in range(s)]
    bad: List[List[Tuple[int]]] = [[] for _ in range(s)]
    from .. import native
    if native.available():
        seen = np.zeros(s * nt, dtype=np.int64)   # arrival index per pair
        for ps, payload, flen, ok in native.drain_frames(w, ln, ct):
            slot = int(seen[ps])
            seen[ps] += 1
            stream, shard = divmod(ps, nt)
            j = shard * frame_slots + slot
            if not ok:
                bad[stream].append((int(start[stream, j]),))
                continue
            out[stream].append(
                (int(start[stream, j]), int(end[stream, j]),
                 Frame(payload, flen, True)))
    else:
        for stream in range(s):
            for shard in range(nt):
                base = shard * frame_slots
                for k in range(int(count[stream, shard])):
                    flen = int(length[stream, base + k])
                    bits = pl._reg_to_bits(words[stream, base + k],
                                           flen + C.FRAME_TAIL_BITS)
                    ok, payload = crc_check_and_extract(bits, flen)
                    if ok:
                        out[stream].append(
                            (int(start[stream, base + k]),
                             int(end[stream, base + k]),
                             Frame(payload, flen, True)))
                    else:
                        bad[stream].append((int(start[stream, base + k]),))
    kept = [dedup_by_start(lst, prev_starts[i] if prev_starts else None)
            for i, lst in enumerate(out)]
    if not with_stats:
        return kept
    bad_counts = [
        len(dedup_by_start(lst,
                           prev_bad_starts[i] if prev_bad_starts else None))
        for i, lst in enumerate(bad)]
    bad_last = [(lst[-1][0] if lst else
                 (prev_bad_starts[i] if prev_bad_starts else -10 ** 9))
                for i, lst in enumerate(bad)]
    return kept, bad_counts, bad_last, _l2, _pk
