"""The sharded decode steps (counterpart of
``gnuais_tpu/parallel/sharded.py``).

``make_sharded_decode``: independent streams split over the ``streams``
axis of a grid, every shard's ``decode_block`` on its own device and no
exchange between them (AIS streams are embarrassingly parallel).

``make_multichip_step``: the streams x time step by overlap-resync.
Every time shard decodes its own extended window [lead overlap | local
block | tail extension] alone; the overlap and extension are raw samples
from its neighbours, the halos (``halo.exchange_halos``), and each
completed frame is kept by exactly one shard: the one whose own region
holds the frame's data start.  The DPLL re-locks within a few dozen
transitions and the deframer re-arms at the next preamble, so a decoder
cold-started ``overlap`` samples before its own region has converged
before any owned frame's preamble; the extension lets frames that start
near the region's end run to completion.  No filtered sample, bit or
frame moves along the time axis; the outputs are gathered time-shard-
major into one ``TimeParFrames``.

On the card each shard runs kernel B2 (``decode_block(fused_pipeline=
True)``) and ``demod.compact_candidates`` over the owned slots; the CPU
runs their plain versions.  Every shard is launched before any is read
back.  Under a cluster (``parallel.cluster``) each process runs its own
shards, and the few-KB frame outputs are read back once and all-gathered
(gloo), so that every process drains the identical global result.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from .. import constants as C
from ..golden.model import Frame, crc_check_and_extract
from ..ops import demod
from ..runtime import pipeline as pl
from .halo import exchange_halos
from .mesh import GridMesh, concat_rows, split_rows, stream_rows

DEFAULT_OVERLAP = 4096      # lead overlap: DPLL lock + max frame
DEFAULT_EXTENSION = 3072    # tail extension: > max frame

# A resynced DPLL can lock a sample or two off the continuous chain's
# emission phase, so a frame's recorded data start jitters by +-2
# samples between the two shards that both decode it.  Ownership keeps
# a margin around the own region and the drain dedups by proximity:
# distinct frames are >= ~235 samples apart (>= 47 bit slots), so a
# 2*OWN_MARGIN window is unambiguous.
OWN_MARGIN = 16


def _tensor(x, dtype=np.int16) -> torch.Tensor:
    """A host array (numpy) or a tensor as a tensor, left where it is."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype))


def make_sharded_decode(mesh: GridMesh, frame_slots: int = 32,
                        exact_fir: bool = True,
                        fused_pipeline: bool = False,
                        device_crc: bool = False,
                        superblock: int = 1,
                        **decode_flags) -> Callable:
    """Returns ``step(samples [S, T], n_valid, carry) -> (carry', frames,
    peak)`` with S split over the ``streams`` axis of ``mesh`` (each
    streams shard on the device of its time shard 0): every shard's rows
    and carry go to its device, each shard's ``decode_block`` (or, with
    superblock > 1, ``decode_superblock`` over that many chained blocks,
    whose FrameBatch leaves lead with [superblock]) is launched before
    any is read, and the results come back concatenated in row order on
    the device of shard (0, 0): equal to the unsharded step.  The flags
    select the branch in every shard as in ``decode_block``
    (``fused_pipeline``: kernel B2, and with ``kernel_compact=True``
    kernel B1).  Under a cluster, ``samples`` and ``carry`` hold this
    process's rows (``cluster.local_stream_rows``), split over its own
    streams shards, and the step returns those rows."""
    shards = mesh.local_streams()
    flags = dict(frame_slots=frame_slots, exact_fir=exact_fir,
                 fused_pipeline=fused_pipeline, device_crc=device_crc,
                 **decode_flags)
    frames_dim = 1 if superblock > 1 else 0

    def step(samples, n_valid, carry):
        samples = _tensor(samples)
        s = samples.shape[0]
        if not shards or s % len(shards):
            raise ValueError(f"{s} rows do not split over this process's "
                             f"{len(shards)} streams shards")
        per = s // len(shards)
        ins = []
        for j, si in enumerate(shards):
            dev = mesh.shard_device(si, 0)
            rows = slice(j * per, (j + 1) * per)
            ins.append((samples[rows].to(dev, non_blocking=True),
                        split_rows(carry, rows, dev)))
        outs = []
        for x, c in ins:
            if superblock > 1:
                outs.append(pl.decode_superblock(x, n_valid, c, superblock,
                                                 **flags))
            else:
                outs.append(pl.decode_block(x, n_valid, c, **flags))
        home = mesh.shard_device(shards[0], 0)
        return (concat_rows([o[0] for o in outs], home),
                concat_rows([o[1] for o in outs], home, dim=frames_dim),
                concat_rows([o[2] for o in outs], home))

    return step


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
                 nt: int = 1, row_phase: torch.Tensor | None = None, *,
                 frame_slots: int = 32, overlap: int = DEFAULT_OVERLAP,
                 extension: int = DEFAULT_EXTENSION) -> TimeParFrames:
    """The step of time shard ``ti`` of ``nt``: decode
    [left | samples | right] and keep the frames the shard owns.

    samples: int16 [S, t_loc] (t_loc >= overlap, extension), the shard's
    block, at absolute position ``global_base + ti * t_loc``; left:
    int16 [S, overlap], the samples before it (``prev_tail`` for shard
    0); right: int16 [S, extension], the samples after it
    (``next_head`` for the last shard); valid_end: the absolute sample
    count that is real data (later window positions are masked);
    row_phase: int32 [S], a per-row offset of the DPLL's grid phase (the
    grouped session's row segments; zeros for independent streams).
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
    # reduced first, as the JAX function does to stay in int32, and the
    # row's phase offset is added (floored modulo: the JAX step's int32
    # wrap is a multiple of 2^16, so the result is the same)
    phase = (torch.zeros((s_loc,), dtype=torch.int64, device=dev)
             if row_phase is None else row_phase.to(torch.int64))
    pll0 = torch.remainder(phase + C.PLL_INC * (base % 65536),
                           65536).to(torch.int32)
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


def _gather_time(parts: List[TimeParFrames],
                 device: torch.device) -> TimeParFrames:
    """One streams shard's time shards, left to right, as one
    TimeParFrames (slot blocks time-shard-major) on ``device``."""
    return TimeParFrames(*(torch.cat([leaf.to(device) for leaf in leaves],
                                     dim=1)
                           for leaves in zip(*parts)))


def _all_gather_shards(mesh: GridMesh, mine: dict,
                       shapes: List[tuple]) -> dict:
    """Every shard's outputs in every process: this process's shards
    (``mine``: flat shard index -> TimeParFrames) packed into one int32
    buffer, read back once and all-gathered (padded to the largest
    process's shard count); returns flat index -> TimeParFrames of host
    tensors for the whole grid."""
    import torch.distributed as dist
    sizes = [int(np.prod(sh)) for sh in shapes]
    per_shard = sum(sizes)
    world = dist.get_world_size()
    owned = [[k for k in range(len(mesh.devices)) if mesh.ranks[k] == r]
             for r in range(world)]
    width = max(map(len, owned)) * per_shard
    buf = torch.zeros(width, dtype=torch.int32)
    if mine:
        dev = mesh.devices[owned[mesh.rank][0]]
        local = torch.cat([_pack_timepar(mine[k]).to(dev)
                           for k in owned[mesh.rank]]).cpu()
        buf[:local.numel()] = local
    bufs = [torch.empty(width, dtype=torch.int32) for _ in range(world)]
    dist.all_gather(bufs, buf)
    out = {}
    for r in range(world):
        for j, k in enumerate(owned[r]):
            flat = bufs[r][j * per_shard:(j + 1) * per_shard]
            leaves = torch.split(flat, sizes)
            out[k] = TimeParFrames(*(v.reshape(sh)
                                     for v, sh in zip(leaves, shapes)))
    return out


def make_multichip_step(mesh: GridMesh, frame_slots: int = 32,
                        overlap: int = DEFAULT_OVERLAP,
                        extension: int = DEFAULT_EXTENSION) -> Callable:
    """The streams x time step on ``mesh``: returns ``step(samples,
    valid_end, global_base, prev_tail, next_head, row_phase=None) ->
    TimeParFrames`` with

      samples     int16 [S, Tg] (numpy or a tensor); the streams axis
                  divides S and the time axis Tg, each shard's
                  Tg/nt >= max(overlap, extension)
      valid_end   the absolute sample count that is real data
      global_base the absolute position of samples[:, 0]
      prev_tail   int16 [S, overlap]: the samples before samples[:, 0]
                  (zeros at stream start)
      next_head   int16 [S, extension]: the samples after the block
                  (zeros at stream end)
      row_phase   int32 [S]: the rows' DPLL phase offsets (None: zeros)

    Each shard's window is [from_left | local | from_right], the halos
    from ``exchange_halos`` with ``prev_tail`` and ``next_head`` at the
    row's ends.  The outputs are gathered time-shard-major, rows in
    streams order, on the device of shard (0, 0); under a cluster every
    process passes the full host arrays, runs its own shards, and gets
    the whole grid's outputs as host tensors.  A streaming caller chains
    super-blocks by handing each block's edges on
    (``timepar.TimeParSession``).  The step is the fused pipeline:
    kernel B2 on the card and its plain version on the CPU, which decode
    as the exact chain does (the JAX function's default, which its CLI
    leaves off the TPU)."""
    nt = mesh.time
    n = mesh.streams * nt
    local = [k for k in range(n) if mesh.is_local(*divmod(k, nt))]

    def step(samples, valid_end, global_base, prev_tail, next_head,
             row_phase=None) -> TimeParFrames:
        valid_end, global_base = int(valid_end), int(global_base)
        s, tg = samples.shape
        if tg % nt:
            raise ValueError(f"{tg} samples do not split over {nt} time "
                             "shards")
        t_loc = tg // nt
        samples, prev_tail, next_head = (
            _tensor(samples), _tensor(prev_tail), _tensor(next_head))
        if row_phase is not None:
            row_phase = _tensor(row_phase, np.int32)
        # every upload first (a copy from pageable memory waits for its
        # stream), then the halos, then every shard's step
        xs, tails, heads = [None] * n, [None] * n, [None] * n
        ends, phases = {}, {}
        for k in local:
            si, ti = divmod(k, nt)
            dev, rows = mesh.devices[k], stream_rows(mesh, s, si)
            xs[k] = samples[rows, ti * t_loc:(ti + 1) * t_loc].to(
                dev, non_blocking=True)
            if ti == 0:
                ends[k, "left"] = prev_tail[rows].to(dev, non_blocking=True)
            if ti == nt - 1:
                ends[k, "right"] = next_head[rows].to(dev, non_blocking=True)
            phases[k] = (None if row_phase is None else
                         row_phase[rows].to(dev, non_blocking=True))
        for k in local:
            tails[k] = xs[k][:, t_loc - overlap:]
            heads[k] = xs[k][:, :extension]
        from_left, from_right = exchange_halos(mesh, tails, heads)
        outs = {}
        for k in local:
            ti = k % nt
            left = ends[k, "left"] if ti == 0 else from_left[k]
            right = ends[k, "right"] if ti == nt - 1 else from_right[k]
            outs[k] = timepar_body(
                xs[k], valid_end, global_base, left, right, ti, nt,
                phases[k], frame_slots=frame_slots, overlap=overlap,
                extension=extension)
        if mesh.multiproc:
            s_loc = s // mesh.streams
            shapes = [(s_loc, frame_slots, demod.REG_WORDS)] \
                + [(s_loc, frame_slots)] * 3 + [(s_loc, 1)] * 3
            outs = _all_gather_shards(mesh, outs, shapes)
            home = torch.device("cpu")
        else:
            home = mesh.device
        rows = [_gather_time([outs[si * nt + ti] for ti in range(nt)], home)
                for si in range(mesh.streams)]
        return concat_rows(rows, home)

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
                         prev_bad_starts: List[int] | None = None,
                         raw: bool = False):
    """Host drain of a TimeParFrames: per stream, CRC-passing frames as
    (absolute_start, absolute_end, Frame) in start order, boundary
    duplicates removed.  ``end`` is the stop-flag sample, the
    reference's emission point.  The (stream, shard) pairs go through
    the native drain as pseudo-streams.  ``prev_starts`` (per stream)
    chains the dedup across streamed super-blocks.

    with_stats=True also returns per-stream deduped wrong-CRC counts
    (the reference's lostframes), the last bad start per stream (for
    ``prev_bad_starts``) and the lost2 and peak arrays [S, nt].

    raw=True returns the un-deduped per-stream lists instead: (ok_lists,
    bad_start_lists, lost2 [S, nt], peak [S, nt]), for a caller (the
    grouped session) that merges several rows of one channel and dedups
    across their seams itself."""
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
    if raw:
        return out, bad, _l2, _pk
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
