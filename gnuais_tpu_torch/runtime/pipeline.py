"""Batched decode pipeline: the device step and the host frame drain
(counterpart of ``gnuais_tpu/runtime/pipeline.py``).

``decode_block`` consumes an int16 ``[S, T]`` block and the carry (FIR
history, DPLL state, HDLC state) and returns the new carry, the block's
frame snapshots and the per-stream peak.  Its branches, in JAX's order
of precedence:

- ``kernel_compact`` (with ``fused_pipeline``): kernel B1, frames in
  dense slots;
- ``pretiled_streams`` (a time-major ``[T, S]`` input, with
  ``fused_pipeline``) and ``fused_pipeline``: kernel B2, its frame
  candidates compacted by ``demod.compact_candidates``;
  each fused branch optionally followed by the on-device CRC filter;
- ``fused_frontend``: kernel B3 (FIR, DPLL, bit slots), then the
  deframer;
- ``fast_dpll``: the FIR, kernel B4, the group reduce and the deframer;
- otherwise the exact chain (``exact_fir=False`` takes the convolution
  FIR ``fir.fir_conv`` in both of these).
On the card these three run as kernels end to end (``_card_route``):
B3's or B4's codes go straight to the deframer kernel (``fused.
hdlc_fused``), and the exact chain is the ``fast_dpll`` route, since B4
is ``dpll_scan`` bit for bit on the emitted bits; then
``demod.compact_candidates``.  On the CPU they run the plain versions.

``decode_superblock`` chains K blocks through ``decode_block``.  The
host unpacks the frame snapshots, checks CRC-16 and hands the payloads
to the AIS layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from ..golden.model import Frame, crc_check_and_extract
from ..device import resolve_device
from ..ops import crc as crc_ops
from ..ops import demod, fir
from ..ops import fused
from ..ops.fused import (bit_slots, frontend_fused, pipeline_fused,
                         pipeline_fused_compact)
from . import trace


class PipelineCarry(NamedTuple):
    history: torch.Tensor     # [S, 36] float32 FIR history
    dpll: demod.DpllState
    hdlc: demod.HdlcState


def init_carry(n_streams: int, device: torch.device | str) -> PipelineCarry:
    return PipelineCarry(
        history=fir.init_history(n_streams, device),
        dpll=demod.init_dpll(n_streams, device),
        hdlc=demod.init_hdlc(n_streams, device),
    )


def _device_crc_filter(frames: demod.FrameBatch, s: int,
                       frame_slots: int) -> demod.FrameBatch:
    """On-device CRC post-pass: the linear CRC over every slot, then
    keep only the passing frames (compacted in arrival order); rejects
    land in the crcfail counter."""
    ok = crc_ops.crc_check_frames_linear(
        frames.words.reshape(-1, frames.words.shape[-1]),
        frames.length.reshape(-1)).reshape(s, frame_slots)
    slots = torch.arange(frame_slots, device=frames.count.device)
    present = slots[None, :] < frames.count[:, None]
    crcfail = (present & ~ok).sum(dim=1).to(torch.int32)
    kept = demod.compact_candidates(
        demod.init_frames(s, frame_slots, frames.words.device), present & ok,
        frames.words, frames.length, frames.start, frames.end,
        lost2=frames.lost2, over=frames.dropped)
    return kept._replace(crcfail=crcfail)


def _fused_step(samples, n_valid, carry, frame_slots, block_base, fir_mode,
                lost2_lo, lost2_hi, assume_full, pretiled_streams,
                kernel_compact):
    """The fused branches of ``decode_block``: kernel B1
    (``kernel_compact``) or kernel B2 and ``compact_candidates``.
    Returns (carry', frames)."""
    kw = dict(block_base=block_base, fir_mode=fir_mode, lost2_lo=lost2_lo,
              lost2_hi=lost2_hi, assume_full=assume_full,
              pretiled_streams=pretiled_streams)
    if kernel_compact:
        # in-kernel compaction: dense frame slots straight from the
        # kernel, the [S, K] candidate axis never exists
        (count_raw, words, length, start, end, lost2, over,
         history, dpll_state, hdlc_state) = pipeline_fused_compact(
            samples, n_valid, carry.history, carry.dpll, carry.hdlc,
            frame_slots=frame_slots, **kw)
        # count_raw is not clipped to the slots: the excess was dropped
        frames = demod.FrameBatch(
            words=words, length=length, start=start, end=end,
            count=torch.clamp(count_raw, max=frame_slots), lost2=lost2,
            dropped=over + torch.clamp(count_raw - frame_slots, min=0),
            crcfail=torch.zeros_like(count_raw))
    else:
        (cand_valid, cw, cl, cs, ce, lost2, over,
         history, dpll_state, hdlc_state) = pipeline_fused(
            samples, n_valid, carry.history, carry.dpll, carry.hdlc, **kw)
        frames = demod.compact_candidates(
            demod.init_frames(cand_valid.shape[0], frame_slots,
                              samples.device),
            cand_valid, cw, cl, cs, ce, lost2=lost2, over=over)
    return PipelineCarry(history, dpll_state, hdlc_state), frames


def _card_route(samples, n_valid, carry, frame_slots, block_base,
                fused_frontend, exact_fir, lost2_lo, lost2_hi):
    """The unfused branches of ``decode_block`` on the card, kernels end
    to end: B3 (``fused_frontend``) or the FIR and B4, their codes read
    by the deframer kernel as they were written, then the candidates'
    compaction.  No step loops on the host.  Returns (carry', frames)."""
    if fused_frontend:
        codes, history, dpll_state = fused.frontend_codes(
            samples, n_valid, carry.history, carry.dpll)
        form = "group"
    else:
        fir_fn = fir.fir_exact if exact_fir else fir.fir_conv
        filtered, history = fir_fn(samples, carry.history, n_valid=n_valid)
        codes, dpll_state = fused.dpll_codes(filtered, n_valid, carry.dpll)
        form = "sample"
    hdlc_state, c = fused.hdlc_fused(carry.hdlc, codes, form,
                                     block_base=block_base, lost2_lo=lost2_lo,
                                     lost2_hi=lost2_hi)
    frames = demod.compact_candidates(
        demod.init_frames(samples.shape[0], frame_slots, samples.device),
        c.valid, c.words, c.length, c.start, c.end, lost2=c.lost2,
        over=c.over)
    return PipelineCarry(history, dpll_state, hdlc_state), frames


def decode_block(samples: torch.Tensor, n_valid: int, carry: PipelineCarry,
                 frame_slots: int = 32, block_base: int = 0,
                 fast_dpll: bool = False, fused_frontend: bool = False,
                 fused_pipeline: bool = False, device_crc: bool = False,
                 lost2_lo: Optional[int] = None,
                 lost2_hi: Optional[int] = None, exact_fir: bool = True,
                 lobe_fir: bool = False, mxu_fir: bool = False,
                 kernel_compact: bool = False,
                 pretiled_streams: Optional[int] = None,
                 with_peak: bool = True, assume_full: bool = False
                 ) -> Tuple[PipelineCarry, demod.FrameBatch, torch.Tensor]:
    """samples: int16 [S, T], or with ``pretiled_streams=S`` the block
    time-major, [T, S] (``ops.fused.tile_superblock``); n_valid: samples
    actually present (short final blocks are padded to T); block_base:
    absolute index of sample 0.  Returns (carry', frames, peak [S]).

    fused_pipeline runs the fused step: kernel B2
    (``ops.fused.pipeline_fused``) whose frame candidates
    ``demod.compact_candidates`` compacts, or with kernel_compact kernel
    B1 (``pipeline_fused_compact``), which returns dense frame slots;
    device_crc then CRC-checks them on the device and keeps only passing
    frames (rejects counted in ``frames.crcfail``).  mxu_fir selects
    the kernels' tensor-core FIR (a banded product per 32-sample chunk),
    lobe_fir their main-lobe FIR (mxu_fir first, as in the JAX package);
    both are held to packet parity, not bitwise.  assume_full promises
    n_valid == T (a checked promise: the kernels have no variant without
    the per-sample gates); with_peak False skips the level meter's pass
    over the block.
    The pretiled input takes the fused branches only and without the
    peak, as in the JAX package, but unlike there it may be a short
    block: its history comes from the time-major rows for any n_valid,
    so it needs no assume_full.  Otherwise the block is cut
    into 4-sample bit slots by ``ops.fused.frontend_fused``
    (fused_frontend) or by the FIR (``fir_exact``, or ``fir_conv`` when
    exact_fir is False) and ``dpll_fused`` (fast_dpll) or ``dpll_scan``
    (the default), and ``demod.hdlc_scan`` deframes them; on the card
    these run as B3 or B4 and the deframer kernel (``_card_route``).
    Each kernel wrapper launches its CUDA kernel for a CUDA tensor and
    runs its plain version for a CPU tensor; every branch but the mxu,
    lobe and convolution FIRs gives the exact chain's result bit for
    bit.

    The JAX function's TPU tiling knobs are not ported."""
    if mxu_fir and not fused_pipeline:
        raise ValueError("mxu_fir requires fused_pipeline")
    if device_crc and not fused_pipeline:
        raise ValueError("device_crc requires fused_pipeline")
    if lobe_fir and not fused_pipeline:
        raise ValueError("lobe_fir requires fused_pipeline")
    if kernel_compact and not fused_pipeline:
        raise ValueError("kernel_compact requires fused_pipeline")
    if pretiled_streams is not None and (not fused_pipeline or with_peak):
        raise ValueError("pretiled_streams requires fused_pipeline and "
                         "with_peak=False")
    if fused_pipeline:
        carry, frames = _fused_step(
            samples, n_valid, carry, frame_slots, block_base,
            "mxu" if mxu_fir else "lobe" if lobe_fir else "vpu", lost2_lo,
            lost2_hi, assume_full, pretiled_streams, kernel_compact)
        s = frames.count.shape[0]
        if device_crc:
            frames = _device_crc_filter(frames, s, frame_slots)
        # block_peak re-reads the whole raw block; throughput callers
        # that feed no level monitor skip it
        peak = fir.block_peak(samples) if with_peak else \
            torch.zeros((s,), dtype=torch.int32, device=samples.device)
        return carry, frames, peak
    s = samples.shape[0]
    if fused.on_card(samples):
        carry, frames = _card_route(samples, n_valid, carry, frame_slots,
                                    block_base, fused_frontend, exact_fir,
                                    lost2_lo, lost2_hi)
        return carry, frames, fir.block_peak(samples)
    if fused_frontend:
        slots = frontend_fused(samples, n_valid, carry.history, carry.dpll,
                               block_base)
    else:
        slots = bit_slots(samples, n_valid, carry.history, carry.dpll,
                          block_base, fast_dpll=fast_dpll,
                          exact_fir=exact_fir)
    gbits, gvalid, gpos, history, dpll_state = slots
    hdlc_state, frames = demod.hdlc_scan(
        gbits, gvalid, carry.hdlc,
        demod.init_frames(s, frame_slots, samples.device), gpos,
        lost2_lo=lost2_lo, lost2_hi=lost2_hi)
    peak = fir.block_peak(samples)
    return PipelineCarry(history, dpll_state, hdlc_state), frames, peak


def decode_superblock(samples: torch.Tensor, n_valid: int,
                      carry: PipelineCarry, n_blocks: int,
                      frame_slots: int = 32, block_base: int = 0,
                      **flags) -> Tuple[PipelineCarry, demod.FrameBatch,
                                        torch.Tensor]:
    """Decode ``n_blocks`` consecutive blocks of ``samples`` (int16
    [S, n_blocks * T], row-major; or with ``pretiled_streams`` in
    ``flags`` [n_blocks, T, S], each block time-major, as
    ``ops.fused.tile_superblock`` makes it) in turn through
    ``decode_block``, the carry chained from each block to the next on
    the device.

    n_valid counts over the whole superblock: block k decodes
    ``clip(n_valid - k*T, 0, T)`` samples at ``block_base + k*T``.
    Returns (carry', frames, peak): the FrameBatch leaves stacked on a
    leading [n_blocks] axis and peak [S] the maximum over the blocks.
    The same result as n_blocks sequential ``decode_block`` calls with
    the same ``flags``."""
    if flags.get("pretiled_streams") is not None:
        if samples.dim() != 3 or samples.shape[0] != n_blocks:
            raise ValueError(f"pretiled superblock {tuple(samples.shape)} "
                             f"is not [{n_blocks}, T, S]")
        t = samples.shape[1]
        blocks = samples.unbind(0)
    else:
        total = samples.shape[1]
        if n_blocks < 1 or total % n_blocks:
            raise ValueError(f"{total} samples do not split into "
                             f"{n_blocks} blocks")
        t = total // n_blocks
        blocks = [samples[:, k * t:(k + 1) * t] for k in range(n_blocks)]
    per_block, peaks = [], []
    for k, xb in enumerate(blocks):
        nv = min(max(int(n_valid) - k * t, 0), t)
        carry, frames, peak = decode_block(
            xb, nv, carry, frame_slots=frame_slots,
            block_base=block_base + k * t, **flags)
        per_block.append(frames)
        peaks.append(peak)
    frames_k = demod.FrameBatch(*(torch.stack(leaf) for leaf in
                                  zip(*per_block)))
    return carry, frames_k, torch.stack(peaks).amax(dim=0)


# ---------------------------------------------------------------------------
# Host drain
# ---------------------------------------------------------------------------

def _reg_to_bits(words: np.ndarray, nbits: int) -> np.ndarray:
    """Unpack the last ``nbits`` appended bits from a register snapshot
    ([REG_WORDS] uint32, newest bit = LSB of the last word)."""
    allbits = np.zeros(demod.REG_BITS, dtype=np.uint8)
    for w in range(demod.REG_WORDS):
        v = int(words[w])
        for i in range(32):
            allbits[w * 32 + i] = (v >> (31 - i)) & 1
    return allbits[demod.REG_BITS - nbits:]


def _readback(*tensors: torch.Tensor) -> List[np.ndarray]:
    """The tensors on the host as numpy arrays: a device-to-host copy
    each, with its wait for the work that writes it.  Traced as one
    ``pipeline.readback`` span; the reads and their bytes are counted
    (``pipeline.d2h_reads``, ``pipeline.d2h_bytes``)."""
    with trace.span("pipeline.readback", mark=True):
        out = [t.cpu().numpy() for t in tensors]
    trace.count("pipeline.d2h_reads", len(out))
    trace.count("pipeline.d2h_bytes", sum(a.nbytes for a in out))
    return out


def _unpack(words: np.ndarray, length: np.ndarray, count: np.ndarray
            ) -> List[List[Frame]]:
    """Register snapshots on the host (words [S, F, REG_WORDS] uint32,
    length [S, F], count [S]) CRC-checked into per-stream lists of
    Frame, crc_ok False entries kept: the native drain
    (``native.drain_frames``) when it is available."""
    from .. import native
    n_streams = words.shape[0]
    with trace.span("pipeline.unpack", mark=True):
        out: List[List[Frame]] = [[] for _ in range(n_streams)]
        if native.available():
            for s_idx, payload, flen, ok in native.drain_frames(
                    words, length, count):
                out[s_idx].append(Frame(payload, flen, ok))
            return out
        for s in range(n_streams):
            for k in range(int(count[s])):
                flen = int(length[s, k])
                # the register holds payload bits + 16 FCS + 6 flag bits
                raw = _reg_to_bits(words[s, k], flen + C.FRAME_TAIL_BITS)
                ok, payload = crc_check_and_extract(raw, flen)
                out[s].append(Frame(payload, flen, ok))
        return out


def extract_frames(frames: demod.FrameBatch) -> List[List[Frame]]:
    """Host drain: CRC-check each snapshot; returns per-stream lists of
    Frame (crc_ok False entries kept for the wrong-CRC counter)."""
    words, length, count = _readback(frames.words, frames.length,
                                     frames.count)
    return _unpack(words.view(np.uint32), length, count)


def _pack_dense(dense: demod.DenseFrames, bucket: int) -> torch.Tensor:
    """One flat int32 tensor of the first ``bucket`` dense rows' words,
    length, start, end and stream, so that the host drain costs one
    device-to-host copy instead of five."""
    return torch.cat([dense.words[:bucket].reshape(-1),
                      dense.length[:bucket], dense.start[:bucket],
                      dense.end[:bucket], dense.stream[:bucket]])


def extract_dense(dense: demod.DenseFrames, n_streams: int,
                  total: Optional[int] = None
                  ) -> List[List[Tuple[int, int, Frame]]]:
    """Host drain of a ``demod.DenseFrames``: per-stream lists of
    (start, end, Frame) in arrival order.

    ``total`` is read first unless the caller has it (it usually read
    ``over`` beside it); then one packed copy of the occupied rows,
    rounded up to a power of two (``_pack_dense``).  The native drain
    (the port's copy) sees each dense row as a one-slot pseudo-stream."""
    if total is None:
        total = int(_readback(dense.total)[0])
    out: List[List[Tuple[int, int, Frame]]] = [[] for _ in range(n_streams)]
    if total == 0:
        return out
    cap = dense.length.shape[0]
    bucket = 1
    while bucket < total:
        bucket *= 2
    bucket = min(bucket, cap)
    nw = dense.words.shape[1]
    flat = _readback(_pack_dense(dense, bucket))[0]
    words = flat[:bucket * nw].reshape(bucket, nw).view(np.uint32)
    length, start, end, stream = flat[bucket * nw:].reshape(4, bucket)
    # each dense row a one-slot pseudo-stream
    rows = _unpack(words[:total, None, :], length[:total, None],
                   np.ones(total, dtype=np.int32))
    for j, (frame,) in enumerate(rows):
        out[int(stream[j])].append((int(start[j]), int(end[j]), frame))
    return out


@dataclass
class StreamCounters:
    receivedframes: int = 0
    lostframes: int = 0
    lostframes2: int = 0


def _upload(samples: np.ndarray, device: torch.device) -> torch.Tensor:
    with trace.span("pipeline.upload", mark=True):
        if not (samples.flags.writeable and samples.flags.c_contiguous
                and samples.dtype == np.int16):
            samples = np.array(samples, dtype=np.int16, order="C")
        trace.count("pipeline.h2d_bytes", samples.nbytes)
        return torch.from_numpy(samples).to(device)


class BatchPipeline:
    """Streaming decoder for S independent streams with carried state.

    The flags select ``decode_block``'s branch; the kernel paths
    (fast_dpll, fused_frontend, fused_pipeline) take blocks of a multiple
    of 512 samples, as in the JAX package.  ``kernel_flags`` pass
    straight to ``decode_block``: ``kernel_compact`` (kernel B1 instead
    of B2), ``with_peak`` and ``assume_full``; the JAX package's TPU
    tiling knobs are not ported, so ``decode_block`` refuses them."""

    def __init__(self, n_streams: int, block_len: int = 49_152,
                 frame_slots: int = 32, fast_dpll: bool = False,
                 fused_frontend: bool = False, fused_pipeline: bool = False,
                 device_crc: bool = False, exact_fir: bool = True,
                 mxu_fir: bool = False, lobe_fir: bool = False,
                 device: torch.device | str = "cuda", **kernel_flags):
        if (fast_dpll or fused_frontend or fused_pipeline) and block_len % 512:
            raise ValueError("kernel path: block_len % 512 == 0")
        if device_crc and not fused_pipeline:
            raise ValueError("device_crc requires fused_pipeline")
        if lobe_fir and not fused_pipeline:
            raise ValueError("lobe_fir requires fused_pipeline")
        if mxu_fir and not fused_pipeline:
            raise ValueError("mxu_fir requires fused_pipeline")
        self.device = resolve_device(device)
        self.n_streams = n_streams
        self.block_len = block_len
        self.frame_slots = frame_slots
        self.flags = dict(fast_dpll=fast_dpll, fused_frontend=fused_frontend,
                          fused_pipeline=fused_pipeline, device_crc=device_crc,
                          exact_fir=exact_fir, lobe_fir=lobe_fir,
                          mxu_fir=mxu_fir, **kernel_flags)
        self.carry = init_carry(n_streams, self.device)
        self.counters = [StreamCounters() for _ in range(n_streams)]

    def step(self, samples: torch.Tensor, n_valid: int
             ) -> Tuple[demod.FrameBatch, torch.Tensor]:
        """Decode one padded device block [S, block_len], advancing the
        carry.  Returns (frames, peak) on the device."""
        self.carry, frames, peak = decode_block(
            samples, n_valid, self.carry, frame_slots=self.frame_slots,
            **self.flags)
        return frames, peak

    def step_superblock(self, samples: torch.Tensor, n_valid: int,
                        n_blocks: int) -> Tuple[demod.FrameBatch, torch.Tensor]:
        """Decode a padded device superblock [S, n_blocks * block_len]
        (``decode_superblock``), advancing the carry.  Returns (frames
        stacked on a leading [n_blocks] axis, peak) on the device."""
        self.carry, frames, peak = decode_superblock(
            samples, n_valid, self.carry, n_blocks,
            frame_slots=self.frame_slots, **self.flags)
        return frames, peak

    def process(self, samples: np.ndarray) -> List[List[Frame]]:
        """samples: int16 [S, n] with n <= block_len (padded here).
        Returns per-stream CRC-passing frames in arrival order."""
        s, n = samples.shape
        if s != self.n_streams or n > self.block_len:
            raise ValueError(f"block {samples.shape} does not fit "
                             f"[{self.n_streams}, <= {self.block_len}]")
        if n < self.block_len:
            samples = np.pad(samples, ((0, 0), (0, self.block_len - n)))
        frames, _peak = self.step(_upload(samples, self.device), n)
        return self.drain(frames)

    def process_superblock(self, samples: np.ndarray) -> List[List[Frame]]:
        """samples: int16 [S, n], any n (padded to a multiple of
        block_len).  Decodes the ceil(n / block_len) blocks with one
        ``step_superblock`` and drains them in block order.  Returns
        per-stream CRC-passing frames in arrival order."""
        s, n = samples.shape
        if s != self.n_streams:
            raise ValueError(f"{s} streams, expected {self.n_streams}")
        k = max(1, -(-n // self.block_len))
        if n < k * self.block_len:
            samples = np.pad(samples, ((0, 0), (0, k * self.block_len - n)))
        frames, _peak = self.step_superblock(_upload(samples, self.device),
                                             n, k)
        return self.drain(frames, k)

    def drain(self, frames: demod.FrameBatch, n_blocks: int = 0
              ) -> List[List[Frame]]:
        """Host drain and accounting of one step's frames: one block
        (``n_blocks`` 0) or ``n_blocks`` stacked on a leading axis, read
        back in one transfer per leaf and drained in block order.
        Returns per-stream CRC-passing frames in arrival order; raises on
        frame slot overflow."""
        words, length, count, lost2, dropped, crcfail = _readback(
            frames.words, frames.length, frames.count, frames.lost2,
            frames.dropped, frames.crcfail)
        words = words.view(np.uint32)
        if not n_blocks:
            return self._account(_unpack(words, length, count), lost2,
                                 dropped, crcfail)
        merged: List[List[Frame]] = [[] for _ in range(self.n_streams)]
        for b in range(n_blocks):
            for i, lst in enumerate(_unpack(words[b], length[b], count[b])):
                merged[i].extend(lst)
        return self._account(merged, lost2.sum(axis=0), dropped.sum(axis=0),
                             crcfail.sum(axis=0))

    def _account(self, per_stream, lost2, dropped, crcfail
                 ) -> List[List[Frame]]:
        received = 0
        with trace.span("pipeline.account", mark=True):
            result: List[List[Frame]] = []
            for i, lst in enumerate(per_stream):
                ok = [f for f in lst if f.crc_ok]
                ctr = self.counters[i]
                ctr.receivedframes += len(ok)
                received += len(ok)
                # host-CRC mode counts rejects in the drained list;
                # device_crc mode pre-filters and reports them in crcfail
                ctr.lostframes += len(lst) - len(ok) + int(crcfail[i])
                ctr.lostframes2 += int(lost2[i])
                if dropped[i]:
                    raise RuntimeError(
                        f"frame slot overflow on stream {i}: raise "
                        f"frame_slots")
                result.append(ok)
        trace.count("pipeline.frames", received)
        return result


class TorchReceiver:
    """Single-channel adapter with the golden receiver's interface
    (``run_block``, ``counters``), for ``DecodeSession`` and the CLI.

    ``fast_dpll`` selects the DPLL kernel (B4; block_len a multiple of
    512), ``fused_pipeline`` the fused kernel with frame candidates (B2,
    as the JAX package's receiver runs it; block length rounded up to a
    multiple of 512).  With ``checkpoint_path`` the pipeline is a
    ``SupervisedDecoder`` over the same ``BatchPipeline`` factory, on the
    same device: a snapshot every ``checkpoint_every`` blocks, exact
    resume (``resume_offset``) and recovery of a failed block."""

    def __init__(self, name: str = "A", block_len: int = 1020,
                 frame_slots: int = 16, fast_dpll: bool = False,
                 fused_pipeline: bool = False, device_crc: bool = False,
                 level_monitor=None, checkpoint_path=None,
                 checkpoint_every: int = 64,
                 device: torch.device | str = "cuda"):
        self.name = name
        if fused_pipeline and block_len % 512:
            block_len = -(-block_len // 512) * 512

        def make():
            return BatchPipeline(1, block_len=block_len,
                                 frame_slots=frame_slots,
                                 fast_dpll=fast_dpll,
                                 fused_pipeline=fused_pipeline,
                                 device_crc=device_crc, device=device)

        if checkpoint_path is not None:
            from .supervisor import SupervisedDecoder
            self.pipe = SupervisedDecoder(make, checkpoint_path,
                                          checkpoint_every=checkpoint_every)
        else:
            self.pipe = make()
        self.level_monitor = level_monitor

    def resume_offset(self) -> int:
        """Samples already consumed per a restored checkpoint (0 when
        unsupervised or fresh)."""
        return getattr(self.pipe, "resume_offset", lambda: 0)()

    def run_block(self, samples: np.ndarray) -> List[Frame]:
        if self.level_monitor is not None:
            # reference level meter: positive peak of the raw block
            self.level_monitor.observe(max(0, int(samples.max(initial=0))))
        return self.pipe.process(samples[None, :])[0]

    @property
    def counters(self):
        c = self.pipe.counters[0]
        return (c.receivedframes, c.lostframes, c.lostframes2)
