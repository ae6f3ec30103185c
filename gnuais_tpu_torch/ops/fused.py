"""The hand-written CUDA kernels of the decode step (counterpart of
``gnuais_tpu/ops/fused.py``; kernel numbers as in ``ROADMAP.md``):

- ``pipeline_fused_compact`` (B1, ``csrc/pipeline_compact.cu``): raw
  samples to dense frame slots in one kernel.
- ``pipeline_fused`` (B2, ``csrc/pipeline_fused.cu``): the same decode,
  the frames landing in per-chunk candidate slots for
  ``demod.compact_candidates``; also on float32 samples filtered before
  the call (``prefiltered``), and with the JAX kernel's ``strip=`` pieces
  left out (``csrc/pipeline_strip.cu``, an instrument built into a
  library of its own at first use).
- ``frontend_fused`` (B3, ``csrc/frontend.cu``): raw samples to 4-sample
  bit slots (FIR, DPLL, group reduce); the deframer runs after it.
- ``dpll_fused`` (B4, ``csrc/dpll.cu``): the DPLL alone over filtered
  samples.
- ``hdlc_fused`` (``csrc/hdlc.cu``): the deframer over bit slots, given
  as B3's or B4's codes (``frontend_codes``, ``dpll_codes``: uint8,
  time-major, as the kernels write them) or as ``[S, M]`` slots (what
  ``demod.hdlc_scan_candidates`` hands it on a CUDA tensor); its frame
  candidates land as B2's do.

B1 and B2 are one kernel body (``csrc/pipeline_kernel.cuh``): per 32
streams, FIR producer warps filter 32-sample chunks into a ring in
shared memory (``csrc/pipeline_ring.cuh``) and one consumer warp runs
the chain over them.  B3 is the same body with a consumer that runs the
DPLL alone; B4 has a copy warp that feeds the filtered samples through
such a ring to its DPLL warp.  Three FIR modes: ``vpu`` (the exact FIR),
``lobe`` (the main-lobe FIR, ``fir.fir_lobe``) and ``mxu`` (a banded
matrix product per chunk on the tensor cores, ``csrc/fir_mxu.cuh``;
plain version ``fir.fir_mxu``).  The kernel reads its input in the
layout the caller holds, with no copy: time-major ``[T, S]``
(``pretiled_streams``, the layout ``tile_superblock`` makes) or an
``[S, T]`` block (a view with unit stride along time, any row pitch).
``fir_mxu_probe`` (``csrc/fir_probe.cu``) runs the ``mxu`` producers
alone, so that the card can hold their filtered values against
``fir.fir_mxu``.

Each wrapper launches its kernel for a CUDA tensor (``on_card``), adding
one to its ``launches`` counter, and runs its plain PyTorch version
(``*_reference``, composed from ``fir`` and ``demod``) for a CPU tensor.
Kernel and plain version return the same tuple bit for bit, but for the ``mxu`` mode,
whose tensor-core sums run in another order than the plain product: it
is held to packet parity (the same frames and carry on captures), its
filtered values to ``MXU_BOUND``.  B2's strip variants are instruments
with no plain version: they run on the card only, held by their
invariants (``diag_strip.check_strip``).
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from .. import constants as C
from . import demod, fir
from .demod import HDLC_CHUNK, MINI_SLOTS, REG_WORDS, DpllState, HdlcState
from .fir import LOBE_HI, LOBE_LO

_I32 = torch.int32

# the kernels' fir_mode argument (B2's prefiltered mode is 3)
FIR_MODES = {"vpu": 0, "lobe": 1, "mxu": 2}
PREFILTERED = 3
# the JAX kernel's strip= flags, bits of the kernels' kStrip
# (csrc/pipeline_strip.cu says what each leaves out)
STRIP_FLAGS = {"fir": 1, "hdlc": 2, "book": 4, "shift": 8, "snap": 16,
               "flush": 32}

# The mxu FIR's error bound against the exact FIR, per output:
# |mxu - exact| <= MXU_BOUND[0] * sum_i |taps[i] * x[i]| + MXU_BOUND[1].
# The kernel splits each operand into two TF32 parts (3xTF32): every
# int16 sample is exact (|x - big| <= 16 is a TF32 value), each tap is
# kept to ~22 bits and the dropped small*small term is below 2^-22 of
# its product; the tensor cores add up to ~3 x 36 terms in float32.
# The exact FIR rounds 36 products and 35 sums (36 * 2^-24 relative).
# Both together stay below 8 * 2^-20 = 2^-17.  The absolute term covers
# what TF32 cannot hold at all: taps 2 and 33 are subnormal and round to
# 0, as do the small parts of taps 3 and 32; against int16 samples each
# of those products is below 2^-120.
MXU_BOUND = (2.0 ** -17, 2.0 ** -100)

_TAPS_F32 = np.asarray(C.FIR_TAPS, dtype=np.float32)
# outside the main lobe the taps are below 1.3e-13: with int16 inputs
# their whole contribution (< 1e-8) cannot move the slicer's sign for
# any input that excites a main-lobe tap (gnuais_tpu/ops/fused.py:40-52)
assert all(abs(t) < 1.3e-13 for i, t in enumerate(_TAPS_F32)
           if not (LOBE_LO <= i <= LOBE_HI))
# the taps are symmetric, so the lobe FIR pairs the mirrored samples
assert all(_TAPS_F32[i] == _TAPS_F32[C.FIR_LEN - 1 - i]
           for i in range(C.FIR_LEN))


def _fir_fn(fir_mode: str):
    """The plain FIR of a kernel FIR mode; raises for an unknown one."""
    if fir_mode not in FIR_MODES:
        raise ValueError(f"unknown fir_mode {fir_mode!r}")
    return {"vpu": fir.fir_exact, "lobe": fir.fir_lobe,
            "mxu": fir.fir_mxu}[fir_mode]


def strip_mask(strip: str) -> int:
    """The bit mask of a comma list of strip flags ("" is 0, "shift,snap"
    24); raises ValueError on an unknown flag."""
    mask = 0
    for flag in filter(None, (f.strip() for f in strip.split(","))):
        if flag not in STRIP_FLAGS:
            raise ValueError(f"unknown strip flag {flag!r} (known: "
                             f"{', '.join(STRIP_FLAGS)})")
        mask |= STRIP_FLAGS[flag]
    return mask


def n_candidates(t: int) -> int:
    """K, the candidate slots per stream of a T-sample block: MINI_SLOTS
    per 64-slot HDLC chunk of the T/4 bit slots, the last chunk padded."""
    return MINI_SLOTS * -(-(t // 4) // HDLC_CHUNK)


def tile_superblock(samples: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """[S, K*T] -> [K, T, S]: each block time-major in one copy, the
    native input layout of the port's fused kernels
    (``pretiled_streams=S``).  The JAX function makes the TPU kernel's
    [K, nt*T, sublanes, 128] stream tiles instead."""
    s, total = samples.shape
    if n_blocks < 1 or total % n_blocks:
        raise ValueError(f"{total} samples do not split into {n_blocks} blocks")
    return samples.reshape(s, n_blocks, total // n_blocks) \
        .permute(1, 2, 0).contiguous()


def _carry_history(samples: torch.Tensor, history: torch.Tensor,
                   n_valid: int) -> torch.Tensor:
    """Last FIR_LEN valid raw samples as float32 [S, 36], without
    building concat(history, samples): the window full[nv : nv+36] of
    full = [history | samples] lies inside samples when nv >= 36 and
    inside the first 72 columns otherwise.  The tail start is clamped
    for short final blocks (n_valid < 36).  For a time-major input
    (``samples`` the [S, T] view of a [T, S] tensor) the same strided
    read gives the 36 rows before row n_valid, for any n_valid."""
    nv = int(n_valid)
    lo = max(nv - C.FIR_LEN, 0)
    tail = samples[:, lo:lo + C.FIR_LEN].to(torch.float32)
    small = torch.cat([history, tail], dim=1)                 # [S, 72]
    k = min(nv, C.FIR_LEN)
    return small[:, k:k + C.FIR_LEN].contiguous()


def _rows(samples: torch.Tensor, n_valid: int, fir_mode: str,
          assume_full: bool, pretiled_streams: Optional[int]) -> torch.Tensor:
    """Check a fused kernel's input and return its [S, T] view: the
    input itself, or the transpose of a time-major [T, S] one."""
    _fir_fn(fir_mode)
    if pretiled_streams is None:
        rows = samples
    else:
        if samples.dim() != 2 or samples.shape[1] != pretiled_streams:
            raise ValueError(f"pretiled input {tuple(samples.shape)} is not "
                             f"[T, {pretiled_streams}]")
        rows = samples.t()
    t = rows.shape[1]
    if t % 4:
        raise ValueError(f"T must be a multiple of 4, got {t}")
    if assume_full and int(n_valid) != t:
        raise ValueError(f"assume_full with n_valid {n_valid} != T {t}")
    return rows


def pipeline_fused_reference(
        samples: torch.Tensor, n_valid: int, history: torch.Tensor,
        dpll: DpllState, hdlc: HdlcState, block_base: int = 0,
        fir_mode: str = "vpu", lost2_lo: Optional[int] = None,
        lost2_hi: Optional[int] = None, assume_full: bool = False,
        pretiled_streams: Optional[int] = None, prefiltered: bool = False):
    """The plain PyTorch version of ``pipeline_fused``: the chain of
    ``fir_mode`` (``fir_exact``, ``fir_lobe`` or ``fir_mxu``; none when
    ``prefiltered``, ``history`` then returned as it is), ``dpll_scan``,
    ``group_reduce_bits`` and ``demod.hdlc_scan_candidates_reference``.
    Same arguments and returns as ``pipeline_fused`` less ``strip``."""
    _check_input(samples, prefiltered)
    rows = _rows(samples, n_valid, fir_mode, assume_full, pretiled_streams)
    gbits, gvalid, gpos, new_history, new_dpll = bit_slots(
        rows, n_valid, history, dpll, block_base, fir_mode=fir_mode,
        prefiltered=prefiltered)
    new_hdlc, cand = demod.hdlc_scan_candidates_reference(
        gbits, gvalid, hdlc, gpos, lost2_lo=lost2_lo, lost2_hi=lost2_hi)
    return (*cand, new_history, new_dpll, new_hdlc)


def compact_slots(candidates, frame_slots: int):
    """``pipeline_fused``'s returns turned into ``pipeline_fused_compact``'s:
    the candidates compacted into ``frame_slots`` dense slots by
    ``demod.compact_candidates``, count_raw their number per stream, the
    counters and carry as they are."""
    valid, cw, cl, cs, ce, lost2, over, *carry = candidates
    dense = demod.compact_candidates(
        demod.init_frames(valid.shape[0], frame_slots, valid.device),
        valid, cw, cl, cs, ce, lost2=lost2, over=over)
    count_raw = valid.sum(dim=1).to(_I32)
    return (count_raw, dense.words, dense.length, dense.start, dense.end,
            lost2, over, *carry)


def pipeline_fused_compact_reference(
        samples: torch.Tensor, n_valid: int, history: torch.Tensor,
        dpll: DpllState, hdlc: HdlcState, frame_slots: int = 32,
        block_base: int = 0, fir_mode: str = "vpu",
        lost2_lo: Optional[int] = None, lost2_hi: Optional[int] = None,
        assume_full: bool = False, pretiled_streams: Optional[int] = None):
    """The plain PyTorch version of ``pipeline_fused_compact``:
    ``pipeline_fused_reference``, then ``compact_slots``.  Same arguments
    and returns as ``pipeline_fused_compact``."""
    return compact_slots(pipeline_fused_reference(
        samples, n_valid, history, dpll, hdlc, block_base, fir_mode,
        lost2_lo, lost2_hi, assume_full, pretiled_streams), frame_slots)


def _check_state(x: torch.Tensor, dtype: torch.dtype, **leaves) -> None:
    """Raise unless ``x`` has ``dtype`` and every state leaf lies on its
    device with the shape the kernel indexes it by (``[S]``, or
    ``[S, 36]`` for the history and ``[S, 15]`` for the register):
    checked before any pointer is passed."""
    if x.dtype != dtype:
        raise TypeError(f"input must be {dtype}, got {x.dtype}")
    s = x.shape[0]
    shapes = {"history": (s, C.FIR_LEN), "shiftreg": (s, REG_WORDS)}
    for name, v in leaves.items():
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, input on {x.device}")
        if tuple(v.shape) != shapes.get(name, (s,)):
            raise ValueError(f"{name} has shape {tuple(v.shape)}, expected "
                             f"{shapes.get(name, (s,))}")


def on_card(x: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel for ``x`` (else it runs the
    plain version): ``x`` lies on a CUDA device.  The host-build tests
    turn it true for CPU tensors, to run the kernels' host build on the
    same routes."""
    return x.device.type == "cuda"


def _wrap32(v: int) -> int:
    return (int(v) + 2**31) % 2**32 - 2**31


def _launch(entry: str, *args, strip: int = 0) -> None:
    """Call the library's C entry point ``entry`` with ``args`` and the
    current stream of the device of the first tensor argument (the
    library of the strip set ``strip`` when it is not 0); raise on a
    refused launch."""
    from . import _build
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    lib = _build.strip_library(strip) if strip else _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args), stream)
    if err:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")


def _kernel_input(rows: torch.Tensor, pretiled: bool):
    """The fused kernels' input as the caller holds it: (tensor, row_major,
    pitch).  Pretiled, the [T, S] tensor behind ``rows`` (unit stride
    along the streams); else ``rows`` itself when its time axis has unit
    stride (a copy otherwise).  pitch: the stride of the outer axis."""
    x = rows.t() if pretiled else rows
    if x.stride(1) != 1 and x.shape[1] > 1:   # a size-1 axis has any stride
        if pretiled:
            raise ValueError("pretiled input must be a [T, S] tensor with "
                             "unit stride along the streams")
        x = x.contiguous()
    return x, int(not pretiled), x.stride(0)


def _launch_pipeline(wrapper, rows, pretiled, n_valid, history, dpll, hdlc,
                     slots, block_base, fir_mode, lost2_lo, lost2_hi,
                     prefiltered=False, strip=0):
    """Launch B1 (``wrapper`` is ``pipeline_fused_compact``: dense slots)
    or B2 (``pipeline_fused``: candidate slots; ``prefiltered`` float32
    input and the strip mask ``strip`` are B2's only) on
    ``rows`` ([S, T]; time-major in memory when ``pretiled``, read so by
    the kernel), with ``slots`` frame slots per stream, and add one to
    ``wrapper.launches`` (and for B2's other modes to
    ``pipeline_fused.mode_launches``).  Returns (count_raw [S] or
    cand_valid [S, slots], words, length, start, end, lost2, over,
    new_history, new_dpll, new_hdlc)."""
    candidates = wrapper is pipeline_fused
    s, t = rows.shape
    dev = rows.device
    _check_state(rows, torch.float32 if prefiltered else torch.int16,
                 history=history, **dict(zip(dpll._fields, dpll)),
                 **hdlc._asdict())
    x, row_major, pitch = _kernel_input(rows, pretiled)
    hist = history.to(torch.float32).contiguous()
    dpll_in = torch.stack(list(dpll)).to(_I32).contiguous()           # [3, S]
    hdlc_in = torch.stack(list(hdlc[:8])).to(_I32).contiguous()       # [8, S]
    reg_in = hdlc.shiftreg.to(_I32).contiguous()                      # [S, 15]
    if candidates:
        first = torch.zeros((s, slots), dtype=torch.bool, device=dev)
    else:
        first = torch.empty((s,), dtype=_I32, device=dev)
    words = torch.zeros((s, slots, REG_WORDS), dtype=_I32, device=dev)
    fields = torch.zeros((3, s, slots), dtype=_I32, device=dev)
    lost2 = torch.empty((s,), dtype=_I32, device=dev)
    over = torch.empty((s,), dtype=_I32, device=dev)
    dpll_out = torch.empty((3, s), dtype=_I32, device=dev)
    hdlc_out = torch.empty((8, s), dtype=_I32, device=dev)
    reg_out = torch.empty((s, REG_WORDS), dtype=_I32, device=dev)
    lo = -2**31 if lost2_lo is None else int(lost2_lo)
    hi = 2**31 - 1 if lost2_hi is None else int(lost2_hi)
    base = _wrap32(block_base)
    nv = max(0, min(int(n_valid), t))
    mode = PREFILTERED if prefiltered else FIR_MODES[fir_mode]
    if s:
        args = (x, hist, dpll_in, hdlc_in, reg_in, first, words, fields,
                lost2, over, dpll_out, hdlc_out, reg_out, s, t, nv, base, lo,
                hi, slots, mode)
        entry = ("gnuais_pipeline_strip" if strip
                 else "gnuais_pipeline_fused" if candidates
                 else "gnuais_pipeline_compact")
        _launch(entry, *args, row_major, pitch, strip=strip)
        wrapper.launches += 1
        if strip or prefiltered:
            pipeline_fused.mode_launches[
                "strip" if strip else "prefiltered"] += 1
    new_dpll = DpllState(*dpll_out.unbind(0))
    new_hdlc = HdlcState(*hdlc_out.unbind(0), shiftreg=reg_out)
    new_history = history if prefiltered else _carry_history(rows, hist, nv)
    return (first, words, fields[0], fields[1], fields[2], lost2, over,
            new_history, new_dpll, new_hdlc)


def pipeline_shape(fir_mode: str, prefiltered: bool = False) -> dict:
    """The launch shape of B1 and B2 in ``fir_mode`` (or of B2's
    prefiltered mode, whatever ``fir_mode``), as the kernel source sets
    it: producer warps, ring stages, warps a block and dynamic shared
    memory a block in bytes (the kernel library, built on first use)."""
    import ctypes
    from . import _build
    _fir_fn(fir_mode)
    out = (ctypes.c_int * 4)()
    mode = PREFILTERED if prefiltered else FIR_MODES[fir_mode]
    if _build.library().gnuais_pipeline_shape(mode, out):
        raise ValueError(f"unknown fir_mode {fir_mode!r}")
    return dict(zip(("producers", "stages", "warps", "shared_bytes"), out))


def pipeline_fused_compact(samples: torch.Tensor, n_valid: int,
                           history: torch.Tensor, dpll: DpllState,
                           hdlc: HdlcState, frame_slots: int = 32,
                           block_base: int = 0, fir_mode: str = "vpu",
                           lost2_lo: Optional[int] = None,
                           lost2_hi: Optional[int] = None,
                           assume_full: bool = False,
                           pretiled_streams: Optional[int] = None):
    """Fused decode of one block with dense frame slots (kernel B1).

    samples: int16 [S, T] (T % 4 == 0), or with ``pretiled_streams=S``
    the same block time-major, [T, S] (``tile_superblock``); n_valid:
    real samples (the rest is padding and freezes the state); history:
    float32 [S, 36]; block_base: absolute index of sample 0; lost2 counts
    wrong-size stops in [lost2_lo, lost2_hi); fir_mode: "vpu" (exact),
    "lobe" or "mxu"; assume_full: the caller promises n_valid == T
    (checked, and nothing else: unlike the TPU kernel's, these have no
    variant with the per-sample gates compiled out).
    Returns (count_raw [S], words [S, F, 15] int32 bit patterns,
    length/start/end [S, F], lost2 [S], over [S], new_history, new_dpll,
    new_hdlc): frames in arrival order with zeroed empty slots, count_raw
    not clipped to F = frame_slots.

    A CUDA tensor launches the hand-written kernel and adds one to
    ``pipeline_fused_compact.launches``; a CPU tensor runs the plain
    version.  The JAX function's TPU tiling knobs have no counterpart
    here (the ``mxu`` chunk is fixed at ``fir.MXU_UNROLL``)."""
    rows = _rows(samples, n_valid, fir_mode, assume_full, pretiled_streams)
    if rows.device.type == "cuda":
        return _launch_pipeline(
            pipeline_fused_compact, rows, pretiled_streams is not None,
            n_valid, history, dpll, hdlc, int(frame_slots), block_base,
            fir_mode, lost2_lo, lost2_hi)
    if rows.device.type == "cpu":
        return pipeline_fused_compact_reference(
            samples, n_valid, history, dpll, hdlc, frame_slots, block_base,
            fir_mode, lost2_lo, lost2_hi, assume_full, pretiled_streams)
    raise ValueError(f"unsupported device {rows.device}")


pipeline_fused_compact.launches = 0


def _check_input(samples: torch.Tensor, prefiltered: bool) -> None:
    """Raise unless B2's input type fits ``prefiltered`` (float32 samples
    filtered before the call, else raw int16)."""
    if prefiltered and samples.dtype != torch.float32:
        raise TypeError(f"prefiltered input must be float32, got "
                        f"{samples.dtype}")
    if not prefiltered and samples.dtype != torch.int16:
        raise TypeError(f"raw input must be int16, got {samples.dtype} "
                        f"(float32 samples need prefiltered=True)")


def pipeline_fused(samples: torch.Tensor, n_valid: int,
                   history: torch.Tensor, dpll: DpllState, hdlc: HdlcState,
                   block_base: int = 0, fir_mode: str = "vpu",
                   lost2_lo: Optional[int] = None,
                   lost2_hi: Optional[int] = None, assume_full: bool = False,
                   pretiled_streams: Optional[int] = None,
                   prefiltered: bool = False, strip: str = ""):
    """Fused decode of one block into frame candidates (kernel B2).

    Arguments as ``pipeline_fused_compact`` less ``frame_slots``, and
    two modes of the JAX function:
    - ``prefiltered``: ``samples`` is float32, filtered before the call
      (``fir.fir_conv``, ``fir.fir_exact``); the kernel runs no FIR,
      ``fir_mode`` is not used and ``history`` (the caller's raw-sample
      carry) comes back as it went in;
    - ``strip``: a comma list of ``STRIP_FLAGS`` (the JAX kernel's perf
      bisection, ``diag_strip``): the kernel with those pieces left out,
      built into a library of its own at first use.  Its outputs are not
      the decode's by design; it runs on the card only (no plain
      version) and raises for a CPU tensor.
    Returns (cand_valid bool [S, K], cw [S, K, 15] int32 bit patterns,
    cl/cs/ce [S, K] (length, start, end), lost2 [S], over [S],
    new_history, new_dpll, new_hdlc), K = ``n_candidates(T)``: frame
    completion n (n < 2) of 64-slot chunk c lands in slot 2c + n, a later
    one in the same chunk counts in ``over``; the empty slots are zero.
    ``compact_slots`` turns the returns into those of
    ``pipeline_fused_compact``.

    A CUDA tensor launches the hand-written kernel and adds one to
    ``pipeline_fused.launches`` (``prefiltered`` or ``strip`` also to
    ``pipeline_fused.mode_launches["prefiltered"]`` or ``["strip"]``); a
    CPU tensor runs the plain version.  The kernel lands each frame once
    after its 32-sample chunk, the JAX function's default
    ``landing="body"``; JAX's "slot" landing gives the same results, and
    the port has no ``landing`` argument."""
    _check_input(samples, prefiltered)
    mask = strip_mask(strip)
    rows = _rows(samples, n_valid, fir_mode, assume_full, pretiled_streams)
    if mask and rows.device.type != "cuda":
        raise ValueError(f"strip={strip!r} runs on the card only; a "
                         f"stripped kernel has no plain version")
    if rows.device.type == "cuda":
        return _launch_pipeline(
            pipeline_fused, rows, pretiled_streams is not None, n_valid,
            history, dpll, hdlc, n_candidates(rows.shape[1]), block_base,
            fir_mode, lost2_lo, lost2_hi, prefiltered, mask)
    if rows.device.type == "cpu":
        return pipeline_fused_reference(
            samples, n_valid, history, dpll, hdlc, block_base, fir_mode,
            lost2_lo, lost2_hi, assume_full, pretiled_streams, prefiltered)
    raise ValueError(f"unsupported device {rows.device}")


pipeline_fused.launches = 0
pipeline_fused.mode_launches = collections.Counter()


def fir_mxu_probe(samples: torch.Tensor,
                  history: torch.Tensor) -> torch.Tensor:
    """The ``mxu`` FIR of kernels B1 and B2 alone, on the card
    (``csrc/fir_probe.cu``): the same producer warps (copies, staging,
    tensor-core product) and ring, its filtered values written out
    instead of fed to the DPLL.  A test instrument, on no decode path.

    samples: int16 [S, T] on a CUDA device; history: float32 [S, 36].
    Returns the filtered float32 [S, T] (plain version: ``fir.fir_mxu``;
    tolerance ``MXU_BOUND`` against ``fir.fir_exact``) and adds one to
    ``fir_mxu_probe.launches``.  Raises for a tensor that is not on a
    CUDA device."""
    if samples.device.type != "cuda":
        raise ValueError("fir_mxu_probe runs on a CUDA device; its plain "
                         "version is fir.fir_mxu")
    return _launch_probe(samples, history)


def _launch_probe(samples, history):
    _check_state(samples, torch.int16, history=history)
    s, t = samples.shape
    x, _, pitch = _kernel_input(samples, False)
    hist = history.to(torch.float32).contiguous()
    out = torch.empty((s, t), dtype=torch.float32, device=samples.device)
    if s and t:
        _launch("gnuais_fir_probe", x, hist, out, s, t, pitch)
        fir_mxu_probe.launches += 1
    return out


fir_mxu_probe.launches = 0


# ---------------------------------------------------------------------------
# B4: the DPLL over filtered samples
# ---------------------------------------------------------------------------

def dpll_fused_reference(filtered: torch.Tensor, n_valid: int,
                         state: DpllState):
    """The plain PyTorch version of ``dpll_fused``: ``demod.dpll_scan``
    with the bits zeroed off emissions, as the kernel writes them."""
    bit_valid, bits, new_state = demod.dpll_scan(filtered, n_valid, state)
    return bit_valid, bits * bit_valid, new_state


def dpll_codes(filtered: torch.Tensor, n_valid: int, state: DpllState):
    """Kernel B4 on a block of filtered samples (float32 [S, T], read in
    place): (codes [T, S] uint8, 2 + bit on a DPLL emission and 0
    elsewhere, time-major as ``hdlc_fused`` reads them, new state).  Adds
    one to ``dpll_fused.launches``; for tensors on the card only."""
    s, t = filtered.shape
    dev = filtered.device
    _check_state(filtered, torch.float32, **state._asdict())
    x, _, pitch = _kernel_input(filtered, False)
    dpll_in = torch.stack(list(state)).to(_I32).contiguous()          # [3, S]
    codes = torch.empty((t, s), dtype=torch.uint8, device=dev)
    dpll_out = torch.empty((3, s), dtype=_I32, device=dev)
    if s:
        _launch("gnuais_dpll", x, dpll_in, codes, dpll_out, s, t,
                max(0, min(int(n_valid), t)), pitch)
        dpll_fused.launches += 1
    return codes, DpllState(*dpll_out.unbind(0))


def dpll_fused(filtered: torch.Tensor, n_valid: int, state: DpllState):
    """Clock recovery over one block: the slicer, DPLL and NRZI of
    ``demod.dpll_scan``.

    filtered: float32 [S, T]; samples at index >= n_valid freeze the
    state and emit nothing.  Returns (bit_valid bool [S, T], bits int32
    [S, T], new state), bits 0 where bit_valid is false.

    A CUDA tensor launches the hand-written kernel (``csrc/dpll.cu``,
    ``dpll_codes``) and adds one to ``dpll_fused.launches``: both returns
    are read from its time-major codes through their transposed view; a
    CPU tensor runs the plain version."""
    if on_card(filtered):
        codes, new_state = dpll_codes(filtered, n_valid, state)
        ct = codes.t()
        return ct >= 2, (ct & 1).to(_I32), new_state
    if filtered.device.type == "cpu":
        return dpll_fused_reference(filtered, n_valid, state)
    raise ValueError(f"unsupported device {filtered.device}")


dpll_fused.launches = 0


# ---------------------------------------------------------------------------
# B3: FIR, DPLL and 4-sample bit slots
# ---------------------------------------------------------------------------

def bit_slots(samples: torch.Tensor, n_valid: int, history: torch.Tensor,
              state: DpllState, block_base: int = 0,
              fast_dpll: bool = False, fir_mode: str = "vpu",
              exact_fir: bool = True, prefiltered: bool = False):
    """The unfused front end: the FIR (``fir.fir_exact``, ``fir.fir_lobe``
    or ``fir.fir_mxu`` for ``fir_mode`` "lobe" or "mxu", ``fir.fir_conv``
    when ``exact_fir`` is False; none when ``prefiltered``: ``samples``
    are filtered and ``history`` comes back as it is), then
    ``dpll_fused`` (``fast_dpll``) or ``demod.dpll_scan``, then
    ``demod.group_reduce_bits`` (the bit axis padded to a multiple of 4).
    Same returns as ``frontend_fused``."""
    fir_fn = _fir_fn(fir_mode) if exact_fir else fir.fir_conv
    if prefiltered:
        filtered, new_history = samples, history
    else:
        filtered, new_history = fir_fn(samples, history, n_valid=n_valid)
    dpll_fn = dpll_fused if fast_dpll else demod.dpll_scan
    bit_valid, bits, new_state = dpll_fn(filtered, n_valid, state)
    t = samples.shape[1]
    if t % 4:
        pad = 4 - t % 4
        bit_valid = torch.nn.functional.pad(bit_valid, (0, pad))
        bits = torch.nn.functional.pad(bits, (0, pad))
    gbits, gvalid, gpos = demod.group_reduce_bits(bit_valid, bits, block_base)
    return gbits, gvalid, gpos, new_history, new_state


def frontend_fused_reference(samples: torch.Tensor, n_valid: int,
                             history: torch.Tensor, state: DpllState,
                             block_base: int = 0):
    """The plain PyTorch version of ``frontend_fused``: the exact chain
    ``fir_exact`` -> ``dpll_scan`` -> ``group_reduce_bits``."""
    return bit_slots(samples, n_valid, history, state, block_base)


def frontend_codes(samples: torch.Tensor, n_valid: int,
                   history: torch.Tensor, state: DpllState):
    """Kernel B3 on a raw block (int16 [S, T], T % 4 == 0, read in
    place): (codes [T/4, S] uint8, ``valid<<3 | bit<<2 | offset`` a
    4-sample group, time-major as ``hdlc_fused`` reads them, new history,
    new state).  Adds one to ``frontend_fused.launches``; for tensors on
    the card only."""
    s, t = samples.shape
    if t % 4:
        raise ValueError(f"T must be a multiple of 4, got {t}")
    dev = samples.device
    _check_state(samples, torch.int16, history=history, **state._asdict())
    x, _, pitch = _kernel_input(samples, False)
    hist = history.to(torch.float32).contiguous()
    dpll_in = torch.stack(list(state)).to(_I32).contiguous()          # [3, S]
    codes = torch.empty((t // 4, s), dtype=torch.uint8, device=dev)
    dpll_out = torch.empty((3, s), dtype=_I32, device=dev)
    nv = max(0, min(int(n_valid), t))
    if s:
        _launch("gnuais_frontend", x, hist, dpll_in, codes, dpll_out, s, t,
                nv, pitch)
        frontend_fused.launches += 1
    return (codes, _carry_history(samples, hist, nv),
            DpllState(*dpll_out.unbind(0)))


def _group_slots(codes: torch.Tensor, block_base: int):
    """B3's codes [M, S] as (gbits int32, gvalid bool, gpos int32) [S, M],
    elementwise on their transposed view; gbits and gpos 0 where gvalid
    is false, gpos wrapping like int32."""
    ct = codes.t()
    gvalid = ct >= 8
    gbits = ((ct >> 2) & 1).to(_I32)
    pos = (int(block_base) + 4 * torch.arange(ct.shape[1], device=ct.device)
           )[None, :] + (ct & 3)
    # the int64 positions wrap into int32 as the kernels' do
    pos = (pos + 2**31) % 2**32 - 2**31
    return gbits, gvalid, torch.where(gvalid, pos.to(_I32), 0)


def frontend_fused(samples: torch.Tensor, n_valid: int,
                   history: torch.Tensor, state: DpllState,
                   block_base: int = 0):
    """Fused FIR + DPLL + 4-sample group reduce of one block.

    samples: int16 [S, T] raw (T % 4 == 0); n_valid: real samples (the
    rest freezes the DPLL and emits nothing); history: float32 [S, 36];
    block_base: absolute index of sample 0.  Returns (gbits int32
    [S, T/4], gvalid bool [S, T/4], gpos int32 [S, T/4] absolute sample
    indices wrapping like int32, new_history, new DPLL state); gbits and
    gpos are 0 where gvalid is false.

    A CUDA tensor launches the hand-written kernel (``csrc/frontend.cu``,
    ``frontend_codes``) and adds one to ``frontend_fused.launches``; a
    CPU tensor runs the plain version."""
    if samples.shape[1] % 4:
        raise ValueError(f"T must be a multiple of 4, got {samples.shape[1]}")
    if on_card(samples):
        codes, new_history, new_state = frontend_codes(samples, n_valid,
                                                       history, state)
        return (*_group_slots(codes, block_base), new_history, new_state)
    if samples.device.type == "cpu":
        return frontend_fused_reference(samples, n_valid, history, state,
                                        block_base)
    raise ValueError(f"unsupported device {samples.device}")


frontend_fused.launches = 0


# ---------------------------------------------------------------------------
# The deframer over bit slots
# ---------------------------------------------------------------------------

# hdlc_fused's input forms, the kernel's form argument
HDLC_FORMS = {"group": 0, "sample": 1, "slots": 2}


def _hdlc_slots_of(form, codes, bitrows, slot_valid, pos_rows, block_base):
    """The [S, M] (bits, valid, positions) that ``hdlc_fused``'s input
    stands for: B3's group codes decoded, B4's sample codes reduced per
    4-sample group (``demod.group_reduce_bits``, T padded to a multiple
    of 4), or the slots as given."""
    if form == "group":
        return _group_slots(codes, block_base)
    if form == "sample":
        ct = codes.t()
        bit_valid, bits = ct >= 2, (ct & 1).to(_I32)
        if ct.shape[1] % 4:
            pad = 4 - ct.shape[1] % 4
            bit_valid = torch.nn.functional.pad(bit_valid, (0, pad))
            bits = torch.nn.functional.pad(bits, (0, pad))
        return demod.group_reduce_bits(bit_valid, bits, block_base)
    if pos_rows is None:
        pos_rows = torch.zeros_like(bitrows)
    return bitrows, slot_valid, pos_rows


def hdlc_fused_reference(state: HdlcState, codes=None, form: str = "slots",
                         bitrows=None, slot_valid=None, pos_rows=None,
                         block_base: int = 0, lost2_lo=None, lost2_hi=None):
    """The plain PyTorch version of ``hdlc_fused``: its input as [S, M]
    slots, then ``demod.hdlc_scan_candidates_reference``."""
    bits, valid, pos = _hdlc_slots_of(form, codes, bitrows, slot_valid,
                                      pos_rows, block_base)
    return demod.hdlc_scan_candidates_reference(bits, valid, state, pos,
                                                lost2_lo, lost2_hi)


def _launch_hdlc(state, form, codes, bitrows, slot_valid, pos_rows,
                 block_base, lost2_lo, lost2_hi):
    if form in ("group", "sample"):
        if codes.dtype != torch.uint8 or codes.dim() != 2:
            raise TypeError("codes must be a uint8 [rows, S] tensor")
        rows, s = codes.shape
        x, _, pitch = _kernel_input(codes, False)
        m = rows if form == "group" else -(-rows // 4)
        bits = valid = pos = x          # not read in these forms
    else:
        s, m = bitrows.shape
        rows = m
        bits = bitrows.to(_I32).contiguous()
        valid = slot_valid.to(torch.bool).contiguous()
        pos = (torch.zeros_like(bits) if pos_rows is None
               else pos_rows.to(_I32).contiguous())
        x = bits
        if valid.shape != bits.shape or pos.shape != bits.shape:
            raise ValueError("bitrows, slot_valid and pos_rows differ in shape")
        pitch = m
    dev = x.device
    # state leaves [S] ([S, 15] the register) on the input's device
    _check_state(bits if form == "slots" else x.t(), x.dtype,
                 **state._asdict())
    kk = MINI_SLOTS * -(-m // HDLC_CHUNK)
    hdlc_in = torch.stack(list(state[:8])).to(_I32).contiguous()       # [8, S]
    reg_in = state.shiftreg.to(_I32).contiguous()                     # [S, 15]
    cv = torch.zeros((s, kk), dtype=torch.bool, device=dev)
    cw = torch.zeros((s, kk, REG_WORDS), dtype=_I32, device=dev)
    fields = torch.zeros((3, s, kk), dtype=_I32, device=dev)
    lost2 = torch.empty((s,), dtype=_I32, device=dev)
    over = torch.empty((s,), dtype=_I32, device=dev)
    hdlc_out = torch.empty((8, s), dtype=_I32, device=dev)
    reg_out = torch.empty((s, REG_WORDS), dtype=_I32, device=dev)
    lo = -2**31 if lost2_lo is None else int(lost2_lo)
    hi = 2**31 - 1 if lost2_hi is None else int(lost2_hi)
    if s:
        _launch("gnuais_hdlc", x, bits, valid, pos, hdlc_in, reg_in, cv, cw,
                fields, lost2, over, hdlc_out, reg_out, s, m, rows, pitch,
                HDLC_FORMS[form], _wrap32(block_base), lo, hi, kk)
        hdlc_fused.launches += 1
    return (HdlcState(*hdlc_out.unbind(0), shiftreg=reg_out),
            demod.Candidates(cv, cw, fields[0], fields[1], fields[2], lost2,
                             over))


def hdlc_fused(state: HdlcState, codes: Optional[torch.Tensor] = None,
               form: str = "slots", bitrows: Optional[torch.Tensor] = None,
               slot_valid: Optional[torch.Tensor] = None,
               pos_rows: Optional[torch.Tensor] = None, block_base: int = 0,
               lost2_lo: Optional[int] = None,
               lost2_hi: Optional[int] = None):
    """The HDLC deframer over one block's bit slots
    (``demod.hdlc_scan_candidates``' work, in the kernel ``csrc/hdlc.cu``).

    The slots come in one of three forms: ``form="group"``, ``codes``
    B3's [M, S] uint8 group codes (``frontend_codes``); ``"sample"``,
    ``codes`` B4's [T, S] uint8 sample codes (``dpll_codes``), slot g
    being samples 4g .. 4g + 3; for both, block_base is the absolute
    index of sample 0; ``"slots"``: ``bitrows``, ``slot_valid`` and
    ``pos_rows`` [S, M], as ``demod.hdlc_scan_candidates`` takes them.
    lost2 counts wrong-size stops at positions in [lost2_lo, lost2_hi).
    Returns (new HdlcState, ``demod.Candidates`` with K = 2 * ceil(M / 64)
    slots a stream), as ``hdlc_scan_candidates`` does.

    On the card (``on_card``) it launches the kernel and adds one to
    ``hdlc_fused.launches``; a CPU tensor runs the plain version."""
    if form not in HDLC_FORMS:
        raise ValueError(f"unknown form {form!r}")
    x = codes if form != "slots" else bitrows
    if on_card(x):
        return _launch_hdlc(state, form, codes, bitrows, slot_valid,
                            pos_rows, block_base, lost2_lo, lost2_hi)
    if x.device.type == "cpu":
        return hdlc_fused_reference(state, codes, form, bitrows, slot_valid,
                                    pos_rows, block_base, lost2_lo, lost2_hi)
    raise ValueError(f"unsupported device {x.device}")


hdlc_fused.launches = 0
