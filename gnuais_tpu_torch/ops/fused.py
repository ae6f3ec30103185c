"""The fused decode step: raw samples to dense frame slots in one CUDA
kernel (counterpart of ``gnuais_tpu/ops/fused.py``
``pipeline_fused_compact``, kernel B1 in ``ROADMAP.md``).

``pipeline_fused_compact`` launches ``csrc/pipeline_compact.cu`` for a
CUDA tensor and runs ``pipeline_fused_compact_reference``, the port's
exact chain composed from ``fir``, ``demod`` and the candidate
compaction, for a CPU tensor.  The two return the same tuple bit for
bit.  Only the exact FIR (``fir_mode="vpu"``) is ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from gnuais_tpu import constants as C

from . import demod, fir
from .demod import REG_WORDS, DpllState, HdlcState

_I32 = torch.int32


def _carry_history(samples: torch.Tensor, history: torch.Tensor,
                   n_valid: int) -> torch.Tensor:
    """Last FIR_LEN valid raw samples as float32 [S, 36], without
    building concat(history, samples): the window full[nv : nv+36] of
    full = [history | samples] lies inside samples when nv >= 36 and
    inside the first 72 columns otherwise.  The tail start is clamped
    for short final blocks (n_valid < 36)."""
    nv = int(n_valid)
    lo = max(nv - C.FIR_LEN, 0)
    tail = samples[:, lo:lo + C.FIR_LEN].to(torch.float32)
    small = torch.cat([history, tail], dim=1)                 # [S, 72]
    k = min(nv, C.FIR_LEN)
    return small[:, k:k + C.FIR_LEN].contiguous()


def pipeline_fused_compact_reference(
        samples: torch.Tensor, n_valid: int, history: torch.Tensor,
        dpll: DpllState, hdlc: HdlcState, frame_slots: int = 32,
        block_base: int = 0, lost2_lo: Optional[int] = None,
        lost2_hi: Optional[int] = None):
    """The plain PyTorch version of the fused step: the exact chain
    (fir_exact, dpll_scan, group_reduce_bits, hdlc_scan) with its
    candidates compacted into dense slots.  Same arguments and returns
    as ``pipeline_fused_compact``."""
    s, t = samples.shape
    filtered, new_history = fir.fir_exact(samples, history, n_valid=n_valid)
    bit_valid, bits, new_dpll = demod.dpll_scan(filtered, n_valid, dpll)
    if t % 4:
        pad = 4 - t % 4
        bit_valid = torch.nn.functional.pad(bit_valid, (0, pad))
        bits = torch.nn.functional.pad(bits, (0, pad))
    gbits, gvalid, gpos = demod.group_reduce_bits(bit_valid, bits, block_base)
    new_hdlc, cand = demod.hdlc_scan_candidates(
        gbits, gvalid, hdlc, gpos, lost2_lo=lost2_lo, lost2_hi=lost2_hi)
    dense = demod.compact_candidates(
        demod.init_frames(s, frame_slots, samples.device), cand.valid,
        cand.words, cand.length, cand.start, cand.end,
        lost2=cand.lost2, over=cand.over)
    count_raw = cand.valid.sum(dim=1).to(_I32)
    return (count_raw, dense.words, dense.length, dense.start, dense.end,
            cand.lost2, cand.over, new_history, new_dpll, new_hdlc)


def _launch_kernel(samples, n_valid, history, dpll, hdlc, frame_slots,
                   block_base, lost2_lo, lost2_hi):
    from . import _build
    s, t = samples.shape
    dev = samples.device
    f = int(frame_slots)
    if samples.dtype != torch.int16:
        raise TypeError(f"samples must be int16, got {samples.dtype}")
    # the kernel indexes every state leaf by stream: check before passing
    # pointers
    shapes = {"history": (s, C.FIR_LEN), "shiftreg": (s, REG_WORDS)}
    for name, v in (("history", history), *zip(dpll._fields, dpll),
                    *zip(hdlc._fields, hdlc)):
        if v.device != dev:
            raise ValueError(f"{name} is on {v.device}, samples on {dev}")
        if tuple(v.shape) != shapes.get(name, (s,)):
            raise ValueError(f"{name} has shape {tuple(v.shape)}, expected "
                             f"{shapes.get(name, (s,))}")
    # time-major input: one transpose copy (a read and a write of the
    # block) so that a warp's loads at one time step are neighbouring
    x = samples.t().contiguous()
    hist = history.to(torch.float32).contiguous()
    dpll_in = torch.stack(list(dpll)).to(_I32).contiguous()           # [3, S]
    hdlc_in = torch.stack(list(hdlc[:8])).to(_I32).contiguous()       # [8, S]
    reg_in = hdlc.shiftreg.to(_I32).contiguous()                      # [S, 15]
    count_raw = torch.empty((s,), dtype=_I32, device=dev)
    words = torch.zeros((s, f, REG_WORDS), dtype=_I32, device=dev)
    fields = torch.zeros((3, s, f), dtype=_I32, device=dev)
    lost2 = torch.empty((s,), dtype=_I32, device=dev)
    over = torch.empty((s,), dtype=_I32, device=dev)
    dpll_out = torch.empty((3, s), dtype=_I32, device=dev)
    hdlc_out = torch.empty((8, s), dtype=_I32, device=dev)
    reg_out = torch.empty((s, REG_WORDS), dtype=_I32, device=dev)
    lo = -2**31 if lost2_lo is None else int(lost2_lo)
    hi = 2**31 - 1 if lost2_hi is None else int(lost2_hi)
    base = (int(block_base) + 2**31) % 2**32 - 2**31     # int32 wrap
    if s:
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.gnuais_pipeline_compact(
                x.data_ptr(), hist.data_ptr(), dpll_in.data_ptr(),
                hdlc_in.data_ptr(), reg_in.data_ptr(), count_raw.data_ptr(),
                words.data_ptr(), fields.data_ptr(), lost2.data_ptr(),
                over.data_ptr(), dpll_out.data_ptr(), hdlc_out.data_ptr(),
                reg_out.data_ptr(), s, t, max(0, min(int(n_valid), t)), base,
                lo, hi, f, stream)
        if err:
            raise RuntimeError(f"pipeline_compact kernel launch failed: "
                               f"cudaError {err}")
        pipeline_fused_compact.launches += 1
    new_dpll = DpllState(*dpll_out.unbind(0))
    new_hdlc = HdlcState(*hdlc_out.unbind(0), shiftreg=reg_out)
    new_history = _carry_history(samples, hist, n_valid)
    return (count_raw, words, fields[0], fields[1], fields[2], lost2, over,
            new_history, new_dpll, new_hdlc)


def pipeline_fused_compact(samples: torch.Tensor, n_valid: int,
                           history: torch.Tensor, dpll: DpllState,
                           hdlc: HdlcState, frame_slots: int = 32,
                           block_base: int = 0, fir_mode: str = "vpu",
                           lost2_lo: Optional[int] = None,
                           lost2_hi: Optional[int] = None):
    """Fused decode of one block with dense frame slots.

    samples: int16 [S, T] (T % 4 == 0); n_valid: real samples (the rest
    is padding and freezes the state); history: float32 [S, 36];
    block_base: absolute index of sample 0; lost2 counts wrong-size stops
    in [lost2_lo, lost2_hi).  Returns (count_raw [S], words [S, F, 15]
    int32 bit patterns, length/start/end [S, F], lost2 [S], over [S],
    new_history, new_dpll, new_hdlc): frames in arrival order with zeroed
    empty slots, count_raw not clipped to F = frame_slots.

    A CUDA tensor launches the hand-written kernel and adds one to
    ``pipeline_fused_compact.launches``; a CPU tensor runs the plain
    version.  The JAX function's TPU tiling knobs have no counterpart
    here; the ``lobe`` and ``mxu`` FIR modes are not ported yet."""
    if fir_mode != "vpu":
        raise NotImplementedError(f"fir_mode={fir_mode!r}: only 'vpu' is ported")
    if samples.shape[1] % 4:
        raise ValueError(f"T must be a multiple of 4, got {samples.shape[1]}")
    if samples.device.type == "cuda":
        return _launch_kernel(samples, n_valid, history, dpll, hdlc,
                              frame_slots, block_base, lost2_lo, lost2_hi)
    if samples.device.type == "cpu":
        return pipeline_fused_compact_reference(
            samples, n_valid, history, dpll, hdlc, frame_slots, block_base,
            lost2_lo, lost2_hi)
    raise ValueError(f"unsupported device {samples.device}")


pipeline_fused_compact.launches = 0
