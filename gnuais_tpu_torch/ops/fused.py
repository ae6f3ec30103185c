"""The hand-written CUDA kernels of the decode step (counterpart of
``gnuais_tpu/ops/fused.py``; kernel numbers as in ``ROADMAP.md``):

- ``pipeline_fused_compact`` (B1, ``csrc/pipeline_compact.cu``): raw
  samples to dense frame slots in one kernel.  Only the exact FIR
  (``fir_mode="vpu"``) is ported.
- ``frontend_fused`` (B3, ``csrc/frontend.cu``): raw samples to 4-sample
  bit slots (FIR, DPLL, group reduce); the deframer runs after it.
- ``dpll_fused`` (B4, ``csrc/dpll.cu``): the DPLL alone over filtered
  samples.

Each wrapper launches its kernel for a CUDA tensor, adding one to its
``launches`` counter, and runs its plain PyTorch version (``*_reference``,
composed from ``fir`` and ``demod``) for a CPU tensor.  Kernel and plain
version return the same tuple bit for bit.
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
    s = samples.shape[0]
    gbits, gvalid, gpos, new_history, new_dpll = frontend_fused_reference(
        samples, n_valid, history, dpll, block_base)
    new_hdlc, cand = demod.hdlc_scan_candidates(
        gbits, gvalid, hdlc, gpos, lost2_lo=lost2_lo, lost2_hi=lost2_hi)
    dense = demod.compact_candidates(
        demod.init_frames(s, frame_slots, samples.device), cand.valid,
        cand.words, cand.length, cand.start, cand.end,
        lost2=cand.lost2, over=cand.over)
    count_raw = cand.valid.sum(dim=1).to(_I32)
    return (count_raw, dense.words, dense.length, dense.start, dense.end,
            cand.lost2, cand.over, new_history, new_dpll, new_hdlc)


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


def _time_major(x: torch.Tensor) -> torch.Tensor:
    """[S, T] -> contiguous [T, S]: one transpose copy (a read and a write
    of the block) so that a warp's loads at one time step are
    neighbouring."""
    return x.t().contiguous()


def _launch(entry: str, *args) -> None:
    """Call the library's C entry point ``entry`` with ``args`` and the
    current stream of the device of the first tensor argument; raise on
    a refused launch."""
    from . import _build
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args), stream)
    if err:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")


def _launch_kernel(samples, n_valid, history, dpll, hdlc, frame_slots,
                   block_base, lost2_lo, lost2_hi):
    s, t = samples.shape
    dev = samples.device
    f = int(frame_slots)
    _check_state(samples, torch.int16, history=history,
                 **dict(zip(dpll._fields, dpll)), **hdlc._asdict())
    x = _time_major(samples)
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
        _launch("gnuais_pipeline_compact", x, hist, dpll_in, hdlc_in, reg_in,
                count_raw, words, fields, lost2, over, dpll_out, hdlc_out,
                reg_out, s, t, max(0, min(int(n_valid), t)), base, lo, hi, f)
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


# ---------------------------------------------------------------------------
# B4: the DPLL over filtered samples
# ---------------------------------------------------------------------------

def dpll_fused_reference(filtered: torch.Tensor, n_valid: int,
                         state: DpllState):
    """The plain PyTorch version of ``dpll_fused``: ``demod.dpll_scan``
    with the bits zeroed off emissions, as the kernel writes them."""
    bit_valid, bits, new_state = demod.dpll_scan(filtered, n_valid, state)
    return bit_valid, bits * bit_valid, new_state


def _launch_dpll(filtered, n_valid, state):
    s, t = filtered.shape
    dev = filtered.device
    _check_state(filtered, torch.float32, **state._asdict())
    x = _time_major(filtered)
    dpll_in = torch.stack(list(state)).to(_I32).contiguous()          # [3, S]
    codes = torch.empty((t, s), dtype=torch.uint8, device=dev)
    dpll_out = torch.empty((3, s), dtype=_I32, device=dev)
    if s:
        _launch("gnuais_dpll", x, dpll_in, codes, dpll_out, s, t,
                max(0, min(int(n_valid), t)))
        dpll_fused.launches += 1
    codes = codes.t().contiguous()                                    # [S, T]
    return codes >= 2, (codes & 1).to(_I32), DpllState(*dpll_out.unbind(0))


def dpll_fused(filtered: torch.Tensor, n_valid: int, state: DpllState):
    """Clock recovery over one block: the slicer, DPLL and NRZI of
    ``demod.dpll_scan``.

    filtered: float32 [S, T]; samples at index >= n_valid freeze the
    state and emit nothing.  Returns (bit_valid bool [S, T], bits int32
    [S, T], new state), bits 0 where bit_valid is false.

    A CUDA tensor launches the hand-written kernel (``csrc/dpll.cu``) and
    adds one to ``dpll_fused.launches``; a CPU tensor runs the plain
    version."""
    if filtered.device.type == "cuda":
        return _launch_dpll(filtered, n_valid, state)
    if filtered.device.type == "cpu":
        return dpll_fused_reference(filtered, n_valid, state)
    raise ValueError(f"unsupported device {filtered.device}")


dpll_fused.launches = 0


# ---------------------------------------------------------------------------
# B3: FIR, DPLL and 4-sample bit slots
# ---------------------------------------------------------------------------

def bit_slots(samples: torch.Tensor, n_valid: int, history: torch.Tensor,
              state: DpllState, block_base: int = 0,
              fast_dpll: bool = False):
    """The unfused front end: ``fir.fir_exact``, then ``dpll_fused``
    (``fast_dpll``) or ``demod.dpll_scan``, then
    ``demod.group_reduce_bits`` (the bit axis padded to a multiple of 4).
    Same returns as ``frontend_fused``."""
    filtered, new_history = fir.fir_exact(samples, history, n_valid=n_valid)
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


def _launch_frontend(samples, n_valid, history, state, block_base):
    s, t = samples.shape
    g = t // 4
    dev = samples.device
    _check_state(samples, torch.int16, history=history, **state._asdict())
    x = _time_major(samples)
    hist = history.to(torch.float32).contiguous()
    dpll_in = torch.stack(list(state)).to(_I32).contiguous()          # [3, S]
    codes = torch.empty((g, s), dtype=torch.uint8, device=dev)
    dpll_out = torch.empty((3, s), dtype=_I32, device=dev)
    nv = max(0, min(int(n_valid), t))
    if s:
        _launch("gnuais_frontend", x, hist, dpll_in, codes, dpll_out, s, t, nv)
        frontend_fused.launches += 1
    codes = codes.t().contiguous()                                    # [S, T/4]
    gvalid = codes >= 8
    gbits = ((codes >> 2) & 1).to(_I32)
    # absolute sample index, wrapping like int32
    pos = (int(block_base) + 4 * torch.arange(g, device=dev))[None, :] \
        + (codes & 3)
    gpos = torch.where(gvalid, pos.to(_I32), 0)
    return (gbits, gvalid, gpos, _carry_history(samples, hist, nv),
            DpllState(*dpll_out.unbind(0)))


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

    A CUDA tensor launches the hand-written kernel (``csrc/frontend.cu``)
    and adds one to ``frontend_fused.launches``; a CPU tensor runs the
    plain version."""
    if samples.shape[1] % 4:
        raise ValueError(f"T must be a multiple of 4, got {samples.shape[1]}")
    if samples.device.type == "cuda":
        return _launch_frontend(samples, n_valid, history, state, block_base)
    if samples.device.type == "cpu":
        return frontend_fused_reference(samples, n_valid, history, state,
                                        block_base)
    raise ValueError(f"unsupported device {samples.device}")


frontend_fused.launches = 0
