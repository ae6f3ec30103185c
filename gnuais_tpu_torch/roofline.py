"""Chain-latency roofline of the fused decode kernel on one NVIDIA GPU
(counterpart of ``tools/roofline.py``):

    python -m gnuais_tpu_torch.roofline [--streams 4096 [16384 ...]] [--steps N]

Kernels B1 and B2 run one thread per stream, and each stream is a
sequential recurrence: the DPLL every sample and the deframer every 4.
This tool runs that recurrence alone, in ``csrc/roofline.cu``, to
measure how long one step of it takes on the card:

- R1, ``chain`` (``tools/roofline.py`` ``make_chain_kernel``): the chain
  fed by an LCG stand-in for the filtered sample, nothing read per step,
  in the modes ``dpll``, ``dpll+hdlc`` and ``dpll+hdlc+shift``;
- R2, ``stream`` (``_make_streamed_kernel``): the chain fed by a
  time-major int16 ``[steps, S]`` input, looped ``passes`` times, in the
  modes ``stream+dpll``, ``stream+dpll+hdlc+shift``,
  ``stream+fir+dpll+hdlc+shift`` (the lobe FIR) and
  ``stream+blocks+dpll+hdlc+shift`` (16 carry arrays read and written
  every 512 samples).

Each wrapper launches its kernel for a CUDA tensor, adding one to its
``launches``, and runs its plain PyTorch version (``*_reference``,
composed from ``ops.demod`` and ``ops.fir``) for a CPU tensor; the two
agree bit for bit.  The deframer starts from its real initial state
(``demod.init_hdlc``), not from zeros as the TPU tool's does: the port's
step takes no state 0.

The table times each mode by CUDA events, one call at a time, each call
on its own seeds or input, less the time of a 32-step R1 call (the
launch floor), and prints ms, ns a step and G samples/s (steps x S over
the time).  It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import card
from .card import F32_TFLOPS, INT32_TOPS
from .ops import demod, fir, fused
from .ops.demod import HdlcState

_I32 = torch.int32

CHAIN_MODES = ("dpll", "dpll+hdlc", "dpll+hdlc+shift")
STREAM_MODES = ("stream+dpll", "stream+dpll+hdlc+shift",
                "stream+fir+dpll+hdlc+shift", "stream+blocks+dpll+hdlc+shift")
UNROLL = 32          # R1: steps are counted in whole bodies of 32
TIME_CHUNK = 512     # R2: samples per TPU grid step; spos restarts in each
N_DUMMY = 16         # R2 "blocks": carry arrays
LCG_MUL, LCG_ADD = 1103515245, 12345

# Integer operations of one step, counted from csrc/pipeline_step.cuh
# as the chain runs them: the LCG 2 (multiply, add), the slicer 1, the
# DPLL 11 (transition xor, nudge compare and select, multiply and two
# adds, emit compare, NRZI xor and subtract, mask, lastbit select);
# with "hdlc" the group's slot code 4 a step (shift, or, select, or) and
# the deframer's hunt state 10 a slot (bit and alternation compares,
# state dispatch 2, count select and add, threshold compare and test,
# last bit, valid test), 2.5 a step.  The register appends ("shift"),
# 3 operations for each of 15 words, run only in the data state, which
# neither the LCG's nor the streamed input's random bits reach (a frame
# needs 15 alternations and a start flag first): counted as 0.
CHAIN_OPS = {"dpll": 14, "dpll+hdlc": 20.5, "dpll+hdlc+shift": 20.5}
STREAM_OPS = {"stream+dpll": 12, "stream+dpll+hdlc+shift": 18.5,
              "stream+fir+dpll+hdlc+shift": 18.5,
              "stream+blocks+dpll+hdlc+shift": 18.5}
# float32 operations of the lobe FIR a step (8 pair adds, 8 multiplies,
# 7 adds) in "stream+fir"
LOBE_FLOPS = 23


def passes_for(steps: int) -> int:
    """R2's passes over its input: enough that a call runs ~2^22 steps
    (``tools/roofline.py``)."""
    return max(1, (1 << 22) // steps)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _lcg_signs(seed: torch.Tensor, steps: int) -> torch.Tensor:
    """float32 [S, steps]: step t's LCG state as a signed int32, cast
    (only its sign matters to the slicer)."""
    x = seed.to(torch.int64) & 0xFFFFFFFF
    out = torch.empty((seed.shape[0], steps), dtype=torch.int64,
                      device=seed.device)
    for t in range(steps):
        x = (x * LCG_MUL + LCG_ADD) & 0xFFFFFFFF
        out[:, t] = x
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.float32)


def _chain_tail(filtered: torch.Tensor, hdlc: bool, shift: bool,
                pos: torch.Tensor) -> Tuple[torch.Tensor, HdlcState]:
    """The DPLL over ``filtered`` [S, n] from rest, then (``hdlc``) the
    deframer over its 4-sample slots at the positions ``pos`` [n / 4],
    the register left as it was unless ``shift``.  Returns (final PLL,
    deframer state)."""
    s, n = filtered.shape
    dev = filtered.device
    emit, bits, st = demod.dpll_scan(filtered, n, demod.init_dpll(s, dev))
    h0 = demod.init_hdlc(s, dev)
    if not hdlc:
        return st.pll, h0
    gbits, gvalid, _ = demod.group_reduce_bits(emit, bits)
    h, _ = demod.hdlc_scan_candidates_reference(
        gbits, gvalid, h0, pos.to(_I32)[None, :].expand(s, -1))
    if not shift:
        h = h._replace(shiftreg=h0.shiftreg)
    return st.pll, h


def chain_reference(seed: torch.Tensor, steps: int,
                    mode: str) -> Tuple[torch.Tensor, HdlcState]:
    """The plain version of ``chain``: ``demod.dpll_scan`` over the
    LCG's signs and ``demod.hdlc_scan_candidates_reference`` over the slots at
    spos = the group's last step.  Same arguments and returns."""
    _check_chain(seed, steps, mode)
    n = steps // UNROLL * UNROLL
    pos = 4 * torch.arange(n // 4, device=seed.device) + 3
    return _chain_tail(_lcg_signs(seed, n), "hdlc" in mode, "shift" in mode,
                       pos)


def stream_reference(x: torch.Tensor, mode: str, passes: int,
                     dummy: Optional[torch.Tensor] = None):
    """The plain version of ``stream``: the input repeated ``passes``
    times along time, through ``fir.fir_lobe`` (with "fir", from a zero
    history), ``demod.dpll_scan`` and
    ``demod.hdlc_scan_candidates_reference`` at
    spos = the group's last sample within its 512-sample chunk.  Same
    arguments and returns."""
    _check_stream(x, mode, passes, dummy)
    steps, s = x.shape
    rows = x.t().repeat(1, passes)
    if "fir" in mode:
        filtered, _ = fir.fir_lobe(rows, fir.init_history(s, x.device))
    else:
        filtered = rows.to(torch.float32)
    pos = (4 * torch.arange(rows.shape[1] // 4, device=x.device) + 3) \
        % TIME_CHUNK
    pll, h = _chain_tail(filtered, "hdlc" in mode, "shift" in mode, pos)
    return pll, h, (dummy.clone() if "blocks" in mode else None)


def build_input(seed: torch.Tensor, steps: int) -> torch.Tensor:
    """R2's input from int32 seeds [S]: int16 [steps, S], row t the seeds
    cast to int16 plus (t as int16) % 251, wrapping like int16
    (``tools/roofline.py``'s ``build``, time-major)."""
    t = torch.arange(steps, device=seed.device).to(torch.int16) % 251
    return seed.to(torch.int16)[None, :] + t[:, None]


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check_chain(seed, steps, mode):
    if mode not in CHAIN_MODES:
        raise ValueError(f"unknown chain mode {mode!r}")
    if seed.dim() != 1 or seed.dtype != _I32:
        raise ValueError("seed must be int32 [S]")
    if steps < UNROLL:
        raise ValueError(f"steps must be at least {UNROLL}, got {steps}")


def _check_stream(x, mode, passes, dummy):
    if mode not in STREAM_MODES:
        raise ValueError(f"unknown stream mode {mode!r}")
    if x.dim() != 2 or x.dtype != torch.int16 or not x.is_contiguous():
        raise ValueError("input must be a contiguous int16 [steps, S]")
    if x.shape[0] % TIME_CHUNK or passes < 1:
        raise ValueError(f"steps must be a multiple of {TIME_CHUNK} and "
                         f"passes >= 1, got {x.shape[0]}, {passes}")
    if "blocks" in mode and (dummy is None or dummy.dtype != _I32 or
                             tuple(dummy.shape) != (N_DUMMY, x.shape[1]) or
                             dummy.device != x.device):
        raise ValueError(f"mode {mode!r} needs int32 dummy [{N_DUMMY}, S] "
                         f"on the input's device")


def _outputs(s: int, dev):
    return (torch.empty((s,), dtype=_I32, device=dev),
            torch.empty((8, s), dtype=_I32, device=dev),
            torch.empty((s, demod.REG_WORDS), dtype=_I32, device=dev))


def _hdlc(mode: str, s: int, dev, hdlc_out, reg_out) -> HdlcState:
    if "hdlc" not in mode:
        return demod.init_hdlc(s, dev)
    reg = reg_out if "shift" in mode else demod.init_hdlc(s, dev).shiftreg
    return HdlcState(*hdlc_out.unbind(0), shiftreg=reg)


def _launch_chain(seed, steps, mode):
    _check_chain(seed, steps, mode)
    s = seed.shape[0]
    pll, hdlc_out, reg_out = _outputs(s, seed.device)
    if s:
        fused._launch("gnuais_roofline_chain", seed.contiguous(), pll,
                      hdlc_out, reg_out, s, steps // UNROLL * UNROLL,
                      CHAIN_MODES.index(mode))
        chain.launches += 1
    return pll, _hdlc(mode, s, seed.device, hdlc_out, reg_out)


def chain(seed: torch.Tensor, steps: int,
          mode: str) -> Tuple[torch.Tensor, HdlcState]:
    """R1: each stream's LCG (int32 seed [S], uint32 arithmetic) drives
    ``steps`` (rounded down to a multiple of 32) DPLL steps and, per
    ``mode``, the deframer and its register.  Returns (final PLL [S],
    deframer state; its initial state in mode "dpll", its initial
    register without "shift").

    A CUDA tensor launches the kernel and adds one to
    ``chain.launches``; a CPU tensor runs ``chain_reference``."""
    if seed.device.type == "cuda":
        return _launch_chain(seed, steps, mode)
    if seed.device.type == "cpu":
        return chain_reference(seed, steps, mode)
    raise ValueError(f"unsupported device {seed.device}")


chain.launches = 0

_STREAM_BITS = {"stream+dpll": 0, "stream+dpll+hdlc+shift": 3,
                "stream+fir+dpll+hdlc+shift": 7,
                "stream+blocks+dpll+hdlc+shift": 11}


def _launch_stream(x, mode, passes, dummy):
    _check_stream(x, mode, passes, dummy)
    steps, s = x.shape
    pll, hdlc_out, reg_out = _outputs(s, x.device)
    blocks = "blocks" in mode
    din = dummy.contiguous() if blocks else pll
    dout = torch.empty_like(din) if blocks else pll
    if s:
        fused._launch("gnuais_roofline_stream", x, din, dout, pll, hdlc_out,
                      reg_out, s, steps, passes, _STREAM_BITS[mode])
        stream.launches += 1
    return (pll, _hdlc(mode, s, x.device, hdlc_out, reg_out),
            dout if blocks else None)


def stream(x: torch.Tensor, mode: str, passes: int,
           dummy: Optional[torch.Tensor] = None):
    """R2: the chain of ``mode`` over the time-major int16 input
    ``x`` [steps, S] (steps % 512 == 0), ``passes`` times over, the
    state carried from pass to pass; with "blocks", ``dummy`` int32
    [16, S] is read and written every 512 samples.  Returns (final PLL
    [S], deframer state as ``chain``'s, the dummy arrays written or
    None).

    A CUDA tensor launches the kernel and adds one to
    ``stream.launches``; a CPU tensor runs ``stream_reference``."""
    if x.device.type == "cuda":
        return _launch_stream(x, mode, passes, dummy)
    if x.device.type == "cpu":
        return stream_reference(x, mode, passes, dummy)
    raise ValueError(f"unsupported device {x.device}")


stream.launches = 0


# ---------------------------------------------------------------------------
# The table
# ---------------------------------------------------------------------------

def bound_ms(mode: str, streams: int, steps: int, passes: int = 1
             ) -> Tuple[float, str]:
    """The least time of a call (``card.bound_ms``): R1 its integer
    operations at INT32_TOPS; R2 the larger of its input's bytes (read
    once) over HBM_TB_S and its operations (integer, and the lobe FIR's
    float32 ones at F32_TFLOPS, on their own pipes).  Returns (ms,
    "bytes" or "operations")."""
    lanes = streams * steps * passes
    if mode in CHAIN_OPS:
        return card.bound_ms(0, (lanes * CHAIN_OPS[mode], INT32_TOPS))
    return card.bound_ms(steps * streams * 2,
                         (lanes * STREAM_OPS[mode], INT32_TOPS),
                         (lanes * LOBE_FLOPS * ("fir" in mode), F32_TFLOPS))


def _event_ms(fn) -> float:
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    e.record()
    e.synchronize()
    return a.elapsed_time(e)


def table(streams: int, steps: int, iters: int = 5,
          seed: int = 7) -> List[Dict]:
    """Every mode of R1 and R2 at ``streams`` streams: one warm-up call,
    then ``iters`` timed calls (CUDA events), each on seeds or an input
    of its own.  R1 runs ``steps`` steps; R2 min(steps, 2^17) steps,
    ``passes_for`` of them times over.  Returns one dict a mode (its
    median ms, less the median of a 32-step R1 call, ns a step,
    G samples/s, the bound)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)

    def seeds():
        return torch.from_numpy(rng.integers(1, 2**31 - 1, streams,
                                             dtype=np.int32)).to(dev)

    def timed(fn, args):
        fn(*args[0])                                  # warm-up (and build)
        return statistics.median(_event_ms(lambda a=a: fn(*a))
                                 for a in args[1:])

    floor = timed(chain, [(seeds(), UNROLL, "dpll")
                          for _ in range(iters + 1)])
    rows = []
    for mode in CHAIN_MODES:
        ms = timed(chain, [(seeds(), steps, mode) for _ in range(iters + 1)])
        rows.append(_row(mode, streams, steps, 1, ms, floor))
    st = min(steps, 1 << 17) // TIME_CHUNK * TIME_CHUNK
    passes = passes_for(st)
    for mode in STREAM_MODES:
        dummy = torch.arange(N_DUMMY * streams, dtype=_I32,
                             device=dev).reshape(N_DUMMY, streams)
        inputs = [(build_input(seeds(), st), mode, passes, dummy)
                  for _ in range(iters + 1)]
        ms = timed(stream, inputs)
        del inputs
        rows.append(_row(mode, streams, st, passes, ms, floor))
    return rows


def _row(mode, streams, steps, passes, ms, floor) -> Dict:
    n = steps * passes
    dev_ms = max(ms - floor, 1e-6)
    b_ms, b_by = bound_ms(mode, streams, steps, passes)
    return dict(mode=mode, streams=streams, steps=n, ms=ms, floor_ms=floor,
                ns_per_step=dev_ms * 1e6 / n,
                gsamples_s=n * streams / (dev_ms * 1e-3) / 1e9,
                bound_ms=b_ms, bound_by=b_by)


def format_row(r: Dict) -> str:
    return (f"  {r['mode']:30s} S={r['streams']:6d} {r['steps']:8d} steps: "
            f"{r['ms']:9.3f} ms ({r['ns_per_step']:7.2f} ns/step device) "
            f"-> {r['gsamples_s']:7.2f} G samples/s; bound {r['bound_ms']:.3f} "
            f"ms by {r['bound_by']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, nargs="+", default=[4096])
    ap.add_argument("--steps", type=int, default=1 << 22)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("roofline: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    iters = 5
    for streams in args.streams:
        rows = table(streams, args.steps, iters)
        print(f"chain calibration at {streams} streams, {args.steps} steps a "
              f"call (median of {iters}, CUDA events; launch floor "
              f"{rows[0]['floor_ms']:.4f} ms); {card}")
        for r in rows:
            print(format_row(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
