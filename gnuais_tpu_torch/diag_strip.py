"""Perf bisection of kernel B2 on one NVIDIA GPU, the counterpart of
``tools/diag_strip.py``:

    python -m gnuais_tpu_torch.diag_strip [strip=snap|shift,snap|hdlc|...] \\
        [fir=vpu|lobe|mxu] [K=12] [pretiled] [prefiltered]

B2 (``ops.fused.pipeline_fused``) with pieces of its kernel left out by
the ``strip=`` flags (``ops.fused.STRIP_FLAGS``; ``csrc/pipeline_strip.cu``
says what each leaves out), timed under the JAX tool's verified
protocol: two distinct inputs of 3 and 4 encoder payloads a stream
(``strip_inputs``), each tiled to K blocks of 4096 streams x 49,152
samples; a dispatch runs B2 over the K blocks with an evolving DPLL
carry, so that no dispatch repeats another, and reads its candidate
count back, which is checked whenever neither ``hdlc`` nor ``flush`` is
stripped.  One warm-up dispatch, then 8 timed ones on the inputs in
turn (host clock, the readback included).  Prints the median and best
ms a dispatch, G samples/s and ns a chain step, and the card's name
and power limit.  ``pretiled`` feeds the blocks time-major
(``fused.tile_superblock``, made before the timing).  ``prefiltered``
takes the FIR out of the kernel, as the JAX function's
``prefiltered=True`` does: each input block is filtered once before
the timing (``fir.fir_exact``, its history zero, as every block's is
here) and B2 runs on the float32 samples, so that beside the same
protocol on the raw samples it splits B2's time between its FIR and
the rest; ``fir=`` is then not used.  The JAX tool's Mosaic knobs
(``unguarded``, ``unroll=``, ``SL=``) have no counterpart in the port's
kernel, nor has its ``landing=``: the port's kernel has the one
landing, JAX's "body" (``csrc/pipeline_kernel.cuh``).  All are refused.

``check_strip`` holds a stripped kernel's outputs to what its flags
leave of the unstripped kernel's: the invariants ``chip_smoke.py`` and
the host-build tests check.  It runs on the card (``device=cuda``, the
default); a stripped kernel has no plain version.
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import card
from .device import resolve_device
from .golden import encoder as E
from .ops import demod, fused
from .ops.fir import fir_exact, init_history
from .ops.fused import STRIP_FLAGS, strip_mask

MOSAIC_KNOBS = ("unguarded", "unroll=", "SL=")
STREAMS, BLOCK = 4096, 49_152


def strip_inputs(n_streams: int, block: int, n_blocks: int, device,
                 prefiltered: bool = False):
    """The tool's two inputs, [S, K*T] int16 on ``device`` (``prefiltered``:
    float32, each block's exact FIR from a zero history), and the
    candidates each dispatch must count: input v (v = 0, 1) holds 3 + v
    payloads (each drawn from ``default_rng(v + 1)``, gap 64 bits,
    lead-in 64 + 16 v bits) at the start of every stream's block, zeros
    after them, the block repeated K times."""
    bufs, wants = [], []
    for v in range(2):
        n_pay = 3 + v
        audio = E.synthesize_capture(
            [E.random_payload(np.random.default_rng(v + 1))
             for _ in range(n_pay)], gap_bits=64, lead_in_bits=64 + 16 * v)
        b = torch.zeros((n_streams, block), dtype=torch.int16, device=device)
        b[:, :len(audio)] = torch.from_numpy(audio).to(device)
        if prefiltered:
            b = fir_exact(b, init_history(n_streams, device))[0]
        bufs.append(b.repeat(1, n_blocks))
        wants.append(n_pay * n_streams * n_blocks)
    return bufs, wants


def dispatch(x: torch.Tensor, n_blocks: int, dpll, strip: str,
             fir_mode: str, pretiled: bool):
    """One dispatch: B2 over the K blocks of ``x`` ([S, K*T], or [K, T, S]
    when ``pretiled``; float32 samples are prefiltered) from a zero
    history, ``dpll`` and a fresh HDLC state, the carry chained through
    the blocks.  Returns (candidates counted, the sum of the DPLL phases,
    the new DPLL state), read back."""
    s = x.shape[2] if pretiled else x.shape[0]
    t = x.shape[1] if pretiled else x.shape[1] // n_blocks
    h = torch.zeros((s, 36), dtype=torch.float32, device=x.device)
    d, hh = dpll, demod.init_hdlc(s, x.device)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    for k in range(n_blocks):
        xb = x[k] if pretiled else x[:, k * t:(k + 1) * t]
        out = fused.pipeline_fused(
            xb, t, h, d, hh, fir_mode=fir_mode, assume_full=True,
            strip=strip, prefiltered=x.dtype == torch.float32,
            pretiled_streams=s if pretiled else None)
        h, d, hh = out[7:]
        count += out[0].sum()
    return int(count), int(d.pll.sum()), d


def run(strip: str = "", fir: str = "mxu", n_blocks: int = 12,
        pretiled: bool = False, prefiltered: bool = False,
        n_streams: int = STREAMS, block: int = BLOCK, dispatches: int = 8,
        device: str = "cuda") -> dict:
    """The tool's protocol; returns {"ms": [ms a dispatch], "median_ms",
    "best_ms", "gsamp_s", "ns_step", "checked"}."""
    dev = resolve_device(device)
    strip_mask(strip)
    bufs, wants = strip_inputs(n_streams, block, n_blocks, dev, prefiltered)
    if pretiled:
        bufs = [fused.tile_superblock(b, n_blocks) for b in bufs]
    checked = "hdlc" not in strip and "flush" not in strip
    d = demod.init_dpll(n_streams, dev)
    cnt, _, d = dispatch(bufs[0], n_blocks, d, strip, fir, pretiled)
    if checked and cnt != wants[0]:
        raise RuntimeError(f"warm-up counted {cnt} candidates, {wants[0]} sent")
    times = []
    for k in range(dispatches):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        cnt, _, d = dispatch(bufs[k % 2], n_blocks, d, strip, fir,
                             pretiled)     # d evolves every dispatch
        times.append((time.perf_counter() - t0) * 1e3)
        if checked and cnt != wants[k % 2]:
            raise RuntimeError(f"dispatch {k} counted {cnt} candidates, "
                               f"{wants[k % 2]} sent")
    med = statistics.median(times)
    n = n_streams * block * n_blocks
    return {"ms": times, "median_ms": med, "best_ms": min(times),
            "gsamp_s": n / med / 1e6, "best_gsamp_s": n / min(times) / 1e6,
            "ns_step": med * 1e6 / (block * n_blocks), "checked": checked}


def _leaves(out) -> list:
    flat = []
    for v in out:
        flat.extend(_leaves(v) if isinstance(v, tuple) else [v])
    return flat


def _same(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def check_strip(strip: str, out, ref, carry_in, fir_ref=None) -> None:
    """Raise RuntimeError unless ``out``, B2's outputs with ``strip``,
    keeps what the flags leave of ``ref``, the unstripped kernel's on the
    same input and FIR mode, from the carry ``carry_in``:
    - ``fir``: every output but the history equals ``fir_ref``'s, the
      prefiltered kernel's on the raw samples cast to float32 with the
      other flags (the HDLC leaves too);
    - otherwise the DPLL carry equals ``ref``'s; with ``hdlc`` the HDLC
      carry is ``carry_in``'s, no candidate, lost2 and over 0;
    - else the HDLC state equals ``ref``'s, its register too (``shift``:
      ``carry_in``'s); lost2 and over equal ``ref``'s (``book``: 0);
      ``flush``: no candidate, nothing written; else the candidates'
      flags equal ``ref``'s, their fields and words too (``snap``: all
      zero; ``shift``: the fields)."""
    mask = strip_mask(strip)
    cv, cw, cl, cs, ce, lost2, over, _, dpll, hdlc = out

    def need(cond, what):
        if not cond:
            raise RuntimeError(f"strip={strip!r}: {what}")

    if mask & STRIP_FLAGS["fir"]:
        need(fir_ref is not None, "no prefiltered run to hold fir against")
        for i, (a, b) in enumerate(zip(_leaves(out[:7] + out[8:]),
                                       _leaves(fir_ref[:7] + fir_ref[8:]))):
            need(_same(a, b), f"leaf {i} differs from the prefiltered kernel's "
                              "on the raw samples")
        return
    need(all(_same(a, b) for a, b in zip(dpll, ref[8])),
         "DPLL carry differs from the unstripped kernel's")

    def zero(*vs):
        return not any(bool(v.any()) for v in vs)

    if mask & STRIP_FLAGS["hdlc"]:
        need(all(_same(a, b) for a, b in zip(hdlc, carry_in.hdlc)),
             "HDLC carry moved without a slot section")
        need(zero(cv, lost2, over), "frames or counts")
        return
    need(all(_same(a, b) for a, b in zip(hdlc[:8], ref[9][:8])),
         "HDLC state differs from the unstripped kernel's")
    reg = carry_in.hdlc.shiftreg if mask & STRIP_FLAGS["shift"] \
        else ref[9].shiftreg
    need(_same(hdlc.shiftreg, reg), "register")
    if mask & STRIP_FLAGS["book"]:
        need(zero(lost2, over), "lost2/over counted")
    else:
        need(_same(lost2, ref[5]) and _same(over, ref[6]), "lost2/over")
    if mask & STRIP_FLAGS["flush"]:
        need(zero(cv, cw, cl, cs, ce), "frames written")
        return
    need(_same(cv, ref[0]), "candidate flags")
    if mask & STRIP_FLAGS["snap"]:
        need(zero(cw, cl, cs, ce), "frame words or fields written")
        return
    need(_same(cl, ref[2]) and _same(cs, ref[3]) and _same(ce, ref[4]),
         "frame fields")
    if not mask & STRIP_FLAGS["shift"]:
        need(_same(cw, ref[1]), "frame words")


def parse(argv) -> dict:
    """The JAX tool's arguments and ``prefiltered``; raises ValueError on a
    Mosaic knob, ``landing=`` or an unknown argument."""
    opts = dict(strip="", fir="mxu", n_blocks=12, pretiled=False,
                prefiltered=False, device="cuda")
    for a in argv:
        if a.startswith(MOSAIC_KNOBS):
            raise ValueError(
                f"{a!r}: the Mosaic knobs {', '.join(MOSAIC_KNOBS)} of the "
                "TPU kernel have no counterpart in the port's kernel "
                "(ROADMAP.md, left out)")
        if a.startswith("landing="):
            raise ValueError(
                f"{a!r}: the port's kernel has one landing, the TPU "
                "kernel's \"body\" (ROADMAP.md, departures)")
        key, _, val = a.partition("=")
        if key == "strip":
            opts["strip"] = val
        elif key == "fir":
            opts["fir"] = val
        elif key == "K":
            opts["n_blocks"] = int(val)
        elif key == "device":
            opts["device"] = val
        elif a in ("pretiled", "prefiltered"):
            opts[a] = True
        else:
            raise ValueError(f"unknown argument {a!r}")
    strip_mask(opts["strip"])
    return opts


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts = parse(argv)
        res = run(**opts)
    except (ValueError, RuntimeError) as e:
        print(f"diag_strip: {e}", file=sys.stderr)
        return 1
    print(f"strip='{opts['strip']}' "
          f"{'prefiltered' if opts['prefiltered'] else 'fir=' + opts['fir']} "
          f"K={opts['n_blocks']}{' pretiled' if opts['pretiled'] else ''}: "
          f"median "
          f"{res['median_ms']:8.2f} ms = {res['gsamp_s']:6.2f} Gsamp/s "
          f"({res['ns_step']:6.1f} ns/step)  best {res['best_gsamp_s']:6.2f}"
          f" ({res['best_ms']:.2f} ms); counts "
          f"{'checked' if res['checked'] else 'not checked (stripped)'}; "
          f"{card.smi() if torch.device(opts['device']).type == 'cuda' else 'cpu'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
