"""Faults planted under the timed path, for the control and the tests
that show a broken program comes out not correct.  Each wraps the
function of the program that produces the per-stream frame lists of one
step (``BatchPipeline.drain``) or that hands the step's state on:

- ``drop``: the control; the last frame of each stream of a step is
  not delivered (each frame exactly once, the configuration's
  guarantee);
- ``alter``: one payload bit of one frame a step is flipped;
- ``half``: the second half of the streams' frames are left out;
- ``stale``: the step hands its state on unchanged.
"""

from __future__ import annotations

import copy

FAULTS = ("drop", "alter", "half", "stale")


def _frame(item):
    """A drained item's Frame: ``Frame`` or ``(start, end, Frame)``."""
    return item[2] if isinstance(item, tuple) else item


def _altered(item):
    fr = copy.copy(_frame(item))
    fr.payload_bits = fr.payload_bits.copy()
    fr.payload_bits[40] ^= 1
    return (item[0], item[1], fr) if isinstance(item, tuple) else fr


def output_fault(name: str, produce):
    """``produce`` (returns per-stream lists, or None) with fault
    ``name`` applied to what it returns."""
    def wrapped(*args, **kwargs):
        out = produce(*args, **kwargs)
        if out is None:
            return out
        out = [list(lst) for lst in out]
        hit = next((i for i, lst in enumerate(out) if lst), None)
        if name == "drop":
            for lst in out:
                if lst:
                    lst.pop()
        elif name == "alter" and hit is not None:
            out[hit][0] = _altered(out[hit][0])
        elif name == "half":
            for i in range(len(out) // 2, len(out)):
                out[i] = []
        return out
    return wrapped


def stale_state(obj, attrs, fn):
    """``fn`` with ``obj``'s ``attrs`` put back after each call, as a
    step that returns its state unchanged."""
    def wrapped(*args, **kwargs):
        keep = {a: getattr(obj, a) for a in attrs}
        out = fn(*args, **kwargs)
        for a, v in keep.items():
            setattr(obj, a, v)
        return out
    return wrapped
