"""Arithmetic shared by the metric readers in ``portbench/metrics/``.
A reader returns None where its run recorded nothing to read."""

from __future__ import annotations

import statistics
from typing import Optional, Sequence

# the hand-written kernel of B1 and B2 (csrc/pipeline_kernel.cuh); the
# cells here launch B2 only
B2_KERNEL = "pipeline_kernel"


def span_mean(ctx: dict, name: str) -> Optional[float]:
    spans = ctx.get("spans")
    return spans.mean(name) if spans is not None else None


def self_ms(ctx: dict, outer: str, inner: Sequence[str]) -> Optional[float]:
    """The mean over units of ``outer`` less its child spans."""
    spans = ctx.get("spans")
    if spans is None or not any(outer in u for u in spans.units):
        return None
    return statistics.fmean(u.get(outer, 0.0) - sum(u.get(k, 0.0)
                                                     for k in inner)
                            for u in spans.units)


def b2_roofline(ctx: dict) -> Optional[float]:
    """B2's bound over its device time in the traced window, in %."""
    prof, spans = ctx.get("profile"), ctx.get("spans")
    if not prof or spans is None:
        return None
    kernel_us = sum(us for name, us in prof["by_name"].items()
                    if B2_KERNEL in name)
    bound_ms = sum(u.get("b2_bound_ms", 0.0) for u in spans.units)
    if kernel_us <= 0 or bound_ms <= 0:
        return None
    return 100.0 * bound_ms / (kernel_us / 1e3)


def device_idle(ctx: dict) -> Optional[float]:
    """The device's idle share of the traced window, in %."""
    prof = ctx.get("profile")
    if not prof or prof["wall_us"] <= 0 or prof["busy_us"] <= 0:
        return None
    return 100.0 * prof["idle_share"]

