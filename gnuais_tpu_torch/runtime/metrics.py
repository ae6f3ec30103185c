"""Receiver metrics: best-range tracking, audio level monitoring, and
frame counters — the reference's runtime self-diagnostics surface
(range.c, receiver.c:137-147, ais.c:250-262,296-310) plus TPU-side
throughput accounting.
"""

from __future__ import annotations

import logging
import math
import time as time_mod
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

log = logging.getLogger("gnuais")


def _f32(x: float) -> np.float32:
    return np.float32(x)


def maidenhead_km_distance(lat1: float, lon1: float, lat2: float,
                           lon2: float) -> float:
    """Great-circle km with the reference's float32 promotion chain
    (range.c:18-30): all four inputs are float parameters, differences
    are float subtractions, the *0.5 happens in double and rounds back
    through sinf.  Inputs in radians."""
    lat1, lon1 = _f32(lat1), _f32(lon1)
    lat2, lon2 = _f32(lat2), _f32(lon2)
    sindlat2 = _f32(math.sin(float(_f32(lat1 - lat2)) * 0.5))
    sindlon2 = _f32(math.sin(float(_f32(lon1 - lon2)) * 0.5))
    coslat1 = _f32(math.cos(float(lat1)))
    coslat2 = _f32(math.cos(float(lat2)))
    a = _f32(_f32(sindlat2 * sindlat2)
             + _f32(_f32(coslat1 * coslat2) * _f32(sindlon2 * sindlon2)))
    c = _f32(2.0) * _f32(math.atan2(float(_f32(math.sqrt(a))),
                                    float(_f32(math.sqrt(_f32(1.0) - a)))))
    return float(_f32(_f32(111.2 * 180.0 / math.pi) * _f32(c)))


class RangeTracker:
    """Per-channel best-range with the reference's bad-fix filters
    (range.c:32-45) and StatsInterval logging+reset (range.c:47-53)."""

    def __init__(self, chanid: str, mylat_deg: Optional[float] = None,
                 mylng_deg: Optional[float] = None):
        self.chanid = chanid
        self.best_range = 0.0
        self.enabled = (mylat_deg is not None and mylng_deg is not None
                        and -90 < mylat_deg < 90 and -180 < mylng_deg < 180)
        if self.enabled:
            # lat2rad: float input times double PI/180, stored as float
            # (range.c:8-16 via cfg.c:366-367)
            self.mylat = float(_f32(float(_f32(mylat_deg)) * (math.pi / 180.0)))
            self.mylng = float(_f32(float(_f32(mylng_deg)) * (math.pi / 180.0)))

    def update(self, lat_deg: float, lon_deg: float) -> None:
        if not self.enabled:
            return
        if lat_deg > 89.0 or lat_deg < -89.0 or lon_deg > 180.01 or lon_deg < -180.01:
            return
        if -0.001 < lat_deg < 0.001 and -0.001 < lon_deg < 0.001:
            return
        lat_r = float(_f32(float(_f32(lat_deg)) * (math.pi / 180.0)))
        lon_r = float(_f32(float(_f32(lon_deg)) * (math.pi / 180.0)))
        d = maidenhead_km_distance(self.mylat, self.mylng, lat_r, lon_r)
        if d > self.best_range:
            self.best_range = d

    def log_and_reset(self) -> Optional[str]:
        msg = None
        if self.best_range > 0.1:
            msg = f"Best range ch {self.chanid}: {self.best_range:.1f} km"
            log.info(msg)
        self.best_range = 0.0
        return msg


class LevelMonitor:
    """Input-level logging: warn above 95% at most every 30 s, info at
    the configured soundlevellog interval (receiver.c:137-147)."""

    def __init__(self, chanid: str, sound_levellog: int = 0):
        self.chanid = chanid
        self.sound_levellog = sound_levellog
        self.last_levellog = 0.0

    def observe(self, maxval: int, now: Optional[float] = None) -> Optional[str]:
        now = now if now is not None else time_mod.time()
        level = float(maxval) / 32768.0 * 100.0
        distance = now - self.last_levellog
        msg = None
        if level > 95.0 and (distance >= 30 or distance >= self.sound_levellog):
            msg = f"Level on ch {self.chanid} too high: {level:.0f} %"
            log.warning(msg)
            self.last_levellog = now
        elif self.sound_levellog != 0 and distance >= self.sound_levellog:
            msg = f"Level on ch {self.chanid}: {level:.0f} %"
            log.info(msg)
            self.last_levellog = now
        return msg


@dataclass
class ThroughputMeter:
    """samples/s accounting for the TPU pipeline."""
    samples: int = 0
    seconds: float = 0.0

    def add(self, n_samples: int, dt: float) -> None:
        self.samples += n_samples
        self.seconds += dt

    @property
    def samples_per_sec(self) -> float:
        return self.samples / self.seconds if self.seconds else 0.0

    @property
    def realtime_factor(self) -> float:
        return self.samples_per_sec / 48_000.0
