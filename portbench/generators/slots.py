"""The one traffic generator: AIS frames on the SOTDMA slot grid.

A traffic file (``portbench/traffic/<name>.json``) gives the rates and
sizes; ``build`` turns it and a seed into every stream's samples and the
frames each stream carries.

- A slot is ``slot_bits`` bits of ``samples_per_bit`` samples (256 x 5
  = 1280 samples at 48 kHz, ITU-R M.1371-5's 2250 slots a minute), and
  every frame starts on a slot boundary: on the stream's absolute
  5-sample bit grid, as UTC-synchronised transmitters send.
- A stream is periodic over ``cycle_slots`` slots.  A pool of ``pool``
  slot schedules is drawn from the seed: the pool as a whole carries
  ``round(pool * frames_per_channel_second * cycle seconds)`` frames,
  one type 5 (two slots) per ``position_reports_per_static`` position
  reports (types 1-3, one slot), spread as evenly as the counts allow,
  so that every seed offers the same work.  Stream s plays schedule
  ``s % pool`` shifted by whole slots, with its own Gaussian noise of
  ``noise_sigma`` made on the device from the seed.
- Idle is the NRZI level of data 1s: no transitions.  The last slot of
  each schedule stays free; where a schedule toggles the level an odd
  number of times, one lone transition in the middle of that slot
  brings the level back, so that the cycle repeats without a seam.
- Within a schedule the frames lie in free slots drawn at random, with
  no rule on the gaps between them: what the reporting process gives
  within the cycle.  The decoder recovers the bit clock with a DPLL
  that free-runs a 65536th of a bit a bit slow and pulls in only so far
  on a frame's training sequence, so after long idle some frames are
  lost by the plain reference decoder itself, as by gnuais; the check
  judges a stream that falls short against that reference.
- ``damaged_share`` of the frames (position reports) carry one payload
  bit flipped after their CRC was made, as a collision or a weak signal
  leaves them: whole frames with a wrong CRC, which the decoder has to
  count and drop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .. import encoder as E

SEED_TAG = 0x5107


@dataclass
class Frame:
    start: int            # first sample, within the schedule's cycle
    length: int           # samples
    payload: np.ndarray   # payload bits, MSB-first
    msg_type: int
    damaged: bool = False  # one payload bit flipped after the CRC


@dataclass
class Traffic:
    """The generated input: ``samples`` int16 [S, cycle] on the host
    (the stream repeats it), and per stream its pool schedule and its
    shift in samples."""
    samples: np.ndarray
    cycle: int
    pool: List[List[Frame]]
    schedule: np.ndarray      # [S] pool index
    shift: np.ndarray         # [S] samples, a whole number of slots

    def frames(self, stream: int, end: int, damaged: bool = False) -> list:
        """(start, last sample, payload bits) of every frame of
        ``stream`` that starts at or after sample 0 and ends before
        ``end``, in order: the sound frames, or with ``damaged`` the
        damaged ones."""
        out = []
        sh = int(self.shift[stream])
        for fr in self.pool[int(self.schedule[stream])]:
            if fr.damaged != damaged:
                continue
            first = (fr.start + sh) % self.cycle
            for c in range(0, end, self.cycle):
                st = c + first
                if st + fr.length <= end:
                    out.append((st, st + fr.length - 1, fr.payload))
        out.sort(key=lambda f: f[0])
        return out


def _counts(total: int, n: int, rng) -> np.ndarray:
    """``total`` spread over ``n`` bins as evenly as possible, the
    bins that get one more drawn from ``rng``."""
    c = np.full(n, total // n, np.int64)
    c[rng.permutation(n)[:total % n]] += 1
    return c


def _schedule(rng, n_pos: int, n_static: int, t: dict) -> List[tuple]:
    """(first slot, message type) of each frame of one schedule: the
    frames in random free slots of 0 .. cycle_slots - 2."""
    usable = t["cycle_slots"] - 1
    taken = np.zeros(usable, bool)
    out = []
    for k in rng.permutation([5] * n_static + [0] * n_pos).tolist():
        need = 2 if k == 5 else 1
        free = ~taken[:usable - need + 1]
        if need == 2:
            free &= ~taken[1:]
        free = np.flatnonzero(free)
        s = int(free[int(rng.integers(len(free)))])
        taken[s:s + need] = True
        out.append((s, k))
    return sorted(out)


def _pool(t: dict, seed: int):
    """The pool's frames and its clean samples, int16 [pool, cycle]."""
    rng = np.random.default_rng([SEED_TAG, seed])
    p = t["pool"]
    slot = t["slot_bits"]
    cycle_bits = t["cycle_slots"] * slot
    cycle_s = cycle_bits * t["samples_per_bit"] / t["sample_rate"]
    total = round(p * t["frames_per_channel_second"] * cycle_s)
    n_static = round(total / (t["position_reports_per_static"] + 1))
    frames_per = _counts(total, p, rng)
    static_per = np.zeros(p, np.int64)
    carrying = np.flatnonzero(frames_per)
    static_per[carrying] = np.minimum(
        _counts(n_static, len(carrying), rng), frames_per[carrying])
    plans = [_schedule(rng, int(frames_per[i] - static_per[i]),
                       int(static_per[i]), t) for i in range(p)]
    reports = [(i, k) for i, plan in enumerate(plans)
               for k, (_, kind) in enumerate(plan) if kind != 5]
    n_damaged = round(total * t["damaged_share"])
    damaged = {reports[j] for j in
               rng.permutation(len(reports))[:n_damaged].tolist()}
    pool, clean = [], np.empty((p, cycle_bits * t["samples_per_bit"]),
                               np.int16)
    for i, plan in enumerate(plans):
        bits = np.ones(cycle_bits, np.uint8)
        frames = []
        for k, (s, kind) in enumerate(plan):
            mmsi = int(rng.integers(201_000_000, 776_000_000))
            if kind == 5:
                payload = E.static_voyage(rng, mmsi)
            else:
                kind = int(rng.choice(t["position_types"]))
                payload = E.position_report(rng, kind, mmsi)
            flip = None
            if (i, k) in damaged:
                # a 1 turned 0: no more stuffing, the frame keeps its room
                ones = np.flatnonzero(payload)
                flip = int(ones[int(rng.integers(len(ones)))])
            line = E.frame_line_bits(payload, flip)
            room = (2 if kind == 5 else 1) * slot
            if len(line) > room:
                raise ValueError(f"a type {kind} frame of {len(line)} bits "
                                 f"overruns its {room}-bit slots")
            bits[s * slot:s * slot + len(line)] = line
            frames.append(Frame(s * slot * t["samples_per_bit"],
                                len(line) * t["samples_per_bit"], payload,
                                kind, flip is not None))
        if (bits == 0).sum() % 2:
            bits[cycle_bits - slot // 2] = 0     # the lone transition
        levels = E.nrzi_levels(bits).astype(np.int16) * 2 - 1
        clean[i] = np.repeat(levels * t["amplitude"], t["samples_per_bit"])
        pool.append(frames)
    return pool, clean


def build(t: dict, n_streams: int, seed: int, device: torch.device,
          rows_per_chunk: int = 512) -> Traffic:
    """Every stream's cycle of samples on the host (pageable memory, as a
    recording read from disk), made on ``device`` from ``seed``."""
    pool, clean = _pool(t, seed)
    cycle = clean.shape[1]
    slot = t["slot_bits"] * t["samples_per_bit"]
    rng = np.random.default_rng([SEED_TAG, seed, 1])
    schedule = np.arange(n_streams) % t["pool"]
    shift = rng.integers(0, t["cycle_slots"], n_streams) * slot
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    dev_clean = torch.from_numpy(clean).to(device)
    host = np.empty((n_streams, cycle), np.int16)
    out = torch.from_numpy(host)
    tt = torch.arange(cycle, device=device)
    for r0 in range(0, n_streams, rows_per_chunk):
        r1 = min(r0 + rows_per_chunk, n_streams)
        sh = torch.from_numpy(shift[r0:r1]).to(device)
        idx = (tt[None, :] - sh[:, None]) % cycle
        rows = torch.from_numpy(schedule[r0:r1]).to(device)
        x = torch.gather(dev_clean[rows], 1, idx).to(torch.float32)
        x += t["noise_sigma"] * torch.randn(x.shape, generator=g,
                                            device=device)
        out[r0:r1] = x.round_().clamp_(-32768, 32767).to(torch.int16).cpu()
        del x, idx
    return Traffic(host, cycle, pool, schedule, shift)
