"""A dry run of the grid steps on n shards (counterpart of
``dryrun_multichip`` in ``__graft_entry__.py``): that the stream-sharded
step and the streams x time step run on a grid and decode a frame whole.

    python -m gnuais_tpu_torch.dryrun [N] [--device cpu|cuda]

On ``cuda`` the grid takes the visible cards, each repeated round-robin
when there are fewer than n (``devices`` names them explicitly).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from .golden import encoder as E
from .parallel import mesh as M
from .parallel.sharded import (drain_timepar_frames, make_multichip_step,
                               make_sharded_decode)
from .runtime import pipeline as pl


def round_robin(n: int, device: str = "cuda") -> list:
    """n devices of ``device``'s kind: the process's, each repeated in
    turn when there are fewer than n."""
    devs = M.process_devices(device)
    return [devs[i % len(devs)] for i in range(n)]


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     devices: Optional[Sequence] = None) -> None:
    """The 1-D stream-sharded step (kernel B2 on each shard on the card)
    over ``n_devices`` shards on 2 x n streams, each holding one frame;
    then, where n factors into s x t with t > 1, the 2-D step with
    1280-sample shards, overlap and extension, the frame straddling the
    first time shard's boundary: every stream decodes it, its payload
    bits byte-equal to the 1-D result and its CRC good.  Raises
    AssertionError on a mismatch."""
    if devices is None:
        devices = round_robin(n_devices, device)
    devices = list(devices)[:n_devices]
    dev = torch.device(devices[0])
    audio = E.synthesize_capture(
        [E.make_type123(1, 257012345, 59.9139, 10.7522)], gap_bits=16)
    # the 2-D factorisation first, so that T splits over the time axis
    s_ax = max(1, n_devices // 2)
    t_ax = n_devices // s_ax
    t = -(-2560 // t_ax) * t_ax
    assert len(audio) <= t

    # --- 1-D data parallel: streams split over every shard ------------
    s = 2 * n_devices
    batch = np.zeros((s, t), dtype=np.int16)
    batch[:, :len(audio)] = audio
    mesh1 = M.make_stream_mesh(n_devices, devices=devices)
    step1 = make_sharded_decode(mesh1, frame_slots=8, fused_pipeline=True)
    _carry, frames, _peak = step1(torch.from_numpy(batch), t,
                                  pl.init_carry(s, dev))
    got = pl.extract_frames(frames)
    assert all(len(g) == 1 and g[0].crc_ok for g in got), \
        [len(g) for g in got]

    # --- 2-D streams x time: overlap-resync sequence parallelism -------
    # each time shard decodes its own extended window; the halos move
    # between shards; every frame is owned by exactly one shard.  The
    # 1280-sample shards put the frame across the first shard boundary
    if s_ax * t_ax > 1:
        mesh2 = M.make_grid_mesh(s_ax, t_ax, devices=devices)
        s2 = s_ax * 2
        o = e = t_loc = 1280
        tg = t_ax * t_loc
        batch2 = np.zeros((s2, tg), dtype=np.int16)
        batch2[:, :min(len(audio), tg)] = audio[:tg]
        step2 = make_multichip_step(mesh2, frame_slots=8, overlap=o,
                                    extension=e)
        tp = step2(batch2, tg, 0, np.zeros((s2, o), np.int16),
                   np.zeros((s2, e), np.int16))
        got2 = drain_timepar_frames(tp, 8)
        assert all(len(g) == 1 for g in got2), [len(g) for g in got2]
        # the payload's bytes and CRC survive the halos and ownership: a
        # boundary fault that corrupts the words but keeps the count
        # would otherwise pass
        want = np.asarray(got[0][0].payload_bits)
        for g in got2:
            st, _en, fr = g[0]
            assert st < t_loc < st + fr.bufferlen * 5, \
                f"the frame at {st} does not straddle {t_loc}"
            assert fr.crc_ok, "2-D grid frame failed CRC"
            assert np.array_equal(np.asarray(fr.payload_bits), want), \
                "2-D grid payload mismatch"

    print(f"dryrun_multichip({n_devices}): ok (1D streams={n_devices}; "
          f"2D {s_ax}x{t_ax}) on {', '.join(map(str, devices))}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gnuais_tpu_torch.dryrun")
    p.add_argument("n", type=int, nargs="?", default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
