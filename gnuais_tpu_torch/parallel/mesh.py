"""The streams x time grid of devices (counterpart of
``gnuais_tpu/parallel/mesh.py``).

Axes:
  streams — data parallel over independent capture streams
  time    — sequence parallel over time blocks of one long stream, with
            overlap-save halos (FIR) and carry hand-off (decoder state)

``GridMesh`` is a small descriptor: the axis sizes and the devices in
streams-major order.  The steps of ``sharded`` run on a 1 x 1 grid; a
grid of several devices needs the exchange of halos between them, which
is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..device import resolve_device


@dataclass(frozen=True)
class GridMesh:
    streams: int
    time: int
    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape`` gives them."""
        return {"streams": self.streams, "time": self.time}

    @property
    def device(self) -> torch.device:
        """The device of a 1 x 1 grid."""
        return self.devices[0]


def process_devices(device: torch.device | str = "cuda"
                    ) -> Tuple[torch.device, ...]:
    """The devices of ``device``'s kind that this process has, ``device``
    itself first: every CUDA device (a bare ``cuda`` is the current
    one), or the one CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        first = (dev.index if dev.index is not None
                 else torch.cuda.current_device())
        return (torch.device("cuda", first),) + tuple(
            torch.device("cuda", i)
            for i in range(torch.cuda.device_count()) if i != first)
    return (dev,)


def make_grid_mesh(streams: int, time: int,
                   devices: Optional[Sequence] = None,
                   device: torch.device | str = "cuda") -> GridMesh:
    """A ``streams`` x ``time`` grid over ``devices`` (default: the
    process's devices of ``device``'s kind, ``process_devices``, so that
    a 1 x 1 grid is ``device`` itself).
    Raises ValueError for a grid larger than the devices there are."""
    if streams < 1 or time < 1:
        raise ValueError(f"meshshape {streams} x {time}: both axes must "
                         "be at least 1")
    devs = (tuple(torch.device(d) for d in devices) if devices is not None
            else process_devices(device))
    if streams * time > len(devs):
        raise ValueError(f"meshshape {streams} x {time} needs "
                         f"{streams * time} devices; this process has "
                         f"{len(devs)} ({devs[0].type if devs else device})")
    return GridMesh(streams, time, devs[:streams * time])
