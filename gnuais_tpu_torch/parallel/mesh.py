"""The streams x time grid of devices (counterpart of
``gnuais_tpu/parallel/mesh.py``).

Axes:
  streams — data parallel over independent capture streams
  time    — sequence parallel over time blocks of one long stream, with
            overlap-save halos (FIR) and carry hand-off (decoder state)

``GridMesh`` is a small descriptor: the axis sizes, each shard's device
in streams-major order, and under a cluster (``parallel.cluster``) the
process rank that owns each shard.  On the card a grid takes distinct
cards; on the CPU a grid of any size is that many logical shards of the
one CPU device, run in turn (the counterpart of the JAX package's
virtual CPU devices).  An explicit ``devices`` list may name a card more
than once.

The JAX module's ``stream_sharding``, ``carry_sharding`` and
``replicated`` are sharding objects that place arrays; here the steps
place each shard's rows themselves: ``stream_rows`` gives the rows of a
streams shard, ``split_rows`` cuts a tensor (or a pytree of them) into
them, and ``concat_rows`` puts the pieces back in row order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device


@dataclass(frozen=True)
class GridMesh:
    streams: int
    time: int
    devices: Tuple[torch.device, ...]  # a shard's device, streams-major
    ranks: Tuple[int, ...] = ()        # each shard's process; () in one
    rank: int = 0                      # this process

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape`` gives them."""
        return {"streams": self.streams, "time": self.time}

    @property
    def device(self) -> torch.device:
        """The device of shard (0, 0): a 1 x 1 grid's one device."""
        return self.devices[0]

    def shard_device(self, si: int, ti: int) -> torch.device:
        return self.devices[si * self.time + ti]

    def shard_rank(self, si: int, ti: int) -> int:
        return self.ranks[si * self.time + ti] if self.ranks else 0

    def is_local(self, si: int, ti: int) -> bool:
        """Whether this process runs shard (si, ti)."""
        return self.shard_rank(si, ti) == self.rank

    @property
    def multiproc(self) -> bool:
        """Whether the grid belongs to a cluster of several processes
        (``ranks`` is set only there; a process may own no shard)."""
        return bool(self.ranks)

    def local_streams(self) -> List[int]:
        """The streams shards this process runs (by their time shard 0)."""
        return [si for si in range(self.streams) if self.is_local(si, 0)]


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
    """A ``streams`` x ``time`` grid.  On ``cuda`` it takes distinct
    cards, the process's (``process_devices``, so that a 1 x 1 grid is
    ``device`` itself), and raises ValueError for a grid larger than the
    cards there are; on ``cpu`` a grid of any size is streams x time
    logical shards of the CPU.  An explicit ``devices`` list is taken
    as it is (a card may repeat) and must hold streams x time."""
    if streams < 1 or time < 1:
        raise ValueError(f"meshshape {streams} x {time}: both axes must "
                         "be at least 1")
    n = streams * time
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
    else:
        devs = process_devices(device)
        if devs[0].type == "cpu":
            devs = devs * n
    if n > len(devs):
        raise ValueError(f"meshshape {streams} x {time} needs {n} devices; "
                         f"this process has {len(devs)} "
                         f"({devs[0].type if devs else device})")
    return GridMesh(streams, time, devs[:n])


def make_stream_mesh(n_devices: Optional[int] = None,
                     device: torch.device | str = "cuda",
                     devices: Optional[Sequence] = None) -> GridMesh:
    """An n x 1 grid: the streams axis alone (default: every device of
    ``device``'s kind, or of ``devices``)."""
    if n_devices is None:
        n_devices = len(devices if devices is not None
                        else process_devices(device))
    return make_grid_mesh(n_devices, 1, devices=devices, device=device)


def stream_rows(mesh: GridMesh, n_rows: int, si: int) -> slice:
    """The rows of streams shard ``si`` in an [n_rows, ...] batch; raises
    ValueError when the streams axis does not divide n_rows (as a JAX
    shard_map does)."""
    if n_rows % mesh.streams:
        raise ValueError(f"{n_rows} rows do not split over the "
                         f"{mesh.streams} streams shards")
    per = n_rows // mesh.streams
    return slice(si * per, (si + 1) * per)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(_tree_map(fn, v) for v in tree))


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for v in tree for x in _leaves(v)]


def split_rows(tree, rows: slice, device: torch.device):
    """Rows ``rows`` of every tensor of ``tree`` (a tensor or nested
    NamedTuples of them), on ``device``."""
    return _tree_map(lambda x: x[rows].to(device, non_blocking=True), tree)


def concat_rows(trees: Sequence, device: torch.device, dim: int = 0):
    """The pieces ``trees`` (same structure, streams-shard order) put
    back along ``dim`` on ``device``."""
    first = trees[0]
    flat = [_leaves(t) for t in trees]
    cat = iter([torch.cat([f[i].to(device) for f in flat], dim=dim)
                for i in range(len(flat[0]))])
    return _tree_map(lambda _x: next(cat), first)
