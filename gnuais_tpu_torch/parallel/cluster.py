"""Several processes, one grid (counterpart of
``gnuais_tpu/parallel/cluster.py``).

The reference is strictly single-node; its multi-host analog here is a
fleet of processes, one or more a host, each ingesting the capture and
decoding on its own devices, with one global grid for the step's halos,
its frame outputs and the counters.

Design:
 - every process runs the same program; ``initialize`` joins them in a
   ``torch.distributed`` process group (the address, size and rank are
   given: nothing else tells a process of the cluster);
 - the global grid is rank-major over each process's devices: its
   visible cards (``CUDA_VISIBLE_DEVICES``), or logical shards of the
   CPU.  ``plan_mesh_axes`` keeps a time row's neighbours on one
   process where it can;
 - each process runs only its own shards; the halos that cross
   processes and the step's frame outputs go between them, and every
   process drains the identical global result (``sharded``);
 - the counters reduce with one collective a report interval.

Why gloo, on host buffers: the traffic is small (a halo is a few KB a
push: overlap x rows of int16; the frame outputs a few KB more) and the
drain that reads it is on the host anyway, so a copy through host memory
costs little; gloo runs the same code on the CPU (the tests) and on the
card, and lets two processes share one card.  Device-side halos over
NCCL are later work (ROADMAP).  The group's ``timeout`` bounds how long a
process waits in a collective for a peer that has failed.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import GridMesh, process_devices

# how long a process waits in a collective for a peer before it fails
TIMEOUT_S = 300.0


@dataclasses.dataclass
class ClusterConfig:
    coordinator_address: Optional[str] = None   # "host:port"
    num_processes: int = 1
    process_id: int = 0


def initialize(cfg: ClusterConfig) -> None:
    """Join the process group (gloo, over TCP at the coordinator's
    address); a no-op for one process."""
    if cfg.num_processes > 1 and not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{cfg.coordinator_address}",
            world_size=cfg.num_processes, rank=cfg.process_id,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def plan_mesh_axes(n_devices: int, devices_per_host: int,
                   time_shards: int = 1) -> Tuple[int, int]:
    """Choose (streams, time) axis sizes for n_devices in all.

    time_shards devices cooperate on one long stream through halo
    exchange; keeping time_shards <= devices_per_host keeps every halo
    between devices of one process, off the network."""
    if time_shards > devices_per_host:
        raise ValueError(
            f"time_shards={time_shards} > devices_per_host="
            f"{devices_per_host}: halos would cross hosts; shard streams "
            "instead")
    if n_devices % time_shards:
        raise ValueError("time_shards must divide device count")
    return n_devices // time_shards, time_shards


def local_devices(device: torch.device | str = "cuda",
                  shards: int = 1) -> Tuple[torch.device, ...]:
    """This process's devices: every card it sees, or ``shards``
    logical shards of the CPU."""
    devs = process_devices(device)
    return devs * shards if devs[0].type == "cpu" else devs


def make_cluster_mesh(time_shards: int = 1,
                      devices: Optional[Sequence] = None,
                      device: torch.device | str = "cuda",
                      streams: Optional[int] = None) -> GridMesh:
    """The (streams, time) grid over every process's devices (``devices``,
    default ``local_devices(device)``), rank-major, so that neighbouring
    time shards share a process.  The processes gather each other's
    device lists; unequal counts raise ValueError.  Without ``streams``
    the axes come from ``plan_mesh_axes`` over all the devices; with it
    the grid is streams x time_shards over the first of them (ValueError
    when there are fewer)."""
    local = [str(torch.device(d)) for d in
             (devices if devices is not None else local_devices(device))]
    world = process_count()
    if world > 1:
        lists = [None] * world
        dist.all_gather_object(lists, local)
    else:
        lists = [local]
    counts = [len(x) for x in lists]
    if len(set(counts)) > 1:
        raise ValueError(f"the processes have unequal device counts "
                         f"{counts}")
    per = counts[0]
    every = [torch.device(d) for x in lists for d in x]
    if streams is None:
        streams, time_shards = plan_mesh_axes(len(every), per, time_shards)
    n = streams * time_shards
    if n > len(every):
        raise ValueError(f"meshshape {streams} x {time_shards} needs {n} "
                         f"devices; the cluster's {world} process(es) have "
                         f"{len(every)}")
    ranks = tuple(r for r in range(world) for _ in range(per))[:n]
    return GridMesh(streams, time_shards, tuple(every[:n]),
                    ranks if world > 1 else (), process_index())


def local_stream_rows(mesh: GridMesh, n_streams: int) -> slice:
    """The rows of the global [n_streams, T] batch this process feeds
    and drains (host-local ingest contract)."""
    procs = sorted(set(mesh.ranks)) or [mesh.rank]
    rows_per_proc = n_streams // len(procs)
    i = procs.index(mesh.rank)
    return slice(i * rows_per_proc, (i + 1) * rows_per_proc)


def global_counter_sum(local: np.ndarray) -> np.ndarray:
    """Sum small host counters over the cluster (one all-reduce a stats
    interval)."""
    if process_count() == 1:
        return local
    t = torch.from_numpy(np.array(local, copy=True))
    dist.all_reduce(t)
    return t.numpy()
