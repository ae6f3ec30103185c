"""Halo exchange between the time shards of a grid, and the overlap-save
FIR of a time-sharded block (counterpart of
``gnuais_tpu/parallel/halo.py`` and of the two ``ppermute``s of
``gnuais_tpu/parallel/sharded.py``'s step).

The reference's circular-buffer tail copy (filter.c:129-134) carries the
last 36 input samples between sequential blocks; when a long stream is
split across devices along time, that carry becomes a neighbour
exchange: each time shard sends its trailing samples to its right
neighbour (and, for the decode step's tail extension, its leading ones
to its left neighbour), and shard 0 consumes the block-level carried
history.  The FIR is then purely local: the sequential filter's outputs,
bit for bit, at every shard edge.

Within a process a halo moves as a device-to-device copy
(``.to(device, non_blocking=True)``, which orders itself on the two
devices' current streams; through the host only where the cards have no
peer access).  Between processes (a time row whose shards lie on two
ranks of a cluster) it goes through ``torch.distributed`` point to point
on host buffers (``batch_isend_irecv``, the gloo backend: see
``parallel.cluster``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..constants import FIR_LEN
from ..ops import fir as fir_ops
from .mesh import GridMesh, concat_rows, stream_rows

Halos = List[Optional[torch.Tensor]]


def exchange_halos(mesh: GridMesh, tails: Sequence[Optional[torch.Tensor]],
                   heads: Optional[Sequence[Optional[torch.Tensor]]] = None
                   ) -> Tuple[Halos, Halos]:
    """Each time shard's neighbours' edges, on its own device.

    tails, heads: one entry a shard, streams-major (index si * nt + ti),
    the shard's trailing and leading samples on its device, or None for a
    shard that another process runs; all local entries of a list have
    one shape and dtype.  Returns (from_left, from_right) in the same
    layout: shard ti gets shard ti-1's tail and shard ti+1's head (None
    at the row's ends, for shards of other processes, and for
    from_right when ``heads`` is None)."""
    nt = mesh.time
    n = mesh.streams * nt
    from_left: Halos = [None] * n
    from_right: Halos = [None] * n
    remote = []     # (src, dst, kind, send or receive, buffer)
    for kind, edges, out, step in (("tail", tails, from_left, 1),
                                   ("head", heads, from_right, -1)):
        if edges is None:
            continue
        for k in range(n):
            si, ti = divmod(k, nt)
            src_t = ti - step
            if not 0 <= src_t < nt:
                continue
            src = si * nt + src_t
            mine, theirs = mesh.is_local(si, ti), mesh.is_local(si, src_t)
            if mine and theirs:
                out[k] = edges[src].to(mesh.devices[k], non_blocking=True)
            elif mine or theirs:
                remote.append((src, k, kind, mine, edges[k if mine else src]))
    if remote:
        _exchange_remote(mesh, remote, from_left, from_right)
    return from_left, from_right


def _exchange_remote(mesh: GridMesh, remote, from_left: Halos,
                     from_right: Halos) -> None:
    """The halos that cross processes: one ``batch_isend_irecv`` of host
    buffers, each message tagged by its receiving shard and kind."""
    import torch.distributed as dist
    ops, landed = [], []
    for src, dst, kind, receive, local in remote:
        tag = 2 * dst + (kind == "head")
        if receive:
            buf = torch.empty(local.shape, dtype=local.dtype)
            ops.append(dist.P2POp(dist.irecv, buf, mesh.ranks[src], tag=tag))
            landed.append((dst, kind, buf))
        else:
            ops.append(dist.P2POp(dist.isend, local.cpu().contiguous(),
                                  mesh.ranks[dst], tag=tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for dst, kind, buf in landed:
        out = from_left if kind == "tail" else from_right
        out[dst] = buf.to(mesh.devices[dst], non_blocking=True)


def fir_time_sharded(samples: torch.Tensor, history: torch.Tensor,
                     mesh: GridMesh, exact: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FIR of a time-sharded [S, T] block (T split over the time
    axis, S over the streams axis), in one process.

    history: float32 [S, 36], the stream-level carry, which time shard 0
    consumes; every other shard's comes from its left neighbour's last 36
    samples (``exchange_halos``).  Returns (filtered [S, T] float32, the
    new stream-level history [S, 36]: the last time shard's tail), both
    on the device of shard (0, 0), equal to the sequential FIR's."""
    if mesh.multiproc:
        raise ValueError("fir_time_sharded runs a grid of one process")
    s, t = samples.shape
    nt = mesh.time
    if t % nt:
        raise ValueError(f"{t} samples do not split over {nt} time shards")
    t_loc = t // nt
    fir_fn = fir_ops.fir_exact if exact else fir_ops.fir_conv
    xs, tails = [], []
    for k, dev in enumerate(mesh.devices):
        si, ti = divmod(k, nt)
        rows = stream_rows(mesh, s, si)
        x = samples[rows, ti * t_loc:(ti + 1) * t_loc].to(
            dev, non_blocking=True)
        xs.append(x)
        tails.append(x.to(torch.float32)[:, -FIR_LEN:])
    from_left, _ = exchange_halos(mesh, tails)
    rows_out, hist_out = [], []
    for si in range(mesh.streams):
        rows = stream_rows(mesh, s, si)
        parts = []
        for ti in range(nt):
            k = si * nt + ti
            hist = (history[rows].to(mesh.devices[k], non_blocking=True)
                    if ti == 0 else from_left[k])
            parts.append(fir_fn(xs[k], hist)[0])
        dev = mesh.devices[si * nt]
        rows_out.append(torch.cat([p.to(dev) for p in parts], dim=1))
        hist_out.append(tails[si * nt + nt - 1])
    return (concat_rows(rows_out, mesh.device),
            concat_rows(hist_out, mesh.device))
