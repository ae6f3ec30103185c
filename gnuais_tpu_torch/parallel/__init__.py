"""The throughput and scale-out modes (counterpart of
``gnuais_tpu/parallel``): independent streams over a grid of devices,
and time as a parallel axis of one long stream, by overlap-resync.

- ``mesh``: the streams x time grid of devices (``GridMesh``): distinct
  cards, or logical shards of the CPU; under a cluster, the shards of
  every process.
- ``halo``: the exchange of raw-sample edges between time shards, and
  the overlap-save FIR of a time-sharded block.
- ``sharded``: the stream-sharded decode step, and the streams x time
  step (kernel B2 on every shard) with its host drain.
- ``timepar``: ``time_parallel_decode`` (a whole capture cut into
  overlapped chunk lanes, one kernel B1 call), ``TimeParSession`` and
  ``GroupedTimeParSession`` (super-blocks streamed through the grid's
  step with the exact hand-off at the seams).
- ``cluster``: several processes, one grid, over ``torch.distributed``.
"""

from gnuais_tpu_torch.parallel import mesh  # noqa: F401
