"""The throughput modes (counterpart of ``gnuais_tpu/parallel``): time
as a parallel axis of one long stream, by overlap-resync.

- ``timepar.time_parallel_decode``: a whole capture cut into overlapped
  chunk lanes decoded as the batch of one kernel B1 call.
- ``timepar.TimeParSession``: super-blocks streamed through the
  streams x time step of ``sharded`` (kernel B2) with the exact carry
  hand-off at the seams.
- ``mesh.make_grid_mesh``: the streams x time grid of devices.  One
  device (a 1 x 1 grid) for now: the exchange of halos between devices
  is not ported yet.
"""

from gnuais_tpu_torch.parallel import mesh  # noqa: F401
