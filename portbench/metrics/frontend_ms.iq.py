"""Device ms a block of the kernels launched under the program's
`gnuais.iq.frontend` annotation (`runtime.batch.BatchSession`'s front
end: `ops.discriminator`'s discriminator, decimator and rounding), from
the profiler's trace (`portbench/annotations.py`)."""

from portbench.annotations import per_block
from portbench.drivers.archive_iq import FRONTEND


def read(ctx):
    got = per_block(ctx, FRONTEND)
    return None if got is None else got[1]
