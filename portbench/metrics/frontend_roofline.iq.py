"""The IQ front end's share of its roofline: its bound over the window's
blocks (`portbench/iqwork.py`: 8 bytes read an IQ sample and 2 written
an audio sample at 3.35 TB/s, or its operations at 67 TFLOP/s, the
longer) over the device time of its kernels there (`frontend_ms.iq`'s),
in %."""

from portbench.annotations import per_block
from portbench.drivers.archive_iq import FRONTEND


def read(ctx):
    got = per_block(ctx, FRONTEND)
    if got is None or not ctx.get("frontend_bound_ms"):
        return None
    return 100.0 * ctx["frontend_bound_ms"] / (got[1] * ctx["blocks"])
