"""Device ms a block of the step in the IQ cell (`decode_block`, fused:
kernel B2, the candidates' compaction, the CRC filter), by CUDA
events."""

from portbench.readers import span_mean


def read(ctx):
    return span_mean(ctx, "step_device")
