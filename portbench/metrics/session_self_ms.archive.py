"""Host ms a block in `BatchSession.run` itself (block assembly,
results), less the upload, step, drain and dispatch inside it."""

from portbench.readers import self_ms


def read(ctx):
    return self_ms(ctx, "session", ("upload", "step", "drain", "dispatch"))
