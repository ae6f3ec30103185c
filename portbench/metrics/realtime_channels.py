"""Archive throughput: the channels' samples of every block decoded in
the window, over 48,000 samples a second and over the window (host
clock): how many real-time channels the card re-decodes."""


def read(ctx):
    if not ctx.get("blocks") or not ctx.get("window_s"):
        return None
    return (ctx["streams"] * ctx["blocks"] * ctx["block_len"] / 48_000
            / ctx["window_s"])
