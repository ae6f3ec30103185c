"""Set-up: process start to the window's start (host clock)."""


def read(ctx):
    return ctx.get("setup_s")
