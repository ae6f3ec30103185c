"""Ms a block in which Python's cyclic garbage collector ran, over the
whole process (``gc.callbacks``): the program's garbage against the heap
of a process that has loaded PyTorch."""


def read(ctx):
    if not ctx.get("blocks"):
        return None
    return 1e3 * ctx["gc_s"] / ctx["blocks"]
