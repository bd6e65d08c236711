"""Python runtime: the share of the window the cyclic garbage collector
ran (``gc.callbacks`` start to stop), over the untraced part."""


def read(ctx):
    s = ctx.get("gc_pause_s")
    return None if s is None else 100.0 * s / ctx["part_s"]
