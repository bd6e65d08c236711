"""Replica step: CUDA kernels the device ran per protocol step over the
traced stretch (memory copies and sets not counted)."""

from paxbench.trace import is_kernel


def read(ctx):
    dt, steps = ctx.get("trace"), ctx.get("trace_steps")
    if dt is None or not steps:
        return None
    n = sum(1 for name, a, b in dt.events
            if is_kernel(name) and b > dt.t0 and a < dt.t1)
    return n / steps if n else None
