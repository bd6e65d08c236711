"""Device: the share of the traced stretch in which nothing ran on the
card (one minus the union of its activity intervals)."""

from paxbench.trace import busy_intervals


def read(ctx):
    dt = ctx.get("trace")
    if dt is None or dt.window_s <= 0:
        return None
    busy = sum(b - a for a, b in busy_intervals(dt.events, dt.t0, dt.t1))
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / dt.window_s)
