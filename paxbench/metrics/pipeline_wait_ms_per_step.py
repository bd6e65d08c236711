"""Engine host loop: host ms per protocol step in the driver's
``pipeline_wait`` phase (the dispatch thread blocked on tickets in
flight, or draining them before a serial step): how long the readback
side holds the dispatch back, over the protocol steps of the window's
untraced part."""


def read(ctx):
    us, steps = ctx["phases"].get("pipeline_wait"), ctx["part_steps"]
    return us / 1e3 / steps if us and steps else None
