"""Driver readback thread: host ms per protocol step in the driver's
``readback_idle`` phase (the readback thread waiting for a ticket):
how long the dispatch side and the device hold the readback back, over
the protocol steps of the window's untraced part."""


def read(ctx):
    us, steps = ctx["phases"].get("readback_idle"), ctx["part_steps"]
    return us / 1e3 / steps if us and steps else None
