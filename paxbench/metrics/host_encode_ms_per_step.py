"""Host data plane: host ms per protocol step in the engine's
``host_encode`` phase (taking the batch and packing its rows), over the
protocol steps of the window's untraced part."""


def read(ctx):
    us, steps = ctx["phases"].get("host_encode"), ctx["part_steps"]
    return us / 1e3 / steps if us and steps else None
