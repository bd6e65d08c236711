"""Engine host loop: host ms per protocol step in the engine's
``device_dispatch`` phase (enqueueing the step's kernels; unfenced, so
host time, not device time), over the protocol steps of the window's
untraced part."""


def read(ctx):
    us, steps = ctx["phases"].get("device_dispatch"), ctx["part_steps"]
    return us / 1e3 / steps if us and steps else None
