"""Health and alert plane: host ms per protocol step in the driver's
``cadence`` phase (alert evaluation, series sampling, profile expiry,
health files with their ``blame``), over the protocol steps of the
window's untraced part."""


def read(ctx):
    us, steps = ctx["phases"].get("cadence"), ctx["part_steps"]
    return us / 1e3 / steps if us and steps else None
