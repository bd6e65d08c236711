"""Driver intake and ack release: host ms per protocol step in the
driver's ``intake_lock_wait`` phase (acquiring the intake's lock in the
submit pump and in the ack release), summed over both threads, over the
protocol steps of the window's untraced part."""


def read(ctx):
    us, steps = ctx["phases"].get("intake_lock_wait"), ctx["part_steps"]
    return us / 1e3 / steps if us and steps else None
