"""Driver readback thread: host ms per protocol step in the engine's
``finish_rules`` and the driver's ``post_step_rules`` phases (the
per-step host rules outside the readback, the replay, the store, the
ack release and the cadence), over the protocol steps of the window's
untraced part."""

PHASES = ("finish_rules", "post_step_rules")


def read(ctx):
    got = [ctx["phases"][p] for p in PHASES if p in ctx["phases"]]
    steps = ctx["part_steps"]
    return sum(got) / 1e3 / steps if got and steps else None
