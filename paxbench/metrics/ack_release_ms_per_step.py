"""Driver intake and ack release: host ms per protocol step in the
driver's ``apply_replay_ack`` phase (store append, replay plan and ack
release; the release's own ``ack_release`` phase runs inside it, so it
is not added again), summed over replicas, over the protocol steps of
the window's untraced part."""


def read(ctx):
    us, steps = ctx["phases"].get("apply_replay_ack"), ctx["part_steps"]
    return us / 1e3 / steps if us and steps else None
