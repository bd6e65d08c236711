"""Engine host loop: host ms per protocol step in the engine's
``apply`` phase (``finish``'s replay of committed entries: the window
fetch and one ``decode_window`` per replica, per (group, replica) in a
sharded deployment), over the protocol steps of the window's untraced
part."""


def read(ctx):
    us, steps = ctx["phases"].get("apply"), ctx["part_steps"]
    return us / 1e3 / steps if us and steps else None
