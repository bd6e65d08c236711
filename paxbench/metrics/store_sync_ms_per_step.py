"""Stable store: host ms per protocol step in the driver's
``store_sync`` phase (the store's fdatasync on the cadence of
``sync_period``), summed over replicas, over the protocol steps of the
window's untraced part."""


def read(ctx):
    us, steps = ctx["phases"].get("store_sync"), ctx["part_steps"]
    return us / 1e3 / steps if us and steps else None
