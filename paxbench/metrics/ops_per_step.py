"""Engine host loop: requests acked per protocol step over the
window's untraced part (the engine's ``step_index`` advance; a burst of
K fused steps counts K)."""


def read(ctx):
    steps = ctx["part_steps"]
    return ctx["part_acked"] / steps if steps else None
