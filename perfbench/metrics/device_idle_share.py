"""``device``: the share of the traced sub-window in which no device
operation ran (one minus the union of their intervals)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
