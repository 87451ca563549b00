"""``launch.steps``: host milliseconds of the call to ``prefill_step`` (its
return, before any sync), over the window's batches."""


def read(ctx):
    if not ctx.batches:
        return None
    return 1e3 * sum(b.t_return - b.t_issue for b in ctx.batches) / len(ctx.batches)
