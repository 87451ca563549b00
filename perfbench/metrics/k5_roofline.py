"""``kernels.flash_attn``: K5's least time at the peaks (``counts/k5.py``)
over its device time in the traced sub-window."""


def read(ctx):
    if ctx.trace is None:
        return None
    k5 = ctx.count("k5")
    measured = ctx.trace.kernel_seconds(k5.KERNELS)
    if measured <= 0:
        return None
    return 100.0 * ctx.ideal_s("k5", ctx.traced) / measured
