"""``kernels.ssd_scan``: K6's least time at the peaks (``counts/k6.py``)
over its three kernels' device time in the traced sub-window."""


def read(ctx):
    if ctx.trace is None:
        return None
    k6 = ctx.count("k6")
    measured = ctx.trace.kernel_seconds(k6.KERNELS)
    if measured <= 0:
        return None
    return 100.0 * ctx.ideal_s("k6", ctx.traced) / measured
