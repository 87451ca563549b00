"""``models.model``: the model FLOPs of the window's prefills
(``counts/model_<family>.py``) over the window's seconds, as a share of the
card's bf16 peak."""


def read(ctx):
    if not ctx.batches:
        return None
    flops = sum(ctx.model_flops(b.rows, b.length) for b in ctx.batches)
    return 100.0 * flops / (ctx.window_s * ctx.peaks["bf16_flops_per_s"])
