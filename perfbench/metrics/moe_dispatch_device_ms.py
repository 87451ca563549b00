"""``models.moe``: device milliseconds a traced batch spent in the routing,
the dispatch plan and scatter, and the combine (``models.moe.route``,
``models.moe.dispatch``, ``models.moe.combine``): the device operations
launched inside those program spans, from the profiler's trace."""
from perfbench import program_spans


def read(ctx):
    return program_spans.ms_a_batch(ctx, "models.moe.route", "models.moe.dispatch",
                                    "models.moe.combine")
