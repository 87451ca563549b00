"""``models.model``: device milliseconds a traced batch spent in the stacking
of the returned cache (``models.cache``): the device operations launched
inside those program spans, from the profiler's trace."""
from perfbench import program_spans


def read(ctx):
    return program_spans.ms_a_batch(ctx, "models.cache")
