"""``models.moe``: device milliseconds a traced batch spent in the experts'
three batched products (``models.moe.experts``): the device operations
launched inside those program spans, from the profiler's trace."""
from perfbench import program_spans


def read(ctx):
    return program_spans.ms_a_batch(ctx, "models.moe.experts")
