"""``models.attention``: device milliseconds a traced batch spent in the
attention blocks (``models.attention``: q / k / v, rope, K5, the out
projection): the device operations launched inside those program spans,
from the profiler's trace."""
from perfbench import program_spans


def read(ctx):
    return program_spans.ms_a_batch(ctx, "models.attention")
