"""``launch.steps``: device milliseconds a traced batch spent in the
prefill step outside every ``models.*`` span (``launch.prefill_step`` as
the innermost span: the embedding gather, the positions): the device
operations launched there, from the profiler's trace.  With the other
``*_device_ms`` readings of a cell it sums to the step's device time."""
from perfbench import program_spans


def read(ctx):
    return program_spans.ms_a_batch(ctx, "launch.prefill_step", innermost=True)
