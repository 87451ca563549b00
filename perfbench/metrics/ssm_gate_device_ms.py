"""``models.ssm``: device milliseconds a traced batch spent in the Mamba2
blocks' gate (``models.ssm.gate``: the D skip, the silu(z) gate, the gated
RMSNorm and the cast, without the output projection), from the profiler's
trace.  Part of ``mamba_layers_device_ms``; nothing where the program opens
no such span."""
from perfbench import program_spans


def read(ctx):
    return program_spans.ms_a_batch(ctx, "models.ssm.gate")
