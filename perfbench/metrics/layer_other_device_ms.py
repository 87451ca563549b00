"""``models.model``: device milliseconds a traced batch spent in the layers
outside their inner spans (``models.layer.shared``, ``models.layer.moe``
as the innermost span: the shared block's MLP and norms, the MoE layers'
norms and residual adds): the device operations launched there, from the
profiler's trace."""
from perfbench import program_spans


def read(ctx):
    return program_spans.ms_a_batch(ctx, "models.layer.shared", "models.layer.moe",
                                    innermost=True)
