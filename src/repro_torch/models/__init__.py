"""Model zoo: PyTorch definitions of all six families of ``repro/models``
(``dense``, ``moe``, ``ssm``, ``hybrid``, ``encdec``, ``vlm``)."""
from repro_torch.models.model import (
    LM,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    padded_vocab,
)
from repro_torch.models.moe import MoEParams, moe_ffn, route_topk

__all__ = ["LM", "MoEParams", "decode_step", "forward", "init_cache", "init_params", "loss_fn",
           "moe_ffn", "padded_vocab", "route_topk"]
