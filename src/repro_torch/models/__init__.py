"""Model zoo: PyTorch definitions of the ``dense``, ``ssm`` and ``hybrid``
families (the port of ``repro/models``); the other families are still to
be ported."""
from repro_torch.models.model import (
    LM,
    decode_step,
    forward,
    init_cache,
    init_params,
    padded_vocab,
)

__all__ = ["LM", "decode_step", "forward", "init_cache", "init_params", "padded_vocab"]
