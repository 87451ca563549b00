"""Input stand-ins for every (arch x shape) cell (the port of
``repro/launch/specs.py``).

Each is a tensor on the ``meta`` device with the shape and dtype of the
real input: nothing is allocated.  The dry run lays them out on its mesh
and makes fake tensors of them (``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import LM, init_cache
from repro_torch.optim.adamw import AdamWConfig, adamw_init

META = torch.device("meta")


def params_spec(cfg: ModelConfig) -> LM:
    """The model with its parameters on ``meta``."""
    return LM(cfg, device=META)


def opt_state_spec(cfg: ModelConfig, pspec: LM) -> dict:
    """AdamW's ``{"m", "v", "step"}`` for ``pspec``'s parameters."""
    ocfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
    return adamw_init(dict(pspec.named_parameters()), ocfg)


def batch_spec(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The training / prefill batch of one cell."""
    b, s = shape.global_batch, shape.seq_len

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=META)

    spec = {"labels": sds((b, s), torch.int32)}
    if cfg.family == "encdec":
        spec["tokens"] = sds((b, s), torch.int32)
        spec["frames"] = sds((b, s, cfg.d_model), torch.bfloat16)  # audio stub
    elif cfg.family == "vlm":
        spec["embeds"] = sds((b, s, cfg.d_model), torch.bfloat16)  # patch stub
        spec["positions3"] = sds((b, 3, s), torch.int32)
    else:
        spec["tokens"] = sds((b, s), torch.int32)
    return spec


def cache_spec(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    return init_cache(cfg, shape.global_batch, shape.seq_len, device=META)


def decode_tokens_spec(shape: ShapeConfig) -> torch.Tensor:
    return torch.empty((shape.global_batch, 1), dtype=torch.int32, device=META)


__all__ = ["batch_spec", "cache_spec", "decode_tokens_spec", "opt_state_spec", "params_spec"]
