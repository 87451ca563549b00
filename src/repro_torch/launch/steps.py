"""The step functions ``train_step``, ``prefill_step`` and ``serve_step``
(the port of ``repro/launch/steps.py``; ``cell_step_and_specs``, the dry
run's, is still to be ported).

``decode_cache_from_prefill`` turns a prefill cache into the decode cache
that ``serve_step`` continues from.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, forward, init_cache, loss_fn
from repro_torch.models.model import check_family
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule


def make_train_step(cfg: ModelConfig, ocfg: Optional[AdamWConfig] = None):
    ocfg = ocfg or AdamWConfig(state_dtype=cfg.opt_state_dtype)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        """One AdamW step on ``loss_fn``'s gradients, the learning rate
        scaled by ``cosine_schedule`` of the step before it (0 at step 0).
        ``params`` is the model, whose parameters must require grad; it and
        ``opt_state`` are updated in place.  Returns ``(params, opt_state,
        {"loss", "nll", "aux"})``."""
        named = dict(params.named_parameters())
        loss, metrics = loss_fn(cfg, params, batch)
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        lr_scale = cosine_schedule(opt_state["step"])
        adamw_update(named, grads, opt_state, ocfg, lr_scale)
        metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch: Dict[str, torch.Tensor]):
        """``(last-position logits (B, V), cache)`` of a batch of prompts
        ``batch["tokens"]`` (B, S)."""
        unported = set(batch) - {"tokens"}
        if unported:
            raise NotImplementedError(
                f"prefill inputs {sorted(unported)} (frontends) are still to be ported (ROADMAP.md)")
        logits, _, cache = forward(cfg, params, batch["tokens"], return_cache=True)
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None, seq_sharded: bool = False):
    if mesh is not None or seq_sharded:
        raise NotImplementedError(
            "the sequence-sharded serve step needs a device mesh; still to be ported (ROADMAP.md)")

    def serve_step(params, tokens, cache):
        """Greedy next token ``(B, 1)`` int32 and the advanced cache."""
        logits, cache = decode_step(cfg, params, tokens, cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return next_tok, cache

    return serve_step


def decode_cache_from_prefill(cfg: ModelConfig, cache: Any, seq_len: int, max_len: int):
    """The decode cache (``init_cache`` layout, ``max_len`` positions) that
    holds a prefill of ``seq_len`` tokens, from ``prefill_step``'s cache."""
    check_family(cfg)
    if cfg.sliding_window and cfg.sliding_window < max_len:
        raise NotImplementedError("a ring-buffer (sliding-window) cache from a prefill")
    if seq_len > max_len:
        raise ValueError(f"prefill of {seq_len} tokens does not fit {max_len} positions")
    if cfg.family == "dense":
        k, v = cache
        b, dev, dtype = k.shape[1], k.device, k.dtype
    elif cfg.family == "ssm":
        b, dev, dtype = cache.shape[1], cache.device, None
    else:
        g_states, (k, v), t_states = cache
        b, dev, dtype = k.shape[1], k.device, k.dtype
    out = init_cache(cfg, b, max_len, dtype=dtype, device=dev)
    out["len"].fill_(seq_len)
    if cfg.family == "dense":
        out["k"][:, :, :seq_len] = k
        out["v"][:, :, :seq_len] = v
    elif cfg.family == "ssm":
        out["state"].copy_(cache)
    else:
        out["g_state"].copy_(g_states)
        out["g_k"][:, :, :seq_len] = k
        out["g_v"][:, :, :seq_len] = v
        if t_states is not None:
            out["t_state"].copy_(t_states)
    return out


__all__ = ["decode_cache_from_prefill", "make_prefill_step", "make_serve_step",
           "make_train_step"]
