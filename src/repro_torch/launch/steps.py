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
from repro_torch.models.model import DENSE_LAYOUT
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule


def param_grads(loss, named: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
    """``{name: d loss / d parameter}`` over ``named``.  Under ``embeds``
    (the vlm's prompt) the token embedding is the one parameter the loss
    may not reach; it then gets a zero gradient, as ``jax.grad`` gives it.
    Any other parameter the loss does not reach raises."""
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused="embeds" in batch)
    unused = [n for n, g in zip(named, grads) if g is None]
    if unused and unused != ["embed"]:
        raise RuntimeError(f"the loss does not reach {unused}")
    return {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named.items(), grads)}


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
        grads = param_grads(loss, named, batch)
        lr_scale = cosine_schedule(opt_state["step"])
        adamw_update(named, grads, opt_state, ocfg, lr_scale)
        metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch: Dict[str, torch.Tensor]):
        """``(last-position logits (B, V), cache)`` of a batch of prompts:
        ``tokens`` (B, S) or ``embeds`` (B, S, D), with ``positions3`` (B,
        3, S) and ``frames`` (B, Se, D) where the family takes them."""
        logits, _, cache = forward(cfg, params, batch.get("tokens"), embeds=batch.get("embeds"),
                                   positions3=batch.get("positions3"),
                                   encoder_frames=batch.get("frames"), return_cache=True)
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


def _fill_kv(k_cache, v_cache, k, v, seq_len: int, window: int):
    """Write the prefill's ``k`` / ``v`` (L, B, S, KV, hd) into a decode
    cache: position p at slot p, or, in a ring of ``window`` slots, the last
    ``window`` positions each at slot ``p % window``."""
    if window and seq_len > window:
        pos = torch.arange(seq_len - window, seq_len, device=k.device)
        k_cache[:, :, pos % window] = k[:, :, pos]
        v_cache[:, :, pos % window] = v[:, :, pos]
    else:
        k_cache[:, :, :seq_len] = k
        v_cache[:, :, :seq_len] = v


def decode_cache_from_prefill(cfg: ModelConfig, cache: Any, seq_len: int, max_len: int):
    """The decode cache (``init_cache`` layout, ``max_len`` positions) that
    holds a prefill of ``seq_len`` tokens, from ``prefill_step``'s cache.

    With a sliding window shorter than ``max_len`` the self-attention
    cache is a ring of ``window`` slots: a prefill longer than the window
    keeps its last ``window`` positions, position p at slot ``p %
    window``, with ``len = seq_len``, the keys the prefill's last query
    saw.  (Like the JAX package's, ``decode_step`` takes its ring branch
    only where the cache holds more than the window, so the steps after
    such a prefill write the last slot.)

    ``encdec``: the cross-attention cache ``xk`` / ``xv`` holds the
    encoder's ``Se`` positions of the prefill, not ``max_len``, and ``xlen
    = Se``: the JAX package's ``init_cache`` sizes it by ``max_len``, but
    its ``decode_step`` reads any length, and whisper's 1,500 frames are
    longer than any decoder cache."""
    if seq_len > max_len:
        raise ValueError(f"prefill of {seq_len} tokens does not fit {max_len} positions")
    if cfg.family == "ssm":
        b, dev, dtype = cache.shape[1], cache.device, None
    else:
        if cfg.family in DENSE_LAYOUT:
            k, v = cache
        elif cfg.family == "encdec":
            (k, v), (xk, xv) = cache
        else:
            g_states, (k, v), t_states = cache
        b, dev, dtype = k.shape[1], k.device, k.dtype
    out = init_cache(cfg, b, max_len, dtype=dtype, device=dev)
    out["len"].fill_(seq_len)
    window = cfg.sliding_window if cfg.sliding_window and cfg.sliding_window < max_len else 0
    if cfg.family == "ssm":
        out["state"].copy_(cache)
    elif cfg.family == "hybrid":
        out["g_state"].copy_(g_states)
        _fill_kv(out["g_k"], out["g_v"], k, v, seq_len, window)
        if t_states is not None:
            out["t_state"].copy_(t_states)
    else:
        _fill_kv(out["k"], out["v"], k, v, seq_len, window)
    if cfg.family == "encdec":
        out["xk"], out["xv"] = xk.clone(), xv.clone()
        out["xlen"].fill_(xk.shape[2])
    return out


__all__ = ["decode_cache_from_prefill", "make_prefill_step", "make_serve_step",
           "make_train_step", "param_grads"]
