"""The step functions ``train_step``, ``prefill_step`` and ``serve_step``,
and ``cell_step_and_specs``, the step and inputs of one dry-run cell (the
port of ``repro/launch/steps.py``).

``decode_cache_from_prefill`` turns a prefill cache into the decode cache
that ``serve_step`` continues from.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.obs import spans as obs
from repro_torch.launch import specs
from repro_torch.models import decode_step, forward, init_cache, loss_fn
from repro_torch.models.model import DENSE_LAYOUT
from repro_torch.models.sharding import (
    argmax_last,
    batch_shardings,
    cache_shardings,
    params_shardings,
    step_context,
    whole,
)
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
        {"loss", "nll", "aux"})``.  With DTensor parameters (a sharding plan on a
        device mesh) the step runs on the mesh, the batch laid out by its
        plan, and the gradient all-reduce is DTensor's."""
        named = dict(params.named_parameters())
        with step_context(params):
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
        3, S) and ``frames`` (B, Se, D) where the family takes them.  Runs
        in the span ``launch.prefill_step``."""
        with obs.span("launch.prefill_step"):
            with step_context(params):
                logits, _, cache = forward(cfg, params, batch.get("tokens"),
                                           embeds=batch.get("embeds"),
                                           positions3=batch.get("positions3"),
                                           encoder_frames=batch.get("frames"),
                                           return_cache=True)
            return logits[:, -1], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None, seq_sharded: bool = False):
    def serve_step(params, tokens, cache):
        """Greedy next token ``(B, 1)`` int32 and the advanced cache (with
        ``seq_sharded``, this rank's sequence shards of the attention
        caches over ``mesh``'s ``data`` axis)."""
        with step_context(params):
            logits, cache = decode_step(cfg, params, tokens, cache, mesh=mesh,
                                        seq_sharded=seq_sharded)
            next_tok = argmax_last(logits[:, -1]).to(torch.int32)[:, None]
        return whole(next_tok), cache  # a DTensor: every rank takes the tokens

    return serve_step


def _fill_kv(k_cache, v_cache, k, v, seq_len: int, window: int, start: int = 0):
    """Write the prefill's ``k`` / ``v`` (L, B, S, KV, hd) into a decode
    cache: position p at slot p - ``start`` (a sequence shard holds the
    positions from ``start`` on), or, in a ring of ``window`` slots, the
    last ``window`` positions each at slot ``p % window``."""
    if window and seq_len > window:
        pos = torch.arange(seq_len - window, seq_len, device=k.device)
        k_cache[:, :, pos % window] = k[:, :, pos]
        v_cache[:, :, pos % window] = v[:, :, pos]
    else:
        hi = min(seq_len, start + k_cache.shape[2])
        if hi > start:
            k_cache[:, :, :hi - start] = k[:, :, start:hi]
            v_cache[:, :, :hi - start] = v[:, :, start:hi]


def decode_cache_from_prefill(cfg: ModelConfig, cache: Any, seq_len: int, max_len: int,
                              seq_shard: Optional[Tuple[int, int]] = None):
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
    longer than any decoder cache.

    ``seq_shard=(i, n)``: rank i's part of the cache split by sequence over
    n ranks (``decode_step(mesh=, seq_sharded=True)``): the attention
    caches hold positions ``[i max_len / n, (i + 1) max_len / n)`` only, so
    no rank allocates the whole; ``len`` and the SSM states are whole."""
    if seq_len > max_len:
        raise ValueError(f"prefill of {seq_len} tokens does not fit {max_len} positions")
    start = 0
    if seq_shard is not None:
        i, n = seq_shard
        if max_len % n or cfg.sliding_window or cfg.family in ("ssm", "encdec"):
            raise ValueError(f"{cfg.name}: no sequence shards of {max_len} positions over {n}")
        start = i * (max_len // n)
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
    out = init_cache(cfg, b, max_len if seq_shard is None else max_len // seq_shard[1],
                     dtype=dtype, device=dev)
    out["len"].fill_(seq_len)
    window = cfg.sliding_window if cfg.sliding_window and cfg.sliding_window < max_len else 0
    if cfg.family == "ssm":
        out["state"].copy_(cache)
    elif cfg.family == "hybrid":
        out["g_state"].copy_(g_states)
        _fill_kv(out["g_k"], out["g_v"], k, v, seq_len, window, start)
        if t_states is not None:
            out["t_state"].copy_(t_states)
    else:
        _fill_kv(out["k"], out["v"], k, v, seq_len, window, start)
    if cfg.family == "encdec":
        out["xk"], out["xv"] = xk.clone(), xv.clone()
        out["xlen"].fill_(xk.shape[2])
    return out


def cell_step_and_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Tuple[Any, tuple, tuple]:
    """``(step_fn, in_specs, in_shardings)`` of one (arch x shape x mesh)
    cell: the inputs as ``meta`` tensors (``launch/specs.py``) and, beside
    them, their layouts (``{name: spec}``, ``models/sharding.py``).  The
    training cell's optimizer state follows its parameter's plan and
    ``step`` is replicated; the decode cache is split over ``data`` by
    sequence only for ``hybrid`` at ``long_500k``."""
    pspec = specs.params_spec(cfg)
    pshard = params_shardings(cfg, mesh, pspec)
    if shape.mode == "train":
        ospec = specs.opt_state_spec(cfg, pspec)
        oshard = {"m": params_shardings(cfg, mesh, ospec["m"]),
                  "v": params_shardings(cfg, mesh, ospec["v"]), "step": ()}
        bspec = specs.batch_spec(cfg, shape)
        bshard = batch_shardings(cfg, mesh, bspec)
        return make_train_step(cfg), (pspec, ospec, bspec), (pshard, oshard, bshard)
    if shape.mode == "prefill":
        bspec = specs.batch_spec(cfg, shape)
        bspec.pop("labels")
        bshard = batch_shardings(cfg, mesh, bspec)
        return make_prefill_step(cfg), (pspec, bspec), (pshard, bshard)
    # decode
    seq_sharded = shape.name == "long_500k" and cfg.family in ("hybrid",)
    cspec = specs.cache_spec(cfg, shape)
    cshard = cache_shardings(cfg, mesh, cspec, seq_sharded=seq_sharded)
    tspec = specs.decode_tokens_spec(shape)
    tshard = batch_shardings(cfg, mesh, {"t": tspec})["t"]
    step = make_serve_step(cfg, mesh=mesh, seq_sharded=seq_sharded)
    return step, (pspec, tspec, cspec), (pshard, tshard, cshard)


__all__ = ["cell_step_and_specs", "decode_cache_from_prefill", "make_prefill_step",
           "make_serve_step", "make_train_step", "param_grads"]
