"""Model assembly: init / prefill forward / decode for the ``dense``,
``ssm`` and ``hybrid`` families (the port of ``repro/models/model.py``).

The parameters are ``nn.Module``s whose attribute names are the JAX
package's pytree keys (``blocks.<i>.attn.wq`` is ``params["blocks"]
["attn"]["wq"][i]``), with one module per layer and a plain Python loop
over layers (no scan).  The parameters are made with
``requires_grad=False``; a trainer turns the gradients on with
``model.requires_grad_(True)``.  The hybrid's shared attention block is
one :class:`DenseLayer` called after every ``hybrid_attn_every`` Mamba
layers, and the tail layers run after the last group.  ``forward``,
``init_cache`` and ``decode_step`` keep the JAX names and return
structures.  Unlike the JAX package's functional caches, ``decode_step``
writes the new token's keys, values and SSM states into the cache's
tensors in place; the dict it returns shares them.

``forward`` and ``decode_step`` serve: they run under ``torch.no_grad``
and launch K5 and K6 on the card.  ``loss_fn`` trains: it runs the same
forward body under autograd with the plain versions of K5 and K6
(``blocked_attention_plain``, ``ssd_chunked_plain``; the kernels have no
backward, and the JAX package differentiates its jnp functions, not its
Pallas kernels), and with the layers wrapped in ``torch.utils.checkpoint``
as ``_remat`` says.

``moe``, ``encdec`` and ``vlm`` are still to be ported (``ROADMAP.md``)
and raise ``NotImplementedError``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attn.ref import blocked_attention_plain
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain
from repro_torch.models.attention import blocked_attention, decode_attention
from repro_torch.models.layers import dense_init, rms_norm, rope, swiglu
from repro_torch.models.ssm import SSMParams, ssd_chunked, ssm_block, ssm_decode_step

FAMILIES = ("dense", "ssm", "hybrid")


def padded_vocab(v: int) -> int:
    return -(-v // 128) * 128


def check_family(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; the port runs "
            f"{', '.join(FAMILIES)} (ROADMAP.md, queue 1 item 9)")


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


# --------------------------------------------------------------------------
# Modules
# --------------------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        hd, d = cfg.resolved_head_dim, cfg.d_model
        self.wq = _param((d, cfg.num_heads * hd), dtype, device)
        self.wk = _param((d, cfg.num_kv_heads * hd), dtype, device)
        self.wv = _param((d, cfg.num_kv_heads * hd), dtype, device)
        self.wo = _param((cfg.num_heads * hd, d), dtype, device)
        if cfg.qk_norm:
            self.qn = _param((hd,), dtype, device)
            self.kn = _param((hd,), dtype, device)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.wg = _param((d, f), dtype, device)
        self.wu = _param((d, f), dtype, device)
        self.wd = _param((f, d), dtype, device)


class DenseLayer(nn.Module):
    """Pre-norm attention + SwiGLU: a dense layer, and the hybrid's shared
    block."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.ln2 = _param((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device)


class SSM(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        d_inner = cfg.ssm_expand * d
        h = d_inner // cfg.ssm_head_dim
        kdim = 2 * d_inner + 2 * cfg.ssm_state + h
        self.w_in = _param((d, kdim), dtype, device)
        self.a_log = _param((h,), dtype, device)
        self.d_skip = _param((h,), dtype, device)
        self.dt_bias = _param((h,), dtype, device)
        self.norm = _param((d_inner,), dtype, device)
        self.w_out = _param((d_inner, d), dtype, device)

    def params(self) -> SSMParams:
        return SSMParams(*(getattr(self, k) for k in SSMParams._fields))


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.ssm = SSM(cfg, dtype, device)


class LM(nn.Module):
    """The language model of one config; parameters uninitialized until
    :func:`init_params` or ``convert.lm_params_from_numpy`` fills them.
    ``device=None`` is the card; ``"meta"`` builds the shapes alone."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        check_family(cfg)
        if device is not None and torch.device(device).type == "meta":
            device = torch.device("meta")
        else:
            device = resolve_device(device)
        self.cfg = cfg
        dtype = cfg.parameter_dtype
        vp = padded_vocab(cfg.vocab_size)
        self.embed = _param((vp, cfg.d_model), dtype, device)
        self.final_norm = _param((cfg.d_model,), dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((vp, cfg.d_model), dtype, device)
        layer = DenseLayer if cfg.family == "dense" else MambaLayer
        self.blocks = nn.ModuleList(layer(cfg, dtype, device) for _ in range(cfg.num_layers))
        if cfg.family == "hybrid":
            self.shared_attn = DenseLayer(cfg, dtype, device)

    @property
    def head(self) -> torch.Tensor:
        return self.lm_head if hasattr(self, "lm_head") else self.embed


# --------------------------------------------------------------------------
# Parameter init
# --------------------------------------------------------------------------


def _fill_attention(p: Attention, g):
    for name in ("wq", "wk", "wv", "wo"):
        w = getattr(p, name)
        w.copy_(dense_init(g, w.shape, in_axis=0, dtype=w.dtype))
    if hasattr(p, "qn"):
        p.qn.fill_(1.0)
        p.kn.fill_(1.0)


def _fill_dense(layer: DenseLayer, g):
    layer.ln1.fill_(1.0)
    layer.ln2.fill_(1.0)
    _fill_attention(layer.attn, g)
    for name in ("wg", "wu", "wd"):
        w = getattr(layer.mlp, name)
        w.copy_(dense_init(g, w.shape, in_axis=0, dtype=w.dtype))


def _fill_mamba(layer: MambaLayer, g):
    layer.ln1.fill_(1.0)
    s = layer.ssm
    s.w_in.copy_(dense_init(g, s.w_in.shape, in_axis=0, dtype=s.w_in.dtype))
    s.a_log.fill_(0.0)  # log(1.0): a = -1
    s.d_skip.fill_(1.0)
    s.dt_bias.fill_(0.0)
    s.norm.fill_(1.0)
    s.w_out.copy_(dense_init(g, s.w_out.shape, in_axis=0, dtype=s.w_out.dtype))


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None) -> LM:
    """A model with the JAX package's shapes, scales and constant
    initializers, drawn on ``device`` from a ``torch.Generator`` there
    seeded with ``seed`` (the numbers differ from ``jax.random``'s)."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    model = LM(cfg, device=dev)
    model.embed.copy_(dense_init(generator, model.embed.shape, in_axis=1, dtype=model.embed.dtype))
    model.final_norm.fill_(1.0)
    if hasattr(model, "lm_head"):
        model.lm_head.copy_(
            dense_init(generator, model.lm_head.shape, in_axis=1, dtype=model.lm_head.dtype))
    for layer in model.blocks:
        (_fill_dense if cfg.family == "dense" else _fill_mamba)(layer, generator)
    if cfg.family == "hybrid":
        _fill_dense(model.shared_attn, generator)
    return model


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------


def _qkv(p: Attention, cfg: ModelConfig, x):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p.wq.to(x.dtype)).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p.wk.to(x.dtype)).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p.wv.to(x.dtype)).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.qn)
        k = rms_norm(k, p.kn)
    return q, k, v


def _attention_block(p: Attention, cfg: ModelConfig, x, positions, attend=blocked_attention):
    """Full-sequence self-attention (prefill: ``blocked_attention``, K5 on
    the card; training: its plain version)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = attend(q, k, v, causal=True, sliding_window=cfg.sliding_window)
    o = o.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim)
    return o @ p.wo.to(x.dtype), (k, v)


def _attention_decode(p: Attention, cfg: ModelConfig, x, k_cache, v_cache, cache_len):
    """One-token attention against the cache; writes the token's k and v
    into ``k_cache`` / ``v_cache`` (B, S, KV, hd) in place."""
    b = x.shape[0]
    q, k, v = _qkv(p, cfg, x)
    if cfg.rope_theta:
        q = rope(q, cache_len[:, None], cfg.rope_theta)
        k = rope(k, cache_len[:, None], cfg.rope_theta)
    s_max = k_cache.shape[1]
    ring = bool(cfg.sliding_window) and cfg.sliding_window < s_max
    if ring:
        write_pos = cache_len % cfg.sliding_window
    else:
        write_pos = torch.clamp(cache_len, max=s_max - 1)
    bidx = torch.arange(b, device=x.device)
    k_cache[bidx, write_pos.long()] = k[:, 0]
    v_cache[bidx, write_pos.long()] = v[:, 0]
    eff_len = torch.clamp(cache_len + 1, max=cfg.sliding_window) if ring else cache_len + 1
    # the ring buffer already bounds the window
    o = decode_attention(q, k_cache, v_cache, eff_len, sliding_window=0)
    return o.reshape(b, 1, cfg.num_heads * cfg.resolved_head_dim) @ p.wo.to(x.dtype)


def _dense_layer(layer: DenseLayer, cfg, x, positions, attend=blocked_attention):
    h = rms_norm(x, layer.ln1)
    attn_out, kv = _attention_block(layer.attn, cfg, h, positions, attend)
    x = x + attn_out
    h = rms_norm(x, layer.ln2)
    return x + swiglu(h, layer.mlp.wg, layer.mlp.wu, layer.mlp.wd), kv


def _dense_decode(layer: DenseLayer, cfg, x, k_cache, v_cache, cache_len):
    h = rms_norm(x, layer.ln1)
    x = x + _attention_decode(layer.attn, cfg, h, k_cache, v_cache, cache_len)
    h = rms_norm(x, layer.ln2)
    return x + swiglu(h, layer.mlp.wg, layer.mlp.wu, layer.mlp.wd)


def _mamba_layer(layer: MambaLayer, cfg, x, scan=ssd_chunked):
    y, state = ssm_block(layer.ssm.params(), rms_norm(x, layer.ln1), cfg, scan=scan)
    return x + y, state


def _mamba_decode(layer: MambaLayer, cfg, x, state):
    y, state = ssm_decode_step(layer.ssm.params(), rms_norm(x, layer.ln1), state, cfg)
    return x + y, state


def _groups(cfg: ModelConfig):
    every = cfg.hybrid_attn_every
    groups = cfg.num_layers // every
    return every, groups, cfg.num_layers - groups * every


def _logits(params: LM, x):
    x = rms_norm(x, params.final_norm)
    return x @ params.head.to(x.dtype).T


# --------------------------------------------------------------------------
# Full-sequence forward (prefill, and the training forward of loss_fn)
# --------------------------------------------------------------------------


class Layers(NamedTuple):
    """The layer functions of one forward: a dense layer, the hybrid's
    shared block and a Mamba layer."""

    dense: Any
    shared: Any
    mamba: Any


SERVE_LAYERS = Layers(_dense_layer, _dense_layer, _mamba_layer)


def _products_saved(ctx, op, *args, **kwargs):
    """The ``dots`` policy: keep the weight products (``x @ W`` reaches the
    dispatcher as ``mm`` / ``addmm``), recompute everything else, batched
    products (``bmm``: the attention's and the SSD's einsums) included, as
    ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims`` does."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat_policy``: ``none`` as it is, ``dots`` with
    only the weight products kept for the backward, anything else (``full``)
    recomputed whole."""
    if cfg.remat_policy == "none":
        return fn
    kw = dict(use_reentrant=False)
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _products_saved)

    @functools.wraps(fn)
    def wrapped(*args):
        return checkpoint(fn, *args, **kw)

    return wrapped


def train_layers(cfg: ModelConfig) -> Layers:
    """The training forward's layers: attention and the SSD scan through
    their plain versions, the dense and the Mamba layer under ``_remat``
    (the hybrid's shared block is not, as in the JAX package)."""
    dense = functools.partial(_dense_layer, attend=blocked_attention_plain)
    mamba = functools.partial(_mamba_layer, scan=ssd_chunked_plain)
    return Layers(_remat(dense, cfg), dense, _remat(mamba, cfg))


def _forward(cfg: ModelConfig, params: LM, tokens: torch.Tensor, return_cache: bool,
             layers: Layers):
    """The body of ``forward`` and of ``loss_fn``'s forward."""
    check_family(cfg)
    dt = cfg.activation_dtype
    x = F.embedding(tokens.long(), params.embed.to(dt))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = None
    if cfg.family == "dense":
        kvs = []
        for layer in params.blocks:
            x, kv = layers.dense(layer, cfg, x, positions)
            if return_cache:
                kvs.append(kv)
        if return_cache:
            caches = (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))
    elif cfg.family == "ssm":
        states = []
        for layer in params.blocks:
            x, st = layers.mamba(layer, cfg, x)
            if return_cache:
                states.append(st)
        if return_cache:
            caches = torch.stack(states)
    else:
        x, caches = _hybrid_forward(cfg, params, x, positions, return_cache, layers)
    return _logits(params, x), aux, caches


@torch.no_grad()
def forward(
    cfg: ModelConfig,
    params: LM,
    tokens: torch.Tensor,  # (B, S)
    *,
    return_cache: bool = False,
):
    """Returns ``(logits, aux_loss, cache_or_None)``.  The cache is
    ``(k, v)`` stacked over layers ``(L, B, S, KV, hd)`` for ``dense``, the
    states ``(L, B, H, P, N)`` for ``ssm``, and ``(g_states (groups, every,
    B, H, P, N), (g_k, g_v) (groups, B, S, KV, hd), t_states (rest, B, H,
    P, N) or None)`` for ``hybrid``."""
    return _forward(cfg, params, tokens, return_cache, SERVE_LAYERS)


def _hybrid_forward(cfg, params: LM, x, positions, return_cache, layers: Layers):
    """Zamba2: groups of ``hybrid_attn_every`` Mamba layers, each followed
    by the one shared attention block; then the tail layers."""
    every, groups, rest = _groups(cfg)
    g_states, g_k, g_v, t_states = [], [], [], []
    for g in range(groups):
        group = []
        for layer in params.blocks[g * every:(g + 1) * every]:
            x, st = layers.mamba(layer, cfg, x)
            group.append(st)
        x, (k, v) = layers.shared(params.shared_attn, cfg, x, positions)
        if return_cache:
            g_states.append(torch.stack(group))
            g_k.append(k)
            g_v.append(v)
    for layer in params.blocks[groups * every:]:
        x, st = layers.mamba(layer, cfg, x)
        t_states.append(st)
    if not return_cache:
        return x, None
    t = torch.stack(t_states) if rest else None
    return x, (torch.stack(g_states), (torch.stack(g_k), torch.stack(g_v)), t)


# --------------------------------------------------------------------------
# Loss / train step body
# --------------------------------------------------------------------------


def loss_fn(cfg: ModelConfig, params: LM, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(loss, {"nll", "aux"})`` of a batch of ``tokens`` and ``labels``
    (B, S), differentiable in the parameters that require gradients: the
    mean of ``logsumexp`` minus the label's logit over float32 logits, the
    padded vocabulary masked to -1e30, plus ``0.01 * aux``."""
    unported = set(batch) - {"tokens", "labels"}
    if unported:
        raise NotImplementedError(
            f"batch inputs {sorted(unported)} (frontends) are still to be ported (ROADMAP.md)")
    logits, aux, _ = _forward(cfg, params, batch["tokens"], False, train_layers(cfg))
    labels = batch["labels"].long()
    vp = logits.shape[-1]
    logits = logits.float()
    if vp > cfg.vocab_size:
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (logz - ll).mean()
    loss = nll + 0.01 * aux
    return loss, {"nll": nll, "aux": aux}


# --------------------------------------------------------------------------
# Decode (serve_step)
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None):
    """Allocate the decode cache of one model (zeros) on ``device``."""
    check_family(cfg)
    device = resolve_device(device)
    dt = dtype or cfg.activation_dtype
    hd = cfg.resolved_head_dim
    L = cfg.num_layers
    eff_len = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    length = zeros((batch,), torch.int32)
    if cfg.family == "dense":
        return {
            "k": zeros((L, batch, eff_len, cfg.num_kv_heads, hd), dt),
            "v": zeros((L, batch, eff_len, cfg.num_kv_heads, hd), dt),
            "len": length,
        }
    d_inner = cfg.ssm_expand * cfg.d_model
    h = d_inner // cfg.ssm_head_dim
    state = (batch, h, cfg.ssm_head_dim, cfg.ssm_state)
    if cfg.family == "ssm":
        return {"state": zeros((L,) + state, torch.float32), "len": length}
    every, groups, rest = _groups(cfg)
    cache = {
        "g_state": zeros((groups, every) + state, torch.float32),
        "g_k": zeros((groups, batch, eff_len, cfg.num_kv_heads, hd), dt),
        "g_v": zeros((groups, batch, eff_len, cfg.num_kv_heads, hd), dt),
        "len": length,
    }
    if rest:
        cache["t_state"] = zeros((rest,) + state, torch.float32)
    return cache


@torch.no_grad()
def decode_step(
    cfg: ModelConfig,
    params: LM,
    tokens: torch.Tensor,  # (B, 1)
    cache: Dict[str, torch.Tensor],
    mesh: Any = None,
    seq_sharded: bool = False,
):
    """serve_step: one new token against the cache.  Returns ``(logits,
    cache)``; the cache's tensors are updated in place."""
    check_family(cfg)
    if mesh is not None or seq_sharded:
        raise NotImplementedError(
            "the sequence-sharded decode needs a device mesh; still to be ported (ROADMAP.md)")
    dt = cfg.activation_dtype
    x = F.embedding(tokens.long(), params.embed.to(dt))
    cache_len = cache["len"]
    if cfg.family == "dense":
        for i, layer in enumerate(params.blocks):
            x = _dense_decode(layer, cfg, x, cache["k"][i], cache["v"][i], cache_len)
    elif cfg.family == "ssm":
        for i, layer in enumerate(params.blocks):
            x, st = _mamba_decode(layer, cfg, x, cache["state"][i])
            cache["state"][i].copy_(st)
    else:
        every, groups, rest = _groups(cfg)
        for g in range(groups):
            for i, layer in enumerate(params.blocks[g * every:(g + 1) * every]):
                x, st = _mamba_decode(layer, cfg, x, cache["g_state"][g, i])
                cache["g_state"][g, i].copy_(st)
            x = _dense_decode(params.shared_attn, cfg, x, cache["g_k"][g], cache["g_v"][g],
                              cache_len)
        for i, layer in enumerate(params.blocks[groups * every:]):
            x, st = _mamba_decode(layer, cfg, x, cache["t_state"][i])
            cache["t_state"][i].copy_(st)
    return _logits(params, x), dict(cache, len=cache_len + 1)


__all__ = [
    "FAMILIES",
    "LM",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "loss_fn",
    "padded_vocab",
    "train_layers",
]
