"""Model assembly: init / prefill forward / decode for all six families
(``dense``, ``moe``, ``ssm``, ``hybrid``, ``encdec``, ``vlm``; the port of
``repro/models/model.py``).

The parameters are ``nn.Module``s whose attribute names are the JAX
package's pytree keys (``blocks.<i>.attn.wq`` is ``params["blocks"]
["attn"]["wq"][i]``), with one module per layer and a plain Python loop
over layers (no scan).  The parameters are made with
``requires_grad=False``; a trainer turns the gradients on with
``model.requires_grad_(True)``.  The hybrid's shared attention block is
one :class:`DenseLayer` called after every ``hybrid_attn_every`` Mamba
layers, and the tail layers run after the last group.  The ``encdec``
family's encoder layers are ``encoder.<i>.*`` (``params["encoder"]
["attn"]["wq"][i]``) beside the unstacked ``encoder.final_norm``; ``vlm``
layers are dense layers.  ``forward``,
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

Frontends are stubs, as in the JAX package: ``embeds`` (B, S, D) stand in
for a vision encoder's output, ``positions3`` (B, 3, S) are M-RoPE's t/h/w
position ids, and ``encoder_frames`` (B, Se, D) stand in for the audio
conv frontend.  Rope is off for cross-attention and for the ``encdec``
family.  The ``vlm`` decode rotates by plain rope at ``cache_len``, not by
M-RoPE, as the JAX package's decode does.  The MoE's capacity follows the
tokens of the call: a prefill routes ``B * S`` tokens, a decode step ``B``,
so the two drop different slots (``models/moe.py``).

The full-sequence forward opens spans (``obs.span``) where the
benchmark's cells read them: ``models.layer.<kind>`` around each
``mamba``, ``shared`` and ``moe`` layer, ``models.attention`` inside each
attention block, ``models.logits`` and ``models.cache`` (the stacked
cache).  They cost a flag check unless a tracer or ``torch.profiler`` is
active; under the profiler they are ``record_function`` ranges, on the
profiler's clock.  The ``dense``, ``encoder`` and ``encdec`` layers and
``decode_step`` have none.
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
from repro_torch.core.obs import spans as obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attn.ref import blocked_attention_plain
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain
from repro_torch.models.attention import (
    attend_on_mesh,
    blocked_attention,
    decode_attention,
    decode_attention_seqsharded,
)
from repro_torch.models.layers import dense_init, mrope, rms_norm, rope, swiglu
from repro_torch.models.moe import MoEParams, moe_ffn
from repro_torch.models.sharding import act_hint, assign, reduce_partial, shard_hint, write_rows
from repro_torch.models.ssm import SSMParams, ssd_chunked, ssm_block, ssm_decode_step

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
DENSE_LAYOUT = ("dense", "vlm", "moe")  # one (k, v) cache a layer


def padded_vocab(v: int) -> int:
    return -(-v // 128) * 128


def _device(device: DeviceLike) -> torch.device:
    """``resolve_device``, but ``"meta"`` is taken as given (shapes alone)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


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


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
        self.router = _param((d, e), dtype, device)
        self.wg = _param((e, d, f), dtype, device)
        self.wu = _param((e, d, f), dtype, device)
        self.wd = _param((e, f, d), dtype, device)

    def params(self) -> MoEParams:
        return MoEParams(self.router, self.wg, self.wu, self.wd)


class MoELayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.ln2 = _param((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.moe = MoE(cfg, dtype, device)


class EncDecLayer(nn.Module):
    """A decoder layer of the encoder-decoder: self-attention, then
    cross-attention over the encoder's output, then SwiGLU."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.ln2 = _param((cfg.d_model,), dtype, device)
        self.ln3 = _param((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.xattn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device)


class Encoder(nn.ModuleList):
    """The encoder's dense layers (``encoder.<i>``) and its final norm
    (``encoder.final_norm``, one vector, not stacked)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(DenseLayer(cfg, dtype, device) for _ in range(cfg.encoder_layers))
        self.final_norm = _param((cfg.d_model,), dtype, device)


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
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}")
        device = _device(device)
        self.cfg = cfg
        dtype = cfg.parameter_dtype
        vp = padded_vocab(cfg.vocab_size)
        self.embed = _param((vp, cfg.d_model), dtype, device)
        self.final_norm = _param((cfg.d_model,), dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((vp, cfg.d_model), dtype, device)
        layer = {"dense": DenseLayer, "vlm": DenseLayer, "moe": MoELayer, "ssm": MambaLayer,
                 "hybrid": MambaLayer, "encdec": EncDecLayer}[cfg.family]
        self.blocks = nn.ModuleList(layer(cfg, dtype, device) for _ in range(cfg.num_layers))
        if cfg.family == "hybrid":
            self.shared_attn = DenseLayer(cfg, dtype, device)
        if cfg.family == "encdec":
            self.encoder = Encoder(cfg, dtype, device)

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


def _fill_mlp(p: MLP, g):
    for name in ("wg", "wu", "wd"):
        w = getattr(p, name)
        w.copy_(dense_init(g, w.shape, in_axis=0, dtype=w.dtype))


def _fill_dense(layer: DenseLayer, g):
    layer.ln1.fill_(1.0)
    layer.ln2.fill_(1.0)
    _fill_attention(layer.attn, g)
    _fill_mlp(layer.mlp, g)


def _fill_moe(layer: MoELayer, g):
    layer.ln1.fill_(1.0)
    layer.ln2.fill_(1.0)
    _fill_attention(layer.attn, g)
    m = layer.moe
    # fan-in: the model width for the router, wg and wu; d_ff for wd
    m.router.copy_(dense_init(g, m.router.shape, in_axis=0, dtype=m.router.dtype))
    for name in ("wg", "wu", "wd"):
        w = getattr(m, name)
        w.copy_(dense_init(g, w.shape, in_axis=1, dtype=w.dtype))


def _fill_encdec(layer: EncDecLayer, g):
    for ln in (layer.ln1, layer.ln2, layer.ln3):
        ln.fill_(1.0)
    _fill_attention(layer.attn, g)
    _fill_attention(layer.xattn, g)
    _fill_mlp(layer.mlp, g)


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
    fill = {"dense": _fill_dense, "vlm": _fill_dense, "moe": _fill_moe, "ssm": _fill_mamba,
            "hybrid": _fill_mamba, "encdec": _fill_encdec}[cfg.family]
    for layer in model.blocks:
        fill(layer, generator)
    if cfg.family == "hybrid":
        _fill_dense(model.shared_attn, generator)
    if cfg.family == "encdec":
        for layer in model.encoder:
            _fill_dense(layer, generator)
        model.encoder.final_norm.fill_(1.0)
    return model


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------


def _qkv(p: Attention, cfg: ModelConfig, x, src=None):
    """q of ``x``, k and v of ``src`` (``x`` but for cross-attention)."""
    src = x if src is None else src
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    kv = cfg.num_kv_heads
    q = act_hint(x @ p.wq.to(x.dtype), cfg.num_heads).reshape(b, s, cfg.num_heads, hd)
    k = act_hint(src @ p.wk.to(x.dtype), kv).reshape(b, src.shape[1], kv, hd)
    v = act_hint(src @ p.wv.to(x.dtype), kv).reshape(b, src.shape[1], kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.qn)
        k = rms_norm(k, p.kn)
    return q, k, v


def _apply_rope(cfg: ModelConfig, q, k, positions, positions3=None):
    if cfg.mrope and positions3 is not None:
        return (mrope(q, positions3, cfg.mrope_sections, cfg.rope_theta),
                mrope(k, positions3, cfg.mrope_sections, cfg.rope_theta))
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta)


def _attention_block(p: Attention, cfg: ModelConfig, x, positions, attend=blocked_attention,
                     positions3=None, causal=True, kv_x=None):
    """Full-sequence attention (prefill: ``blocked_attention``, K5 on the
    card; training: its plain version); ``kv_x`` given is cross-attention
    over it."""
    b, s, _ = x.shape
    with obs.span("models.attention"):
        q, k, v = _qkv(p, cfg, x, kv_x)
        if kv_x is None and cfg.rope_theta and cfg.family != "encdec":
            q, k = _apply_rope(cfg, q, k, positions, positions3)
        o = attend_on_mesh(attend, q, k, v, causal=causal, sliding_window=cfg.sliding_window)
        # pinned as q was: the gradient then reaches the merge of the heads in a
        # layout its split back into heads can take
        o = act_hint(o.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim), cfg.num_heads)
        return o @ p.wo.to(x.dtype), (k, v)


def _attention_decode(p: Attention, cfg: ModelConfig, x, k_cache, v_cache, cache_len,
                      mesh=None, seq_sharded: bool = False):
    """One-token attention against the cache; writes the token's k and v
    into ``k_cache`` / ``v_cache`` (B, S, KV, hd) in place.  With
    ``seq_sharded`` and a mesh, the cache is this rank's part of a cache
    split over the mesh's ``data`` axis (``decode_attention_seqsharded``)."""
    b = x.shape[0]
    q, k, v = _qkv(p, cfg, x)
    if cfg.rope_theta and cfg.family != "encdec":  # plain rope, also for vlm
        q = rope(q, cache_len[:, None], cfg.rope_theta)
        k = rope(k, cache_len[:, None], cfg.rope_theta)
    if seq_sharded and mesh is not None:
        # the owner shard writes the token (no window, no clamp: the reference's)
        o, _, _ = decode_attention_seqsharded(q, k_cache, v_cache, cache_len, mesh,
                                              k_new=k, v_new=v)
        return o.reshape(b, 1, cfg.num_heads * cfg.resolved_head_dim) @ p.wo.to(x.dtype)
    # As in the JAX package, the ring branch is taken only where the cache
    # holds more than the window; init_cache sizes it to the window, so
    # past it the newest position is written to the last slot.
    s_max = k_cache.shape[1]
    ring = bool(cfg.sliding_window) and cfg.sliding_window < s_max
    if ring:
        write_pos = cache_len % cfg.sliding_window
    else:
        write_pos = torch.clamp(cache_len, max=s_max - 1)
    write_rows(write_pos, (k_cache, k[:, 0]), (v_cache, v[:, 0]))
    eff_len = torch.clamp(cache_len + 1, max=cfg.sliding_window) if ring else cache_len + 1
    # the ring buffer already bounds the window
    o = decode_attention(q, k_cache, v_cache, eff_len, sliding_window=0)
    return o.reshape(b, 1, cfg.num_heads * cfg.resolved_head_dim) @ p.wo.to(x.dtype)


def _mlp(p: MLP, h):
    return swiglu(h, p.wg, p.wu, p.wd)


def _dense_layer(layer: DenseLayer, cfg, x, positions, positions3=None,
                 attend=blocked_attention):
    h = rms_norm(x, layer.ln1)
    attn_out, kv = _attention_block(layer.attn, cfg, h, positions, attend, positions3)
    x = x + attn_out
    return x + _mlp(layer.mlp, rms_norm(x, layer.ln2)), kv


def _moe_layer(layer: MoELayer, cfg, x, positions, positions3=None, attend=blocked_attention):
    """Returns ``(x, aux, (k, v))``."""
    b, s, d = x.shape
    h = rms_norm(x, layer.ln1)
    attn_out, kv = _attention_block(layer.attn, cfg, h, positions, attend, positions3)
    x = x + attn_out
    h = rms_norm(x, layer.ln2)
    y, aux, _ = moe_ffn(h.reshape(b * s, d), layer.moe.params(), cfg.moe_top_k)
    return x + y.reshape(b, s, d), aux, kv


def _encoder_layer(layer: DenseLayer, cfg, x, positions, attend=blocked_attention):
    h = rms_norm(x, layer.ln1)
    o, _ = _attention_block(layer.attn, cfg, h, positions, attend, causal=False)
    x = x + o
    return x + _mlp(layer.mlp, rms_norm(x, layer.ln2))


def _encdec_layer(layer: EncDecLayer, cfg, x, positions, enc_out, attend=blocked_attention):
    """Returns ``(x, ((k, v), (xk, xv)))``."""
    h = rms_norm(x, layer.ln1)
    attn_out, kv = _attention_block(layer.attn, cfg, h, positions, attend)
    x = x + attn_out
    h = rms_norm(x, layer.ln3)
    xo, xkv = _attention_block(layer.xattn, cfg, h, positions, attend, causal=False,
                               kv_x=enc_out)
    x = x + xo
    return x + _mlp(layer.mlp, rms_norm(x, layer.ln2)), (kv, xkv)


def _dense_decode(layer: DenseLayer, cfg, x, k_cache, v_cache, cache_len, mesh=None,
                  seq_sharded=False):
    h = rms_norm(x, layer.ln1)
    x = x + _attention_decode(layer.attn, cfg, h, k_cache, v_cache, cache_len, mesh, seq_sharded)
    return x + _mlp(layer.mlp, rms_norm(x, layer.ln2))


def _moe_decode(layer: MoELayer, cfg, x, k_cache, v_cache, cache_len, mesh=None,
                seq_sharded=False):
    """The MoE routes the step's ``B`` tokens: capacity ``max(int(1.25 B k
    / E), 1)``, so a decode step can drop slots a prefill keeps."""
    b = x.shape[0]
    h = rms_norm(x, layer.ln1)
    x = x + _attention_decode(layer.attn, cfg, h, k_cache, v_cache, cache_len, mesh, seq_sharded)
    h = rms_norm(x, layer.ln2)
    y, _, _ = moe_ffn(h.reshape(b, -1), layer.moe.params(), cfg.moe_top_k)
    return x + y.reshape(b, 1, -1)


def _cross_decode(p: Attention, cfg, x, xk, xv, xlen):
    """One token's cross-attention over the first ``xlen`` encoder
    positions of ``xk`` / ``xv`` (no qk-norm and no rope, as in the JAX
    package).  With ``xlen`` 0 (an empty cross cache) every score is the
    finite ``NEG_INF``: the softmax is uniform over the cache's zeros and
    the output is zero, not NaN."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q = act_hint(x @ p.wq.to(x.dtype), cfg.num_heads).reshape(b, 1, cfg.num_heads, hd)
    o = decode_attention(q, xk, xv, xlen)
    return o.reshape(b, 1, cfg.num_heads * hd) @ p.wo.to(x.dtype)


def _encdec_decode(layer: EncDecLayer, cfg, x, k_cache, v_cache, xk, xv, cache_len, xlen):
    h = rms_norm(x, layer.ln1)
    x = x + _attention_decode(layer.attn, cfg, h, k_cache, v_cache, cache_len)
    x = x + _cross_decode(layer.xattn, cfg, rms_norm(x, layer.ln3), xk, xv, xlen)
    return x + _mlp(layer.mlp, rms_norm(x, layer.ln2))


def _mamba_layer(layer: MambaLayer, cfg, x, scan=ssd_chunked):
    x = act_hint(x)
    y, state = ssm_block(layer.ssm.params(), rms_norm(x, layer.ln1), cfg, scan=scan)
    return x + y, state


def _mamba_decode(layer: MambaLayer, cfg, x, state):
    x = act_hint(x)
    y, state = ssm_decode_step(layer.ssm.params(), rms_norm(x, layer.ln1), state, cfg)
    return x + y, state


def _groups(cfg: ModelConfig):
    every = cfg.hybrid_attn_every
    groups = cfg.num_layers // every
    return every, groups, cfg.num_layers - groups * every


def _embed(params: LM, tokens, dt):
    """The tokens' rows of the embedding (on a device mesh, reduced at once
    where the vocabulary is split)."""
    return reduce_partial(F.embedding(tokens.long(), params.embed.to(dt)))


def _logits(params: LM, x):
    x = rms_norm(x, params.final_norm)
    return shard_hint(x @ params.head.to(x.dtype).T, "batch", None, "model")


# --------------------------------------------------------------------------
# Full-sequence forward (prefill, and the training forward of loss_fn)
# --------------------------------------------------------------------------


class Layers(NamedTuple):
    """The layer functions of one forward: a dense (and vlm) layer, the
    hybrid's shared block, a Mamba layer, an MoE layer, an encoder layer
    and an encoder-decoder layer."""

    dense: Any
    shared: Any
    mamba: Any
    moe: Any
    encoder: Any
    encdec: Any


SERVE_LAYERS = Layers(_dense_layer, _dense_layer, _mamba_layer, _moe_layer, _encoder_layer,
                      _encdec_layer)


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
    their plain versions, every layer under ``_remat`` but the hybrid's
    shared block, as in the JAX package."""
    plain = dict(attend=blocked_attention_plain)
    dense = functools.partial(_dense_layer, **plain)
    mamba = functools.partial(_mamba_layer, scan=ssd_chunked_plain)
    return Layers(_remat(dense, cfg), dense, _remat(mamba, cfg),
                  _remat(functools.partial(_moe_layer, **plain), cfg),
                  _remat(functools.partial(_encoder_layer, **plain), cfg),
                  _remat(functools.partial(_encdec_layer, **plain), cfg))


def _stack(parts):
    """Per-layer parts into the stacked cache, in the span ``models.cache``:
    ``torch.stack`` of a list of tensors (states), or ``(torch.stack(firsts),
    torch.stack(seconds))`` of a list of ``(a, b)`` pairs (``(k, v)``)."""
    with obs.span("models.cache"):
        if isinstance(parts[0], torch.Tensor):
            return torch.stack(parts)
        return torch.stack([a for a, _ in parts]), torch.stack([b for _, b in parts])


def _encoder_forward(cfg: ModelConfig, enc: Encoder, frames: torch.Tensor, layers: Layers):
    """Sinusoidal positions (whisper-style), the non-causal encoder layers,
    the final norm."""
    dt = cfg.activation_dtype
    x = frames.to(dt)
    b, s, d = x.shape
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=x.device)
                      / max(half - 1, 1) * torch.log(torch.tensor(10000.0)))
    ang = torch.arange(s, device=x.device)[:, None] * freqs[None, :]
    x = x + torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dt)[None]
    positions = torch.arange(s, device=x.device).expand(b, s)
    for layer in enc:
        x = layers.encoder(layer, cfg, x, positions)
    return rms_norm(x, enc.final_norm)


def _forward(cfg: ModelConfig, params: LM, tokens, return_cache: bool, layers: Layers,
             embeds=None, positions3=None, encoder_frames=None):
    """The body of ``forward`` and of ``loss_fn``'s forward."""
    dt = cfg.activation_dtype
    if embeds is not None:
        x = embeds.to(dt)
    else:
        x = _embed(params, tokens, dt)
    x = shard_hint(x, "batch", None, None)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = None
    if cfg.family in DENSE_LAYOUT or cfg.family == "encdec":
        if cfg.family == "encdec":
            enc_out = _encoder_forward(cfg, params.encoder, encoder_frames, layers)
        kvs = []
        for layer in params.blocks:
            if cfg.family != "encdec":
                x = shard_hint(x, "batch", None, None)
            if cfg.family == "moe":
                with obs.span("models.layer.moe"):
                    x, a, kv = layers.moe(layer, cfg, x, positions, positions3)
                aux = aux + a
            elif cfg.family == "encdec":
                x, kv = layers.encdec(layer, cfg, x, positions, enc_out)
            else:
                x, kv = layers.dense(layer, cfg, x, positions, positions3)
            if return_cache:
                kvs.append(kv)
        if return_cache and cfg.family == "encdec":
            caches = (_stack([kv for kv, _ in kvs]), _stack([xkv for _, xkv in kvs]))
        elif return_cache:
            caches = _stack(kvs)
    elif cfg.family == "ssm":
        states = []
        for layer in params.blocks:
            with obs.span("models.layer.mamba"):
                x, st = layers.mamba(layer, cfg, x)
            if return_cache:
                states.append(st)
        if return_cache:
            caches = _stack(states)
    else:
        x, caches = _hybrid_forward(cfg, params, x, positions, return_cache, layers)
    with obs.span("models.logits"):
        logits = _logits(params, x)
    return logits, aux, caches


@torch.no_grad()
def forward(
    cfg: ModelConfig,
    params: LM,
    tokens,  # (B, S), or None when embeds are given
    *,
    embeds=None,  # (B, S, D) stub frontends
    positions3=None,  # (B, 3, S) M-RoPE
    encoder_frames=None,  # (B, Se, D) audio stub
    return_cache: bool = False,
):
    """Returns ``(logits, aux_loss, cache_or_None)``.  The cache is
    ``(k, v)`` stacked over layers ``(L, B, S, KV, hd)`` for ``dense``,
    ``vlm`` and ``moe``; ``((k, v), (xk, xv))`` for ``encdec``, the cross
    pair ``(L, B, Se, KV, hd)``; the states ``(L, B, H, P, N)`` for
    ``ssm``; and ``(g_states (groups, every, B, H, P, N), (g_k, g_v)
    (groups, B, S, KV, hd), t_states (rest, B, H, P, N) or None)`` for
    ``hybrid``.  ``aux_loss`` is the MoE layers' load-balancing loss summed
    over layers (0 for the other families)."""
    return _forward(cfg, params, tokens, return_cache, SERVE_LAYERS, embeds, positions3,
                    encoder_frames)


def _hybrid_forward(cfg, params: LM, x, positions, return_cache, layers: Layers):
    """Zamba2: groups of ``hybrid_attn_every`` Mamba layers, each followed
    by the one shared attention block; then the tail layers."""
    every, groups, rest = _groups(cfg)
    g_states, g_kv, t_states = [], [], []
    for g in range(groups):
        group = []
        for layer in params.blocks[g * every:(g + 1) * every]:
            with obs.span("models.layer.mamba"):
                x, st = layers.mamba(layer, cfg, x)
            group.append(st)
        with obs.span("models.layer.shared"):
            x, (k, v) = layers.shared(params.shared_attn, cfg, x, positions)
        if return_cache:
            g_states.append(_stack(group))
            g_kv.append((k, v))
    for layer in params.blocks[groups * every:]:
        with obs.span("models.layer.mamba"):
            x, st = layers.mamba(layer, cfg, x)
        t_states.append(st)
    if not return_cache:
        return x, None
    return x, (_stack(g_states), _stack(g_kv), _stack(t_states) if rest else None)


# --------------------------------------------------------------------------
# Loss / train step body
# --------------------------------------------------------------------------


def loss_fn(cfg: ModelConfig, params: LM, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(loss, {"nll", "aux"})`` of a batch of ``labels`` (B, S) and
    ``tokens`` (B, S) or ``embeds`` (B, S, D), with ``positions3`` and
    ``frames`` where the family takes them, differentiable in the
    parameters that require gradients: the mean of ``logsumexp`` minus the
    label's logit over float32 logits, the padded vocabulary masked to
    -1e30, plus ``0.01 * aux``."""
    unknown = set(batch) - {"tokens", "labels", "embeds", "positions3", "frames"}
    if unknown:
        raise ValueError(f"unknown batch inputs {sorted(unknown)}")
    logits, aux, _ = _forward(cfg, params, batch.get("tokens"), False, train_layers(cfg),
                              batch.get("embeds"), batch.get("positions3"), batch.get("frames"))
    labels = batch["labels"].long()
    vp = logits.shape[-1]
    logits = logits.float()
    if vp > cfg.vocab_size:
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    ll = reduce_partial(torch.gather(logits, -1, labels[..., None]))[..., 0]
    nll = (logz - ll).mean()
    loss = nll + 0.01 * aux
    return loss, {"nll": nll, "aux": aux}


# --------------------------------------------------------------------------
# Decode (serve_step)
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None):
    """Allocate the decode cache of one model (zeros) on ``device``
    (``"meta"``: the shapes alone)."""
    device = _device(device)
    dt = dtype or cfg.activation_dtype
    hd = cfg.resolved_head_dim
    L = cfg.num_layers
    eff_len = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    length = zeros((batch,), torch.int32)
    kv = (L, batch, eff_len, cfg.num_kv_heads, hd)
    if cfg.family in DENSE_LAYOUT:
        return {"k": zeros(kv, dt), "v": zeros(kv, dt), "len": length}
    if cfg.family == "encdec":
        return {"k": zeros(kv, dt), "v": zeros(kv, dt), "xk": zeros(kv, dt), "xv": zeros(kv, dt),
                "xlen": zeros((batch,), torch.int32), "len": length}
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
    cache)``; the cache's tensors are updated in place.  With
    ``seq_sharded`` and a ``mesh`` the attention caches (``k`` / ``v``,
    ``g_k`` / ``g_v``) are this rank's sequence shards (or DTensors split so
    over ``data``; ``decode_attention_seqsharded``); ``len`` stays global.
    As in the JAX package, the encoder-decoder's self-attention does not
    take the mesh."""
    dt = cfg.activation_dtype
    x = _embed(params, tokens, dt)
    cache_len = cache["len"]
    if cfg.family in DENSE_LAYOUT:
        step = _moe_decode if cfg.family == "moe" else _dense_decode
        for i, layer in enumerate(params.blocks):
            x = step(layer, cfg, x, cache["k"][i], cache["v"][i], cache_len, mesh, seq_sharded)
    elif cfg.family == "encdec":
        for i, layer in enumerate(params.blocks):
            x = _encdec_decode(layer, cfg, x, cache["k"][i], cache["v"][i], cache["xk"][i],
                               cache["xv"][i], cache_len, cache["xlen"])
    elif cfg.family == "ssm":
        for i, layer in enumerate(params.blocks):
            x, st = _mamba_decode(layer, cfg, x, cache["state"][i])
            assign(cache["state"][i], st)
    else:
        every, groups, rest = _groups(cfg)
        for g in range(groups):
            for i, layer in enumerate(params.blocks[g * every:(g + 1) * every]):
                x, st = _mamba_decode(layer, cfg, x, cache["g_state"][g, i])
                assign(cache["g_state"][g, i], st)
            x = _dense_decode(params.shared_attn, cfg, x, cache["g_k"][g], cache["g_v"][g],
                              cache_len, mesh, seq_sharded)
        for i, layer in enumerate(params.blocks[groups * every:]):
            x, st = _mamba_decode(layer, cfg, x, cache["t_state"][i])
            assign(cache["t_state"][i], st)
    return _logits(params, x), dict(cache, len=cache_len + 1)


__all__ = [
    "FAMILIES",
    "LM",
    "MoE",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "loss_fn",
    "padded_vocab",
    "train_layers",
]
