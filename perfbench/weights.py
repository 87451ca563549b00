"""Random weights of a configuration, drawn on the device from the seed in
the JAX package's parameter tree layout: nested dicts, each layer's tensors
stacked on axis 0 (``tree["blocks"]["attn"]["wq"]`` is ``(L, D, H hd)``).

One leaf is one draw (a few large calls for a whole model), in the dtype
the model is served in.  The distributions follow the port's
``convert.random_lm_tree``: norms ``1 + 0.1 N(0, 1)``, ``a_log`` ``log U(0.6,
1.2)``, ``d_skip`` ``U(0.5, 1.5)``, ``dt_bias`` ``0.1 N(0, 1)``, every
matrix ``N(0, 1 / fan_in)`` (the model width for ``lm_head``, the input
axis ``shape[-2]`` for the others), but for two depth scalings, as GPT-2's
initialization has them: the embedding is ``N(0, 1)``, and the projections
that write into the residual stream (attention ``wo``, Mamba2 ``w_out``, the
MLPs' and experts' ``wd``) have their std times ``1 / sqrt(2 L)`` for ``L``
layers.  With every matrix at ``N(0, 1 / fan_in)`` each branch is as large
as the stream, and the random model amplifies rounding from layer to layer
(bf16 against float32: 0.4 % at zamba2's first layer, 92 % at its 38th),
so that no comparison with the reference could tell bf16 from float8.  The
same seed gives the same tree on every call, so the check draws it again
after the program's copy is freed.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from perfbench.traffic import sub_seed

Path_ = Tuple[str, ...]
NORMS = ("ln1", "ln2", "ln3", "norm", "final_norm", "qn", "kn")
OUT_PROJECTIONS = ("wo", "w_out", "wd")  # write into the residual stream


def padded_vocab(v: int) -> int:
    """The vocabulary rows the program's embedding and head hold."""
    return -(-v // 128) * 128


def _attention(cfg) -> Dict[str, tuple]:
    d, hd = cfg["d_model"], cfg["head_dim"]
    return {"wq": (d, cfg["num_heads"] * hd), "wk": (d, cfg["num_kv_heads"] * hd),
            "wv": (d, cfg["num_kv_heads"] * hd), "wo": (cfg["num_heads"] * hd, d)}


def tree_shapes(cfg: dict) -> Dict[Path_, tuple]:
    """Path -> shape of every leaf of a ``hybrid`` or ``moe`` model."""
    d, L, f = cfg["d_model"], cfg["num_layers"], cfg["d_ff"]
    vp = padded_vocab(cfg["vocab_size"])
    out: Dict[Path_, tuple] = {("embed",): (vp, d), ("final_norm",): (d,), ("lm_head",): (vp, d)}
    if cfg["family"] == "hybrid":
        d_in = cfg["ssm_expand"] * d
        h = d_in // cfg["ssm_head_dim"]
        n = cfg["ssm_state"]
        out[("blocks", "ln1")] = (L, d)
        for k, s in {"w_in": (d, 2 * d_in + 2 * n + h), "a_log": (h,), "d_skip": (h,),
                     "dt_bias": (h,), "norm": (d_in,), "w_out": (d_in, d)}.items():
            out[("blocks", "ssm", k)] = (L, *s)
        out[("shared_attn", "ln1")] = (d,)
        out[("shared_attn", "ln2")] = (d,)
        for k, s in _attention(cfg).items():
            out[("shared_attn", "attn", k)] = s
        for k, s in {"wg": (d, f), "wu": (d, f), "wd": (f, d)}.items():
            out[("shared_attn", "mlp", k)] = s
    elif cfg["family"] == "moe":
        e = cfg["moe_experts"]
        out[("blocks", "ln1")] = (L, d)
        out[("blocks", "ln2")] = (L, d)
        for k, s in _attention(cfg).items():
            out[("blocks", "attn", k)] = (L, *s)
        for k, s in {"router": (d, e), "wg": (e, d, f), "wu": (e, d, f),
                     "wd": (e, f, d)}.items():
            out[("blocks", "moe", k)] = (L, *s)
    else:
        raise ValueError(f"no weights for family {cfg['family']!r}")
    return out


def draw_leaf(path: Path_, shape: tuple, seed: int, dtype, device, layers: int) -> torch.Tensor:
    """One leaf of a model of ``layers`` layers, from a generator of its own
    (so leaves can be drawn in any order, or one at a time)."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "w/" + "/".join(path)))
    leaf = path[-1]

    def normal():
        return torch.randn(shape, generator=g, device=device, dtype=dtype)

    def uniform(lo, hi):
        return torch.rand(shape, generator=g, device=device, dtype=torch.float32) * (hi - lo) + lo

    if leaf in NORMS:
        return (1.0 + 0.1 * normal().float()).to(dtype)
    if leaf == "a_log":
        return torch.log(uniform(0.6, 1.2)).to(dtype)
    if leaf == "d_skip":
        return uniform(0.5, 1.5).to(dtype)
    if leaf == "dt_bias":
        return (0.1 * normal().float()).to(dtype)
    if leaf == "embed":
        return normal()
    std = (shape[-1] if leaf == "lm_head" else shape[-2]) ** -0.5
    if leaf in OUT_PROJECTIONS:
        std *= (2 * layers) ** -0.5
    return normal().mul_(std)


def draw_tree(cfg: dict, seed: int, device) -> dict:
    """The whole tree (nested dicts of leaves)."""
    dtype = getattr(torch, cfg["param_dtype"])
    tree: dict = {}
    for path, shape in sorted(tree_shapes(cfg).items()):
        leaf = draw_leaf(path, shape, seed, dtype, device, cfg["num_layers"])
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def nest(path: Path_, leaf) -> dict:
    """A tree that holds one leaf at ``path``."""
    tree: dict = {}
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = leaf
    return tree


def names_of(path: Path_, named) -> list:
    """The program's parameter names that hold ``path``'s leaf: the layers'
    ``blocks.<i>.<rest>`` for a ``blocks`` path, ``a.b`` otherwise."""
    if path[0] == "blocks":
        rest = ".".join(path[1:])
        return [n for n in named if n.startswith("blocks.")
                and n.split(".", 2)[2] == rest and n.split(".")[1].isdigit()]
    return [".".join(path)] if ".".join(path) in named else []
