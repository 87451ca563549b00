"""Random weights of a configuration, drawn on the device from the seed in
the tree its family's reference reads (``reference/<family>.py``'s
``tree_shapes``), the JAX package's parameter tree layout: nested dicts,
each layer's tensors stacked on axis 0 (``tree["blocks"]["attn"]["wq"]``
is ``(L, D, H hd)``).

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

from perfbench import family_module
from perfbench.traffic import sub_seed

Path_ = Tuple[str, ...]
NORMS = ("ln1", "ln2", "ln3", "norm", "final_norm", "qn", "kn")
OUT_PROJECTIONS = ("wo", "w_out", "wd")  # write into the residual stream


def padded_vocab(v: int) -> int:
    """The vocabulary rows the program's embedding and head hold."""
    return -(-v // 128) * 128


def attention_shapes(cfg: dict) -> Dict[str, tuple]:
    """The q / k / v / o projections' shapes of one attention block."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    return {"wq": (d, cfg["num_heads"] * hd), "wk": (d, cfg["num_kv_heads"] * hd),
            "wv": (d, cfg["num_kv_heads"] * hd), "wo": (cfg["num_heads"] * hd, d)}


def family(cfg: dict):
    """The reference module of ``cfg``'s family (``reference/<family>.py``),
    which owns the family's tree."""
    return family_module("reference", cfg["family"])


def tree_shapes(cfg: dict) -> Dict[Path_, tuple]:
    """Path -> shape of every leaf of the model: the family's
    ``tree_shapes``, the leaves its reference forward reads."""
    return family(cfg).tree_shapes(cfg)


def draw_leaf(cfg: dict, path: Path_, shape: tuple, seed: int, device) -> torch.Tensor:
    """One leaf, from a generator of its own (so leaves can be drawn in any
    order, or one at a time), in the configuration's ``param_dtype``.  The
    family's ``draw_leaf(path, shape, generator, dtype, device, layers)``,
    where it has one, may draw the leaf itself; where it returns ``None``
    this module's rules draw it."""
    dtype = getattr(torch, cfg["param_dtype"])
    layers = cfg["num_layers"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "w/" + "/".join(path)))
    own = getattr(family(cfg), "draw_leaf", None)
    if own is not None:
        leaf = own(path, shape, g, dtype, device, layers)
        if leaf is not None:
            return leaf
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
    tree: dict = {}
    for path, shape in sorted(tree_shapes(cfg).items()):
        leaf = draw_leaf(cfg, path, shape, seed, device)
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
