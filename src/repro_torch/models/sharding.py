"""Sharding rules: the parameter, batch and cache layouts on the production
mesh (the port of ``repro/models/sharding.py``).

Mesh axes: ("pod", "data", "model") multi-pod / ("data", "model") single-pod.
  - batch        -> ("pod", "data") (pure DP across pods: only the gradient
                    all-reduce crosses the slow inter-pod links)
  - vocab, d_ff, attention heads, experts' f dim -> "model" (TP)
  - parameters' d_model/d_ff input dims -> "data" (FSDP/ZeRO-3 style)
  - attention replicated on "model" for archs whose head count does not
    divide the model axis (smollm 15H, whisper 6H, qwen2-vl 28H).

The rules are the JAX package's, resolved per leaf by its path with
divisibility checked against the mesh.  A layout is the port's own
partition spec: a tuple with one entry per tensor dim, each a mesh-axis
name, a tuple of names (the dim split over several axes, major first) or
``None`` (not split); :func:`placements` turns it into DTensor placements
on a ``DeviceMesh``.  A mesh is a ``DeviceMesh`` or anything with
``axis_names`` and a ``shape`` dict (the JAX ``Mesh``'s fields).

The JAX package stacks each layer list into one leaf ``(L, ...)``; the
port keeps a module a layer.  A layer's parameter takes the JAX spec of
its stacked leaf (``convert._leaf``'s mapping) without the leading layer
dim, which no rule splits.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication, local_map

from repro_torch.configs.base import ModelConfig

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a JAX-style mesh."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def _div(n: int, mesh, axis: Optional[str]) -> bool:
    axes = mesh_axes(mesh)
    return axis in axes and n % axes[axis] == 0


# FSDP (weight sharding over the data axis) pays a per-layer all-gather on
# every step.  For models whose full train state (p + g + m + v) fits one
# device with room for activations, replicating weights across the data
# axis removes those gathers: the only cross-data collective left is the
# gradient all-reduce.
FSDP_STATE_BYTES_THRESHOLD = 12e9


def _itemsize(name: str) -> int:
    return getattr(torch, name).itemsize


def _use_fsdp(cfg: ModelConfig) -> bool:
    per_param = 2 * _itemsize(cfg.param_dtype) + 2 * _itemsize(cfg.opt_state_dtype)
    return cfg.param_count() * per_param > FSDP_STATE_BYTES_THRESHOLD


def param_spec(cfg: ModelConfig, mesh, path: str, shape: Sequence[int]) -> Spec:
    """The spec of one leaf of the JAX package's parameter tree (``path``
    '/'-joined, ``shape`` the stacked leaf's)."""
    fsdp = "data" if _use_fsdp(cfg) else None
    tp = "model"
    nd = len(shape)
    spec = [None] * nd

    def ok(dim_size, axis):
        return _div(dim_size, mesh, axis)

    name = path.split("/")[-1]
    stacked = path.startswith("blocks/") or path.startswith("encoder/")
    lead = 1 if stacked and nd >= 2 else 0  # the stacked layer dim
    heads_shardable = cfg.num_heads > 0 and ok(cfg.num_heads, tp)

    if name in ("embed", "lm_head"):
        if ok(shape[0], tp):
            spec[0] = tp
        if ok(shape[1], fsdp):
            spec[1] = fsdp
    elif name in ("wq", "wk", "wv"):
        if ok(shape[lead], fsdp):
            spec[lead] = fsdp
        out_ok = heads_shardable if name == "wq" else ok(cfg.num_kv_heads, tp)
        if out_ok and ok(shape[lead + 1], tp):
            spec[lead + 1] = tp
    elif name == "wo":
        if heads_shardable and ok(shape[lead], tp):
            spec[lead] = tp
        if ok(shape[lead + 1], fsdp):
            spec[lead + 1] = fsdp
    elif name in ("wg", "wu", "w_in"):  # (L?, [E,] D, F), (L, D, K)
        if ok(shape[-1], tp):
            spec[-1] = tp
        if ok(shape[-2], fsdp):
            spec[-2] = fsdp
    elif name in ("wd", "w_out"):  # (L?, [E,] F, D), (L, d_inner, D)
        if ok(shape[-2], tp):
            spec[-2] = tp
        if ok(shape[-1], fsdp):
            spec[-1] = fsdp
    elif name == "router":
        if ok(shape[-2], fsdp):
            spec[-2] = fsdp
    elif name == "norm" and nd >= 2:  # the SSM's gated norm (L, d_inner)
        if ok(shape[-1], tp):
            spec[-1] = tp
    # norms, scalars, biases: replicated
    return tuple(spec)


STACKED = ("blocks", "encoder")  # the layer lists the JAX package stacks


def leaf_path(name: str) -> Tuple[str, bool]:
    """``(JAX path, is a layer's)`` of a port parameter name:
    ``blocks.<i>.attn.wq`` is ``blocks/attn/wq`` of the stacked leaf;
    ``encoder.final_norm`` and the rest keep their path."""
    parts = name.split(".")
    if parts[0] in STACKED and len(parts) > 2 and parts[1].isdigit():
        return "/".join([parts[0]] + parts[2:]), True
    return "/".join(parts), False


def params_shardings(cfg: ModelConfig, mesh, params) -> Dict[str, Spec]:
    """``{parameter name: spec}`` of an ``LM`` (or of a mapping from
    parameter names to tensors of their shapes, like AdamW's ``m``)."""
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else params
    depth = {"blocks": cfg.num_layers, "encoder": cfg.encoder_layers}
    out = {}
    for name, p in named.items():
        path, layer = leaf_path(name)
        if layer:
            spec = param_spec(cfg, mesh, path, (depth[path.split("/")[0]], *p.shape))
            assert spec[0] is None, (name, spec)
            spec = spec[1:]
        else:
            spec = param_spec(cfg, mesh, path, tuple(p.shape))
        out[name] = spec
    return out


def _batch_size(mesh) -> int:
    axes = mesh_axes(mesh)
    return int(np.prod([axes[a] for a in batch_axes(mesh)]))


def _batch_entry(mesh):
    """The batch axes as a spec entry: one name alone, as ``PartitionSpec``
    normalizes ``("data",)``."""
    ba = batch_axes(mesh)
    return ba if len(ba) > 1 else ba[0]


def batch_shardings(cfg: ModelConfig, mesh, batch: Mapping[str, torch.Tensor]) -> Dict[str, Spec]:
    """Input batch: leading dim over (pod, data) when divisible."""
    ba, n_b = _batch_entry(mesh), _batch_size(mesh)

    def spec(shape):
        if shape and shape[0] % n_b == 0 and shape[0] > 1:
            return (ba,) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    return {k: spec(tuple(v.shape)) for k, v in batch.items()}


def cache_shardings(cfg: ModelConfig, mesh, cache: Mapping[str, torch.Tensor],
                    seq_sharded: bool) -> Dict[str, Spec]:
    """Decode cache: batch-sharded normally; the sequence dim (dim 2 of
    ``(L, B, S, KV, hd)``) over ``data`` when ``seq_sharded`` (long_500k)."""
    ba, n_b = _batch_entry(mesh), _batch_size(mesh)
    n_data = mesh_axes(mesh)["data"]

    def spec(shp):
        nd = len(shp)
        if nd == 1:  # lengths
            return (None,)
        # caches have a leading layer/group dim, batch at dim 1
        if seq_sharded:
            if nd >= 3 and shp[2] % n_data == 0 and shp[2] > 1:
                return (None, None, "data") + (None,) * (nd - 3)
            return (None,) * nd
        if nd >= 2 and shp[1] % n_b == 0 and shp[1] > 1:
            return (None, ba) + (None,) * (nd - 2)
        return (None,) * nd

    return {k: spec(tuple(v.shape)) for k, v in cache.items()}


# --------------------------------------------------------------------------
# Specs on a DeviceMesh
# --------------------------------------------------------------------------


def placements(spec: Spec, mesh) -> list:
    """The DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(d)``
    on each mesh dim that tensor dim ``d`` names, ``Replicate()`` on the
    others.  A dim split over several axes is split over them in mesh
    order, major first, as the JAX spec's tuple orders them."""

    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, entry in enumerate(spec):
        for axis in (entry,) if isinstance(entry, str) else (entry or ()):
            out[mesh.mesh_dim_names.index(axis)] = Shard(d)
    return out


def distribute(tensors: Mapping[str, torch.Tensor], specs: Mapping[str, Spec], mesh) -> dict:
    """``{name: DTensor}`` of whole tensors laid out by their specs, each
    rank keeping its shard of its own copy: every rank must hold the same
    whole tensors (``init_params`` with one seed, the same batch), and no
    collective runs."""
    return {k: to_layout(t, mesh, placements(specs[k], mesh)) for k, t in tensors.items()}


@torch.no_grad()
def distribute_params(model: nn.Module, mesh) -> nn.Module:
    """Lay ``model``'s parameters out on ``mesh`` by the plan, in place:
    each becomes a DTensor parameter holding this rank's shard of it (every
    rank must hold the same whole model, as ``init_params`` with one seed
    gives)."""
    specs = params_shardings(model.cfg, mesh, model)
    for name, p in list(model.named_parameters()):
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        d = distribute({name: p.data}, specs, mesh)[name]
        setattr(mod, attr, nn.Parameter(d, requires_grad=p.requires_grad))
    return model


# --------------------------------------------------------------------------
# Layout hints inside the step
# --------------------------------------------------------------------------

_AMBIENT = []  # the meshes of the enclosing use_mesh() blocks, innermost last


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Make ``mesh`` the ambient mesh of :func:`shard_hint` (the JAX
    package's ``with mesh:``)."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def resolve_spec(mesh, spec: Sequence) -> Spec:
    """``"batch"`` becomes the mesh's batch axes; names the mesh lacks
    become ``None``."""
    names = mesh_axes(mesh)
    ba = _batch_entry(mesh)
    return tuple(ba if s == "batch" else (s if s in names else None) for s in spec)


@contextlib.contextmanager
def step_context(model: nn.Module) -> Iterator:
    """The context a step runs in: for a model whose parameters are
    DTensors, their mesh made ambient (:func:`use_mesh`) and plain tensors
    (positions, masks, constants) taken as replicated on it
    (``implicit_replication``); nothing otherwise."""

    p = next(model.parameters(), None)
    if not isinstance(p, DTensor):
        yield
        return
    with use_mesh(p.device_mesh), implicit_replication():
        yield


def to_layout(t, mesh, placements_):
    """``t`` as a DTensor laid out as ``placements_``: a DTensor
    redistributed, a plain tensor (the same whole tensor on every rank)
    split without a collective."""

    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements_)
    return distribute_tensor(t, mesh, placements_, src_data_rank=None)


def whole(t):
    """A DTensor gathered whole on every rank (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _rows_layout(placements_, dims: Sequence[int]) -> list:
    """The cache's placements carried to a tensor whose dim i is the
    cache's dim ``dims[i]``; a split cache dim the tensor lacks raises."""

    out = []
    for p in placements_:
        if p.is_shard():
            if p.dim not in dims:
                raise ValueError(f"the written dim {p.dim} of the cache is split: {placements_}")
            out.append(Shard(dims.index(p.dim)))
        else:
            out.append(Replicate())
    return out


def write_rows(pos, *pairs):
    """``cache[b, pos[b]] = val[b]`` for every row b and each ``(cache,
    val)`` of ``pairs``, in place: ``cache`` (B, S, ...), ``pos`` (B,),
    ``val`` (B, ...).  A DTensor cache split by rows (or not at all) is
    written by each rank into its own rows, ``pos`` and ``val`` taken to
    its layout; a plain cache (whole on every rank) takes ``val`` whole."""
    if not isinstance(pairs[0][0], DTensor):
        rows = torch.arange(pairs[0][0].shape[0], device=pairs[0][0].device)
        pos = whole(pos).long()
        for cache, val in pairs:
            cache[rows, pos] = whole(val)
        return
    for cache, val in pairs:
        mesh, pl = cache.device_mesh, cache.placements
        nd = cache.ndim
        p = to_layout(pos, mesh, _rows_layout(pl, [0])).to_local()
        val = to_layout(val, mesh, _rows_layout(pl, [0] + list(range(2, nd)))).to_local()
        cache = cache.to_local()
        cache[torch.arange(cache.shape[0], device=cache.device), p.long()] = val


def assign(dst, src):
    """``dst.copy_(src)`` with ``src`` taken to ``dst``'s layout (a DTensor
    ``dst``) or whole (a plain one)."""

    if isinstance(dst, DTensor):
        dst.to_local().copy_(to_layout(src, dst.device_mesh, dst.placements).to_local())
    else:
        dst.copy_(whole(src))


def argmax_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.argmax(x, dim=-1)``; for a DTensor whose last dim (the
    vocabulary) is split, each rank's argmax of its part, then the largest
    ``(value, index)`` pair over the ranks that split it, ties to the lower
    index as ``torch.argmax`` takes them: all-gathers of the rows' values
    and indices a mesh dim, not of the logits (DTensor's own argmax asks
    its offsets of tensors a fake-tensor trace cannot read)."""

    last = x.ndim - 1
    if not isinstance(x, DTensor) or not any(p.is_shard(last) for p in x.placements):
        return torch.argmax(x, dim=-1)
    mesh, pl = x.device_mesh, x.placements
    local = x.to_local()
    idx = torch.argmax(local, dim=-1)
    val = torch.gather(local, -1, idx[..., None])[..., 0]
    chunk, n = 0, 1  # this rank's part of the split dim, major mesh dim first
    for d, p in enumerate(pl):
        if p.is_shard(last):
            chunk = chunk * mesh.size(d) + mesh.get_local_rank(d)
            n *= mesh.size(d)
    if x.shape[-1] % n:
        raise ValueError(f"the last dim {x.shape[-1]} is not split evenly over {n}")
    idx = idx + chunk * local.shape[-1]
    rep = [Replicate()] * mesh.ndim
    for d, p in enumerate(pl):
        if not p.is_shard(last):
            continue
        # an all-gather over mesh dim d alone
        over_d = [Shard(0) if i == d else Replicate() for i in range(mesh.ndim)]
        vals, idxs = (DTensor.from_local(t[None], mesh, over_d, run_check=False).redistribute(
            mesh, rep).to_local() for t in (val, idx))
        best = vals.amax(dim=0)
        idx = torch.where(vals == best, idxs, torch.iinfo(idxs.dtype).max).amin(dim=0)
        val = best
    return DTensor.from_local(idx, mesh, [Replicate() if p.is_shard(last) else p for p in pl],
                              run_check=False)


def act_hint(x, heads: int = 0, heads_dim: int = -1):
    """Lay an activation out as the plan implies, on the ambient mesh: its
    rows (dim 0) over the batch axes where they divide them, dim
    ``heads_dim`` over ``model`` where ``heads`` (the count of heads laid
    along it, outermost) divides that axis, every other dim whole.  DTensor
    may leave a product's result split where the plan does not (the
    sequence, or a heads dim over a count of heads the axis does not
    divide), and a view of it then has no layout; this pins it.  A no-op
    off a mesh and on a tensor that is not a DTensor."""

    mesh = _AMBIENT[-1] if _AMBIENT else None
    if mesh is None or not isinstance(x, DTensor):
        return x
    axes = mesh_axes(mesh)
    spec = [None] * x.ndim
    if x.shape[0] % _batch_size(mesh) == 0:
        spec[0] = "batch"
    if heads and "model" in axes and heads % axes["model"] == 0:
        spec[heads_dim] = "model"
    return shard_hint(x, *spec)


def local_on_mesh(fn, args, dims, out_dims, split_heads: bool):
    """``fn(*args)`` on each rank's shards (``local_map``) where DTensor would
    have to merge a batch dim split over ``data`` with a heads dim split
    over ``model`` (an einsum's ``bmm``), which it cannot lay out.  ``dims``
    gives each arg's ``(rows dim, heads dim)`` (``None``: it has none): the
    rows are laid out over the batch axes where the batch divides them, the
    heads over ``model`` with ``split_heads``, every other dim whole;
    ``fn`` computes each (row, head) slice on its own, and its outputs take
    the layouts of ``out_dims``."""

    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    batch = next(a.shape[r] for a, (r, _) in zip(args, dims) if r is not None)
    rows = batch % _batch_size(mesh) == 0
    ba = batch_axes(mesh)

    def lay(rdim, hdim):
        return [Shard(rdim) if rows and rdim is not None and name in ba else
                Shard(hdim) if split_heads and hdim is not None and name == "model" else
                Replicate() for name in mesh.mesh_dim_names]

    in_pl = [lay(*d) for d in dims]
    args = [to_layout(a, mesh, p) for a, p in zip(args, in_pl)]
    out_pl = tuple(lay(*d) for d in out_dims)
    return local_map(fn, out_pl if len(out_pl) > 1 else out_pl[0], in_placements=in_pl,
                     device_mesh=mesh)(*args)


def splits_heads(heads: int) -> bool:
    """Whether ``heads`` divide the ambient mesh's ``model`` axis."""
    mesh = _AMBIENT[-1] if _AMBIENT else None
    axes = mesh_axes(mesh) if mesh is not None else {}
    return "model" in axes and heads % axes["model"] == 0


def reduce_partial(x):
    """A DTensor with partial (pending-reduction) placements reduced to
    replicated there; anything else as it is.  An embedding lookup into a
    vocabulary split over ``model`` leaves its rows partial (each rank holds
    the rows of its own part of the vocabulary), and DTensor reduces them
    only before the op right after it."""

    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def shard_hint(x, *spec):
    """Lay the DTensor ``x`` out as ``spec`` on the ambient mesh (the JAX
    package's ``with_sharding_constraint``).  A no-op outside a mesh with
    a ``data`` axis, and on a tensor that is not a DTensor."""

    mesh = _AMBIENT[-1] if _AMBIENT else None
    if mesh is None or "data" not in mesh_axes(mesh) or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(resolve_spec(mesh, spec), x.device_mesh))


__all__ = [
    "FSDP_STATE_BYTES_THRESHOLD",
    "act_hint",
    "argmax_last",
    "assign",
    "batch_axes",
    "batch_shardings",
    "cache_shardings",
    "distribute",
    "distribute_params",
    "local_on_mesh",
    "leaf_path",
    "mesh_axes",
    "param_spec",
    "params_shardings",
    "placements",
    "reduce_partial",
    "shard_hint",
    "splits_heads",
    "step_context",
    "to_layout",
    "use_mesh",
    "whole",
    "write_rows",
]
