"""Build the port's carried state, graphs and models from plain numpy
arrays.

The JAX package hands its :class:`CacheState` carries, demand-simulation
carries, CSR graphs, evolving pairs and model parameters out as numpy
arrays; these functions turn such arrays into the port's objects, so a pass
of the port can resume exactly where a pass of the JAX package stopped (the
cross-package shard seam), the port's apps can run on a pair the JAX
package made, and the port's model can run the JAX package's weights.
``random_lm_tree`` draws a parameter tree of the JAX package's layout from
a numpy seed, for runs that hold the two packages' models against each
other where JAX is not installed.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.evolve import EvolvingGraphPair
from repro_torch.memsim.engine import CacheState
from repro_torch.memsim.hierarchy import DemandState
from repro_torch.models.model import LM


def cache_state(tags: np.ndarray, age: np.ndarray, device: DeviceLike = None) -> CacheState:
    """A :class:`CacheState` from ``(sets, ways)`` tag and age arrays."""
    dev = resolve_device(device)
    tags = np.asarray(tags)
    age = np.asarray(age)
    if tags.shape != age.shape or tags.ndim != 2:
        raise ValueError(f"tags {tags.shape} and age {age.shape} must be one (sets, ways) shape")
    return CacheState(
        torch.from_numpy(tags.astype(np.int32)).to(dev),
        torch.from_numpy(age.astype(np.int32)).to(dev),
    )


def demand_state(
    levels: Sequence[Tuple[np.ndarray, np.ndarray]],
    pos_offset: int,
    device: DeviceLike = None,
) -> DemandState:
    """A :class:`DemandState` from the L1, L2 and LLC ``(tags, age)`` pairs
    and the global position of the next access."""
    if len(levels) != 3:
        raise ValueError("a demand state has three levels: L1, L2, LLC")
    l1, l2, llc = (cache_state(t, a, device) for t, a in levels)
    return DemandState(l1=l1, l2=l2, llc=llc, pos_offset=int(pos_offset))


def csr_graph(
    offsets: np.ndarray,
    neighbors: np.ndarray,
    weights: Optional[np.ndarray] = None,
    name: str = "graph",
) -> CSRGraph:
    """A validated :class:`CSRGraph` over the same arrays (int64 offsets,
    int32 neighbors, float32 weights)."""
    g = CSRGraph(
        offsets=np.asarray(offsets, dtype=np.int64),
        neighbors=np.asarray(neighbors, dtype=np.int32),
        weights=None if weights is None else np.asarray(weights, dtype=np.float32),
        name=name,
    )
    g.validate()
    return g


def _graph(g) -> CSRGraph:
    return csr_graph(g.offsets, g.neighbors, g.weights, name=g.name)


def evolving_pair(base, run1, run2, mask1: np.ndarray, mask2: np.ndarray) -> EvolvingGraphPair:
    """An :class:`EvolvingGraphPair` from three CSR graphs (any objects with
    ``offsets``, ``neighbors``, ``weights`` and ``name``, such as the JAX
    package's) and the two presence masks."""
    return EvolvingGraphPair(
        base=_graph(base),
        run1=_graph(run1),
        run2=_graph(run2),
        mask1=np.asarray(mask1, dtype=bool),
        mask2=np.asarray(mask2, dtype=bool),
    )


def _leaf(tree: Dict[str, Any], name: str) -> np.ndarray:
    """The JAX pytree leaf of a port parameter name: ``blocks.<i>.a.b`` is
    ``tree["blocks"]["a"]["b"][i]`` (layers stacked on axis 0); any other
    ``a.b`` is ``tree["a"]["b"]``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        node = tree["blocks"]
        for key in parts[2:]:
            node = node[key]
        return np.asarray(node)[int(parts[1])]
    node = tree
    for key in parts:
        node = node[key]
    return np.asarray(node)


def lm_params_from_numpy(cfg, tree: Dict[str, Any], device: DeviceLike = None) -> LM:
    """The port's model holding a JAX parameter pytree with numpy leaves
    (``np.asarray`` of ``repro.models.init_params``'s), name for name, in
    ``cfg.param_dtype``."""
    dev = resolve_device(device)
    model = LM(cfg, device=dev)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = _leaf(tree, name)
            if tuple(leaf.shape) != tuple(p.shape):
                raise ValueError(f"{name}: tree leaf {leaf.shape} != parameter {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(leaf, dtype=np.float32)).to(dev))
    return model


def lm_tree_shapes(cfg) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """Path -> shape of every leaf of the JAX package's parameter pytree of
    ``cfg`` (layers stacked on axis 0), from the port's module tree."""
    model = LM(cfg, device="meta")
    shapes: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            shapes[("blocks", *parts[2:])] = (cfg.num_layers, *p.shape)
        else:
            shapes[tuple(parts)] = tuple(p.shape)
    return shapes


def random_lm_tree(cfg, seed: int) -> Dict[str, Any]:
    """A float32 parameter pytree of the JAX package's layout drawn from
    ``numpy.random.default_rng(seed)``, leaf by leaf in sorted path order:

    - norms (``ln*``, ``norm``, ``final_norm``, ``qn``, ``kn``):
      ``1 + 0.1 N(0, 1)``;
    - ``a_log``: ``log U(0.6, 1.2)`` (decay rates a in [-1.2, -0.6]);
    - ``d_skip``: ``U(0.5, 1.5)``; ``dt_bias``: ``0.1 N(0, 1)``;
    - every matrix: ``N(0, 1 / fan_in)``, fan_in the model width for
      ``embed`` and ``lm_head`` and the input axis for the others.
    """
    rng = np.random.default_rng(seed)
    tree: Dict[str, Any] = {}
    for path, shape in sorted(lm_tree_shapes(cfg).items()):
        leaf = path[-1]
        if leaf.startswith("ln") or leaf in ("norm", "final_norm", "qn", "kn"):
            x = 1.0 + 0.1 * rng.normal(size=shape)
        elif leaf == "a_log":
            x = np.log(rng.uniform(0.6, 1.2, size=shape))
        elif leaf == "d_skip":
            x = rng.uniform(0.5, 1.5, size=shape)
        elif leaf == "dt_bias":
            x = 0.1 * rng.normal(size=shape)
        else:
            fan_in = shape[-1] if leaf in ("embed", "lm_head") else shape[-2]
            x = rng.normal(size=shape) / np.sqrt(fan_in)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[leaf] = x.astype(np.float32)
    return tree


__all__ = [
    "cache_state",
    "csr_graph",
    "demand_state",
    "evolving_pair",
    "lm_params_from_numpy",
    "lm_tree_shapes",
    "random_lm_tree",
]
