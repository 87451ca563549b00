"""Synthetic graph generators mirroring the paper's Table VII dataset shapes.

SNAP downloads are unavailable offline, so each dataset is represented by a
synthetic graph at ~1/32 the vertex count with matching average degree and
degree-distribution class:

  amazon    product network   RMAT (a=.57)     0.4M v, deg 9  -> 12.5k v
  stanford  web graph         RMAT (a=.65, skewed) 0.28M v, deg 9 -> 9k v
  youtube   social network    powerlaw (gamma=2.1) 1.16M v, deg 3 -> 36k v
  road-ca   road network      2-D lattice + shortcuts, deg 3      -> 61k v
  comdblp   collaboration     powerlaw clustered, deg 1(dir)      -> 13k v
  google    web graph         RMAT (a=.6) 0.88M v, deg 6          -> 27k v
  notredame web graph         RMAT (a=.63) 0.33M v, deg 5         -> 10k v

The properties AMC exploits (frontier sparsity, degree skew, cross-iteration
stability of the vertex-neighbor relation) are scale-free, so reduced-scale
graphs exercise the same mechanisms; EXPERIMENTS.md §1 records the scaling.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.graphs.csr import CSRGraph, from_edges


def rmat_graph(
    num_vertices: int,
    num_edges: int,
    a: float = 0.57,
    b: float = None,
    c: float = None,
    seed: int = 0,
    name: str = "rmat",
) -> CSRGraph:
    """R-MAT / Kronecker generator (power-law in/out degrees, communities).

    ``b``/``c`` default to an even split of the remaining mass so any
    skew parameter ``a`` < 1 is valid."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(num_vertices, 2))))
    n = 1 << scale
    # Oversample: dedup + self-loop removal eats some edges.
    m = int(num_edges * 1.35)
    if b is None:
        b = (1.0 - a) * 0.35
    if c is None:
        c = (1.0 - a) * 0.35
    d = 1.0 - a - b - c
    assert d >= 0, (a, b, c)
    probs = np.array([a, b, c, d])
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for level in range(scale):
        q = rng.choice(4, size=m, p=probs)
        src = (src << 1) | (q >> 1)
        dst = (dst << 1) | (q & 1)
    # Fold into [0, num_vertices) and permute ids to break bit-structure.
    perm = rng.permutation(n)
    src = perm[src] % num_vertices
    dst = perm[dst] % num_vertices
    g = from_edges(src, dst, num_vertices, name=name)
    if g.num_edges > num_edges:
        keep = np.sort(rng.choice(g.num_edges, size=num_edges, replace=False))
        g = from_edges(
            g.edge_sources()[keep], g.neighbors[keep], num_vertices,
            dedup=False, name=name,
        )
    return g


def powerlaw_graph(
    num_vertices: int,
    num_edges: int,
    gamma: float = 2.1,
    seed: int = 0,
    name: str = "powerlaw",
) -> CSRGraph:
    """Configuration-model graph with power-law out-degrees."""
    rng = np.random.default_rng(seed)
    # Zipf-like degree weights, capped.
    ranks = np.arange(1, num_vertices + 1, dtype=np.float64)
    w = ranks ** (-1.0 / (gamma - 1.0))
    rng.shuffle(w)
    w /= w.sum()
    src = rng.choice(num_vertices, size=int(num_edges * 1.25), p=w)
    dst = rng.choice(num_vertices, size=int(num_edges * 1.25), p=w)
    g = from_edges(src, dst, num_vertices, name=name)
    if g.num_edges > num_edges:
        keep = np.sort(rng.choice(g.num_edges, size=num_edges, replace=False))
        g = from_edges(
            g.edge_sources()[keep], g.neighbors[keep], num_vertices,
            dedup=False, name=name,
        )
    return g


def road_graph(
    num_vertices: int,
    shortcut_frac: float = 0.05,
    seed: int = 0,
    name: str = "road",
) -> CSRGraph:
    """2-D lattice + a few shortcuts: low degree, huge diameter (road-CA class)."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(num_vertices))
    n = side * side
    idx = np.arange(n).reshape(side, side)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    lattice = np.concatenate([right, down])
    # Both directions.
    edges = np.concatenate([lattice, lattice[:, ::-1]])
    n_short = int(n * shortcut_frac)
    s = rng.integers(0, n, size=n_short)
    d = rng.integers(0, n, size=n_short)
    edges = np.concatenate([edges, np.stack([s, d], axis=1)])
    return from_edges(edges[:, 0], edges[:, 1], n, name=name)


# name -> (generator kind, vertices, edges, kwargs). Scaled ~1/8 of Table VII
# (paired with the 1/8-1/16-scaled cache hierarchy in memsim.config.SCALED).
# "tiny" is not a paper input: it is the fast-iteration cell used by the
# stream-protocol tests and the CI streaming smoke (seconds, not minutes).
DATASETS: Dict[str, dict] = {
    "tiny": dict(kind="powerlaw", n=3_000, m=9_000, gamma=2.2, seed=21),
    # "tinyroad" is the long-horizon fast cell: a pure 2-D lattice (no
    # shortcuts) whose huge diameter drives traversal kernels through
    # hundreds of small frontiers — the regime where whole-run batched
    # trace emission beats the per-iteration path hardest (bench-gated).
    "tinyroad": dict(kind="road", n=20_000, shortcut_frac=0.0, seed=18),
    "amazon": dict(kind="rmat", n=50_000, m=424_000, a=0.57, seed=11),
    "stanford": dict(kind="rmat", n=35_000, m=289_000, a=0.65, seed=12),
    "youtube": dict(kind="powerlaw", n=145_000, m=374_000, gamma=2.1, seed=13),
    "road-ca": dict(kind="road", n=246_000, seed=14),
    # "road-8m" is the paper-scale cell: ~2.1M vertices / ~8.4M directed
    # edges, the largest trace the repo emits. Its workload traces exceed
    # memory when materialized whole, so it is only reachable through the
    # ShardedSpec streaming-scoring path (bench-gated for flat peak RSS).
    "road-8m": dict(kind="road", n=2_100_000, seed=19),
    "comdblp": dict(kind="powerlaw", n=54_000, m=45_000, gamma=2.4, seed=15),
    "google": dict(kind="rmat", n=110_000, m=640_000, a=0.60, seed=16),
    "notredame": dict(kind="rmat", n=41_000, m=188_000, a=0.63, seed=17),
}

# Paper Table VII full-scale shapes, for reference and for storage-overhead
# normalization (vertices, edges in millions).
PAPER_SCALE = {
    "amazon": (0.4e6, 3.39e6),
    "stanford": (0.28e6, 2.31e6),
    "youtube": (1.16e6, 2.99e6),
    "road-ca": (1.97e6, 5.53e6),
    "comdblp": (0.43e6, 0.36e6),
    "google": (0.88e6, 5.11e6),
    "notredame": (0.33e6, 1.5e6),
}

_CACHE: Dict[str, CSRGraph] = {}


def make_dataset(name: str, weighted: bool = False, seed_offset: int = 0) -> CSRGraph:
    """Materialize a named synthetic dataset (memoized)."""
    key = f"{name}:{weighted}:{seed_offset}"
    if key in _CACHE:
        return _CACHE[key]
    spec = dict(DATASETS[name])
    kind = spec.pop("kind")
    spec["seed"] = spec.get("seed", 0) + seed_offset
    if kind == "rmat":
        g = rmat_graph(spec["n"], spec["m"], a=spec["a"], seed=spec["seed"], name=name)
    elif kind == "powerlaw":
        g = powerlaw_graph(spec["n"], spec["m"], gamma=spec["gamma"], seed=spec["seed"], name=name)
    elif kind == "road":
        g = road_graph(
            spec["n"],
            shortcut_frac=spec.get("shortcut_frac", 0.05),
            seed=spec["seed"],
            name=name,
        )
    else:  # pragma: no cover
        raise ValueError(kind)
    if weighted:
        rng = np.random.default_rng(spec["seed"] + 999)
        w = rng.integers(1, 16, size=g.num_edges).astype(np.float32)
        g = CSRGraph(g.offsets, g.neighbors, weights=w, name=g.name)
    _CACHE[key] = g
    return g
