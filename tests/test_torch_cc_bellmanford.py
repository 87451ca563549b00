"""The port's cc, bellmanford and partitioner against the JAX package.

Both kernels reduce with a min, which does not depend on the order of the
edges, so on the same graph the port's labels and distances must be bit
for bit the JAX package's, and so must every iteration's frontier and
direction, in push, pull and auto, and the emitted trace.  The iteration
counts on comdblp are the JAX package's own (cc 12, bellmanford 15,
``tests/test_kernel_registry.py``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.apps import get_kernel as j_get_kernel
from repro.apps.trace import TraceConfig as JTraceConfig
from repro.apps.trace import trace_run as j_trace_run
from repro.graphs import make_dataset as j_make_dataset
from repro.graphs.csr import from_edges as j_from_edges
from repro.graphs.partition import bfs_reorder as j_bfs_reorder
from repro.graphs.partition import partition_contiguous as j_partition

from repro_torch.apps import get_kernel as t_get_kernel
from repro_torch.apps.trace import TraceConfig as TTraceConfig
from repro_torch.apps.trace import trace_run as t_trace_run
from repro_torch.graphs import bfs_reorder as t_bfs_reorder
from repro_torch.graphs import make_dataset as t_make_dataset
from repro_torch.graphs import partition_contiguous as t_partition
from repro_torch.graphs.csr import from_edges as t_from_edges

COMDBLP_ITERS = {"cc": 12, "bellmanford": 15}


@functools.lru_cache(maxsize=None)
def graphs(name: str, weighted: bool):
    """(JAX graph, port graph, present mask or None) from one seed.

    ``random`` is a directed multigraph of 600 vertices and 4,000 edges
    with uniform weights in [1, 10) and 10 % of its vertices absent."""
    if name != "random":
        return j_make_dataset(name, weighted=weighted), t_make_dataset(name, weighted=weighted), None
    rng = np.random.default_rng(7)
    n, m = 600, 4000
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    w = rng.uniform(1.0, 10.0, m).astype(np.float32) if weighted else None
    present = rng.random(n) < 0.9
    return (
        j_from_edges(src, dst, n, weights=w, name="random"),
        t_from_edges(src, dst, n, weights=w, name="random"),
        present,
    )


@functools.lru_cache(maxsize=None)
def runs(kernel: str, name: str, direction: str):
    """(JAX AppRun, port AppRun) of ``kernel`` on one graph."""
    jk, tk = j_get_kernel(kernel), t_get_kernel(kernel)
    jg, tg, present = graphs(name, jk.weighted)
    kw = {} if present is None else dict(present_mask=present)
    return jk.run(jg, direction=direction, **kw), tk.run(tg, direction=direction, device="cpu", **kw)


@pytest.mark.parametrize("direction", ["push", "pull", "auto"])
@pytest.mark.parametrize("name", ["random", "comdblp"])
@pytest.mark.parametrize("kernel", ["cc", "bellmanford"])
def test_frontiers_directions_and_values_equal(kernel, name, direction):
    ref, run = runs(kernel, name, direction)
    assert run.num_iters == ref.num_iters
    if name == "comdblp":
        assert run.num_iters == COMDBLP_ITERS[kernel]
    assert run.directions == ref.directions
    assert len(run.frontiers) == len(ref.frontiers)
    for i, (a, b) in enumerate(zip(run.frontiers, ref.frontiers)):
        np.testing.assert_array_equal(a, b, err_msg=f"iteration {i}")
    assert run.values.dtype == np.float32
    np.testing.assert_array_equal(run.values, np.asarray(ref.values))
    assert run.stats == ref.stats


@pytest.mark.parametrize("direction", ["push", "pull"])
@pytest.mark.parametrize("kernel", ["cc", "bellmanford"])
def test_traces_equal(kernel, direction):
    ref, run = runs(kernel, "comdblp", direction)
    g = ref.graph
    kw = dict(num_vertices=g.num_vertices, num_edges=g.num_edges)
    got, want = t_trace_run(run, TTraceConfig(**kw)), j_trace_run(ref, JTraceConfig(**kw))
    assert got.num_iters == want.num_iters
    for f in ("array_id", "elem", "addr", "block", "src_vertex", "iter_bounds"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.directions == want.directions


def test_auto_direction_switches_on_comdblp():
    """The direction-optimizing switch really goes dense on some iteration
    of cc (its first frontier is every present vertex)."""
    _, run = runs("cc", "comdblp", "auto")
    assert "pull" in run.directions and run.stats["dense_iters"] > 0


@pytest.mark.parametrize("name", ["random", "comdblp"])
def test_partition_equal(name):
    jg, tg, _ = graphs(name, True)
    np.testing.assert_array_equal(t_bfs_reorder(tg, seed=3), j_bfs_reorder(jg, seed=3))
    t_parts, t_part = t_partition(tg, num_parts=4)
    j_parts, j_part = j_partition(jg, num_parts=4)
    np.testing.assert_array_equal(t_part, j_part)
    for a, b in zip(t_parts, j_parts):
        assert a.name == b.name
        for f in ("offsets", "neighbors", "weights"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
