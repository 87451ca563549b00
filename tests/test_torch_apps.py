"""The port's graphs, PageRankDelta and tracer against the JAX package.

Generators are numpy-RNG only, so the port's copies must give identical
``offsets`` / ``neighbors`` / ``weights``.  PageRankDelta runs on the CPU
here (its neighbor sum through ``index_add_``, which adds in edge order
like ``jax.ops.segment_sum`` on XLA-CPU): the frontier of every iteration
must equal the reference's, and so must the emitted trace.  Final ranks
are compared at ``rtol=1e-6``: only the convergence ``error`` is a
reduction in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.apps import pagerank_delta as j_pgd
from repro.apps.trace import TraceConfig as JTraceConfig
from repro.apps.trace import trace_run as j_trace_run
from repro.graphs import make_dataset as j_make_dataset

from repro_torch.apps import pagerank_delta as t_pgd
from repro_torch.apps.ligra import _segment_min
from repro_torch.apps.trace import TraceConfig as TTraceConfig
from repro_torch.apps.trace import trace_run as t_trace_run
from repro_torch.convert import csr_graph
from repro_torch.graphs import make_dataset as t_make_dataset
from repro_torch.kernels.segment_sum.segment_sum import segment_plan, segment_sum


@pytest.mark.parametrize("name", ["tiny", "comdblp", "tinyroad", "notredame"])
@pytest.mark.parametrize("weighted", [False, True])
def test_generators_identical(name, weighted):
    ref = j_make_dataset(name, weighted=weighted)
    got = t_make_dataset(name, weighted=weighted)
    np.testing.assert_array_equal(got.offsets, ref.offsets)
    np.testing.assert_array_equal(got.neighbors, ref.neighbors)
    if weighted:
        np.testing.assert_array_equal(got.weights, ref.weights)
    else:
        assert got.weights is None and ref.weights is None
    t = got.transpose()
    np.testing.assert_array_equal(t.offsets, ref.transpose().offsets)
    np.testing.assert_array_equal(t.neighbors, ref.transpose().neighbors)


def test_csr_device_and_convert():
    g = t_make_dataset("tiny")
    offsets, neighbors, weights, edge_src = g.device(torch.device("cpu"))
    assert offsets.dtype == torch.int64 and neighbors.dtype == torch.int32
    assert weights.dtype == torch.float32 and edge_src.dtype == torch.int32
    np.testing.assert_array_equal(edge_src.numpy(), g.edge_sources())
    ref = j_make_dataset("tiny")
    c = csr_graph(ref.offsets, ref.neighbors, ref.weights, name="tiny")
    np.testing.assert_array_equal(c.offsets, g.offsets)
    np.testing.assert_array_equal(c.neighbors, g.neighbors)


def test_segment_sum_is_edge_ordered_like_jax():
    """The plain segment sum equals jax.ops.segment_sum bit for bit on a
    sum whose value depends on the addition order."""
    rng = np.random.default_rng(0)
    n_seg, n = 50, 200_000
    ids = rng.integers(0, n_seg, n)
    vals = (rng.random(n, dtype=np.float32) * 10.0 ** rng.integers(-6, 3, n)).astype(np.float32)
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids), num_segments=n_seg))
    plan = segment_plan(ids, n_seg, torch.device("cpu"))
    got = segment_sum(torch.from_numpy(vals), plan)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the input has power: adding in reversed edge order changes some sums
    rev = np.asarray(jax.ops.segment_sum(
        jnp.asarray(vals[::-1]), jnp.asarray(ids[::-1]), num_segments=n_seg))
    assert not np.array_equal(rev, ref)
    with pytest.raises(ValueError):
        segment_sum(torch.from_numpy(vals[:10]), plan)


def test_segment_min_matches_jax():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 30, 1000)
    ids[ids == 7] = 8  # an empty segment
    for vals in (rng.random(1000, dtype=np.float32), rng.integers(0, 999, 1000).astype(np.int32)):
        ref = np.asarray(jax.ops.segment_min(jnp.asarray(vals), jnp.asarray(ids), num_segments=30))
        got = _segment_min(torch.from_numpy(vals), torch.from_numpy(ids), 30)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize(
    "name,direction",
    [("tiny", "push"), ("tiny", "pull"), ("tiny", "auto"),
     ("comdblp", "push"), ("comdblp", "pull")],
)
def test_pgd_frontiers_and_trace_equal(name, direction):
    ref_run = j_pgd(j_make_dataset(name), direction=direction)
    run = t_pgd(t_make_dataset(name), direction=direction, device="cpu")
    assert run.num_iters == ref_run.num_iters
    assert run.directions == ref_run.directions
    assert len(run.frontiers) == len(ref_run.frontiers)
    for i, (a, b) in enumerate(zip(run.frontiers, ref_run.frontiers)):
        np.testing.assert_array_equal(a, b, err_msg=f"iteration {i}")
    np.testing.assert_allclose(run.values, ref_run.values, rtol=1e-6)
    assert run.stats == ref_run.stats
    g = ref_run.graph
    kw = dict(num_vertices=g.num_vertices, num_edges=g.num_edges)
    got, ref = t_trace_run(run, TTraceConfig(**kw)), j_trace_run(ref_run, JTraceConfig(**kw))
    for f in ("array_id", "elem", "addr", "block", "src_vertex", "iter_bounds"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert got.directions == ref.directions
