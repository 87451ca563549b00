"""The port's §VI evolving pair against the JAX package's.

``make_evolving_pair`` draws its masks through ``UniformChurn`` with the
same rng calls in the same order, and builds both runs as induced
subgraphs in the base id space, so the masks and CSR arrays must be
identical to ``repro``'s.  Also: the delta path of the snapshot sequence
(``apply_delta`` of the uniform-churn batch) reproduces run 2, and the
epoch statistics equal the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graphs import make_dataset as j_make_dataset
from repro.graphs import make_evolving_pair as j_make_evolving_pair
from repro.stream import UniformChurn as JUniformChurn
from repro.stream import snapshot_sequence as j_snapshot_sequence

from repro_torch.graphs import make_dataset, make_evolving_pair
from repro_torch.stream import UniformChurn, apply_delta, snapshot_sequence


def _graph_equal(got, ref):
    assert got.name == ref.name
    np.testing.assert_array_equal(got.offsets, ref.offsets)
    np.testing.assert_array_equal(got.neighbors, ref.neighbors)
    assert got.offsets.dtype == ref.offsets.dtype and got.neighbors.dtype == ref.neighbors.dtype
    assert (got.weights is None) == (ref.weights is None)
    if got.weights is not None:
        np.testing.assert_array_equal(got.weights, ref.weights)


@pytest.mark.parametrize("dataset", ["tiny", "comdblp", "notredame"])
@pytest.mark.parametrize("seed", [0, 1])
def test_evolving_pair_equals_jax(dataset, seed):
    got = make_evolving_pair(make_dataset(dataset), seed=seed)
    ref = j_make_evolving_pair(j_make_dataset(dataset), seed=seed)
    for part in ("base", "run1", "run2"):
        _graph_equal(getattr(got, part), getattr(ref, part))
    np.testing.assert_array_equal(got.mask1, ref.mask1)
    np.testing.assert_array_equal(got.mask2, ref.mask2)
    assert got.vertex_overlap == ref.vertex_overlap


def test_weighted_pair_equals_jax():
    got = make_evolving_pair(make_dataset("tiny", weighted=True), seed=3)
    ref = j_make_evolving_pair(j_make_dataset("tiny", weighted=True), seed=3)
    _graph_equal(got.run1, ref.run1)
    _graph_equal(got.run2, ref.run2)


@pytest.mark.parametrize("epochs", [1, 2, 4])
def test_snapshot_sequence_equals_jax(epochs):
    churn = dict(init_frac=0.7, del_frac=0.2, add_frac=0.15)
    got = snapshot_sequence(make_dataset("tiny"), UniformChurn(**churn), epochs, seed=5)
    ref = j_snapshot_sequence(j_make_dataset("tiny"), JUniformChurn(**churn), epochs, seed=5)
    assert got.num_epochs == ref.num_epochs == epochs
    for g, r in zip(got.graphs, ref.graphs):
        _graph_equal(g, r)
    for m, r in zip(got.masks, ref.masks):
        np.testing.assert_array_equal(m, r)
    for b, r in zip(got.batches, ref.batches):
        for f in ("add_src", "add_dst", "del_src", "del_dst"):
            np.testing.assert_array_equal(getattr(b, f), getattr(r, f))
    assert [s.row() for s in got.stats] == [dataclasses.asdict(s) for s in ref.stats]
    assert got.max_edges == ref.max_edges
    for e in range(1, epochs):
        np.testing.assert_array_equal(got.changed_vertices(e), ref.changed_vertices(e))


def test_delta_path_reproduces_run2():
    """Folding the boundary's delta batch into run 1 gives run 2's arrays."""
    seq = snapshot_sequence(make_dataset("comdblp"), UniformChurn(), epochs=2, seed=0)
    g1 = apply_delta(seq.graphs[0], seq.batches[0], name=seq.graphs[1].name)
    _graph_equal(g1, seq.graphs[1])


def test_uniform_churn_rejects_bad_fractions():
    with pytest.raises(ValueError):
        UniformChurn(init_frac=0.0)
    with pytest.raises(ValueError):
        UniformChurn(del_frac=-0.1)
    with pytest.raises(ValueError):
        snapshot_sequence(make_dataset("tiny"), UniformChurn(), epochs=0)
