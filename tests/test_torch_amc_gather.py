"""The port's AMC gather kernels (K4a, K4b) and ``AMCGatherSession``
against the JAX package.

The plain PyTorch versions (CPU tensors) are held against the Pallas
kernels in interpret mode: K4a exactly (a copy), K4b at ``rtol=1e-5`` on
non-empty segments (the JAX package's own tolerance; the Pallas kernel
leaves empty segments unwritten), and exactly against the JAX oracle
``gather_segment_sum_ref``, which adds in index order as ``index_add_``
does on the CPU and zero-fills empty segments.  The session gives the
reference's outputs and ``stats`` on the JAX package's replay case and on
vertex-keyed streams of an evolving pair.  The kernels themselves run
against the plain versions on a card in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # bare environment: seeded stub strategies
    from _hypothesis_fallback import given, settings, st

import jax.numpy as jnp

from repro.kernels.amc_gather.amc_gather import amc_gather as pallas_gather
from repro.kernels.amc_gather.amc_gather import amc_gather_segment_sum as pallas_segment_sum
from repro.kernels.amc_gather.ops import AMCGatherSession as JSession
from repro.kernels.amc_gather.ref import gather_segment_sum_ref as j_segment_sum_ref

from repro_torch.kernels.amc_gather import amc_gather as t_amc_gather
from repro_torch.kernels.amc_gather.amc_gather import (
    amc_gather,
    amc_gather_plain,
    amc_gather_segment_sum,
    amc_gather_segment_sum_plain,
)
from repro_torch.kernels.amc_gather.ops import AMCGatherSession
from repro_torch.kernels.amc_gather.ref import gather_ref, gather_segment_sum_ref

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@given(
    v=st.integers(8, 128),
    d=st.sampled_from([3, 8, 128]),
    n=st.integers(1, 64),
    bf16=st.sampled_from([False, True]),
    seed=st.integers(0, 20),
)
@settings(max_examples=12, deadline=None)
def test_k4a_plain_matches_pallas(v, d, n, bf16, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(0, v, n).astype(np.int32)
    jt = jnp.asarray(table, jnp.bfloat16 if bf16 else jnp.float32)
    tt = _t(table).to(torch.bfloat16 if bf16 else torch.float32)
    got = amc_gather(tt, _t(idx))
    assert got.dtype == tt.dtype and got.shape == (n, d)
    want = np.asarray(pallas_gather(jt, jnp.asarray(idx), interpret=True).astype(jnp.float32))
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)


def _segments(rng, n, nseg, all_nonempty):
    if all_nonempty:  # the JAX test's construction: every segment present
        return np.sort(np.concatenate([np.arange(nseg), rng.integers(0, nseg, n - nseg)]))
    return np.sort(rng.integers(0, nseg, n))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("all_nonempty", [True, False])
def test_k4b_plain_matches_pallas_and_oracle(seed, all_nonempty):
    rng = np.random.default_rng(seed)
    v, d, n, nseg = 64, 32, 50, 8 if all_nonempty else 30
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(0, v, n).astype(np.int32)
    segs = _segments(rng, n, nseg, all_nonempty).astype(np.int32)
    got = amc_gather_segment_sum(_t(table), _t(idx), _t(segs), nseg).numpy()
    oracle = np.asarray(j_segment_sum_ref(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(segs), nseg))
    np.testing.assert_array_equal(got, oracle)  # empty segments are 0 in both
    pallas = np.asarray(pallas_segment_sum(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(segs), nseg, interpret=True))
    filled = np.unique(segs)
    np.testing.assert_allclose(got[filled], pallas[filled], rtol=1e-5)
    empty = np.setdiff1d(np.arange(nseg), filled)
    assert all_nonempty == (len(empty) == 0)
    assert not got[empty].any()


def test_k4b_long_segment_and_bf16():
    """One segment holding all of N, in float32 and bfloat16, and N = 0."""
    rng = np.random.default_rng(9)
    table = rng.normal(size=(40, 6)).astype(np.float32)
    idx = rng.integers(0, 40, 2000).astype(np.int32)
    segs = np.full(2000, 2, np.int32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        got = amc_gather_segment_sum(_t(table).to(tdt), _t(idx), _t(segs), 5)
        assert got.dtype == tdt
        want = j_segment_sum_ref(jnp.asarray(table, jdt), jnp.asarray(idx), jnp.asarray(segs), 5)
        np.testing.assert_array_equal(
            got.to(torch.float32).numpy(), np.asarray(want.astype(jnp.float32)))
    zero = amc_gather_segment_sum(_t(table), _t(idx[:0]), _t(segs[:0]), 3)
    assert zero.shape == (3, 6) and not zero.any()


# ------------------------------------------------------------ session


def _run_sessions(table, streams):
    """Both packages' sessions over the same index streams, with an
    ``update()`` between streams; returns the outputs and stats of each."""
    jsess, tsess = JSession(interpret=True), AMCGatherSession(device="cpu")
    jt, tt = jnp.asarray(table), _t(table)
    outs = []
    for k, idx in enumerate(streams):
        if k:
            jsess.update()
            tsess.update()
        want = np.asarray(jsess.gather(jt, jnp.asarray(idx, jnp.int32)))
        got = tsess.gather(tt, idx.astype(np.int32)).numpy()
        outs.append((got, want))
    return outs, tsess.stats, jsess.stats


def test_session_replay_case_equals_jax():
    """The JAX package's replay case (``tests/test_kernels.py``)."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=(32, 16)).astype(np.float32)
    idx1 = rng.integers(0, 32, 20)
    idx2 = idx1.copy()
    idx2[[3, 7]] = (idx2[[3, 7]] + 5) % 32
    outs, tstats, jstats = _run_sessions(table, [idx1, idx2, idx2, idx1[:10]])
    for got, want in outs:
        np.testing.assert_array_equal(got, want)
    assert tstats == jstats == {"replayed": 2, "fallback": 3}
    np.testing.assert_array_equal(outs[1][0], table[idx2])


def test_session_on_evolving_pair_equals_jax():
    """Vertex-keyed streams of tiny's evolving pair, built as the example
    builds them (first 8 neighbors of the 64 vertices of highest degree)."""
    from repro.graphs import make_dataset, make_evolving_pair

    from test_torch_golden_evolving import demo_streams

    pair = make_evolving_pair(make_dataset("tiny"), seed=1)
    idx1, idx2 = demo_streams(pair, top=64)
    assert 0 < (idx1 == idx2).mean() < 1
    table = np.random.default_rng(0).normal(size=(pair.base.num_vertices, 128)).astype(np.float32)
    outs, tstats, jstats = _run_sessions(table, [idx1, idx2])
    for got, want in outs:
        np.testing.assert_array_equal(got, want)
    assert tstats == jstats


def test_session_checks_table_and_indices(monkeypatch):
    sess = AMCGatherSession(device="cpu")
    table = torch.zeros((4, 2))
    with pytest.raises(IndexError):
        sess.gather(table, np.array([0, 4]))
    with pytest.raises(ValueError, match="table on meta"):
        sess.gather(torch.zeros((4, 2), device="meta"), np.array([0]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AMCGatherSession()


# ------------------------------------------------------ wrappers, routing


def test_non_cpu_tensor_never_reaches_plain_version(monkeypatch):
    def no_plain(*a, **k):
        raise AssertionError("plain version reached with a device tensor")

    def no_build(source):
        raise RuntimeError(f"cannot build {source.name} here")

    monkeypatch.setattr(t_amc_gather, "amc_gather_plain", no_plain)
    monkeypatch.setattr(t_amc_gather, "amc_gather_segment_sum_plain", no_plain)
    monkeypatch.setattr(t_amc_gather, "load", no_build)
    meta = torch.device("meta")
    table = torch.zeros((8, 4), device=meta)
    idx = torch.zeros(5, dtype=torch.int32, device=meta)
    with pytest.raises(RuntimeError, match="cannot build amc_gather"):
        amc_gather(table, idx)
    with pytest.raises(RuntimeError, match="cannot build amc_gather"):
        amc_gather_segment_sum(table, idx, idx, 3)


def test_wrappers_validate_inputs():
    table = torch.zeros((8, 4))
    idx = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(TypeError):
        amc_gather(table.double(), idx)
    with pytest.raises(TypeError):
        amc_gather(table, idx.long())
    with pytest.raises(ValueError):
        amc_gather(table[:, 0], idx)
    with pytest.raises(ValueError):
        amc_gather_segment_sum(table, idx, idx[:4], 3)
    with pytest.raises(ValueError):
        amc_gather_segment_sum(table, idx, idx, -1)
    # the oracles and the plain versions are one function
    assert amc_gather_plain is gather_ref and amc_gather_segment_sum_plain is gather_segment_sum_ref
