"""The port's prefetchers (paper Table I) against the JAX package.

Every registered prefetcher is host numpy in both packages, so on a port
workload and its JAX twin (built from the same spec, the port's on the CPU)
each must emit the same ``PrefetchStream``: blocks, positions,
``metadata_bytes`` and prefetcher-side stats; and the family scored
together by ``score_prefetchers_batched`` must give the same rows.  pgd
(one AMC epoch an iteration) and bfs (the §VI two-run protocol, one epoch a
run) drive RnR's record-once / replay through both epoch structures.
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.driver import WorkloadSpec as JSpec
from repro.core.experiment import score_prefetchers_batched as j_batched
from repro.core.registry import get_prefetcher as j_get_prefetcher
from repro.core.registry import list_prefetchers as j_list_prefetchers
from repro.core.registry import resolve_prefetchers as j_resolve

from repro_torch.core import WorkloadSpec as TSpec
from repro_torch.core import get_prefetcher, list_prefetchers, resolve_prefetchers
from repro_torch.core import score_prefetcher, score_prefetchers_batched

TABLE_I = ["nextline2", "prodigy", "isb", "misb", "domino", "vldp", "bingo", "rnr", "amc", "ideal"]
WORKLOADS = [("pgd", "tiny"), ("bfs", "comdblp")]


def jsonable(x):
    return json.loads(json.dumps(x, default=lambda o: o.tolist()))


@functools.lru_cache(maxsize=None)
def twins(kernel: str, dataset: str):
    """(port workload on the CPU, JAX workload) of one spec."""
    return TSpec(kernel, dataset).build(device="cpu"), JSpec(kernel, dataset).build()


def test_registry_holds_table_i_in_the_jax_order():
    assert list_prefetchers() == j_list_prefetchers()
    assert sorted(list_prefetchers()) == sorted(TABLE_I)
    for name in TABLE_I:
        t, j = get_prefetcher(name), j_get_prefetcher(name)
        assert (t.trains_on, t.storage, t.family) == (j.trains_on, j.storage, j.family)


@pytest.mark.parametrize("name", TABLE_I)
@pytest.mark.parametrize("kernel,dataset", WORKLOADS)
def test_streams_equal(kernel, dataset, name):
    tw, jw = twins(kernel, dataset)
    got = get_prefetcher(name).instantiate()(tw)
    want = j_get_prefetcher(name).instantiate()(jw)
    assert got.name == want.name
    np.testing.assert_array_equal(got.blocks, want.blocks)
    np.testing.assert_array_equal(got.pos, want.pos)
    assert got.metadata_bytes == want.metadata_bytes
    assert jsonable(got.info) == jsonable(want.info)


@pytest.mark.parametrize("kernel,dataset", WORKLOADS)
def test_batched_rows_equal(kernel, dataset):
    tw, jw = twins(kernel, dataset)
    got = score_prefetchers_batched(tw, resolve_prefetchers(TABLE_I))
    want = j_batched(jw, j_resolve(TABLE_I))
    assert [jsonable(m.row()) for m in got] == [jsonable(m.row()) for m in want]


def test_hwm_dedupe():
    from repro_torch.core.prefetchers.temporal import _issue_with_hwm

    lo, counts = _issue_with_hwm(np.array([0, 1, 2, 10]), degree=4, stream_len=20)
    # trigger 0 issues 1..4; trigger 1 issues 5 only; trigger 2 issues 6;
    # trigger 10 issues 11..14
    np.testing.assert_array_equal(counts, [4, 1, 1, 4])
    np.testing.assert_array_equal(lo, [1, 5, 6, 11])


def test_rnr_records_once_amc_rerecords():
    """The core AMC-vs-RnR distinction on an evolving workload."""
    from repro_torch.core.amc import AMCConfig, AMCPrefetcher
    from repro_torch.core.prefetchers.rnr import rnr

    w = TSpec("pgd", "comdblp").build(device="cpu")
    amc = score_prefetcher(w, "amc", AMCPrefetcher(AMCConfig()).generate)
    rnr_m = score_prefetcher(w, "rnr", rnr)
    assert amc.coverage > 2 * rnr_m.coverage
