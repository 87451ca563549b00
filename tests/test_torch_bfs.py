"""The port's BFS and the §VI two-run protocol against the JAX package.

Both runs of the evolving pair go through the port's ``bfs`` and the JAX
package's, from the shared root the driver picks, in every traversal
direction: parents, per-iteration frontiers and directions, and the
emitted ``RunTrace`` arrays must be identical.  Each is run twice: on the
pair the JAX package made (handed over by ``convert.evolving_pair``, so an
app fault shows apart from an evolve fault) and on the port's own pair.
End to end, the two-run ``build_workload`` on tiny gives the reference's
epochs, ``eval_from_pos``, trace arrays and ``amc`` / ``vldp`` rows, and
on notredame (the example's own cell) the golden record.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.apps.bfs import bfs as j_bfs
from repro.apps.bfs import pick_root as j_pick_root
from repro.apps.trace import TraceConfig as JTraceConfig
from repro.apps.trace import trace_run as j_trace_run
from repro.graphs import make_dataset as j_make_dataset
from repro.graphs import make_evolving_pair as j_make_evolving_pair

from repro_torch.apps import bfs as t_bfs
from repro_torch.apps import pick_root
from repro_torch.apps.trace import TraceConfig as TTraceConfig
from repro_torch.apps.trace import trace_run as t_trace_run
from repro_torch.convert import evolving_pair
from repro_torch.graphs import make_dataset, make_evolving_pair

CPU = torch.device("cpu")
TRACE_FIELDS = ("array_id", "elem", "addr", "block", "src_vertex", "iter_bounds")


@pytest.fixture(scope="module", params=["tiny", "comdblp"])
def pairs(request):
    """(JAX pair, the same pair converted, the port's own pair)."""
    ref = j_make_evolving_pair(j_make_dataset(request.param), seed=0)
    conv = evolving_pair(ref.base, ref.run1, ref.run2, ref.mask1, ref.mask2)
    own = make_evolving_pair(make_dataset(request.param), seed=0)
    return ref, conv, own


@pytest.mark.parametrize("source", ["converted", "own"])
@pytest.mark.parametrize("direction", ["push", "pull", "auto"])
def test_two_runs_equal_jax(pairs, source, direction):
    ref, conv, own = pairs
    pair = conv if source == "converted" else own
    root = pick_root(pair.run1, pair.mask1 & pair.mask2)
    assert root == j_pick_root(ref.run1, ref.mask1 & ref.mask2)
    jcfg = JTraceConfig(ref.base.num_vertices, max(ref.run1.num_edges, ref.run2.num_edges))
    tcfg = TTraceConfig(pair.base.num_vertices, max(pair.run1.num_edges, pair.run2.num_edges))
    for g, jg, m, jm in ((pair.run1, ref.run1, pair.mask1, ref.mask1),
                         (pair.run2, ref.run2, pair.mask2, ref.mask2)):
        got = t_bfs(g, root=root, present_mask=m, direction=direction, device=CPU)
        want = j_bfs(jg, root=root, present_mask=jm, direction=direction)
        np.testing.assert_array_equal(got.values, np.asarray(want.values))
        assert got.values.dtype == np.float32
        assert got.num_iters == want.num_iters and got.directions == want.directions
        assert got.stats == want.stats
        for f, w in zip(got.frontiers, want.frontiers):
            np.testing.assert_array_equal(f, w)
        rt, jrt = t_trace_run(got, tcfg), j_trace_run(want, jcfg)
        for f in TRACE_FIELDS:
            np.testing.assert_array_equal(getattr(rt, f), getattr(jrt, f), err_msg=f)
        assert rt.directions == jrt.directions


def test_default_root_and_mask_equal_jax():
    got = t_bfs(make_dataset("tiny"), device=CPU)
    want = j_bfs(j_make_dataset("tiny"))
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    assert got.num_iters == want.num_iters


def _rows(metrics):
    return [json.loads(json.dumps(m.row(), default=lambda o: o.tolist())) for m in metrics]


@pytest.mark.parametrize("kernel", ["bfs", "bfs_do"])
def test_two_run_workload_equals_jax(kernel):
    from repro.core.driver import WorkloadSpec as JSpec
    from repro.core.experiment import score_prefetchers_batched as j_batched
    from repro.core.registry import resolve_prefetchers as j_resolve

    from repro_torch.core import WorkloadSpec, resolve_prefetchers, score_prefetchers_batched

    jwl = JSpec(kernel, "tiny").build()
    twl = WorkloadSpec(kernel, "tiny").build(device="cpu")
    assert twl.iter_epochs == jwl.iter_epochs
    assert {e for e, _ in twl.iter_epochs} == {0, 1}
    assert twl.eval_from_pos == jwl.eval_from_pos > 0
    for f in ("block", "array_id", "epoch_id", "iter_id", "elem", "nl_blocks", "nl_pos"):
        np.testing.assert_array_equal(getattr(twl, f), getattr(jwl, f), err_msg=f)
    names = ["amc", "vldp"]
    assert _rows(score_prefetchers_batched(twl, resolve_prefetchers(names))) == _rows(
        j_batched(jwl, j_resolve(names))
    )


def test_notredame_cell_on_cpu_equals_golden():
    """The example's own cell, bfs/notredame under ``SCALED``, built and
    scored by the port on the CPU, equals the JAX package's golden record
    (``tests/data/torch_port_golden_evolving.json``) field for field."""
    import hashlib

    from repro_torch import memsim
    from repro_torch.core import build_workload, resolve_prefetchers, score_prefetchers_batched

    from test_torch_golden_evolving import GOLDEN, demand_levels, jsonable

    with open(GOLDEN) as f:
        gold = json.load(f)["bfs/notredame/SCALED"]
    wl = build_workload("bfs", "notredame", hierarchy=memsim.SCALED, device="cpu")
    rows = score_prefetchers_batched(wl, resolve_prefetchers(gold["prefetchers"]))
    runs = [e for e, _ in wl.iter_epochs]
    assert [runs.count(0), runs.count(1)] == gold["run_iterations"]
    assert wl.num_accesses == gold["accesses"]
    assert len(wl.profile.l2_pos) == gold["l2_accesses"]
    assert wl.eval_from_pos == gold["eval_from_pos"]
    lvl = demand_levels(wl.profile)
    assert hashlib.sha256(lvl.tobytes()).hexdigest() == gold["levels_sha256"]
    assert {m.name: jsonable(m.row()) for m in rows} == gold["rows"]


def test_two_run_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.core import WorkloadSpec, build_workload

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda **kw: build_workload("bfs", "tiny", **kw),
        lambda **kw: WorkloadSpec("bfs_do", "tiny").build(**kw),
        lambda **kw: t_bfs(make_dataset("tiny"), **kw),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
