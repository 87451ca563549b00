"""The port's stream protocol against the JAX package's, on the CPU.

Churn models, update streams and snapshot sequences must equal the JAX
package's bit for bit for the same ``(base, epochs, seed)`` (the numpy rng
draws are the same calls in the same order).  ``TableLifecycle`` is driven
by both packages over the same epoch traces under each policy, and its
``EpochTableReport`` rows must be equal.  Streams through
``repro_torch.core.Experiment(device="cpu")`` (where K1, K2 and the
ordered segment sum run their plain versions) must give the JAX package's
rows exactly, including the ``epoch`` / ``lifecycle`` columns and
``info["table"]``, serially and under ``workers=2``, alone and mixed with
plain workloads; and the drift document ``chip_smoke.py`` builds must
equal the one ``examples/streaming_drift.py --tiny`` writes.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as jcore
import repro.stream as jstream
import repro_torch.core as tcore
import repro_torch.stream as tstream
from repro.graphs import make_dataset as j_make_dataset
from repro_torch.graphs import make_dataset as t_make_dataset

ROOT = Path(__file__).resolve().parents[1]
KINDS = sorted(jstream.CHURN_MODELS)
LIFECYCLES = ["persist", "reset", "age", "invalidate_changed"]
TWO = ["amc", "nextline2"]


def jsonable(x):
    return json.loads(json.dumps(x, default=lambda o: o.tolist()))


def churn_pair(kind, **params):
    return jstream.CHURN_MODELS[kind](**params), tstream.CHURN_MODELS[kind](**params)


def same_arrays(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module")
def bases():
    return {(d, w): (j_make_dataset(d, weighted=w), t_make_dataset(d, weighted=w))
            for d in ("tiny", "comdblp") for w in (False, True)}


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("dataset,weighted", [("tiny", True), ("comdblp", False)])
@pytest.mark.parametrize("kind", KINDS)
def test_update_stream_equals_jax(bases, kind, dataset, weighted, seed):
    jbase, tbase = bases[(dataset, weighted)]
    jm, tm = churn_pair(kind)
    assert type(tm).kind == kind and hash(tm) == hash(tstream.CHURN_MODELS[kind]())
    js, ts = jm.generate(jbase, 4, seed), tm.generate(tbase, 4, seed)
    assert ts.num_vertices == js.num_vertices and ts.num_epochs == js.num_epochs == 4
    for f in ("init_src", "init_dst", "init_w"):
        assert same_arrays(getattr(js, f), getattr(ts, f)), f
    for jb, tb in zip(js.batches, ts.batches, strict=True):
        for f in dataclasses.fields(jb):
            ja, ta = getattr(jb, f.name), getattr(tb, f.name)
            assert (ja == ta) if f.name == "epoch" else same_arrays(ja, ta), f.name
    assert (js.masks is None) == (ts.masks is None)
    for jmask, tmask in zip(js.masks or (), ts.masks or (), strict=True):
        assert same_arrays(jmask, tmask)
    if hasattr(jm, "masks"):
        for a, b in zip(jm.masks(jbase, 4, seed), tm.masks(tbase, 4, seed), strict=True):
            assert same_arrays(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_snapshot_sequence_equals_jax(bases, kind):
    jbase, tbase = bases[("comdblp", True)]
    jm, tm = churn_pair(kind)
    jseq = jstream.snapshot_sequence(jbase, jm, 4, seed=3)
    tseq = tstream.snapshot_sequence(tbase, tm, 4, seed=3)
    assert [s.row() for s in tseq.stats] == [s.row() for s in jseq.stats]
    assert tseq.max_edges == jseq.max_edges
    for e in range(4):
        jg, tg = jseq.graphs[e], tseq.graphs[e]
        for f in ("offsets", "neighbors", "weights"):
            assert same_arrays(getattr(jg, f), getattr(tg, f)), (e, f)
        assert same_arrays(jseq.masks[e], tseq.masks[e])
    for e in range(1, 4):
        assert same_arrays(jseq.changed_vertices(e), tseq.changed_vertices(e))


@pytest.mark.parametrize("kind", ["uniform_churn", "community_churn"])
def test_apply_delta_matches_induced_construction(bases, kind):
    tbase = bases[("comdblp", True)][1]
    seq = tstream.snapshot_sequence(tbase, tstream.CHURN_MODELS[kind](), 4, seed=5)
    g = seq.graphs[0]
    for e, batch in enumerate(seq.batches, start=1):
        g = tstream.apply_delta(g, batch, name=f"delta@e{e}")
        want = seq.graphs[e]  # induced_subgraph on the base, as the JAX package builds it
        for f in ("offsets", "neighbors", "weights"):
            assert same_arrays(getattr(g, f), getattr(want, f)), (e, f)


def _bad_stream_kwargs(pkg):
    churn = pkg.CHURN_MODELS["sliding_window"]()
    return [
        dict(kernel="pgd", dataset="tiny", churn=churn, epochs=1),
        dict(kernel="pgd", dataset="tiny", churn=churn, lifecycle="forever"),
        dict(kernel="pgd", dataset="tiny", churn="sliding_window"),
        dict(kernel="pgd", dataset="tiny", churn=churn, target_elem_size=6,
             frontier_elem_size=4),
        dict(kernel="pgd", dataset="tiny", churn=churn, target_elem_size=0),
    ]


@pytest.mark.parametrize("case", range(5))
def test_stream_spec_validation_equals_jax(case):
    errs = []
    for pkg in (jstream, tstream):
        with pytest.raises((ValueError, TypeError)) as info:
            pkg.StreamSpec(**_bad_stream_kwargs(pkg)[case])
        errs.append((type(info.value), str(info.value).replace("repro_torch.", "repro.")))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("bad", [
    dict(kwargs=dict(kernel="nope", dataset="tiny"), where="names"),
    dict(kwargs=dict(kernel="pgd", dataset="nope"), where="names"),
    dict(kwargs=dict(kernel="pgd", dataset="tiny", epoch=3), where="init"),
    dict(kwargs=dict(kernel="pgd", dataset="tiny", epoch=-1), where="init"),
])
def test_epoch_spec_validation_equals_jax(bad):
    errs = []
    for pkg in (jstream, tstream):
        kw = dict(bad["kwargs"], churn=pkg.CHURN_MODELS["uniform_churn"](), epochs=3)
        kw.setdefault("epoch", 0)
        with pytest.raises((ValueError, KeyError)) as info:
            spec = pkg.StreamEpochSpec(**kw)
            if bad["where"] == "names":
                spec.validate_names()
        errs.append((type(info.value), str(info.value)))
    assert errs[0] == errs[1]


@pytest.fixture(scope="module")
def caches():
    """One workload cache a package: epoch traces are lifecycle-agnostic,
    so every lifecycle below scores the same builds."""
    return jcore.WorkloadCache(), tcore.WorkloadCache()


def _streams(pkg, lifecycle, kernel="pgd", kind="sliding_window", **params):
    return pkg.StreamSpec(kernel, "tiny", pkg.CHURN_MODELS[kind](**params), epochs=3,
                          lifecycle=lifecycle)


@pytest.mark.parametrize("lifecycle", LIFECYCLES)
def test_stream_through_experiment_equals_jax(caches, lifecycle):
    jres = jcore.Experiment(workloads=[_streams(jstream, lifecycle)], prefetchers=TWO,
                            cache=caches[0]).run(workers=1)
    tres = tcore.Experiment(workloads=[_streams(tstream, lifecycle)], prefetchers=TWO,
                            cache=caches[1], device="cpu").run(workers=1)
    rows = jsonable(tres.rows())
    assert rows == jsonable(jres.rows())
    assert [(r["epoch"], r["prefetcher"], r["lifecycle"]) for r in rows] == [
        (e, p, lifecycle if p == "amc" else None) for p in TWO for e in range(3)]
    assert all(r["info"]["table"]["policy"] == lifecycle for r in rows if r["prefetcher"] == "amc")
    assert tres.trace_reuse == jres.trace_reuse
    assert all(w.device.type == "cpu" for w in tres.workloads.values())


@pytest.mark.parametrize("lifecycle", LIFECYCLES)
def test_table_lifecycle_reports_equal_jax(caches, lifecycle):
    """Both packages' lifecycles walk the JAX package's epoch traces with
    their own AMC prefetchers: the reports and the streams must agree."""
    from repro.core.amc.prefetcher import AMCConfig as JConfig, AMCPrefetcher as JAMC
    from repro_torch.core.amc.prefetcher import AMCConfig as TConfig, AMCPrefetcher as TAMC

    spec = _streams(jstream, lifecycle)
    traces = [caches[0].get_or_build(es) for es in spec.epoch_specs()]
    tseq = _streams(tstream, lifecycle).sequence()
    reports = []
    for lc_mod, amc, seq in ((jstream, JAMC(JConfig()), spec.sequence()),
                             (tstream, TAMC(TConfig()), tseq)):
        lc = lc_mod.TableLifecycle(lifecycle, capacity_bytes=int(0.2 * traces[0].input_bytes),
                                   max_age=1)
        got = []
        for e, trace in enumerate(traces):
            stream = amc.generate(trace, storage=lc.begin_epoch(e))
            changed = seq.changed_vertices(e + 1) if e + 1 < 3 else None
            got.append((lc.end_epoch(e, changed_vids=changed).row(), stream.blocks.tolist(),
                        stream.pos.tolist(), jsonable(stream.info)))
        reports.append(got)
    assert reports[0] == reports[1]
    assert [r[0]["epoch"] for r in reports[1]] == [0, 1, 2]


def test_lifecycle_policy_validation_equals_jax():
    errs = []
    for pkg in (jstream, tstream):
        with pytest.raises(ValueError) as info:
            pkg.TableLifecycle("forever", capacity_bytes=1024)
        errs.append(str(info.value))
    assert errs[0] == errs[1] and tstream.LIFECYCLE_POLICIES == jstream.LIFECYCLE_POLICIES


def test_streams_mix_with_plain_workloads(caches):
    def grid(pkg, core, stream_pkg, **kw):
        return core.Experiment(
            workloads=[core.WorkloadSpec("bfs", "tiny"),
                       _streams(stream_pkg, "persist", kernel="bfs", kind="community_churn"),
                       core.WorkloadSpec("bellmanford", "tiny")],
            prefetchers=TWO, cache=caches[pkg], **kw).run(workers=1)

    jres = grid(0, jcore, jstream)
    tres = grid(1, tcore, tstream, device="cpu")
    assert jsonable(tres.rows()) == jsonable(jres.rows())
    assert [(c.kernel, c.epoch) for c in tres.cells][:4] == (
        [("bfs", None)] * 2 + [("bellmanford", None)] * 2)
    assert set(tres.workloads) == set(
        [tcore.WorkloadSpec("bfs", "tiny"), tcore.WorkloadSpec("bellmanford", "tiny")]
        + _streams(tstream, "persist", kernel="bfs", kind="community_churn").epoch_specs())


def test_drift_document_equals_the_example(caches, tmp_path):
    """``chip_smoke.drift_document`` on the port's run equals the document
    ``examples/streaming_drift.py --tiny`` writes through the JAX package."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    out = tmp_path / "drift.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               HOME=str(tmp_path))
    subprocess.run([sys.executable, str(ROOT / "examples" / "streaming_drift.py"), "--tiny",
                    "--out", str(out)], cwd=tmp_path, env=env, check=True,
                   capture_output=True)
    policies = ("persist", "reset")
    streams = [_streams(tstream, p) for p in policies]
    res = tcore.Experiment(workloads=streams, prefetchers=TWO, cache=caches[1],
                           device="cpu").run(workers=1)
    doc = jsonable(chip_smoke.drift_document(res, streams, policies))
    assert doc == json.loads(out.read_text())


def test_stream_parallel_equals_serial_and_reuse():
    """``workers=2`` builds the epochs in spawned CPU workers and scores
    here: rows and ``trace_reuse`` equal the serial run's, cold (a zero-churn
    stream's three identical epochs are one build) and warm."""
    zero = _streams(tstream, "persist", kernel="bfs", kind="uniform_churn", init_frac=1.0,
                    del_frac=0.0, add_frac=0.0)
    specs = [zero, _streams(tstream, "invalidate_changed", kernel="bfs")]
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for w, root in ((1, "serial"), (2, "pool"), (2, "pool")):
            cache = tcore.WorkloadCache(artifacts=tcore.ArtifactCache(Path(tmp) / root))
            res = tcore.Experiment(workloads=specs, prefetchers=TWO, cache=cache,
                                   device="cpu").run(workers=w)
            runs.setdefault(w, []).append(res)
    serial, (cold, warm) = runs[1][0], runs[2]
    assert serial.trace_reuse == cold.trace_reuse == 2
    assert warm.trace_reuse == 6
    for res in (cold, warm):
        assert jsonable(res.rows()) == jsonable(serial.rows())
