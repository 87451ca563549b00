"""The port's process-pool scheduler and cost model
(``repro_torch.core.exec.scheduler``) against the JAX package's, on the CPU.

- ``decide`` gives the JAX package's decision on the same costs when both
  modules' constants are equal; the card's free memory caps the pool.
- ``estimate_cost`` prefers the measured sidecar, then the artifact, then
  the dataset-size estimate; ``_plan`` splits only materialized workloads.
- ``run(workers=2)`` (spawned workers, on the CPU) equals ``run(workers=1)``
  for a plain grid and for a grid mixing plain and sharded specs, and the
  JAX package's rows; ``run()`` records the cost model's decision.
- A worker sent to the card that finds none raises; unpicklable
  prefetchers raise under ``workers=2`` and stay serial by default.

Spawned pools import torch in each worker, so this file keeps them few.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.core import ArtifactCache, Experiment, WorkloadCache, WorkloadSpec  # noqa: E402
from repro_torch.core.exec import scheduler  # noqa: E402
from repro_torch.core.exec.scheduler import (  # noqa: E402
    TaskCost,
    _plan,
    _split,
    decide,
    estimate_cost,
    rows_equal,
)
from repro_torch.core.exec.sharded import ShardedSpec  # noqa: E402

TINY = WorkloadSpec("pgd", "tiny")


def _cost(module, total_s, *, measured=True, resident=1e6):
    return module.TaskCost(spec=None, build_s=total_s / 2, score_s=total_s / 2,
                           resident_bytes=resident, measured=measured)


# the cases of the JAX package's tests/test_sched_pipeline.py:46-80:
# (costs as (total_s, resident bytes), cores, mem_bytes)
DECIDE_CASES = {
    "deterministic": ([(30.0, 1e6), (10.0, 1e6), (5.0, 1e6)], 4, 1 << 30),
    "single_core": ([(100.0, 1e6), (100.0, 1e6)], 1, None),
    "overhead_exceeds_gain": ([(0.3, 1e6), (0.3, 1e6)], 8, None),
    "makespan_beats_serial": ([(40.0, 1e6)] * 4, 4, 1 << 40),
    "memory_caps_width": ([(40.0, float(1 << 30))] * 4, 8, (1 << 31) + (1 << 20)),
    "memory_forces_serial": ([(40.0, float(1 << 30))] * 4, 8, 1 << 30),
    "one_task": ([(40.0, 1e6)], 8, None),
}


@pytest.mark.parametrize("case", sorted(DECIDE_CASES))
def test_decide_equals_jax(monkeypatch, case):
    from repro.core.exec import scheduler as jsched

    for name in ("SPAWN_BASE_S", "SPAWN_PER_WORKER_S"):
        monkeypatch.setattr(scheduler, name, getattr(jsched, name))
    costs, cores, mem = DECIDE_CASES[case]
    got = decide([_cost(scheduler, t, resident=r) for t, r in costs], cores=cores,
                 mem_bytes=mem)
    want = jsched.decide([_cost(jsched, t, resident=r) for t, r in costs], cores=cores,
                         mem_bytes=mem)
    assert got.as_dict() == want.as_dict()
    assert got == decide([_cost(scheduler, t, resident=r) for t, r in costs], cores=cores,
                         mem_bytes=mem)


def test_decide_caps_the_pool_by_the_cards_free_memory():
    costs = [TaskCost(None, 20.0, 20.0, 1e6, True, device_bytes=float(1 << 30))] * 4
    per_worker = scheduler.CUDA_CONTEXT_BYTES + (1 << 30)
    wide = decide(costs, cores=8, device_mem_bytes=8 * per_worker)
    assert wide.mode == "pipeline" and wide.workers == 4
    assert decide(costs, cores=8, device_mem_bytes=2 * per_worker).workers <= 2
    tight = decide(costs, cores=8, device_mem_bytes=per_worker + 1)
    assert tight.mode == "serial" and "card" in tight.reason
    # on the CPU the card does not count
    assert decide(costs, cores=8, device_mem_bytes=None) == wide


def test_estimate_cost_prefers_sidecar_then_artifact(tmp_path):
    arts = ArtifactCache(tmp_path)
    cold = estimate_cost(TINY, 2, arts)
    assert not cold.measured and cold.build_s > 0 and cold.score_s > 0
    assert cold.device_bytes == cold.resident_bytes / scheduler.TRACE_BYTES_PER_ACCESS \
        * scheduler.DEVICE_BYTES_PER_ACCESS
    assert arts.load_cost(TINY) is None  # absent == None, not {}
    arts.record_cost(TINY, build_s=12.5)
    arts.record_cost(TINY, score_s_per_prefetcher=0.75)
    arts.record_cost(TINY, build_s=10.0)  # the latest measurement wins
    assert arts.load_cost(TINY) == {"build_s": 10.0, "score_s_per_prefetcher": 0.75}
    cost = estimate_cost(TINY, 2, arts)
    assert cost.measured and cost.build_s == 10.0 and cost.score_s == pytest.approx(1.5)
    assert estimate_cost(TINY, 3, arts).score_s == pytest.approx(2.25)
    # a materialized artifact prices a load, not the recorded rebuild
    arts.path_for(TINY).write_bytes(b"x" * 120_000)
    warm = estimate_cost(TINY, 2, arts)
    assert warm.measured and warm.build_s < 10.0 and warm.score_s == pytest.approx(1.5)
    assert warm.resident_bytes == 120_000 / scheduler.ARTIFACT_BYTES_PER_ACCESS \
        * scheduler.TRACE_BYTES_PER_ACCESS
    # a corrupt sidecar reads as absent
    arts.cost_path(TINY).write_text("not json")
    assert arts.load_cost(TINY) is None
    assert estimate_cost(TINY, 2, arts).score_s != pytest.approx(1.5)
    # a sharded spec is sized from its manifest's exact access count
    sh = ShardedSpec(TINY, 4096)
    arts.save_manifest(sh, {"num_accesses": 1000, "shard_sizes": []})
    assert estimate_cost(sh, 1, arts).measured
    assert estimate_cost(sh, 1, arts).resident_bytes == 1000 * scheduler.TRACE_BYTES_PER_ACCESS


def test_estimate_cost_cold_equals_jax(monkeypatch, tmp_path):
    """With equal constants, the cold (dataset-size) estimate is the JAX
    package's: the same registries, the same formula."""
    from repro.core import ArtifactCache as JCache, WorkloadSpec as JSpec
    from repro.core.exec import scheduler as jsched

    for name in ("BUILD_S_PER_ACCESS", "SCORE_S_PER_ACCESS", "TRACE_BYTES_PER_ACCESS"):
        monkeypatch.setattr(scheduler, name, getattr(jsched, name))
    for kernel, dataset in (("pgd", "road-ca"), ("bfs", "google"), ("cc", "road-8m")):
        got = estimate_cost(WorkloadSpec(kernel, dataset), 2, ArtifactCache(tmp_path))
        want = jsched.estimate_cost(JSpec(kernel, dataset), 2, JCache(tmp_path / "j"))
        assert (got.build_s, got.score_s, got.resident_bytes, got.measured) == \
            (want.build_s, want.score_s, want.resident_bytes, want.measured)
    assert scheduler._dataset_shape("nosuch") == jsched._dataset_shape("nosuch")


def test_plan_splits_only_materialized_workloads(tmp_path):
    pairs = [(n, None) for n in ("a", "b", "c")]
    other = WorkloadSpec("cc", "tiny")
    cold = ArtifactCache(tmp_path / "cold")
    unique, tasks = _plan([TINY, other], pairs, workers=4, artifacts=cold)
    assert len(unique) == 2 and len(tasks) == 2
    assert all(len(chunk) == 3 for _, chunk in tasks)
    warm = ArtifactCache(tmp_path / "warm")
    warm.save(TINY, TINY.build(device="cpu"))
    assert warm.has(TINY) and not warm.has(other)
    unique, tasks = _plan([TINY, other], pairs, workers=4, artifacts=warm)
    split = [chunk for spec, chunk in tasks if spec == TINY]
    whole = [chunk for spec, chunk in tasks if spec != TINY]
    assert len(split) > 1 and len(whole) == 1
    assert sorted(n for chunk in split for n, _ in chunk) == ["a", "b", "c"]
    unique, tasks = _plan([other, other], pairs, workers=1, artifacts=cold)
    assert len(unique) == 1 and len(tasks) == 1
    # a truncated artifact reads as absent
    path = warm.path_for(TINY)
    path.write_bytes(path.read_bytes()[:100])
    assert not warm.has(TINY)


def test_split_and_rows_equal():
    assert _split([1, 2, 3, 4, 5], 2) == [[1, 2, 3], [4, 5]]
    assert _split([1], 4) == [[1]]
    assert _split([1, 2], 2) == [[1], [2]]
    a = [{"speedup": 1.0, "info": {"x": np.arange(3)}}]
    assert rows_equal(a, [{"speedup": 1.0, "info": {"x": np.arange(3)}}])
    assert not rows_equal(a, [{"speedup": 1.0, "info": {"x": np.arange(4)}}])
    assert not rows_equal(a, [{"speedup": 1.5, "info": {"x": np.arange(3)}}])
    assert not rows_equal(a, [])


def test_plain_grid_parallel_equals_serial_and_jax(tmp_path):
    from repro.core import Experiment as JExperiment, WorkloadSpec as JSpec

    specs = [TINY, WorkloadSpec("cc", "tiny")]
    pf = ["rnr", "nextline2", "amc"]
    serial = Experiment(workloads=specs, prefetchers=pf, device="cpu").run(workers=1)
    assert serial.sched is None and isinstance(serial.workloads, dict)
    arts = ArtifactCache(tmp_path)
    par = Experiment(workloads=specs, prefetchers=pf, device="cpu",
                     cache=WorkloadCache(artifacts=arts)).run(workers=2)
    assert rows_equal(serial.rows(), par.rows())
    assert [c.prefetcher for c in par.cells] == pf * 2
    # the workers built and persisted both traces, with their costs
    assert all(arts.has(s) and "build_s" in arts.load_cost(s) for s in specs)
    # the lazy view loads real traces, on the experiment's device
    assert TINY in par.workloads and len(par.workloads) == 2
    assert par.workload("pgd", "tiny").device.type == "cpu"
    assert dict(par.workloads)[TINY].num_accesses == serial.workloads[TINY].num_accesses
    jax = JExperiment(workloads=[JSpec("pgd", "tiny"), JSpec("cc", "tiny")],
                      prefetchers=pf).run(workers=1)
    assert rows_equal(jax.rows(), par.rows())
    # the phased schedule on the now-warm store splits the prefetcher lists
    phased = Experiment(workloads=specs, prefetchers=pf, device="cpu",
                        cache=WorkloadCache(artifacts=arts)).run(workers=2, pipeline=False)
    assert rows_equal(serial.rows(), phased.rows())
    # run() consults the cost model: tiny work, so serial, and says why
    auto = Experiment(workloads=specs, prefetchers=pf, device="cpu",
                      cache=WorkloadCache(artifacts=arts)).run()
    assert set(auto.sched) >= {"mode", "workers", "reason"}
    assert auto.sched["mode"] == "serial" and auto.sched["measured_frac"] == 1.0
    assert rows_equal(serial.rows(), auto.rows())
    assert auto.telemetry["manifest"]["sched"] == auto.sched


def test_mixed_sharded_grid_parallel_equals_serial(tmp_path):
    base = WorkloadSpec("bfs", "tiny")
    workloads = [base, ShardedSpec(base, 1 << 12)]
    pf = ["nextline2", "amc"]
    serial = Experiment(workloads=workloads, prefetchers=pf, device="cpu",
                        cache=WorkloadCache(artifacts=ArtifactCache(tmp_path / "s"))
                        ).run(workers=1)
    rows_s = [c.metrics.row() for c in serial.cells]
    assert rows_equal(rows_s[:2], rows_s[2:])  # sharded == its unsharded twin
    assert list(serial.workloads) == [base]  # sharded specs have no whole trace
    par = Experiment(workloads=workloads, prefetchers=pf, device="cpu",
                     cache=WorkloadCache(artifacts=ArtifactCache(tmp_path / "p"))
                     ).run(workers=2)
    assert rows_equal(serial.rows(), par.rows())
    assert list(par.workloads) == [base]
    # a serial run with no artifact cache attaches the default one for the
    # shard store
    cache = WorkloadCache()
    assert cache.artifacts is None
    cache.artifacts = ArtifactCache(tmp_path / "d")
    again = Experiment(workloads=workloads[1:], prefetchers=pf, device="cpu",
                       cache=cache).run(workers=1)
    assert rows_equal(rows_s[2:], [c.metrics.row() for c in again.cells])


def test_unpicklable_prefetcher_raises_in_a_pool_and_stays_serial_by_default(tmp_path):
    from repro_torch.core import get_prefetcher

    nl = get_prefetcher("nextline2").instantiate()
    pairs = [("lam", lambda workload: nl(workload))]
    exp = Experiment(workloads=[TINY], prefetchers=pairs, device="cpu",
                     cache=WorkloadCache(artifacts=ArtifactCache(tmp_path)))
    with pytest.raises(ValueError, match="not picklable"):
        exp.run(workers=2)
    res = exp.run()
    assert res.sched["mode"] == "serial" and res.sched["workers"] == 1
    assert "unpicklable" in res.sched["reason"]
    assert len(res.cells) == 1


def test_worker_sent_to_the_card_never_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        scheduler._run_task((0, TINY, [], str(tmp_path), "cuda"))
    with pytest.raises(RuntimeError, match="CUDA"):
        scheduler._materialize_task((0, TINY, str(tmp_path), "cuda"))
    with pytest.raises(RuntimeError, match="CUDA"):
        scheduler.plan_execution([TINY], 1, ArtifactCache(tmp_path))
    assert not list(tmp_path.iterdir())  # nothing was built on the CPU


def test_spawn_pool_environment(monkeypatch, tmp_path):
    import os

    import repro_torch
    from repro_torch.memsim.engine import ENGINE_ENV, use_engine

    monkeypatch.delenv("XLA_FLAGS", raising=False)
    before = dict(os.environ)
    with use_engine("set_parallel"), scheduler._spawn_pool(
            ArtifactCache(tmp_path), 3, 2, torch.device("cpu")) as pool:
        env = dict(os.environ)
        assert pool._max_workers == min(2, os.cpu_count())
    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    assert env["PYTHONPATH"].split(os.pathsep)[0] == src
    assert env[ENGINE_ENV] == "set_parallel"
    assert int(env["OMP_NUM_THREADS"]) == max(1, os.cpu_count() // min(2, os.cpu_count()))
    assert not [k for k in env if k.startswith("JAX_") and k not in before]
    assert "XLA_FLAGS" not in env
    assert dict(os.environ) == before  # restored


def test_materialize_pipeline_dedupes_in_flight_builds(tmp_path):
    arts = ArtifactCache(tmp_path)
    warm_spec, cold_spec = TINY, WorkloadSpec("cc", "tiny")
    arts.save(warm_spec, warm_spec.build(device="cpu"))
    specs = [cold_spec, warm_spec, cold_spec, WorkloadSpec("cc", "tiny")]
    pipe = scheduler.MaterializePipeline(specs, workers=2, artifacts=arts, device="cpu")
    try:
        assert (pipe.n_specs, pipe.n_built, pipe.n_reused) == (2, 1, 1)
        assert list(pipe._futures) == [str(arts.path_for(cold_spec))]
        for s in specs:
            pipe.wait(s)
            assert arts.has(s)
    finally:
        pipe.close()
    assert "build_s" in arts.load_cost(cold_spec)
    warm = scheduler.MaterializePipeline(specs, workers=2, artifacts=arts, device="cpu")
    warm.close()
    assert (warm.n_built, warm.n_reused) == (0, 2)
    assert warm._stack is None  # no pool was opened
    assert scheduler.materialize_specs(specs, workers=2, artifacts=arts, device="cpu") == 0
