"""The port's ``Experiment``, workload and artifact caches and telemetry
against the JAX package.

The reduced grid (cc and bellmanford#s0 on comdblp, scored with ``amc`` and
``rnr``) must give the JAX package's rows exactly.  The artifact cache is
the port's own: its root and variable (``REPRO_TORCH_WORKLOAD_CACHE``) and a
port marker in its key, so a directory the JAX package wrote is never read.
Every kind of workload the JAX package's ``Experiment`` takes (plain,
sharded, stream and serve specs) is ported and routed as it routes them.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ArtifactCache, Experiment, WorkloadCache, WorkloadSpec
from repro_torch.core.exec import artifacts, collect_stages, stage
from repro_torch.core.obs import spans

ROOT = Path(__file__).resolve().parents[1]
PREFETCHERS = ["amc", "rnr"]


def jsonable(x):
    return json.loads(json.dumps(x, default=lambda o: o.tolist()))


@pytest.fixture(scope="module")
def reduced_grid():
    """The port's reduced grid on the CPU, with its stage seconds."""
    with collect_stages() as stages:
        res = Experiment(
            kernels=["cc", "bellmanford"], datasets=["comdblp"],
            prefetchers=PREFETCHERS, device="cpu",
        ).run(workers=1)
    return res, stages


def test_reduced_grid_rows_equal_jax(reduced_grid):
    from repro.core import Experiment as JExperiment

    res, _ = reduced_grid
    ref = JExperiment(
        kernels=["cc", "bellmanford"], datasets=["comdblp"], prefetchers=PREFETCHERS
    ).run(workers=1)
    assert len(res.rows()) == 4
    assert jsonable(res.rows()) == jsonable(ref.rows())
    for c in res.cells:
        assert c.metrics.speedup == res.suite(c.kernel, "comdblp")[c.prefetcher].speedup
    assert res.workload("bellmanford", "comdblp").eval_from_pos > 0


def test_serial_run_telemetry(reduced_grid):
    res, _ = reduced_grid
    assert res.sched is None
    man = res.telemetry["manifest"]
    assert man["torch"] == torch.__version__ and man["device"] == "cpu"
    assert man["engine"] == "fused" and man["trace_code_version"] == 2
    assert res.telemetry["workload_cache"] == dict(hits=0, builds=2, loads=0, reuses=0)


def test_collect_stages_sees_the_pipeline(reduced_grid):
    _, stages = reduced_grid
    for name in ("trace_gen", "trace_emit", "demand_sim", "score",
                 "cache_pass[fused]", "cache_pass[l2]", "cache_pass[llc]"):
        assert stages.get(name, 0.0) > 0.0, name
    assert stages["trace_gen"] >= stages["trace_emit"]


def test_workload_cache_counters_and_spans():
    cache = WorkloadCache()
    exp = Experiment(kernels=["bfs"], datasets=["tiny"], prefetchers=["amc", "vldp"],
                     cache=cache, device="cpu")
    assert [(s.kernel, n) for s, n in exp.grid] == [("bfs", "amc"), ("bfs", "vldp")]
    with spans.trace() as tracer:
        first = exp.run()
    assert (cache.builds, cache.hits, cache.loads, len(cache)) == (1, 0, 0, 1)
    names = {s.name for s in tracer.result.spans}
    assert {"experiment_run", "get_or_build", "build_workload", "trace_gen",
            "demand_sim", "score_batch", "score_cell", "score"} <= names
    assert tracer.result.metrics["counters"]["workload_cache.builds"] == 1.0
    assert first.telemetry["trace_id"] == tracer.trace_id
    again = Experiment(kernels=["bfs"], datasets=["tiny"], prefetchers=["vldp", "amc"],
                       cache=cache, device="cpu").run()
    assert (cache.builds, cache.hits) == (1, 1)
    assert again.metrics(prefetcher="amc").row() == first.metrics(prefetcher="amc").row()
    cache.evict(WorkloadSpec("bfs", "tiny"))
    assert len(cache) == 0


def test_artifact_round_trip(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_WORKLOAD_CACHE", str(tmp_path / "port"))
    assert artifacts.default_cache_dir() == tmp_path / "port"

    def run():
        cache = WorkloadCache(artifacts=ArtifactCache())
        res = Experiment(kernels=["bfs"], datasets=["tiny"], prefetchers=PREFETCHERS,
                         cache=cache, device="cpu").run()
        return cache, res

    cold_cache, cold = run()
    assert (cold_cache.builds, cold_cache.loads, cold_cache.artifacts.saves) == (1, 0, 1)
    files = sorted(p.name for p in (tmp_path / "port").glob("*.npz"))
    assert len(files) == 1 and files[0].startswith("bfs_tiny_s0_")
    warm_cache, warm = run()
    assert (warm_cache.builds, warm_cache.loads) == (0, 1)
    assert jsonable(warm.rows()) == jsonable(cold.rows())
    a, b = cold.workload("bfs", "tiny"), warm.workload("bfs", "tiny")
    assert b.device.type == "cpu" and b.eval_from_pos == a.eval_from_pos
    for f in ("block", "array_id", "epoch_id", "iter_id", "elem", "nl_blocks", "nl_pos"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)


@dataclasses.dataclass(frozen=True)
class AliasSpec(WorkloadSpec):
    """A content-keyed spec: its trace is determined by (kernel, dataset,
    seed) whatever its ``alias``."""

    alias: int = 0

    def content_key(self):
        return dict(kernel=self.kernel, dataset=self.dataset, seed=self.seed)


def test_content_keyed_specs_share_one_build(tmp_path):
    cache = WorkloadCache()
    first = cache.get_or_build(AliasSpec("bfs", "tiny", alias=0), device="cpu")
    second = cache.get_or_build(AliasSpec("bfs", "tiny", alias=1), device="cpu")
    assert (cache.builds, cache.reuses, cache.hits, len(cache)) == (1, 1, 0, 2)
    assert second.spec.alias == 1 and second.block is first.block
    store = ArtifactCache(tmp_path)
    paths = {store.path_for(AliasSpec("bfs", "tiny", alias=a)) for a in (0, 1)}
    assert len(paths) == 1 and "_g" in paths.pop().name
    assert store.path_for(WorkloadSpec("bfs", "tiny")).name.count("_g") == 0


def test_jax_artifacts_are_never_read(monkeypatch, tmp_path):
    from repro.core.driver import WorkloadSpec as JSpec
    from repro.core.exec.artifacts import ArtifactCache as JArtifactCache

    shared = tmp_path / "jax"
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("REPRO_WORKLOAD_CACHE", str(shared))
    monkeypatch.delenv("REPRO_TORCH_WORKLOAD_CACHE", raising=False)
    jspec = JSpec("bfs", "tiny")
    JArtifactCache().save(jspec, jspec.build())
    jax_files = {p.name: p.read_bytes() for p in shared.iterdir()}
    assert len(jax_files) == 1

    # The port's default root is its own, whatever the JAX package's says.
    assert artifacts.default_cache_dir() == tmp_path / "home" / ".cache" / "repro-amc-torch" / "workloads"
    # Pointed at the very directory the JAX package wrote, it still misses:
    # the port marker moves its key.
    monkeypatch.setenv("REPRO_TORCH_WORKLOAD_CACHE", str(shared))
    port = ArtifactCache()
    assert port.root == shared
    assert port.path_for(WorkloadSpec("bfs", "tiny")).name not in jax_files
    assert port.load(WorkloadSpec("bfs", "tiny"), device="cpu") is None
    cache = WorkloadCache(artifacts=port)
    Experiment(kernels=["bfs"], datasets=["tiny"], prefetchers=["rnr"], cache=cache,
               device="cpu").run()
    assert (cache.builds, cache.loads) == (1, 0)
    for name, data in jax_files.items():
        assert (shared / name).read_bytes() == data


def test_stage_and_span_are_noops_with_nothing_active(monkeypatch):
    monkeypatch.delenv(spans.SPAN_DIR_ENV, raising=False)
    spans._reset_for_tests()
    try:
        assert (spans.SPAN_DIR_ENV, spans.TRACE_ID_ENV) == (
            "REPRO_TORCH_TRACE_DIR", "REPRO_TORCH_TRACE_ID")
        with stage("trace_gen"):
            pass
        with spans.span("score_cell", prefetcher="amc") as sp:
            assert sp is None
        spans.record("x")
        spans.inc("y")
        assert spans.current_tracer() is None and spans.current_metrics() is None
        assert spans._STAGES is None
    finally:
        spans._reset_for_tests()


def test_what_is_not_ported_raises():
    # Nothing is left: stream and serve specs are routed beside plain and
    # sharded ones, as the JAX package's Experiment routes them.
    import repro_torch.core.exec as exec_pkg
    from repro_torch.core.exec import scheduler
    from repro_torch.core.exec.sharded import ShardedSpec
    from repro_torch.serve.protocol import ServeSpec, TenantSpec
    from repro_torch.stream.protocol import StreamSpec
    from repro_torch.stream.updates import UniformChurn

    stream = StreamSpec("pgd", "tiny", UniformChurn(), epochs=2)
    serve = ServeSpec(tenants=(TenantSpec("pgd", "tiny"),))
    sharded = ShardedSpec(WorkloadSpec("bfs", "tiny"))
    plain = WorkloadSpec("pgd", "tiny")
    exp = Experiment(workloads=[plain, stream, sharded, serve], device="cpu")
    assert exp.workload_specs == [plain, sharded]
    assert exp.stream_specs == [stream] and exp.serve_specs == [serve]
    assert exec_pkg.run_grid is scheduler.run_grid
    assert exec_pkg.SchedDecision is scheduler.SchedDecision


def test_experiment_needs_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Experiment(kernels=["pgd"], datasets=["tiny"])
    with pytest.raises(RuntimeError, match="CUDA"):
        WorkloadCache().get_or_build(WorkloadSpec("pgd", "tiny"))


def test_no_port_module_imports_jax_or_repro():
    """Every module of the port loaded into one fresh interpreter leaves
    no ``jax`` or ``repro`` module behind."""
    code = (
        "import pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: __import__(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(mods), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split(maxsplit=1)
    assert int(out[0]) > 60
    assert out[1].strip() == "[]"
