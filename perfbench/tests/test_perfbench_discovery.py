"""The harness is driven by data: a cell, a configuration, a traffic mix, a
traffic kind with an end-to-end metric of its own and a per-layer metric
added as new files (and new entries in ``BENCHMARK.json``) to a copy of the
benchmark are found by name, with no existing file edited; and a whole run
(on the CPU, at small sizes, the look for a card skipped) prints every key
the driver reads, loads neither JAX nor the JAX package, and comes out
correct."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.tests.tiny import tiny_root

RUN = r"""
import json, sys, time
t0 = time.perf_counter()
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import torch
from perfbench import bench
cell = bench.load_cell(sys.argv[2], __import__("pathlib").Path(sys.argv[1]))
out = bench.run_cell(cell, int(sys.argv[3]), 0.5, bool(int(sys.argv[4])), torch.device("cpu"),
                     t0, log=lambda m: print(m, file=sys.stderr))
out["forbidden"] = bench.forbidden_modules()
out["perfbench_from"] = bench.__file__
print(json.dumps(out))
"""


def run_tiny(root: Path, cell: str, seed: int, trace: int) -> dict:
    p = subprocess.run([sys.executable, "-c", RUN, str(root), cell, str(seed), str(trace)],
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def add_files(root: Path):
    """A new configuration, traffic mix, cell and metric, as files and new
    entries; returns the paths of the files that were there before."""
    bench_dir = root / "perfbench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    conf = json.loads((bench_dir / "configs" / "zamba2-1.2b.json").read_text())
    conf.update(name="hybrid-mini", num_layers=3, hybrid_attn_every=3)
    (bench_dir / "configs" / "hybrid-mini.json").write_text(json.dumps(conf))
    (bench_dir / "traffic" / "short-uniform.json").write_text(json.dumps({
        "kind": "closed_loop_prefill", "lengths": [64, 128], "batch_tokens": 256,
        "token_ids": {"dist": "uniform"}, "pool_cycles": 3}))
    (bench_dir / "workloads" / "hybrid-mini.short.json").write_text(json.dumps({
        "check": {"batches": 2, "within_cycles": 1}, "trace_cycles": 1,
        "limits": {"token_gap": 0.01, "kv_err": 1e-3, "state_err": 1e-3}}))
    # a kind of its own: the prefill's driver, its own end-to-end metric
    (bench_dir / "kinds" / "prefill_batch_time.py").write_text(
        "from perfbench.kinds.closed_loop_prefill import Driver, load_traffic, readings\n"
        "def end_to_end(batches, window_s):\n"
        "    return {'batch_ms_mean': 1e3 * sum(b.t_done - b.t_issue for b in batches)"
        " / len(batches)}\n")
    (bench_dir / "traffic" / "short-batch-time.json").write_text(json.dumps({
        "kind": "prefill_batch_time", "lengths": [64], "batch_tokens": 128,
        "token_ids": {"dist": "zipf", "s": 1.0}, "pool_cycles": 2}))
    (bench_dir / "workloads" / "hybrid-mini.batch-time.json").write_text(json.dumps({
        "check": {"batches": 1, "within_cycles": 1}, "trace_cycles": 1,
        "limits": {"logits_err": 1e-3, "kv_err": 1e-3, "state_err": 1e-3}}))
    (bench_dir / "metrics" / "batches_per_s.py").write_text(
        "def read(ctx):\n    return len(ctx.batches) / ctx.window_s\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "hybrid-mini", "source": "arXiv:2411.15242",
                                "file": "perfbench/configs/hybrid-mini.json", "reduced": [],
                                "why": "a test"})
    manifest["workloads"].append({"name": "hybrid-mini.short", "config": "hybrid-mini",
                                  "traffic": "short-uniform", "chips": 1, "why": "a test"})
    manifest["workloads"].append({"name": "hybrid-mini.batch-time", "config": "hybrid-mini",
                                  "traffic": "short-batch-time", "chips": 1, "why": "a test"})
    manifest["end_to_end"].insert(0, {"name": "batch_ms_mean", "unit": "ms", "better": "lower",
                                      "bound": 0.05, "source": "host_clock",
                                      "workloads": ["hybrid-mini.batch-time"]})
    manifest["per_layer"].append({"name": "batches_per_s", "unit": "1/s", "better": "higher",
                                  "source": "host_clock", "layer": "launch.steps",
                                  "moves": "prefill_tokens_per_s",
                                  "workloads": ["hybrid-mini.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return before


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("bench"))
    for name in ("zamba2-1.2b", "hybrid-mini"):
        path = root / "perfbench" / "configs" / f"{name}.json"
        if path.exists():  # float32: the program then matches the reference closely
            path.write_text(json.dumps(dict(json.loads(path.read_text()), dtype="float32",
                                            param_dtype="float32")))
    return root, add_files(root)


def test_new_files_change_no_existing_file(setup):
    root, before = setup
    for path, data in before.items():
        assert path.read_bytes() == data, path


@pytest.mark.parametrize("trace", [0, 1])
def test_new_cell_runs_from_files_alone(setup, trace):
    root = setup[0]
    out = run_tiny(root, "hybrid-mini.short", 2**31 + 11, trace)
    assert out["perfbench_from"].startswith(str(root))
    assert out["forbidden"] == []
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device", "compared"}
    assert list(out)[list(out).index("compared")] == "compared"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    metrics = out["metrics"]
    if trace:
        assert metrics["batches_per_s"]["unit"] == "1/s"
        assert metrics["batches_per_s"]["value"] > 0
        assert "breakdown" in out
        # no card: the device's readers find nothing to read
        assert "k6_roofline" not in metrics and "device_idle_share" not in metrics
    else:
        assert set(metrics) == {"prefill_tokens_per_s", "ttft_p95_ms", "setup_s"}


def test_same_seed_same_inputs(setup):
    root = setup[0]
    sys.path.insert(0, str(root))
    try:
        from perfbench.traffic import Traffic
    finally:
        sys.path.remove(str(root))
    t = Traffic.load(root / "perfbench" / "traffic" / "short-uniform.json")
    seed = 2**31 + 5
    a, b = t.pool(seed, 512, "cpu"), t.pool(seed, 512, "cpu")
    assert t.order(seed) == t.order(seed) and all((x == y).all() for x, y in zip(a, b))
    assert sorted(t.order(seed)[:2]) == [64, 128]
    c = t.pool(seed + 1, 512, "cpu")
    assert any((x.shape != y.shape) or (x != y).any() for x, y in zip(a, c))


def test_new_kind_runs_from_files_alone(setup):
    root = setup[0]
    out = run_tiny(root, "hybrid-mini.batch-time", 2**31 + 13, 0)
    assert out["correct"] is True and out["forbidden"] == []
    assert set(out["metrics"]) == {"batch_ms_mean", "setup_s"}
    assert out["metrics"]["batch_ms_mean"]["value"] > 0
