"""The harness is driven by data: a cell, a configuration, a traffic mix, a
traffic kind with an end-to-end metric of its own, a per-layer metric and a
model family (its reference, weight tree and counts) added as new files
(and new entries in ``BENCHMARK.json``) to a copy of the benchmark are
found by name, with no existing file or entry edited; and a whole run (on the CPU,
at small sizes, the look for a card skipped) prints every key of the result
line, loads neither JAX nor the JAX package, and comes out correct."""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench import bench, weights
from perfbench.counts import k5
from perfbench.tests.tiny import HERE, tiny_root

FAMILY = Path(__file__).resolve().parent / "dense_family"  # the files a new family adds

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


# no card, so no K5 kernel in the trace: one stand-in K5 operation of 1 s
K5_STAND_IN = r"""
from perfbench import devtrace
_read = devtrace.read
def _with_k5(prof):
    t = _read(prof)
    t.ops.append(("flash_attn_tc_kernel (stand-in)", t.start, t.start + 1.0))
    return t
devtrace.read = _with_k5
"""


def run_tiny(root: Path, cell: str, seed: int, trace: int, prelude: str = "") -> dict:
    script = RUN.replace("from perfbench import bench\n", "from perfbench import bench\n" + prelude)
    p = subprocess.run([sys.executable, "-c", script, str(root), cell, str(seed), str(trace)],
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def snapshot(root: Path):
    """The benchmark's files and ``BENCHMARK.json``'s entries, before a test
    adds any."""
    files = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    return files, json.loads((root / "BENCHMARK.json").read_text())


def assert_nothing_edited(root: Path, before):
    """Every file that was there is byte-identical, and every entry of
    ``BENCHMARK.json`` that was there is there unchanged."""
    files, manifest = before
    for path, data in files.items():
        assert path.read_bytes() == data, path
    now = json.loads((root / "BENCHMARK.json").read_text())
    for key, old in manifest.items():
        if isinstance(old, list):
            for entry in old:
                assert entry in now[key], (key, entry)
        else:
            assert now[key] == old, key


def add_files(root: Path):
    """A new configuration, traffic mix, cell and metric, as files and new
    entries; returns :func:`snapshot` of what was there before."""
    bench_dir = root / "perfbench"
    before = snapshot(root)
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
    assert_nothing_edited(*setup)


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


def add_family(root: Path):
    """The port's ``dense`` family with a tied head, which the benchmark has
    no module for, as files alone: its reference and tree, its counts, a
    configuration, a traffic mix, a cell and their entries (the per-layer
    quantities it reports, whose entries list other cells, as entries of its
    own); returns :func:`snapshot` of what was there before."""
    bench_dir = root / "perfbench"
    before = snapshot(root)
    (bench_dir / "reference" / "dense.py").write_bytes((FAMILY / "reference.py").read_bytes())
    (bench_dir / "counts" / "model_dense.py").write_bytes((FAMILY / "counts.py").read_bytes())
    conf = FAMILY / "smollm-360m-mini.json"
    (bench_dir / "configs" / conf.name).write_bytes(conf.read_bytes())
    (bench_dir / "traffic" / "dense-short.json").write_text(json.dumps({
        "kind": "closed_loop_prefill", "lengths": [64, 128], "batch_tokens": 256,
        "token_ids": {"dist": "zipf", "s": 1.0}, "pool_cycles": 3}))
    (bench_dir / "workloads" / "smollm-360m-mini.short.json").write_text(json.dumps({
        "check": {"batches": 2, "within_cycles": 1}, "trace_cycles": 1,
        "limits": {"token_gap": 0.01, "logits_err": 1e-3, "kv_err": 1e-3}}))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "smollm-360m-mini", "source": json.loads(
        conf.read_text())["source"], "file": f"perfbench/configs/{conf.name}", "reduced": [],
        "why": "a test"})
    manifest["workloads"].append({"name": "smollm-360m-mini.short", "config": "smollm-360m-mini",
                                  "traffic": "dense-short", "chips": 1, "why": "a test"})
    for m in list(manifest["per_layer"]):
        if m["name"] in ("prefill_mfu", "k5_roofline"):
            manifest["per_layer"].append(dict(m, name=m["name"] + ".smollm-360m-mini",
                                              workloads=["smollm-360m-mini.short"]))
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return before


@pytest.fixture(scope="module")
def family_root(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("family"))
    return root, add_family(root)


def test_new_family_changes_no_existing_file(family_root):
    assert_nothing_edited(*family_root)


@pytest.mark.parametrize("trace", [0, 1])
def test_new_family_runs_from_files_alone(family_root, trace):
    root = family_root[0]
    out = run_tiny(root, "smollm-360m-mini.short", 2**31 + 17, trace, K5_STAND_IN)
    assert out["correct"] is True and out["failed"] == 0 and out["forbidden"] == []
    assert set(out["compared"]) == {"token_gap", "logits_err", "kv_err"}
    metrics = out["metrics"]
    if not trace:
        assert set(metrics) == {"prefill_tokens_per_s", "ttft_p95_ms", "setup_s"}
        return
    mfu, roofline = "prefill_mfu.smollm-360m-mini", "k5_roofline.smollm-360m-mini"
    assert set(metrics) == {mfu, roofline}
    assert metrics[mfu]["value"] > 0
    # the traced cycle, a batch of each length, over the stand-in's 1 s: K5 once a
    # layer, as the family's counts say
    cfg = json.loads((FAMILY / "smollm-360m-mini.json").read_text())
    peaks = json.loads((HERE / "peaks.json").read_text())
    least = sum(max(ops / peaks["bf16_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
                for ops, nbytes in (k5.launch(cfg, 256 // n, n) for n in (64, 128)))
    assert metrics[roofline]["value"] == pytest.approx(100.0 * cfg["num_layers"] * least)


def test_a_family_draws_its_own_leaves(monkeypatch):
    """A family's ``draw_leaf`` draws the leaves it returns; the harness's
    rules draw the rest, from the same generators; a tied tree has no head."""
    spec = importlib.util.spec_from_file_location("perfbench.reference.dense",
                                                  FAMILY / "reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setitem(sys.modules, "perfbench.reference.dense", mod)
    cfg = json.loads((FAMILY / "smollm-360m-mini.json").read_text())
    tree = weights.draw_tree(cfg, 5, "cpu")
    assert "lm_head" not in tree
    assert float(tree["embed"].std()) == pytest.approx(cfg["d_model"] ** -0.5, rel=0.02)
    moe = dict(cfg, family="moe")  # a family with no draw of its own
    for path in (("blocks", "ln1"), ("blocks", "attn", "wo"), ("final_norm",)):
        leaf = tree
        for key in path:
            leaf = leaf[key]
        assert torch.equal(leaf, weights.draw_leaf(moe, path, tuple(leaf.shape), 5, "cpu"))


def test_a_family_without_files_is_named():
    cfg = {"family": "granite", "num_layers": 2}
    with pytest.raises(ModuleNotFoundError, match="perfbench/reference/granite.py"):
        weights.tree_shapes(cfg)
    with pytest.raises(ModuleNotFoundError, match="perfbench/counts/model_granite.py"):
        k5.attention_layers(cfg)
    ctx = bench.Context(SimpleNamespace(config=cfg, family="granite"), {}, [], 1.0)
    with pytest.raises(ModuleNotFoundError, match="perfbench/counts/model_granite.py"):
        ctx.model_flops(1, 64)


@pytest.mark.parametrize("name, reader", [
    ("k5_roofline", "k5_roofline"),
    ("k5_roofline.granite-4.0-h-small", "k5_roofline"),
    ("prefill_mfu.smollm-360m-mini", "prefill_mfu"),
])
def test_a_split_metric_is_read_by_its_quantitys_reader(name, reader):
    assert bench.metric_reader(name) == HERE / "metrics" / f"{reader}.py"


def test_a_metric_without_a_reader_is_named():
    with pytest.raises(FileNotFoundError, match="perfbench/metrics/kept_share.granite.py"):
        bench.metric_reader("kept_share.granite")
