"""One run of one cell: set-up, the measured window, the traced sub-window,
the check, and the result line.

Everything cell-specific comes from files found by name:
``BENCHMARK.json``'s workload entry names its configuration
(``configs/<config>.json``) and traffic (``traffic/<traffic>.json``); the
traffic file's ``kind`` names the module that drives the cell's entry and
computes its end-to-end metrics (``kinds/<kind>.py``); the cell's own file
(``workloads/<cell>.json``) says what the check samples and the limits it
holds; each per-layer metric is read by ``metrics/<metric>.py``, a
metric split by cell (``<metric>.<suffix>``) by its quantity's reader.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from perfbench import check, devtrace, family_module, weights
from perfbench.traffic import Traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: Traffic
    spec: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def family(self) -> str:
        return self.config["family"]

    @property
    def kind(self):
        """The module of the traffic's kind (``kinds/<kind>.py``)."""
        return kind_module(self.traffic.kind)


def kind_module(kind: str):
    return importlib.import_module(f"perfbench.kinds.{kind}")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    here = root / "perfbench"
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    path = here / "traffic" / f"{entry['traffic']}.json"
    traffic = kind_module(json.loads(path.read_text())["kind"]).load_traffic(path)
    spec = json.loads((here / "workloads" / f"{name}.json").read_text())

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(name, config, traffic, spec, [m for m in manifest["end_to_end"] if mine(m)],
                [m for m in manifest["per_layer"] if mine(m)])


def model_config(config: dict):
    """The program's ``ModelConfig`` of a configuration file: its keys that
    name a field."""
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(**{f.name: config[f.name] for f in dataclasses.fields(ModelConfig)
                          if f.name in config})


def build_model(config: dict, seed: int, device):
    """The program's model, filled leaf by leaf (each leaf drawn, loaded
    through ``convert.load_lm_tree`` and freed) from the benchmark's tree,
    which has to fill every parameter."""
    from repro_torch.convert import load_lm_tree
    from repro_torch.models import LM

    model = LM(model_config(config), device=device)
    named = dict(model.named_parameters())
    unfilled = set(named)
    for path, shape in sorted(weights.tree_shapes(config).items()):
        leaf = weights.draw_leaf(config, path, shape, seed, device)
        names = weights.names_of(path, named)
        if not names:
            raise RuntimeError(f"the program's model has no parameter for {'.'.join(path)}")
        load_lm_tree({n: named[n] for n in names}, weights.nest(path, leaf))
        unfilled -= set(names)
        del leaf
    if unfilled:
        raise RuntimeError(f"the benchmark's tree fills none of {sorted(unfilled)}")
    return model


def power_limit() -> Optional[str]:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return p.stdout.strip().splitlines()[0] if p.returncode == 0 and p.stdout.strip() else None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Batch:
    index: int
    rows: int
    length: int
    t_issue: float
    t_return: float
    t_done: float


@dataclass
class Context:
    """What a metric reader reads: the window's batches, and of the traced
    cycle its batches, its device trace and the counters the program
    incremented (``obs.inc``) while it ran."""

    cell: Cell
    peaks: dict
    batches: List[Batch]
    window_s: float
    trace: Optional[devtrace.Trace] = None
    traced: List[Batch] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)  # the traced cycle's

    @property
    def cfg(self) -> dict:
        return self.cell.config

    def count(self, name: str):
        """The counts ``counts/<name>.py`` (a kernel's, or a family's
        ``model_<family>``)."""
        return family_module("counts", name)

    def model_flops(self, rows: int, length: int) -> int:
        return self.count(f"model_{self.cell.family}").flops(self.cfg, rows, length)

    def ideal_s(self, kernel: str, batches: List[Batch]) -> float:
        """The least seconds ``kernel``'s launches of ``batches`` could take
        at the peaks."""
        mod = self.count(kernel)
        return sum(max(ops / self.peaks["bf16_flops_per_s"],
                       nbytes / self.peaks["hbm_bytes_per_s"])
                   for b in batches for ops, nbytes in mod.launches(self.cfg, b.rows, b.length))


def metric_reader(name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, else that of
    its longest dotted prefix that has one.  A cell that reports a quantity
    whose entry lists other cells adds an entry of its own,
    ``<metric>.<suffix>`` with its ``workloads``, read by the quantity's
    reader: no existing entry is edited."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = HERE / "metrics" / (".".join(parts[:n]) + ".py")
        if path.is_file():
            return path
    raise FileNotFoundError(f"no perfbench/metrics/{name}.py: no reader of metric {name!r}")


def read_metric(name: str, ctx: Context):
    path = metric_reader(name)
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             step_factory: Optional[Callable] = None, log=print) -> dict:
    """One run: returns the result object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown``, ``compared``).
    ``step_factory(cfg)`` stands in for the kind's entry (tests)."""
    peaks = json.loads((HERE / "peaks.json").read_text())
    driver = cell.kind.Driver(cell, seed, device, step_factory)
    driver.warm_up()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    batches, window_s = driver.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    prof_trace, traced, counters = None, [], {}
    if trace:
        from repro_torch.core.obs import metrics_registry
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            # the program's counters (``obs.inc``) count the traced cycle alone
            with record_function(devtrace.WINDOW_SPAN), metrics_registry() as registry:
                traced = driver.traced()
        prof_trace = devtrace.read(prof)
        counters = registry.snapshot()["counters"]

    e2e = dict(cell.kind.end_to_end(batches, window_s), setup_s=setup_s)
    ctx = Context(cell, peaks, batches, window_s, prof_trace, traced, counters)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = e2e.get(m["name"]) if not trace else read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"{driver.describe(batches, window_s)}; set-up {setup_s:.2f} s; peak {peak} B")

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev_info.update(busy_s=prof_trace.busy_s, window_s=prof_trace.window_s)
    # the check: the program's state freed, the reference on the same inputs
    values, failed = driver.check(log=log)
    ok, rows = check.judge(values, cell.spec["limits"])
    log("readings: " + json.dumps(values))
    out = {"correct": bool(ok) and failed == 0, "attempted": sum(b.rows for b in batches),
           "failed": failed, "metrics": metrics, "device": dev_info}
    if trace:
        out["breakdown"] = {"device_ops": prof_trace.top_ops(), "idle_gaps": prof_trace.idle_gaps()}
    out["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return out
