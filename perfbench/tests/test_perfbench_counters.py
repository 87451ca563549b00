"""The program's counters reach the metric readers from the traced cycle
alone: a run opens a metrics registry around the traced cycle and nowhere
else, and the readers find what the program incremented (``obs.inc``)
there under ``Context.counters``.  The timed window runs with no registry
open, as the program runs untraced."""
from __future__ import annotations

import json

import pytest
import torch

from perfbench import bench
from perfbench.tests.tiny import tiny_root


def counting_factory(seen: list):
    """The prefill step, which counts each batch it runs into the open
    registry and notes whether one was open."""
    from repro_torch.core import obs
    from repro_torch.launch.steps import make_prefill_step

    def factory(model_cfg):
        step = make_prefill_step(model_cfg)

        def prefill(model, batch):
            seen.append(obs.current_metrics() is not None)
            obs.inc("test.counter", 1.0)
            return step(model, batch)

        return prefill

    return factory


@pytest.mark.parametrize("trace", [0, 1])
def test_counters_of_the_traced_cycle_alone(tmp_path, monkeypatch, trace):
    root = tiny_root(tmp_path)
    bench_dir = root / "perfbench"  # a small cell: the counters, not the check, are tested
    for path, cut in ((bench_dir / "configs" / "mixtral-8x22b.json",
                       {"num_layers": 2, "dtype": "float32", "param_dtype": "float32"}),
                      (bench_dir / "traffic" / "prefill-2k-16k.json",
                       {"lengths": [32, 64], "batch_tokens": 128}),
                      (bench_dir / "workloads" / "mixtral-8x22b.prefill.json",
                       {"check": {"batches": 1, "within_cycles": 1}})):
        path.write_text(json.dumps(dict(json.loads(path.read_text()), **cut)))
    cell = bench.load_cell("mixtral-8x22b.prefill", root)
    contexts = []

    class Recorded(bench.Context):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            contexts.append(self)

    monkeypatch.setattr(bench, "Context", Recorded)
    seen: list = []
    bench.run_cell(cell, 2**31 + 41, 0.2, bool(trace), torch.device("cpu"), 0.0,
                   step_factory=counting_factory(seen), log=lambda m: None)
    (ctx,) = contexts
    if trace:
        assert len(ctx.traced) == len(cell.traffic.lengths)
        assert ctx.counters == {"test.counter": float(len(ctx.traced))}
        assert sum(seen) == len(ctx.traced)  # the window's and warm-up's calls saw none
    else:
        assert ctx.counters == {} and ctx.traced == []
    assert not any(seen[:len(cell.traffic.lengths) + len(ctx.batches)])
