"""The model path's spans (``repro_torch.core.obs.spans``), on the CPU at
the reduced zamba2 (5 layers: two groups and a tail, each Mamba2 layer's
gate a span of its own) and mixtral (2 layers, 4 experts at top-2).

Off (no tracer, no profiler) a prefill launches the same aten ops as with
every span a null context; an obs tracer or a metrics registry adds none.
Under ``torch.profiler`` each span is a ``record_function`` range, nested
as the layers are, and the outputs are bit-equal to an untraced run's;
under an obs tracer the same spans are recorded.  Importing the model path
loads no graph-path module.
"""
import contextlib
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.obs import spans as obs  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

ROWS, LENGTH = 2, 24


def config(arch):
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, num_layers=5) if cfg.family == "hybrid" else cfg


@functools.lru_cache(maxsize=None)
def make_prefill(arch):
    """``(cfg, run)``: ``run()`` prefills one seeded batch of the reduced
    model in float32 on the CPU."""
    cfg = dataclasses.replace(config(arch), dtype="float32", param_dtype="float32")
    model = init_params(cfg, seed=3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (ROWS, LENGTH),
                           generator=torch.Generator().manual_seed(5))
    step = make_prefill_step(cfg)
    return cfg, lambda: step(model, {"tokens": tokens})


@pytest.fixture(params=["zamba2_1p2b", "mixtral_8x22b"])
def prefill(request):
    return make_prefill(request.param)


class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((str(func), tuple(a.dtype for a in args if isinstance(a, torch.Tensor))))
        return func(*args, **(kwargs or {}))


def logged(run):
    with OpLog() as log:
        run()
    return log.ops


def flat(out):
    logits, cache = out
    leaves = [logits]

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)

    walk(cache)
    return leaves


def test_off_path_launches_what_null_spans_launch(prefill, monkeypatch):
    cfg, run = prefill
    run()  # first-call set-up outside the logs
    with monkeypatch.context() as m:  # off: neither sink may be opened
        m.setattr(torch.profiler, "record_function", None)
        m.setattr(obs.Tracer, "open_span", None)
        with_spans = logged(run)
    with monkeypatch.context() as m:
        m.setattr(obs, "span", lambda name, **attrs: contextlib.nullcontext())
        null_spans = logged(run)
    assert with_spans == null_spans
    # the host-side sinks launch nothing either
    with obs.metrics_registry():
        assert logged(run) == null_spans
    with obs.trace():
        assert logged(run) == null_spans


def expected_spans(cfg):
    """``{span name: count}`` of one prefill."""
    n = cfg.num_layers
    out = {"launch.prefill_step": 1, "models.logits": 1}
    if cfg.family == "hybrid":
        groups, rest = divmod(n, cfg.hybrid_attn_every)
        # each group's states, then the groups' states, their (k, v) and the tail's
        out.update({"models.layer.mamba": n, "models.ssm.gate": n, "models.layer.shared": groups,
                    "models.attention": groups, "models.cache": groups + 2 + (rest > 0)})
    else:
        out.update({"models.layer.moe": n, "models.attention": n, "models.cache": 1})
        out.update({f"models.moe.{p}": n for p in ("route", "dispatch", "experts", "combine")})
    return out


def inside(inner, outer):
    """Each of ``inner``'s intervals lies in one of ``outer``'s."""
    return all(any(a <= s and e <= b for a, b in outer) for s, e in inner)


def test_spans_enter_the_profiler_nested(prefill):
    cfg, run = prefill
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = {}
    for e in prof.events():
        if e.name.startswith(("launch.", "models.")):
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    assert {k: len(v) for k, v in spans.items()} == expected_spans(cfg)
    top = spans["launch.prefill_step"]
    assert all(inside(v, top) for v in spans.values())
    if cfg.family == "hybrid":
        assert inside(spans["models.attention"], spans["models.layer.shared"])
        assert inside(spans["models.ssm.gate"], spans["models.layer.mamba"])
        assert not inside(spans["models.layer.mamba"], spans["models.layer.shared"])
    else:
        for phase in ("route", "dispatch", "experts", "combine"):
            assert inside(spans[f"models.moe.{phase}"], spans["models.layer.moe"])
        assert inside(spans["models.attention"], spans["models.layer.moe"])


def test_spans_enter_the_tracer_nested(prefill):
    cfg, run = prefill
    with obs.trace() as tracer:
        run()
    spans = tracer.result.spans
    counts = {}
    for s in spans:
        counts[s.name] = counts.get(s.name, 0) + 1
    assert counts == expected_spans(cfg)
    by_id = {s.span_id: s for s in spans}
    assert tracer.result.by_name("launch.prefill_step")[0].parent_id is None
    pairs = ([("models.moe.experts", "models.layer.moe")] if cfg.family == "moe" else
             [("models.attention", "models.layer.shared"),
              ("models.ssm.gate", "models.layer.mamba")])
    for inner, outer in pairs:
        assert all(by_id[s.parent_id].name == outer for s in tracer.result.by_name(inner))


def test_outputs_are_bit_equal_traced_and_untraced(prefill):
    cfg, run = prefill
    off = flat(run())
    with profile(activities=[ProfilerActivity.CPU]):
        on = flat(run())
    assert len(on) == len(off) and all(torch.equal(a, b) for a, b in zip(on, off))


def test_model_path_loads_no_graph_module():
    code = ("import sys, repro_torch.launch.steps, repro_torch.models\n"
            "bad = ('repro_torch.apps', 'repro_torch.graphs', 'repro_torch.core.driver',"
            " 'repro_torch.core.experiment', 'repro_torch.core.registry',"
            " 'repro_torch.kernels.cache_sim')\n"
            "print(sorted(m for m in sys.modules if m.startswith(bad)))\n")
    src = str(Path(__file__).resolve().parent.parent / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([src, os.environ.get("PYTHONPATH", "")]))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"
