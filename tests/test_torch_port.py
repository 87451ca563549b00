"""The port end to end against the JAX package, plus its two guards.

End to end: pgd/tiny under ``SCALED``, built and scored with ``amc`` and
``vldp`` through the public entry points of both packages, gives
dict-equal metric rows.  Guards: no module of ``src/repro_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, and the entry points
refuse to run without a CUDA device unless the caller passes
``device="cpu"``.
"""
import ast
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _rows(metrics):
    return [json.loads(json.dumps(m.row(), default=lambda o: o.tolist())) for m in metrics]


@pytest.fixture(scope="module")
def tiny_workloads():
    from repro.core.driver import WorkloadSpec as JSpec

    from repro_torch.core import WorkloadSpec as TSpec

    return JSpec("pgd", "tiny").build(), TSpec("pgd", "tiny").build(device="cpu")


@pytest.mark.parametrize("batched", [True, False])
def test_tiny_rows_equal_jax(tiny_workloads, batched):
    from repro.core.experiment import score_prefetcher as j_score
    from repro.core.experiment import score_prefetchers_batched as j_batched
    from repro.core.registry import resolve_prefetchers as j_resolve

    from repro_torch.core import resolve_prefetchers, score_prefetcher, score_prefetchers_batched

    jwl, twl = tiny_workloads
    assert twl.device == torch.device("cpu")
    assert twl.num_accesses == jwl.num_accesses and twl.iter_epochs == jwl.iter_epochs
    for f in ("block", "array_id", "epoch_id", "iter_id", "elem", "nl_blocks", "nl_pos"):
        np.testing.assert_array_equal(getattr(twl, f), getattr(jwl, f), err_msg=f)
    names = ["amc", "vldp"]
    if batched:
        ref = j_batched(jwl, j_resolve(names))
        got = score_prefetchers_batched(twl, resolve_prefetchers(names))
    else:
        ref = [j_score(jwl, n, g) for n, g in j_resolve(names)]
        got = [score_prefetcher(twl, n, g) for n, g in resolve_prefetchers(names)]
    assert _rows(got) == _rows(ref)


def test_amc_iteration_views_equal(tiny_workloads):
    jwl, twl = tiny_workloads
    for (tv, te), (jv, je) in zip(twl.amc_iteration_views(), jwl.amc_iteration_views()):
        assert te == je
        for f in ("iteration", "within_epoch"):
            assert getattr(tv, f) == getattr(jv, f)
        for f in ("target_pos", "target_vid", "miss_pos", "miss_blocks"):
            np.testing.assert_array_equal(getattr(tv, f), getattr(jv, f))


def test_two_run_kernels_are_not_ported_yet():
    """The two-run protocol is ported now (the name is kept from the slice
    that refused it): a registered two-run kernel runs twice, on the §VI
    pair's run 1 and run 2 with their presence masks and one shared root,
    and the evaluation window starts at run 2."""
    from repro_torch.apps import bfs, pick_root, registry
    from repro_torch.core.driver import WorkloadSpec
    from repro_torch.graphs import make_dataset, make_evolving_pair

    calls = []

    @registry.register_kernel(
        "two_run_probe", epoch_protocol="per_run", needs_root=True
    )
    def probe(graph, present_mask=None, root=None, device=None):
        calls.append((graph.name, present_mask, root))
        return bfs(graph, root=root, present_mask=present_mask, device=device)

    try:
        wl = WorkloadSpec("two_run_probe", "tiny", seed=2).build(device="cpu")
    finally:
        del registry._REGISTRY["two_run_probe"]
    pair = make_evolving_pair(make_dataset("tiny"), seed=2)
    root = pick_root(pair.run1, pair.mask1 & pair.mask2)
    assert [(name, r) for name, _, r in calls] == [("tiny@run1", root), ("tiny@run2", root)]
    np.testing.assert_array_equal(calls[0][1], pair.mask1)
    np.testing.assert_array_equal(calls[1][1], pair.mask2)
    first_run2 = [e for e, _ in wl.iter_epochs].index(1)
    assert wl.eval_from_pos == int(np.searchsorted(wl.iter_id, first_run2)) > 0


# ------------------------------------------------------------------ guards


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_never_imports_jax_or_repro():
    files = _port_sources()
    assert len(files) > 20
    port = {p.relative_to(ROOT / "src" / "repro_torch").as_posix() for p in files[:-1]}
    assert {"memsim/streaming.py", "core/exec/sharded.py", "core/exec/scheduler.py"} <= port
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch import memsim
    from repro_torch.core import WorkloadSpec, build_workload
    from repro_torch.device import resolve_device
    from repro_torch.memsim import engine, fused, hierarchy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blocks = np.arange(100, dtype=np.int64)
    it = np.zeros(100, np.int32)
    levels = ((16, 8), (64, 8))
    calls = [
        lambda **kw: resolve_device(**kw),
        lambda **kw: build_workload("pgd", "tiny", **kw),
        lambda **kw: WorkloadSpec("pgd", "tiny").build(**kw),
        lambda **kw: hierarchy.simulate_demand(blocks, it, memsim.SCALED, **kw),
        lambda **kw: hierarchy.simulate_demand_batch([(blocks, it)], memsim.SCALED, **kw),
        lambda **kw: engine.cache_pass(blocks, 16, 8, **kw),
        lambda **kw: engine.cache_pass_batch([blocks], 16, 8, **kw),
        lambda **kw: fused.fused_cache_pass(blocks, levels, **kw),
        lambda **kw: fused.fused_cache_pass_batch([blocks], levels, **kw),
        lambda **kw: engine.init_state(16, 8, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        with pytest.raises(RuntimeError, match="CUDA"):
            call(device="cuda")
    for call in calls[3:]:
        call(device="cpu")  # runs
