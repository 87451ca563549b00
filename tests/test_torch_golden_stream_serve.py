"""Golden stream and serve rows for the port, computed by the JAX package.

``tests/data/torch_port_golden_stream_serve.json`` holds, per cell, its
declaration (below, in ``CELLS``), the rows of
``repro.core.Experiment(workloads=..., prefetchers=...).run(workers=1)``
and its ``trace_reuse``:

- ``ST-full``: ``StreamSpec("bfs", "google", SlidingWindow(), epochs=4,
  hierarchy=PAPER)`` under ``persist`` and ``invalidate_changed``, with
  ``amc`` and ``nextline2`` (the paper's graph under its Table VI
  hierarchy, carried over 4 versions);
- ``SV-full``: ``ServeSpec`` of bfs#s0, bfs#s1 and bfs#s2 on google under
  ``PAPER``, ``round_robin``, both table modes, ``amc`` and ``nextline2``;
- ``ST-models``: pgd/comdblp over 3 epochs, ``CommunityChurn`` under
  ``age`` (``max_age=2``), ``PreferentialGrowth`` under
  ``invalidate_changed`` and ``UniformChurn`` under ``persist``, with
  ``amc`` and ``nextline2``; ``ST-models-tiny`` is the same on ``tiny``;
- ``SV-rate``: pgd#s0 and cc#s0 on comdblp under the ``rate`` policy with
  rates 1.0 and 2.0, both table modes, ``amc`` and ``nextline2``;
- ``zero-churn``: ``StreamSpec("pgd", "tiny", UniformChurn(init_frac=1.0,
  del_frac=0.0, add_frac=0.0), epochs=3)`` with ``amc``, whose
  ``trace_reuse`` is 2 from a fresh artifact root and 3 from the root it
  filled.

``chip_smoke.py`` holds the port's run on the GPU against this file, so it
never needs the JAX package.  Here, ``ST-models-tiny``, ``SV-rate`` and
``zero-churn`` are recomputed through the JAX package and through the port
on the CPU, and both must equal the file (the port's comdblp cell under
the ``set_parallel`` engine, whose rows equal the default engine's, to keep
the plain versions' CPU time short).  The whole file is written (about two
minutes on a CPU) only by running this module, with the names of the cells
to rewrite or none for all of them::

    PYTHONPATH=src python tests/test_torch_golden_stream_serve.py [ST-full SV-full ...]
"""
import json
import os
import sys
import tempfile

import pytest

pytest.importorskip("torch")

GOLDEN = os.path.join(
    os.path.dirname(__file__), "data", "torch_port_golden_stream_serve.json"
)
TWO = ["amc", "nextline2"]


def _stream(kernel, dataset, churn, lifecycle, epochs=3, hierarchy="SCALED", **kw):
    return dict(kernel=kernel, dataset=dataset, churn=churn, epochs=epochs,
                lifecycle=lifecycle, hierarchy=hierarchy, **kw)


def _models(dataset):
    return [
        _stream("pgd", dataset, ["community_churn", {}], "age", max_age=2),
        _stream("pgd", dataset, ["preferential_growth", {}], "invalidate_changed"),
        _stream("pgd", dataset, ["uniform_churn", {}], "persist"),
    ]


# cell name -> its Experiment: streams (StreamSpec fields, the churn as
# [CHURN_MODELS kind, its parameters], the hierarchy by name) or a serve
# scenario (ServeSpec fields, tenants as TenantSpec fields), and prefetchers
CELLS = {
    "ST-full": dict(streams=[_stream("bfs", "google", ["sliding_window", {}], lc, epochs=4,
                                     hierarchy="PAPER")
                             for lc in ("persist", "invalidate_changed")],
                    prefetchers=TWO),
    "SV-full": dict(serve=dict(tenants=[dict(kernel="bfs", dataset="google", seed=s)
                                        for s in (0, 1, 2)],
                               policy="round_robin", table_modes=["per_tenant", "shared"],
                               hierarchy="PAPER"),
                    prefetchers=TWO),
    "ST-models": dict(streams=_models("comdblp"), prefetchers=TWO),
    "ST-models-tiny": dict(streams=_models("tiny"), prefetchers=TWO),
    "SV-rate": dict(serve=dict(tenants=[dict(kernel="pgd", dataset="comdblp", seed=0, rate=1.0),
                                        dict(kernel="cc", dataset="comdblp", seed=0, rate=2.0)],
                               policy="rate", table_modes=["per_tenant", "shared"],
                               hierarchy="SCALED"),
                    prefetchers=TWO),
    "zero-churn": dict(streams=[_stream("pgd", "tiny",
                                        ["uniform_churn", dict(init_frac=1.0, del_frac=0.0,
                                                               add_frac=0.0)],
                                        "persist")],
                       prefetchers=["amc"]),
}


def workloads(cell: dict, pkg: str) -> list:
    """The cell's stream or serve specs, built from the package ``pkg``
    (``"repro"`` or ``"repro_torch"``)."""
    import importlib

    memsim = importlib.import_module(f"{pkg}.memsim")
    if "serve" in cell:
        proto = importlib.import_module(f"{pkg}.serve.protocol")
        sv = cell["serve"]
        return [proto.ServeSpec(
            tenants=tuple(proto.TenantSpec(**t) for t in sv["tenants"]),
            policy=sv["policy"], table_modes=tuple(sv["table_modes"]),
            hierarchy=getattr(memsim, sv["hierarchy"]))]
    proto = importlib.import_module(f"{pkg}.stream.protocol")
    churns = importlib.import_module(f"{pkg}.stream.updates").CHURN_MODELS
    specs = []
    for st in cell["streams"]:
        kind, params = st["churn"]
        fields = {k: v for k, v in st.items() if k not in ("churn", "hierarchy")}
        specs.append(proto.StreamSpec(churn=churns[kind](**params),
                                      hierarchy=getattr(memsim, st["hierarchy"]), **fields))
    return specs


def jsonable(x):
    return json.loads(json.dumps(x, default=lambda o: o.tolist()))


def run_cell(cell: dict, pkg: str, cache=None):
    """``(rows, trace_reuse)`` of the cell through ``pkg``'s Experiment
    (the port's on the CPU)."""
    import importlib

    core = importlib.import_module(f"{pkg}.core")
    kw = dict(device="cpu") if pkg == "repro_torch" else {}
    res = core.Experiment(workloads=workloads(cell, pkg), prefetchers=cell["prefetchers"],
                          cache=cache, **kw).run(workers=1)
    return jsonable(res.rows()), res.trace_reuse


def reuse_cold_warm(cell: dict, pkg: str):
    """``(rows, trace_reuse cold, trace_reuse warm)`` through ``pkg`` from a
    fresh artifact root, then from the root the first run filled."""
    import importlib

    core = importlib.import_module(f"{pkg}.core")
    with tempfile.TemporaryDirectory() as tmp:
        runs = [run_cell(cell, pkg, core.WorkloadCache(artifacts=core.ArtifactCache(tmp)))
                for _ in range(2)]
    assert runs[0][0] == runs[1][0]
    return runs[0][0], runs[0][1], runs[1][1]


def compute(name: str) -> dict:
    cell = CELLS[name]
    if name == "zero-churn":
        rows, cold, warm = reuse_cold_warm(cell, "repro")
        return dict(cell, rows=rows, trace_reuse_cold=cold, trace_reuse_warm=warm)
    rows, reuse = run_cell(cell, "repro")
    return dict(cell, rows=rows, trace_reuse=reuse)


def golden() -> dict:
    with open(GOLDEN) as f:
        return json.load(f)


def test_the_record_declares_the_cells_here():
    gold = golden()["cells"]
    assert set(gold) == set(CELLS)
    for name, cell in CELLS.items():
        assert {k: gold[name][k] for k in cell} == jsonable(cell), name


@pytest.mark.parametrize("name", ["ST-models-tiny", "SV-rate"])
@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_cell_equals_the_record(name, pkg):
    from repro_torch.memsim import use_engine

    gold = golden()["cells"][name]
    with use_engine("set_parallel"):
        rows, reuse = run_cell(CELLS[name], pkg)
    assert rows == gold["rows"]
    assert reuse == gold["trace_reuse"]


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_zero_churn_reuse_equals_the_record(pkg):
    gold = golden()["cells"]["zero-churn"]
    rows, cold, warm = reuse_cold_warm(CELLS["zero-churn"], pkg)
    assert (cold, warm) == (gold["trace_reuse_cold"], gold["trace_reuse_warm"]) == (2, 3)
    assert rows == gold["rows"]


if __name__ == "__main__":
    names = sys.argv[1:] or list(CELLS)
    doc = golden() if os.path.exists(GOLDEN) else {}
    doc["note"] = ("Rows of repro.core.Experiment(workloads=[...]).run(workers=1) for the "
                   "stream and serve cells declared in tests/test_torch_golden_stream_serve.py"
                   " (JAX package, CPU); rewritten by running that module.")
    cells = doc.setdefault("cells", {})
    for name in names:
        cells[name] = compute(name)
        print(f"{name}: {len(cells[name]['rows'])} rows", flush=True)
    doc["cells"] = {k: cells[k] for k in CELLS if k in cells}
    with open(GOLDEN, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {GOLDEN}")
