"""Golden ``Experiment`` rows for the port's evaluation grid, computed by the
JAX package.

``tests/data/torch_port_golden_grid.json`` holds, per cell, the rows of
``repro.core.Experiment(...).run(workers=1).rows()`` and, for each of its
workloads, the iterations, accesses, ``eval_from_pos`` and a sha256 of the
demand hit-level array:

- ``G``: the BENCH v9 grid (``BENCH_2026-08-07.5.json`` ``grid``): pgd, cc,
  bfs#s0-s2, bellmanford#s0-s2 and bfs_do#s0 on comdblp under ``SCALED``,
  each scored with ``amc`` and ``rnr`` (18 rows);
- ``G-fused``: that file's ``fused`` cell, pgd/comdblp#s0 with ``amc``,
  ``vldp`` and ``rnr``;
- ``G-quick``: the ``examples/quickstart.py`` cell, pgd/comdblp with
  ``amc`` and ``vldp``;
- ``G-tableI``: every registered prefetcher on pgd/comdblp#s0;
- ``H``: bellmanford/google under ``PAPER`` (the paper's Table VI
  hierarchy), the §VI pair with seed 0, scored on run 2 with ``amc``,
  ``vldp`` and ``rnr``.

``chip_smoke.py`` holds the port's run on the GPU against this file, so it
never needs the JAX package.  Here, cc/comdblp#s0 and
bellmanford/comdblp#s0 of ``G`` are recomputed through the JAX package and
through the port on the CPU, and both must equal the file.  The whole file
is written (about a minute on a CPU) only by running this module, with
the names of the cells to rewrite or none for all of them::

    PYTHONPATH=src python tests/test_torch_golden_grid.py [G G-fused ...]
"""
import hashlib
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_port_golden_grid.json")
BENCH_GRID = [
    "pgd/comdblp#s0",
    "cc/comdblp#s0",
    "bfs/comdblp#s0",
    "bfs/comdblp#s1",
    "bfs/comdblp#s2",
    "bellmanford/comdblp#s0",
    "bellmanford/comdblp#s1",
    "bellmanford/comdblp#s2",
    "bfs_do/comdblp#s0",
]
TABLE_I = ["nextline2", "prodigy", "isb", "misb", "domino", "vldp", "bingo", "rnr", "amc", "ideal"]
# cell name -> its Experiment: workloads "kernel/dataset#sSEED", hierarchy, prefetchers
CELLS = {
    "G": dict(workloads=BENCH_GRID, hierarchy="SCALED", prefetchers=["amc", "rnr"]),
    "G-fused": dict(workloads=["pgd/comdblp#s0"], hierarchy="SCALED",
                    prefetchers=["amc", "vldp", "rnr"]),
    "G-quick": dict(workloads=["pgd/comdblp#s0"], hierarchy="SCALED",
                    prefetchers=["amc", "vldp"]),
    "G-tableI": dict(workloads=["pgd/comdblp#s0"], hierarchy="SCALED", prefetchers=TABLE_I),
    "H": dict(workloads=["bellmanford/google#s0"], hierarchy="PAPER",
              prefetchers=["amc", "vldp", "rnr"]),
}


def parse_workload(name: str):
    """``"kernel/dataset#sSEED"`` -> (kernel, dataset, seed)."""
    kd, seed = name.split("#s")
    kernel, dataset = kd.split("/")
    return kernel, dataset, int(seed)


def jsonable(x):
    """Plain-JSON form of a row (numpy scalars and arrays unwrapped)."""
    return json.loads(json.dumps(x, default=lambda o: o.tolist()))


def demand_levels(profile) -> np.ndarray:
    """Per-access hit level of a demand profile: 0 L1, 1 L2, 2 LLC, 3 DRAM."""
    lvl = np.full(len(profile.blocks), 3, dtype=np.int8)
    lvl[profile.l1_hit] = 0
    lvl[profile.l2_pos[profile.l2_hit]] = 1
    lvl[profile.l2_miss_pos[profile.llc_hit]] = 2
    return lvl


def workload_record(w) -> dict:
    return dict(
        iterations=len(w.iter_epochs),
        accesses=w.num_accesses,
        eval_from_pos=int(w.eval_from_pos),
        levels_sha256=hashlib.sha256(demand_levels(w.profile).tobytes()).hexdigest(),
    )


def cell_record(result, cell: dict) -> dict:
    """One cell's record from an ``ExperimentResult`` of either package."""
    workloads = {}
    for name in cell["workloads"]:
        kernel, dataset, seed = parse_workload(name)
        workloads[name] = workload_record(result.workload(kernel, dataset, seed))
    return dict(cell, rows=jsonable(result.rows()), workload_records=workloads)


def run_jax(cell: dict) -> dict:
    from repro import memsim
    from repro.core import Experiment, WorkloadSpec

    hierarchy = getattr(memsim, cell["hierarchy"])
    specs = [WorkloadSpec(k, d, hierarchy=hierarchy, seed=s)
             for k, d, s in map(parse_workload, cell["workloads"])]
    res = Experiment(workloads=specs, prefetchers=cell["prefetchers"]).run(workers=1)
    return cell_record(res, cell)


def run_port(cell: dict, device="cpu") -> dict:
    from repro_torch import memsim
    from repro_torch.core import Experiment, WorkloadSpec

    hierarchy = getattr(memsim, cell["hierarchy"])
    specs = [WorkloadSpec(k, d, hierarchy=hierarchy, seed=s)
             for k, d, s in map(parse_workload, cell["workloads"])]
    res = Experiment(workloads=specs, prefetchers=cell["prefetchers"], device=device).run()
    return cell_record(res, cell)


def sub_cell(golden: dict, workloads) -> tuple:
    """``G`` cut to ``workloads``: (cell declaration, its golden record)."""
    cell = dict(CELLS["G"], workloads=list(workloads))
    want = dict(
        cell,
        rows=[r for r in golden["G"]["rows"]
              if f"{r['kernel']}/{r['dataset']}#s{r['seed']}" in workloads],
        workload_records={w: golden["G"]["workload_records"][w] for w in workloads},
    )
    return cell, want


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def test_file_holds_every_cell(golden):
    assert sorted(golden) == sorted(CELLS)
    for name, cell in CELLS.items():
        rec = golden[name]
        assert {k: rec[k] for k in cell} == cell
        assert sorted(rec["workload_records"]) == sorted(cell["workloads"])
        assert len(rec["rows"]) == len(cell["workloads"]) * len(cell["prefetchers"])
    assert len(golden["G"]["rows"]) == 18


@pytest.mark.parametrize("kernel", ["cc", "bellmanford"])
def test_jax_recomputes_the_file(golden, kernel):
    cell, want = sub_cell(golden, [f"{kernel}/comdblp#s0"])
    assert run_jax(cell) == want


@pytest.mark.parametrize("kernel", ["cc", "bellmanford"])
def test_port_on_cpu_equals_the_file(golden, kernel):
    cell, want = sub_cell(golden, [f"{kernel}/comdblp#s0"])
    assert run_port(cell) == want


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    names = sys.argv[1:] or list(CELLS)
    out = {}
    if os.path.exists(GOLDEN):
        with open(GOLDEN) as f:
            out = json.load(f)
    for name in names:
        out[name] = run_jax(CELLS[name])
        print(f"{name}: {len(out[name]['rows'])} rows", flush=True)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {GOLDEN}")
