"""Golden reference rows for the PyTorch port, computed by the JAX package.

``tests/data/torch_port_golden.json`` holds, per cell, the JAX package's
``score_prefetchers_batched`` rows for ``amc`` and ``vldp``, the iteration
and access counts, and a sha256 of the demand hit-level array.
``chip_smoke.py`` holds the port's run on the GPU against this file, so it
never needs the JAX package.

The pgd/comdblp ``SCALED`` cell is recomputed on every test run and must
equal the file.  The pgd/google ``PAPER`` cell takes minutes on a CPU, so
it is written only by running this module::

    PYTHONPATH=src python tests/test_torch_golden.py
"""
import hashlib
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_port_golden.json")
PREFETCHERS = ("amc", "vldp")
# cell name -> (kernel, dataset, hierarchy name)
CELLS = {
    "pgd/comdblp/SCALED": ("pgd", "comdblp", "SCALED"),
    "pgd/google/PAPER": ("pgd", "google", "PAPER"),
}


def jsonable(x):
    """Plain-JSON form of a metrics row (numpy scalars and arrays unwrapped)."""
    return json.loads(json.dumps(x, default=lambda o: o.tolist()))


def demand_levels(profile) -> np.ndarray:
    """Per-access hit level of a demand profile: 0 L1, 1 L2, 2 LLC, 3 DRAM."""
    lvl = np.full(len(profile.blocks), 3, dtype=np.int8)
    lvl[profile.l1_hit] = 0
    lvl[profile.l2_pos[profile.l2_hit]] = 1
    lvl[profile.l2_miss_pos[profile.llc_hit]] = 2
    return lvl


def golden_cell(kernel: str, dataset: str, hierarchy: str) -> dict:
    """One cell's golden record, computed by the JAX package."""
    from repro import memsim
    from repro.core.driver import build_workload
    from repro.core.experiment import score_prefetchers_batched
    from repro.core.registry import resolve_prefetchers

    wl = build_workload(kernel, dataset, hierarchy=getattr(memsim, hierarchy))
    rows = score_prefetchers_batched(wl, resolve_prefetchers(list(PREFETCHERS)))
    lvl = demand_levels(wl.profile)
    return dict(
        kernel=kernel,
        dataset=dataset,
        hierarchy=hierarchy,
        iterations=len(wl.iter_epochs),
        accesses=wl.num_accesses,
        l2_accesses=len(wl.profile.l2_pos),
        levels_sha256=hashlib.sha256(lvl.tobytes()).hexdigest(),
        rows={m.name: jsonable(m.row()) for m in rows},
    )


def test_comdblp_cell_matches_golden_file():
    with open(GOLDEN) as f:
        golden = json.load(f)
    cell = "pgd/comdblp/SCALED"
    assert golden[cell] == golden_cell(*CELLS[cell])


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    out = {name: golden_cell(*args) for name, args in CELLS.items()}
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {GOLDEN}")
