"""Golden reference for the port's evolving-graph slice, computed by the
JAX package.

``tests/data/torch_port_golden_evolving.json`` holds, per cell of the
§VI two-run protocol, the JAX package's ``score_prefetchers_batched`` rows,
the iterations of each run, the access counts, ``eval_from_pos`` and a
sha256 of the demand hit-level array; and, for the AMC gather demo of
``examples/evolving_graph_analytics.py``, the session's ``stats``, the
stream stability and a sha256 of each run's index stream.
``chip_smoke.py`` holds the port's run on the GPU against this file, so it
never needs the JAX package.

Every cell and the gather demo are recomputed on every test run and must
equal the file (about 40 s on one CPU core).  The file is written by
running this module::

    PYTHONPATH=src python tests/test_torch_golden_evolving.py
"""
import hashlib
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_port_golden_evolving.json")
# cell name -> (kernel, dataset, hierarchy name, prefetchers)
CELLS = {
    "bfs/notredame/SCALED": ("bfs", "notredame", "SCALED", ("amc", "vldp")),
    "bfs/google/PAPER": ("bfs", "google", "PAPER", ("amc", "vldp")),
    "bfs_do/notredame/SCALED": ("bfs_do", "notredame", "SCALED", ("amc",)),
}
DEMO = "amc_gather_demo"


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


def golden_cell(kernel: str, dataset: str, hierarchy: str, prefetchers) -> dict:
    """One cell's golden record, computed by the JAX package."""
    from repro import memsim
    from repro.core.driver import build_workload
    from repro.core.experiment import score_prefetchers_batched
    from repro.core.registry import resolve_prefetchers

    wl = build_workload(kernel, dataset, hierarchy=getattr(memsim, hierarchy))
    rows = score_prefetchers_batched(wl, resolve_prefetchers(list(prefetchers)))
    runs = [e for e, _ in wl.iter_epochs]
    return dict(
        kernel=kernel,
        dataset=dataset,
        hierarchy=hierarchy,
        prefetchers=list(prefetchers),
        iterations=len(wl.iter_epochs),
        run_iterations=[runs.count(0), runs.count(1)],
        accesses=wl.num_accesses,
        l2_accesses=len(wl.profile.l2_pos),
        eval_from_pos=wl.eval_from_pos,
        levels_sha256=hashlib.sha256(demand_levels(wl.profile).tobytes()).hexdigest(),
        rows={m.name: jsonable(m.row()) for m in rows},
    )


def demo_streams(pair, cap: int = 8, top: int = 512):
    """The demo's two index streams, built as the example builds them: the
    first ``cap`` neighbors of the ``top`` vertices of highest degree in
    both runs, padded with the vertex itself."""

    def vertex_stream(run, vids):
        out = []
        for v in vids:
            s, e = run.offsets[v], run.offsets[v + 1]
            row = run.neighbors[s:e][:cap]
            out.append(np.pad(row, (0, cap - len(row)), constant_values=v))
        return np.concatenate(out).astype(np.int32)

    deg = np.minimum(pair.run1.degrees, pair.run2.degrees)
    vids = np.argsort(-deg)[:top]
    return vertex_stream(pair.run1, vids), vertex_stream(pair.run2, vids)


def demo_table(num_vertices: int) -> np.ndarray:
    return np.random.default_rng(0).normal(size=(num_vertices, 128)).astype(np.float32)


def golden_demo() -> dict:
    """The gather demo's golden record, computed by the JAX package."""
    import jax.numpy as jnp

    from repro.graphs import make_dataset, make_evolving_pair
    from repro.kernels.amc_gather.ops import AMCGatherSession

    g = make_dataset("comdblp")
    pair = make_evolving_pair(g, seed=1)
    idx1, idx2 = demo_streams(pair)
    table = jnp.asarray(demo_table(g.num_vertices))
    sess = AMCGatherSession(interpret=True)
    sess.gather(table, jnp.asarray(idx1))
    sess.update()
    out2 = sess.gather(table, jnp.asarray(idx2))
    assert np.array_equal(np.asarray(out2), np.asarray(table[idx2]))
    return dict(
        dataset="comdblp",
        pair_seed=1,
        run1_edges=pair.run1.num_edges,
        run2_edges=pair.run2.num_edges,
        vertex_overlap=pair.vertex_overlap,
        stats=dict(sess.stats),
        stream_stability=float((idx1 == idx2).mean()),
        idx1_sha256=hashlib.sha256(idx1.tobytes()).hexdigest(),
        idx2_sha256=hashlib.sha256(idx2.tobytes()).hexdigest(),
    )


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_matches_golden_file(golden, cell):
    assert golden[cell] == golden_cell(*CELLS[cell])


def test_gather_demo_matches_golden_file(golden):
    assert golden[DEMO] == golden_demo()


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    out = {name: golden_cell(*args) for name, args in CELLS.items()}
    out[DEMO] = golden_demo()
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {GOLDEN}")
