"""The port's sharded trace store and streaming scorer
(``repro_torch.core.exec.sharded``) against the JAX package and the port's
own unsharded path, on the CPU.

``score_sharded`` must return the unsharded ``score_prefetcher`` rows and
the JAX package's ``score_sharded`` rows bit for bit, at shard sizes that
force many seams and at one shard, for bfs and pgd and under every cache
engine; its manifest must equal the JAX package's.

``tests/data/torch_port_golden_sharded.json`` holds the JAX package's
records of the sharded cells that ``chip_smoke.py`` phase 14 holds the
port to on the card:

- ``S-parity``: ``ShardedSpec(WorkloadSpec("bfs", "comdblp", seed=0),
  16384)``, ``amc`` and ``nextline2`` (the parity cell of
  ``BENCH_2026-08-07.5.json`` ``sharded``);
- ``S-full``: ``ShardedSpec(WorkloadSpec("bfs", "road-8m"), 1 << 22)``,
  the paper-scale road lattice (32,488,421 accesses in 8 shards);
- ``mixed``: bfs/comdblp#s0 and its ``ShardedSpec`` at 4096 accesses in
  one grid, ``nextline2`` and ``amc``.

Each holds the ``Experiment(...).run(workers=1).rows()`` and (the sharded
cells) the manifest with a sha256 of each shard's ``block`` column.
``S-parity`` is recomputed here through the port; the whole file is
written from the JAX package (about 3 minutes on a CPU, most of it
``S-full``) only by running this module, with the names of the cells to
rewrite or none for all of them::

    PYTHONPATH=src python tests/test_torch_sharded.py [S-parity S-full mixed]
"""
import dataclasses
import hashlib
import json
import os
import sys
import tempfile

import numpy as np
import pytest

pytest.importorskip("torch")

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_port_golden_sharded.json")
# cell name -> its Experiment: workloads ("kernel/dataset#sSEED", with
# "@N" for a ShardedSpec of N accesses a shard), hierarchy, prefetchers
CELLS = {
    "S-parity": dict(workloads=["bfs/comdblp#s0@16384"], hierarchy="SCALED",
                     prefetchers=["amc", "nextline2"]),
    "S-full": dict(workloads=["bfs/road-8m#s0@4194304"], hierarchy="SCALED",
                   prefetchers=["amc", "nextline2"]),
    "mixed": dict(workloads=["bfs/comdblp#s0", "bfs/comdblp#s0@4096"], hierarchy="SCALED",
                  prefetchers=["nextline2", "amc"]),
}
MANIFEST_KEYS = ("kernel", "dataset", "seed", "num_accesses", "shard_accesses",
                 "shard_sizes", "iter_epochs", "eval_from_pos", "num_vertices",
                 "num_edges", "base")


def parse_workload(name: str):
    """``"kernel/dataset#sSEED[@N]"`` -> (kernel, dataset, seed, N or None)."""
    name, _, shard = name.partition("@")
    kd, seed = name.split("#s")
    kernel, dataset = kd.split("/")
    return kernel, dataset, int(seed), int(shard) if shard else None


def jsonable(x):
    """Plain-JSON form of a row (numpy scalars and arrays unwrapped)."""
    return json.loads(json.dumps(x, default=lambda o: o.tolist()))


def manifest_record(cache, spec, manifest) -> dict:
    """The manifest's identity fields and a sha256 of each shard's blocks."""
    rec = {k: manifest[k] for k in MANIFEST_KEYS}
    rec["block_sha256"] = [
        hashlib.sha256(np.ascontiguousarray(cache.load_shard(spec, i)["block"]).tobytes())
        .hexdigest()
        for i in range(len(manifest["shard_sizes"]))
    ]
    return rec


def run_cell(pkg: str, cell: dict, device=None) -> dict:
    """One cell's record through ``pkg`` ("repro" or "repro_torch"), each
    from a fresh artifact root."""
    import importlib

    memsim = importlib.import_module(f"{pkg}.memsim")
    core = importlib.import_module(f"{pkg}.core")
    sharded = importlib.import_module(f"{pkg}.core.exec.sharded")
    hierarchy = getattr(memsim, cell["hierarchy"])
    specs = []
    for k, d, s, n in map(parse_workload, cell["workloads"]):
        base = core.WorkloadSpec(k, d, hierarchy=hierarchy, seed=s)
        specs.append(base if n is None else sharded.ShardedSpec(base, n))
    kw = {} if device is None else dict(device=device)
    with tempfile.TemporaryDirectory() as td:
        arts = core.ArtifactCache(td)
        res = core.Experiment(workloads=specs, prefetchers=cell["prefetchers"],
                              cache=core.WorkloadCache(artifacts=arts), **kw).run(workers=1)
        manifests = {
            name: manifest_record(arts, spec, arts.load_manifest(spec))
            for name, spec in zip(cell["workloads"], specs)
            if getattr(spec, "is_sharded", False)
        }
    return dict(cell, rows=jsonable(res.rows()), manifests=manifests)


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def tiny():
    """bfs and pgd on ``tiny``: the port's spec, trace and unsharded rows."""
    from repro_torch.core import WorkloadSpec, score_prefetcher
    from repro_torch.core.registry import resolve_prefetchers

    out = {}
    for kernel in ("bfs", "pgd"):
        base = WorkloadSpec(kernel, "tiny")
        trace = base.build(device="cpu")
        pairs = resolve_prefetchers(["nextline2", "amc"])
        out[kernel] = [score_prefetcher(trace, n, g).row() for n, g in pairs]
    return out


def _jax_sharded(kernel, shard_accesses, prefetchers, engine=None):
    """JAX's ``score_sharded`` rows and manifest for ``kernel``/tiny."""
    from repro.core import ArtifactCache, WorkloadSpec
    from repro.core.exec.sharded import ShardedSpec, ensure_shards, score_sharded
    from repro.core.registry import resolve_prefetchers
    from repro.memsim import use_engine

    spec = ShardedSpec(WorkloadSpec(kernel, "tiny"), shard_accesses)
    with use_engine(engine or "fused"), tempfile.TemporaryDirectory() as td:
        arts = ArtifactCache(td)
        scored = score_sharded(spec, resolve_prefetchers(prefetchers), arts)
        manifest = manifest_record(arts, spec, ensure_shards(spec, arts))
    return [m.row() for _, m in scored], manifest


def _port_sharded(kernel, shard_accesses, prefetchers, engine=None):
    from repro_torch.core import ArtifactCache, WorkloadSpec
    from repro_torch.core.exec.sharded import ShardedSpec, ensure_shards, score_sharded
    from repro_torch.core.registry import resolve_prefetchers
    from repro_torch.memsim import use_engine

    spec = ShardedSpec(WorkloadSpec(kernel, "tiny"), shard_accesses)
    with use_engine(engine or "fused"), tempfile.TemporaryDirectory() as td:
        arts = ArtifactCache(td)
        scored = score_sharded(spec, resolve_prefetchers(prefetchers), arts, device="cpu")
        assert [n for n, _ in scored] == prefetchers
        manifest = manifest_record(arts, spec, ensure_shards(spec, arts, "cpu"))
    return [m.row() for _, m in scored], manifest


@pytest.mark.parametrize("kernel", ["bfs", "pgd"])
@pytest.mark.parametrize("shard_accesses", [4096, 1 << 30])
def test_score_sharded_equals_unsharded_and_jax(tiny, kernel, shard_accesses):
    from repro_torch.core.exec.scheduler import rows_equal

    rows, manifest = _port_sharded(kernel, shard_accesses, ["nextline2", "amc"])
    jrows, jmanifest = _jax_sharded(kernel, shard_accesses, ["nextline2", "amc"])
    assert rows_equal(tiny[kernel], rows)
    assert rows_equal(jrows, rows)
    assert manifest == jmanifest
    assert (len(manifest["shard_sizes"]) > 1) == (shard_accesses == 4096)


@pytest.mark.parametrize("engine", ["fused", "reference", "set_parallel"])
def test_score_sharded_per_engine(tiny, engine):
    from repro_torch.core.exec.scheduler import rows_equal

    rows, _ = _port_sharded("bfs", 4096, ["nextline2"], engine)
    jrows, _ = _jax_sharded("bfs", 4096, ["nextline2"], engine)
    assert rows_equal(tiny["bfs"][:1], rows)
    assert rows_equal(jrows, rows)


def test_unsupported_prefetcher_raises(tmp_path):
    from repro_torch.core import ArtifactCache, WorkloadSpec
    from repro_torch.core.exec.sharded import ShardedScoringError, ShardedSpec, score_sharded
    from repro_torch.core.registry import resolve_prefetchers

    arts = ArtifactCache(tmp_path)
    spec = ShardedSpec(WorkloadSpec("bfs", "tiny"), 4096)
    for pf in (["rnr"], ["nextline2", "vldp"]):
        with pytest.raises(ShardedScoringError, match="streaming adapter"):
            score_sharded(spec, resolve_prefetchers(pf), arts, device="cpu")
    # refused before any work: no shard was built
    assert not arts.has(spec) and not list(tmp_path.iterdir())


def test_sharded_keys_move_with_shard_size(tmp_path):
    from repro_torch.core import ArtifactCache, WorkloadSpec
    from repro_torch.core.exec.sharded import ShardedSpec

    arts = ArtifactCache(tmp_path)
    base = WorkloadSpec("bfs", "tiny")
    a = ShardedSpec(base=base, shard_accesses=4096)
    b = ShardedSpec(base=base, shard_accesses=8192)
    c = dataclasses.replace(a)
    assert arts.path_for(a) != arts.path_for(b)
    assert arts.path_for(a) == arts.path_for(c) == arts.manifest_path(a)
    assert arts.shard_path(a, 0) != arts.shard_path(b, 0)
    assert arts.shard_path(a, 0) != arts.shard_path(a, 1)
    assert not arts.has(a)
    with pytest.raises(ValueError):
        ShardedSpec(base, 0)


def test_jax_built_shard_store_reads_as_a_miss(tmp_path):
    """A shard store the JAX package built under the same root is never
    read: the port's keys carry its marker, so it builds its own."""
    from repro.core import ArtifactCache as JCache, WorkloadSpec as JSpec
    from repro.core.exec.sharded import ShardedSpec as JSharded, ensure_shards as jensure
    from repro_torch.core import ArtifactCache, WorkloadSpec
    from repro_torch.core.exec.sharded import ShardedSpec, ensure_shards

    jspec = JSharded(JSpec("bfs", "tiny"), 4096)
    jensure(jspec, JCache(tmp_path))
    jfiles = sorted(p.name for p in tmp_path.iterdir())
    arts = ArtifactCache(tmp_path)
    spec = ShardedSpec(WorkloadSpec("bfs", "tiny"), 4096)
    assert not arts.has(spec) and arts.load_manifest(spec) is None
    assert arts.manifest_path(spec).name not in jfiles
    assert all(arts.shard_path(spec, i).name not in jfiles for i in range(8))
    saves = arts.saves
    manifest = ensure_shards(spec, arts, "cpu")
    assert arts.saves - saves == len(manifest["shard_sizes"]) > 1
    assert arts.has(spec)


def test_s_parity_equals_the_golden_file(golden):
    got = run_cell("repro_torch", CELLS["S-parity"], device="cpu")
    want = golden["S-parity"]
    assert got["manifests"] == want["manifests"]
    assert got["rows"] == want["rows"]
    # and the port's unsharded rows of the base spec
    plain = run_cell("repro_torch", dict(CELLS["S-parity"], workloads=["bfs/comdblp#s0"]),
                     device="cpu")
    assert plain["rows"] == got["rows"]


def test_golden_file_holds_every_cell(golden):
    assert sorted(golden) == sorted(CELLS)
    for name, cell in CELLS.items():
        rec = golden[name]
        assert {k: rec[k] for k in cell} == cell
        assert len(rec["rows"]) == len(cell["workloads"]) * len(cell["prefetchers"])
    full = golden["S-full"]["manifests"]["bfs/road-8m#s0@4194304"]
    assert full["num_accesses"] == 32_488_421 and len(full["shard_sizes"]) == 8
    mixed = golden["mixed"]["rows"]
    assert mixed[:2] == mixed[2:]  # the sharded rows equal their unsharded twins


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    names = sys.argv[1:] or list(CELLS)
    out = {}
    if os.path.exists(GOLDEN):
        with open(GOLDEN) as f:
            out = json.load(f)
    for name in names:
        out[name] = run_cell("repro", CELLS[name])
        print(f"{name}: {len(out[name]['rows'])} rows", flush=True)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {GOLDEN}")
