#!/usr/bin/env python3
"""Run the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Build every CUDA kernel of the main path from ``src/repro_torch`` (one
   ``nvcc`` per source, all at once) and print the ``ptxas`` register and
   spill lines.
2. Hold each kernel against its plain PyTorch version on the card, bit for
   bit, on randomized families (K1 ``lru_hits``, K2 ``fused_levels``) and
   against ``index_add_`` on the CPU (the ordered segment sum).
3. Main path A: ``build_workload("pgd", "comdblp")`` under ``SCALED`` on
   the card, then ``score_prefetchers_batched`` with ``amc`` and ``vldp``.
4. Main path B: the same for pgd/google under ``PAPER`` (the paper's Table
   VI hierarchy; 20.6 M accesses).  Both phases must reproduce the JAX
   package's golden rows (``tests/data/torch_port_golden.json``) exactly.
5. K2 on the first 2,000,000 accesses of B's demand stream, cold and
   resumed at access 1,000,000, against its plain version.
6. At B's shapes (its whole demand stream for K2, its next-line L2 pass
   for K1, its push edge order for the segment sum), hold each kernel
   against its plain version once more, bit for bit, and time it with CUDA
   events beside its plain version, the card's bound and (where one
   exists) a PyTorch library call.

Kernel launch counters are set to 0 just before phases 3-4 and read just
after.  Prints the card's name and power limit first, a ``{"kernels": ...}``
line, and as the last line ``{"ok": true, "device": {...}}``.  Exits
non-zero without printing a result when no CUDA device is available or the
repository's sources are missing.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.json"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM CUDA-core float32 peak (NVIDIA data sheet)
PREFETCHERS = ["amc", "vldp"]


def log(*args):
    print(*args, flush=True)


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str):
    if not cond:
        raise SmokeError(what)


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cuda_ms(fn, dev, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` from CUDA events, after one
    warm-up call."""
    import torch

    fn()
    sync(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, dev):
    """Milliseconds of one call on the host clock, synchronized, and the
    call's result."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3, out


# ------------------------------------------------------------ inputs


def k1_inputs(streams, sets, ways, dev, states=None):
    """Ragged K1 inputs of a family of streams (cold unless ``states``)."""
    import numpy as np
    import torch

    from repro_torch.memsim import engine

    grouped = [engine.group_by_set(s, sets) for s in streams]
    blocks = np.concatenate([g[0] for g in grouped]) if grouped else np.zeros(0, np.int32)
    offsets = engine.ragged_offsets([g[2] for g in grouped])
    if states is None:
        states = [engine.init_state(sets, ways, dev)] * len(streams)
    tags = torch.cat([s.tags for s in states]).contiguous()
    age = torch.cat([s.age for s in states]).contiguous()
    return (torch.from_numpy(blocks).to(dev), torch.from_numpy(offsets).to(dev), tags, age)


def k2_inputs(streams, levels, dev, states=None):
    """Ragged K2 inputs (group-sorted, run-collapsed) of a family."""
    import numpy as np
    import torch

    from repro_torch.memsim import engine, fused

    groups = fused.fused_group_count(levels)
    grouped = [fused._group_collapse(s, groups) for s in streams]
    blocks = np.concatenate([g[0] for g in grouped])
    offsets = engine.ragged_offsets([g[3] for g in grouped])
    if states is None:
        states = [[engine.init_state(s, w, dev) for s, w in levels]] * len(streams)
    tags = [
        torch.cat([fused.state_to_groups(st[i].tags, groups) for st in states]).contiguous()
        for i in range(len(levels))
    ]
    age = [
        torch.cat([fused.state_to_groups(st[i].age, groups) for st in states]).contiguous()
        for i in range(len(levels))
    ]
    return torch.from_numpy(blocks).to(dev), torch.from_numpy(offsets).to(dev), tags, age


def max_err(got, ref) -> float:
    """Max abs difference over matching tensors (lists flattened)."""
    import torch

    got = [g for x in got for g in (x if isinstance(x, list) else [x])]
    ref = [r for x in ref for r in (x if isinstance(x, list) else [x])]
    err = 0.0
    for g, r in zip(got, ref):
        check(g.shape == r.shape and g.dtype == r.dtype, f"shape/dtype {g.shape} {r.shape}")
        if g.numel():
            err = max(err, float((g.to(torch.float64) - r.to(torch.float64)).abs().max()))
    return err


# ------------------------------------------------------------ phase 2


def k1_families(dev):
    """K1 against its plain version on the card; returns max abs error."""
    import numpy as np

    from repro_torch.kernels.cache_sim.ops import lru_hits, lru_hits_plain
    from repro_torch.memsim import engine

    rng = np.random.default_rng(0)
    cases = [
        ("ways=1", [rng.integers(0, 300, 3000)], 64, 1),
        ("single set", [rng.integers(0, 40, 3000)], 1, 8),
        ("repeated blocks", [np.repeat(rng.integers(0, 500, 1500), rng.integers(1, 5, 1500))], 16, 8),
        ("empty", [np.zeros(0, np.int64)], 64, 8),
        ("skewed", [rng.integers(0, 60, 2000) * 8192], 8192, 16),
        ("stream axis of 3", [rng.integers(0, 5000, n) for n in (100, 4000, 2500)], 512, 8),
        ("SCALED LLC", [rng.integers(0, 20000, 20000)], 256, 16),
        ("PAPER LLC", [rng.integers(0, 200000, 60000)], 8192, 16),
    ]
    err = 0.0
    for name, streams, sets, ways in cases:
        args = k1_inputs(streams, sets, ways, dev)
        e = max_err(lru_hits(*args), lru_hits_plain(*args))
        check(e == 0, f"K1 {name}: kernel != plain (max err {e})")
        err = max(err, e)
    # carried-state resume: the second half resumes from the first half's
    # canonical state, on both versions.
    blocks = rng.integers(0, 3000, 8000)
    h = len(blocks) // 2
    first = k1_inputs([blocks[:h]], 64, 8, dev)
    _, t1, a1 = lru_hits(*first)
    st = engine.canonicalize_state(t1, a1)
    second = k1_inputs([blocks[h:]], 64, 8, dev, states=[st])
    e = max_err(lru_hits(*second), lru_hits_plain(*second))
    check(e == 0, f"K1 resume: kernel != plain (max err {e})")
    log(f"  K1 lru_hits == plain on {len(cases) + 1} families")
    return max(err, e)


def k2_families(dev):
    import numpy as np

    from repro_torch.kernels.cache_sim.ops import fused_levels, fused_levels_plain
    from repro_torch.memsim import PAPER, SCALED
    from repro_torch.memsim.hierarchy import _demand_levels

    rng = np.random.default_rng(1)
    err, n = 0.0, 0
    for cfg in (SCALED, PAPER):
        levels = _demand_levels(cfg)
        span = 40 * cfg.llc.sets
        cases = [
            ("random", [rng.integers(0, span, 30000)]),
            ("repeated blocks", [np.repeat(rng.integers(0, span, 8000), rng.integers(1, 5, 8000))]),
            ("empty member", [np.zeros(0, np.int64), rng.integers(0, span, 500)]),
            ("skewed", [rng.integers(0, 64, 3000) * cfg.llc.sets]),
            ("stream axis of 3", [rng.integers(0, span, k) for k in (900, 20000, 7000)]),
        ]
        for name, streams in cases:
            args = k2_inputs(streams, levels, dev)
            e = max_err(fused_levels(*args[:2], levels, *args[2:]),
                        fused_levels_plain(*args[:2], levels, *args[2:]))
            check(e == 0, f"K2 {cfg.name} {name}: kernel != plain (max err {e})")
            err, n = max(err, e), n + 1
        blocks = rng.integers(0, span, 20000)
        e = k2_resume(blocks, len(blocks) // 2, levels, dev)
        err, n = max(err, e), n + 1
    log(f"  K2 fused_levels == plain on {n} families (SCALED, PAPER)")
    return err


def k2_resume(blocks, seam, levels, dev) -> float:
    """K2 cold over ``blocks`` and resumed at ``seam`` from the carry, each
    against its plain version.  Returns the max abs error."""
    from repro_torch.kernels.cache_sim.ops import fused_levels, fused_levels_plain
    from repro_torch.memsim import engine, fused

    groups = fused.fused_group_count(levels)
    cold = k2_inputs([blocks], levels, dev)
    e = max_err(fused_levels(*cold[:2], levels, *cold[2:]),
                fused_levels_plain(*cold[:2], levels, *cold[2:]))
    check(e == 0, f"K2 cold {len(blocks)}: kernel != plain (max err {e})")
    first = k2_inputs([blocks[:seam]], levels, dev)
    _, t1, a1 = fused_levels(*first[:2], levels, *first[2:])
    states = [
        engine.canonicalize_state(
            fused.state_from_groups(t, s, w), fused.state_from_groups(a, s, w)
        )
        for t, a, (s, w) in zip(t1, a1, levels)
    ]
    second = k2_inputs([blocks[seam:]], levels, dev, states=[states])
    e2 = max_err(fused_levels(*second[:2], levels, *second[2:]),
                 fused_levels_plain(*second[:2], levels, *second[2:]))
    check(e2 == 0, f"K2 resumed at {seam}: kernel != plain (max err {e2})")
    return max(e, e2)


def segment_sum_check(dev):
    """The ordered segment sum on the card == index_add_ on the CPU, bit for
    bit, on the google graph's push and pull edge orders."""
    import numpy as np
    import torch

    from repro_torch.graphs import make_dataset
    from repro_torch.kernels.segment_sum.segment_sum import (
        segment_plan, segment_sum, segment_sum_plain,
    )

    g = make_dataset("google")
    rng = np.random.default_rng(2)
    err = 0.0
    for dst in (g.neighbors, g.transpose().edge_sources()):
        vals = rng.random(len(dst), dtype=np.float32) / 1000
        vals[rng.random(len(dst)) < 0.5] = 0.0
        plan = segment_plan(dst, g.num_vertices, dev)
        got = segment_sum(torch.from_numpy(vals).to(dev), plan).cpu()
        ref = segment_sum_plain(torch.from_numpy(vals), torch.from_numpy(dst.astype(np.int64)),
                                g.num_vertices)
        check(torch.equal(got, ref), "segment_sum: kernel != index_add_ on the CPU")
        err = max(err, float((got - ref).abs().max()))
    log("  segment_sum == index_add_ (CPU) bit for bit on google push and pull")
    return err


# ------------------------------------------------------------ phases 3-4


def demand_levels(profile):
    import numpy as np

    lvl = np.full(len(profile.blocks), 3, dtype=np.int8)
    lvl[profile.l1_hit] = 0
    lvl[profile.l2_pos[profile.l2_hit]] = 1
    lvl[profile.l2_miss_pos[profile.llc_hit]] = 2
    return lvl


def jsonable(x):
    return json.loads(json.dumps(x, default=lambda o: o.tolist()))


def main_path(cell: str, golden: dict, dev):
    """Build + score one golden cell on ``dev``; check against the golden
    record.  Returns (workload, stage seconds)."""
    import numpy as np

    from repro_torch import memsim
    from repro_torch.core import build_workload, resolve_prefetchers, score_prefetchers_batched

    gold = golden[cell]
    t0 = time.perf_counter()
    wl = build_workload(gold["kernel"], gold["dataset"],
                        hierarchy=getattr(memsim, gold["hierarchy"]), device=dev)
    sync(dev)
    t1 = time.perf_counter()
    rows = score_prefetchers_batched(wl, resolve_prefetchers(PREFETCHERS))
    sync(dev)
    t2 = time.perf_counter()
    stages = dict(wl.stage_seconds, score=t2 - t1, total=t2 - t0)
    check(wl.device.type == dev.type, f"{cell}: workload on {wl.device}, expected {dev}")
    got = dict(
        iterations=len(wl.iter_epochs),
        accesses=wl.num_accesses,
        l2_accesses=len(wl.profile.l2_pos),
        levels_sha256=hashlib.sha256(demand_levels(wl.profile).tobytes()).hexdigest(),
    )
    for k, v in got.items():
        check(v == gold[k], f"{cell}: {k} {v} != golden {gold[k]}")
    for m in rows:
        row = jsonable(m.row())
        check(all(np.isfinite(v) for v in row.values() if isinstance(v, float)),
              f"{cell}: non-finite metric in {m.name}")
        if row != gold["rows"][m.name]:
            diff = {k: (row.get(k), gold["rows"][m.name].get(k))
                    for k in gold["rows"][m.name] if row.get(k) != gold["rows"][m.name].get(k)}
            raise SmokeError(f"{cell}: {m.name} row differs from golden: {diff}")
    log(f"  {cell}: {got['iterations']} iterations, {got['accesses']} accesses, "
        f"rows == golden ({', '.join(PREFETCHERS)})")
    log("  stage seconds " + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    return wl, stages


# ------------------------------------------------------------ phase 6


def bound(bytes_moved: float, ops: float):
    tb, to = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_kernels(wl, dev, errs, launches):
    """Per-kernel timing at main path B's shapes."""
    import torch

    from repro_torch.kernels.cache_sim.ops import (
        fused_levels, fused_levels_plain, lru_hits, lru_hits_plain,
    )
    from repro_torch.graphs import make_dataset
    from repro_torch.kernels.segment_sum.segment_sum import (
        segment_plan, segment_sum, segment_sum_plain,
    )
    from repro_torch.memsim.hierarchy import _demand_levels, _merge_prefetch_stream

    cfg = wl.profile.cfg
    out = []

    # K2: B's whole demand stream (one launch of the main path).
    levels = _demand_levels(cfg)
    a2 = k2_inputs([wl.block], levels, dev)
    n2, rows2 = a2[0].numel(), a2[1].numel() - 1
    state_b = sum(t.numel() for t in a2[2]) * 4 * 2 * 2
    ms2 = cuda_ms(lambda: fused_levels(*a2[:2], levels, *a2[2:]), dev, reps=3)
    plain2, ref2 = host_ms(lambda: fused_levels_plain(*a2[:2], levels, *a2[2:]), dev)
    got2 = fused_levels(*a2[:2], levels, *a2[2:])
    e2 = max_err(got2, ref2)
    check(e2 == 0, f"K2 at main path B's shape: kernel != plain (max err {e2})")
    errs["fused_levels"] = max(errs["fused_levels"], e2)
    # operations this run's data needs: a compare and a select per lane of
    # every level an access reaches (it reaches level i unless it hit above)
    ops2 = sum(2 * w * int((got2[0] >= i).sum()) for i, (_, w) in enumerate(levels))
    b2, by2 = bound(n2 * 5 + (rows2 + 1) * 8 + state_b, ops2)
    out.append(dict(
        name="fused_levels", route="cuda",
        source="src/repro_torch/kernels/cache_sim/csrc/fused_levels.cu",
        replaces="src/repro/kernels/cache_sim/fused_sim.py:77",
        launches=launches["fused_levels"], max_abs_err=errs["fused_levels"],
        matches_plain=errs["fused_levels"] == 0,
        ms=ms2, plain_ms=plain2, bound_ms=b2, bound_by=by2, library_ms=None,
        shape=f"{n2} kept accesses, {rows2} groups, levels {list(levels)}",
    ))
    log(f"  fused_levels: {ms2:.3f} ms (plain {plain2:.1f} ms, bound {b2:.4f} ms)")

    # K1: the next-line L2 pass of B's build (the largest K1 launch there).
    prof = wl.profile
    merged = _merge_prefetch_stream(prof, wl.nl_blocks, wl.nl_pos, None)["mblocks_s"]
    a1 = k1_inputs([merged], cfg.l2.sets, cfg.l2.ways, dev)
    n1, rows1 = a1[0].numel(), a1[1].numel() - 1
    ms1 = cuda_ms(lambda: lru_hits(*a1), dev, reps=5)
    plain1, ref1 = host_ms(lambda: lru_hits_plain(*a1), dev)
    e1 = max_err(lru_hits(*a1), ref1)
    check(e1 == 0, f"K1 at main path B's shape: kernel != plain (max err {e1})")
    errs["lru_hits"] = max(errs["lru_hits"], e1)
    b1, by1 = bound(n1 * 5 + (rows1 + 1) * 8 + a1[2].numel() * 4 * 4,
                    n1 * 2 * cfg.l2.ways)
    out.append(dict(
        name="lru_hits", route="cuda",
        source="src/repro_torch/kernels/cache_sim/csrc/lru_hits.cu",
        replaces="src/repro/kernels/cache_sim/cache_sim.py:126",
        launches=launches["lru_hits"], max_abs_err=errs["lru_hits"],
        matches_plain=errs["lru_hits"] == 0,
        ms=ms1, plain_ms=plain1, bound_ms=b1, bound_by=by1, library_ms=None,
        shape=f"{n1} accesses, {rows1} sets x {cfg.l2.ways} ways",
    ))
    log(f"  lru_hits: {ms1:.3f} ms (plain {plain1:.1f} ms, bound {b1:.4f} ms)")

    # Ordered segment sum: B's push edge order.
    graph = make_dataset(wl.dataset)
    plan = segment_plan(graph.neighbors, graph.num_vertices, dev)
    vals = torch.rand(graph.num_edges, generator=torch.Generator().manual_seed(3)).to(dev)
    ms3 = cuda_ms(lambda: segment_sum(vals, plan), dev, reps=20)
    plain3 = cuda_ms(lambda: segment_sum_plain(vals, plan.ids, plan.num_segments), dev, reps=20)
    # held against the plain version on the CPU, where index_add_ adds in
    # edge order (on the card it adds with atomics)
    ref3 = segment_sum_plain(vals.cpu(), plan.ids.cpu(), plan.num_segments)
    e3 = max_err([segment_sum(vals, plan).cpu()], [ref3])
    check(e3 == 0, f"segment_sum at main path B's shape: kernel != index_add_ (max err {e3})")
    errs["segment_sum"] = max(errs["segment_sum"], e3)
    e = graph.num_edges
    b3, by3 = bound(e * 8 + (graph.num_vertices + 1) * 8 + graph.num_vertices * 4, e)
    out.append(dict(
        name="segment_sum", route="cuda",
        source="src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu",
        replaces="src/repro/apps/pagerank_delta.py:59 (jax.ops.segment_sum; not a Pallas kernel)",
        launches=launches["segment_sum"], max_abs_err=errs["segment_sum"],
        matches_plain=errs["segment_sum"] == 0,
        ms=ms3, plain_ms=plain3, bound_ms=b3, bound_by=by3, library_ms=plain3,
        shape=f"{e} edges into {graph.num_vertices} segments",
    ))
    log(f"  segment_sum: {ms3:.4f} ms (index_add_ {plain3:.4f} ms, bound {b3:.5f} ms)")
    return out


# ------------------------------------------------------------ main


def gpu_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "nvidia-smi unavailable"


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.exists():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch and tests/data are missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.cache_sim.ops import SOURCES, fused_levels, lru_hits
    from repro_torch.kernels.segment_sum import segment_sum as seg_mod

    dev = torch.device("cuda", 0)
    log(gpu_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    golden = json.loads(GOLDEN.read_text())
    t_start = time.perf_counter()

    log("phase 1: build")
    sources = list(SOURCES) + [seg_mod.SOURCE]
    t0 = time.perf_counter()
    secs = build.build(sources)
    log(f"  built {len(secs)} libraries in {time.perf_counter() - t0:.1f} s "
        + json.dumps({k: round(v, 1) for k, v in secs.items()}))
    for src in sources:
        for line in build.ptxas_report(src):
            log(f"  [{src.name}] {line}")

    log("phase 2: kernels vs plain on the card")
    errs = dict(lru_hits=k1_families(dev), fused_levels=k2_families(dev),
                segment_sum=segment_sum_check(dev))
    sync(dev)

    counters = (lru_hits, fused_levels, seg_mod.segment_sum)
    for c in counters:
        c.launches = 0
    log("phase 3: main path A (pgd/comdblp, SCALED)")
    main_path("pgd/comdblp/SCALED", golden, dev)
    log("phase 4: main path B (pgd/google, PAPER)")
    wl_b, _ = main_path("pgd/google/PAPER", golden, dev)
    launches = {c.__name__: c.launches for c in counters}
    log("  launches on the main path " + json.dumps(launches))
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    log("phase 5: K2 on B's first 2,000,000 accesses, cold and resumed at 1,000,000")
    from repro_torch.memsim.hierarchy import _demand_levels

    e = k2_resume(wl_b.block[:2_000_000], 1_000_000, _demand_levels(wl_b.profile.cfg), dev)
    errs["fused_levels"] = max(errs["fused_levels"], e)
    log("  K2 == plain, cold and resumed")

    log("phase 6: kernel times at main path B's shapes")
    kernels = time_kernels(wl_b, dev, errs, launches)
    log(f"total seconds {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        sys.exit(1)
