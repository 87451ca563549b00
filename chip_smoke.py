#!/usr/bin/env python3
"""Run the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; each prints its seconds):

1. Build every CUDA kernel from ``src/repro_torch`` (one ``nvcc`` per
   source, all at once) and print the ``ptxas`` register and spill lines;
   K5's two tensor-core kernels (bfloat16 and float32) at hd 64 must not
   spill.
2. Hold each kernel against its plain PyTorch version on the card, bit for
   bit, on randomized families (K1 ``lru_hits``, K2 ``fused_levels``, K3a /
   K3b ``basedelta_*_tiles``, K4a ``amc_gather``) and against the plain
   version on the CPU where the card's ``index_add_`` adds in another order
   (the ordered segment sum, whose families are those of
   ``tests/test_torch_segment_sum.py``: no edges, a segment of 5,000 edges,
   lengths around its chunk of 32 and its ring of 256, skewed unsorted ids,
   magnitudes where order matters, signed zeros, subnormals, infinities and
   NaN, and google's push and pull orders; K4b ``amc_gather_segment_sum``,
   whose families include path E's skew, rows of several vectors a lane, a
   misaligned table and out-of-range indices); K5 and K6 within stated
   tolerances (K5's families include cancelling pairs on both routes, where
   one bfloat16 rounding of P, or two bfloat16 parts of a float32 operand,
   would show; K6's bfloat16 families include them, where one bfloat16
   rounding of its G, w B or S would show; K6 runs both
   of its routes, bfloat16 and float32, and checks that both ran).  K2 runs both of its routes (a
   row's state in shared memory, and in global memory where it is over the
   shared-memory budget) and levels whose ways sum to more than 32; K3b
   both of its routes (16-byte units; single elements for other widths and
   a misaligned view).  Each log line names the route that ran.
3. Main path A: ``build_workload("pgd", "comdblp")`` under ``SCALED`` on
   the card, then ``score_prefetchers_batched`` with ``amc`` and ``vldp``.
4. Main path B: the same for pgd/google under ``PAPER`` (the paper's Table
   VI hierarchy; 20.6 M accesses).  Both phases must reproduce the JAX
   package's golden rows (``tests/data/torch_port_golden.json``) exactly.
5. K2 on the first 1,000,000 accesses of B's demand stream, cold and
   resumed at access 500,000, against its plain version.
6. At B's shapes (its whole demand stream for K2, the largest of its K1
   launches for K1, its push edge order for the segment sum), hold each
   kernel against its plain version once more, bit for bit, and time it
   with CUDA events beside its plain version, the card's bound and (where
   one exists) a PyTorch library call (K1 and K2 also with their longest
   row and the nanoseconds a step of it; the segment sum's bound with the
   chain of its longest segment's adds, and ``torch.segment_reduce`` timed
   as a yardstick); then time each of B's K1 launches, with its longest row
   and nanoseconds a step.
7. Main paths C (bfs/notredame, ``SCALED``) and D (bfs/google, ``PAPER``)
   and bfs_do/notredame: the §VI two-run protocol, scored on run 2, must
   reproduce ``tests/data/torch_port_golden_evolving.json`` exactly; then
   D once more under ``torch.profiler`` for the device's busy share.
8. The AMC gather demo of ``examples/evolving_graph_analytics.py``: run 1's
   recorded index stream drives run 2's gather through
   ``AMCGatherSession`` (K4a); stats, streams and output against the
   golden file and ``table[idx2]``.
9. ``compress_entries`` / ``roundtrip`` (K3a, K3b) on every AMC entry
   table recorded over path D: modes equal ``select_modes``', misses come
   back.
10. Main path E: ``amc_gather_segment_sum`` (K4b) of a (110,000 x 128)
    float32 vertex table along run 2 of D; then K3 and K4 timed at these
    shapes as phase 6 times the others (K4b beside ``embedding_bag`` in the
    same call).
11. The reduced zamba2 (4 layers, and 5 so the tail runs) in float32 with
    parameters from ``convert.random_lm_tree``: ``prefill_step`` and 8
    ``serve_step``s against ``tests/data/torch_port_golden_lm.json``
    (written from the JAX package).
12. Main path F: zamba2-1.2b at full width (38 layers, d 2048, bfloat16,
    parameters from ``init_params`` with a seed):
    ``prefill_step`` on 4 prompts x 4,096 tokens (6 K5 and 38 K6 launches,
    finite logits), timed by host clock and CUDA events and once more under
    ``torch.profiler``; the serve loop answering 4 requests of 512-token
    prompts with 32 tokens, and one decode step under ``torch.profiler``;
    a float32 cross-check of the prefill's caches and logits against the
    same 512 tokens decoded one by one, beside the same prefill through the
    plain versions of K5 and K6 (``repro_torch.launch.drift``); then K5 and
    K6 timed at the prefill's shapes beside their plain versions, their
    bounds and (K5) ``scaled_dot_product_attention`` with K5's TFLOP/s, and
    K5's float32 (tensor-core) route at the cross-check's shape beside SDPA
    in float32, with its two bounds.
    K5 and K6 are also held against their plain versions in phase 2.
13. ``repro_torch.core.Experiment`` on the card against the JAX package's
    rows (``tests/data/torch_port_golden_grid.json``), every row and each
    workload's iterations, accesses, ``eval_from_pos`` and hit-level sha256
    exactly: G, the BENCH v9 grid (pgd, cc, bfs#s0-s2, bellmanford#s0-s2
    and bfs_do#s0 on comdblp with ``amc`` and ``rnr``, 18 rows); G-fused
    (pgd/comdblp with ``amc``, ``vldp``, ``rnr``) under
    ``REPRO_TORCH_CACHE_ENGINE=fused`` and ``set_parallel``; G-quick (the
    quickstart's cell); G-tableI (every registered prefetcher on
    pgd/comdblp); H (bellmanford/google under ``PAPER``, the §VI pair,
    scored on run 2); then G again through a ``WorkloadCache`` on the
    ``ArtifactCache`` its first run filled, which must load all 9 workloads
    and build none.  Each cell prints its stage seconds
    (``collect_stages``), ``score``'s parts from its spans and the artifact
    spans; G cold and warm give the scheduler's per-access costs.
14. Sharded and parallel (``tests/data/torch_port_golden_sharded.json``,
    written from the JAX package), each from a fresh artifact root:
    S-parity, ``ShardedSpec(bfs/comdblp#s0, 16384)`` with ``amc`` and
    ``nextline2`` under ``fused`` and ``set_parallel``, rows and manifest
    (shard sizes, ``eval_from_pos``, epochs, a sha256 of each shard's
    blocks) equal to the golden file and to the unsharded rows; S-full,
    ``ShardedSpec(bfs/road-8m, 1 << 22)`` (32,488,421 accesses in 8
    shards, scored cold), the same checks, its build, phase 1 and replay
    seconds, peak RSS and the card's peak allocation; P, the scheduler on
    the card: G under ``run(workers=2)`` from a cold store (no launch in
    this process, 9 builds in 2 workers, the workers' spans gathered) and
    ``run(workers=None)`` warm (its ``sched`` printed), both equal to the
    golden rows, and the mixed grid (bfs/comdblp#s0 beside its
    ``ShardedSpec`` at 4096) under 2 and 1 workers; then the seconds to
    start a pool of 1 and 2 workers (import, CUDA context, kernels) and
    the card's memory a context takes.  Prints the cost model's constants
    from this run.
15. The stream and serve protocols through ``repro_torch.core.Experiment``,
    each cell from a fresh artifact root: ST-drift (``StreamSpec`` of
    pgd/comdblp, ``SlidingWindow()``, 6 epochs, ``persist`` and ``reset``,
    ``amc``, ``vldp``, ``nextline2``), serially and under ``workers=2``,
    whose merged drift document (as ``examples/streaming_drift.py
    --verify-parallel`` writes it) must equal
    ``results/drift_pgd_comdblp_sliding_window.json``; SV-contention
    (``ServeSpec`` of pgd#s0, cc#s0, pgd#s1 on comdblp, both table modes,
    the same prefetchers), serially and under ``workers=2``, whose
    contention document must equal ``results/contention_comdblp_k3.json``;
    ST-full (bfs/google, ``PAPER``, 4 epochs), SV-full (bfs#s0-s2 on
    google, ``PAPER``), ST-models (every churn model and lifecycle) and
    SV-rate (the ``rate`` policy), whose rows and ``trace_reuse`` must
    equal ``tests/data/torch_port_golden_stream_serve.json`` (written from
    the JAX package); and the zero-churn stream's ``trace_reuse``, 2 cold
    and 3 warm.  Each cell prints its seconds, its stream and serve stages
    (``update_apply``, ``trace_epoch``, ``table_carry``,
    ``serve_interleave``, ``serve_llc``, ``serve_score``), the K1 launches
    inside the shared-LLC pass and the card's peak allocation.

Every launch counter is set to 0 just before each path (A, B, C, D,
bfs_do, the gather demo, K3 on D's entries, E, the reduced LMs, F's
prefill, serve loop and float32 cross-check, each cell of phase 13 and
each run of phases 14 and 15) and read just after; each
kernel must have launched on the paths that run it, and the ``launches``
of the kernels line are the sums over those paths.  Prints the card's
name and power limit first, a ``{"kernels": ...}`` line, and as the last
line ``{"ok": true, "device": {...}}``.  Exits non-zero without printing a
result when no CUDA device is available or the repository's sources are
missing.
"""
from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.json"
GOLDEN_EVOLVING = ROOT / "tests" / "data" / "torch_port_golden_evolving.json"
GOLDEN_LM = ROOT / "tests" / "data" / "torch_port_golden_lm.json"
GOLDEN_GRID = ROOT / "tests" / "data" / "torch_port_golden_grid.json"
GOLDEN_SHARDED = ROOT / "tests" / "data" / "torch_port_golden_sharded.json"
GOLDEN_STREAM_SERVE = ROOT / "tests" / "data" / "torch_port_golden_stream_serve.json"
RESULTS = (ROOT / "results" / "drift_pgd_comdblp_sliding_window.json",
           ROOT / "results" / "contention_comdblp_k3.json")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM CUDA-core float32 peak (NVIDIA data sheet)
FADD_CYCLES = 4  # latency of a dependent float32 add on an SM (Hopper)
H100_SM_MHZ = 1980  # H100 SXM's top SM clock, where nvidia-smi does not say
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


def enqueue_us(fn, dev) -> float:
    """Host microseconds to issue one call of ``fn`` (no synchronize inside
    the clock: for an asynchronous launch, the wrapper's own cost)."""
    sync(dev)
    t0 = time.perf_counter()
    fn()
    us = (time.perf_counter() - t0) * 1e6
    sync(dev)
    return us


def cuda_ms(fn, dev, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` from CUDA events, after
    one warm-up call.  The device first spins for twice the time the host
    needs to issue the ``reps`` calls (at most 0.5 s), so the calls run back
    to back and the events time the device, not the host's launch rate."""
    import torch

    fn()
    host_s = enqueue_us(fn, dev) * 1e-6
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * reps * host_s, 0.5) * 2e9))  # cycles, ~2 GHz
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
    err = max(err, e)
    # ragged rows of every length around the kernel's 4-access hit words
    # and 4 G-access batches (so rows start at every offset within a batch,
    # and some run many batches), a tenth of the accesses pads (-1), from a
    # random carry, at ways 3, 8 and 32 (lane groups of 4, 8 and 32); and a
    # view of the blocks 4 bytes off 16-byte alignment (the wrapper copies
    # it)
    import torch

    lengths = np.array([0, 1, 15, 16, 17, 63, 64, 65, 200, 5000, 0, 3, 129, 40, 1, 0, 77] * 8)
    for ways in (3, 8, 32):
        blocks = rng.integers(0, 8 * ways + 3, int(lengths.sum())).astype(np.int32)
        blocks[rng.random(blocks.shape[0]) < 0.1] = -1
        offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)])).to(dev)
        st = engine.canonicalize_state(
            torch.from_numpy(rng.integers(-1, 30, (len(lengths), ways)).astype(np.int32)),
            torch.from_numpy(rng.permuted(np.tile(np.arange(1, ways + 1), (len(lengths), 1)),
                                          axis=1).astype(np.int32)))
        args = (torch.from_numpy(blocks).to(dev), offsets, st.tags.to(dev), st.age.to(dev))
        e = max_err(lru_hits(*args), lru_hits_plain(*args))
        check(e == 0, f"K1 batches and pads, ways {ways}: kernel != plain (max err {e})")
        off = torch.empty(blocks.shape[0] + 1, dtype=torch.int32, device=dev)[1:]
        off.copy_(args[0])
        check(off.data_ptr() % 16 != 0, "K1 misaligned family: view is aligned")
        e = max_err(lru_hits(off, *args[1:]), lru_hits_plain(*args))
        check(e == 0, f"K1 misaligned blocks, ways {ways}: kernel != plain (max err {e})")
    log(f"  K1 lru_hits == plain on {len(cases) + 7} families (batches and pads at ways 3, 8 "
        f"and 32, each also from a misaligned view)")
    return err


def k2_families(dev):
    import numpy as np

    from repro_torch.kernels.cache_sim.fused_sim import fused_levels_route
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
    log(f"  K2 fused_levels == plain on {n} families (SCALED, PAPER; route "
        f"{fused_levels_route(levels)})")
    # ways that sum to more than a warp's 32 lanes (two turns a step), a row
    # state above 48 KB (shared memory by opt-in) and one above the
    # shared-memory budget (the global-memory route)
    for name, levels in (("ways 16 + 16 + 16", ((16, 16), (64, 16), (256, 16))),
                         ("131 KB of state a row", ((16, 16), (64, 16), (16384, 16))),
                         ("525 KB of state a row", ((16, 16), (64, 16), (65536, 16)))):
        span = 40 * levels[-1][0]
        before = dict(fused_levels.routes)
        for streams in ([rng.integers(0, span, 30000)],
                        [rng.integers(0, span, k) for k in (900, 0, 7000)]):
            args = k2_inputs(streams, levels, dev)
            e = max_err(fused_levels(*args[:2], levels, *args[2:]),
                        fused_levels_plain(*args[:2], levels, *args[2:]))
            check(e == 0, f"K2 {name}: kernel != plain (max err {e})")
            err = max(err, e)
        err = max(err, k2_resume(rng.integers(0, span, 20000), 7000, levels, dev))
        ran = [r for r, c in fused_levels.routes.items() if c > before[r]]
        check(ran == [fused_levels_route(levels)], f"K2 {name}: routes {ran} ran")
        log(f"  K2 fused_levels == plain on {name}, a stream axis of 3 with an empty "
            f"member, and resumed (route {ran[0]})")
    check(all(fused_levels.routes.values()), f"K2 routes {fused_levels.routes}: one never ran")
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


def same_bits(got, ref) -> bool:
    """Equal bit for bit, except that any NaN matches any NaN (the card's
    and the CPU's adds give NaNs of other signs and payloads)."""
    import torch

    nan = torch.isnan(ref)
    return bool(torch.equal(torch.isnan(got), nan)) and bool(
        torch.equal(got[~nan].view(torch.int32), ref[~nan].view(torch.int32)))


def segment_sum_families():
    """(name, values, segment ids, segments) of the ordered segment sum's
    families (``tests/test_torch_segment_sum.py``'s, on the card)."""
    import numpy as np

    from repro_torch.graphs import make_dataset

    rng = np.random.default_rng(2)

    def spread(e):  # magnitudes where another order gives other bits
        return (10.0 ** rng.uniform(-6, 3, e) * rng.choice([-1.0, 1.0], e)).astype(np.float32)

    def segments(lens):
        return rng.permutation(np.repeat(np.arange(len(lens)), lens))

    out = [("no edges", np.zeros(0, np.float32), np.zeros(0, np.int64), 7),
           ("9 of 10 segments empty", np.ones(3, np.float32), np.full(3, 9), 10),
           ("one segment of 5,000 edges", spread(5000), np.full(5000, 3), 5)]
    for n in (8, 32, 64, 256):  # the hoist, the chunk, two chunks, the ring
        ids = segments([n - 1, n, n + 1, 0, 2 * n, 5])
        out.append((f"lengths around {n}", spread(len(ids)), ids, 6))
    ids = segments(np.minimum(rng.zipf(1.6, 3000), 3000))
    out.append(("skewed lengths, unsorted ids", spread(len(ids)), ids, 3000))
    tiny = np.float32(np.finfo(np.float32).tiny)
    sub = tiny * np.float32(2.0**-10)
    odd = [[-0.0], [-0.0] * 40, [sub, sub, -sub], [sub] * 50, [tiny, -tiny / 2, -tiny / 4],
           [np.inf, -np.inf], [1.0] * 35 + [-np.inf] + [2.0] * 10, [1.0] * 40 + [np.nan],
           [3.0e38, 3.0e38, -3.0e38]]
    ids = rng.permutation(np.concatenate([np.full(len(x), i) for i, x in enumerate(odd)]))
    vals = np.empty(len(ids), np.float32)
    for i, x in enumerate(odd):
        vals[ids == i] = x
    out.append(("signed zeros, subnormals, infinities, NaN", vals, ids, len(odd)))
    g = make_dataset("google")
    for name, dst in (("google push", g.neighbors), ("google pull", g.transpose().edge_sources())):
        vals = rng.random(len(dst), dtype=np.float32) / 1000
        vals[rng.random(len(dst)) < 0.5] = 0.0
        out.append((name, vals, dst, g.num_vertices))
    return out


def segment_sum_check(dev):
    """The ordered segment sum on the card == index_add_ on the CPU, bit for
    bit, on its families; returns the max abs error (0)."""
    import numpy as np
    import torch

    from repro_torch.kernels.segment_sum.segment_sum import (
        segment_plan, segment_sum, segment_sum_plain,
    )

    fams = segment_sum_families()
    for name, vals, ids, n in fams:
        plan = segment_plan(ids, n, dev)
        got = segment_sum(torch.from_numpy(vals).to(dev), plan).cpu()
        ref = segment_sum_plain(torch.from_numpy(vals), torch.from_numpy(ids.astype(np.int64)), n)
        check(same_bits(got, ref), f"segment_sum {name}: kernel != index_add_ on the CPU")
    log(f"  segment_sum == index_add_ (CPU) bit for bit on {len(fams)} families")
    return 0.0


INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def k3_tiles(rng, e, w, spread):
    """AMC-shaped entry tiles: per row a base near 2^24 plus deltas within
    ``spread``, counts in ``[0, w]`` (pad columns hold junk)."""
    import numpy as np

    counts = rng.integers(0, w + 1, e).astype(np.int32)
    base = rng.integers(0, 2**24, (e, 1))
    tiles = (base + rng.integers(-spread, spread + 1, (e, w))).astype(np.int32)
    return tiles, counts


def k3_extremes():
    """Rows whose deltas wrap at the int32 extremes."""
    import numpy as np

    rows = [
        [INT32_MIN, INT32_MAX, 0, -1],  # INT32_MAX - INT32_MIN wraps to -1
        [0, INT32_MIN, 5, 0],  # delta INT32_MIN: abs stays INT32_MIN
        [0, INT32_MIN, 200, 0],  # ... and the 200 decides the mode
        [-1, INT32_MAX, 0, 0],  # delta wraps to INT32_MIN
        [INT32_MAX, INT32_MIN, -40000, 7],
        [5, 5 + 127, 5 - 127, 5 + 128],
        [5, 5 + 32767, 5 - 32768, 0],
    ]
    tiles = np.array(rows, dtype=np.int64).astype(np.int32)
    return tiles, np.full(len(rows), 4, np.int32)


def k3_families(dev):
    """K3a / K3b against their plain versions on the card, bit for bit; K3b
    on both routes (16-byte units, single elements)."""
    import numpy as np
    import torch

    from repro_torch.kernels.basedelta.basedelta import (
        basedelta_compress_plain, basedelta_compress_tiles,
        basedelta_decompress_plain, basedelta_decompress_tiles,
    )

    rng = np.random.default_rng(4)
    cases = [
        ("E=0", np.zeros((0, 32), np.int32), np.zeros(0, np.int32)),
        ("W=1", *k3_tiles(rng, 300, 1, 1000)),
        ("counts 0 and W", rng.integers(-99, 99, (4, 32)).astype(np.int32),
         np.array([0, 32, 0, 32], np.int32)),
        ("int32 extremes", *k3_extremes()),
        ("W=40 (columns loop)", *k3_tiles(rng, 500, 40, 40000)),
    ] + [(f"W={w}", *k3_tiles(rng, 3001, w, 5000)) for w in (3, 4, 33)] + [
        (f"AMC tiles, spread {s}", *k3_tiles(rng, 5000, 32, s)) for s in (50, 5000, 10**6)]
    routes = basedelta_decompress_tiles.routes
    before = dict(routes)
    err = 0.0
    for name, tiles, counts in cases:
        t = torch.from_numpy(tiles).to(dev)
        c = torch.from_numpy(counts).to(dev)
        got = basedelta_compress_tiles(t, c)
        e = max_err(got, basedelta_compress_plain(t, c))
        check(e == 0, f"K3a {name}: kernel != plain (max err {e})")
        base = t[:, 0].contiguous()
        views = [("", got[0])]
        if name.startswith("AMC tiles"):
            # the same deltas in a view 4 bytes off 16-byte alignment
            buf = torch.empty(got[0].numel() + 1, dtype=torch.int32, device=dev)
            views.append((", a view 4 bytes off alignment", buf[1:].view(got[0].shape)))
            views[-1][1].copy_(got[0])
        for what, deltas in views:
            n0 = dict(routes)
            e2 = max_err([basedelta_decompress_tiles(base, deltas)],
                         [basedelta_decompress_plain(base, deltas)])
            check(e2 == 0, f"K3b {name}{what}: kernel != plain (max err {e2})")
            ran = [r for r, k in routes.items() if k > n0[r]] or ["none (E=0)"]
            log(f"  K3 {name}{what}: == plain, K3b route {ran[0]}")
            err = max(err, e, e2)
    ran = {r: routes[r] - before[r] for r in routes}
    check(all(ran.values()), f"K3b routes {ran}: one never ran")
    log(f"  K3a basedelta_compress_tiles, K3b basedelta_decompress_tiles == plain on "
        f"{len(cases)} families; K3b launches by route {json.dumps(ran)}")
    return err


def k4_families(dev):
    """K4a against its plain version on the card and K4b against its plain
    version on the CPU (``index_add_`` adds in index order there; on the
    card it adds with atomics), bit for bit."""
    import numpy as np
    import torch

    from repro_torch.kernels.amc_gather.amc_gather import (
        amc_gather, amc_gather_plain, amc_gather_segment_sum, amc_gather_segment_sum_plain,
    )

    rng = np.random.default_rng(5)

    def table(v, d, dtype):
        return torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(dtype).to(dev)

    def idx(n, v):
        return torch.from_numpy(rng.integers(0, v, n).astype(np.int32)).to(dev)

    f32, bf16 = torch.float32, torch.bfloat16
    gathers = [
        ("N=0", table(50, 128, f32), idx(0, 50)),
        ("f32 D=128 (16-byte rows)", table(3000, 128, f32), idx(20000, 3000)),
        ("f32 D=3", table(100, 3, f32), idx(5000, 100)),
        ("f32 D=5", table(100, 5, f32), idx(5000, 100)),
        ("f32 D=2, table not 16-byte aligned", table(101, 2, f32)[1:], idx(777, 100)),
        ("bf16 D=128", table(3000, 128, bf16), idx(20000, 3000)),
        ("bf16 D=3", table(100, 3, bf16), idx(999, 100)),
        ("bf16 D=6", table(100, 6, bf16), idx(999, 100)),
        ("repeated index", table(10, 64, f32), torch.full((300,), 7, dtype=torch.int32, device=dev)),
    ]
    err = 0.0
    for name, tab, ix in gathers:
        e = max_err([amc_gather(tab, ix)], [amc_gather_plain(tab, ix)])
        check(e == 0, f"K4a {name}: kernel != plain (max err {e})")
        err = max(err, e)

    def segs(n, s, empty_frac):
        keep = rng.random(s) >= empty_frac
        ids = np.flatnonzero(keep) if keep.any() else np.arange(1)
        return torch.from_numpy(np.sort(rng.choice(ids, n)).astype(np.int32)).to(dev)

    deg = rng.integers(1, 5, 20000)  # segment 10,000 holds 5,000 rows
    skewed = torch.from_numpy(np.repeat(np.arange(20001), np.insert(deg, 10000, 5000))
                              .astype(np.int32)).to(dev)
    misaligned = table(3001, 128, f32).flatten()[1:1 + 3000 * 128].view(3000, 128)
    out_of_range_segs = segs(3000, 50, 0.0)
    ix = rng.integers(0, 500, 3000)
    in7 = (out_of_range_segs == 7).cpu().numpy()
    ix[in7] = np.where(rng.random(int(in7.sum())) < 0.5, -1 - ix[in7], 500 + ix[in7])
    out_of_range = torch.from_numpy(ix.astype(np.int32)).to(dev)
    check(bool(in7.any()), "K4b families: segment 7 is empty")
    sums = [
        ("N=0, all segments empty", table(40, 16, f32), idx(0, 40), segs(0, 7, 0.0), 7),
        ("f32 D=128, empty segments", table(3000, 128, f32), idx(30000, 3000),
         segs(30000, 5000, 0.3), 5000),
        ("one segment holds all of N", table(500, 64, f32), idx(20000, 500),
         torch.full((20000,), 3, dtype=torch.int32, device=dev), 9),
        ("f32 D=5", table(100, 5, f32), idx(4000, 100), segs(4000, 300, 0.2), 300),
        ("bf16 D=128, empty segments", table(2000, 128, bf16), idx(10000, 2000),
         segs(10000, 3000, 0.3), 3000),
        ("bf16 D=3", table(100, 3, bf16), idx(2000, 100), segs(2000, 90, 0.1), 90),
        ("path E's skew: one segment of 5,000 rows among 20,000 of 1-4",
         table(20000, 128, f32), idx(5000 + deg.sum(), 20000), skewed, 20001),
        ("f32 D=256 (two vectors a lane)", table(3000, 256, f32), idx(20000, 3000),
         segs(20000, 4000, 0.2), 4000),
        ("bf16 D=64 (8 lanes of 32)", table(3000, 64, bf16), idx(20000, 3000),
         segs(20000, 4000, 0.2), 4000),
        ("f32 D=128, table view 4 bytes past 16-byte alignment", misaligned,
         idx(10000, 3000), segs(10000, 2000, 0.2), 2000),
        ("segment 7's every index out of range", table(500, 128, f32), out_of_range,
         out_of_range_segs, 50),
    ]
    for name, tab, ix, sg, ns in sums:
        got = amc_gather_segment_sum(tab, ix, sg, ns).cpu()
        keep = ((ix >= 0) & (ix < tab.shape[0])).cpu()  # the kernel adds nothing for the rest
        ref = amc_gather_segment_sum_plain(tab.cpu(), ix.cpu()[keep], sg.cpu()[keep], ns)
        e = max_err([got], [ref])
        check(e == 0, f"K4b {name}: kernel != plain on the CPU (max err {e})")
        err = max(err, e)
    log(f"  K4a amc_gather == plain on {len(gathers)} families; K4b "
        f"amc_gather_segment_sum == plain (CPU) on {len(sums)} families")
    return err


# Tolerances of the LM kernels against their plain versions, stated before
# any run.  float32: the JAX package's own tests (attention
# tests/test_ssm_moe_attn.py:160, SSD :44).  bfloat16: both versions compute
# in float32 from the same bfloat16 inputs and round once at the end, so an
# output may land one bfloat16 ulp apart (at most 2^-7 of its value): rtol
# 1e-2, and atol 1e-3 for outputs near 0.  At path F's attention (outputs
# of about 0.03) that is about 4 % of a typical value.
ATTN_TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=1e-2, atol=1e-3)}
SSD_TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=1e-2, atol=1e-3)}


def close(got, ref, rtol, atol, what):
    """Check ``|got - ref| <= atol + rtol |ref|`` elementwise (finite
    values only); returns the max abs error."""
    import torch

    g, r = got.double(), ref.double()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    err = (g - r).abs()
    bad = err > atol + rtol * r.abs()
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements outside rtol={rtol} "
          f"atol={atol} (max abs err {float(err.max())})")
    return float(err.max()) if err.numel() else 0.0


def k5_inputs(rng, b, sq, skv, h, kv, hd, dtype, dev, cancelling=False):
    """Normal q, k, v; with ``cancelling``, key rows in pairs (the second
    1.05 times the first) with values +v and -v of size ~16, so that each
    output is a small difference of large terms and one bfloat16 rounding of
    P, or two bfloat16 parts of a float32 operand, would show
    (``tests/test_torch_flash_attn_tc.py``, ``test_torch_flash_attn_f32tc.py``)."""
    import numpy as np
    import torch

    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd)))
    if cancelling:
        k[:, 1::2] = k[:, 0::2][:, :k[:, 1::2].shape[1]] * 1.05
        v *= 16
        v[:, 1::2] = -v[:, 0::2][:, :v[:, 1::2].shape[1]]
    return tuple(torch.from_numpy(a).to(dtype).to(dev) for a in (q, k, v))


def k5_families(dev):
    """K5 against its plain version (blocked_attention's scan) on the card;
    returns the max abs error."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attn.flash_attn import flash_attention
    from repro_torch.kernels.flash_attn.ref import blocked_attention_plain

    rng = np.random.default_rng(6)
    # (name, b, sq, skv, h, kv, hd, causal, window, q_offset)
    cases = [
        ("causal GQA hd 64", 2, 256, 256, 4, 2, 64, True, 0, 0),
        ("causal window 128 hd 128", 1, 384, 384, 2, 2, 128, True, 128, 0),
        ("non-causal hd 64", 2, 200, 200, 4, 4, 64, False, 0, 0),
        ("ragged S 130, kv 1", 1, 130, 130, 2, 1, 64, True, 0, 0),
        ("hd 32 GQA 4", 2, 100, 100, 8, 2, 32, True, 0, 0),
        ("q_offset 200 into 300 keys", 2, 100, 300, 4, 2, 64, True, 0, 200),
        ("window 10 (all-masked first tiles)", 1, 500, 500, 4, 4, 64, True, 10, 0),
        ("non-causal window 50", 1, 300, 300, 2, 1, 128, False, 50, 0),
        ("zamba2 heads, S 1024", 1, 1024, 1024, 32, 32, 64, True, 0, 0),
        ("cancelling pairs, causal GQA hd 64", 2, 256, 256, 4, 2, 64, True, 0, 0),
        ("cancelling pairs, hd 128 window 128", 1, 300, 300, 2, 2, 128, True, 128, 0),
        ("cancelling pairs, hd 32 non-causal", 1, 130, 130, 4, 4, 32, False, 0, 0),
        ("zamba2 heads, S 4096", 1, 4096, 4096, 32, 32, 64, True, 0, 0),
        ("hd 128 window 128, S 1000", 2, 1000, 1000, 4, 4, 128, True, 128, 0),
        ("GQA 4, q_offset 300 into 700 keys", 2, 400, 700, 8, 2, 64, True, 0, 300),
        ("cancelling pairs, window 10 hd 64", 1, 300, 300, 4, 4, 64, True, 10, 0),
    ]
    err, n = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[str(dtype).split(".")[1]]
        for name, b, sq, skv, h, kv, hd, causal, win, qoff in cases:
            cancelling = name.startswith("cancelling")
            q, k, v = k5_inputs(rng, b, sq, skv, h, kv, hd, dtype, dev, cancelling)
            got = flash_attention(q, k, v, causal=causal, sliding_window=win, q_offset=qoff)
            ref = blocked_attention_plain(q, k, v, causal, win, qoff)
            check(got.shape == ref.shape and got.dtype == ref.dtype, f"K5 {name}: shape/dtype")
            err = max(err, close(got, ref, what=f"K5 {name} {dtype}", **tol))
            n += 1
    # bf16 views 2 bytes past 16-byte alignment: the wrapper copies them for
    # the kernel's 16-byte cp.async
    q, k, v = k5_inputs(rng, 2, 200, 200, 4, 2, 64, torch.bfloat16, dev)
    q, k, v = (torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape).copy_(t)
               for t in (q, k, v))
    check(q.data_ptr() % 16 != 0, "K5 misaligned family: view is aligned")
    got = flash_attention(q, k, v, causal=True)
    err = max(err, close(got, blocked_attention_plain(q, k, v, True),
                         what="K5 misaligned bf16 views", **ATTN_TOL["bfloat16"]))
    n += 1
    log(f"  K5 flash_attention == plain on {n} families (float32 rtol 1e-4 atol 1e-5, "
        f"bfloat16 rtol 1e-2 atol 1e-3), max abs err {err:.3g}")
    return err


def k6_inputs(rng, bsz, s, h, p, n, dtype, dev, init=False, softplus_dt=False,
              cancelling=False):
    """K6 inputs from ``rng``; with ``cancelling``, positions in pairs (the
    second's B 1.05 times the first's, its x negated, the same dt, slow
    decay), so that one bfloat16 rounding of G, w B or S would show
    (``tests/test_torch_ssd_scan_tc.py``)."""
    import numpy as np
    import torch

    def t(arr, dt=torch.float32):
        return torch.from_numpy(np.asarray(arr, dtype=np.float32)).to(dt).to(dev)

    x = rng.normal(size=(bsz, s, h, p))
    if softplus_dt:  # the model's init: dt = softplus(N(0, 1)), a = -1
        dt = np.log1p(np.exp(rng.normal(size=(bsz, s, h))))
        a = -np.ones(h)
    else:
        dt = rng.uniform(0.1, 0.8, (bsz, s, h))
        a = -rng.uniform(0.3, 1.5, h)
    b = rng.normal(size=(bsz, s, n))
    c = rng.normal(size=(bsz, s, n))
    if cancelling:
        half = s // 2
        b[:, 1:2 * half:2] = 1.05 * b[:, 0:2 * half:2]
        x[:, 1:2 * half:2] = -x[:, 0:2 * half:2]
        dt[:, 1:2 * half:2] = dt[:, 0:2 * half:2]
        a = -rng.uniform(0.01, 0.05, h)
    st = t(rng.normal(size=(bsz, h, p, n))) if init else None
    return t(x, dtype), t(dt), t(a), t(b, dtype), t(c, dtype), st


def k6_families(dev):
    """K6 against its plain version on the card, and against the
    sequential recurrence ``ssd_naive`` at chunk 256 with the model's dt,
    where ssd_chunked's unmasked exponent overflows; returns the max abs
    error."""
    import numpy as np
    import torch

    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain, ssd_naive
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan

    rng = np.random.default_rng(7)
    f32, bf16 = torch.float32, torch.bfloat16
    routes = dict(ssd_scan.routes)
    # (name, bsz, s, h, p, n, chunk, dtype, init); "cancelling" cases take
    # k6_inputs' cancelling pairs
    cases = [
        ("P 32 N 16 chunk 16", 2, 50, 3, 32, 16, 16, f32, False),
        ("P 32 N 64 chunk 32, init", 2, 120, 2, 32, 64, 32, f32, True),
        ("P 64 N 64 chunk 64, init", 1, 300, 4, 64, 64, 64, f32, True),
        ("P 64 N 128 chunk 256, ragged", 2, 600, 2, 64, 128, 256, f32, False),
        ("P 32 N 128 chunk 128, init", 1, 333, 3, 32, 128, 128, f32, True),
        ("P 64 N 16 chunk 256, S < chunk", 1, 100, 2, 64, 16, 256, f32, False),
        ("zamba2 head shapes, chunk 256, init", 2, 1000, 8, 64, 64, 256, f32, True),
        ("bf16 P 64 N 64 chunk 256, init", 2, 600, 4, 64, 64, 256, bf16, True),
        ("bf16 P 32 N 16 chunk 16", 1, 100, 2, 32, 16, 16, bf16, False),
        ("bf16 P 64 N 128 chunk 64", 1, 200, 2, 64, 128, 64, bf16, False),
        ("cancelling pairs, bf16 zamba2 head shapes, init", 2, 1000, 8, 64, 64, 256, bf16, True),
        ("cancelling pairs, bf16 P 32 N 128 chunk 128", 1, 333, 3, 32, 128, 128, bf16, False),
        ("f32 P 32 N 16 chunk 48, init", 1, 100, 2, 32, 16, 48, f32, True),
        ("f32 P 64 N 128 chunk 512 (query tiles of 16)", 1, 1100, 2, 64, 128, 512, f32, True),
        ("bf16 P 64 N 64 chunk 1024 (query tiles of 16)", 1, 2100, 2, 64, 64, 1024, bf16, False),
    ]
    err, n = 0.0, 0
    for name, bsz, s, h, p, nn, chunk, dtype, init in cases:
        x, dt, a, b, c, st = k6_inputs(rng, bsz, s, h, p, nn, dtype, dev, init,
                                       cancelling=name.startswith("cancelling"))
        y, fin = ssd_scan(x, dt, a, b, c, chunk=chunk, init_state=st)
        y_ref, fin_ref = ssd_chunked_plain(x, dt, a, b, c, chunk, st)
        check(y.dtype == x.dtype and fin.dtype == f32, f"K6 {name}: dtypes")
        tol = SSD_TOL[str(dtype).split(".")[1]]
        err = max(err, close(y, y_ref, what=f"K6 {name}: y", **tol),
                  close(fin, fin_ref, what=f"K6 {name}: final state", **SSD_TOL["float32"]))
        n += 1
    # x, B and C as slices of one in-projection (the model's layout: the
    # kernel reads them in place), and a projection whose slices sit 2
    # elements off 16-byte alignment (the wrapper copies them)
    for shift in (0, 2):
        bsz, s_len, h, p, nn = 2, 700, 8, 64, 64
        proj = torch.from_numpy(rng.normal(size=(bsz, s_len, shift + h * p + 2 * nn))
                                .astype(np.float32)).to(bf16).to(dev)[..., shift:]
        x = proj[..., :h * p].reshape(bsz, s_len, h, p)
        b, c = proj[..., h * p:h * p + nn], proj[..., h * p + nn:]
        _, dt, a, _, _, st = k6_inputs(rng, bsz, s_len, h, p, nn, bf16, dev, init=True)
        check((x.data_ptr() % 16 == 0) == (shift == 0) and not x.is_contiguous(),
              "K6 sliced family: the views are not what the case needs")
        y, fin = ssd_scan(x, dt, a, b, c, chunk=256, init_state=st)
        y_ref, fin_ref = ssd_chunked_plain(x, dt, a, b, c, 256, st)
        what = f"K6 slices of one projection{' (misaligned)' if shift else ''}"
        err = max(err, close(y, y_ref, what=f"{what}: y", **SSD_TOL["bfloat16"]),
                  close(fin, fin_ref, what=f"{what}: final state", **SSD_TOL["float32"]))
        n += 1
    for dtype in (f32, bf16):  # both routes against the recurrence
        x, dt, a, b, c, _ = k6_inputs(rng, 1, 512, 4, 64, 64, dtype, dev, softplus_dt=True)
        y, fin = ssd_scan(x, dt, a, b, c, chunk=256)
        y_ref, fin_ref = ssd_naive(x, dt, a, b, c)
        tol = SSD_TOL[str(dtype).split(".")[1]]
        err = max(err, close(y, y_ref, what=f"K6 vs ssd_naive, chunk 256, {dtype}: y", **tol),
                  close(fin, fin_ref, what=f"K6 vs ssd_naive, chunk 256, {dtype}: state",
                        **SSD_TOL["float32"]))
    ran = {r: ssd_scan.routes[r] - routes[r] for r in routes}
    check(all(ran.values()), f"K6 routes {ran}: one never ran")
    log(f"  K6 ssd_scan == plain on {n} families and == ssd_naive at chunk 256 with "
        f"dt = softplus(N(0, 1)) (float32 2e-4, bfloat16 rtol 1e-2 atol 1e-3), max abs err "
        f"{err:.3g}; launches by route {ran}")
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
    prefetchers = gold.get("prefetchers", PREFETCHERS)
    t0 = time.perf_counter()
    wl = build_workload(gold["kernel"], gold["dataset"],
                        hierarchy=getattr(memsim, gold["hierarchy"]), device=dev)
    sync(dev)
    t1 = time.perf_counter()
    rows = score_prefetchers_batched(wl, resolve_prefetchers(prefetchers))
    sync(dev)
    t2 = time.perf_counter()
    stages = dict(wl.stage_seconds, score=t2 - t1, total=t2 - t0)
    check(wl.device.type == dev.type, f"{cell}: workload on {wl.device}, expected {dev}")
    runs = [e for e, _ in wl.iter_epochs]
    got = dict(
        iterations=len(wl.iter_epochs),
        accesses=wl.num_accesses,
        l2_accesses=len(wl.profile.l2_pos),
        levels_sha256=hashlib.sha256(demand_levels(wl.profile).tobytes()).hexdigest(),
        # two-run cells only: the iterations of each run and where run 2 starts
        run_iterations=[runs.count(0), runs.count(1)],
        eval_from_pos=wl.eval_from_pos,
    )
    for k, v in got.items():
        if k in gold:
            check(v == gold[k], f"{cell}: {k} {v} != golden {gold[k]}")
    check(sorted(m.name for m in rows) == sorted(gold["rows"]), f"{cell}: prefetchers differ")
    for m in rows:
        row = jsonable(m.row())
        check(all(np.isfinite(v) for v in row.values() if isinstance(v, float)),
              f"{cell}: non-finite metric in {m.name}")
        if row != gold["rows"][m.name]:
            diff = {k: (row.get(k), gold["rows"][m.name].get(k))
                    for k in gold["rows"][m.name] if row.get(k) != gold["rows"][m.name].get(k)}
            raise SmokeError(f"{cell}: {m.name} row differs from golden: {diff}")
    log(f"  {cell}: {got['iterations']} iterations, {got['accesses']} accesses, "
        f"rows == golden ({', '.join(prefetchers)})")
    log("  stage seconds " + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    return wl, stages


# ------------------------------------------------------------ phase 6


def bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """The least milliseconds the card could take: bytes over the memory
    rate or operations over the peak rate of their type, whichever is
    larger, and which of the two it is."""
    tb, to = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_kernels(wl, dev, errs, launches, k1_calls):
    """Per-kernel timing at main path B's shapes (K1 at the largest of the
    recorded K1 launches ``k1_calls``)."""
    import torch

    from repro_torch.kernels.cache_sim.fused_sim import fused_levels_route
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
    longest2 = int((a2[1][1:] - a2[1][:-1]).max())  # the longest dependent chain
    state_b = sum(t.numel() for t in a2[2]) * 4 * 2 * 2
    def run_k2():
        return fused_levels(*a2[:2], levels, *a2[2:])

    ms2, host2 = cuda_ms(run_k2, dev, reps=3), enqueue_us(run_k2, dev)
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
        ms=ms2, host_us=host2, plain_ms=plain2, bound_ms=b2, bound_by=by2, library_ms=None,
        kernel_route=fused_levels_route(levels), longest_row=longest2,
        ns_per_step=ms2 * 1e6 / longest2,
        shape=f"{n2} kept accesses, {rows2} groups (longest {longest2}), levels {list(levels)}",
    ))
    log(f"  fused_levels ({fused_levels_route(levels)} route): {ms2:.3f} ms (plain "
        f"{plain2:.1f} ms, bound {b2:.4f} ms); {n2} kept accesses in {rows2} rows, the "
        f"longest {longest2} steps: {ms2 * 1e6 / longest2:.1f} ns a step")

    # K1: the largest of B's launches (by accesses), on its recorded inputs
    a1 = max(k1_calls, key=lambda args: args[0].numel())
    n1, rows1, ways1 = a1[0].numel(), a1[1].numel() - 1, a1[2].shape[1]
    longest1 = int((a1[1][1:] - a1[1][:-1]).max())
    ms1, host1 = cuda_ms(lambda: lru_hits(*a1), dev, reps=5), enqueue_us(lambda: lru_hits(*a1), dev)
    plain1, ref1 = host_ms(lambda: lru_hits_plain(*a1), dev)
    e1 = max_err(lru_hits(*a1), ref1)
    check(e1 == 0, f"K1 at main path B's largest launch: kernel != plain (max err {e1})")
    errs["lru_hits"] = max(errs["lru_hits"], e1)
    b1, by1 = bound(n1 * 5 + (rows1 + 1) * 8 + a1[2].numel() * 4 * 4, n1 * 2 * ways1)
    out.append(dict(
        name="lru_hits", route="cuda",
        source="src/repro_torch/kernels/cache_sim/csrc/lru_hits.cu",
        replaces="src/repro/kernels/cache_sim/cache_sim.py:126",
        launches=launches["lru_hits"], max_abs_err=errs["lru_hits"],
        matches_plain=errs["lru_hits"] == 0,
        ms=ms1, host_us=host1, plain_ms=plain1, bound_ms=b1, bound_by=by1, library_ms=None,
        longest_row=longest1, ns_per_step=ms1 * 1e6 / longest1,
        shape=f"{n1} accesses, {rows1} sets x {ways1} ways (the largest of B's launches)",
    ))
    log(f"  lru_hits at B's largest launch: {ms1:.3f} ms (plain {plain1:.1f} ms, bound "
        f"{b1:.4f} ms); {n1} accesses in {rows1} rows x {ways1} ways, the longest {longest1} "
        f"steps: {ms1 * 1e6 / longest1:.1f} ns a step")

    # Ordered segment sum: B's push edge order.
    graph = make_dataset(wl.dataset)
    plan = segment_plan(graph.neighbors, graph.num_vertices, dev)
    vals = torch.rand(graph.num_edges, generator=torch.Generator().manual_seed(3)).to(dev)
    ms3, host3 = cuda_ms(lambda: segment_sum(vals, plan), dev, reps=20), enqueue_us(
        lambda: segment_sum(vals, plan), dev)
    plain3 = cuda_ms(lambda: segment_sum_plain(vals, plan.ids, plan.num_segments), dev, reps=20)
    # held against the plain version on the CPU, where index_add_ adds in
    # edge order (on the card it adds with atomics)
    ref3 = segment_sum_plain(vals.cpu(), plan.ids.cpu(), plan.num_segments)
    e3 = max_err([segment_sum(vals, plan).cpu()], [ref3])
    check(e3 == 0, f"segment_sum at main path B's shape: kernel != index_add_ (max err {e3})")
    errs["segment_sum"] = max(errs["segment_sum"], e3)
    # torch.segment_reduce over the values gathered into segment order: two
    # calls, and its own order of adds; a yardstick, and the library call
    # only if it gives the same bits
    perm = plan.perm.long()
    reduce = lambda: torch.segment_reduce(vals[perm], "sum", offsets=plan.offsets)  # noqa: E731
    reduce_ms = cuda_ms(reduce, dev, reps=20)
    reduce_same = same_bits(reduce().cpu(), ref3)
    e = graph.num_edges
    lens = plan.offsets[1:] - plan.offsets[:-1]
    longest3 = int(lens.max())
    # the bound: the bytes, or the longest segment's chain of dependent
    # float32 adds (4 cycles each at the SM's top clock), whichever is longer
    clock = sm_clock_hz()
    chain3 = longest3 * FADD_CYCLES / clock * 1e3
    bytes3 = (e * 8 + (graph.num_vertices + 1) * 8 + graph.num_vertices * 4
              + plan.heavy.numel() * 4) / HBM_BYTES_PER_S * 1e3
    b3, by3 = (chain3, "operations") if chain3 >= bytes3 else (bytes3, "bytes")
    out.append(dict(
        name="segment_sum", route="cuda",
        source="src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu",
        replaces="src/repro/apps/pagerank_delta.py:59 (jax.ops.segment_sum; not a Pallas kernel)",
        launches=launches["segment_sum"], max_abs_err=errs["segment_sum"],
        matches_plain=errs["segment_sum"] == 0,
        # index_add_ on the card adds with atomics, in no fixed order: it is
        # the plain version's time, not a library call for the same function
        ms=ms3, host_us=host3, plain_ms=plain3, bound_ms=b3, bound_by=by3,
        library_ms=reduce_ms if reduce_same else None,
        bound_bytes_ms=bytes3, bound_chain_ms=chain3, sm_clock_mhz=clock / 1e6,
        segment_reduce_ms=reduce_ms, segment_reduce_bit_equal=reduce_same,
        longest_segment=longest3, heavy_segments=plan.heavy.numel(),
        shape=f"{e} edges into {graph.num_vertices} segments ({plan.heavy.numel()} of more "
              f"than 32 edges, the longest {longest3})",
    ))
    log(f"  segment_sum: {ms3:.4f} ms (index_add_, atomic, {plain3:.4f} ms; bound {b3:.5f} ms "
        f"by {by3}: bytes {bytes3:.5f}, the longest segment's {longest3} adds {chain3:.5f} at "
        f"{clock / 1e6:.0f} MHz); {plan.heavy.numel()} segments on warps; "
        f"torch.segment_reduce {reduce_ms:.4f} ms, "
        f"{'the same bits' if reduce_same else 'other bits'}")
    return out


def time_k1_launches(captured, dev):
    """Each K1 launch of main path B, timed one by one: ``(accesses,
    rows x ways, ms)`` per launch, in launch order."""
    from repro_torch.kernels.cache_sim.ops import lru_hits

    out = []
    for args in captured:
        ms = cuda_ms(lambda: lru_hits(*args), dev, reps=3)
        longest = int((args[1][1:] - args[1][:-1]).max())
        out.append(dict(accesses=int(args[0].numel()), rows=int(args[2].shape[0]),
                        ways=int(args[2].shape[1]), ms=ms, longest_row=longest,
                        ns_per_step=ms * 1e6 / longest))
        log(f"  lru_hits launch {len(out)}: {out[-1]['accesses']} accesses, "
            f"{out[-1]['rows']} rows x {out[-1]['ways']} ways: {ms:.3f} ms, the longest row "
            f"{longest} steps: {ms * 1e6 / longest:.1f} ns a step")
    log(f"  lru_hits, B's {len(out)} launches: {sum(o['ms'] for o in out):.3f} ms in all")
    return out


# ------------------------------------------------------------ phases 7-10


def device_share(fn, dev):
    """Run ``fn`` once under ``torch.profiler``: ``(wall s, device-busy s,
    top kernels, device events)``, where device-busy is the summed self time
    of the CUDA events (kernels and copies; one stream, so they do not
    overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall = time.perf_counter() - t0
    cuda = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in cuda) * 1e-6
    top = sorted(cuda, key=lambda e: -e.self_device_time_total)[:8]
    events = sum(e.count for e in cuda)
    return wall, busy, [(e.key[:60], e.count, e.self_device_time_total * 1e-3) for e in top], events


def demo_streams(pair, cap: int = 8, top: int = 512):
    """The gather demo's index streams, built as
    ``examples/evolving_graph_analytics.py`` builds them: the first ``cap``
    neighbors of the ``top`` vertices of highest degree in both runs,
    padded with the vertex itself."""
    import numpy as np

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


def vertex_table(num_vertices: int, dev):
    """The demo's (V, 128) float32 property table from ``default_rng(0)``."""
    import numpy as np
    import torch

    rows = np.random.default_rng(0).normal(size=(num_vertices, 128)).astype(np.float32)
    return torch.from_numpy(rows).to(dev)


def gather_demo(gold: dict, dev):
    """Phase 8: run 1's recorded gather stream drives run 2's gather through
    the port's ``AMCGatherSession`` on the card."""
    import numpy as np
    import torch

    from repro_torch.graphs import make_dataset, make_evolving_pair
    from repro_torch.kernels.amc_gather.amc_gather import amc_gather
    from repro_torch.kernels.amc_gather.ops import AMCGatherSession

    g = make_dataset(gold["dataset"])
    pair = make_evolving_pair(g, seed=gold["pair_seed"])
    idx1, idx2 = demo_streams(pair)
    table = vertex_table(g.num_vertices, dev)
    sess = AMCGatherSession(device=dev)
    sess.gather(table, idx1)
    sess.update()
    out2 = sess.gather(table, idx2)
    sync(dev)
    launches = amc_gather.launches
    got = dict(
        dataset=gold["dataset"], pair_seed=gold["pair_seed"],
        run1_edges=pair.run1.num_edges, run2_edges=pair.run2.num_edges,
        vertex_overlap=pair.vertex_overlap, stats=dict(sess.stats),
        stream_stability=float((idx1 == idx2).mean()),
        idx1_sha256=hashlib.sha256(idx1.tobytes()).hexdigest(),
        idx2_sha256=hashlib.sha256(idx2.tobytes()).hexdigest(),
    )
    for k, v in gold.items():
        check(got[k] == v, f"gather demo: {k} {got[k]} != golden {v}")
    ref = table[torch.from_numpy(idx2.astype(np.int64)).to(dev)]
    check(torch.equal(out2, ref), "gather demo: run-2 output != table[idx2]")
    check(launches == 1, f"gather demo: amc_gather launched {launches} times, expected 1")
    log(f"  stats {got['stats']}, stream stability {got['stream_stability']:.6f}, "
        f"output == table[idx2] exactly, amc_gather launches {launches}")
    return launches


def amc_entry_tables(wl):
    """Every correlation table the port's AMC records over ``wl``'s
    ``amc_iteration_views()``, as stored."""
    from repro_torch.core.amc.prefetcher import AMCConfig, AMCPrefetcher
    from repro_torch.core.amc.storage import AMCStorage

    class Keep(AMCStorage):
        def store(self, table):
            table = super().store(table)
            self.kept.append(table)
            return table

    cfg = AMCConfig()
    storage = Keep(int(cfg.storage_fraction * wl.input_bytes))
    storage.kept = []
    AMCPrefetcher(cfg).generate(wl, storage=storage)
    return storage.kept


def k3_on_amc_entries(tables, dev):
    """Phase 9: ``compress_entries`` and ``roundtrip`` on the card for every
    recorded table; modes equal ``select_modes``' and the misses come back."""
    import numpy as np

    from repro_torch.kernels.basedelta.ops import compress_entries, roundtrip

    entries = 0
    for t in tables:
        _, _, modes, counts, _ = compress_entries(t.miss_blocks, t.miss_offsets, device=dev)
        check(np.array_equal(modes, t.mode), f"K3 table {t.iteration}: modes != select_modes")
        check(np.array_equal(counts, t.nmiss), f"K3 table {t.iteration}: counts != nmiss")
        rec = roundtrip(t.miss_blocks, t.miss_offsets, device=dev)
        want = t.miss_blocks[t.miss_offsets[0]:t.miss_offsets[-1]]
        check(np.array_equal(rec, want), f"K3 table {t.iteration}: round trip != miss_blocks")
        entries += t.num_entries
    log(f"  {len(tables)} tables, E = {entries} entries: modes == select_modes, "
        "round trip == miss_blocks")
    return entries


def path_e(run2, table, dev):
    """Main path E: the push-mode gather consumer, ``amc_gather_segment_sum``
    of the vertex table along run 2's edges in CSR order, on the card;
    held against the plain version on the CPU.  Returns its inputs."""
    import torch

    from repro_torch.kernels.amc_gather.amc_gather import (
        amc_gather_segment_sum, amc_gather_segment_sum_plain,
    )

    idx = torch.from_numpy(run2.neighbors).to(dev)
    seg = torch.from_numpy(run2.edge_sources()).to(dev)
    s = run2.num_vertices
    got = amc_gather_segment_sum(table, idx, seg, s).cpu()
    ref = amc_gather_segment_sum_plain(table.cpu(), idx.cpu(), seg.cpu(), s)
    e = max_err([got], [ref])
    check(e == 0, f"path E: amc_gather_segment_sum != plain on the CPU (max err {e})")
    log(f"  amc_gather_segment_sum of ({table.shape[0]} x {table.shape[1]}) along "
        f"{idx.numel()} edges into {s} segments == plain (CPU)")
    return idx, seg, s


def time_recorded_stream_kernels(table, idx, seg, num_segments, tables, dev, errs, launches):
    """Phase 10: K4a / K4b along run 2 of path D and K3a / K3b on phase 9's
    entries, each held once more against its plain version and timed with
    CUDA events beside the plain version, the bytes bound and the library
    call."""
    import numpy as np
    import torch

    from repro_torch.kernels.amc_gather.amc_gather import (
        amc_gather, amc_gather_plain, amc_gather_segment_sum, amc_gather_segment_sum_plain,
    )
    from repro_torch.kernels.basedelta.basedelta import (
        basedelta_compress_plain, basedelta_compress_tiles,
        basedelta_decompress_plain, basedelta_decompress_tiles, decompress_route,
    )
    from repro_torch.kernels.basedelta.ops import pack_ragged

    out = []
    v, d = table.shape
    n = idx.numel()
    row_b = d * table.element_size()
    uniq = int(torch.unique(idx).numel())
    common = dict(route="cuda", library_ms=None)

    # K4a: table[idx] along run 2's edges
    ms = cuda_ms(lambda: amc_gather(table, idx), dev, reps=20)
    host = enqueue_us(lambda: amc_gather(table, idx), dev)
    plain = cuda_ms(lambda: amc_gather_plain(table, idx), dev, reps=20)
    lib = cuda_ms(lambda: torch.index_select(table, 0, idx), dev, reps=20)
    e = max_err([amc_gather(table, idx)], [amc_gather_plain(table, idx)])
    check(e == 0, f"K4a at path D's shape: kernel != plain (max err {e})")
    errs["amc_gather"] = max(errs["amc_gather"], e)
    b, by = bound(uniq * row_b + n * 4 + n * row_b, 0)
    out.append(dict(common, name="amc_gather",
                    source="src/repro_torch/kernels/amc_gather/csrc/amc_gather.cu",
                    replaces="src/repro/kernels/amc_gather/amc_gather.py:34",
                    launches=launches["amc_gather"], max_abs_err=errs["amc_gather"],
                    matches_plain=errs["amc_gather"] == 0, ms=ms, host_us=host, plain_ms=plain,
                    bound_ms=b, bound_by=by, library_ms=lib,
                    shape=f"({v} x {d}) float32 table, {n} indices ({uniq} distinct rows)"))
    log(f"  amc_gather: {ms:.4f} ms (plain {plain:.4f} ms, index_select {lib:.4f} ms, "
        f"bound {b:.4f} ms)")

    # K4b: segment sums of the same rows over run 2's edge sources
    ms = cuda_ms(lambda: amc_gather_segment_sum(table, idx, seg, num_segments), dev, reps=10)
    host = enqueue_us(lambda: amc_gather_segment_sum(table, idx, seg, num_segments), dev)
    plain = cuda_ms(lambda: amc_gather_segment_sum_plain(table, idx, seg, num_segments),
                    dev, reps=10)
    starts = torch.searchsorted(
        seg, torch.arange(num_segments, device=dev, dtype=torch.int32), out_int32=True)
    lib = cuda_ms(lambda: torch.nn.functional.embedding_bag(
        idx, table, starts, mode="sum"), dev, reps=10)
    e = max_err([amc_gather_segment_sum(table, idx, seg, num_segments).cpu()],
                [amc_gather_segment_sum_plain(table.cpu(), idx.cpu(), seg.cpu(), num_segments)])
    check(e == 0, f"K4b at path D's shape: kernel != plain on the CPU (max err {e})")
    errs["amc_gather_segment_sum"] = max(errs["amc_gather_segment_sum"], e)
    b, by = bound(uniq * row_b + n * 8 + num_segments * row_b, n * d)
    out.append(dict(common, name="amc_gather_segment_sum",
                    source="src/repro_torch/kernels/amc_gather/csrc/amc_gather.cu",
                    replaces="src/repro/kernels/amc_gather/amc_gather.py:89",
                    launches=launches["amc_gather_segment_sum"],
                    max_abs_err=errs["amc_gather_segment_sum"],
                    matches_plain=errs["amc_gather_segment_sum"] == 0, ms=ms, host_us=host, plain_ms=plain,
                    bound_ms=b, bound_by=by, library_ms=lib,
                    shape=f"({v} x {d}) float32 table, {n} indices into {num_segments} segments"))
    log(f"  amc_gather_segment_sum: {ms:.4f} ms (plain on the card {plain:.4f} ms, "
        f"embedding_bag {lib:.4f} ms, bound {b:.4f} ms); {ms / lib:.2f} x embedding_bag's "
        f"time in this call")

    # K3a / K3b: every entry AMC recorded over path D, one (E, 32) tile set
    packed = [pack_ragged(t.miss_blocks, t.miss_offsets) for t in tables]
    tiles = torch.from_numpy(np.concatenate([p[0] for p in packed])).to(dev)
    counts = torch.from_numpy(np.concatenate([p[1] for p in packed])).to(dev)
    e_rows, w = tiles.shape
    ms = cuda_ms(lambda: basedelta_compress_tiles(tiles, counts), dev, reps=20)
    host = enqueue_us(lambda: basedelta_compress_tiles(tiles, counts), dev)
    plain = cuda_ms(lambda: basedelta_compress_plain(tiles, counts), dev, reps=20)
    deltas, mode = basedelta_compress_tiles(tiles, counts)
    e = max_err([deltas, mode], list(basedelta_compress_plain(tiles, counts)))
    check(e == 0, f"K3a on path D's entries: kernel != plain (max err {e})")
    errs["basedelta_compress_tiles"] = max(errs["basedelta_compress_tiles"], e)
    b, by = bound(e_rows * w * 8 + e_rows * 8, e_rows * w * 2)
    out.append(dict(common, name="basedelta_compress_tiles",
                    source="src/repro_torch/kernels/basedelta/csrc/basedelta.cu",
                    replaces="src/repro/kernels/basedelta/basedelta.py:42",
                    launches=launches["basedelta_compress_tiles"],
                    max_abs_err=errs["basedelta_compress_tiles"],
                    matches_plain=errs["basedelta_compress_tiles"] == 0, ms=ms, host_us=host, plain_ms=plain,
                    bound_ms=b, bound_by=by, shape=f"({e_rows}, {w}) int32 entry tiles"))
    log(f"  basedelta_compress_tiles: {ms:.4f} ms (plain {plain:.4f} ms, bound {b:.5f} ms)")

    base = tiles[:, 0].contiguous()
    route = decompress_route(deltas, torch.empty_like(deltas))
    ms = cuda_ms(lambda: basedelta_decompress_tiles(base, deltas), dev, reps=20)
    host = enqueue_us(lambda: basedelta_decompress_tiles(base, deltas), dev)
    plain = cuda_ms(lambda: basedelta_decompress_plain(base, deltas), dev, reps=20)
    lib = cuda_ms(lambda: base[:, None] + deltas, dev, reps=20)
    e = max_err([basedelta_decompress_tiles(base, deltas)],
                [basedelta_decompress_plain(base, deltas)])
    check(e == 0, f"K3b on path D's entries: kernel != plain (max err {e})")
    errs["basedelta_decompress_tiles"] = max(errs["basedelta_decompress_tiles"], e)
    b, by = bound(e_rows * w * 8 + e_rows * 4, e_rows * w)
    out.append(dict(common, name="basedelta_decompress_tiles",
                    source="src/repro_torch/kernels/basedelta/csrc/basedelta.cu",
                    replaces="src/repro/kernels/basedelta/basedelta.py:81",
                    launches=launches["basedelta_decompress_tiles"],
                    max_abs_err=errs["basedelta_decompress_tiles"],
                    matches_plain=errs["basedelta_decompress_tiles"] == 0, ms=ms, host_us=host,
                    plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
                    kernel_route=route, shape=f"({e_rows}, {w}) int32 entry tiles"))
    log(f"  basedelta_decompress_tiles ({route} route): {ms:.4f} ms (plain {plain:.4f} ms, "
        f"base[:, None] + deltas {lib:.4f} ms, bound {b:.5f} ms); {ms / lib:.2f} x the "
        f"library call's time in this call")
    return out


# ------------------------------------------------------------ phases 11-12

# The reduced LM against the JAX package's golden record, stated before any
# run: last-position logits and the first values of each cache component
# elementwise, each component's L2 norm and absolute sum relatively.  The
# serve steps are fed the record's previous token (so a near tie cannot
# carry over into later steps) and each must return one of the record's
# tokens within 1e-2 of its step's largest logit, ten times the logits
# tolerance: the record's greedy token, unless another lies that close.
LM_TOL = dict(rtol=1e-3, atol=1e-3)
LM_NORM_RTOL = 1e-4


def lm_config(record):
    """The reduced config of a golden LM record."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(record["arch"]).reduced(),
                               num_layers=record["num_layers"])


def cache_components(cache):
    """Named tensors of a hybrid prefill cache (g_states, g_k, g_v,
    t_states); the tail is absent without tail layers."""
    g_states, (g_k, g_v), t_states = cache
    out = dict(g_states=g_states, g_k=g_k, g_v=g_v)
    if t_states is not None:
        out["t_states"] = t_states
    return out


def lm_golden_run(record, dev):
    """The reduced LM of ``record`` on ``dev``: parameters from
    ``random_lm_tree``, ``prefill_step`` on the record's prompts, then
    ``serve_step`` from the prefill cache, fed the record's tokens.
    Returns ``(last logits, {component: tensor}, returned tokens (B,
    gen))``."""
    import numpy as np
    import torch

    from repro_torch.convert import lm_params_from_numpy, random_lm_tree
    from repro_torch.launch.steps import (
        decode_cache_from_prefill, make_prefill_step, make_serve_step,
    )

    cfg = lm_config(record)
    model = lm_params_from_numpy(cfg, random_lm_tree(cfg, record["param_seed"]), device=dev)
    tokens = torch.tensor(record["tokens"], dtype=torch.int32, device=dev)
    s, gen = record["prompt_len"], record["gen"]
    last, cache = make_prefill_step(cfg)(model, {"tokens": tokens[:, :s]})
    comps = cache_components(cache)
    dcache = decode_cache_from_prefill(cfg, cache, s, s + gen + 1)
    step = make_serve_step(cfg)
    fed = torch.cat([tokens[:, s:s + 1],
                     torch.tensor(record["gen_tokens"], dtype=torch.int32, device=dev)], dim=1)
    out = []
    for i in range(gen):
        tok, dcache = step(model, fed[:, i:i + 1], dcache)
        out.append(tok)
    return last, comps, torch.cat(out, dim=1).cpu().numpy().astype(np.int64)


def lm_golden_check(record, dev):
    """Phase 11 for one record: the port's run against the JAX package's
    golden values; returns the max abs error of the logits."""
    import numpy as np
    import torch

    last, comps, gen = lm_golden_run(record, dev)
    name = record["name"]
    err = close(last.float().cpu(), torch.tensor(record["last_logits"]), what=f"{name} logits",
                **LM_TOL)
    check(sorted(comps) == sorted(record["cache"]), f"{name}: cache components "
          f"{sorted(comps)} != {sorted(record['cache'])}")
    for k, want in record["cache"].items():
        t = comps[k].float().cpu()
        check(list(t.shape) == want["shape"], f"{name} {k}: shape {list(t.shape)} != {want['shape']}")
        close(t.flatten()[:len(want["head"])], torch.tensor(want["head"]), what=f"{name} {k} head",
              **LM_TOL)
        for stat, got in (("l2", float(t.double().norm())), ("abs_sum", float(t.double().abs().sum()))):
            rel = abs(got - want[stat]) / max(abs(want[stat]), 1e-30)
            check(rel <= LM_NORM_RTOL, f"{name} {k}: {stat} {got} vs {want[stat]} (rel {rel:.2e})")
    near = record["near_max_tokens"]
    for i in range(gen.shape[1]):
        for bi in range(gen.shape[0]):
            check(int(gen[bi, i]) in near[i][bi], f"{name}: step {i} sequence {bi} returned "
                  f"{int(gen[bi, i])}, not one of {near[i][bi]} (greedy {record['gen_tokens'][bi][i]})")
    same = int((gen == np.array(record["gen_tokens"])).sum())
    log(f"  {name}: logits max abs err {err:.3g} (rtol/atol 1e-3), cache "
        f"{', '.join(sorted(comps))} within {LM_NORM_RTOL:g}, serve-step tokens {same} of "
        f"{gen.size} == golden, all within 1e-2 of the largest logit "
        f"(smallest top-2 gap {record['min_top2_gap']:.3g})")
    return err


# Path F: zamba2-1.2b at full width.  The float32 cross-check holds the
# prefill (K5, K6) against the token-by-token decode path.  Both compute in
# float32 and differ in the order of their sums, and this randomly
# initialized 38-layer model amplifies such differences with depth, to about
# 1e-3 relative L2 in the logits.  The witness measures that level at the
# same shapes on the same card: the same prefill with the plain versions of
# K5 and K6 in the kernels' places (``repro_torch.launch.drift``).  The
# check is threefold, every reading a relative L2 error: layer 0's SSM state
# (one K6 call against 512 recurrence steps, nothing in front to amplify)
# within 1e-4; every cache component and the last logits within twice the
# witness's own distance from the decode; and all of them within 1e-2.  A
# fault of a kernel (a wrong mask, decay or state) gives errors of order 1.
# The one-ulp move of the embedding table is logged beside them.
XCHECK_FIRST_LAYER_REL_L2 = 1e-4
XCHECK_WITNESS_RATIO = 2.0
XCHECK_REL_L2 = 1e-2
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)


def capture(module, name, keep):
    """Replace ``module.name`` by a wrapper that keeps the first call's
    arguments in ``keep[name]``; returns the undo function."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        keep.setdefault(name, (args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, wrapped)
    return lambda: setattr(module, name, fn)


def path_f_prefill(cfg, model, tokens, dev, keep):
    """Phase 12.1: ``prefill_step`` on ``tokens`` (B, S); finite logits;
    the first K5 and K6 calls' inputs kept in ``keep``."""
    import torch

    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention, ssm

    step = make_prefill_step(cfg)
    undo = [capture(attention, "flash_attention", keep), capture(ssm, "ssd_scan", keep)]
    try:
        host, (last, cache) = host_ms(lambda: step(model, {"tokens": tokens}), dev)
    finally:
        for u in undo:
            u()
    check(bool(torch.isfinite(last).all()), "path F: non-finite prefill logits")
    comps = cache_components(cache)
    for k, t in comps.items():
        check(bool(torch.isfinite(t).all()), f"path F: non-finite prefill cache {k}")
    log(f"  prefill_step on {tuple(tokens.shape)} tokens: {host:.1f} ms host clock, logits "
        f"{tuple(last.shape)} finite, cache " + ", ".join(f"{k} {tuple(t.shape)}" for k, t in comps.items()))
    return step, host


def path_f_xcheck(cfg, tokens, seed, dev):
    """Phase 12.3: float32 full width, ``prefill_step`` on the prompts
    against the serve loop's cache and logits after the same tokens fed one
    by one, beside the witness (see XCHECK_*).  Returns the worst relative
    L2 error."""
    import dataclasses

    from repro_torch.launch.drift import prefill_decode_drift
    from repro_torch.models import init_params

    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model = init_params(cfg32, seed, device=dev)
    d = prefill_decode_drift(cfg32, model, tokens, seed)

    def fmt(x):
        if isinstance(x, dict):
            return json.dumps({k: float(f"{v:.3g}") for k, v in x.items()})
        return json.dumps([float(f"{v:.2g}") for v in x])

    errs, wit = d["prefill_vs_decode"], d["plain_vs_decode"]
    first = d["layer_state"][0]
    log(f"  float32 prefill vs token-by-token decode of the same ({tokens.shape[0]}, "
        f"{tokens.shape[1] - 1}) prompts (serve loop {d['decode_s']:.1f} s), relative L2: "
        f"kernels {fmt(errs)}; witness (plain versions) {fmt(wit)}; kernels vs witness "
        f"{fmt(d['prefill_vs_plain'])}; one-ulp move {fmt(d['one_ulp_move'])}; layer 0's "
        f"state {first:.3g}")
    log(f"  per Mamba layer, state vs decode: kernels {fmt(d['layer_state'])}")
    log(f"  per Mamba layer, state vs decode: witness {fmt(d['layer_state_plain'])}")
    check(first <= XCHECK_FIRST_LAYER_REL_L2,
          f"path F cross-check: layer 0's state differs by {first} > {XCHECK_FIRST_LAYER_REL_L2}")
    over = {k: v for k, v in errs.items() if v > XCHECK_WITNESS_RATIO * wit[k]}
    check(not over, f"path F cross-check: {over} more than {XCHECK_WITNESS_RATIO} x the "
          f"witness's {wit}")
    worst = max(errs.values())
    check(worst <= XCHECK_REL_L2, f"path F cross-check: relative L2 {errs} > {XCHECK_REL_L2}")
    return worst


def time_lm_kernels(keep, dev, errs, launches):
    """Phase 12.4: K5 and K6 on the inputs of their first calls in path F's
    bf16 prefill, held against their plain versions and timed with CUDA
    events beside the plain versions, the bound and the library call."""
    import torch

    from repro_torch.kernels.flash_attn.flash_attn import flash_attention
    from repro_torch.kernels.flash_attn.ref import blocked_attention_plain
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan

    out = []
    (q, k, v), kw = keep["flash_attention"]
    b, s, h, hd = q.shape
    causal, win = kw.get("causal", True), kw.get("sliding_window", 0)
    run = lambda: flash_attention(q, k, v, causal=causal, sliding_window=win)  # noqa: E731
    ms, host = cuda_ms(run, dev, reps=10), enqueue_us(run, dev)
    ref = blocked_attention_plain(q, k, v, causal, win)
    plain = cuda_ms(lambda: blocked_attention_plain(q, k, v, causal, win), dev, reps=2)
    e_attn = close(run(), ref, what="K5 at path F's shape", **ATTN_TOL[str(q.dtype)[6:]])
    errs["flash_attention"] = max(errs["flash_attention"], e_attn)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    gqa = {"enable_gqa": True} if k.shape[2] != h else {}
    lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, **gqa), dev, reps=10)
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)  # no window on this path
    flop = 4 * hd * pairs
    bnd, by = bound(4 * q.numel() * q.element_size(), flop, BF16_OPS_PER_S)
    f32 = time_k5_float32(b, h, hd, dev)
    out.append(dict(name="flash_attention", route="cuda",
                    source="src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
                    replaces="src/repro/kernels/flash_attn/flash_attn.py:70",
                    launches=launches["flash_attention"], max_abs_err=errs["flash_attention"],
                    path_f_max_abs_err=e_attn, ms=ms, host_us=host, plain_ms=plain,
                    bound_ms=bnd, bound_by=by, library_ms=lib, tflops=flop / ms * 1e-9,
                    float32_route=f32,
                    shape=f"q, k, v ({b}, {s}, {h}, {hd}) {str(q.dtype)[6:]}, causal"))
    log(f"  flash_attention: {ms:.3f} ms (plain {plain:.3f} ms, SDPA {lib:.3f} ms, "
        f"bound {bnd:.4f} ms by {by}); {flop / ms * 1e-9:.1f} TFLOP/s, "
        f"{ms / lib:.2f} x SDPA's time in this call; max abs err against the plain version "
        f"here {e_attn:.3g} (output rms {float(ref.float().pow(2).mean().sqrt()):.3g})")

    (x, dt, a, bm, cm), kw = keep["ssd_scan"]
    chunk = kw["chunk"]
    bsz, s, h, p = x.shape
    n = bm.shape[-1]
    run = lambda: ssd_scan(x, dt, a, bm, cm, chunk=chunk)  # noqa: E731
    ms, host = cuda_ms(run, dev, reps=10), enqueue_us(run, dev)
    ref = ssd_chunked_plain(x, dt, a, bm, cm, chunk)
    plain = cuda_ms(lambda: ssd_chunked_plain(x, dt, a, bm, cm, chunk), dev, reps=2)
    y, fin = run()
    e_ssd = max(close(y, ref[0], what="K6 at path F's shape: y", **SSD_TOL[str(x.dtype)[6:]]),
                close(fin, ref[1], what="K6 at path F's shape: state", **SSD_TOL["float32"]))
    errs["ssd_scan"] = max(errs["ssd_scan"], e_ssd)
    nc = -(-s // chunk)
    tri = chunk * (chunk + 1) // 2
    # C.B^T once per (batch, chunk) on the lower triangle, the masked
    # product per head, exp(cum) C.S and the state update per head
    ops = 2 * bsz * nc * (tri * n + h * (tri * p + 2 * chunk * n * p))
    nbytes = (2 * x.numel() * x.element_size() + dt.numel() * 4 + a.numel() * 4
              + 2 * bm.numel() * bm.element_size() + fin.numel() * 4)
    bnd, by = bound(nbytes, ops, BF16_OPS_PER_S)
    out.append(dict(name="ssd_scan", route="cuda",
                    source="src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                    replaces="src/repro/kernels/ssd_scan/ssd_scan.py:61",
                    launches=launches["ssd_scan"], max_abs_err=errs["ssd_scan"],
                    kernel_route=str(x.dtype)[6:],
                    path_f_max_abs_err=e_ssd, ms=ms, host_us=host, plain_ms=plain,
                    bound_ms=bnd, bound_by=by, library_ms=None,
                    shape=f"x ({bsz}, {s}, {h}, {p}) {str(x.dtype)[6:]}, B/C ({bsz}, {s}, {n}), "
                          f"chunk {chunk}"))
    log(f"  ssd_scan: {ms:.3f} ms (plain {plain:.3f} ms, bound {bnd:.4f} ms by {by}); max abs "
        f"err against the plain version here {e_ssd:.3g} (y rms "
        f"{float(ref[0].float().pow(2).mean().sqrt()):.3g})")
    return out


def time_k5_float32(b, h, hd, dev):
    """K5's float32 route (the tensor cores, three bf16 parts a side) at
    the cross-check's attention shape ((b, 512, h, hd), causal, random
    inputs from a seed), held against its plain version and timed beside
    SDPA in float32, with its two bounds: the float32 work at the CUDA
    cores' peak, and the split's bf16 products (six a product) at the
    tensor cores' peak, the lower of the two and the design it assumes."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attn.flash_attn import flash_attention
    from repro_torch.kernels.flash_attn.ref import blocked_attention_plain

    s = PATH_F_PROMPT
    q, k, v = k5_inputs(np.random.default_rng(8), b, s, s, h, h, hd, torch.float32, dev)
    run = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
    ms = cuda_ms(run, dev, reps=10)
    ref = blocked_attention_plain(q, k, v, True)
    err = close(run(), ref, what="K5 float32 route", **ATTN_TOL["float32"])
    plain = cuda_ms(lambda: blocked_attention_plain(q, k, v, True), dev, reps=3)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), dev, reps=10)
    flop = 4 * hd * b * h * (s * (s + 1) // 2)
    nbytes = 4 * q.numel() * 4
    f32_ms, _ = bound(nbytes, flop, FP32_OPS_PER_S)
    split_ms, split_by = bound(nbytes, 6 * flop, BF16_OPS_PER_S)
    log(f"  flash_attention float32 route (tensor cores, 3 bf16 parts a side) at ({b}, {s}, {h}, "
        f"{hd}), causal: {ms:.4f} ms (plain {plain:.3f} ms, SDPA in float32 {lib:.4f} ms; bound "
        f"{split_ms:.4f} ms: {6 * flop / 1e9:.1f} GFLOP of bf16 products at 989 TFLOP/s; "
        f"{f32_ms:.4f} ms for {flop / 1e9:.2f} GFLOP at 67 TFLOP/s), "
        f"{flop / ms * 1e-9:.1f} TFLOP/s of float32 work; max abs err against the plain version "
        f"{err:.3g}")
    return dict(design="tensor cores: mma.sync m16n8k16, scaled Q, K, P and V each in 3 bf16 "
                       "parts, 6 products a product",
                shape=f"({b}, {s}, {h}, {hd}) float32, causal", ms=ms, plain_ms=plain,
                library_ms=lib, max_abs_err=err, bound_ms=min(split_ms, f32_ms),
                bound_by=split_by,
                bound_note="bf16 products of the 3-part split at the tensor cores' peak; the "
                           "float32 work at the CUDA cores' peak is bound_f32_ms",
                bound_f32_ms=f32_ms, bound_split_ms=split_ms, tflops=flop / ms * 1e-9)


def profile_share(what, fn, dev):
    """Log ``fn``'s wall time, device events and device busy share under
    ``torch.profiler``, and its top kernels."""
    wall, busy, top, events = device_share(fn, dev)
    if busy:
        log(f"  {what} under torch.profiler: {wall * 1e3:.1f} ms wall, {events} device events, "
            f"device busy {busy * 1e3:.1f} ms ({100 * busy / wall:.2f} %), "
            f"idle {100 * (1 - busy / wall):.2f} %")
    else:
        log(f"  {what} under torch.profiler: {wall * 1e3:.1f} ms wall; the profiler "
            "recorded no device time (busy share not measured)")
    for name, count, kms in top:
        log(f"    {kms:10.3f} ms  {count:5d} x  {name}")


PATH_F_SEED = 0
PATH_F_BATCH = 4
PATH_F_PREFILL = 4096  # tokens per prompt of the prefill
PATH_F_PROMPT = 512  # tokens per prompt of the serve loop
PATH_F_GEN = 32


def path_f(dev, run_path, errs, totals):
    """Phase 12: main path F.  Returns the K5 and K6 entries of the
    kernels line."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompt_tokens, serve_loop
    from repro_torch.models import decode_step, init_cache, init_params, padded_vocab

    cfg = get_config("zamba2_1p2b")
    every = cfg.hybrid_attn_every
    exact = dict(flash_attention=cfg.num_layers // every, ssd_scan=cfg.num_layers)
    lm = tuple(exact)
    t0 = time.perf_counter()
    model = init_params(cfg, PATH_F_SEED, device=dev)
    sync(dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}: {n_params:,} parameters in {cfg.param_dtype} "
        f"({n_params * 2 / 1e9:.2f} GB), drawn on the card in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(PATH_F_SEED)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (PATH_F_BATCH, PATH_F_PREFILL))
                               .astype(np.int32)).to(dev)
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan

    keep = {}
    torch.cuda.reset_peak_memory_stats(dev)
    routes = dict(ssd_scan.routes)
    step, host = run_path("F prefill", lm, lambda: path_f_prefill(cfg, model, prompts, dev, keep),
                          exact=exact)
    ran = {r: ssd_scan.routes[r] - routes[r] for r in routes}
    check(ran == {"bfloat16": exact["ssd_scan"], "float32": 0},
          f"path F prefill: K6 launches by route {ran}, expected all {exact['ssd_scan']} on the "
          "bfloat16 tensor-core route")
    log(f"  K6 launches by route on the prefill {json.dumps(ran)}")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    batch = {"tokens": prompts}
    ms = cuda_ms(lambda: step(model, batch), dev, reps=3)
    toks = PATH_F_BATCH * PATH_F_PREFILL
    log(f"  prefill_step: {ms:.1f} ms by CUDA events ({toks / ms * 1e3:,.0f} tokens/s), "
        f"{host:.1f} ms host clock on the first call, peak memory {peak:.2f} GB")
    profile_share("prefill_step", lambda: step(model, batch), dev)
    del batch, prompts

    tokens = prompt_tokens(np.random.default_rng(PATH_F_SEED), cfg.vocab_size, PATH_F_BATCH,
                           PATH_F_PROMPT)
    res = run_path("F serve", (), lambda: serve_loop(cfg, model, tokens, PATH_F_GEN))
    check(res.gen.shape == (PATH_F_BATCH, PATH_F_GEN), f"path F serve: tokens {res.gen.shape}")
    check(bool(((res.gen >= 0) & (res.gen < padded_vocab(cfg.vocab_size))).all()),
          "path F serve: token ids out of the padded vocabulary")
    check(bool(torch.isfinite(res.prompt_logits).all()), "path F serve: non-finite logits")
    log(f"  serve loop: {PATH_F_BATCH} requests, {PATH_F_PROMPT} prompt tokens fed in "
        f"{res.prefill_s:.2f} s ({PATH_F_PROMPT / res.prefill_s:.1f} steps/s), {PATH_F_GEN} "
        f"tokens generated in {res.decode_s:.2f} s "
        f"({PATH_F_BATCH * PATH_F_GEN / res.decode_s:.1f} tokens/s); sample {res.gen[0, :8].tolist()}")
    cache = init_cache(cfg, PATH_F_BATCH, PATH_F_PROMPT + PATH_F_GEN + 1, device=dev)
    tok = torch.from_numpy(tokens[:, :1]).to(dev)
    decode_step(cfg, model, tok, cache)
    profile_share("one decode step", lambda: decode_step(cfg, model, tok, cache), dev)
    del model, res, cache
    torch.cuda.empty_cache()

    run_path("F float32 cross-check", lm,
             lambda: path_f_xcheck(cfg, tokens[:, :PATH_F_PROMPT + 1], PATH_F_SEED, dev),
             exact={k: 2 * n for k, n in exact.items()})  # two prefills
    torch.cuda.empty_cache()
    return time_lm_kernels(keep, dev, errs, totals)


# ------------------------------------------------------------ phase 13
def parse_workload(name: str):
    """``"kernel/dataset#sSEED"`` -> (kernel, dataset, seed)."""
    kd, seed = name.split("#s")
    kernel, dataset = kd.split("/")
    return kernel, dataset, int(seed)


def score_breakdown(run_trace) -> dict:
    """Seconds of ``score``'s parts from the spans of one traced run: the
    prefetchers' streams (``score_cell`` children, by prefetcher), the K1
    passes (``cache_pass[...]`` children: launch, device and the copy back)
    and the rest (merging the streams, ``classify_prefetch_events``,
    ``evaluate``: host numpy).  Where a family is scored one stream at a
    time (one prefetcher, or an engine that does not batch) the streams are
    not a child span and count in the rest."""
    by_parent = {}
    for sp in run_trace.spans:
        by_parent.setdefault(sp.parent_id, []).append(sp)
    out = dict(score=0.0, cache_passes=0.0, rest=0.0, streams={})
    for sp in run_trace.by_name("score"):
        out["score"] += sp.dur
        inner = 0.0
        for child in by_parent.get(sp.span_id, []):
            inner += child.dur
            if child.name == "score_cell":
                name = child.attrs["prefetcher"]
                out["streams"][name] = out["streams"].get(name, 0.0) + child.dur
            elif child.name.startswith("cache_pass"):
                out["cache_passes"] += child.dur
        out["rest"] += sp.dur - inner
    return out


def experiment_cell(name: str, gold: dict, dev, cache=None, workers=1, trace_dir=None):
    """Run one golden cell through ``repro_torch.core.Experiment`` on
    ``dev`` (``run(workers=workers)``; a dir-backed trace under
    ``trace_dir`` also gathers the workers' spans) and hold every row and
    workload record against the JAX package's; log its stage seconds,
    ``score``'s parts and the artifact spans.  Returns the
    ``ExperimentResult`` with ``stage_seconds``, ``span_seconds`` and
    ``run_trace`` attached."""
    import numpy as np
    import torch

    from repro_torch import memsim
    from repro_torch.core import Experiment, WorkloadSpec
    from repro_torch.core.exec import collect_stages
    from repro_torch.core.obs import trace

    hierarchy = getattr(memsim, gold["hierarchy"])
    specs = [WorkloadSpec(k, d, hierarchy=hierarchy, seed=s)
             for k, d, s in map(parse_workload, gold["workloads"])]
    t0 = time.perf_counter()
    with collect_stages() as stages, trace(dir=trace_dir) as tracer:
        res = Experiment(workloads=specs, prefetchers=gold["prefetchers"], cache=cache,
                         device=dev).run(workers=workers)
    sync(dev)
    secs = time.perf_counter() - t0
    want_device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    check(res.telemetry["manifest"]["device"] == want_device,
          f"{name}: the manifest names {res.telemetry['manifest']['device']}")
    rows = jsonable(res.rows())
    check(len(rows) == len(gold["rows"]), f"{name}: {len(rows)} rows, golden {len(gold['rows'])}")
    for got, want in zip(rows, gold["rows"]):
        check(all(np.isfinite(v) for v in got.values() if isinstance(v, float)),
              f"{name}: non-finite metric in {got['kernel']}/{got['prefetcher']}")
        if got != want:
            diff = {k: (got.get(k), want.get(k)) for k in want if got.get(k) != want.get(k)}
            raise SmokeError(f"{name}: row {want['kernel']}#s{want['seed']}/{want['prefetcher']} "
                             f"differs from golden: {diff}")
    for wname, want in gold["workload_records"].items():
        w = res.workload(*parse_workload(wname))
        check(w.device.type == dev.type, f"{name}: {wname} on {w.device}, expected {dev}")
        got = dict(iterations=len(w.iter_epochs), accesses=w.num_accesses,
                   eval_from_pos=int(w.eval_from_pos),
                   levels_sha256=hashlib.sha256(demand_levels(w.profile).tobytes()).hexdigest())
        check(got == want, f"{name}: {wname} {got} != golden {want}")
    log(f"  {name}: {len(rows)} rows == golden ({', '.join(gold['prefetchers'])}; "
        f"{len(specs)} workloads), {secs:.2f} s; workload cache "
        + json.dumps(res.telemetry["workload_cache"]))
    log("  stage seconds " + json.dumps({k: round(v, 4) for k, v in sorted(stages.items())}))
    parts = score_breakdown(tracer.result)
    log("  score's parts, seconds " + json.dumps(
        {k: round(v, 4) if isinstance(v, float) else {p: round(t, 4) for p, t in v.items()}
         for k, v in parts.items()}))
    totals = tracer.result.stage_totals()
    log("  span seconds " + json.dumps({k: round(totals[k], 4) for k in
                                        ("build_workload", "artifact_save", "artifact_load")
                                        if k in totals}))
    res.stage_seconds, res.span_seconds, res.run_trace = dict(stages), totals, tracer.result
    return res


def resident_bytes(obj, seen=None) -> int:
    """Bytes of the numpy arrays a (nested) dataclass holds, each once."""
    import dataclasses

    import numpy as np

    seen = set() if seen is None else seen
    if isinstance(obj, np.ndarray):
        if id(obj) in seen:
            return 0
        seen.add(id(obj))
        return obj.nbytes
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(resident_bytes(getattr(obj, f.name), seen) for f in dataclasses.fields(obj))
    return 0


def phase13(grid: dict, dev, run_path) -> dict:
    """Every cell of ``tests/data/torch_port_golden_grid.json`` through
    ``Experiment`` on the card; then ``G`` again from the artifact cache
    its first run filled.  Returns what the scheduler's cost model takes
    from G cold and warm: accesses, build, score and load seconds, the
    artifacts' bytes and the traces' resident bytes."""
    import os
    import tempfile

    from repro_torch.core import ArtifactCache, WorkloadCache

    t0 = time.perf_counter()
    graph = ("lru_hits", "fused_levels")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_artifacts_") as tmp:
        cold = WorkloadCache(artifacts=ArtifactCache(tmp))
        res_g = run_path("G", graph + ("segment_sum",),
                         lambda: experiment_cell("G", grid["G"], dev, cold))
        check((cold.builds, cold.loads) == (9, 0), f"G cold: {cold.builds} builds, {cold.loads} loads")
        traces = list(res_g.workloads.values())
        calib = dict(
            accesses=sum(w.num_accesses for w in traces),
            prefetchers=len(grid["G"]["prefetchers"]),
            build_s=res_g.stage_seconds["trace_gen"] + res_g.stage_seconds["demand_sim"]
            + res_g.span_seconds["artifact_save"],
            score_s=res_g.stage_seconds["score"],
            artifact_bytes=sum(p.stat().st_size for p in Path(tmp).glob("*.npz")),
            trace_bytes=sum(resident_bytes(w) for w in traces),
        )
        del res_g, traces
        for engine, expect in (("fused", graph + ("segment_sum",)),
                               ("set_parallel", ("lru_hits", "segment_sum"))):
            os.environ["REPRO_TORCH_CACHE_ENGINE"] = engine
            try:
                run_path(f"G-fused ({engine})", expect,
                         lambda: experiment_cell(f"G-fused ({engine})", grid["G-fused"], dev),
                         exact={"fused_levels": 0} if engine == "set_parallel" else None)
            finally:
                del os.environ["REPRO_TORCH_CACHE_ENGINE"]
        for name in ("G-quick", "G-tableI"):
            run_path(name, graph + ("segment_sum",), lambda: experiment_cell(name, grid[name], dev))
        run_path("H", graph, lambda: experiment_cell("H", grid["H"], dev))
        warm = WorkloadCache(artifacts=ArtifactCache(tmp))
        res_w = run_path("G warm", ("lru_hits",),
                         lambda: experiment_cell("G (warm artifacts)", grid["G"], dev, warm),
                         exact={"fused_levels": 0, "segment_sum": 0})
        check((warm.loads, warm.builds) == (9, 0),
              f"G warm: {warm.loads} loads, {warm.builds} builds, expected 9 and 0")
        calib["load_s"] = res_w.span_seconds["artifact_load"]
    log(f"  phase 13 seconds {time.perf_counter() - t0:.1f}")
    return calib


# ------------------------------------------------------------ phase 14
SHARD_MANIFEST_KEYS = ("kernel", "dataset", "seed", "num_accesses", "shard_accesses",
                       "shard_sizes", "iter_epochs", "eval_from_pos", "num_vertices",
                       "num_edges", "base")


def sharded_specs(cell: dict) -> list:
    """A cell's workloads: ``"kernel/dataset#sSEED"``, with ``"@N"`` for a
    ``ShardedSpec`` of N accesses a shard."""
    from repro_torch import memsim
    from repro_torch.core import WorkloadSpec
    from repro_torch.core.exec.sharded import ShardedSpec

    specs = []
    for name in cell["workloads"]:
        name, _, shard = name.partition("@")
        kernel, dataset, seed = parse_workload(name)
        base = WorkloadSpec(kernel, dataset, seed=seed,
                            hierarchy=getattr(memsim, cell["hierarchy"]))
        specs.append(ShardedSpec(base, int(shard)) if shard else base)
    return specs


def shard_manifest(arts, spec) -> dict:
    """The manifest's identity fields and a sha256 of each shard's blocks."""
    import numpy as np

    m = arts.load_manifest(spec)
    check(m is not None and arts.has(spec), f"no committed shard store for {spec}")
    rec = {k: m[k] for k in SHARD_MANIFEST_KEYS}
    rec["block_sha256"] = [
        hashlib.sha256(np.ascontiguousarray(arts.load_shard(spec, i)["block"]).tobytes()).hexdigest()
        for i in range(len(m["shard_sizes"]))
    ]
    return rec


def sharded_cell(name: str, gold: dict, dev, root: Path, workers=1):
    """Run one cell of ``tests/data/torch_port_golden_sharded.json``
    through ``Experiment(...).run(workers=workers)`` on ``dev`` from a fresh
    artifact root, and hold its rows and every shard manifest against the
    JAX package's.  Logs the stage seconds and the sharded spans (build,
    phase 1 and its K2 passes, each replay); returns the rows."""
    from repro_torch.core import ArtifactCache, Experiment, WorkloadCache
    from repro_torch.core.exec import collect_stages
    from repro_torch.core.obs import trace

    specs = sharded_specs(gold)
    arts = ArtifactCache(root)
    t0 = time.perf_counter()
    with collect_stages() as stages, trace() as tracer:
        res = Experiment(workloads=specs, prefetchers=gold["prefetchers"],
                         cache=WorkloadCache(artifacts=arts), device=dev).run(workers=workers)
    sync(dev)
    secs = time.perf_counter() - t0
    rows = jsonable(res.rows())
    for got, want in zip(rows, gold["rows"]):
        if got != want:
            diff = {k: (got.get(k), want.get(k)) for k in want if got.get(k) != want.get(k)}
            raise SmokeError(f"{name}: row {want['kernel']}/{want['dataset']}/"
                             f"{want['prefetcher']} differs from golden: {diff}")
    check(len(rows) == len(gold["rows"]), f"{name}: {len(rows)} rows, golden {len(gold['rows'])}")
    for wname, spec in zip(gold["workloads"], specs):
        if wname in gold["manifests"]:
            got = shard_manifest(arts, spec)
            check(got == gold["manifests"][wname], f"{name}: {wname}'s manifest differs from golden")
    sp = tracer.result.stage_totals()
    replays = {}
    for r in tracer.result.by_name("sharded_replay"):
        replays[r.attrs["prefetcher"]] = replays.get(r.attrs["prefetcher"], 0.0) + r.dur
    parts = dict(total=secs, build=sp.get("ensure_shards", 0.0),
                 score=stages.get("score", 0.0), phase1=sp.get("sharded_sweep", 0.0),
                 phase1_demand=sp.get("shard_demand", 0.0),
                 k1_passes=stages.get("cache_pass[l2]", 0.0) + stages.get("cache_pass[llc]", 0.0),
                 replays=replays)
    log(f"  {name}: {len(rows)} rows and {len(gold['manifests'])} manifests == golden "
        f"(workers={workers}), {secs:.2f} s; seconds " + json.dumps(
            {k: round(v, 3) if isinstance(v, float) else {a: round(b, 3) for a, b in v.items()}
             for k, v in parts.items()}))
    return rows


class RssPeak:
    """The largest ``VmRSS`` of this process, read from ``/proc/self/status``
    every 50 ms by a thread while the block runs (``kib``; None where the
    file has no ``VmRSS``)."""

    def __init__(self):
        import threading

        self.kib, self._stop = None, threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def read():
        try:
            return int(Path("/proc/self/status").read_text().split("VmRSS:")[1].split()[0])
        except (OSError, IndexError, ValueError):
            return None

    def _run(self):
        while True:
            now = self.read()
            if now is not None:
                self.kib = max(self.kib or 0, now)
            if self._stop.wait(0.05):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def _warm_worker(device: str, barrier: str, n: int):
    """A pool worker's start: import the port, open a CUDA context, load
    the graph path's kernels; then wait for all ``n`` workers (a file each
    under ``barrier``) and report the card's free memory."""
    import os

    import torch

    from repro_torch.core.exec.scheduler import graph_kernel_sources
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    dev = resolve_device(device)
    torch.zeros(1, device=dev)
    for src in graph_kernel_sources():
        build.load(src)
    Path(barrier, str(os.getpid())).touch()
    deadline = time.time() + 300
    while len(os.listdir(barrier)) < n and time.time() < deadline:
        time.sleep(0.01)
    return os.getpid(), torch.cuda.mem_get_info(dev)[0]


def spawn_times(dev, root: Path) -> dict:
    """Seconds until a spawned pool of P workers (P = 1, 2) has every
    worker started as the scheduler's workers start (``_spawn_pool``), and
    the card's free memory each worker's context takes; fits t(P) = base +
    P x per_worker."""
    import numpy as np
    import torch

    from repro_torch.core import ArtifactCache
    from repro_torch.core.exec import scheduler

    out = {}
    for n in (1, 2):
        barrier = root / f"barrier{n}"
        barrier.mkdir(parents=True)
        free0 = torch.cuda.mem_get_info(dev)[0]
        t0 = time.perf_counter()
        with scheduler._spawn_pool(ArtifactCache(root), n, n, dev) as pool:
            got = [f.result() for f in [pool.submit(_warm_worker, str(dev), str(barrier), n)
                                        for _ in range(n)]]
            t = time.perf_counter() - t0
        check(len({pid for pid, _ in got}) == n, f"spawn timing: {n} tasks ran in "
              f"{len({pid for pid, _ in got})} workers")
        out[n] = dict(seconds=t, context_bytes=(free0 - min(f for _, f in got)) / n,
                      with_shutdown=time.perf_counter() - t0)
    ps = np.array(sorted(out), dtype=float)
    per_worker, base = np.polyfit(ps, [out[int(p)]["seconds"] for p in ps], 1)
    log("  spawn seconds " + json.dumps({n: {k: round(v, 3) for k, v in d.items()}
                                         for n, d in out.items()})
        + f"; fit t(P) = {base:.3f} + {per_worker:.3f} P")
    return dict(base=float(base), per_worker=float(per_worker),
                context_bytes=float(np.median([d["context_bytes"] for d in out.values()])))


def phase14(gold: dict, grid: dict, dev, run_path, calib: dict):
    """Sharded and parallel on the card: S-parity under both engines and
    beside its unsharded rows, S-full at paper scale, the scheduler's pool
    (G cold under ``workers=2``, then ``workers=None`` warm; the mixed
    grid under ``workers=2`` and 1), and the spawn timing; then the cost
    model's constants from this run."""
    import os
    import resource
    import tempfile

    import torch

    t0 = time.perf_counter()
    graph = ("lru_hits", "fused_levels")
    no_launch = dict(lru_hits=0, fused_levels=0, segment_sum=0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_phase14_") as tmp:
        tmp = Path(tmp)
        rows_by_engine = {}
        for engine, expect, exact in (("fused", graph, None),
                                      ("set_parallel", ("lru_hits",), {"fused_levels": 0})):
            os.environ["REPRO_TORCH_CACHE_ENGINE"] = engine
            try:
                rows_by_engine[engine] = run_path(
                    f"S-parity ({engine})", expect,
                    lambda: sharded_cell(f"S-parity ({engine})", gold["S-parity"], dev,
                                         tmp / f"parity-{engine}"), exact=exact)
            finally:
                del os.environ["REPRO_TORCH_CACHE_ENGINE"]
        plain = dict(gold["S-parity"], workloads=["bfs/comdblp#s0"], manifests={})
        plain_rows = run_path("S-parity unsharded", graph, lambda: sharded_cell(
            "S-parity unsharded", dict(plain, rows=gold["S-parity"]["rows"]), dev, tmp / "plain"))
        check(plain_rows == rows_by_engine["fused"] == rows_by_engine["set_parallel"],
              "S-parity: sharded rows differ from the unsharded rows")

        rss0 = RssPeak.read()
        torch.cuda.reset_peak_memory_stats(dev)
        with RssPeak() as rss:
            run_path("S-full", graph, lambda: sharded_cell("S-full", gold["S-full"], dev,
                                                           tmp / "full"))
        peak_dev = torch.cuda.max_memory_allocated(dev)
        manifest = gold["S-full"]["manifests"]["bfs/road-8m#s0@4194304"]
        log(f"  S-full: {manifest['num_accesses']:,} accesses in {len(manifest['shard_sizes'])} "
            f"shards; ru_maxrss {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} KiB "
            f"(the process's life); VmRSS {rss0} KiB before S-full, at most {rss.kib} KiB "
            f"during it (sampled every 50 ms); torch.cuda.max_memory_allocated {peak_dev:,} B")

        p_root = tmp / "pool"
        from repro_torch.core import ArtifactCache, WorkloadCache

        res = run_path("P: G workers=2", (), lambda: experiment_cell(
            "P: G workers=2 (cold)", grid["G"], dev, WorkloadCache(artifacts=ArtifactCache(p_root)),
            workers=2, trace_dir=tmp / "trace-P"), exact=no_launch)
        tasks = res.run_trace.by_name("run_task") + res.run_trace.by_name("materialize")
        builds = [sp for sp in res.run_trace.by_name("materialize") if sp.attrs.get("cache") == "build"]
        pids = {sp.pid for sp in tasks}
        check(len(builds) == 9 and os.getpid() not in pids and len(pids) == 2,
              f"P: {len(builds)} builds in workers {sorted(pids)}, expected 9 in 2 workers")
        check(all(sp.attrs["device"] == str(dev) for sp in res.run_trace.by_name("run_task")),
              "P: a worker ran off the card")
        log(f"  P: workers {sorted(pids)} built 9 workloads and ran "
            f"{len(res.run_trace.by_name('run_task'))} score tasks on {dev}; their K2 launches "
            f"{res.run_trace.metrics['counters'].get('fused.launches', 0):.0f}")
        res = run_path("P: G workers=None", (), lambda: experiment_cell(
            "P: G workers=None (warm)", grid["G"], dev, WorkloadCache(artifacts=ArtifactCache(p_root)),
            workers=None))
        check(res.sched is not None and {"mode", "workers", "reason"} <= set(res.sched),
              f"P: run() gave no scheduler decision: {res.sched}")
        log("  P: sched " + json.dumps(res.sched))
        del res
        mixed = {}
        for workers in (2, 1):
            mixed[workers] = run_path(
                f"P: mixed workers={workers}", () if workers > 1 else graph,
                lambda: sharded_cell(f"P: mixed workers={workers}", gold["mixed"], dev,
                                     tmp / f"mixed{workers}", workers=workers),
                exact=no_launch if workers > 1 else None)
        check(mixed[2] == mixed[1] and mixed[1][:2] == mixed[1][2:],
              "P: the mixed grid's rows differ between workers=2 and 1, or sharded from unsharded")
        spawn = spawn_times(dev, tmp / "spawn")

    shard = manifest["shard_accesses"]
    consts = dict(
        BUILD_S_PER_ACCESS=calib["build_s"] / calib["accesses"],
        SCORE_S_PER_ACCESS=calib["score_s"] / (calib["accesses"] * calib["prefetchers"]),
        LOAD_S_PER_ACCESS=calib["load_s"] / calib["accesses"],
        ARTIFACT_BYTES_PER_ACCESS=calib["artifact_bytes"] / calib["accesses"],
        TRACE_BYTES_PER_ACCESS=calib["trace_bytes"] / calib["accesses"],
        DEVICE_BYTES_PER_ACCESS=peak_dev / shard,
        SPAWN_BASE_S=spawn["base"],
        SPAWN_PER_WORKER_S=spawn["per_worker"],
        CUDA_CONTEXT_BYTES=spawn["context_bytes"],
    )
    log("  cost model from this run " + json.dumps({k: float(f"{v:.4g}") for k, v in consts.items()})
        + f" (G: {calib['accesses']:,} accesses)")
    log(f"  phase 14 seconds {time.perf_counter() - t0:.1f}")


# ------------------------------------------------------------ phase 15
STAGES_15 = ("update_apply", "trace_epoch", "table_carry",
             "serve_interleave", "serve_llc", "serve_score")
DRIFT = dict(kernel="pgd", dataset="comdblp", epochs=6, policies=("persist", "reset"),
             prefetchers=["amc", "vldp", "nextline2"])
CONTENTION = dict(tenants=[("pgd", "comdblp", 0), ("cc", "comdblp", 0), ("pgd", "comdblp", 1)],
                  prefetchers=["amc", "vldp", "nextline2"])


def cell_workloads(cell: dict) -> list:
    """The stream or serve specs of a cell of
    ``tests/data/torch_port_golden_stream_serve.json`` (its declaration:
    StreamSpec fields with the churn as ``[kind, parameters]``, or ServeSpec
    fields with TenantSpec fields for the tenants; hierarchies by name)."""
    from repro_torch import memsim
    from repro_torch.serve import ServeSpec, TenantSpec
    from repro_torch.stream import CHURN_MODELS, StreamSpec

    if "serve" in cell:
        sv = cell["serve"]
        return [ServeSpec(tenants=tuple(TenantSpec(**t) for t in sv["tenants"]),
                          policy=sv["policy"], table_modes=tuple(sv["table_modes"]),
                          hierarchy=getattr(memsim, sv["hierarchy"]))]
    specs = []
    for st in cell["streams"]:
        kind, params = st["churn"]
        fields = {k: v for k, v in st.items() if k not in ("churn", "hierarchy")}
        specs.append(StreamSpec(churn=CHURN_MODELS[kind](**params),
                                hierarchy=getattr(memsim, st["hierarchy"]), **fields))
    return specs


def drift_document(result, streams, policies, parity=None) -> dict:
    """The drift JSON of ``examples/streaming_drift.py`` from a stream
    run's cells: one ``drift_payload`` per policy merged into one document,
    AMC keyed per policy, stateless baselines once."""
    from repro_torch.stream import drift_payload

    merged = None
    for spec in streams:
        epoch_set = set(spec.epoch_specs())
        seen, cells = set(), []
        for c in result.cells:
            if c.epoch is None or c.spec not in epoch_set:
                continue
            if c.lifecycle is not None and c.lifecycle != spec.lifecycle:
                continue  # another policy's lifecycle-carried cells
            key = (c.prefetcher, c.epoch)
            if key in seen:
                continue  # stateless baseline, already scored identically
            seen.add(key)
            cells.append(c)
        doc = drift_payload(spec, spec.sequence(), cells)
        if merged is None:
            merged = {**doc, "lifecycle": ",".join(policies), "prefetchers": {}}
        for name, pf in doc["prefetchers"].items():
            key = f"{name}[{pf['lifecycle']}]" if pf["lifecycle"] else name
            merged["prefetchers"][key] = pf
    if parity is not None:
        merged["parallel_matches_serial"] = parity
    return merged


def contention_document(result, spec, parity=None) -> dict:
    """The contention JSON of ``examples/serving_contention.py`` from a
    serve run's cells."""
    from repro_torch.serve import ServeCell, contention_payload

    wspecs = spec.tenant_workloads()
    cells = [ServeCell(tenant=c.tenant, prefetcher=c.prefetcher, table_mode=c.table_mode,
                       metrics=c.metrics, spec=wspecs[c.tenant]) for c in result.cells]
    doc = contention_payload(spec, cells)
    if parity is not None:
        doc["parallel_matches_serial"] = parity
    return doc


class SharedLlcClock:
    """Seconds and K1 launches of the serving protocol's shared-LLC work,
    by part: ``_share_llc`` in all (merge keys from the interleave, the
    patched outcomes), of it ``shared_llc_pass`` (shift, concatenate,
    stable argsort, scatter back), of that ``cache_pass`` (K1 with its
    group-by-set and copies).  Wraps the three names where they are looked
    up while it is entered."""

    def __init__(self):
        self.launches, self.share_s, self.pass_s, self.k1_s = 0, 0.0, 0.0, 0.0

    def _timed(self, fn, field, count=False):
        from repro_torch.kernels.cache_sim.ops import lru_hits

        def wrapped(*args, **kw):
            n0, t0 = lru_hits.launches, time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                setattr(self, field, getattr(self, field) + time.perf_counter() - t0)
                if count:
                    self.launches += lru_hits.launches - n0
        return wrapped

    def __enter__(self):
        from repro_torch.memsim import shared_llc
        from repro_torch.serve import protocol

        self._saved = (protocol._share_llc, protocol.shared_llc_pass, shared_llc.cache_pass)
        protocol._share_llc = self._timed(protocol._share_llc, "share_s")
        protocol.shared_llc_pass = self._timed(protocol.shared_llc_pass, "pass_s")
        shared_llc.cache_pass = self._timed(shared_llc.cache_pass, "k1_s", count=True)
        return self

    def __exit__(self, *exc):
        from repro_torch.memsim import shared_llc
        from repro_torch.serve import protocol

        protocol._share_llc, protocol.shared_llc_pass, shared_llc.cache_pass = self._saved

    def snapshot(self):
        return (self.launches, self.share_s, self.pass_s, self.k1_s)


def protocol_cell(name: str, specs, prefetchers, dev, root: Path, workers=1, llc=None):
    """Run stream / serve ``specs`` through ``repro_torch.core.Experiment``
    on ``dev`` from the artifact root ``root``; log the host seconds, the
    stream and serve stages, the artifact spans, the shared-LLC parts (from
    the entered :class:`SharedLlcClock` ``llc``) and the card's peak
    allocation.  Returns the ``ExperimentResult``."""
    import numpy as np
    import torch

    from repro_torch.core import ArtifactCache, Experiment, WorkloadCache
    from repro_torch.core.exec import collect_stages
    from repro_torch.core.obs import trace

    if dev.type == "cuda":
        torch.empty(0, device=dev)  # the allocator's stats need a context
        torch.cuda.reset_peak_memory_stats(dev)
    llc0 = llc.snapshot() if llc is not None else None
    cache = WorkloadCache(artifacts=ArtifactCache(root))
    t0 = time.perf_counter()
    with collect_stages() as stages, trace() as tracer:
        res = Experiment(workloads=specs, prefetchers=prefetchers, cache=cache,
                         device=dev).run(workers=workers)
    sync(dev)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rows = res.rows()
    check(len(rows) > 0 and all(np.isfinite(v) for r in rows for v in r.values()
                                if isinstance(v, float)), f"{name}: no rows or a non-finite metric")
    log(f"  {name}: {len(rows)} rows in {secs:.2f} s (workers={workers}); trace_reuse "
        f"{res.trace_reuse}; workload cache " + json.dumps(res.telemetry["workload_cache"]))
    log("  stage seconds " + json.dumps({k: round(stages.get(k, 0.0), 4) for k in STAGES_15}
                                        | {k: round(stages[k], 4) for k in ("trace_gen",
                                                                            "demand_sim", "score")
                                           if k in stages}))
    totals = tracer.result.stage_totals()
    log("  span seconds " + json.dumps({k: round(totals[k], 4) for k in
                                        ("artifact_save", "artifact_load") if k in totals}))
    if llc is not None and "serve_llc" in stages:
        n, share, pss, k1 = (b - a for a, b in zip(llc0, llc.snapshot()))
        log(f"  shared LLC: {n} K1 launches; seconds _share_llc {share:.4f} (merge keys and "
            f"patching {share - pss:.4f}; shared_llc_pass {pss:.4f}: its host merge "
            f"{pss - k1:.4f}, cache_pass {k1:.4f})")
    log(f"  torch.cuda.max_memory_allocated {peak:,} B")
    res.seconds, res.stage_seconds = secs, dict(stages)
    return res


def phase15(gold: dict, dev, run_path):
    """Stream and serve protocols through ``Experiment`` on the card, each
    cell from a fresh artifact root: ST-drift and SV-contention against the
    committed ``results/`` documents (each then under ``workers=2``, whose
    rows must equal the serial rows), ST-full, SV-full, ST-models and
    SV-rate against ``tests/data/torch_port_golden_stream_serve.json``, and
    the zero-churn stream's ``trace_reuse`` cold and warm."""
    import tempfile

    from repro_torch.core.exec.scheduler import rows_equal
    from repro_torch.serve import ServeSpec, TenantSpec
    from repro_torch.stream import SlidingWindow, StreamSpec

    t0 = time.perf_counter()
    graph = ("lru_hits", "fused_levels", "segment_sum")
    scored_only = dict(fused_levels=0, segment_sum=0)  # builds ran in the workers
    with SharedLlcClock() as llc:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_phase15_") as tmp:
            tmp = Path(tmp)
            streams = [StreamSpec(DRIFT["kernel"], DRIFT["dataset"], SlidingWindow(),
                                  epochs=DRIFT["epochs"], lifecycle=p, seed=0)
                       for p in DRIFT["policies"]]
            runs = {w: run_path(f"ST-drift workers={w}", graph if w == 1 else ("lru_hits",),
                                lambda: protocol_cell(f"ST-drift (workers={w})", streams,
                                                      DRIFT["prefetchers"], dev,
                                                      tmp / f"drift{w}", workers=w),
                                exact=None if w == 1 else scored_only)
                    for w in (1, 2)}
            parity = rows_equal(runs[1].rows(), runs[2].rows())
            check(parity and runs[1].trace_reuse == runs[2].trace_reuse,
                  "ST-drift: workers=2 rows or trace_reuse differ from serial")
            doc = jsonable(drift_document(runs[1], streams, DRIFT["policies"], parity))
            want = json.loads((ROOT / "results" / "drift_pgd_comdblp_sliding_window.json")
                              .read_text())
            check(doc == want, "ST-drift: the drift document differs from "
                  "results/drift_pgd_comdblp_sliding_window.json")
            log("  ST-drift: == results/drift_pgd_comdblp_sliding_window.json "
                f"(parallel_matches_serial {parity})")
            del runs

            serve = ServeSpec(tenants=tuple(TenantSpec(k, d, seed=s)
                                            for k, d, s in CONTENTION["tenants"]))
            runs = {w: run_path(f"SV-contention workers={w}", graph if w == 1 else ("lru_hits",),
                                lambda: protocol_cell(f"SV-contention (workers={w})", [serve],
                                                      CONTENTION["prefetchers"], dev,
                                                      tmp / f"contention{w}", workers=w,
                                                      llc=llc),
                                exact=None if w == 1 else scored_only)
                    for w in (1, 2)}
            check(rows_equal(runs[1].rows(), runs[2].rows()),
                  "SV-contention: workers=2 rows differ from serial")
            doc = jsonable(contention_document(runs[1], serve))
            want = json.loads((ROOT / "results" / "contention_comdblp_k3.json").read_text())
            check(doc == want, "SV-contention: the contention document differs from "
                  "results/contention_comdblp_k3.json")
            log("  SV-contention: == results/contention_comdblp_k3.json; workers=2 == serial")
            del runs

            for name in ("ST-full", "SV-full", "ST-models", "SV-rate"):
                cell = gold["cells"][name]
                expect = ("lru_hits", "fused_levels") + (
                    ("segment_sum",) if any(s.get("kernel", "") == "pgd" for s in
                                            cell.get("streams", []) + cell.get("serve", {})
                                            .get("tenants", [])) else ())
                res = run_path(name, expect, lambda: protocol_cell(
                    name, cell_workloads(cell), cell["prefetchers"], dev, tmp / name, llc=llc))
                rows = jsonable(res.rows())
                check(len(rows) == len(cell["rows"]),
                      f"{name}: {len(rows)} rows, golden {len(cell['rows'])}")
                for got, want in zip(rows, cell["rows"]):
                    if got != want:
                        diff = {k: (got.get(k), want.get(k)) for k in want
                                if got.get(k) != want.get(k)}
                        raise SmokeError(f"{name}: row {want['kernel']}#s{want['seed']}/"
                                         f"{want['prefetcher']} differs from golden: {diff}")
                check(res.trace_reuse == cell["trace_reuse"],
                      f"{name}: trace_reuse {res.trace_reuse}, golden {cell['trace_reuse']}")
                log(f"  {name}: {len(rows)} rows == golden")
                del res

            cell = gold["cells"]["zero-churn"]
            got = [run_path(f"zero-churn {w}", graph if w == "cold" else ("lru_hits",),
                            lambda: protocol_cell(f"zero-churn ({w})", cell_workloads(cell),
                                                  cell["prefetchers"], dev, tmp / "zero"),
                            exact=None if w == "cold" else scored_only)
                   for w in ("cold", "warm")]
            reuse = [r.trace_reuse for r in got]
            check(reuse == [cell["trace_reuse_cold"], cell["trace_reuse_warm"]] == [2, 3],
                  f"zero-churn: trace_reuse cold and warm {reuse}, expected 2 and 3")
            check(all(jsonable(r.rows()) == cell["rows"] for r in got),
                  "zero-churn: rows differ from golden")
            log("  zero-churn: trace_reuse 2 cold, 3 warm; rows == golden")
    log(f"  K1 launches inside the shared-LLC passes of phase 15: {llc.launches}")
    log(f"  phase 15 seconds {time.perf_counter() - t0:.1f}")


# ------------------------------------------------------------ main


def k5_spills(report, kernel) -> int:
    """Spill bytes ``ptxas`` reported for ``kernel<64>`` (its report
    follows the line that names the entry)."""
    spills, inside = None, False
    for line in report:
        if "Compiling entry" in line:
            inside = kernel in line and "ILi64E" in line
        elif inside and "spill" in line:
            spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
            inside = False
    check(spills is not None, f"no ptxas report for K5's {kernel} at hd 64")
    return spills


def sm_clock_hz() -> float:
    """The card's top SM clock (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60)
        return float(r.stdout.strip().splitlines()[0]) * 1e6
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        log(f"  nvidia-smi gave no SM clock: the bound takes H100 SXM's {H100_SM_MHZ} MHz")
        return H100_SM_MHZ * 1e6


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
    if not (ROOT / "src" / "repro_torch").is_dir() or not all(
            g.exists() for g in (GOLDEN, GOLDEN_EVOLVING, GOLDEN_LM, GOLDEN_GRID, GOLDEN_SHARDED,
                                 GOLDEN_STREAM_SERVE) + RESULTS):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch, tests/data and results are missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.amc_gather import amc_gather as gather_mod
    from repro_torch.kernels.basedelta import basedelta as bd_mod
    from repro_torch.kernels.cache_sim.ops import SOURCES, fused_levels, lru_hits
    from repro_torch.kernels.flash_attn import flash_attn as fa_mod
    from repro_torch.kernels.segment_sum import segment_sum as seg_mod
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_mod
    from repro_torch.memsim import engine

    dev = torch.device("cuda", 0)
    # float32 products in full float32 (the LM comparisons are stated for it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(gpu_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    golden = json.loads(GOLDEN.read_text())
    golden_ev = json.loads(GOLDEN_EVOLVING.read_text())
    t_start = time.perf_counter()
    phase_t = [t_start]

    def phase(title):
        now = time.perf_counter()
        if len(phase_t) > 1:
            log(f"  ({now - phase_t[-1]:.1f} s)")
        phase_t.append(now)
        log(title)

    counters = (lru_hits, fused_levels, seg_mod.segment_sum,
                bd_mod.basedelta_compress_tiles, bd_mod.basedelta_decompress_tiles,
                gather_mod.amc_gather, gather_mod.amc_gather_segment_sum,
                fa_mod.flash_attention, ssd_mod.ssd_scan)
    totals = {c.__name__: 0 for c in counters}
    # launches by route, for the kernels that count them, on the paths only
    route_totals = {c.__name__: dict.fromkeys(c.routes, 0) for c in counters
                    if hasattr(c, "routes")}

    def run_path(name, expect, fn, exact=None):
        """Drive one path with every launch counter at 0; check that each
        kernel in ``expect`` launched (``exact`` times, where given), and
        add the counts to the totals."""
        for c in counters:
            c.launches = 0
        routes0 = {c.__name__: dict(c.routes) for c in counters if hasattr(c, "routes")}
        result = fn()
        sync(dev)
        counts = {c.__name__: c.launches for c in counters}
        log(f"  launches on path {name} " + json.dumps(counts))
        for k in expect:
            check(counts[k] > 0, f"kernel {k} was not launched on path {name}")
        for k, n in (exact or {}).items():
            check(counts[k] == n, f"kernel {k} launched {counts[k]} times on path {name}, "
                  f"expected {n}")
        for k, n in counts.items():
            totals[k] += n
        for c in counters:
            for r, n in getattr(c, "routes", {}).items():
                route_totals[c.__name__][r] += n - routes0[c.__name__][r]
        return result

    phase("phase 1: build")
    sources = list(SOURCES) + [seg_mod.SOURCE, bd_mod.SOURCE, gather_mod.SOURCE,
                               fa_mod.SOURCE, ssd_mod.SOURCE]
    secs = build.build(sources)
    log(f"  built {len(secs)} libraries in {time.perf_counter() - phase_t[-1]:.1f} s "
        + json.dumps({k: round(v, 1) for k, v in secs.items()}))
    for src in sources:
        report = build.ptxas_report(src)
        if len(report) > 30:  # one instantiation per template case: summarize
            regs = [int(n) for ln in report for n in re.findall(r"Used (\d+) registers", ln)]
            stack = [int(n) for ln in report for n in re.findall(r"(\d+) bytes stack", ln)]
            spill = sum(int(n) for ln in report for n in re.findall(r"(\d+) bytes spill", ln))
            log(f"  [{src.name}] {len(regs)} kernels: {min(regs)}-{max(regs)} registers, "
                f"stack frames up to {max(stack)} bytes, {spill} bytes of spill")
            continue
        for line in report:
            log(f"  [{src.name}] {line}")
    for route, kernel in (("bfloat16", "flash_attn_tc_kernel"),
                          ("float32", "flash_attn_f32tc_kernel")):
        spills = k5_spills(build.ptxas_report(fa_mod.SOURCE), kernel)
        log(f"  K5 {route} route at hd 64: {spills} bytes of spill stores and loads")
        check(spills == 0, f"K5's {route} route spills {spills} bytes at hd 64")

    phase("phase 2: kernels vs plain on the card")
    k3_err, k4_err = k3_families(dev), k4_families(dev)
    errs = dict(lru_hits=k1_families(dev), fused_levels=k2_families(dev),
                segment_sum=segment_sum_check(dev),
                basedelta_compress_tiles=k3_err, basedelta_decompress_tiles=k3_err,
                amc_gather=k4_err, amc_gather_segment_sum=k4_err,
                flash_attention=k5_families(dev), ssd_scan=k6_families(dev))
    sync(dev)

    slice1 = ("lru_hits", "fused_levels", "segment_sum")
    phase("phase 3: main path A (pgd/comdblp, SCALED)")
    run_path("A", slice1, lambda: main_path("pgd/comdblp/SCALED", golden, dev))
    phase("phase 4: main path B (pgd/google, PAPER)")
    # keep B's K1 launches (their inputs) to time them one by one in phase 6
    k1_calls = []

    def k1_recorded(*args):
        k1_calls.append(args)
        return lru_hits(*args)

    engine.lru_hits = k1_recorded
    try:
        wl_b, _ = run_path("B", slice1, lambda: main_path("pgd/google/PAPER", golden, dev))
    finally:
        engine.lru_hits = lru_hits

    phase("phase 5: K2 on B's first 1,000,000 accesses, cold and resumed at 500,000")
    from repro_torch.memsim.hierarchy import _demand_levels

    e = k2_resume(wl_b.block[:1_000_000], 500_000, _demand_levels(wl_b.profile.cfg), dev)
    errs["fused_levels"] = max(errs["fused_levels"], e)
    log("  K2 == plain, cold and resumed")

    phase("phase 6: kernel times at main path B's shapes; each K1 launch of B")
    kernels = time_kernels(wl_b, dev, errs, totals, k1_calls)
    k1_entry = next(k for k in kernels if k["name"] == "lru_hits")
    k1_entry["per_launch_ms"] = time_k1_launches(k1_calls, dev)
    del wl_b, k1_calls

    cache = ("lru_hits", "fused_levels")
    phase("phase 7: main paths C (bfs/notredame, SCALED) and D (bfs/google, PAPER), "
          "and bfs_do/notredame (SCALED); two runs each, scored on run 2")
    run_path("C", cache, lambda: main_path("bfs/notredame/SCALED", golden_ev, dev))
    wl_d, _ = run_path("D", cache, lambda: main_path("bfs/google/PAPER", golden_ev, dev))
    run_path("bfs_do", cache, lambda: main_path("bfs_do/notredame/SCALED", golden_ev, dev))
    profile_share("path D again", lambda: main_path("bfs/google/PAPER", golden_ev, dev), dev)

    phase("phase 8: the AMC gather demo (comdblp, pair seed 1) through AMCGatherSession")
    run_path("gather demo", ("amc_gather",), lambda: gather_demo(golden_ev["amc_gather_demo"], dev))

    phase("phase 9: K3 on every AMC entry table recorded over path D")
    tables = amc_entry_tables(wl_d)
    run_path("K3 on D's entries", ("basedelta_compress_tiles", "basedelta_decompress_tiles"),
             lambda: k3_on_amc_entries(tables, dev))

    phase("phase 10: main path E (amc_gather_segment_sum along run 2 of D); "
          "K3 and K4 times at path D's shapes")
    from repro_torch.graphs import make_dataset, make_evolving_pair

    run2 = make_evolving_pair(make_dataset("google"), seed=wl_d.spec.seed).run2
    table = vertex_table(run2.num_vertices, dev)
    idx, seg, nseg = run_path("E", ("amc_gather_segment_sum",), lambda: path_e(run2, table, dev))
    kernels += time_recorded_stream_kernels(table, idx, seg, nseg, tables, dev, errs, totals)
    del wl_d, tables, run2, table, idx, seg

    lm = ("flash_attention", "ssd_scan")
    phase("phase 11: the reduced zamba2 (4 and 5 layers) against the JAX package's golden record")
    for rec in json.loads(GOLDEN_LM.read_text())["records"]:
        run_path(rec["name"], lm, lambda: lm_golden_check(rec, dev))

    phase(f"phase 12: main path F, zamba2-1.2b at full width (bfloat16): prefill "
          f"{PATH_F_BATCH} x {PATH_F_PREFILL}, serve {PATH_F_BATCH} x {PATH_F_PROMPT} + "
          f"{PATH_F_GEN}, float32 cross-check, K5 and K6 times")
    kernels += path_f(dev, run_path, errs, totals)

    phase("phase 13: Experiment on the card against the JAX package's grid rows: G (the BENCH "
          "v9 grid), G-fused under the fused and set_parallel engines, G-quick, G-tableI, H "
          "(bellmanford/google, PAPER); G again from a warm artifact cache")
    grid = json.loads(GOLDEN_GRID.read_text())
    calib = phase13(grid, dev, run_path)

    phase("phase 14: sharded and parallel: S-parity (bfs/comdblp at 16,384-access shards) under "
          "the fused and set_parallel engines, S-full (bfs/road-8m at 4,194,304-access shards), "
          "the scheduler's pool (G under workers=2 and None, the mixed grid), spawn timing")
    phase14(json.loads(GOLDEN_SHARDED.read_text()), grid, dev, run_path, calib)

    phase("phase 15: stream and serve protocols through Experiment: ST-drift and SV-contention "
          "against results/, ST-full, SV-full, ST-models, SV-rate against the golden record, "
          "the zero-churn reuse counts")
    phase15(json.loads(GOLDEN_STREAM_SERVE.read_text()), dev, run_path)
    for k in kernels:
        k["launches"] = totals[k["name"]]
        if k["name"] in route_totals:
            k["launches_by_route"] = route_totals[k["name"]]
            check(sum(route_totals[k["name"]].values()) == totals[k["name"]],
                  f"{k['name']}: launches by route {route_totals[k['name']]} do not add up to "
                  f"{totals[k['name']]}")
    log("  launches over all paths " + json.dumps(totals))
    log("  launches by route over all paths " + json.dumps(route_totals))
    phase_t.append(time.perf_counter())
    log(f"  ({phase_t[-1] - phase_t[-2]:.1f} s)")
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
