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
   would show, and the shapes of phase 17's families: cross-attention of
   448 queries over 1,500 keys, GQA groups of 6 and 7 at hd 128, a
   4,096-key window over 8,192 positions; K6's bfloat16 families include them, where one bfloat16
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
   reproduce ``tests/data/torch_port_golden_evolving.json`` exactly (D's
   device busy share, 0.23 % in PR 18, is no longer re-measured here: the
   rerun was cut for the script's time).
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
    ``torch.profiler``; the serve loop answering 4 requests of 64-token
    prompts with 32 tokens, and one decode step under ``torch.profiler``;
    a float32 cross-check of the prefill's caches and logits against the
    same 256 tokens decoded one by one, beside the same prefill through the
    plain versions of K5 and K6 (``repro_torch.launch.drift``); then K5 and
    K6 timed at the prefill's shapes beside their plain versions, their
    bounds and (K5) ``scaled_dot_product_attention`` with K5's TFLOP/s, and
    K5's float32 (tensor-core) route at 4 x 512 tokens beside SDPA in
    float32, with its two bounds.
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
    ``ShardedSpec`` at 4096) under 2 and 1 workers.  Prints the cost
    model's per-access constants from this run (the seconds to start a
    pool and a context's memory are no longer measured here).
15. The stream and serve protocols through ``repro_torch.core.Experiment``,
    ST-drift and SV-contention each from a fresh artifact root, the golden
    cells on an in-memory cache: ST-drift (``StreamSpec`` of
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
16. LM training (``tests/data/torch_port_golden_train.json``, written from
    the JAX package), float32 with TF32 off unless said: five
    ``train_step``s of the reduced smollm, qwen3, mamba2 and zamba2 from
    ``convert.random_lm_tree`` (losses ``rtol=1e-4``, the step-0 gradient
    norm ``1e-3``, every leaf's norm after the last step ``1e-5``);
    smollm-360m at full width cut to 4 layers in bfloat16, 3 steps at 2 x
    128 (each loss and the gradient norm within twice the JAX package's own
    bfloat16-to-float32 distance, at least 1e-3 of it); ``loss_fn``'s
    gradients of the reduced smollm and zamba2 on the card against the
    CPU's; ``flash_attention`` and ``ssd_scan`` raising on inputs that
    require grad; then smollm-360m whole (32 layers, bfloat16, remat
    ``dots``, batch 8 x 256): the step-0 gradient of every leaf finite and
    not all zero, a step (ms, peak allocation), a step each under the
    ``none`` and ``full`` remat policies with 4 layers, the launcher (``launch/train.py``) for 10
    steps with a checkpoint every 10 (step ms, tokens/s, peak allocation,
    save seconds and bytes), the step-10 checkpoint read back bit-equal to
    the run's state, and the launcher again, resuming to step 15.  The
    training path takes the plain versions of K5 and K6 under autograd:
    each of its runs must launch neither.
17. The ``moe``, ``vlm`` and ``encdec`` families
    (``tests/data/torch_port_golden_families.json``, written from the JAX
    package): (a) the reduced mixtral (a 64-key window under a 96-token
    prompt), qwen2-vl (``embeds`` with an M-RoPE text / image / text
    layout) and whisper (48 frames), float32, parameters from
    ``convert.random_lm_tree``: ``prefill_step`` (K5 once a layer and
    attention kind), 8 ``serve_step``s from ``decode_cache_from_prefill``'s
    cache and 5 ``train_step``s (no K5), with phases 11's and 16's
    tolerances; (b) at full width in bfloat16 from ``init_params``: M,
    mixtral-8x22b cut to 4 layers, ``prefill_step`` on 2 x 8,192 tokens
    (a windowed K5 a layer, the kept share of each layer's MoE plan), the
    ring of 4,096 slots from it bit-equal to the prefill's keys and values
    at the positions it holds, 16 serve steps; V, qwen2-vl-7b whole,
    ``prefill_step`` on 4 x 2,048 ``embeds`` with an M-RoPE layout, the
    serve loop answering 4 requests of 128 prompt tokens with 32; W,
    whisper-tiny whole, 1,500 frames a request from a seeded generator, the
    decoder's prefill of 4 x 448 tokens and 32 serve steps from its cache;
    each with its host and CUDA-event ms and the card's peak; float32
    cross-checks of M (2 layers) and V (4 layers), the prefill of 512
    tokens at batch 1 against the same tokens decoded one by one
    (``launch/drift.py``; for M at its own top-2 not applicable where its
    prefill drops MoE slots: then held to the same prefill through K5's
    plain version; M again at top-8 of 8 experts, where nothing can drop
    and the check must apply); (c)
    K5 on the first call of each kind of M's, V's and W's prefills, timed
    beside its plain version, its bound and
    ``scaled_dot_product_attention``.
18. Cell L, zamba2-1.2b at ``long_500k`` (bfloat16, ``init_params`` with a
    seed): ``prefill_step`` on 1 x 8,192 tokens (K5 x 6, K6 x 38), the
    decode cache of 524,288 positions (25.8 GB) from it and 16 greedy
    ``serve_step``s, then the cache filled with seeded N(0, 1) keys and
    values to 524,280 and 8 more (the inserts land in the last slots);
    each step beside a witness (the same step with the fed token's
    embedding row moved one ulp).  Then the same on two spawned ranks of a
    gloo group on the one card, each building only its half of the cache
    (``decode_cache_from_prefill(seq_shard=)``) and stepping
    ``make_serve_step(cfg, mesh, seq_sharded=True)`` fed the unsharded
    run's tokens: each step's logits within twice the witness's distance
    and its token the unsharded one's (the margin rule).  Prints the median
    step ms of both runs, the cache's read bound, each run's peak.

Every launch counter is set to 0 just before each path (A, B, C, D,
bfs_do, the gather demo, K3 on D's entries, E, the reduced LMs, F's
prefill, serve loop and float32 cross-check, each cell of phase 13,
each run of phases 14 and 15, each training run of phase 16, each
serving and training run of phase 17 and cell L's prefill) and read
just after; each
kernel must have launched on the paths that run it, and the ``launches``
of the kernels line are the sums over those paths.  Prints the card's
name and power limit first, a ``{"kernels": ...}`` line, and as the last
line ``{"ok": true, "device": {...}}``.  Exits non-zero without printing a
result when no CUDA device is available or the repository's sources are
missing.
"""
from __future__ import annotations

import dataclasses
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
GOLDEN_TRAIN = ROOT / "tests" / "data" / "torch_port_golden_train.json"
GOLDEN_FAMILIES = ROOT / "tests" / "data" / "torch_port_golden_families.json"
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
        # the shapes of the moe, vlm and encdec families (phase 17):
        # whisper's cross-attention (448 decoder queries over 1,500 frames),
        # mixtral's and qwen2-vl's GQA groups of 6 and 7 at hd 128, and
        # mixtral's 4,096-key window over 8,192 positions, whose leading
        # tiles the window masks whole
        ("non-causal cross 448 x 1500 hd 64", 2, 448, 1500, 6, 6, 64, False, 0, 0),
        ("GQA 6 hd 128 causal", 1, 512, 512, 12, 2, 128, True, 0, 0),
        ("GQA 7 hd 128 causal", 1, 384, 384, 14, 2, 128, True, 0, 0),
        ("window 4096 at S 8192 hd 128", 1, 8192, 8192, 2, 1, 128, True, 4096, 0),
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


def ssm_gate_check(dev, time_it: bool = True):
    """The Mamba2 gate kernel (``kernels/ssm_gate``) against its plain
    version on the card: x and z read in place from a projection of the
    model's width, bfloat16 within one bfloat16 step of every element
    (zamba2-1.2b's shapes: one 4,096-token row block, d_inner 4,096, 64
    heads; mamba2-780m's; the reduced models'), float32 within rtol 1e-5
    (the mean's sum in another order, exp and rsqrt by other functions); a
    projection 4 bytes off 16-byte alignment refused.  With ``time_it``,
    the kernel and the plain chain at a 32,768-token batch by CUDA events.
    Returns the max abs error of the float32 cases."""
    import torch

    from repro_torch.kernels.ssm_gate.ssm_gate import ssm_gate, ssm_gate_plain

    bf16, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(11)

    def inputs(bsz, s, h, p, n, dtype, wdtype, shift=0):
        """x and z start ``shift`` elements into a projection 8 wider."""
        d_inner = h * p
        zx = torch.randn((bsz, s, 2 * d_inner + 2 * n + h + 8), generator=g, device=dev)
        zx[..., shift + d_inner:shift + 2 * d_inner] *= 3.0  # z: silu's tails on both sides
        zx = zx.to(dtype)[..., shift:]
        y = torch.randn((bsz, s, h, p), generator=g, device=dev).to(dtype)
        d = (0.5 + torch.rand(h, generator=g, device=dev)).to(wdtype)
        w = (0.5 + torch.rand(d_inner, generator=g, device=dev)).to(wdtype)
        return y, zx[..., :d_inner].reshape(bsz, s, h, p), zx[..., d_inner:2 * d_inner], d, w

    cases = [("zamba2-1.2b, one 4,096-token row block", 1, 4096, 64, 64, 64, bf16, bf16),
             ("zamba2-1.2b, float32 weights", 2, 300, 64, 64, 64, bf16, f32),
             ("mamba2-780m", 2, 300, 48, 64, 128, bf16, bf16),
             ("reduced, bfloat16", 2, 24, 8, 32, 16, bf16, bf16),
             ("zamba2-1.2b, float32", 1, 512, 64, 64, 64, f32, f32),
             ("reduced, float32", 2, 24, 8, 32, 16, f32, f32)]
    err, moved = 0.0, []
    for name, bsz, s, h, p, n, dtype, wdtype in cases:
        args = inputs(bsz, s, h, p, n, dtype, wdtype)
        launches = ssm_gate.launches
        out = ssm_gate(*args)
        ref = ssm_gate_plain(*args)
        check(ssm_gate.launches == launches + 1 and out.dtype == ref.dtype
              and out.shape == ref.shape, f"ssm_gate {name}: no launch, or dtype / shape")
        if dtype == bf16:
            step = torch.ldexp(torch.ones_like(ref, dtype=f32),
                               torch.frexp(ref.float().abs()).exponent - 8)
            off = (out.float() - ref.float()).abs() / step
            check(bool(torch.isfinite(out).all()) and bool((off <= 1).all()),
                  f"ssm_gate {name}: {int((off > 1).sum())} elements more than one bfloat16 "
                  f"step from the plain version (most {float(off.max())} steps)")
            moved.append(f"{name} {float((out != ref).float().mean()):.2e}")
        else:
            err = max(err, close(out, ref, rtol=1e-5, atol=0.0, what=f"ssm_gate {name}"))
    try:
        ssm_gate(*inputs(1, 8, 64, 64, 64, bf16, bf16, shift=2))
    except ValueError as e:
        check("aligned" in str(e), f"ssm_gate misaligned: unexpected error {e}")
    else:
        raise SmokeError("ssm_gate ran on a projection off 16-byte alignment")
    log(f"  ssm_gate == plain: bfloat16 within one step (share of elements a step off: "
        f"{'; '.join(moved)}), float32 max abs err {err:.3g}")
    if time_it:
        args = inputs(8, 4096, 64, 64, 64, bf16, bf16)
        ms = cuda_ms(lambda: ssm_gate(*args), dev, reps=20)
        plain = cuda_ms(lambda: ssm_gate_plain(*args), dev, reps=5)
        gbytes = 4 * 8 * 4096 * 4096 * 2 / 1e9  # y, x, z read, the output written, bf16
        log(f"  ssm_gate at 8 x 4,096 tokens, d_inner 4,096, bf16: {ms:.4f} ms "
            f"({gbytes / ms:.3f} TB/s over {gbytes:.3f} GB; bound {gbytes / 3.35:.4f} ms at "
            f"3.35 TB/s), plain chain {plain:.3f} ms")
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


def lm_golden_run(record, dev, cfg=None, batch=None, components=cache_components):
    """The reduced LM of ``record`` on ``dev``: parameters from
    ``random_lm_tree``, ``prefill_step`` on the record's prompts (or on
    ``batch``, numpy arrays), then ``serve_step`` from
    ``decode_cache_from_prefill``'s cache, fed the record's tokens.
    Returns ``(last logits, components(prefill cache), returned tokens (B,
    gen))``."""
    import numpy as np
    import torch

    from repro_torch.convert import lm_params_from_numpy, random_lm_tree
    from repro_torch.launch.steps import (
        decode_cache_from_prefill, make_prefill_step, make_serve_step,
    )

    cfg = cfg or lm_config(record)
    model = lm_params_from_numpy(cfg, random_lm_tree(cfg, record["param_seed"]), device=dev)
    tokens = torch.tensor(record["tokens"], dtype=torch.int32, device=dev)
    s, gen = record["prompt_len"], record["gen"]
    batch = ({"tokens": tokens[:, :s]} if batch is None else
             {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    last, cache = make_prefill_step(cfg)(model, batch)
    comps = components(cache)
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
    return serve_golden_check(record, *lm_golden_run(record, dev))


def serve_golden_check(record, last, comps, gen):
    """A serving record (phases 11 and 17): the last logits, each cache
    component's shape, first values, L2 norm and absolute sum, and each
    serve step's token against the JAX package's; returns the max abs
    error of the logits."""
    import numpy as np
    import torch

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


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs that K5's mask keeps (q_offset 0)."""
    import torch

    q = torch.arange(sq, dtype=torch.int64)
    hi = torch.clamp(q, max=skv - 1) if causal else torch.full_like(q, skv - 1)
    lo = torch.clamp(q - window + 1, min=0) if window else torch.zeros_like(q)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def time_k5(q, k, v, causal: bool, win: int, dev, what: str) -> dict:
    """K5 on ``(q, k, v)`` held against its plain version and timed with
    CUDA events beside the plain version, its bound (the kept pairs'
    operations, or the bytes of q, k, v and the output) and
    ``scaled_dot_product_attention`` (with a window as a boolean mask);
    logs a line that starts with ``what``."""
    import torch

    from repro_torch.kernels.flash_attn.flash_attn import flash_attention
    from repro_torch.kernels.flash_attn.ref import blocked_attention_plain

    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    run = lambda: flash_attention(q, k, v, causal=causal, sliding_window=win)  # noqa: E731
    ms, host = cuda_ms(run, dev, reps=10), enqueue_us(run, dev)
    ref = blocked_attention_plain(q, k, v, causal, win)
    err = close(run(), ref, what=f"K5 at {what}", **ATTN_TOL[str(q.dtype)[6:]])
    rms = float(ref.float().pow(2).mean().sqrt())
    del ref
    plain = cuda_ms(lambda: blocked_attention_plain(q, k, v, causal, win), dev, reps=2)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = dict(enable_gqa=True) if kvh != h else {}
    if win:
        qp, kp = torch.arange(sq, device=dev)[:, None], torch.arange(skv, device=dev)[None, :]
        sdpa["attn_mask"] = (kp > qp - win) & ((kp <= qp) if causal else True)
    else:
        sdpa["is_causal"] = causal
    lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, **sdpa),
                  dev, reps=10)
    flop = 4 * hd * b * h * attention_pairs(sq, skv, causal, win)
    bnd, by = bound((2 * q.numel() + k.numel() + v.numel()) * q.element_size(), flop,
                    BF16_OPS_PER_S)
    log(f"  flash_attention at {what}: {ms:.3f} ms (plain {plain:.3f} ms, SDPA {lib:.3f} ms, "
        f"bound {bnd:.4f} ms by {by}); {flop / ms * 1e-9:.1f} TFLOP/s, {ms / lib:.2f} x SDPA's "
        f"time in this call; max abs err against the plain version {err:.3g} (output rms "
        f"{rms:.3g})")
    return dict(ms=ms, host_us=host, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
                max_abs_err=err, tflops=flop / ms * 1e-9)


def time_lm_kernels(keep, dev, errs, launches):
    """Phase 12.4: K5 and K6 on the inputs of their first calls in path F's
    bf16 prefill, held against their plain versions and timed with CUDA
    events beside the plain versions, the bound and the library call."""
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan

    out = []
    (q, k, v), kw = keep["flash_attention"]
    b, s, h, hd = q.shape
    shape = f"q, k, v ({b}, {s}, {h}, {hd}) {str(q.dtype)[6:]}, causal"
    t = time_k5(q, k, v, kw.get("causal", True), kw.get("sliding_window", 0), dev,
                f"path F's {shape}")
    errs["flash_attention"] = max(errs["flash_attention"], t["max_abs_err"])
    f32 = time_k5_float32(b, h, hd, dev)
    out.append(dict(name="flash_attention", route="cuda",
                    source="src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
                    replaces="src/repro/kernels/flash_attn/flash_attn.py:70",
                    launches=launches["flash_attention"], max_abs_err=errs["flash_attention"],
                    path_f_max_abs_err=t.pop("max_abs_err"), **t, float32_route=f32,
                    shape=shape))

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
    (b, 512, h, hd), causal, random inputs from a seed, held against its
    plain version and timed beside SDPA in float32, with its two bounds:
    the float32 work at the CUDA cores' peak, and the split's bf16 products
    (six a product) at the tensor cores' peak, the lower of the two and the
    design it assumes."""
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
PATH_F_PROMPT = 512  # tokens per prompt of K5's float32 route timing
PATH_F_XCHECK = 256  # tokens per prompt of the float32 cross-check
PATH_F_SERVE_PROMPT = 128  # tokens per prompt of the serve loop
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
    exact = dict(flash_attention=cfg.num_layers // every, ssd_scan=cfg.num_layers,
                 ssm_gate=cfg.num_layers)
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
    res = run_path("F serve", (), lambda: serve_loop(
        cfg, model, tokens[:, :PATH_F_SERVE_PROMPT + 1], PATH_F_GEN))
    check(res.gen.shape == (PATH_F_BATCH, PATH_F_GEN), f"path F serve: tokens {res.gen.shape}")
    check(bool(((res.gen >= 0) & (res.gen < padded_vocab(cfg.vocab_size))).all()),
          "path F serve: token ids out of the padded vocabulary")
    check(bool(torch.isfinite(res.prompt_logits).all()), "path F serve: non-finite logits")
    log(f"  serve loop: {PATH_F_BATCH} requests, {PATH_F_SERVE_PROMPT} prompt tokens fed in "
        f"{res.prefill_s:.2f} s ({PATH_F_SERVE_PROMPT / res.prefill_s:.1f} steps/s), {PATH_F_GEN} "
        f"tokens generated in {res.decode_s:.2f} s "
        f"({PATH_F_BATCH * PATH_F_GEN / res.decode_s:.1f} tokens/s); sample {res.gen[0, :8].tolist()}")
    cache = init_cache(cfg, PATH_F_BATCH, PATH_F_SERVE_PROMPT + PATH_F_GEN + 1, device=dev)
    tok = torch.from_numpy(tokens[:, :1]).to(dev)
    decode_step(cfg, model, tok, cache)
    profile_share("one decode step", lambda: decode_step(cfg, model, tok, cache), dev)
    del model, res, cache
    torch.cuda.empty_cache()

    run_path("F float32 cross-check", lm,
             lambda: path_f_xcheck(cfg, tokens[:, :PATH_F_XCHECK + 1], PATH_F_SEED, dev),
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


def phase14(gold: dict, grid: dict, dev, run_path, calib: dict):
    """Sharded and parallel on the card: S-parity under both engines and
    beside its unsharded rows, S-full at paper scale, the scheduler's pool
    (G cold under ``workers=2``, then ``workers=None`` warm; the mixed
    grid under ``workers=2`` and 1); then the cost model's constants from
    this run (the spawn constants are not re-measured here)."""
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

    shard = manifest["shard_accesses"]
    consts = dict(
        BUILD_S_PER_ACCESS=calib["build_s"] / calib["accesses"],
        SCORE_S_PER_ACCESS=calib["score_s"] / (calib["accesses"] * calib["prefetchers"]),
        LOAD_S_PER_ACCESS=calib["load_s"] / calib["accesses"],
        ARTIFACT_BYTES_PER_ACCESS=calib["artifact_bytes"] / calib["accesses"],
        TRACE_BYTES_PER_ACCESS=calib["trace_bytes"] / calib["accesses"],
        DEVICE_BYTES_PER_ACCESS=peak_dev / shard,
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


def protocol_cell(name: str, specs, prefetchers, dev, root=None, workers=1, llc=None):
    """Run stream / serve ``specs`` through ``repro_torch.core.Experiment``
    on ``dev`` from the artifact root ``root`` (an in-memory cache alone
    where ``root`` is None); log the host seconds, the
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
    cache = WorkloadCache(artifacts=None if root is None else ArtifactCache(root))
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
    """Stream and serve protocols through ``Experiment`` on the card:
    ST-drift and SV-contention against the committed ``results/`` documents,
    each from a fresh artifact root (ST-drift then under ``workers=2`` from
    it, whose rows must equal the serial rows: its document records that;
    SV-contention's pool run is held on the CPU, and the pool on the card by
    phase 14), ST-full, SV-full, ST-models and
    SV-rate against ``tests/data/torch_port_golden_stream_serve.json`` on an
    in-memory cache (no run reads their artifacts; the saves cost 37-65 %
    of such a cell, and ST-drift and SV-contention measure them), and the
    zero-churn stream's ``trace_reuse`` cold and warm from one artifact
    root."""
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
            res = run_path("SV-contention workers=1", graph,
                           lambda: protocol_cell("SV-contention (workers=1)", [serve],
                                                 CONTENTION["prefetchers"], dev,
                                                 tmp / "contention1", workers=1, llc=llc))
            doc = jsonable(contention_document(res, serve))
            want = json.loads((ROOT / "results" / "contention_comdblp_k3.json").read_text())
            check(doc == want, "SV-contention: the contention document differs from "
                  "results/contention_comdblp_k3.json")
            log("  SV-contention: == results/contention_comdblp_k3.json")
            del res

            for name in ("ST-full", "SV-full", "ST-models", "SV-rate"):
                cell = gold["cells"][name]
                expect = ("lru_hits", "fused_levels") + (
                    ("segment_sum",) if any(s.get("kernel", "") == "pgd" for s in
                                            cell.get("streams", []) + cell.get("serve", {})
                                            .get("tenants", [])) else ())
                res = run_path(name, expect, lambda: protocol_cell(
                    name, cell_workloads(cell), cell["prefetchers"], dev, llc=llc))
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


# ------------------------------------------------------------ phase 16

TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_NORM_RTOL = 1e-3
TRAIN_LEAF_RTOL = 1e-5
# A gradient leaf of the port on the card against the port on the CPU:
# rtol 1e-4 and atol in units of the leaf's largest element; the ssm and
# hybrid families' float32 gradients lie up to ~3e-5 of it from a float64
# evaluation in either package (tests/test_torch_train.py).
TRAIN_GRAD_ATOL = {"dense": 1e-6, "ssm": 3e-5, "hybrid": 3e-5}
# training takes the plain versions
NO_LM_KERNEL = {"flash_attention": 0, "ssd_scan": 0, "ssm_gate": 0}
T_BATCH, T_SEQ = 8, 256  # the launcher's defaults
T_REMAT_LAYERS = 4  # smollm-360m's depth under the remat policies not its own
# 10 steps with one checkpoint, resumed to 15 (the issue's 20 + 5 cut for
# the script's time; each save and restore moves 3.6 GB)
T_STEPS, T_RESUME, T_EVERY = 10, 15, 10


def train_golden_run(cfg, record, dev, leaf_norms: bool, batches=None):
    """The port's training run of a golden record on ``dev``: parameters
    from ``random_lm_tree``, the step-0 gradient's global norm, then one
    ``train_step`` on each of the record's batches (its token sequences:
    numpy versions differ in ``SyntheticLMData``'s draws; or ``batches``,
    dicts of numpy arrays, where given).  Returns ``(losses, gradient
    norm, {leaf path: L2 norm after the last step} or None)``."""
    import torch

    from repro_torch.checkpoint.manager import tree_flatten_with_path
    from repro_torch.convert import lm_params_from_numpy, lm_tree_from_params, random_lm_tree
    from repro_torch.launch.steps import make_train_step, param_grads
    from repro_torch.models import loss_fn
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import global_norm

    model = lm_params_from_numpy(cfg, random_lm_tree(cfg, record["param_seed"]), device=dev)
    named = dict(model.requires_grad_(True).named_parameters())
    ocfg = AdamWConfig(lr=record["lr"], state_dtype=cfg.opt_state_dtype)
    opt = adamw_init(named, ocfg)
    if batches is None:
        seqs = [torch.tensor(s, dtype=torch.int32, device=dev) for s in record["sequences"]]
        batches = [{"tokens": s[:, :-1], "labels": s[:, 1:]} for s in seqs]
    else:
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in batches]
    loss, _ = loss_fn(cfg, model, batches[0])
    gn = global_norm(param_grads(loss, named, batches[0])).item()
    step_fn = make_train_step(cfg, ocfg)
    losses = []
    for batch in batches:
        model, opt, metrics = step_fn(model, opt, batch)
        losses.append(float(metrics["loss"]))
    norms = None
    if leaf_norms:
        norms = {p: float(t.double().norm())
                 for p, t in tree_flatten_with_path(lm_tree_from_params(model))}
    return losses, gn, norms


def rel_err(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def train_golden_check(record, dev):
    """Phase 16, part 1, for one reduced record: losses, the step-0
    gradient norm and every leaf's norm after the last step against the
    JAX package's."""
    from repro_torch.configs import get_config

    losses, gn, norms = train_golden_run(get_config(record["arch"]).reduced(), record, dev, True)
    name = record["name"]
    for i, (got, want) in enumerate(zip(losses, record["losses"])):
        check(rel_err(got, want) <= TRAIN_LOSS_RTOL,
              f"{name}: loss of step {i} {got} vs {want} (rel {rel_err(got, want):.2e})")
    check(rel_err(gn, record["grad_norm0"]) <= TRAIN_GRAD_NORM_RTOL,
          f"{name}: step-0 gradient norm {gn} vs {record['grad_norm0']}")
    check(sorted(norms) == sorted(record["leaf_norms"]), f"{name}: leaves {sorted(norms)}")
    worst = max((rel_err(norms[k], w), k) for k, w in record["leaf_norms"].items())
    check(worst[0] <= TRAIN_LEAF_RTOL, f"{name}: leaf {worst[1]} norm off by {worst[0]:.2e}")
    log(f"  {name}: {len(losses)} losses within {max(rel_err(g, w) for g, w in zip(losses, record['losses'])):.2e} "
        f"(rtol {TRAIN_LOSS_RTOL:g}), step-0 gradient norm {gn:.6g} within "
        f"{rel_err(gn, record['grad_norm0']):.2e}, {len(norms)} leaf norms within {worst[0]:.2e}")


def train_full_check(full: dict, dev):
    """Phase 16, part 2: smollm-360m at full width cut to 4 layers, in
    bfloat16, against the JAX package's bfloat16 record; each value within
    twice the JAX package's own bfloat16-to-float32 distance (at least
    1e-3 of the float32 value)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(full["arch"]), num_layers=full["num_layers"])
    losses, gn, _ = train_golden_run(cfg, full, dev, False)
    bf, f32 = full["bfloat16"], full["float32"]
    pairs = [(f"loss {i}", g, w, f) for i, (g, w, f) in
             enumerate(zip(losses, bf["losses"], f32["losses"]))]
    pairs.append(("step-0 gradient norm", gn, bf["grad_norm0"], f32["grad_norm0"]))
    for what, got, want, ref32 in pairs:
        tol = max(2 * abs(want - ref32), 1e-3 * abs(ref32))
        check(abs(got - want) <= tol, f"{full['name']} bf16 {what}: {got} vs the JAX package's "
              f"{want} (float32 {ref32}), tolerance {tol:.3g}")
        log(f"  {full['name']} bf16 {what}: {got:.6g} vs {want:.6g} (|d| {abs(got - want):.3g}, "
            f"tolerance {tol:.3g}; JAX float32 {ref32:.6g})")


def train_grads_card_vs_cpu(dev, arch: str):
    """``loss_fn``'s gradients of the reduced ``arch`` on the card against
    the port's own on the CPU (float32, TF32 off); returns the largest
    difference over a leaf's largest element."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy, random_lm_tree
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import loss_fn

    cfg = get_config(arch).reduced()
    tree = random_lm_tree(cfg, 0)
    batch = SyntheticLMData(cfg.vocab_size, 32, 2, seed=0).batch_at(0)
    out = {}
    for d in (torch.device("cpu"), dev):
        model = lm_params_from_numpy(cfg, tree, device=d).requires_grad_(True)
        named = dict(model.named_parameters())
        loss, _ = loss_fn(cfg, model, {k: torch.from_numpy(v).to(d) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(named.values()))
        out[d.type] = (loss.item(), {k: g.cpu() for k, g in zip(named, grads)})
    (l_cpu, g_cpu), (l_dev, g_dev) = out["cpu"], out[dev.type]
    check(rel_err(l_dev, l_cpu) <= 1e-5, f"{arch}: loss on the card {l_dev} vs CPU {l_cpu}")
    worst = 0.0
    for k, want in g_cpu.items():
        got = g_dev[k]
        check(bool(torch.isfinite(got).all()), f"{arch}: non-finite gradient of {k} on the card")
        top = float(want.abs().max())
        atol = TRAIN_GRAD_ATOL[cfg.family] * top
        bad = (got - want).abs() > 1e-4 * want.abs() + atol
        check(not bool(bad.any()), f"{arch}: gradient of {k} on the card differs from the CPU's "
              f"at {int(bad.sum())} elements (max {float((got - want).abs().max()):.3g})")
        worst = max(worst, float((got - want).abs().max()) / max(top, 1e-30))
    return worst


def raw_bits(t):
    """``t``'s bits as integers of its width, so ``torch.equal`` compares
    bits (NaN payloads and signed zeros included)."""
    import torch

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(ints[t.element_size()])


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def remat_steps(cfg, dev):
    """smollm-360m at the launcher's defaults from ``init_params``: the
    step-0 gradient of every leaf finite and not all zero; then two train
    steps under the config's remat policy, and two under each other policy
    with the model cut to ``T_REMAT_LAYERS`` layers (``none`` is the
    launcher's under ``--reduced``): the second's host ms and the peak
    allocation of both (a step under ``torch.profiler`` is not re-measured
    here, for the script's time)."""
    import dataclasses
    import math

    import torch

    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import AdamWConfig, adamw_init

    model = init_params(cfg, 0, device=dev).requires_grad_(True)
    named = dict(model.named_parameters())
    data = SyntheticLMData(cfg.vocab_size, T_SEQ, T_BATCH, seed=0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(0).items()}
    loss, _ = loss_fn(cfg, model, batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    for k, g in zip(named, grads):
        check(bool(torch.isfinite(g).all()), f"step-0 gradient of {k} is not finite")
        check(float(g.abs().amax()) > 0, f"step-0 gradient of {k} is all zero")
    log(f"  step-0 gradient: {len(grads)} leaves, every one finite and not all zero "
        f"(loss {loss.item():.4f})")
    del loss, grads
    others = [p for p in ("none", "dots", "full") if p != cfg.remat_policy]
    for policy in [cfg.remat_policy] + others:
        pc = dataclasses.replace(cfg, remat_policy=policy)
        if policy != cfg.remat_policy:
            pc = dataclasses.replace(pc, num_layers=T_REMAT_LAYERS)
            del model, named
            torch.cuda.empty_cache()
            model = init_params(pc, 0, device=dev).requires_grad_(True)
            named = dict(model.named_parameters())
        ocfg = AdamWConfig(state_dtype=pc.opt_state_dtype)
        opt = adamw_init(named, ocfg)
        step = make_train_step(pc, ocfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        losses = [float(step(model, opt, batch)[2]["loss"])]
        ms = host_ms(lambda: losses.append(float(step(model, opt, batch)[2]["loss"])), dev)[0]
        check(all(map(math.isfinite, losses)), f"remat {policy!r}: losses {losses}")
        log(f"  one train step under remat {policy!r} ({pc.num_layers} layers): {ms:.1f} ms host "
            f"clock, peak allocation {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
        del opt
    del model, named, batch
    torch.cuda.empty_cache()


def phase16(gold: dict, dev, run_path):
    """LM training: the reduced golden records, the 4-layer full-width
    smollm-360m record, the card's gradients against the CPU's, the
    autograd guard of K5 and K6, then smollm-360m whole: the step-0
    gradient and a step under ``dots`` (``none`` and ``full`` at
    ``T_REMAT_LAYERS`` layers), and the launcher
    (``launch/train.py``): ``T_STEPS`` steps with a checkpoint, read back
    bit for bit, and a resumed run to ``T_RESUME``."""
    import math
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import tree_flatten_with_path
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.models import LM

    for rec in gold["records"]:
        run_path(f"T {rec['name']}", (), lambda: train_golden_check(rec, dev), exact=NO_LM_KERNEL)
    run_path("T full-width 4 layers", (), lambda: train_full_check(gold["full"], dev),
             exact=NO_LM_KERNEL)
    for arch in ("smollm_360m", "zamba2_1p2b"):
        worst = run_path(f"T gradients {arch}", (), lambda: train_grads_card_vs_cpu(dev, arch),
                         exact=NO_LM_KERNEL)
        log(f"  {arch} reduced: loss_fn's gradients on the card within {worst:.2e} of a leaf's "
            f"largest element of the CPU's")
    guard_checks(dev)
    log("  flash_attention and ssd_scan raise on CUDA inputs that require grad")

    cfg = get_config("smollm_360m")
    n_params = sum(p.numel() for p in LM(cfg, device="meta").parameters())
    log(f"  {cfg.name}: {n_params:,} parameters, {cfg.num_layers} layers, {cfg.param_dtype}, "
        f"remat {cfg.remat_policy!r}, batch {T_BATCH} x {T_SEQ}")
    run_path("T remat steps", (), lambda: remat_steps(cfg, dev), exact=NO_LM_KERNEL)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_phase16_") as tmp:
        args = ["--arch", "smollm_360m", "--ckpt-dir", tmp, "--ckpt-every", str(T_EVERY),
                "--batch", str(T_BATCH), "--seq", str(T_SEQ), "--log-every", "5"]
        torch.cuda.reset_peak_memory_stats(dev)
        first = run_path("T launcher", (), lambda: train_mod.train(
            train_mod.parse_args(args + ["--steps", str(T_STEPS)]), dev), exact=NO_LM_KERNEL)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        check(len(first.losses) == T_STEPS and all(map(math.isfinite, first.losses)),
              f"launcher: losses {first.losses}")
        steady = sorted(first.step_s[2:])
        med = steady[len(steady) // 2] * 1e3
        save_bytes = dir_bytes(first.ckpt_paths[-1])
        log(f"  launcher: {T_STEPS} steps, loss {first.losses[0]:.4f} -> {first.losses[-1]:.4f}; "
            f"step {med:.1f} ms (median of steps 2-{T_STEPS - 1}; first {first.step_s[0] * 1e3:.0f} "
            f"ms), {T_BATCH * T_SEQ / med * 1e3:,.0f} tokens/s; peak allocation {peak:.2f} GB; "
            f"checkpoint saves {', '.join(f'{s:.2f}' for s in first.ckpt_s)} s, "
            f"{save_bytes / 1e9:.3f} GB each")
        held = [(p, t.cpu()) for p, t in
                tree_flatten_with_path(train_mod.train_state(first.params, first.opt_state))]
        del first
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        like = [t for _, t in held]
        restored, step = CheckpointManager(tmp).restore(like)
        load_s = time.perf_counter() - t0
        check(step == T_STEPS, f"launcher: newest checkpoint is step {step}, not {T_STEPS}")
        for (path, want), got in zip(held, restored):
            check(got.dtype == want.dtype and torch.equal(raw_bits(got), raw_bits(want)),
                  f"checkpoint leaf {path} differs from the run's state")
        log(f"  checkpoint of step {T_STEPS} read back in {load_s:.2f} s: {len(held)} leaves "
            "bit-equal to the run's state")
        del held, restored, like
        second = run_path("T launcher resumed", (), lambda: train_mod.train(
            train_mod.parse_args(args + ["--steps", str(T_RESUME)]), dev), exact=NO_LM_KERNEL)
        check(second.start_step == T_STEPS and len(second.losses) == T_RESUME - T_STEPS
              and all(map(math.isfinite, second.losses)),
              f"launcher resume: start {second.start_step}, losses {second.losses}")
        log(f"  resumed at step {second.start_step}: losses {[round(x, 4) for x in second.losses]}")
        del second
    torch.cuda.empty_cache()


def guard_checks(dev):
    """K5, K6 and the Mamba2 gate raise on CUDA inputs that require grad
    under grad mode, and run under ``torch.no_grad``."""
    import torch

    from repro_torch.kernels.flash_attn.flash_attn import flash_attention
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
    from repro_torch.kernels.ssm_gate.ssm_gate import ssm_gate

    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((1, 64, 4, 64), generator=g, device=dev, requires_grad=True)
    k = torch.randn((1, 64, 2, 64), generator=g, device=dev)
    x = torch.randn((1, 64, 2, 32), generator=g, device=dev, requires_grad=True)
    dt = torch.rand((1, 64, 2), generator=g, device=dev)
    a = -torch.rand((2,), generator=g, device=dev)
    b = torch.randn((1, 64, 16), generator=g, device=dev)
    y, z, d = x.detach(), x.detach().reshape(1, 64, 64), a.detach()
    for name, call in (("flash_attention", lambda: flash_attention(q, k, k)),
                       ("ssd_scan", lambda: ssd_scan(x, dt, a, b, b, chunk=16)),
                       ("ssm_gate", lambda: ssm_gate(y, x, z, d, z[0, 0]))):
        try:
            call()
        except RuntimeError as e:
            check("no backward" in str(e), f"{name}: unexpected error {e}")
        else:
            raise SmokeError(f"{name} ran on an input that requires grad")
        with torch.no_grad():
            call()


# ------------------------------------------------------------ phase 17


def mrope_layout(text1: int, grid_h: int, grid_w: int, text2: int):
    """M-RoPE position ids ``(3, S)`` int32 of text, one image of ``grid_h
    x grid_w`` patches, then text, as Qwen2-VL assigns them (arXiv:2409.12191
    §2.1): a text token has t = h = w = its index; the image's patches
    share t and take h and w from their row and column, offset by the
    image's start; the text after it resumes one past the largest id so
    far."""
    import numpy as np

    t = np.arange(text1)
    pos = [np.stack([t, t, t])]
    rows, cols = np.meshgrid(np.arange(grid_h), np.arange(grid_w), indexing="ij")
    pos.append(np.stack([np.full(grid_h * grid_w, text1), text1 + rows.ravel(),
                         text1 + cols.ravel()]))
    t = text1 + max(grid_h, grid_w) + np.arange(text2)
    pos.append(np.stack([t, t, t]))
    return np.concatenate(pos, axis=1).astype(np.int32)


# The reduced records of the moe, vlm and encdec families
# (tests/data/torch_port_golden_families.json, written from the JAX
# package) are held with phase 11's tolerances (logits and first cache
# values rtol/atol 1e-3, cache norms 1e-4, serve-step tokens within 1e-2 of
# the step's largest logit) and phase 16's (losses 1e-4, the step-0
# gradient norm 1e-3).  The embeds and frames a record feeds are numpy draws
# from its seed, held to the record's L2 norm of them to DRAW_RTOL first.
DRAW_RTOL = 1e-6
FAMILY_SEED = 0
# M: mixtral-8x22b at full width, cut to 4 of its 56 layers
M_LAYERS, M_BATCH, M_PREFILL, M_GEN = 4, 2, 8192, 16
# V: qwen2-vl-7b whole; the prefill's M-RoPE layout: 64 text tokens, an
# image of 32 x 48 patches, 448 text tokens (2,048 positions)
V_BATCH, V_PREFILL, V_LAYOUT, V_PROMPT, V_GEN = 4, 2048, (64, 32, 48, 448), 128, 32
# W: whisper-tiny whole; 1,500 frames stand in for the stubbed conv frontend
W_BATCH, W_FRAMES, W_PREFILL, W_GEN = 4, 1500, 448, 32
# the float32 cross-checks, (arch, layers, config changes): M cut to 2
# layers, V to 4, 512 tokens at batch 1 (so that a decode step of the MoE
# keeps every slot).  M's random router drops slots in its prefill at top-2,
# where the check is not applicable; at top-8 of its 8 experts the capacity
# (1.25 x 512) exceeds each expert's 512 slots, nothing drops, and the
# prefill is held to its decode through the MoE's dispatch and combine
XF_TOKENS = 512
XF_CASES = [("mixtral_8x22b", 2, {}), ("mixtral_8x22b", 2, {"moe_top_k": 8}),
            ("qwen2_vl_7b", 4, {})]


def family_inputs(cfg, record, step=None):
    """The numpy inputs of a family record: the prefill's (``step`` None)
    or those of train step ``step``.  Tokens and labels come from the
    record; ``embeds`` (the vlm: N(0, 1 / d_model)) and ``frames`` (the
    encdec: 0.5 N(0, 1), ``record["frames"]`` of them) are drawn from
    ``numpy.random.default_rng(input_seed + 1 + step)`` (the prefill: step
    -1) and held against the record's L2 norm of the draw; ``positions3``
    is ``mrope_layout`` of the record's layout.  Returns ``(batch, draws)``,
    ``draws`` the L2 norms of what was drawn."""
    import numpy as np

    if step is None:
        seq, key = np.asarray(record["tokens"], np.int32), "prefill"
        s = record["prompt_len"]
        batch = {"tokens": seq[:, :s]}
    else:
        seq, key = np.asarray(record["train_sequences"][step], np.int32), f"train{step}"
        s = seq.shape[1] - 1
        batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    b = seq.shape[0]
    rng = np.random.default_rng(record["input_seed"] + 1 + (-1 if step is None else step))
    if cfg.family == "vlm":
        del batch["tokens"]
        batch["embeds"] = (rng.standard_normal((b, s, cfg.d_model))
                           / np.sqrt(cfg.d_model)).astype(np.float32)
        layout = record["layout"] if step is None else record["train_layout"]
        batch["positions3"] = np.broadcast_to(mrope_layout(*layout), (b, 3, s)).copy()
    if cfg.family == "encdec":
        batch["frames"] = (0.5 * rng.standard_normal((b, record["frames"], cfg.d_model))).astype(
            np.float32)
    draws = {k: float(np.linalg.norm(batch[k].astype(np.float64)))
             for k in ("embeds", "frames") if k in batch}
    for k, want in record.get("draws", {}).get(key, {}).items():
        check(abs(draws[k] - want) <= DRAW_RTOL * want,
              f"{record['name']}: this numpy draws other {k} for {key} (L2 {draws[k]} vs the "
              f"record's {want})")
    return batch, draws


def family_cache_components(cfg, cache):
    """Named tensors of a prefill cache of the attention families."""
    if cfg.family == "encdec":
        (k, v), (xk, xv) = cache
        return dict(k=k, v=v, xk=xk, xv=xv)
    k, v = cache
    return dict(k=k, v=v)


def family_k5_launches(cfg) -> int:
    """K5 launches of one prefill: a self-attention a layer, and for the
    encdec a cross-attention a decoder layer and the encoder's layers."""
    return cfg.num_layers * (2 if cfg.family == "encdec" else 1) + cfg.encoder_layers


def family_golden_check(record, dev, run_path=None):
    """Phase 17 (a) for one record: its serving run (``lm_golden_run`` on
    the record's inputs, ``prefill_step`` launching K5 once a layer and
    attention kind) and its training run (5 ``train_step``s, no K5)
    against the JAX package's values.  ``run_path``
    (``main``'s) counts the launches of each; without it the two run
    directly."""
    import functools

    from repro_torch.configs import get_config

    cfg = get_config(record["arch"]).reduced()
    name = record["name"]
    run = run_path or (lambda _name, _expect, fn, exact=None: fn())
    serving = lambda: lm_golden_run(  # noqa: E731
        record, dev, cfg, family_inputs(cfg, record)[0],
        functools.partial(family_cache_components, cfg))
    run(f"{name} serve", ("flash_attention",), lambda: serve_golden_check(record, *serving()),
        exact={"flash_attention": family_k5_launches(cfg)})
    batches = [family_inputs(cfg, record, i)[0] for i in range(len(record["losses"]))]
    losses, gn, _ = run(f"{name} train", (), lambda: train_golden_run(
        cfg, record, dev, False, batches), exact=NO_LM_KERNEL)
    for i, (got, want) in enumerate(zip(losses, record["losses"])):
        check(rel_err(got, want) <= TRAIN_LOSS_RTOL,
              f"{name}: loss of step {i} {got} vs {want} (rel {rel_err(got, want):.2e})")
    check(rel_err(gn, record["grad_norm0"]) <= TRAIN_GRAD_NORM_RTOL,
          f"{name}: step-0 gradient norm {gn} vs {record['grad_norm0']}")
    margin = record.get("min_router_margin")
    log(f"  {name}: {len(losses)} losses within "
        f"{max(rel_err(g, w) for g, w in zip(losses, record['losses'])):.2e} (rtol "
        f"{TRAIN_LOSS_RTOL:g}), step-0 gradient norm within {rel_err(gn, record['grad_norm0']):.2e}"
        + (f"; smallest margin between the router's k-th and (k+1)-th logit {margin:.3g}"
           if margin is not None else ""))


class MoEPlans:
    """While open, ``models.model.moe_ffn`` records each call's token
    count and plan (slot experts, ranks, kept slots)."""

    def __enter__(self):
        from repro_torch.models import model as model_mod

        self.mod, self.fn, self.calls = model_mod, model_mod.moe_ffn, []

        def wrapped(x, *args, **kwargs):
            y, aux, plan = self.fn(x, *args, **kwargs)
            self.calls.append((x.shape[0], plan))
            return y, aux, plan

        model_mod.moe_ffn = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.moe_ffn = self.fn

    def kept(self, n=None):
        """The kept share of each call (of ``n`` tokens, where given)."""
        return [float(plan[2].float().mean()) for m, plan in self.calls if n is None or m == n]


def capture_k5(keep, path):
    """Replace the model's ``flash_attention`` by a wrapper that keeps the
    first call's arguments of each (path, q shape, k shape, causal, window)
    in ``keep``; returns the undo function."""
    from repro_torch.models import attention

    fn = attention.flash_attention

    def wrapped(q, k, v, causal=True, sliding_window=0, q_offset=0):
        keep.setdefault((path, tuple(q.shape), tuple(k.shape), causal, sliding_window),
                        ((q, k, v), dict(causal=causal, sliding_window=sliding_window)))
        return fn(q, k, v, causal=causal, sliding_window=sliding_window, q_offset=q_offset)

    attention.flash_attention = wrapped
    return lambda: setattr(attention, "flash_attention", fn)


def full_width_model(arch, dev, **changes):
    """``init_params`` of ``arch`` (with ``changes``) on ``dev`` from
    FAMILY_SEED; logs its size and draw seconds."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config(arch), **changes)
    t0 = time.perf_counter()
    model = init_params(cfg, FAMILY_SEED, device=dev)
    sync(dev)
    n = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}, {cfg.num_layers} layers: {n:,} parameters in {cfg.param_dtype} "
        f"({n * model.embed.element_size() / 1e9:.2f} GB), drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, model


def prefill_run(name, cfg, model, batch, dev, run_path, keep):
    """``prefill_step`` of a full-width path: launched through ``run_path``
    with K5 once a layer and attention kind; host ms of the first call,
    CUDA-event ms of two more, the card's peak, one more under
    ``torch.profiler``; finite logits and cache.  Returns ``(last logits,
    cache, plans)``."""
    import torch

    from repro_torch.launch.steps import make_prefill_step

    step = make_prefill_step(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    undo = capture_k5(keep, name)
    try:
        with MoEPlans() as plans:
            host, (last, cache) = run_path(
                f"{name} prefill", ("flash_attention",), lambda: host_ms(lambda: step(model, batch),
                                                                         dev),
                exact={"flash_attention": family_k5_launches(cfg)})
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    ms = cuda_ms(lambda: step(model, batch), dev, reps=2)
    check(bool(torch.isfinite(last).all()), f"path {name}: non-finite prefill logits")
    comps = family_cache_components(cfg, cache)
    for k, t in comps.items():
        check(bool(torch.isfinite(t).all()), f"path {name}: non-finite prefill cache {k}")
    shape = next(v for v in batch.values() if v.dim() >= 2).shape
    toks = shape[0] * shape[1]
    log(f"  prefill_step on {tuple(shape)}: {ms:.1f} ms by CUDA events ({toks / ms * 1e3:,.0f} "
        f"tokens/s), {host:.1f} ms host clock on the first call, peak allocation {peak:.2f} GB; "
        f"logits {tuple(last.shape)} finite, cache "
        + ", ".join(f"{k} {tuple(t.shape)}" for k, t in comps.items()))
    if plans.calls:
        log(f"  kept share of each MoE layer's plan: {[round(x, 4) for x in plans.kept()]}")
    if name != "W":  # W's prefill takes ~3 ms of host-bound launches
        profile_share(f"{name}'s prefill_step", lambda: step(model, batch), dev)
    return last, cache, plans


def serve_steps(name, cfg, model, tok, cache, gen, dev, run_path):
    """``gen`` greedy ``serve_step``s from ``cache`` fed ``tok`` first:
    tokens in the padded vocabulary, host seconds; then one more step
    under ``torch.profiler``."""
    import torch

    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import padded_vocab

    step = make_serve_step(cfg)

    def loop():
        nonlocal tok, cache
        out = []
        for _ in range(gen):
            tok, cache = step(model, tok, cache)
            out.append(tok)
        return torch.cat(out, dim=1)

    ms, out = run_path(f"{name} serve", (), lambda: host_ms(loop, dev))
    out = out.cpu()
    check(bool(((out >= 0) & (out < padded_vocab(cfg.vocab_size))).all()),
          f"path {name}: served token ids out of the padded vocabulary")
    b = out.shape[0]
    log(f"  {gen} serve steps from the prefill's cache: {ms / 1e3:.2f} s host clock "
        f"({b * gen / ms * 1e3:.1f} tokens/s); sample {out[0, :8].tolist()}")
    profile_share(f"one of {name}'s serve steps", lambda: step(model, tok, cache), dev)
    return cache


def path_m(dev, run_path, keep):
    """Phase 17 (b), M: mixtral-8x22b at full width cut to M_LAYERS
    layers, bfloat16: ``prefill_step`` on M_BATCH x M_PREFILL tokens (a
    windowed K5 launch a layer), the kept share of each layer's plan;
    ``decode_cache_from_prefill`` into a ring of ``sliding_window`` slots,
    each bit-equal to the prefill's k / v at the position it holds; then
    M_GEN serve steps from it."""
    import torch

    from repro_torch.launch.steps import decode_cache_from_prefill

    cfg, model = full_width_model("mixtral_8x22b", dev, num_layers=M_LAYERS)
    g = torch.Generator(device=dev).manual_seed(FAMILY_SEED)
    tokens = torch.randint(0, cfg.vocab_size, (M_BATCH, M_PREFILL + 1), generator=g, device=dev,
                           dtype=torch.int32)
    _, cache, _ = prefill_run("M", cfg, model, {"tokens": tokens[:, :-1]}, dev, run_path, keep)
    w = cfg.sliding_window
    dcache = decode_cache_from_prefill(cfg, cache, M_PREFILL, M_PREFILL + M_GEN + 1)
    check(dcache["k"].shape[2] == w, f"path M: ring of {dcache['k'].shape[2]} slots, not {w}")
    pos = torch.arange(M_PREFILL - w, M_PREFILL, device=dev)
    for i, name in enumerate(("k", "v")):
        check(torch.equal(raw_bits(dcache[name][:, :, pos % w]), raw_bits(cache[i][:, :, pos])),
              f"path M: a ring slot of {name} differs from the prefill's {name} at its position")
    log(f"  decode_cache_from_prefill: a ring of {w} slots holding positions {M_PREFILL - w}-"
        f"{M_PREFILL - 1}, each slot's k and v bit-equal to the prefill's at its position")
    del cache
    serve_steps("M", cfg, model, tokens[:, -1:], dcache, M_GEN, dev, run_path)
    del model, dcache
    torch.cuda.empty_cache()


def path_v(dev, run_path, keep):
    """Phase 17 (b), V: qwen2-vl-7b whole, bfloat16: ``prefill_step`` on
    V_BATCH x V_PREFILL ``embeds`` (N(0, 1 / d_model) from a seeded
    generator) with the M-RoPE layout V_LAYOUT; then the serve loop
    answering V_BATCH requests of V_PROMPT prompt tokens with V_GEN
    tokens."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import prompt_tokens, serve_loop
    from repro_torch.models import decode_step, init_cache

    cfg, model = full_width_model("qwen2_vl_7b", dev)
    g = torch.Generator(device=dev).manual_seed(FAMILY_SEED)
    embeds = (torch.randn((V_BATCH, V_PREFILL, cfg.d_model), generator=g, device=dev)
              * cfg.d_model**-0.5).to(cfg.activation_dtype)
    pos3 = torch.from_numpy(mrope_layout(*V_LAYOUT)).to(dev).expand(V_BATCH, 3, V_PREFILL)
    prefill_run("V", cfg, model, {"embeds": embeds, "positions3": pos3}, dev, run_path, keep)
    del embeds
    tokens = prompt_tokens(np.random.default_rng(FAMILY_SEED), cfg.vocab_size, V_BATCH, V_PROMPT)
    res = run_path("V serve", (), lambda: serve_loop(cfg, model, tokens, V_GEN))
    check(res.gen.shape == (V_BATCH, V_GEN), f"path V serve: tokens {res.gen.shape}")
    check(bool(torch.isfinite(res.prompt_logits).all()), "path V serve: non-finite logits")
    log(f"  serve loop: {V_BATCH} requests, {V_PROMPT} prompt tokens fed in {res.prefill_s:.2f} s "
        f"({V_PROMPT / res.prefill_s:.1f} steps/s), {V_GEN} tokens generated in "
        f"{res.decode_s:.2f} s ({V_BATCH * V_GEN / res.decode_s:.1f} tokens/s); sample "
        f"{res.gen[0, :8].tolist()}")
    cache = init_cache(cfg, V_BATCH, V_PROMPT + V_GEN + 1, device=dev)
    tok = torch.from_numpy(tokens[:, :1]).to(dev)
    decode_step(cfg, model, tok, cache)
    profile_share("one of V's decode steps", lambda: decode_step(cfg, model, tok, cache), dev)
    del model, res, cache
    torch.cuda.empty_cache()


def path_w(dev, run_path, keep):
    """Phase 17 (b), W: whisper-tiny whole, bfloat16: frames (W_BATCH,
    W_FRAMES, d_model) from a seeded generator, ``prefill_step`` on
    W_BATCH x W_PREFILL decoder tokens (the encoder's non-causal K5, the
    decoder's causal and cross K5 a layer each), the decode cache with the
    frames' cross keys and values, then W_GEN serve steps from it."""
    import torch

    from repro_torch.launch.steps import decode_cache_from_prefill

    cfg, model = full_width_model("whisper_tiny", dev)
    g = torch.Generator(device=dev).manual_seed(FAMILY_SEED)
    frames = torch.randn((W_BATCH, W_FRAMES, cfg.d_model), generator=g, device=dev).to(
        cfg.activation_dtype)
    tokens = torch.randint(0, cfg.vocab_size, (W_BATCH, W_PREFILL + 1), generator=g, device=dev,
                           dtype=torch.int32)
    _, cache, _ = prefill_run("W", cfg, model, {"tokens": tokens[:, :-1], "frames": frames}, dev,
                              run_path, keep)
    dcache = decode_cache_from_prefill(cfg, cache, W_PREFILL, W_PREFILL + W_GEN + 1)
    check(dcache["xk"].shape[2] == W_FRAMES and dcache["xlen"].tolist() == [W_FRAMES] * W_BATCH,
          f"path W: cross cache {tuple(dcache['xk'].shape)}, xlen {dcache['xlen'].tolist()}")
    del cache
    serve_steps("W", cfg, model, tokens[:, -1:], dcache, W_GEN, dev, run_path)
    del model, dcache
    torch.cuda.empty_cache()


def family_xcheck(arch, layers, changes, dev, run_path):
    """Phase 17 (b), float32: ``arch`` at full width cut to ``layers``
    layers (with the config ``changes``), the prefill of XF_TOKENS tokens
    at batch 1 against the same tokens decoded one by one, beside the
    witness (``launch/drift.py``).
    Every reading (relative L2 of k, v and the logits) must lie within
    twice the larger of the witness's distance and the one-ulp move (the
    model's own float32 noise: a shallow model's witness may sit below
    it), and within XCHECK_REL_L2.  The check applies where no MoE layer of
    the prefill drops a slot (a decode step at batch 1 never does); where
    one does, it is reported as not applicable, and the prefill is held to
    the same prefill through the plain version of K5 instead: equal plans,
    and within XCHECK_REL_L2.  With ``moe_top_k`` equal to ``moe_experts``
    no slot can drop, and the check must apply."""
    import numpy as np

    from repro_torch.launch.drift import prefill_decode_drift
    from repro_torch.launch.serve import prompt_tokens

    cfg, model = full_width_model(arch, dev, num_layers=layers, dtype="float32",
                                  param_dtype="float32", **changes)
    name = arch + "".join(f" {k} {v}" for k, v in changes.items())
    tokens = prompt_tokens(np.random.default_rng(FAMILY_SEED), cfg.vocab_size, 1, XF_TOKENS)
    with MoEPlans() as plans:
        d = run_path(f"{name} float32 cross-check", ("flash_attention",),
                     lambda: prefill_decode_drift(cfg, model, tokens, FAMILY_SEED),
                     exact={"flash_attention": 2 * cfg.num_layers})  # two prefills on K5
    del model

    def fmt(x):
        return json.dumps({k: float(f"{v:.3g}") for k, v in x.items()})

    errs, wit, ulp = d["prefill_vs_decode"], d["plain_vs_decode"], d["one_ulp_move"]
    log(f"  float32 prefill vs token-by-token decode of the same (1, {XF_TOKENS}) prompt (decode "
        f"{d['decode_s']:.1f} s), relative L2: kernels {fmt(errs)}; witness (plain K5) "
        f"{fmt(wit)}; kernels vs witness {fmt(d['prefill_vs_plain'])}; one-ulp move {fmt(ulp)}")
    per_layer = [float(f"{v:.2g}") for v in d["layer_state"]]
    log(f"  per layer, k vs decode: kernels {json.dumps(per_layer)}")
    applies = True
    if plans.calls:
        prefill_plans = [p for n, p in plans.calls if n == XF_TOKENS]
        kept, decode_kept = plans.kept(XF_TOKENS)[:layers], plans.kept(1)
        check(min(decode_kept) == 1.0, f"{name}: a decode step at batch 1 dropped a slot")
        log(f"  kept share of the prefill's MoE plans {[round(x, 4) for x in kept]}; the "
            f"decode's {len(decode_kept)} MoE calls keep every slot")
        applies = min(kept) == 1.0
        check(applies or cfg.moe_top_k < cfg.moe_experts,
              f"{name}: the prefill dropped slots at top-k {cfg.moe_top_k} of {cfg.moe_experts}")
    if not applies:
        same = all(all(bool((a == b).all()) for a, b in zip(p, q))
                   for p, q in zip(prefill_plans[:layers], prefill_plans[layers:2 * layers]))
        check(same, f"{name}: the prefill's plans through K5 and through its plain version differ")
        worst = max(d["prefill_vs_plain"].values())
        log(f"  prefill vs decode: not applicable, the prefill drops slots (kept share "
            f"{min(kept):.4f}); the prefill through K5 against the same through the plain "
            f"version, plans equal: relative L2 {worst:.3g} (limit {XCHECK_REL_L2:g})")
        check(worst <= XCHECK_REL_L2, f"{name}: K5's prefill vs the plain version's {worst}")
        return worst
    over = {k: v for k, v in errs.items() if v > XCHECK_WITNESS_RATIO * max(wit[k], ulp[k])}
    check(not over, f"{name} cross-check: {over} more than {XCHECK_WITNESS_RATIO} x the larger of "
          f"the witness's {wit} and the one-ulp move {ulp}")
    worst = max(errs.values())
    check(worst <= XCHECK_REL_L2, f"{name} cross-check: relative L2 {errs} > {XCHECK_REL_L2}")
    return worst


def time_k5_model_shapes(keep, dev, errs):
    """Phase 17 (c): K5 on the inputs of its first call of each kind in
    M's, V's and W's prefills (``time_k5``)."""
    out = []
    for (path, qs, ks, causal, win), ((q, k, v), _) in keep.items():
        b, sq, h, hd = qs
        shape = (f"path {path}: q ({b}, {sq}, {h}, {hd}), k, v ({b}, {ks[1]}, {ks[2]}, {hd}) "
                 f"{str(q.dtype)[6:]}, {'causal' if causal else 'non-causal'}"
                 + (f", window {win}" if win else ""))
        t = time_k5(q, k, v, causal, win, dev, shape)
        errs["flash_attention"] = max(errs["flash_attention"], t["max_abs_err"])
        out.append(dict(shape=shape, **t))
    return out


def phase17(gold: dict, dev, run_path, errs) -> list:
    """The moe, vlm and encdec families: (a) the reduced records, (b) M,
    V and W at full width in bfloat16 and the float32 cross-checks of M
    and V, (c) K5 timed at the shapes of M's, V's and W's prefills.
    Returns (c)'s entries."""
    import torch

    t0 = time.perf_counter()
    for rec in gold["records"]:
        family_golden_check(rec, dev, run_path)
    keep = {}
    path_m(dev, run_path, keep)
    path_v(dev, run_path, keep)
    path_w(dev, run_path, keep)
    for arch, layers, changes in XF_CASES:
        family_xcheck(arch, layers, changes, dev, run_path)
        torch.cuda.empty_cache()
    # W's causal decoder self-attention (448 positions, hd 64) is left out:
    # path F times K5 causal at hd 64
    keep = {key: call for key, call in keep.items() if not (key[0] == "W" and key[3])}
    shapes = time_k5_model_shapes(keep, dev, errs)
    del keep
    torch.cuda.empty_cache()
    log(f"  phase 17 seconds {time.perf_counter() - t0:.1f}")
    return shapes


# ------------------------------------------------------------ phase 18
# Cell L: zamba2-1.2b (6 shared-attention groups of 32 kv heads x 64) at
# long_500k: one request whose KV cache spans 524,288 positions (25.8 GB in
# bfloat16), decoded once whole and once split by sequence over two ranks of
# a gloo group on the one card (NCCL refuses two ranks on one device; gloo's
# all-reduce takes CUDA tensors).  Two checks hold the sharded decode to the
# unsharded one, in both runs (from the prefill, and over the filled cache):
#
# The layer.  Shared-attention group L_GROUP's call of every unsharded step
# is kept: its q, the k / v row it inserted, its length and its output.  Each
# rank replays those calls through decode_attention_seqsharded on a copy of
# its shard of that group's cache taken before the first step (the prompt's
# rows the unsharded run's, so both start from the same cache), and each
# output must lie within one bfloat16 ulp of the unsharded output, element by
# element: both score in float32 and differ only in the order of their sums,
# then round to bfloat16 once.  The two ranks' outputs must be equal, and the
# owner rank's copy must hold every inserted row at its position.
#
# The model.  The sharded steps are fed the unsharded run's tokens (teacher
# forcing).  A random 38-layer model moves its logits far under a float32
# reorder, so the bound is measured: the unsharded steps run again, fed the
# same tokens, with every attention call's sums taken over L_REORDER_PARTS
# equal runs of the cache's positions and combined by a max / sum written
# here in plain PyTorch (one run per count of parts), and the reorder bound
# of a step is the largest distance (max abs) of those runs' logits from the
# unsharded logits at that step or before it.  A sharded step's logits must
# lie within L_REORDER_RATIO times that bound of the unsharded step's, and
# its token must equal the unsharded one unless the unsharded top-2 gap is
# within the bound itself, and then be within the bound of the largest
# logit.
L_GROUP = 0
L_REORDER_PARTS = (2, 4, 8)
L_REORDER_RATIO = 2.0
L_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class LCell:
    arch: str = "zamba2_1p2b"
    reduced: bool = False  # the config's reduced() (a CPU rehearsal) in bfloat16
    seed: int = 0
    prompt: int = 8192  # tokens of the prefill
    max_len: int = 524_288  # positions of the cache (SHAPES["long_500k"])
    steps: int = 16
    fill_len: int = 524_280  # the second check's length: its inserts land in rank 1's last slots
    fill_steps: int = 8
    ranks: int = 2
    chunk: int = 8192  # positions of one seeded draw of the second check's keys and values

    def model(self, dev):
        """``(cfg, init_params model, the prompt (1, prompt) int32)``."""
        import torch

        from repro_torch.configs import get_config
        from repro_torch.models import init_params

        cfg = get_config(self.arch)
        if self.reduced:
            cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16", param_dtype="bfloat16")
        model = init_params(cfg, self.seed, device=dev)
        g = torch.Generator(device=dev).manual_seed(self.seed)
        tokens = torch.randint(0, cfg.vocab_size, (1, self.prompt), generator=g, device=dev,
                               dtype=torch.int32)
        return cfg, model, tokens

    def fill(self, cache, lo: int, dev):
        """Seeded N(0, 1) keys and values at global positions ``[prompt,
        fill_len)`` of an attention cache holding positions ``[lo, lo +
        S)``, chunk by chunk, so that a shard draws the same numbers as the
        whole cache at the positions it holds; then ``len = fill_len``."""
        import torch

        groups, b, s, kv, hd = cache["g_k"].shape
        for c in range(self.prompt // self.chunk, self.max_len // self.chunk):
            a = max(c * self.chunk, self.prompt, lo)
            z = min((c + 1) * self.chunk, self.fill_len, lo + s)
            if a >= z:
                continue
            for g in range(groups):
                for j, name in enumerate(("g_k", "g_v")):
                    gen = torch.Generator(device=dev).manual_seed((g * 2 + j) * 100_000 + c)
                    x = torch.randn((b, self.chunk, kv, hd), generator=gen, device=dev)
                    cache[name][g, :, a - lo:z - lo] = x[:, a - c * self.chunk:
                                                         z - c * self.chunk].to(cache[name].dtype)
        cache["len"].fill_(self.fill_len)


CELL_L = LCell()


class DecodeCalls:
    """While entered, every ``decode_step`` keeps the last position's
    logits (``models.model._logits``, wrapped) and the call of
    shared-attention group ``group`` of ``groups`` (``decode_attention``,
    wrapped: its q, the k / v row at position ``len - 1``, which the step
    has just inserted, ``len - 1``, and its output), all on the CPU.
    ``attend`` replaces ``decode_attention`` (a reordered combine)."""

    def __init__(self, groups: int, group: int = L_GROUP, attend=None):
        self.groups, self.group, self.attend = groups, group, attend

    def __enter__(self):
        import torch

        from repro_torch.models import model as mm

        self.mm, self.orig = mm, (mm._logits, mm.decode_attention)
        self.logits, self.calls, n = [], [], [0]
        attend = self.attend or self.orig[1]

        def logits(*a):
            out = self.orig[0](*a)
            self.logits.append(out[0, -1].float().cpu())
            return out

        def decode_attention(q, k_cache, v_cache, cache_len, sliding_window=0):
            out = attend(q, k_cache, v_cache, cache_len, sliding_window=sliding_window)
            if n[0] % self.groups == self.group:
                pos = (cache_len - 1).long()
                rows = torch.arange(q.shape[0], device=q.device)
                self.calls.append(dict(q=q.cpu(), k_new=k_cache[rows, pos][:, None].cpu(),
                                       v_new=v_cache[rows, pos][:, None].cpu(),
                                       len=(cache_len - 1).cpu(), out=out.cpu()))
            n[0] += 1
            return out

        mm._logits, mm.decode_attention = logits, decode_attention
        return self

    def __exit__(self, *exc):
        self.mm._logits, self.mm.decode_attention = self.orig


def split_attention(parts: int):
    """``decode_attention`` (no window) with its sums taken over ``parts``
    equal runs of the cache's positions: float32 scores, the largest over
    all runs, each run's exponentials, then the runs' sums added in order.
    Plain PyTorch, apart from the port (the reorder bound's steps)."""
    import torch

    def attend(q, k_cache, v_cache, cache_len, sliding_window=0):
        check(not sliding_window, "cell L: the reorder run takes no window")
        b, s, kv, hd = k_cache.shape
        h, n = q.shape[2], s // parts
        scale = torch.tensor(hd ** -0.5, dtype=q.dtype, device=q.device)
        qf = (q[:, 0] * scale).float().reshape(b, kv, h // kv, hd)  # scaled in q's dtype
        scores = []
        for j in range(parts):
            sc = torch.einsum("bkgd,bskd->bkgs", qf, k_cache[:, j * n:(j + 1) * n].float())
            pos = j * n + torch.arange(n, device=q.device)
            scores.append(torch.where((pos[None, :] < cache_len[:, None])[:, None, None, :],
                                      sc, -1e30))
        top = torch.stack([sc.amax(dim=-1) for sc in scores]).amax(dim=0)
        den, num = 0.0, 0.0
        for j, sc in enumerate(scores):
            p = torch.exp(sc - top[..., None])
            den = den + p.sum(dim=-1)
            num = num + torch.einsum("bkgs,bskd->bkgd", p, v_cache[:, j * n:(j + 1) * n].float())
        return (num / den[..., None]).reshape(b, 1, h, hd).to(q.dtype)

    return attend


def l_decode(model, cache, feed, dev, step, groups: int, greedy: bool, attend=None):
    """``feed.shape[1]`` serve steps from ``cache``: fed ``feed[0]`` and
    then their own tokens (``greedy``) or ``feed[i]`` at step i (teacher
    forcing), under ``DecodeCalls(groups, attend=attend)``; returns ``dict(feed
    (1, n), tokens (n,), logits (n, V) float32, calls, ms)`` on the CPU, ms
    on the host clock, synchronized."""
    import torch

    tok, inputs, toks, ms = feed[:, :1], [], [], []
    with DecodeCalls(groups, attend=attend) as kept:
        for i in range(feed.shape[1]):
            if not greedy:
                tok = feed[:, i:i + 1]
            inputs.append(tok)
            sync(dev)
            t0 = time.perf_counter()
            tok, cache = step(model, tok, cache)
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            toks.append(int(tok[0, 0]))
    return dict(feed=torch.cat(inputs, dim=1).cpu(), tokens=torch.tensor(toks),
                logits=torch.stack(kept.logits), calls=kept.calls, ms=ms)


def l_reference(cell, cfg, model, tokens, dev, run_path):
    """The unsharded run: the prefill (through ``run_path``: K5 x 6, K6 x
    38), the whole cache, ``steps`` greedy serve steps, then the same steps
    fed their tokens once for each of ``L_REORDER_PARTS`` (the reorder
    bound's runs); then the same over the cache filled to ``fill_len``, for
    ``fill_steps``.  Also returns group ``L_GROUP``'s keys and values of the
    prompt (for the ranks' replay copies)."""
    import torch

    from repro_torch.launch.steps import (
        decode_cache_from_prefill,
        make_prefill_step,
        make_serve_step,
    )

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prefill = make_prefill_step(cfg)
    groups = cfg.num_layers // cfg.hybrid_attn_every
    host, (last, pcache) = run_path(
        "L prefill", ("flash_attention", "ssd_scan"),
        lambda: host_ms(lambda: prefill(model, {"tokens": tokens}), dev),
        exact={"flash_attention": groups, "ssd_scan": cfg.num_layers})
    check(bool(torch.isfinite(last).all()), "cell L: non-finite prefill logits")
    first = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    step = make_serve_step(cfg)
    runs, prompt_kv = [], None
    for fill, n in ((False, cell.steps), (True, cell.fill_steps)):
        cache = decode_cache_from_prefill(cfg, pcache, cell.prompt, cell.max_len)
        if fill:
            cell.fill(cache, 0, dev)
        else:
            prompt_kv = tuple(cache[k][L_GROUP, :, :cell.prompt].cpu() for k in ("g_k", "g_v"))
        start = {k: v.clone() for k, v in cache.items() if k not in ("g_k", "g_v")}
        nbytes = sum(cache[k].numel() * cache[k].element_size() for k in ("g_k", "g_v"))
        run = l_decode(model, cache, first.expand(1, n), dev, step, groups, True)
        run["reorder"] = []
        for parts in L_REORDER_PARTS:
            for k, v in start.items():  # the rows past len are rewritten before they are read
                cache[k].copy_(v)
            again = l_decode(model, cache, run["feed"].to(dev), dev, step, groups, False,
                             attend=split_attention(parts))
            run["reorder"].append(again["logits"])
        runs.append(dict(run, cache_bytes=nbytes))
        del cache
        if cuda:
            torch.cuda.empty_cache()
    return dict(prefill_ms=host, runs=runs, prompt_kv=prompt_kv,
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else 0.0)


def l_replay(cell, calls, kv, lo: int, mesh):
    """Group ``L_GROUP``'s unsharded calls replayed through
    ``decode_attention_seqsharded`` on ``kv`` (this rank's copies of that
    group's shards, positions ``[lo, lo + S/n)``); returns the outputs and
    whether every inserted row this rank owns sits at its position."""
    import torch

    from repro_torch.models.attention import decode_attention_seqsharded

    k, v = kv
    dev, s = k.device, k.shape[1]
    outs, held = [], True
    for c in calls:
        out, k, v = decode_attention_seqsharded(c["q"].to(dev), k, v, c["len"].to(dev), mesh,
                                                k_new=c["k_new"].to(dev),
                                                v_new=c["v_new"].to(dev))
        outs.append(out.cpu())
        p = int(c["len"][0]) - lo
        if 0 <= p < s:
            held &= bool(torch.equal(k[:, p].cpu(), c["k_new"][:, 0])
                         and torch.equal(v[:, p].cpu(), c["v_new"][:, 0]))
    return outs, held


def l_rank(rank, port, cell, ref_path, dev_type, out_path):
    """One rank of the sharded run (a spawned process; on the card every
    rank takes ``cuda:0``): its own prefill, only its shard of the cache
    (``decode_cache_from_prefill(seq_shard=)``), the serve steps of
    ``make_serve_step(cfg, mesh, seq_sharded=True)`` fed the unsharded
    tokens; then the replay of group ``L_GROUP``'s unsharded calls
    (:func:`l_replay`) on a copy of its shard of that group taken before
    the steps."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import flash_attn as fa_mod
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_mod
    from repro_torch.launch.steps import (
        decode_cache_from_prefill,
        make_prefill_step,
        make_serve_step,
    )

    dev = torch.device(dev_type, 0) if dev_type == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        build.build([fa_mod.SOURCE, ssd_mod.SOURCE])
    ref = torch.load(ref_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=cell.ranks)
    try:
        mesh = init_device_mesh(dev.type, (cell.ranks, 1), mesh_dim_names=("data", "model"))
        cfg, model, tokens = cell.model(dev)
        groups = cfg.num_layers // cfg.hybrid_attn_every
        fa_mod.flash_attention.launches = ssd_mod.ssd_scan.launches = 0
        _, pcache = make_prefill_step(cfg)(model, {"tokens": tokens})
        sync(dev)
        out = {"k5": fa_mod.flash_attention.launches, "k6": ssd_mod.ssd_scan.launches,
               "backend": dist.get_backend(), "runs": []}
        step = make_serve_step(cfg, mesh=mesh, seq_sharded=True)
        lo = rank * (cell.max_len // cell.ranks)
        for fill, run in zip((False, True), ref["runs"]):
            cache = decode_cache_from_prefill(cfg, pcache, cell.prompt, cell.max_len,
                                              seq_shard=(rank, cell.ranks))
            if fill:
                cell.fill(cache, lo, dev)
            shard = tuple(cache["g_k"].shape)
            kv = [cache[k][L_GROUP].clone() for k in ("g_k", "g_v")]
            mine = slice(lo, min(lo + shard[2], cell.prompt))
            prompt_diff = 0.0  # this rank's prefill rows against the unsharded run's
            for t, want in zip(kv, ref["prompt_kv"]):
                if mine.start < mine.stop:
                    got = t[:, :mine.stop - lo]
                    prompt_diff = max(prompt_diff, float((got.float().cpu()
                                                          - want[:, mine].float()).abs().max()))
                    got.copy_(want[:, mine].to(dev))
            res = l_decode(model, cache, run["feed"].to(dev), dev, step, groups, False)
            del cache
            res["layer"], res["held"] = l_replay(cell, run["calls"], kv, lo, mesh)
            del kv
            out["runs"].append(dict(res, shard=shard, prompt_diff=prompt_diff))
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
        torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def l_rank_entry(rank, port, cell, ref_path, dev_type, paths):
    l_rank(rank, port, cell, ref_path, dev_type, paths[rank])


def l_sharded(cell, ref, dev_type):
    """Spawn the ranks and return their results; a rank that fails or a run
    past L_TIMEOUT_S fails the phase (the ranks are killed)."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_phase18_") as tmp:
        ref_path = str(Path(tmp) / "reference.pt")
        torch.save(dict(prompt_kv=ref["prompt_kv"],
                        runs=[dict(feed=r["feed"], calls=r["calls"]) for r in ref["runs"]]),
                   ref_path)
        paths = [str(Path(tmp) / f"rank{r}.pt") for r in range(cell.ranks)]
        ctx = mp.start_processes(l_rank_entry, args=(port, cell, ref_path, dev_type, paths),
                                 nprocs=cell.ranks, join=False, start_method="spawn")
        deadline = time.perf_counter() + L_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                check(time.perf_counter() < deadline,
                      f"cell L: the sharded ranks ran past {L_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        return [torch.load(p, weights_only=False) for p in paths]


def bf16_ulp(x):
    """The larger spacing of each element of the bfloat16 ``x`` to its
    neighbours, in float32."""
    import torch

    inf = torch.full_like(x, float("inf"))
    return torch.maximum(torch.nextafter(x, inf) - x, x - torch.nextafter(x, -inf)).float()


def l_layer_check(what, run, ranks, j):
    """Each rank's replayed outputs within one bfloat16 ulp of the
    unsharded calls', equal on every rank, the inserts held; returns the
    largest error in ulps.  An element below 1/256 of the output's largest
    takes the ulp of that share: the float32 sums' rounding follows the
    sizes of their terms, not of a total that cancels to near zero."""
    import torch

    worst = 0.0
    for r, res in enumerate(ranks):
        got = res["runs"][j]
        check(got["held"], f"cell L {what}: rank {r} does not hold every row it inserted")
        for i, (c, out) in enumerate(zip(run["calls"], got["layer"])):
            want = c["out"]
            ulp = torch.maximum(bf16_ulp(want), bf16_ulp(want.abs().amax() / 256))
            err = float(((out.float() - want.float()).abs() / ulp).max())
            check(err == err, f"cell L {what} step {i}: rank {r}'s layer output is not finite")
            check(err <= 1.0, f"cell L {what} step {i}: rank {r}'s group-{L_GROUP} output "
                  f"{err:.3g} bfloat16 ulps from the unsharded one")
            check(torch.equal(out, ranks[0]["runs"][j]["layer"][i]),
                  f"cell L {what} step {i}: ranks 0 and {r} disagree on the layer's output")
            worst = max(worst, err)
    return worst


def l_compare(what, ref, got):
    """The margin rule over one run's steps against the reorder bound;
    returns ``(the largest logit error as a share of the tolerance, tokens
    equal, the near ties taken, the steps whose logits equal each reorder
    run's bit for bit)``."""
    import torch

    worst, ties = 0.0, []
    dist = [(r - ref["logits"]).abs().amax(dim=-1) for r in ref["reorder"]]
    bound = torch.stack(dist).amax(dim=0).cummax(dim=0).values
    same = [sum(torch.equal(a, b) for a, b in zip(got["logits"], r)) for r in ref["reorder"]]
    for i in range(ref["logits"].shape[0]):
        want, have = ref["logits"][i], got["logits"][i]
        b = float(bound[i])
        tol = L_REORDER_RATIO * b
        err = float((have - want).abs().max())
        top = torch.topk(want, 2).values
        gap = float(top[0] - top[1])
        tok, ref_tok = int(got["tokens"][i]), int(ref["tokens"][i])
        log(f"    {what} step {i}: logits {err:.4g} from the unsharded step's, reorder bound "
            f"{b:.4g} (" + ", ".join(f"{p} parts {float(d[i]):.4g}" for p, d in
                                     zip(L_REORDER_PARTS, dist))
            + f"), top-2 gap {gap:.4g}, token {tok} vs {ref_tok}")
        worst = max(worst, err / tol if tol else (0.0 if err == 0 else float("inf")))
        check(err <= tol, f"cell L {what} step {i}: logits differ by {err:.4g} > {tol:.4g}")
        if tok != ref_tok:
            check(gap <= b and float(top[0] - want[tok]) <= b,
                  f"cell L {what} step {i}: token {tok} != {ref_tok}, the top-2 gap {gap:.4g} "
                  f"and its own gap {float(top[0] - want[tok]):.4g} against the reorder bound "
                  f"{b:.4g}")
            ties.append(i)
    return worst, int((got["tokens"] == ref["tokens"]).sum()), ties, same


def phase18(dev, run_path, cell=CELL_L):
    """Cell L: the unsharded reference with its reorder runs, then the
    sequence-sharded decode on ``cell.ranks`` spawned gloo ranks, held to
    it layer by layer and by the margin rule."""
    import statistics

    import torch

    t0 = time.perf_counter()
    cfg, model, tokens = cell.model(dev)
    ref = l_reference(cell, cfg, model, tokens, dev, run_path)
    del model, tokens
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0
    ranks = l_sharded(cell, ref, dev.type)
    t_all = time.perf_counter() - t0
    groups = cfg.num_layers // cfg.hybrid_attn_every
    for r, res in enumerate(ranks):  # the CPU runs the plain versions, which count nothing
        check(dev.type != "cuda" or (res["k5"] == groups and res["k6"] == cfg.num_layers),
              f"cell L rank {r}: its prefill launched K5 {res['k5']} and K6 {res['k6']} times")
    names = (f"{cell.steps} steps from the prefill (len {cell.prompt:,})",
             f"{cell.fill_steps} steps from len {cell.fill_len:,} over the filled cache")
    for j, name in enumerate(names):
        run = ref["runs"][j]
        ulps = l_layer_check(name, run, ranks, j)
        held = [l_compare(f"{name}, rank {r}", run, res["runs"][j])
                for r, res in enumerate(ranks)]
        worst, same = max(h[0] for h in held), min(h[1] for h in held)
        ties = sorted({i for h in held for i in h[2]})
        equal = [min(h[3][k] for h in held) for k in range(len(L_REORDER_PARTS))]
        ref_ms = statistics.median(run["ms"])
        sh_ms = statistics.median(ranks[0]["runs"][j]["ms"])
        bound_ms = run["cache_bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"  L {name}: group {L_GROUP}'s layer within {ulps:.3g} bfloat16 ulps of the "
            f"unsharded one at every step, equal on the ranks, inserts held; tokens {same} of "
            f"{len(run['tokens'])} == the unsharded run's ({run['tokens'][:8].tolist()}...), "
            f"near ties within the reorder bound at steps {ties}; logits within {worst:.3f} of "
            f"the tolerance ({L_REORDER_RATIO:g}x the reorder bound), bit-equal to the reorder "
            f"runs' at " + ", ".join(f"{n} ({p} parts)" for n, p in zip(equal, L_REORDER_PARTS))
            + f" of {len(run['tokens'])} steps; the ranks' prefill rows "
            f"of group {L_GROUP} "
            + ", ".join(f"{res['runs'][j]['prompt_diff']:.3g}" for res in ranks)
            + f" from the unsharded run's; median step {ref_ms:.1f} ms unsharded, "
            f"{sh_ms:.1f} ms sharded (rank 0; host clock, synchronized); bound {bound_ms:.2f} "
            f"ms (the {run['cache_bytes'] / 1e9:.2f} GB cache read once at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    log(f"  L: {gpu_line()}; backend {ranks[0]['backend']}, {cell.ranks} ranks on one device, "
        f"each holding g_k {ranks[0]['runs'][0]['shard']}; each rank's prefill K5 x "
        f"{ranks[0]['k5']}, K6 x {ranks[0]['k6']}; prefill 1 x {cell.prompt:,} in "
        f"{ref['prefill_ms']:.1f} ms (host, first call); peak allocation {ref['peak_gb']:.2f} GB "
        f"unsharded, " + ", ".join(f"rank {r} {res['peak_gb']:.2f} GB" for r, res in
                                   enumerate(ranks))
        + f"; reference {t_ref:.1f} s, phase {t_all:.1f} s")


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
                                 GOLDEN_STREAM_SERVE, GOLDEN_TRAIN, GOLDEN_FAMILIES) + RESULTS):
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
    from repro_torch.kernels.ssm_gate import ssm_gate as gate_mod
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
                fa_mod.flash_attention, ssd_mod.ssd_scan, gate_mod.ssm_gate)
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
                               fa_mod.SOURCE, ssd_mod.SOURCE, gate_mod.SOURCE]
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
                flash_attention=k5_families(dev), ssd_scan=k6_families(dev),
                ssm_gate=ssm_gate_check(dev))
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
          f"{PATH_F_BATCH} x {PATH_F_PREFILL}, serve {PATH_F_BATCH} x {PATH_F_SERVE_PROMPT} + "
          f"{PATH_F_GEN}, float32 cross-check, K5 and K6 times")
    kernels += path_f(dev, run_path, errs, totals)

    phase("phase 13: Experiment on the card against the JAX package's grid rows: G (the BENCH "
          "v9 grid), G-fused under the fused and set_parallel engines, G-quick, G-tableI, H "
          "(bellmanford/google, PAPER); G again from a warm artifact cache")
    grid = json.loads(GOLDEN_GRID.read_text())
    calib = phase13(grid, dev, run_path)

    phase("phase 14: sharded and parallel: S-parity (bfs/comdblp at 16,384-access shards) under "
          "the fused and set_parallel engines, S-full (bfs/road-8m at 4,194,304-access shards), "
          "the scheduler's pool (G under workers=2 and None, the mixed grid)")
    phase14(json.loads(GOLDEN_SHARDED.read_text()), grid, dev, run_path, calib)

    phase("phase 15: stream and serve protocols through Experiment: ST-drift and SV-contention "
          "against results/, ST-full, SV-full, ST-models, SV-rate against the golden record, "
          "the zero-churn reuse counts")
    phase15(json.loads(GOLDEN_STREAM_SERVE.read_text()), dev, run_path)

    phase("phase 16: LM training: the reduced records and the 4-layer full-width smollm-360m "
          "against the JAX package's, gradients on the card against the CPU's, the K5 / K6 "
          "autograd guard, smollm-360m whole through the launcher (10 steps, checkpoint, resume "
          "to 15)")
    phase16(json.loads(GOLDEN_TRAIN.read_text()), dev, run_path)

    phase("phase 17: the moe, vlm and encdec families: the reduced mixtral, qwen2-vl and whisper "
          "against the JAX package's records; M (mixtral-8x22b, 4 layers), V (qwen2-vl-7b) and W "
          "(whisper-tiny) at full width in bfloat16; float32 cross-checks of M and V; K5 at their "
          "shapes")
    k5 = next(k for k in kernels if k["name"] == "flash_attention")
    k5["model_shapes"] = phase17(json.loads(GOLDEN_FAMILIES.read_text()), dev, run_path, errs)

    phase(f"phase 18: cell L, zamba2-1.2b at long_500k: prefill 1 x {CELL_L.prompt:,}, the "
          f"{CELL_L.max_len:,}-position cache decoded whole and split by sequence over "
          f"{CELL_L.ranks} gloo ranks on the card ({CELL_L.steps} steps; {CELL_L.fill_steps} "
          f"more over a filled cache)")
    phase18(dev, run_path)
    k5["max_abs_err"] = errs["flash_attention"]
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
