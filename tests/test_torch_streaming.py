"""The port's streaming primitives (``repro_torch.memsim.streaming`` and the
carried cache passes under them) against the JAX package's, on the CPU.

The sharded path's contract: chopping a trace at ANY boundary — empty and
single-access chunks included — changes nothing.  Carried cache state
resumes every engine bit for bit (and equals the JAX package's carry), the
spilled MLP equals ``measure_mlp``, chained classification equals one
call, and the chunked composite scorer equals the whole-trace scorer and
the JAX package's chunked scorer on the same chunks.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.memsim import SCALED, simulate_demand, use_engine  # noqa: E402
from repro_torch.memsim.engine import ENGINES, cache_pass  # noqa: E402
from repro_torch.memsim.hierarchy import simulate_with_prefetch  # noqa: E402
from repro_torch.memsim.metrics import _outcome_cycles  # noqa: E402
from repro_torch.memsim.streaming import (  # noqa: E402
    BlockPosTable,
    ClassifyCarry,
    CompositeRunScorer,
    SpillFile,
    classify_chunk,
    iter_grouped,
    spilled_mlp,
)
from repro_torch.memsim.timing import TimingModel, measure_mlp  # noqa: E402


def _boundaries(rng, n, n_cuts):
    """Chunk boundaries over [0, n] with empty and size-1 chunks forced
    (sorted, not deduplicated: a repeated cut is an empty chunk)."""
    cuts = rng.integers(0, n + 1, size=n_cuts)
    mid = int(rng.integers(0, n))
    extra = [mid, mid, min(mid + 1, n)]
    return np.sort(np.concatenate([[0], cuts, extra, [n]]))


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("seed", [7, 8])
def test_cache_pass_carry_splits_at_any_boundary(engine, seed):
    from repro.memsim import use_engine as jax_engine
    from repro.memsim.engine import cache_pass as jax_pass

    rng = np.random.default_rng(seed)
    n, sets, ways = 3000, 16, 4
    blocks = rng.integers(0, 97, size=n).astype(np.int64) + (1 << 22)
    bounds = _boundaries(rng, n, 9)
    with use_engine(engine):
        whole, end = cache_pass(blocks, sets, ways, return_state=True, device="cpu")
        got, state = [], None
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            hits, state = cache_pass(blocks[lo:hi], sets, ways, state=state,
                                     return_state=True, device="cpu")
            got.append(hits)
    with jax_engine(engine):
        jwhole, jend = jax_pass(blocks, sets, ways, return_state=True)
    np.testing.assert_array_equal(np.concatenate(got), whole)
    np.testing.assert_array_equal(whole, np.asarray(jwhole))
    for got_state in (state, end):
        np.testing.assert_array_equal(got_state.tags.numpy(), np.asarray(jend.tags))
        np.testing.assert_array_equal(got_state.age.numpy(), np.asarray(jend.age))


@pytest.mark.parametrize("trial", range(4))
def test_spilled_mlp_matches_measure_mlp(tmp_path, trial):
    from repro.memsim.streaming import SpillFile as JSpill, spilled_mlp as jspilled

    rng = np.random.default_rng(3 + trial)
    n = int(rng.integers(0, 3000)) if trial else 1
    pos = np.unique(rng.integers(0, 12000, size=n).astype(np.int64))
    window = int(rng.integers(1, 60))
    cap = float(rng.uniform(1.0, 8.0))
    sp = SpillFile(str(tmp_path / "mlp.i64"), cols=1)
    jsp = JSpill(str(tmp_path / "jmlp.i64"), cols=1)
    i = 0
    while i < len(pos):
        step = int(rng.integers(0, 500))
        sp.append(pos[i : i + step])  # step == 0 is an empty append
        jsp.append(pos[i : i + step])
        i += step if step else 1
    got = spilled_mlp(sp, window, cap, rows=257)
    assert got == measure_mlp(pos, window, cap)
    assert got == jspilled(jsp, window, cap, rows=257)
    sp.close()
    jsp.close()


def test_spill_file_groups_and_iter_grouped(tmp_path):
    rng = np.random.default_rng(1)
    sp = SpillFile(tmp_path / "g.i64", cols=3)
    rows = []
    for it in (0, 0, 2, 5, 5, 5):  # groups 1, 3, 4 stay empty
        k = int(rng.integers(0, 40))
        cols = (rng.integers(0, 1000, size=k), rng.integers(0, 9, size=k),
                np.full(k, it))
        sp.append(*cols)
        rows.append(cols)
    with pytest.raises(ValueError):
        sp.append(np.zeros(2), np.zeros(3), np.zeros(2))
    counts = [len(c[0]) for c in rows]
    for got, want in zip(sp.groups(counts), rows):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    allcols = [np.concatenate([c[j] for c in rows]) for j in range(3)]
    seen = list(iter_grouped(sp, 2, 7, rows=11))
    assert [g for g, _ in seen] == list(range(7))
    for g, cols in seen:
        sel = allcols[2] == g
        for j in range(3):
            np.testing.assert_array_equal(cols[j], allcols[j][sel])
    sp.close()


@pytest.mark.parametrize("trial", range(5))
def test_classify_chunk_chained_matches_single_call(trial):
    from repro.memsim.streaming import ClassifyCarry as JCarry, classify_chunk as jclassify

    rng = np.random.default_rng(11 + trial)
    n = int(rng.integers(2, 2500))
    blocks = rng.integers(0, 60, size=n).astype(np.int64) + (1 << 22)
    pos2 = np.cumsum(rng.integers(1, 3, size=n)).astype(np.int64)
    is_pf = rng.random(n) < 0.5
    issuer = rng.integers(0, 2, size=n).astype(np.int8)
    # a real LRU pass: each chain segment starts at a fill
    hit = cache_pass(blocks, 8, 2, device="cpu")
    fw2 = 2 * int(rng.integers(1, 40))
    t0 = int(rng.integers(0, int(pos2[-1] >> 1) + 1))
    single, _ = classify_chunk(ClassifyCarry.empty(), blocks, is_pf, pos2, hit, issuer,
                               fw2, t0, 1)
    bounds = _boundaries(rng, n, 7)
    carry, jcarry, total = ClassifyCarry.empty(), JCarry.empty(), None
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        args = (blocks[lo:hi], is_pf[lo:hi], pos2[lo:hi], hit[lo:hi], issuer[lo:hi],
                fw2, t0, 1)
        counts, carry = classify_chunk(carry, *args)
        jcounts, jcarry = jclassify(jcarry, *args)
        assert counts == jcounts
        for f in ("blocks", "fill_pos2", "fill_issuer", "all_pf_tail", "pending",
                  "pending_sel"):
            np.testing.assert_array_equal(getattr(carry, f), getattr(jcarry, f))
        total = counts if total is None else {k: total[k] + v for k, v in counts.items()}
    assert total == single


def test_block_pos_table_dense_and_sparse_span_fallback():
    from repro.memsim.streaming import BlockPosTable as JTable

    rng = np.random.default_rng(4)
    table, jtable = BlockPosTable(), JTable()
    for _ in range(6):
        b = rng.integers(0, 5000, size=300) + (1 << 22)
        p = np.sort(rng.integers(0, 1 << 20, size=300))
        table.update(b, p)
        jtable.update(b, p)
    assert table._dense is not None and len(table) == len(jtable)
    q, qp = rng.integers(0, 5200, size=999) + (1 << 22), rng.integers(0, 1 << 20, size=999)
    np.testing.assert_array_equal(table.has_later(q, qp), jtable.has_later(q, qp))
    # block ids spread past the dense-span cap demote to sorted rows
    small = BlockPosTable()
    small.update(np.array([100, 200]), np.array([5, 9]))
    assert small._dense is not None
    small.update(np.array([100 + (1 << 30)]), np.array([12]))
    small.update(np.array([200, 300]), np.array([15, 1]))
    assert small._dense is None and len(small) == 4
    qb = np.array([100, 200, 100 + (1 << 30), 77, 300])
    np.testing.assert_array_equal(
        small.has_later(qb, np.array([4, 9, 11, 0, 0])), [True, True, True, False, True]
    )
    assert not small.has_later(np.zeros(0, np.int64), np.zeros(0, np.int64)).size


@pytest.mark.parametrize("trial", range(3))
def test_composite_scorer_chunked_matches_whole_trace_and_jax(tmp_path, trial):
    from repro.memsim.streaming import BlockPosTable as JTable
    from repro.memsim.streaming import CompositeRunScorer as JScorer

    rng = np.random.default_rng(5 + trial)
    cfg, tm = SCALED, TimingModel()
    n = int(rng.integers(400, 4000))
    blocks = rng.integers(0, 150, size=n).astype(np.int64) + (1 << 22)
    iter_id = np.sort(rng.integers(0, 5, size=n)).astype(np.int32)
    profile = simulate_demand(blocks, iter_id, cfg, device="cpu")
    t0 = int(rng.integers(0, n))
    npf = int(rng.integers(0, 2 * len(profile.l2_pos) + 2))
    pf_pos = rng.integers(0, n, size=npf).astype(np.int64)
    pf_blocks = rng.integers(0, 150, size=npf).astype(np.int64) + (1 << 22)
    pf_issuer = rng.integers(0, 2, size=npf).astype(np.int8)
    # the sharded contract pre-sorts the prefetch stream globally (stable)
    o = np.argsort(pf_pos, kind="stable")
    pf_pos, pf_blocks, pf_issuer = pf_pos[o], pf_blocks[o], pf_issuer[o]

    outcome = simulate_with_prefetch(profile, pf_blocks, pf_pos, pf_issuer)
    base = profile.baseline_counts(t0)
    want_cycles, want_counts = _outcome_cycles(profile, outcome, t0, tm, base["dram"], 7.5, 3)

    table, jtable = BlockPosTable(), JTable()
    for j in range(0, len(profile.l2_miss_blocks), 173):
        for t in (table, jtable):
            t.update(profile.l2_miss_blocks[j : j + 173], profile.l2_miss_pos[j : j + 173])
    sink = SpillFile(tmp_path / "sink.i64", cols=3)
    sc = CompositeRunScorer(cfg, t0, str(tmp_path), "t", sel_issuer=1, no_future=table,
                            miss_sink=sink, device="cpu")
    jsc = JScorer(cfg, t0, str(tmp_path), "j", sel_issuer=1, no_future=jtable)
    bounds = _boundaries(rng, n, 8)
    for a0, a1 in zip(bounds[:-1], bounds[1:]):
        dlo, dhi = np.searchsorted(profile.l2_pos, [a0, a1])
        plo, phi = np.searchsorted(pf_pos, [a0, a1])
        args = (profile.l2_pos[dlo:dhi], profile.l2_blocks[dlo:dhi], pf_blocks[plo:phi],
                pf_pos[plo:phi], pf_issuer[plo:phi])
        sc.feed(*args, d_iter=profile.l2_iter[dlo:dhi])
        jsc.feed(*args)
    got_cycles, got_counts = sc.finalize(base, base["dram"], 7.5, 3, tm)
    j_cycles, j_counts = jsc.finalize(base, base["dram"], 7.5, 3, tm)
    assert got_counts == want_counts == j_counts
    assert got_cycles == want_cycles == j_cycles
    for f in ("useful", "late_sel", "redundant", "early", "overpred", "issued"):
        assert getattr(sc, f) == getattr(jsc, f), f
    assert sc.l2_state.tags.device.type == "cpu"
    # the sink got every demand L2 miss of the composite run, in order
    ((pos, blk, it),) = sink.groups([sink.rows])
    d_miss = ~outcome.demand_l2_hit
    np.testing.assert_array_equal(pos, profile.l2_pos[d_miss])
    np.testing.assert_array_equal(blk, profile.l2_blocks[d_miss])
    np.testing.assert_array_equal(it, profile.l2_iter[d_miss])
    sink.close()
