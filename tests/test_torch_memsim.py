"""The port's cache engines and hierarchy passes against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU (plain versions of K1 / K2, and the serial host
oracle under the ``reference`` engine).  Hit masks, hit levels, canonical
states and every demand-profile / prefetch-outcome array must be
bit-identical — including across the shard seam, where a carry made by the
JAX package resumes a pass of the port through ``repro_torch.convert``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # bare environment: seeded stub strategies
    from _hypothesis_fallback import given, settings, st

from repro import memsim as jmemsim
from repro.memsim import engine as jengine
from repro.memsim import fused as jfused
from repro.memsim import hierarchy as jhier

from repro_torch import convert
from repro_torch import memsim as tmemsim
from repro_torch.memsim import engine as tengine
from repro_torch.memsim import fused as tfused
from repro_torch.memsim import hierarchy as thier

CPU = "cpu"
THREE_LEVEL = ((16, 8), (64, 8), (256, 16))
TWO_LEVEL = ((64, 8), (256, 16))


def _stream(n, span, seed):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, span, n).astype(np.int64)
    if seed % 3 == 0:  # repeated-block runs
        blocks = np.repeat(blocks, rng.integers(1, 4, n))[: max(n, 1)]
    return blocks


def assert_state_equal(port_state, jax_state):
    np.testing.assert_array_equal(port_state.tags.numpy(), jax_state.tags)
    np.testing.assert_array_equal(port_state.age.numpy(), jax_state.age)


def _to_port(jax_state):
    return convert.cache_state(jax_state.tags, jax_state.age, device=CPU)


# ----------------------------------------------------------- cache_pass


@given(
    n=st.integers(1, 400),
    span=st.integers(1, 300),
    sets=st.sampled_from([1, 4, 16, 64]),
    ways=st.sampled_from([1, 2, 8]),
    seed=st.integers(0, 100),
)
@settings(max_examples=20, deadline=None)
def test_cache_pass_bit_identical_to_jax(n, span, sets, ways, seed):
    blocks = _stream(n, span, seed)
    ref, ref_st = jengine.cache_pass(blocks, sets, ways, return_state=True)
    for engine in tengine.ENGINES:
        with tengine.use_engine(engine):
            got, got_st = tengine.cache_pass(
                blocks, sets, ways, return_state=True, device=CPU
            )
        np.testing.assert_array_equal(got, ref, err_msg=engine)
        assert_state_equal(got_st, ref_st)


@pytest.mark.parametrize("engine", ["fused", "reference"])
def test_cache_pass_edge_geometries(engine):
    rng = np.random.default_rng(0)
    cases = [
        (np.zeros(0, np.int64), 16, 8),  # empty stream
        (np.zeros(1, np.int64), 1, 1),  # single access, degenerate cache
        (np.full(50, 7, np.int64), 4, 1),  # one block repeated, direct-mapped
        (rng.integers(0, 9, 300).astype(np.int64), 1, 4),  # single set
        (np.arange(64, dtype=np.int64), 8, 2),  # all cold misses
        (rng.integers(0, 40, 3000).astype(np.int64) * 8192, 8192, 16),  # skewed
    ]
    for blocks, sets, ways in cases:
        ref = jengine.cache_pass(blocks, sets, ways)
        with tengine.use_engine(engine):
            got = tengine.cache_pass(blocks, sets, ways, device=CPU)
        np.testing.assert_array_equal(got, ref, err_msg=f"{engine} {sets}x{ways}")


@pytest.mark.parametrize("engine", tengine.ENGINES)
def test_cache_pass_resumes_a_jax_carry(engine):
    """Cross-package shard seam: the JAX package's first half, then the
    port's second half from the converted carry == JAX's whole pass."""
    blocks = _stream(3000, 900, seed=5)
    h = 1700
    ref, ref_st = jengine.cache_pass(blocks, 16, 4, return_state=True)
    first, carry = jengine.cache_pass(blocks[:h], 16, 4, return_state=True)
    with tengine.use_engine(engine):
        second, st = tengine.cache_pass(
            blocks[h:], 16, 4, state=_to_port(carry), return_state=True, device=CPU
        )
    np.testing.assert_array_equal(np.concatenate([first, second]), ref)
    assert_state_equal(st, ref_st)


def test_cache_pass_batch_matches_jax():
    rng = np.random.default_rng(6)
    streams = [rng.integers(0, 1500, n).astype(np.int64) for n in (37, 400, 1200, 1)]
    with jengine.use_engine("fused"):
        ref = jengine.cache_pass_batch(streams, 64, 8)
    got = tengine.cache_pass_batch(streams, 64, 8, device=CPU)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    skewed = streams + [rng.integers(0, 30, 2000).astype(np.int64) * 8192]
    got = tengine.cache_pass_batch(skewed, 8192, 16, device=CPU)
    for g, s in zip(got, skewed):
        np.testing.assert_array_equal(g, jengine.cache_pass(s, 8192, 16))
    assert tengine.cache_pass_batch([], 64, 8, device=CPU) == []


# ------------------------------------------------------ fused_cache_pass


@given(
    n=st.integers(1, 400),
    span=st.integers(1, 2000),
    geom=st.sampled_from(
        [
            THREE_LEVEL,
            TWO_LEVEL,
            ((1, 4), (4, 1)),
            ((4, 1), (8, 2), (16, 1)),
            ((8, 2), (8, 4)),
        ]
    ),
    seed=st.integers(0, 100),
)
@settings(max_examples=20, deadline=None)
def test_fused_cache_pass_bit_identical_to_jax(n, span, geom, seed):
    blocks = _stream(n, span, seed)
    ref, ref_sts = jfused.fused_cache_pass(blocks, geom, return_states=True)
    got, got_sts = tfused.fused_cache_pass(blocks, geom, return_states=True, device=CPU)
    np.testing.assert_array_equal(got, ref)
    for a, b in zip(got_sts, ref_sts):
        assert_state_equal(a, b)
    # seam inside the port, and across packages (JAX first half)
    h = n // 2
    l1, sts = tfused.fused_cache_pass(blocks[:h], geom, return_states=True, device=CPU)
    l2 = tfused.fused_cache_pass(blocks[h:], geom, states=sts, device=CPU)
    np.testing.assert_array_equal(np.concatenate([l1, l2]), ref)
    j1, jsts = jfused.fused_cache_pass(blocks[:h], geom, return_states=True)
    t2 = tfused.fused_cache_pass(
        blocks[h:], geom, states=[_to_port(s) for s in jsts], device=CPU
    )
    np.testing.assert_array_equal(np.concatenate([j1, t2]), ref)


def test_fused_batch_matches_jax_with_carries():
    rng = np.random.default_rng(6)
    streams = [rng.integers(0, 1500, n).astype(np.int64) for n in (37, 400, 1200, 1)]
    carries = [
        [jengine.init_state(s, w) for s, w in TWO_LEVEL],
        [
            jengine.canonicalize_state(
                rng.integers(0, 99, (s, w)), rng.integers(1, 50, (s, w))
            )
            for s, w in TWO_LEVEL
        ],
        [jengine.init_state(s, w) for s, w in TWO_LEVEL],
        [jengine.init_state(s, w) for s, w in TWO_LEVEL],
    ]
    ref, ref_sts = jfused.fused_cache_pass_batch(
        streams, TWO_LEVEL, states=carries, return_states=True, force_scan=True
    )
    got, got_sts = tfused.fused_cache_pass_batch(
        streams, TWO_LEVEL, states=[[_to_port(s) for s in c] for c in carries],
        return_states=True, device=CPU,
    )
    for i in range(len(streams)):
        np.testing.assert_array_equal(got[i], ref[i], err_msg=f"stream {i}")
        for a, b in zip(got_sts[i], ref_sts[i]):
            assert_state_equal(a, b)


def test_fused_empty_and_skewed_members():
    rng = np.random.default_rng(7)
    streams = [
        rng.integers(0, 500, 100).astype(np.int64),
        np.zeros(0, np.int64),
        rng.integers(0, 50, 3000).astype(np.int64) * 256,  # one LLC set
    ]
    got = tfused.fused_cache_pass_batch(streams, THREE_LEVEL, device=CPU)
    for g, s in zip(got, streams):
        np.testing.assert_array_equal(g, jfused.fused_cache_pass(s, THREE_LEVEL))
    assert tfused.fused_cache_pass_batch([], THREE_LEVEL, device=CPU) == []


def test_state_group_layout_round_trips():
    rng = np.random.default_rng(3)
    a = rng.integers(-50, 50, (256, 16)).astype(np.int32)
    for groups in (16, 64, 256):
        lanes = tfused.state_to_groups(torch.from_numpy(a), groups)
        np.testing.assert_array_equal(lanes.numpy(), jfused.state_to_groups(a, groups))
        np.testing.assert_array_equal(
            tfused.state_from_groups(lanes, 256, 16).numpy(), a
        )
    lvl = rng.integers(0, 4, 500).astype(np.int8)
    for x, y in zip(tfused.levels_to_hits(lvl, 3), jfused.levels_to_hits(lvl, 3)):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------ hierarchy passes


def _demand_items():
    rng = np.random.default_rng(8)
    items = []
    for n in (20_000, 9_000):
        base = rng.integers(0, 4_000, n // 3).astype(np.int64)
        blocks = np.repeat(base, 3)[:n]
        items.append((blocks, np.repeat(np.arange(4), n // 4 + 1)[:n].astype(np.int32)))
    return items


def assert_profile_equal(got, ref):
    for f in ("blocks", "iter_id", "l1_hit", "l2_pos", "l2_blocks", "l2_iter",
              "l2_hit", "llc_hit"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)


@pytest.mark.parametrize("engine", tengine.ENGINES)
def test_simulate_demand_matches_jax(engine):
    items = _demand_items()
    for blocks, it in items:
        ref = jhier.simulate_demand(blocks, it, jmemsim.SCALED)
        with tengine.use_engine(engine):
            got = thier.simulate_demand(blocks, it, tmemsim.SCALED, device=CPU)
        assert got.device == torch.device("cpu")
        assert_profile_equal(got, ref)
    with tengine.use_engine(engine):
        batch = thier.simulate_demand_batch(items, tmemsim.SCALED, device=CPU)
    for (blocks, it), got in zip(items, batch):
        assert_profile_equal(got, jhier.simulate_demand(blocks, it, jmemsim.SCALED))


def test_simulate_demand_resumes_a_jax_demand_state():
    blocks, it = _demand_items()[0]
    h = 11_000
    ref = jhier.simulate_demand(blocks, it, jmemsim.SCALED)
    p1, carry = jhier.simulate_demand(blocks[:h], it[:h], jmemsim.SCALED, return_state=True)
    port_carry = convert.demand_state(
        [(carry.l1.tags, carry.l1.age), (carry.l2.tags, carry.l2.age),
         (carry.llc.tags, carry.llc.age)],
        carry.pos_offset, device=CPU,
    )
    p2, st = thier.simulate_demand(
        blocks[h:], it[h:], tmemsim.SCALED, state=port_carry, return_state=True, device=CPU
    )
    assert st.pos_offset == len(blocks)
    np.testing.assert_array_equal(np.concatenate([p1.l1_hit, p2.l1_hit]), ref.l1_hit)
    np.testing.assert_array_equal(np.concatenate([p1.l2_pos, p2.l2_pos]), ref.l2_pos)
    np.testing.assert_array_equal(np.concatenate([p1.l2_hit, p2.l2_hit]), ref.l2_hit)
    np.testing.assert_array_equal(np.concatenate([p1.llc_hit, p2.llc_hit]), ref.llc_hit)


@pytest.mark.parametrize("engine", ["fused", "set_parallel"])
def test_simulate_with_prefetch_matches_jax(engine):
    blocks, it = _demand_items()[0]
    jprof = jhier.simulate_demand(blocks, it, jmemsim.SCALED)
    tprof = thier.simulate_demand(blocks, it, tmemsim.SCALED, device=CPU)
    streams = []
    for k in (1, 4):  # two simple delta prefetchers as the family
        pf_pos = jprof.l2_pos[:: 7 * k].astype(np.int64)
        streams.append((jprof.blocks[pf_pos] + k, pf_pos, np.ones(len(pf_pos), np.int8)))
    ref = jhier.simulate_with_prefetch_batch(jprof, streams)
    with tengine.use_engine(engine):
        batched = thier.simulate_with_prefetch_batch(tprof, streams)
        single = [thier.simulate_with_prefetch(tprof, b, p, pf_issuer=i) for b, p, i in streams]
    for got_list in (batched, single):
        for got, r in zip(got_list, ref):
            for f in dataclasses.fields(r):
                a, b = getattr(got, f.name), getattr(r, f.name)
                assert np.array_equal(a, b), f.name


def test_engine_switch_plumbing(monkeypatch):
    monkeypatch.delenv(tengine.ENGINE_ENV, raising=False)
    assert tengine.current_engine() == "fused"
    monkeypatch.setenv(tengine.ENGINE_ENV, "reference")
    assert tengine.current_engine() == "reference"
    tengine.set_engine("set_parallel")
    try:
        assert tengine.current_engine() == "set_parallel"
        with tengine.use_engine("fused"):
            assert tengine.current_engine() == "fused"
        assert tengine.current_engine() == "set_parallel"
    finally:
        tengine.set_engine(None)
    assert tengine.current_engine() == "reference"
    monkeypatch.setenv(tengine.ENGINE_ENV, "pallas")
    with pytest.raises(ValueError):
        tengine.current_engine()
    with pytest.raises(ValueError):
        tengine.set_engine("nope")


def test_canonicalize_matches_jax():
    rng = np.random.default_rng(9)
    tags = rng.integers(-1, 5, (32, 8))
    age = rng.permutation(32 * 8).reshape(32, 8)
    ref = jengine.canonicalize_state(tags, age)
    got = tengine.canonicalize_state(torch.from_numpy(tags), torch.from_numpy(age))
    assert_state_equal(got, ref)
    assert_state_equal(tengine.init_state(32, 8, CPU), jengine.init_state(32, 8))
