"""The port's cache-simulation kernels against the JAX package's Pallas kernels.

K1 (``lru_hits``) and K2 (``fused_levels``) run here through their plain
PyTorch versions (CPU tensors) and through a g++ build of the CUDA step
headers ``csrc/cache_sim_step.h`` and ``csrc/fused_warp_step.h`` — the
logic the GPU runs, compiled for the host; K1's and K2's warp kernels run
as emulations of their 32 lanes (``host_lru_hits_group``: a lane group a
row, one way a lane; ``host_fused_levels_warp``, on both of K2's state
routes).  Both are held bit for bit against the Pallas kernels in
interpret mode (``lru_hits`` / ``lru_hits_carry`` / ``fused_levels_pallas``)
and the pure-Python oracle ``lru_hits_ref``: hit bits, hit levels and raw
final states (every version stamps ages with the position in the row plus
1).  The non-carry Pallas kernel runs its machine over tail pads, so it is
compared on real cells only.  The kernels themselves run against the
plain versions on a card in ``tests/test_torch_cuda.py``.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # bare environment: seeded stub strategies
    from _hypothesis_fallback import given, settings, st

import jax.numpy as jnp

from repro.kernels.cache_sim.cache_sim import lru_hits as pallas_lru_hits
from repro.kernels.cache_sim.cache_sim import lru_hits_carry as pallas_lru_hits_carry
from repro.kernels.cache_sim.fused_sim import fused_levels_pallas
from repro.kernels.cache_sim.ref import lru_hits_ref
from repro.memsim import engine as jengine
from repro.memsim import fused as jfused

from repro_torch.kernels.cache_sim import cache_sim as tcache_sim
from repro_torch.kernels.cache_sim.ops import (
    fused_levels,
    fused_levels_plain,
    lru_hits,
    lru_hits_plain,
)
from repro_torch.memsim import engine as tengine
from repro_torch.memsim import fused as tfused

CPU = torch.device("cpu")
GEOMETRIES = [
    ((16, 8), (64, 8), (256, 16)),  # SCALED demand
    ((64, 8), (256, 16)),  # SCALED scoring
    ((1, 4), (4, 1)),  # single-set L1, direct-mapped L2
    ((4, 1), (8, 2), (16, 1)),  # ways=1 at the outer and inner level
    ((8, 2), (8, 4)),  # equal set counts
]
# K2's warp step: the demand levels of SCALED (GEOMETRIES[0]) and PAPER,
# 8 + 8 + 16 ways in one turn of 32 lanes; ways that sum to more than 32
# (two turns), and four levels of 32 ways (four turns)
PAPER_DEMAND = ((128, 8), (512, 8), (8192, 16))
WIDE = ((16, 16), (64, 16), (256, 16))
WARP_GEOMETRIES = GEOMETRIES + [PAPER_DEMAND, WIDE, ((2, 32), (4, 32), (8, 32), (16, 32))]
ROUTES = {"shared": 1, "global": 0}


def _stream(n, span, seed):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, span, n).astype(np.int64)
    if seed % 3 == 0:  # repeated-block runs
        blocks = np.repeat(blocks, rng.integers(1, 4, n))[: max(n, 1)]
    return blocks


def _random_canonical(sets, ways, seed):
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, 99, (sets, ways))
    tags[rng.random((sets, ways)) < 0.3] = -1
    return jengine.canonicalize_state(tags, rng.integers(1, 50, (sets, ways)))


def _k1_ragged(blocks, sets, tags, age):
    """Port K1 inputs (ragged, CPU tensors) of one stream."""
    srt, _, counts = tengine.group_by_set(blocks, sets)
    offsets = tengine.ragged_offsets([counts])
    return (
        torch.from_numpy(srt),
        torch.from_numpy(offsets),
        torch.from_numpy(np.ascontiguousarray(tags, dtype=np.int32)),
        torch.from_numpy(np.ascontiguousarray(age, dtype=np.int32)),
    )


def _k2_ragged(blocks, levels, states):
    groups = jfused.fused_group_count(levels)
    kept, _, _, counts = tfused._group_collapse(blocks, groups)
    offsets = tengine.ragged_offsets([counts])
    tags = [
        torch.from_numpy(np.ascontiguousarray(jfused.state_to_groups(s.tags, groups)))
        for s in states
    ]
    age = [
        torch.from_numpy(np.ascontiguousarray(jfused.state_to_groups(s.age, groups)))
        for s in states
    ]
    return torch.from_numpy(kept), torch.from_numpy(offsets), tags, age


def _pallas_k1(blocks, sets, st0):
    """Pallas ``lru_hits_carry`` (interpret) in the port's sorted order:
    ``(hits, tags, age)``."""
    padded, _, col, row = jengine.group_by_set(blocks, sets)
    mat = np.ascontiguousarray(padded.T)  # (sets, L)
    ph, pt, pa = pallas_lru_hits_carry(
        jnp.asarray(mat), jnp.asarray(st0.tags), jnp.asarray(st0.age),
        set_tile=min(sets, 8), interpret=True,
    )
    return np.asarray(ph)[row, col], np.asarray(pt), np.asarray(pa)


def _pallas_k2(blocks, geom, states):
    """``fused_levels_pallas`` (interpret) in the port's kept-sorted order:
    ``(levels, [tags per level], [age per level])``."""
    groups = jfused.fused_group_count(geom)
    padded, _, _, col, row, _ = jfused._group_collapse(blocks, groups)
    res = fused_levels_pallas(
        jnp.asarray(padded.T), geom,
        *jfused._grouped_state_args(states, groups), interpret=True,
    )
    k = len(geom)
    return (
        np.asarray(res[0]).T[col, row],
        [np.asarray(res[1 + 2 * i]) for i in range(k)],
        [np.asarray(res[2 + 2 * i]) for i in range(k)],
    )


def assert_k1_equal(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def assert_k2_equal(got, ref):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    for part in (1, 2):
        for g, r in zip(got[part], ref[part]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


# ------------------------------------------------------------------ K1


@given(
    n=st.integers(1, 300),
    span=st.integers(1, 200),
    sets=st.sampled_from([1, 4, 8, 16]),
    ways=st.sampled_from([1, 2, 4, 8]),
    seed=st.integers(0, 50),
)
@settings(max_examples=15, deadline=None)
def test_k1_plain_matches_pallas_and_oracle(n, span, sets, ways, seed):
    blocks = _stream(n, span, seed)
    padded, _, col, row = jengine.group_by_set(blocks, sets)
    mat = np.ascontiguousarray(padded.T)  # (sets, L)
    init = jengine.init_state(sets, ways)
    got = lru_hits_plain(*_k1_ragged(blocks, sets, init.tags, init.age))
    # the non-carry kernel and the oracle: hits on real cells only
    pallas = np.asarray(
        pallas_lru_hits(jnp.asarray(mat), ways, set_tile=sets, interpret=True)
    )
    np.testing.assert_array_equal(got[0].numpy(), pallas[row, col])
    np.testing.assert_array_equal(got[0].numpy(), lru_hits_ref(mat, ways)[row, col])
    # the carry kernel from the canonical cold state: hits and raw state
    assert_k1_equal(got, _pallas_k1(blocks, sets, init))


@pytest.mark.parametrize("sets,ways", [(16, 8), (64, 8), (8, 1), (1, 16)])
def test_k1_plain_resumes_carry_like_pallas(sets, ways):
    blocks = _stream(700, 40 * sets, seed=4)
    st0 = _random_canonical(sets, ways, seed=sets + ways)
    got = lru_hits_plain(*_k1_ragged(blocks, sets, st0.tags, st0.age))
    assert_k1_equal(got, _pallas_k1(blocks, sets, st0))


def test_k1_stream_axis_equals_per_stream():
    """One plain call over three streams (rows stacked) == three calls."""
    sets, ways = 16, 4
    streams = [_stream(n, 500, seed=n) for n in (5, 300, 120)]
    init = tengine.init_state(sets, ways, CPU)
    grouped = [tengine.group_by_set(s, sets) for s in streams]
    blocks = torch.from_numpy(np.concatenate([g[0] for g in grouped]))
    offsets = torch.from_numpy(tengine.ragged_offsets([g[2] for g in grouped]))
    tags = init.tags.repeat(3, 1)
    age = init.age.repeat(3, 1)
    hits, t1, a1 = lru_hits(blocks, offsets, tags, age)
    base = 0
    for i, s in enumerate(streams):
        h, t, a = lru_hits(*_k1_ragged(s, sets, init.tags.numpy(), init.age.numpy()))
        np.testing.assert_array_equal(hits[base : base + len(s)].numpy(), h.numpy())
        np.testing.assert_array_equal(t1[i * sets : (i + 1) * sets].numpy(), t.numpy())
        np.testing.assert_array_equal(a1[i * sets : (i + 1) * sets].numpy(), a.numpy())
        base += len(s)


# ------------------------------------------------------------------ K2


@given(
    n=st.integers(1, 250),
    span=st.integers(1, 1500),
    geom=st.sampled_from(GEOMETRIES),
    seed=st.integers(0, 50),
)
@settings(max_examples=15, deadline=None)
def test_k2_plain_matches_pallas(n, span, geom, seed):
    blocks = _stream(n, span, seed)
    states = [_random_canonical(s, w, seed + i) for i, (s, w) in enumerate(geom)]
    kept, offsets, tags0, age0 = _k2_ragged(blocks, geom, states)
    got = fused_levels_plain(kept, offsets, geom, tags0, age0)
    assert_k2_equal(got, _pallas_k2(blocks, geom, states))


# ------------------------------------------- g++ build of the step header


@pytest.fixture(scope="session")
def host_steps(tmp_path_factory):
    """ctypes handle on a g++ build of ``cache_sim_step.h`` (through the
    test-only driver ``csrc/host_step_test.cpp``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    src = tcache_sim.SOURCE.parent / "host_step_test.cpp"
    out = tmp_path_factory.mktemp("host_steps") / "libhost_step_test.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(out), str(src)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.host_lru_hits.argtypes = [vp, vp, ci, ci, vp, vp, vp, vp, vp]
    lib.host_lru_hits.restype = ci
    lib.host_lru_hits_group.argtypes = [vp, vp, ci, ci, vp, vp, vp, vp, vp]
    lib.host_lru_hits_group.restype = ci
    lib.host_fused_levels.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp]
    lib.host_fused_levels.restype = ci
    lib.host_fused_levels_warp.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, ci, vp]
    lib.host_fused_levels_warp.restype = ci
    lib.host_fused_turns.argtypes = [ci, vp, vp]
    lib.host_fused_turns.restype = ci
    return lib


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def host_lru(lib, blocks, offsets, tags, age, group=False):
    """The host build of K1's walk: the kernel's lane groups, emulated
    (``group``), or the per-step walk ``lru_row`` of the design before."""
    hits = torch.full((blocks.shape[0],), 7, dtype=torch.uint8)
    to, ao = torch.empty_like(tags), torch.empty_like(age)
    rc = (lib.host_lru_hits_group if group else lib.host_lru_hits)(
        _ptr(blocks), _ptr(offsets), offsets.shape[0] - 1, tags.shape[1],
        _ptr(tags), _ptr(age), _ptr(to), _ptr(ao), _ptr(hits),
    )
    assert rc == 0
    return hits, to, ao


def host_fused(lib, blocks, offsets, levels, tags, age):
    groups = min(s for s, _ in levels)
    k = len(levels)
    ints = ctypes.c_int * k
    ptrs = ctypes.c_void_p * k
    to = [t.clone() for t in tags]
    ao = [a.clone() for a in age]
    lvl = torch.empty(blocks.shape[0], dtype=torch.int8)
    rc = lib.host_fused_levels(
        _ptr(blocks), _ptr(offsets), offsets.shape[0] - 1, k, groups.bit_length() - 1,
        ints(*[s // groups - 1 for s, _ in levels]), ints(*[w for _, w in levels]),
        ints(*[(s // groups) * w for s, w in levels]),
        ptrs(*[t.data_ptr() for t in to]), ptrs(*[a.data_ptr() for a in ao]), _ptr(lvl),
    )
    assert rc == 0
    return lvl, to, ao


def host_fused_warp(lib, blocks, offsets, levels, tags, age, route):
    """The emulated warp kernel: ``(lvl, tags_out, age_out)``; the inputs
    are left as they are."""
    groups = min(s for s, _ in levels)
    k = len(levels)
    ints = ctypes.c_int * k
    ptrs = ctypes.c_void_p * k
    to = [torch.full_like(t, -7) for t in tags]
    ao = [torch.full_like(a, -7) for a in age]
    lvl = torch.full((blocks.shape[0],), -7, dtype=torch.int8)
    keep = [t.clone() for t in tags] + [a.clone() for a in age]
    rc = lib.host_fused_levels_warp(
        _ptr(blocks), _ptr(offsets), offsets.shape[0] - 1, k, groups.bit_length() - 1,
        ints(*[s // groups - 1 for s, _ in levels]), ints(*[w for _, w in levels]),
        ints(*[(s // groups) * w for s, w in levels]),
        ptrs(*[t.data_ptr() for t in tags]), ptrs(*[a.data_ptr() for a in age]),
        ptrs(*[t.data_ptr() for t in to]), ptrs(*[a.data_ptr() for a in ao]),
        ROUTES[route], _ptr(lvl),
    )
    assert rc == 0
    for t, kept in zip(list(tags) + list(age), keep):
        assert torch.equal(t, kept)
    return lvl, to, ao


@given(
    n=st.integers(0, 600),
    span=st.integers(1, 400),
    sets=st.sampled_from([1, 4, 16, 64]),
    ways=st.sampled_from([1, 2, 3, 8, 16]),
    seed=st.integers(0, 50),
)
@settings(max_examples=25, deadline=None)
def test_host_build_k1_matches_plain_and_jax(host_steps, n, span, sets, ways, seed):
    from repro.memsim.scan_cache import cache_pass as jax_reference

    blocks = _stream(n, span, seed) if n else np.zeros(0, np.int64)
    st0 = _random_canonical(sets, ways, seed)
    args = _k1_ragged(blocks, sets, st0.tags, st0.age)
    got = host_lru(host_steps, *args)
    assert_k1_equal(got, lru_hits_plain(*args))
    assert_k1_equal(got, _pallas_k1(blocks, sets, st0))
    if n:
        jh, jst = jax_reference(blocks, sets, ways, st0, return_state=True)
        _, order, _ = tengine.group_by_set(blocks, sets)
        full = np.zeros(n, dtype=bool)
        full[order] = got[0].numpy().astype(bool)
        np.testing.assert_array_equal(full, jh)
        canon = tengine.canonicalize_state(got[1], got[2])
        np.testing.assert_array_equal(canon.tags.numpy(), jst.tags)
        np.testing.assert_array_equal(canon.age.numpy(), jst.age)


@given(
    n=st.integers(0, 600),
    span=st.integers(1, 400),
    sets=st.sampled_from([1, 4, 16, 64]),
    ways=st.integers(1, 32),
    seed=st.integers(0, 50),
)
@settings(max_examples=12, deadline=None)
def test_host_group_k1_matches_plain_pallas_and_oracle(host_steps, n, span, sets, ways, seed):
    """The kernel's lane groups (one way a lane, 32 lanes emulated; batches
    of 4 G accesses, hit bytes 4 at a time) on ways 1-32, from a random
    carry: hit bits and raw final states equal the plain version's and the
    Pallas carry kernel's (interpret mode), and the oracle's hits."""
    blocks = _stream(n, span, seed) if n else np.zeros(0, np.int64)
    st0 = _random_canonical(sets, ways, seed)
    args = _k1_ragged(blocks, sets, st0.tags, st0.age)
    got = host_lru(host_steps, *args, group=True)
    assert_k1_equal(got, lru_hits_plain(*args))
    assert_k1_equal(got, _pallas_k1(blocks, sets, st0))
    if n:
        padded, _, col, row = jengine.group_by_set(blocks, sets)
        init = jengine.init_state(sets, ways)
        cold = _k1_ragged(blocks, sets, init.tags, init.age)
        np.testing.assert_array_equal(host_lru(host_steps, *cold, group=True)[0].numpy(),
                                      lru_hits_ref(np.ascontiguousarray(padded.T), ways)[row, col])


def _ragged_rows(lengths, span, seed, pad_frac=0.0):
    """Ragged K1 rows of the given lengths (random blocks, a share of them
    pads, -1), as CPU tensors: ``(blocks, offsets)``."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, span, int(sum(lengths))).astype(np.int32)
    blocks[rng.random(blocks.shape[0]) < pad_frac] = -1
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    return torch.from_numpy(blocks), torch.from_numpy(offsets)


@pytest.mark.parametrize("ways", list(range(1, 33)))
def test_host_group_k1_rows_batches_and_pads(host_steps, ways):
    """Rows of every length around the 4-access hit words and the 4 G-access
    batches (0, 1, 15, 16, 17, 63, 64, 65, 200, 600), so rows start at
    every offset within a batch and some span many batches, with pads:
    equal to the plain version and to the per-step walk it replaces,
    which both set a pad's hit bit and leave the state alone; resumed
    from the first call's canonical carry, the same again."""
    lengths = [0, 1, 15, 16, 17, 63, 64, 65, 200, 600, 0, 3, 129, 40, 1, 0, 77, 130, 5]
    blocks, offsets = _ragged_rows(lengths, 8 * ways + 3, seed=ways, pad_frac=0.1)
    tags = torch.from_numpy(_random_canonical(len(lengths), ways, 5).tags)
    age = torch.from_numpy(_random_canonical(len(lengths), ways, 5).age)
    got = host_lru(host_steps, blocks, offsets, tags, age, group=True)
    assert_k1_equal(got, lru_hits_plain(blocks, offsets, tags, age))
    assert_k1_equal(got, host_lru(host_steps, blocks, offsets, tags, age))
    carry = tengine.canonicalize_state(got[1], got[2])
    again = host_lru(host_steps, blocks, offsets, carry.tags, carry.age, group=True)
    assert_k1_equal(again, lru_hits_plain(blocks, offsets, carry.tags, carry.age))


@pytest.mark.parametrize("rows,ways,accesses", [
    (512, 8, 60_000),  # path B's launches 1 and 3: few sets, long rows
    (1024, 8, 80_000),
    (8192, 16, 40_000),  # launches 2 and 4: many sets, short rows, some empty
    (16384, 16, 30_000),
])
def test_host_group_k1_at_b_like_geometries(host_steps, rows, ways, accesses):
    """Path B's launch geometries (sets x ways), with a skewed stream so
    one row runs many batches long and others stay empty: the lane groups
    equal the plain version bit for bit, cold and resumed."""
    rng = np.random.default_rng(rows)
    # even sets only (odd rows empty), and set 0 hot: ~500 extra accesses
    blocks = np.concatenate([rng.integers(0, 20 * rows, accesses) * 2,
                             rng.integers(0, 200, 500) * 2 * rows]).astype(np.int64)
    rng.shuffle(blocks)
    init = tengine.init_state(rows, ways, CPU)
    args = _k1_ragged(blocks, rows, init.tags.numpy(), init.age.numpy())
    lens = args[1][1:] - args[1][:-1]
    assert int(lens.max()) > 3 * 64 and int((lens == 0).sum()) > 0
    got = host_lru(host_steps, *args, group=True)
    assert_k1_equal(got, lru_hits_plain(*args))
    carry = tengine.canonicalize_state(got[1], got[2])
    args2 = _k1_ragged(blocks[::-1].copy(), rows, carry.tags.numpy(), carry.age.numpy())
    assert_k1_equal(host_lru(host_steps, *args2, group=True), lru_hits_plain(*args2))


@given(
    n=st.integers(0, 500),
    span=st.integers(1, 3000),
    geom=st.sampled_from(GEOMETRIES),
    seed=st.integers(0, 50),
)
@settings(max_examples=25, deadline=None)
def test_host_build_k2_matches_plain_and_jax(host_steps, n, span, geom, seed):
    blocks = _stream(n, span, seed) if n else np.zeros(0, np.int64)
    states = [_random_canonical(s, w, seed + i) for i, (s, w) in enumerate(geom)]
    args = _k2_ragged(blocks, geom, states)
    got = host_fused(host_steps, args[0], args[1], geom, args[2], args[3])
    assert_k2_equal(got, fused_levels_plain(args[0], args[1], geom, args[2], args[3]))
    assert_k2_equal(got, _pallas_k2(blocks, geom, states))
    if n:
        jl, jst = jfused.fused_cache_pass(
            blocks, geom, states, return_states=True, use_pallas=False, force_scan=True
        )
        groups = jfused.fused_group_count(geom)
        _, order, keep, _ = tfused._group_collapse(blocks, groups)
        np.testing.assert_array_equal(
            tfused._unpack_levels(n, got[0].numpy(), order, keep), jl
        )
        for i, (s, w) in enumerate(geom):
            canon = tengine.canonicalize_state(
                tfused.state_from_groups(got[1][i], s, w),
                tfused.state_from_groups(got[2][i], s, w),
            )
            np.testing.assert_array_equal(canon.tags.numpy(), jst[i].tags)
            np.testing.assert_array_equal(canon.age.numpy(), jst[i].age)


def _jax_levels_and_states(blocks, geom, states, got):
    """Assert the port's kept-order result ``got`` equals the JAX package's
    fused pass (hit levels in stream order, canonical final states)."""
    jl, jst = jfused.fused_cache_pass(
        blocks, geom, states, return_states=True, use_pallas=False, force_scan=True
    )
    groups = jfused.fused_group_count(geom)
    _, order, keep, _ = tfused._group_collapse(blocks, groups)
    np.testing.assert_array_equal(tfused._unpack_levels(len(blocks), got[0].numpy(), order, keep), jl)
    for i, (s, w) in enumerate(geom):
        canon = tengine.canonicalize_state(
            tfused.state_from_groups(got[1][i], s, w),
            tfused.state_from_groups(got[2][i], s, w),
        )
        np.testing.assert_array_equal(canon.tags.numpy(), jst[i].tags)
        np.testing.assert_array_equal(canon.age.numpy(), jst[i].age)
    return jst


@given(
    n=st.integers(0, 500),
    span=st.integers(1, 20000),
    geom=st.sampled_from(WARP_GEOMETRIES),
    route=st.sampled_from(sorted(ROUTES)),
    seed=st.integers(0, 50),
)
@settings(max_examples=30, deadline=None)
def test_host_warp_k2_matches_plain_pallas_and_jax(host_steps, n, span, geom, route, seed):
    """The warp kernel's step, emulated lane by lane, on every geometry and
    both state routes: hit levels and raw final states equal the plain
    version's and the Pallas kernel's (interpret mode), and the JAX
    package's fused pass."""
    blocks = _stream(n, span, seed) if n else np.zeros(0, np.int64)
    states = [_random_canonical(s, w, seed + i) for i, (s, w) in enumerate(geom)]
    args = _k2_ragged(blocks, geom, states)
    got = host_fused_warp(host_steps, *args[:2], geom, *args[2:], route)
    assert_k2_equal(got, fused_levels_plain(*args[:2], geom, *args[2:]))
    if n:
        assert_k2_equal(got, _pallas_k2(blocks, geom, states))
        _jax_levels_and_states(blocks, geom, states, got)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("geom", [GEOMETRIES[0], PAPER_DEMAND, WIDE, GEOMETRIES[3]])
def test_host_warp_k2_resumes_carry_at_a_seam(host_steps, geom, route):
    """Cold over the first part, then resumed at the seam from the first
    part's canonical carry: each part equals the plain version and the JAX
    package's pass resumed from its own carry."""
    blocks = _stream(1500, 60 * max(s for s, _ in geom), seed=7)
    seam = 611
    states = [jengine.init_state(s, w) for s, w in geom]
    for part in (blocks[:seam], blocks[seam:]):
        args = _k2_ragged(part, geom, states)
        got = host_fused_warp(host_steps, *args[:2], geom, *args[2:], route)
        assert_k2_equal(got, fused_levels_plain(*args[:2], geom, *args[2:]))
        states = _jax_levels_and_states(part, geom, states, got)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_host_warp_k2_stream_axis_with_empty_rows(host_steps, route):
    """Three streams in one call, one of them empty, rows of uneven length
    (the longest longer than many 32-access batches): equal to the plain
    version, and every row's state comes back even where it had no access."""
    geom = PAPER_DEMAND
    groups = jfused.fused_group_count(geom)
    rng = np.random.default_rng(3)
    streams = [rng.integers(0, 40 * 8192, 2000), np.zeros(0, np.int64),
               np.concatenate([5 + groups * rng.integers(0, 3000, 400), rng.integers(0, 900, 300)])]
    grouped = [tfused._group_collapse(s, groups) for s in streams]
    blocks = torch.from_numpy(np.concatenate([g[0] for g in grouped]))
    offsets = torch.from_numpy(tengine.ragged_offsets([g[3] for g in grouped]))
    assert int((offsets[1:] - offsets[:-1]).max()) > 3 * 32
    assert int((offsets[1:] == offsets[:-1]).sum()) >= groups
    states = [_random_canonical(s, w, 11 + i) for i, (s, w) in enumerate(geom)]
    tags = [torch.from_numpy(np.ascontiguousarray(
        np.concatenate([jfused.state_to_groups(st.tags, groups)] * 3))) for st in states]
    age = [torch.from_numpy(np.ascontiguousarray(
        np.concatenate([jfused.state_to_groups(st.age, groups)] * 3))) for st in states]
    got = host_fused_warp(host_steps, blocks, offsets, geom, tags, age, route)
    assert_k2_equal(got, fused_levels_plain(blocks, offsets, geom, tags, age))


@pytest.mark.parametrize("ways,turns,first,off", [
    ((8, 8, 16), 1, [0], [0, 8, 16]),
    ((16, 16, 16), 2, [0, 2], [0, 16, 0]),
    ((4, 1), 1, [0], [0, 4]),
    ((32, 32, 32, 32), 4, [0, 1, 2, 3], [0, 0, 0, 0]),
    ((20, 12, 1, 31), 2, [0, 2], [0, 20, 0, 1]),
])
def test_fused_turns_pack_levels_in_order(host_steps, ways, turns, first, off):
    k = len(ways)
    out = (ctypes.c_int * (2 * k + 1))()
    assert host_steps.host_fused_turns(k, (ctypes.c_int * k)(*ways), out) == 0
    assert out[0] == turns
    assert list(out[1 : 1 + turns]) == first
    assert list(out[1 + k :]) == off


def test_route_follows_the_state_size():
    from repro_torch.kernels.cache_sim.fused_sim import SMEM_BUDGET, fused_levels_route

    assert fused_levels_route(PAPER_DEMAND) == "shared"  # 1,064 pairs, 8.5 KB
    assert fused_levels_route(((16, 16), (64, 16), (16384, 16))) == "shared"  # 131 KB
    assert fused_levels_route(((16, 16), (64, 16), (65536, 16))) == "global"  # 525 KB
    assert (8 + 2048 * 8) * 8 <= SMEM_BUDGET < (8 + 4096 * 8) * 8
    assert fused_levels_route(((16, 8), (16 * 2048, 8))) == "shared"
    assert fused_levels_route(((16, 8), (16 * 4096, 8))) == "global"


# ------------------------------------------------------ wrappers, routing


def test_non_cpu_tensor_never_reaches_plain_version(monkeypatch):
    """A tensor off the CPU goes to the kernel; when the kernel cannot be
    built the call raises instead of falling back to the plain version."""
    from repro_torch.kernels.cache_sim import fused_sim

    def no_plain(*a, **k):
        raise AssertionError("plain version reached with a device tensor")

    def no_build(source):
        raise RuntimeError(f"cannot build {source.name} here")

    monkeypatch.setattr(tcache_sim, "lru_hits_plain", no_plain)
    monkeypatch.setattr(fused_sim, "fused_levels_plain", no_plain)
    monkeypatch.setattr(tcache_sim, "load", no_build)
    monkeypatch.setattr(fused_sim, "load", no_build)
    meta = torch.device("meta")
    blocks = torch.zeros(10, dtype=torch.int32, device=meta)
    offsets = torch.zeros(5, dtype=torch.int64, device=meta)
    state = torch.zeros((4, 8), dtype=torch.int32, device=meta)
    with pytest.raises(RuntimeError, match="cannot build lru_hits"):
        lru_hits(blocks, offsets, state, state)
    with pytest.raises(RuntimeError, match="cannot build fused_levels"):
        fused_levels(blocks, offsets, ((4, 8),), [state], [state])


def test_wrappers_validate_inputs():
    blocks = torch.zeros(4, dtype=torch.int32)
    offsets = torch.tensor([0, 4], dtype=torch.int64)
    state = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        lru_hits(blocks.long(), offsets, state, state)
    with pytest.raises(ValueError):
        lru_hits(blocks, torch.tensor([0, 2, 4]), state, state)
    with pytest.raises(ValueError):
        lru_hits(blocks, offsets, torch.zeros((1, 40), dtype=torch.int32),
                 torch.zeros((1, 40), dtype=torch.int32))
    with pytest.raises(ValueError):
        fused_levels(blocks, offsets, ((1, 4), (2, 4)), [state], [state])
