"""The ordered segment sum's two roles, emulated on the CPU, against the
plain version and the JAX package, bit for bit.

``csrc/host_step_test.cpp::host_segment_sum_warp`` is a g++ build of the
step header ``csrc/segment_sum_step.h`` that runs ``segment_sum.cu``'s grid
on the host: each heavy segment's warp with its 32 lanes emulated in step
(a ring of ``SS_RING`` chunks a lane, the next chunk's loads before this
chunk's adds, the shuffles as reads of the lanes' values), then a thread
for each light segment.  Every output must equal ``index_add_`` on the CPU
(``segment_sum_plain``) and ``jax.ops.segment_sum`` on XLA-CPU bit for
bit: signed zeros, subnormals, infinities and NaN positions included,
except that XLA-CPU flushes subnormal inputs and sums to zero, where
``index_add_`` and the kernel keep them (no ``--use_fast_math``): segments
that hold a subnormal are held against ``index_add_`` only.  The kernel
itself runs against the plain version on a card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro_torch.graphs import make_dataset
from repro_torch.kernels.segment_sum import segment_sum as t_ss
from repro_torch.kernels.segment_sum.segment_sum import (
    segment_plan, segment_sum, segment_sum_plain,
)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    src = t_ss.SOURCE.parent / "host_step_test.cpp"
    out = tmp_path_factory.mktemp("host_ss") / "libsegment_sum_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.host_segment_sum_warp.argtypes = [vp, vp, vp, ci, vp, ci, vp]
    lib.host_segment_sum_warp.restype = ci
    return lib


def emulated(lib, vals, ids, n):
    """The emulated kernel's sums; segments no role writes stay NaN."""
    plan = segment_plan(ids, n, torch.device("cpu"))
    vals = np.ascontiguousarray(vals, np.float32)
    perm, offsets, heavy = (t.numpy() for t in (plan.perm, plan.offsets, plan.heavy))
    out = np.full(n, np.nan, np.float32)
    rc = lib.host_segment_sum_warp(vals.ctypes.data, perm.ctypes.data, offsets.ctypes.data, n,
                                   heavy.ctypes.data, len(heavy), out.ctypes.data)
    assert rc == 0
    return out


def assert_bits_equal(got, ref, what):
    """Equal bit for bit, except that any NaN matches any NaN."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    bad = got.view(np.uint32)[~nan] != ref.view(np.uint32)[~nan]
    assert not bad.any(), f"{what}: {int(bad.sum())} sums differ, first {np.flatnonzero(bad)[:5]}"


def check_all(lib, vals, ids, n, flushed=()):
    """Emulated kernel == index_add_ == jax.ops.segment_sum, bit for bit;
    JAX is not asked about the segments in ``flushed``."""
    vals = np.asarray(vals, np.float32)
    ids = np.asarray(ids, np.int64)
    plain = segment_sum_plain(torch.from_numpy(vals), torch.from_numpy(ids), n).numpy()
    jref = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids, jnp.int32),
                                          num_segments=n))
    keep = np.ones(n, bool)
    keep[list(flushed)] = False
    assert_bits_equal(plain[keep], jref[keep], "index_add_ against jax.ops.segment_sum")
    assert_bits_equal(emulated(lib, vals, ids, n), plain, "emulated kernel against index_add_")
    # the wrapper on a CPU tensor is the plain version
    got = segment_sum(torch.from_numpy(vals), segment_plan(ids, n, torch.device("cpu")))
    assert_bits_equal(got.numpy(), plain, "wrapper on the CPU")


def spread(rng, e):
    """Magnitudes 1e-6 .. 1e3 with random signs: a sum in another order
    gives other bits."""
    return (10.0 ** rng.uniform(-6, 3, e) * rng.choice([-1.0, 1.0], e)).astype(np.float32)


def test_chunk_matches_the_header(host_lib):
    header = (t_ss.SOURCE.parent / "segment_sum_step.h").read_text()
    assert int(re.search(r"#define SS_CHUNK (\d+)", header).group(1)) == t_ss.CHUNK
    assert host_lib.host_segment_sum_chunk() == t_ss.CHUNK


def test_plan_lists_the_heavy_segments_longest_first():
    rng = np.random.default_rng(0)
    lens = rng.integers(0, 120, 500)
    ids = rng.permutation(np.repeat(np.arange(500), lens))
    plan = segment_plan(ids, 500, torch.device("cpu"))
    heavy = plan.heavy.numpy()
    assert plan.heavy.dtype == torch.int32
    assert sorted(heavy.tolist()) == np.flatnonzero(lens > t_ss.CHUNK).tolist()
    assert (np.diff(lens[heavy]) <= 0).all()  # longest first
    ties = lens[heavy][1:] == lens[heavy][:-1]
    assert (heavy[1:][ties] > heavy[:-1][ties]).all()  # stable among equals


def test_no_edges_and_all_segments_empty(host_lib):
    check_all(host_lib, np.zeros(0, np.float32), np.zeros(0, np.int64), 7)
    check_all(host_lib, np.ones(3, np.float32), np.full(3, 9), 10)  # 9 of 10 empty


def test_one_segment_of_5000_edges(host_lib):
    rng = np.random.default_rng(1)
    check_all(host_lib, spread(rng, 5000), np.full(5000, 3), 5)


@pytest.mark.parametrize("length", [1, 8, 9, 31, 32, 33, 63, 64, 65, 255, 256, 257, 289])
def test_lengths_around_the_chunk_and_the_ring(host_lib, length):
    """Segments around SS_CHUNK (32) edges, where the role changes, around
    SS_HOIST (8), and around the ring of 8 chunks (256 edges)."""
    rng = np.random.default_rng(length)
    lens = np.array([length, length - 1, length + 1, 0, 2 * length, 5])
    ids = rng.permutation(np.repeat(np.arange(len(lens)), lens))
    check_all(host_lib, spread(rng, len(ids)), ids, len(lens))


def test_unsorted_ids_and_skewed_lengths(host_lib):
    rng = np.random.default_rng(2)
    lens = np.minimum(rng.zipf(1.6, 3000), 3000)
    ids = rng.permutation(np.repeat(np.arange(3000), lens))
    check_all(host_lib, spread(rng, len(ids)), ids, 3000)


def test_order_matters_for_these_values(host_lib):
    """The spread family is one where another order gives other bits: the
    sums of the reversed edge order differ from the plain version's."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 40, 4000)
    vals = spread(rng, 4000)
    plain = segment_sum_plain(torch.from_numpy(vals), torch.from_numpy(ids), 40).numpy()
    rev = segment_sum_plain(torch.from_numpy(vals[::-1].copy()),
                            torch.from_numpy(ids[::-1].copy()), 40).numpy()
    assert (plain.view(np.uint32) != rev.view(np.uint32)).sum() > 20
    check_all(host_lib, vals, ids, 40)


def test_signed_zeros_subnormals_infinities_nan(host_lib):
    tiny = np.finfo(np.float32).tiny
    sub = np.float32(tiny) * np.float32(2.0**-10)  # a subnormal
    segs = [
        [-0.0],  # 0.0f + -0.0f is +0.0f: the chain must start from 0.0f
        [-0.0, -0.0],
        [-0.0] * 40,  # a heavy segment of -0.0
        [sub, sub, -sub],
        [sub] * 50,  # heavy, subnormal sums
        [tiny, -tiny / 2, -tiny / 4],  # normal to subnormal
        [np.inf, 1.0],
        [np.inf, -np.inf],  # NaN
        [1.0] * 35 + [-np.inf] + [2.0] * 10,  # heavy with -inf
        [np.nan, 1.0],
        [1.0] * 40 + [np.nan],  # heavy, NaN in its last chunk
        [3.0e38, 3.0e38, -3.0e38],  # overflows to inf, stays inf
    ]
    # the segments' edges interleaved, each segment's own order kept
    rng = np.random.default_rng(4)
    ids_s = rng.permutation(np.concatenate([np.full(len(s), i) for i, s in enumerate(segs)]))
    vals_s = np.empty(len(ids_s), np.float32)
    for i, s in enumerate(segs):
        vals_s[ids_s == i] = s
    # XLA-CPU flushes subnormals to zero: segments 3-5 against index_add_ only
    check_all(host_lib, vals_s, ids_s, len(segs) + 2, flushed=(3, 4, 5))
    plain = segment_sum_plain(torch.from_numpy(vals_s), torch.from_numpy(ids_s.astype(np.int64)),
                              len(segs) + 2).numpy()
    assert not np.signbit(plain[0]) and not np.signbit(plain[1])  # +0.0, not -0.0
    assert plain[3] != 0 and abs(plain[3]) < tiny


def test_google_push_order_at_full_size(host_lib):
    """PGD's push edge order on the google graph (640,000 edges into 110,000
    segments, the longest 2,038), values as PGD's deltas: many zeros."""
    g = make_dataset("google")
    rng = np.random.default_rng(5)
    vals = rng.random(g.num_edges, dtype=np.float32) / 1000
    vals[rng.random(g.num_edges) < 0.5] = 0.0
    lens = np.bincount(g.neighbors, minlength=g.num_vertices)
    assert lens.max() > 2000 and (lens > t_ss.CHUNK).sum() > 100
    check_all(host_lib, vals, g.neighbors, g.num_vertices)
