"""The port's BaseΔ kernels (K3a, K3b) and their entry API against the JAX
package.

The plain PyTorch versions (CPU tensors) and a g++ build of the CUDA step
header ``csrc/basedelta_step.h`` — the logic the GPU runs, compiled for
the host, K3b's kernels as every thread of their grid through its
thread-to-element map, on both routes — are held bit for bit against the Pallas kernels in interpret
mode and the JAX oracles ``compress_ref`` / ``decompress_ref``, on the
cases of the JAX package's own tests plus deltas that wrap at the int32
extremes.  ``pack_ragged`` / ``compress_entries`` / ``roundtrip`` give the
reference's arrays, and the modes the kernel picks for AMC's recorded
entries equal ``select_modes``'.  The kernels themselves run against the
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

from repro.kernels.basedelta import ops as j_ops
from repro.kernels.basedelta.basedelta import (
    basedelta_compress_tiles as pallas_compress,
    basedelta_decompress_tiles as pallas_decompress,
)
from repro.kernels.basedelta.ref import compress_ref as j_compress_ref
from repro.kernels.basedelta.ref import decompress_ref as j_decompress_ref

from repro_torch.kernels.basedelta import basedelta as t_basedelta
from repro_torch.kernels.basedelta.basedelta import (
    basedelta_compress_plain,
    basedelta_compress_tiles,
    basedelta_decompress_plain,
    basedelta_decompress_tiles,
)
from repro_torch.kernels.basedelta.ops import compress_entries, pack_ragged, roundtrip
from repro_torch.kernels.basedelta.ref import compress_ref, decompress_ref

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
EXTREME_ROWS = [
    [I32_MIN, I32_MAX, 0, -1],
    [0, I32_MIN, 5, 0],
    [0, I32_MIN, 200, 0],
    [-1, I32_MAX, 0, 0],
    [I32_MAX, I32_MIN, -40000, 7],
    [5, 5 + 127, 5 - 127, 5 + 128],
    [5, 5 + 32767, 5 - 32768, 0],
    [I32_MIN, I32_MIN, I32_MIN, I32_MIN],
]


@pytest.fixture(scope="session")
def host_bd(tmp_path_factory):
    """ctypes handle on a g++ build of ``basedelta_step.h`` (through the
    test-only driver ``csrc/host_step_test.cpp``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    src = t_basedelta.SOURCE.parent / "host_step_test.cpp"
    out = tmp_path_factory.mktemp("host_bd") / "libbasedelta_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(out), str(src)],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.host_basedelta_compress.argtypes = [vp, vp, i64, ci, vp, vp]
    lib.host_basedelta_compress.restype = ci
    lib.host_basedelta_decompress.argtypes = [vp, vp, i64, ci, vp]
    lib.host_basedelta_decompress.restype = ci
    lib.host_basedelta_decompress_map.argtypes = [vp, vp, i64, ci, ci, vp]
    lib.host_basedelta_decompress_map.restype = ci
    lib.host_basedelta_map.argtypes = [i64, ci, ci, vp]
    lib.host_basedelta_map.restype = ci
    return lib


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def host_compress(lib, tiles, counts):
    e, w = tiles.shape
    deltas = torch.empty_like(tiles)
    mode = torch.empty(e, dtype=torch.int32)
    assert lib.host_basedelta_compress(_ptr(tiles), _ptr(counts), e, w, _ptr(deltas), _ptr(mode)) == 0
    return deltas, mode


def host_decompress(lib, base, deltas):
    out = torch.empty_like(deltas)
    e, w = deltas.shape
    assert lib.host_basedelta_decompress(_ptr(base), _ptr(deltas), e, w, _ptr(out)) == 0
    return out


def _tiles(e, width, spread, seed):
    """The JAX package's test tiles (``tests/test_kernels.py``)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, width + 1, e).astype(np.int32)
    tiles = np.zeros((e, width), np.int32)
    for i in range(e):
        base = rng.integers(0, 2**24)
        tiles[i, : counts[i]] = base + rng.integers(-spread, spread, counts[i])
    return tiles, counts


def _all_versions_equal(lib, tiles, counts, with_pallas=True):
    t, c = torch.from_numpy(tiles), torch.from_numpy(counts)
    got = basedelta_compress_plain(t, c)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    for other in (host_compress(lib, t, c), basedelta_compress_tiles(t, c)):
        np.testing.assert_array_equal(other[0].numpy(), got[0].numpy())
        np.testing.assert_array_equal(other[1].numpy(), got[1].numpy())
    base = t[:, 0].contiguous()
    rec = basedelta_decompress_plain(base, got[0])
    np.testing.assert_array_equal(host_decompress(lib, base, got[0]).numpy(), rec.numpy())
    np.testing.assert_array_equal(basedelta_decompress_tiles(base, got[0]).numpy(), rec.numpy())
    if not with_pallas:
        return got, rec
    refs = [
        pallas_compress(jnp.asarray(tiles), jnp.asarray(counts), interpret=True),
        j_compress_ref(jnp.asarray(tiles), jnp.asarray(counts)),
    ]
    for d, m in refs:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(d))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(m))
    jbase = jnp.asarray(tiles[:, 0])
    for r in (pallas_decompress(jbase, jnp.asarray(got[0].numpy()), interpret=True),
              j_decompress_ref(jbase, jnp.asarray(got[0].numpy()))):
        np.testing.assert_array_equal(rec.numpy(), np.asarray(r))
    return got, rec


@given(
    e=st.integers(1, 30),
    width=st.sampled_from([8, 32]),
    spread=st.sampled_from([50, 5000, 10**6]),
    seed=st.integers(0, 30),
)
@settings(max_examples=15, deadline=None)
def test_k3_versions_match_pallas_and_oracle(host_bd, e, width, spread, seed):
    _all_versions_equal(host_bd, *_tiles(e, width, spread, seed))


@pytest.mark.parametrize("width", [4, 33])
def test_k3_int32_extremes(host_bd, width):
    """Deltas that wrap in int32: abs(INT32_MIN) stays negative, as in JAX."""
    tiles = np.zeros((len(EXTREME_ROWS), width), np.int64)
    tiles[:, :4] = EXTREME_ROWS
    tiles[:, 4:] = I32_MAX
    counts = np.array([4, 4, 4, 4, 4, 4, 4, width], np.int32)
    got, rec = _all_versions_equal(host_bd, tiles.astype(np.int32), counts)
    assert got[1].tolist() == [2, 0, 1, 0, 2, 1, 2, 0]
    np.testing.assert_array_equal(rec.numpy(), np.where(
        np.arange(width)[None, :] < counts[:, None], tiles.astype(np.int32), tiles[:, :1]))


@pytest.mark.parametrize("shape", [(0, 32), (5, 1), (7, 40)])
def test_k3_edge_shapes(host_bd, shape):
    """E = 0 (the Pallas kernel cannot take it; held against the oracle and
    the host build only), W = 1, and W above a warp's 32 lanes."""
    e, w = shape
    rng = np.random.default_rng(e + w)
    tiles = rng.integers(-3000, 3000, shape).astype(np.int32)
    counts = rng.integers(0, w + 1, e).astype(np.int32)
    got, _ = _all_versions_equal(host_bd, tiles, counts, with_pallas=e > 0)
    assert got[0].shape == shape and got[1].shape == (e,)


def test_k3_counts_zero_and_full(host_bd):
    tiles = np.random.default_rng(3).integers(-99, 99, (4, 32)).astype(np.int32)
    got, _ = _all_versions_equal(host_bd, tiles, np.array([0, 32, 0, 32], np.int32))
    assert not got[0][0].any() and not got[0][2].any()


# ------------------------------------------- K3b's thread-to-element map


def _view(buf_words, e, w, off):
    """A contiguous (e, w) int32 view ``off`` words into a fresh buffer."""
    buf = torch.empty(buf_words + 4, dtype=torch.int32)
    base_off = (-buf.data_ptr() // 4) % 4  # words to the next 16-byte boundary
    return buf[base_off + off : base_off + off + e * w].view(e, w)


def host_decompress_map(lib, base, deltas, vec):
    out = torch.full_like(deltas, 0x5A5A5A5A)  # fresh, so 16-byte aligned
    e, w = deltas.shape
    rc = lib.host_basedelta_decompress_map(_ptr(base), _ptr(deltas), e, w, vec, _ptr(out))
    return rc, out


@pytest.mark.parametrize("width", range(1, 41))
def test_k3b_thread_map_matches_oracle_and_jax(host_bd, width):
    """Every thread of K3b's grid, on the route the wrapper picks, for
    E = 0, 1 and path D's 77,995 rows, aligned and 4 bytes off alignment:
    equal to the plain version and JAX's ``decompress_ref``; the vector
    route is refused on a misaligned view."""
    rng = np.random.default_rng(width)
    for e in (0, 1, 77_995):
        d = rng.integers(I32_MIN, I32_MAX, (e, width), dtype=np.int64, endpoint=True)
        base_np = rng.integers(I32_MIN, I32_MAX, e, dtype=np.int64, endpoint=True)
        base = torch.from_numpy(base_np.astype(np.int32))
        want = decompress_ref(base, torch.from_numpy(d.astype(np.int32)))
        if e:
            np.testing.assert_array_equal(want.numpy(), np.asarray(j_decompress_ref(
                jnp.asarray(base_np.astype(np.int32)), jnp.asarray(d.astype(np.int32)))))
        for off in (0, 1):
            deltas = _view(e * width, e, width, off)
            deltas.copy_(torch.from_numpy(d.astype(np.int32)))
            route = t_basedelta.decompress_route(deltas, torch.empty_like(deltas))
            if e:  # an empty view has no address
                assert deltas.is_contiguous() and (deltas.data_ptr() % 16 == 0) == (off == 0)
                assert route == ("vector" if width % 4 == 0 and off == 0 else "scalar")
            rc, got = host_decompress_map(host_bd, base, deltas, int(route == "vector"))
            assert rc == 0
            np.testing.assert_array_equal(got.numpy(), want.numpy())
            if e and width % 4 == 0 and off:
                assert host_decompress_map(host_bd, base, deltas, 1)[0] == 2
            if e and route == "vector":  # the scalar route gives the same
                rc, got = host_decompress_map(host_bd, base, deltas, 0)
                np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("e,w,vec,want", [
    (77_995, 32, 1, (8, 8, 32, 2438)),  # path D's tiles: one row a thread group
    (77_995, 33, 0, (33, 33, 7, 4224)),  # capped at a few waves
    (5, 1, 0, (1, 1, 256, 1)),
    (3, 2048, 1, (512, 256, 1, 3)),  # a row wider than a block loops
])
def test_k3b_map_shape(host_bd, e, w, vec, want):
    out = (ctypes.c_int64 * 4)()
    assert host_bd.host_basedelta_map(e, w, vec, out) == 0
    assert tuple(out) == want


# -------------------------------------------------------- entry API


def _ragged(seed, n=300):
    """The JAX package's ragged round-trip case (``tests/test_kernels.py``)."""
    rng = np.random.default_rng(seed)
    mb = rng.integers(1 << 20, (1 << 20) + 4000, n).astype(np.int64)
    off = np.concatenate([[0], np.cumsum(rng.integers(1, 21, 40))])
    off = off[off <= n]
    if off[-1] != n:
        off = np.append(off, n)
    return mb, off


@pytest.mark.parametrize("seed", [2, 7])
def test_entry_api_equals_jax(seed):
    mb, off = _ragged(seed)
    for got, ref in zip(pack_ragged(mb, off), j_ops.pack_ragged(mb, off)):
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype
    got = compress_entries(mb, off, device="cpu")
    ref = j_ops.compress_entries(mb, off)
    for g, r in zip(got[:4], ref[:4]):
        np.testing.assert_array_equal(g, r)
        assert g.dtype == r.dtype
    assert got[4] == ref[4]
    rec = roundtrip(mb, off, device="cpu")
    np.testing.assert_array_equal(rec, j_ops.roundtrip(mb, off))
    np.testing.assert_array_equal(rec, mb)
    assert rec.dtype == np.int64


def test_entry_api_empty_and_oversized():
    empty = np.zeros(0, np.int64), np.zeros(1, np.int64)
    assert compress_entries(*empty, device="cpu")[4] == 0
    assert roundtrip(*empty, device="cpu").shape == (0,)
    with pytest.raises(ValueError, match="exceeds tile width"):
        roundtrip(np.arange(100, dtype=np.int64), np.array([0, 50, 100]), device="cpu")


def test_modes_equal_select_modes_on_amc_tables():
    """compress_entries on every table AMC records for tiny bfs: the modes
    are ``select_modes``' and the round trip gives the misses back."""
    from repro_torch.core import WorkloadSpec
    from repro_torch.core.amc.prefetcher import AMCConfig, AMCPrefetcher
    from repro_torch.core.amc.storage import AMCStorage

    class Keep(AMCStorage):
        def store(self, table):
            table = super().store(table)
            self.kept.append(table)
            return table

    wl = WorkloadSpec("bfs", "tiny").build(device="cpu")
    storage = Keep(int(AMCConfig().storage_fraction * wl.input_bytes))
    storage.kept = []
    AMCPrefetcher().generate(wl, storage=storage)
    assert sum(t.num_entries for t in storage.kept) > 100
    for t in storage.kept:
        _, _, modes, counts, _ = compress_entries(t.miss_blocks, t.miss_offsets, device="cpu")
        np.testing.assert_array_equal(modes, t.mode)
        np.testing.assert_array_equal(counts, t.nmiss)
        np.testing.assert_array_equal(
            roundtrip(t.miss_blocks, t.miss_offsets, device="cpu"),
            t.miss_blocks[t.miss_offsets[0] : t.miss_offsets[-1]],
        )


# ------------------------------------------------------ wrappers, routing


def test_entry_api_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mb, off = _ragged(2)
    for call in (compress_entries, roundtrip):
        with pytest.raises(RuntimeError, match="CUDA"):
            call(mb, off)


def test_non_cpu_tensor_never_reaches_plain_version(monkeypatch):
    def no_plain(*a, **k):
        raise AssertionError("plain version reached with a device tensor")

    def no_build(source):
        raise RuntimeError(f"cannot build {source.name} here")

    monkeypatch.setattr(t_basedelta, "basedelta_compress_plain", no_plain)
    monkeypatch.setattr(t_basedelta, "basedelta_decompress_plain", no_plain)
    monkeypatch.setattr(t_basedelta, "load", no_build)
    meta = torch.device("meta")
    tiles = torch.zeros((4, 32), dtype=torch.int32, device=meta)
    rows = torch.zeros(4, dtype=torch.int32, device=meta)
    with pytest.raises(RuntimeError, match="cannot build basedelta"):
        basedelta_compress_tiles(tiles, rows)
    with pytest.raises(RuntimeError, match="cannot build basedelta"):
        basedelta_decompress_tiles(rows, tiles)


def test_wrappers_validate_inputs():
    tiles = torch.zeros((4, 8), dtype=torch.int32)
    rows = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        basedelta_compress_tiles(tiles.long(), rows)
    with pytest.raises(ValueError):
        basedelta_compress_tiles(tiles, rows[:3])
    with pytest.raises(ValueError):
        basedelta_compress_tiles(torch.zeros((4, 0), dtype=torch.int32), rows)
    with pytest.raises(ValueError):
        basedelta_decompress_tiles(rows, tiles.t())
    # the oracle and the plain version are one function
    assert basedelta_compress_plain is compress_ref and basedelta_decompress_plain is decompress_ref
