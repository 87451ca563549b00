"""K5's bfloat16 tensor-core route, emulated on the CPU, against the JAX
package and the plain version.

``csrc/host_step_test.cpp::host_flash_attn_tc`` is a g++ build of the step
header ``csrc/flash_attn_step.h`` that runs the kernel's bfloat16 route one
warp at a time, its 32 lanes emulated on the host: the swizzled shared-
memory tiles, ldmatrix from the lanes' row addresses, each ``mma.sync`` as
a plain loop over the PTX fragment layout, the shuffles as butterflies over
the lanes, and the header's masks, softmax step and hi / lo split of P.
The kernel itself runs against the plain version on a card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerance: bfloat16 ``rtol=1e-2, atol=1e-3`` (``TOL_BLOCKED`` of
``tests/test_torch_flash_attn.py``, unchanged) against ``blocked_attention``
and the plain version: both compute in float32 and round once to
bfloat16.  The hi / lo split keeps P within about 2^-17 of its float32
value, so that premise holds on the tensor cores too.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.models.attention import blocked_attention as j_blocked

from repro_torch.kernels.build import INCLUDE_DIR
from repro_torch.kernels.flash_attn import flash_attn as t_fa
from repro_torch.kernels.flash_attn.ref import blocked_attention_plain

TOL = dict(rtol=1e-2, atol=1e-3)  # TOL_BLOCKED["bfloat16"]

# (b, sq, skv, h, kv, hd, causal, window, q_offset)
SHAPES = [
    (2, 256, 256, 4, 2, 64, True, 0, 0),  # tests/test_kernels.py:38-44
    (1, 384, 384, 2, 2, 128, True, 128, 0),
    (2, 200, 200, 4, 4, 64, False, 0, 0),
    (1, 130, 130, 2, 1, 64, True, 0, 0),
    (2, 100, 100, 8, 2, 32, True, 0, 0),  # hd 32, GQA 4
    (1, 150, 150, 2, 1, 128, False, 40, 0),  # hd 128, non-causal window
    (1, 300, 300, 4, 4, 64, True, 10, 0),  # first visited tiles all masked
    (1, 200, 200, 2, 2, 128, True, 128, 0),  # hd 128, window 128, S not a multiple of 64
    (2, 70, 250, 8, 2, 64, True, 0, 180),  # GQA 4 with q_offset
]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    src = t_fa.SOURCE.parent / "host_step_test.cpp"
    out = tmp_path_factory.mktemp("host_fa_tc") / "libflash_attn_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(INCLUDE_DIR),
                    "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.host_flash_attn_tc.argtypes = [vp] * 4 + [i64] * 3 + [ci] * 3 + [
        ctypes.c_float, ci, i64, i64, ci]
    lib.host_flash_attn_tc.restype = ci
    lib.host_split_bf16.argtypes = [vp, vp, vp, i64]
    lib.host_tile_order.argtypes = [i64, i64]
    lib.host_tile_order.restype = i64
    lib.host_tile_needs_mask.argtypes = [i64, i64, i64, i64, i64, ci, i64]
    lib.host_allowed.argtypes = [i64, i64, i64, ci, i64]
    lib.host_fragment_maps.argtypes = [vp]
    lib.host_ldmatrix_offsets.argtypes = [ci, vp]
    lib.host_smem_off.argtypes = [ci, ci, ci]
    return lib


def emulated(lib, q, k, v, causal, win, q_offset, split=1):
    """The emulated bfloat16 route's output for bfloat16 torch inputs."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qf, kf, vf = (t.float().contiguous().numpy() for t in (q, k, v))
    out = np.zeros(qf.shape, np.float32)
    scale = float(torch.tensor(hd**-0.5, dtype=torch.bfloat16))
    rc = lib.host_flash_attn_tc(qf.ctypes.data, kf.ctypes.data, vf.ctypes.data, out.ctypes.data,
                                b, sq, skv, h, kvh, hd, scale, int(causal), win, q_offset, split)
    assert rc == 0
    return torch.from_numpy(out).to(torch.bfloat16)


def random_inputs(seed, b, sq, skv, h, kv, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd))]


def cancelling_inputs(seed, b, sq, skv, h, kv, hd):
    """Key rows in pairs, the second 1.05 times the first, with values +v and
    -v of size ~16: each output is a small difference of large terms, so one
    bfloat16 rounding of P (2^-9 of a term) lands well outside 1e-3."""
    q, k, v = random_inputs(seed, b, sq, skv, h, kv, hd)
    k[:, 1::2] = k[:, 0::2][:, :k[:, 1::2].shape[1]] * 1.05
    v *= 16
    v[:, 1::2] = -v[:, 0::2][:, :v[:, 1::2].shape[1]]
    return [q, k, v]


def to_both(arrs):
    torch_in = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    jax_in = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    return torch_in, jax_in


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("family", ["random", "cancelling"])
@pytest.mark.parametrize("b,sq,skv,h,kv,hd,causal,win,qoff", SHAPES)
def test_emulated_route_matches_plain_and_jax(host_lib, family, b, sq, skv, h, kv, hd, causal,
                                              win, qoff):
    make = random_inputs if family == "random" else cancelling_inputs
    (tq, tk, tv), (jq, jk, jv) = to_both(make(12, b, sq, skv, h, kv, hd))
    got = emulated(host_lib, tq, tk, tv, causal, win, qoff)
    ref = blocked_attention_plain(tq, tk, tv, causal, win, qoff)
    np.testing.assert_allclose(f32(got), f32(ref), **TOL)
    jref = j_blocked(jq, jk, jv, causal=causal, sliding_window=win, q_offset=qoff)
    np.testing.assert_allclose(f32(got), f32(jref), **TOL)


@pytest.mark.parametrize("b,sq,skv,h,kv,hd,causal,win,qoff", [SHAPES[0], SHAPES[4], SHAPES[7]])
def test_cancelling_family_needs_the_split(host_lib, b, sq, skv, h, kv, hd, causal, win, qoff):
    """Without lo (one bfloat16 rounding of P) the cancelling family falls
    outside the tolerance; the same emulation with the split passes above."""
    (tq, tk, tv), _ = to_both(cancelling_inputs(12, b, sq, skv, h, kv, hd))
    ref = f32(blocked_attention_plain(tq, tk, tv, causal, win, qoff))
    hi_only = f32(emulated(host_lib, tq, tk, tv, causal, win, qoff, split=0))
    outside = np.abs(hi_only - ref) > TOL["atol"] + TOL["rtol"] * np.abs(ref)
    assert outside.sum() > 100


def test_split_is_exact_to_2_pow_minus_16(host_lib):
    rng = np.random.default_rng(0)
    tiny = np.float32(np.finfo(np.float32).tiny)
    p = np.concatenate([
        np.array([0.0, 1.0, 0.5, 1 - 2**-24, tiny, tiny / 2, tiny * 2**-23, 2**-117, 2**-118],
                 np.float32),
        rng.random(200_000, dtype=np.float32),
        np.exp(-rng.random(100_000) * 100).astype(np.float32),  # exp(s - m) of distant scores
        rng.random(10_000, dtype=np.float32) * tiny,  # subnormals
    ]).astype(np.float32)
    hi, lo = np.zeros_like(p), np.zeros_like(p)
    host_lib.host_split_bf16(p.ctypes.data, hi.ctypes.data, lo.ctypes.data, p.size)
    # both parts are bfloat16 values: their low 16 bits are zero
    assert not (hi.view(np.uint32) & 0xFFFF).any() and not (lo.view(np.uint32) & 0xFFFF).any()
    assert np.array_equal(hi, torch.from_numpy(p).bfloat16().float().numpy())
    err = np.abs(p.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    # relative 2^-16 wherever lo is a normal float (p >= 2^-117); below that
    # bfloat16's finest step, 2^-133, floors the error at 2^-134
    assert (err <= np.maximum(2.0**-16 * p.astype(np.float64), 2.0**-134)).all()
    normal = p >= 2.0**-117
    assert (err[normal] <= 2.0**-16 * p[normal]).all()
    assert err[0] == 0 and err[1] == 0


def test_tile_order_is_a_permutation(host_lib):
    for n in list(range(1, 130)) + [1000, 4096 // 64]:
        order = [host_lib.host_tile_order(i, n) for i in range(n)]
        assert sorted(order) == list(range(n))
        assert order[0] == n - 1  # longest first


def test_no_mask_tiles_are_wholly_allowed(host_lib):
    """Wherever the predicate says a tile needs no mask, every (q, k) pair of
    the tile is allowed: exhaustive over small shapes, windows and offsets."""
    checked = 0
    for skv in (1, 5, 16, 23, 40):
        for causal in (0, 1):
            for win in (0, 1, 3, 8, 17):
                for qpos0 in range(0, 45, 3):
                    for kpos0 in range(0, 40, 4):
                        for nq, nk in ((1, 1), (4, 8), (16, 8), (5, 3)):
                            if host_lib.host_tile_needs_mask(qpos0, nq, kpos0, nk, skv, causal,
                                                             win):
                                continue
                            checked += 1
                            for qp in range(qpos0, qpos0 + nq):
                                for kp in range(kpos0, kpos0 + nk):
                                    assert host_lib.host_allowed(qp, kp, skv, causal, win), (
                                        qpos0, nq, kpos0, nk, skv, causal, win, qp, kp)
    assert checked > 1000


def test_fragment_maps_cover_each_element_once(host_lib):
    rc = np.zeros((32 * 8 + 32 * 4 + 32 * 4, 2), np.int32)
    host_lib.host_fragment_maps(rc.ctypes.data)
    a, b, c = rc[:256], rc[256:384], rc[384:]
    for m, rows, cols in ((a, 16, 16), (b, 16, 8), (c, 16, 8)):
        assert sorted(map(tuple, m)) == [(r, q) for r in range(rows) for q in range(cols)]
    # P's A fragment is read from the S accumulators of n-tiles 2j, 2j + 1:
    # element i of A at (row, col) is element i % 4 of n-tile i // 4 at
    # (row, col % 8)
    for lane in range(32):
        for i in range(8):
            ar, ac = a[lane * 8 + i]
            cr, cc = c[lane * 4 + i % 4]
            assert (ar, ac) == (cr, cc + 8 * (i // 4))


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_swizzle_is_a_bijection_and_ldmatrix_is_conflict_free(host_lib, hd):
    offs = sorted(host_lib.host_smem_off(r, c, hd) for r in range(64) for c in range(hd))
    assert offs == list(range(64 * hd))
    out = np.zeros(4096, np.int32)
    n = host_lib.host_ldmatrix_offsets(hd, out.ctypes.data)
    assert n > 0 and n % 32 == 0
    for ins in out[:n].reshape(-1, 32):
        assert (ins % 16 == 0).all()  # 16-byte row segments
        for m in range(4):  # one phase per 8-row matrix: 8 distinct bank groups
            groups = (ins[8 * m:8 * m + 8] % 128) // 16
            assert len(set(groups.tolist())) == 8
