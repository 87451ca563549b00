"""K5's float32 tensor-core route, emulated on the CPU, against the JAX
package and the plain version.

``csrc/host_step_test.cpp::host_flash_attn_f32tc`` is a g++ build of the
step header ``csrc/flash_attn_step.h`` that runs the kernel's float32 route
one 16-row strip at a time, a warp's 32 lanes emulated on the host: the Q
tile scaled in float32 and the K and V tiles split into three bfloat16
parts as images of the kernel's swizzled shared-memory planes, ldmatrix
emulated from the lanes' row addresses, P split from the score registers,
each ``mma.sync`` as a loop over the PTX fragment layout for each pair of
parts the kernel takes, summed as an H100's tensor cores sum (``tce_mma_fused``:
every term cut toward zero 25 bits below the largest exponent, the sum
rounded toward zero, the model ``tools/mma_accumulation.py`` fits to the
card's results bit for bit), and the header's masks and softmax step.  The
kernel itself runs against the plain version on a card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerance: float32 ``rtol=1e-4, atol=1e-5`` (``TOL_BLOCKED`` of
``tests/test_torch_flash_attn.py`` and ``chip_smoke.ATTN_TOL``, unchanged)
against ``blocked_attention`` and the plain version.  Three parts hold
every product to about 2^-24, so that tolerance is float32's own; the
cancelling family shows that two parts would not hold it.
"""
import ctypes
import importlib.util
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.models.attention import blocked_attention as j_blocked

from repro_torch.kernels.build import INCLUDE_DIR
from repro_torch.kernels.flash_attn import flash_attn as t_fa
from repro_torch.kernels.flash_attn.ref import blocked_attention_plain

TOL = dict(rtol=1e-4, atol=1e-5)  # TOL_BLOCKED["float32"]

# (b, sq, skv, h, kv, hd, causal, window, q_offset)
SHAPES = [
    (2, 256, 256, 4, 2, 64, True, 0, 0),  # GQA 2
    (1, 384, 384, 2, 2, 128, True, 128, 0),  # hd 128: Q parts from shared memory
    (2, 200, 200, 4, 4, 64, False, 0, 0),  # non-causal, ragged S
    (1, 130, 130, 2, 1, 64, True, 0, 0),  # ragged S, kv 1
    (2, 100, 100, 8, 2, 32, True, 0, 0),  # hd 32, GQA 4
    (1, 150, 150, 2, 1, 128, False, 40, 0),  # hd 128, non-causal window
    (1, 300, 300, 4, 4, 64, True, 10, 0),  # first visited tiles all masked
    (2, 70, 250, 8, 2, 64, True, 0, 180),  # GQA 4 with q_offset
    (1, 90, 200, 2, 2, 128, True, 0, 110),  # hd 128 with q_offset
]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    src = t_fa.SOURCE.parent / "host_step_test.cpp"
    out = tmp_path_factory.mktemp("host_fa_f32tc") / "libflash_attn_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(INCLUDE_DIR),
                    "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.host_flash_attn_f32tc.argtypes = [vp] * 4 + [i64] * 3 + [ci] * 3 + [
        ctypes.c_float, ci, i64, i64, ci]
    lib.host_flash_attn_f32tc.restype = ci
    lib.host_f32_ldmatrix_offsets.argtypes = [ci, vp, vp, vp]
    lib.host_f32_ldmatrix_offsets.restype = ci
    lib.host_split_parts.argtypes = [vp, vp, i64]
    lib.host_mma.argtypes = [vp, vp, vp]
    return lib


def emulated(lib, q, k, v, causal, win, q_offset, parts=3):
    """The emulated float32 route's output for float32 torch inputs."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qf, kf, vf = (t.contiguous().numpy() for t in (q, k, v))
    out = np.full(qf.shape, np.nan, np.float32)
    rc = lib.host_flash_attn_f32tc(qf.ctypes.data, kf.ctypes.data, vf.ctypes.data,
                                   out.ctypes.data, b, sq, skv, h, kvh, hd, hd**-0.5,
                                   int(causal), win, q_offset, parts)
    assert rc == 0
    return out


def random_inputs(seed, b, sq, skv, h, kv, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd))]


def cancelling_inputs(seed, b, sq, skv, h, kv, hd):
    """Key rows in pairs, the second 1.05 times the first, with values +v and
    -v of size ~16: each output is a small difference of large terms."""
    q, k, v = random_inputs(seed, b, sq, skv, h, kv, hd)
    k[:, 1::2] = k[:, 0::2][:, :k[:, 1::2].shape[1]] * 1.05
    v *= 16
    v[:, 1::2] = -v[:, 0::2][:, :v[:, 1::2].shape[1]]
    return [q, k, v]


@pytest.mark.parametrize("family", ["random", "cancelling"])
@pytest.mark.parametrize("b,sq,skv,h,kv,hd,causal,win,qoff", SHAPES)
def test_emulated_route_matches_plain_and_jax(host_lib, family, b, sq, skv, h, kv, hd, causal,
                                              win, qoff):
    make = random_inputs if family == "random" else cancelling_inputs
    arrs = make(13, b, sq, skv, h, kv, hd)
    tq, tk, tv = (torch.from_numpy(a) for a in arrs)
    got = emulated(host_lib, tq, tk, tv, causal, win, qoff)
    ref = blocked_attention_plain(tq, tk, tv, causal, win, qoff).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    jref = j_blocked(*(jnp.asarray(a) for a in arrs), causal=causal, sliding_window=win,
                     q_offset=qoff)
    np.testing.assert_allclose(got, np.asarray(jref), **TOL)


@pytest.mark.parametrize("b,sq,skv,h,kv,hd,causal,win,qoff", [SHAPES[0], SHAPES[1], SHAPES[4]])
def test_cancelling_family_needs_three_parts(host_lib, b, sq, skv, h, kv, hd, causal, win, qoff):
    """With two parts a side (hi hi, hi lo, lo hi: products to about 2^-16)
    the cancelling family falls outside float32's tolerance; the same
    emulation with three parts passes above."""
    tq, tk, tv = (torch.from_numpy(a) for a in cancelling_inputs(13, b, sq, skv, h, kv, hd))
    ref = blocked_attention_plain(tq, tk, tv, causal, win, qoff).numpy()
    two = emulated(host_lib, tq, tk, tv, causal, win, qoff, parts=2)
    outside = np.abs(two - ref) > TOL["atol"] + TOL["rtol"] * np.abs(ref)
    assert outside.sum() > 100


def test_three_parts_hold_float32(host_lib):
    """x1 + x2 + x3 (each part a bfloat16 value) is within 2^-24 of x
    wherever the parts are normal floats, and each part is the bfloat16
    rounding of what the parts before it left."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.array([0.0, 1.0, -1.0, 1 - 2**-24, 3.0e38, -1e-30, 2.0**-100], np.float32),
        rng.normal(size=100_000).astype(np.float32),
        (rng.normal(size=50_000) * 10.0 ** rng.uniform(-20, 20, 50_000)).astype(np.float32),
    ])
    parts = np.zeros((x.size, 3), np.float32)
    host_lib.host_split_parts(x.ctypes.data, parts.ctypes.data, x.size)
    assert not (parts.view(np.uint32) & 0xFFFF).any()  # every part is a bfloat16 value
    left = x.copy()
    for p in range(3):
        want = torch.from_numpy(left).bfloat16().float().numpy()
        np.testing.assert_array_equal(parts[:, p], want)
        left = left - parts[:, p]  # exact in float32
    err = np.abs(x.astype(np.float64) - parts.astype(np.float64).sum(axis=1))
    normal = np.abs(x) >= 2.0**-100
    assert (err[normal] <= 2.0**-24 * np.abs(x[normal])).all()


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_fragment_loads_are_free_of_bank_conflicts(host_lib, hd):
    """Every ldmatrix.x4 of the float32 route's planes (Q: a 64-row tile;
    K, V: FA_F32_BK rows, 64 at hd 32 and 32 above) addresses 16-byte row
    segments inside its tile, each 8-row matrix on 8 different bank
    groups, and one pass over a tile's k-steps addresses each segment of
    it exactly once."""
    out = np.zeros(1 << 14, np.int32)
    n_q, n_k = np.zeros(1, np.int32), np.zeros(1, np.int32)
    n = host_lib.host_f32_ldmatrix_offsets(hd, out.ctypes.data, n_q.ctypes.data,
                                           n_k.ctypes.data)
    bk = 64 if hd <= 32 else 32
    q, k, v = out[:n_q[0]], out[n_q[0]:n_q[0] + n_k[0]], out[n_q[0] + n_k[0]:n]
    for offs, rows in ((q, 64), (k, bk), (v, bk)):
        assert len(offs) == rows * hd * 2 // 16  # 16-byte segments of the tile, each once
        assert sorted(offs.tolist()) == list(range(0, rows * hd * 2, 16))
        for ins in offs.reshape(-1, 32):
            for m in range(4):
                groups = (ins[8 * m:8 * m + 8] % 128) // 16
                assert len(set(groups.tolist())) == 8


def test_emulated_mma_sums_as_the_card(host_lib):
    """host_mma (tce_mma_fused) gives, bit for bit, what the model that
    tools/mma_accumulation.py fits to an H100's mma.sync results gives, on
    that tool's cases: products and addends over many binades, and sums
    that cancel."""
    path = Path(__file__).resolve().parent.parent / "tools" / "mma_accumulation.py"
    spec = importlib.util.spec_from_file_location("mma_accumulation", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    a, b, c = tool.cases(64)
    want = tool.model_mma(a, b, c, frac=25, rz=True, operands=True)
    got = c.copy()
    for i in range(len(a)):
        host_lib.host_mma(a[i].ctypes.data, b[i].ctypes.data, got[i].ctypes.data)
    np.testing.assert_array_equal(got, want)
