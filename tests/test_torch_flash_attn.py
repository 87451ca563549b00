"""The port's K5 (blocked attention) against the JAX package, on the CPU.

The plain PyTorch version (what the K5 wrapper runs on a CPU tensor) and a
g++ build of the CUDA step header ``csrc/flash_attn_step.h`` (through the
test-only harness ``csrc/host_step_test.cpp``: each dtype's tensor-core
route, ``host_flash_attn_tc`` and ``host_flash_attn_f32tc``, with the tile
skipping the GPU runs) are held against the JAX oracle
``attention_ref``, the Pallas kernel ``mha`` in interpret mode and the
model's ``blocked_attention``, on the shapes of ``tests/test_kernels.py``
and ``tests/test_ssm_moe_attn.py``.  Inputs come from a numpy seed.  The
kernel itself runs against the plain version on a card in
``tests/test_torch_cuda.py``.

Tolerances: float32 as the JAX tests (``rtol=1e-4, atol=1e-5`` against
``blocked_attention``, ``2e-5`` against the Pallas kernel and the oracle);
bfloat16 ``rtol=1e-2, atol=1e-3`` against ``blocked_attention`` and the
plain version (both compute in float32 and round once to bfloat16, so they
differ by at most about one bfloat16 ulp, 2^-7 relative), and ``2e-2``, the
JAX tests' bfloat16 tolerance, against the Pallas kernel and the oracle
(the Pallas kernel scales q after the float32 cast where
blocked_attention scales before it).
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.flash_attn.ops import mha as j_mha
from repro.kernels.flash_attn.ref import attention_ref as j_attention_ref
from repro.models.attention import blocked_attention as j_blocked
from repro.models.attention import decode_attention as j_decode

from repro_torch.kernels.build import INCLUDE_DIR
from repro_torch.kernels.flash_attn import flash_attn as t_fa
from repro_torch.kernels.flash_attn.flash_attn import flash_attention
from repro_torch.kernels.flash_attn.ops import mha
from repro_torch.kernels.flash_attn.ref import attention_ref, blocked_attention_plain
from repro_torch.models.attention import (
    blocked_attention,
    decode_attention,
    decode_attention_seqsharded,
)

KERNEL_SHAPES = [  # tests/test_kernels.py:38-44
    (2, 256, 4, 2, 64, True, 0),
    (1, 384, 2, 2, 128, True, 128),
    (2, 200, 4, 4, 64, False, 0),
    (1, 130, 2, 1, 64, True, 0),
]
TOL_BLOCKED = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=1e-2, atol=1e-3)}
TOL_KERNEL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def inputs(seed, b, sq, skv, h, kv, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd))]
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in arrs)
    return (tq, tk, tv), (jq, jk, jv)


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def bh_layout(t, b, h):
    """(B, S, H, hd) -> (B*H, S, hd)."""
    return t.transpose(1, 2).reshape(b * h, t.shape[1], t.shape[3])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,hd,causal,win", KERNEL_SHAPES)
def test_plain_matches_jax_blocked_pallas_and_oracle(b, s, h, kv, hd, causal, win, dtype):
    (tq, tk, tv), (jq, jk, jv) = inputs(0, b, s, s, h, kv, hd, dtype)
    before = flash_attention.launches
    got = flash_attention(tq, tk, tv, causal=causal, sliding_window=win)
    assert flash_attention.launches == before  # CPU tensors run the plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    ref = j_blocked(jq, jk, jv, causal=causal, sliding_window=win)
    np.testing.assert_allclose(f32(got), f32(ref), **TOL_BLOCKED[dtype])
    pallas = j_mha(jq, jk, jv, causal=causal, sliding_window=win, interpret=True)
    np.testing.assert_allclose(f32(got), f32(pallas), **TOL_KERNEL[dtype])
    # the oracle: full softmax over repeated kv heads, (BH, S, hd)
    g = h // kv
    oracle = j_attention_ref(
        jnp.moveaxis(jq, 2, 1).reshape(b * h, s, hd),
        jnp.moveaxis(jnp.repeat(jk, g, axis=2), 2, 1).reshape(b * h, s, hd),
        jnp.moveaxis(jnp.repeat(jv, g, axis=2), 2, 1).reshape(b * h, s, hd),
        causal=causal, sliding_window=win)
    np.testing.assert_allclose(f32(bh_layout(got, b, h)), f32(oracle), **TOL_KERNEL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_jax(dtype):
    (tq, tk, tv), (jq, jk, jv) = inputs(1, 3, 70, 70, 1, 1, 32, dtype)
    got = attention_ref(tq[:, :, 0], tk[:, :, 0], tv[:, :, 0], causal=True, sliding_window=20)
    ref = j_attention_ref(jq[:, :, 0], jk[:, :, 0], jv[:, :, 0], causal=True, sliding_window=20)
    np.testing.assert_allclose(f32(got), f32(ref), **TOL_KERNEL[dtype])


@pytest.mark.parametrize(
    "b,s,h,kv,hd,win,block",
    [(2, 100, 4, 2, 16, 0, 32), (1, 90, 2, 2, 8, 24, 32)],  # tests/test_ssm_moe_attn.py:141-180
)
def test_model_blocked_attention_matches_jax(b, s, h, kv, hd, win, block):
    (tq, tk, tv), (jq, jk, jv) = inputs(5, b, s, s, h, kv, hd, "float32")
    got = blocked_attention_plain(tq, tk, tv, True, win, block_size=block)
    ref = j_blocked(jq, jk, jv, causal=True, sliding_window=win, block_size=block)
    np.testing.assert_allclose(f32(got), f32(ref), **TOL_BLOCKED["float32"])
    model = blocked_attention(tq, tk, tv, causal=True, sliding_window=win)
    assert torch.equal(model, blocked_attention_plain(tq, tk, tv, True, win))


def test_q_offset_matches_jax():
    (tq, tk, tv), (jq, jk, jv) = inputs(8, 2, 50, 180, 4, 2, 32, "float32")
    got = blocked_attention_plain(tq, tk, tv, True, 0, 130, block_size=64)
    ref = j_blocked(jq, jk, jv, causal=True, q_offset=130, block_size=64)
    np.testing.assert_allclose(f32(got), f32(ref), **TOL_BLOCKED["float32"])
    model = blocked_attention(tq, tk, tv, causal=True, q_offset=130)
    assert torch.equal(model, blocked_attention_plain(tq, tk, tv, True, 0, 130))


def test_mha_is_the_k5_wrapper():
    (tq, tk, tv), _ = inputs(9, 1, 64, 64, 4, 2, 32, "float32")
    assert torch.equal(mha(tq, tk, tv, causal=True, sliding_window=16),
                       blocked_attention_plain(tq, tk, tv, True, 16))


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(7)
    b, s, h, kv, hd = 2, 24, 4, 2, 8
    q, k, v = (rng.normal(size=sh).astype(np.float32)
               for sh in ((b, 1, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    lens = np.array([5, 24], np.int32)
    for win in (0, 4):
        got = decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(lens), sliding_window=win)
        ref = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
                       sliding_window=win)
        np.testing.assert_allclose(f32(got), f32(ref), rtol=1e-4, atol=1e-5)


def test_seqsharded_decode_waits_for_the_mesh():
    """The sequence-sharded decode takes a device mesh: on a one-rank mesh
    (a gloo group of one) its owner-shard insert and combined softmax give
    ``decode_attention`` over the inserted cache (the two-rank cases are in
    ``tests/test_torch_seqsharded.py``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    rng = np.random.default_rng(5)
    b, s, h, kv, hd = 2, 24, 4, 2, 16
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, 1, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    kn, vn = (rng.standard_normal((b, 1, kv, hd)).astype(np.float32) for _ in range(2))
    lens = np.array([5, 23], np.int32)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        kc, vc = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
        out, k2, v2 = decode_attention_seqsharded(
            torch.from_numpy(q), kc, vc, torch.from_numpy(lens), mesh,
            k_new=torch.from_numpy(kn), v_new=torch.from_numpy(vn))
    finally:
        dist.destroy_process_group()
    for i, n in enumerate(lens):
        k[i, n], v[i, n] = kn[i, 0], vn[i, 0]
    assert k2 is kc and v2 is vc
    np.testing.assert_array_equal(kc.numpy(), k)
    np.testing.assert_array_equal(vc.numpy(), v)
    want = decode_attention(*(torch.from_numpy(a) for a in (q, k, v, lens + 1)))
    np.testing.assert_allclose(f32(out), f32(want), rtol=1e-4, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 8, 3, 32), torch.zeros(1, 8, 3, 32))  # 4 % 3
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 4, 16))
    with pytest.raises(ValueError):
        flash_attention(q, q, q, sliding_window=-1)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, q_offset=-3)


# ---------------------------------------------------- g++ build of the step


@pytest.fixture(scope="module")
def host_fa(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    src = t_fa.SOURCE.parent / "host_step_test.cpp"
    out = tmp_path_factory.mktemp("host_fa") / "libflash_attn_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(INCLUDE_DIR),
                    "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for route in (lib.host_flash_attn_tc, lib.host_flash_attn_f32tc):
        route.argtypes = [vp] * 4 + [i64] * 3 + [ci] * 3 + [ctypes.c_float, ci, i64, i64, ci]
        route.restype = ci
    return lib


def host_attention(lib, q, k, v, causal, win, q_offset):
    """The emulated route of q's dtype (bfloat16: P split in two parts;
    float32: every operand in three) for torch inputs, in q's dtype."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qf, kf, vf = (t.float().contiguous().numpy() for t in (q, k, v))
    out = np.zeros(qf.shape, np.float32)
    scale = float(torch.tensor(hd**-0.5, dtype=q.dtype))
    bf16 = q.dtype == torch.bfloat16
    route = lib.host_flash_attn_tc if bf16 else lib.host_flash_attn_f32tc
    rc = route(qf.ctypes.data, kf.ctypes.data, vf.ctypes.data, out.ctypes.data, b, sq, skv, h,
               kvh, hd, scale, int(causal), win, q_offset, 1 if bf16 else 3)
    assert rc == 0
    return torch.from_numpy(out).to(q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,sq,skv,h,kv,hd,causal,win,qoff",
    [
        (2, 256, 256, 4, 2, 64, True, 0, 0),
        (1, 384, 384, 2, 2, 128, True, 128, 0),
        (2, 200, 200, 4, 4, 64, False, 0, 0),
        (1, 130, 130, 2, 1, 32, True, 0, 0),
        (1, 300, 300, 4, 4, 64, True, 10, 0),  # first visited tiles all masked
        (2, 60, 200, 4, 2, 64, True, 0, 140),
        (1, 150, 150, 2, 1, 128, False, 40, 0),
    ],
)
def test_step_header_matches_plain(host_fa, b, sq, skv, h, kv, hd, causal, win, qoff, dtype):
    (tq, tk, tv), _ = inputs(11, b, sq, skv, h, kv, hd, dtype)
    got = host_attention(host_fa, tq, tk, tv, causal, win, qoff)
    ref = blocked_attention_plain(tq, tk, tv, causal, win, qoff)
    np.testing.assert_allclose(f32(got), f32(ref), **TOL_BLOCKED[dtype])
