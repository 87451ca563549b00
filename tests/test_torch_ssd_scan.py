"""The port's K6 (the Mamba2 SSD chunk scan) against the JAX package, on
the CPU.

The plain chunked version (what the K6 wrapper runs on a CPU tensor), the
sequential recurrence ``ssd_naive`` and a g++ build of the CUDA step header
``csrc/ssd_step.h`` (through the test-only harness
``csrc/host_step_test.cpp``: the serial (chunk, head) step with the decay
masked before the exponent) are held against the model's ``ssd_chunked``
(chunks 16 and 32), the Pallas kernel ``ssd_scan`` in interpret mode and
the JAX naive recurrence.  At chunk 256 with the model's dt, the reference
``ssd_chunked`` gives NaN (its unmasked exponent overflows) while the port
agrees with the recurrence.  The Mamba2 block and its decode step are held
against the JAX package's too.  Inputs come from a numpy seed.  The kernel
itself runs against the plain version on a card in
``tests/test_torch_cuda.py``.

Tolerance: ``rtol=atol=2e-4`` in float32, the JAX package's SSD tolerance
(``tests/test_ssm_moe_attn.py:44``); ``2e-3`` against the Pallas kernel, as
``tests/test_kernels.py:219`` holds it; ``3e-3`` for the decode step, as
``tests/test_ssm_moe_attn.py:66``.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.kernels.ssd_scan.ref import ssd_naive as j_ssd_naive_bh
from repro.kernels.ssd_scan.ssd_scan import ssd_scan as j_ssd_scan_pallas
from repro.models.model import init_params as j_init_params
from repro.models.ssm import SSMParams as JSSMParams
from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro.models.ssm import ssm_block as j_ssm_block
from repro.models.ssm import ssm_decode_step as j_ssm_decode_step

from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ssd_scan as t_ssd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain, ssd_naive
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
from repro_torch.models.ssm import SSMParams, ssd_chunked, ssm_block, ssm_decode_step

TOL = dict(rtol=2e-4, atol=2e-4)


def inputs(seed, bsz, s, h, p, n, init=False, softplus_dt=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, s, h, p)).astype(np.float32)
    if softplus_dt:  # the model at init: dt = softplus(N(0, 1)), a = -exp(0)
        dt = np.log1p(np.exp(rng.normal(size=(bsz, s, h)))).astype(np.float32)
        a = -np.ones(h, np.float32)
    else:
        dt = rng.uniform(0.1, 0.8, (bsz, s, h)).astype(np.float32)
        a = -rng.uniform(0.3, 1.5, h).astype(np.float32)
    b = rng.normal(size=(bsz, s, n)).astype(np.float32)
    c = rng.normal(size=(bsz, s, n)).astype(np.float32)
    st = rng.normal(size=(bsz, h, p, n)).astype(np.float32) if init else None
    return x, dt, a, b, c, st


def tt(*arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def jj(*arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize(
    "bsz,s,h,p,n,init",
    [(2, 50, 3, 8, 4, False), (2, 120, 2, 32, 16, True), (1, 64, 4, 64, 64, True)],
)
def test_plain_matches_ssd_chunked(bsz, s, h, p, n, init, chunk):
    x, dt, a, b, c, st = inputs(0, bsz, s, h, p, n, init)
    before = ssd_scan.launches
    y, fin = ssd_scan(*tt(x, dt, a, b, c), chunk=chunk, init_state=tt(st)[0])
    assert ssd_scan.launches == before  # CPU tensors run the plain version
    jy, jfin = j_ssd_chunked(*jj(x, dt, a, b, c), chunk=chunk, init_state=jj(st)[0])
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), **TOL)
    # and the sequential recurrence, from the same initial state
    ny, nfin = ssd_naive(*tt(x, dt, a, b, c, st))
    np.testing.assert_allclose(y.numpy(), ny.numpy(), **TOL)
    np.testing.assert_allclose(fin.numpy(), nfin.numpy(), **TOL)


def test_naive_matches_jax_naive():
    x, dt, a, b, c, _ = inputs(1, 2, 40, 3, 8, 4)
    ny, _ = ssd_naive(*tt(x, dt, a, b, c))
    for hi in range(3):  # the JAX naive takes one head per row: (BH, S, P)
        ref = j_ssd_naive_bh(x[:, :, hi], dt[:, :, hi], np.full(2, a[hi]), b, c)
        np.testing.assert_allclose(ny[:, :, hi].numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [16, 32])
def test_plain_matches_pallas_interpret(chunk):
    bh, s, p, n = 3, 70, 32, 16
    x, dt, a, b, c, _ = inputs(2, bh, s, 1, p, n)
    y, _ = ssd_scan(*tt(x, dt, a, b, c), chunk=chunk)  # one head per batch row
    ref = j_ssd_scan_pallas(jnp.asarray(x[:, :, 0]), jnp.asarray(dt[:, :, 0]),
                            jnp.full((bh,), a[0]), jnp.asarray(b), jnp.asarray(c),
                            chunk=chunk, interpret=True)
    np.testing.assert_allclose(y[:, :, 0].numpy(), np.asarray(ref), rtol=2e-3, atol=2e-3)


def test_chunk_256_reference_overflows_port_matches_recurrence():
    """At zamba2's chunk 256 with dt = softplus(N(0, 1)) and a = -1,
    ssd_chunked's exp(cum_t - cum_s) for s > t overflows and its y holds
    NaN; the port masks before the exponent and equals the recurrence."""
    x, dt, a, b, c, _ = inputs(3, 1, 512, 2, 16, 16, softplus_dt=True)
    jy, _ = j_ssd_chunked(*jj(x, dt, a, b, c), chunk=256)
    assert np.isnan(np.asarray(jy)).any()
    y, fin = ssd_scan(*tt(x, dt, a, b, c), chunk=256)
    ny, nfin = ssd_naive(*tt(x, dt, a, b, c))
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), ny.numpy(), **TOL)
    np.testing.assert_allclose(fin.numpy(), nfin.numpy(), **TOL)
    # where the reference is finite (chunk 64 here) the port equals it
    jy64, jfin64 = j_ssd_chunked(*jj(x, dt, a, b, c), chunk=64)
    y64, fin64 = ssd_chunked_plain(*tt(x, dt, a, b, c), chunk=64)
    assert np.isfinite(np.asarray(jy64)).all()
    np.testing.assert_allclose(y64.numpy(), np.asarray(jy64), **TOL)
    np.testing.assert_allclose(fin64.numpy(), np.asarray(jfin64), **TOL)


def test_bfloat16_output_dtype_and_padding():
    x, dt, a, b, c, _ = inputs(4, 1, 37, 2, 32, 16)
    xb, bb, cb = (torch.from_numpy(t).bfloat16() for t in (x, b, c))
    y, fin = ssd_scan(xb, torch.from_numpy(dt), torch.from_numpy(a), bb, cb, chunk=16)
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32 and y.shape == xb.shape
    ref, rfin = ssd_naive(xb, torch.from_numpy(dt), torch.from_numpy(a), bb, cb)
    np.testing.assert_allclose(y.float().numpy(), ref.float().numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(fin.numpy(), rfin.numpy(), **TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, dt, a, b, c, _ = tt(*inputs(5, 1, 20, 2, 8, 4)[:5], None)
    with pytest.raises(TypeError):
        ssd_scan(x, dt.double(), a, b, c)
    with pytest.raises(TypeError):
        ssd_scan(x.bfloat16(), dt, a, b, c)  # b, c must share x's dtype
    with pytest.raises(ValueError):
        ssd_scan(x, dt[:, :10], a, b, c)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a, b, c, init_state=torch.zeros(1, 2, 8, 5))
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a, b, c, chunk=0)


# ---------------------------------------------------- the Mamba2 block


@pytest.fixture(scope="module")
def mamba_layer():
    cfg = j_get_config("mamba2_780m").reduced()
    params = jax.tree.map(np.asarray, j_init_params(cfg, jax.random.PRNGKey(1))["blocks"]["ssm"])
    rng = np.random.default_rng(9)
    layer = {k: params[k][0] for k in JSSMParams._fields}
    # non-trivial decay rates, skips and biases (the init has a = -1, D = 1, bias 0)
    h = layer["a_log"].shape[0]
    layer["a_log"] = np.log(rng.uniform(0.5, 1.5, h)).astype(np.float32)
    layer["d_skip"] = rng.uniform(0.5, 1.5, h).astype(np.float32)
    layer["dt_bias"] = (0.1 * rng.normal(size=h)).astype(np.float32)
    return cfg, layer


def test_ssm_block_and_decode_match_jax(mamba_layer):
    jcfg, layer = mamba_layer
    tcfg = get_config("mamba2_780m").reduced()
    jp = JSSMParams(**{k: jnp.asarray(v) for k, v in layer.items()})
    tp = SSMParams(**{k: torch.from_numpy(np.array(v)) for k, v in layer.items()})
    rng = np.random.default_rng(2)
    T, B = 40, 2
    x = (rng.normal(size=(B, T, jcfg.d_model)) * 0.3).astype(np.float32)
    jy, jst = j_ssm_block(jp, jnp.asarray(x), jcfg)
    y, st = ssm_block(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)
    # decode steps from zero, against the JAX decode step and the block
    d_inner = tcfg.ssm_expand * tcfg.d_model
    h = d_inner // tcfg.ssm_head_dim
    jstate = jnp.zeros((B, h, tcfg.ssm_head_dim, tcfg.ssm_state), jnp.float32)
    tstate = torch.zeros((B, h, tcfg.ssm_head_dim, tcfg.ssm_state))
    for t in range(12):
        jyt, jstate = j_ssm_decode_step(jp, jnp.asarray(x[:, t:t + 1]), jstate, jcfg)
        yt, tstate = ssm_decode_step(tp, torch.from_numpy(x[:, t:t + 1]), tstate, tcfg)
        np.testing.assert_allclose(yt.numpy(), np.asarray(jyt), **TOL)
        np.testing.assert_allclose(yt.numpy(), y[:, t:t + 1].numpy(), rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), **TOL)


def test_ssd_chunked_init_state_continues_a_split_sequence():
    x, dt, a, b, c, _ = inputs(6, 2, 80, 2, 8, 4)
    y, fin = ssd_chunked(*tt(x, dt, a, b, c), chunk=16)
    y1, s1 = ssd_chunked(*tt(x[:, :48], dt[:, :48], a, b[:, :48], c[:, :48]), chunk=16)
    y2, s2 = ssd_chunked(*tt(x[:, 48:], dt[:, 48:], a, b[:, 48:], c[:, 48:]), chunk=16,
                         init_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), **TOL)
    np.testing.assert_allclose(s2.numpy(), fin.numpy(), **TOL)


# ---------------------------------------------------- g++ build of the step


@pytest.fixture(scope="module")
def host_ssd(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    src = t_ssd.SOURCE.parent / "host_step_test.cpp"
    out = tmp_path_factory.mktemp("host_ssd") / "libssd_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.host_ssd_scan.argtypes = [vp] * 7 + [i64, i64, ci, ci, ci, ci]
    lib.host_ssd_scan.restype = ci
    return lib


@pytest.mark.parametrize(
    "bsz,s,h,p,n,chunk,init,softplus_dt",
    [
        (2, 50, 3, 32, 16, 16, False, False),
        (2, 120, 2, 32, 64, 32, True, False),
        (1, 200, 2, 64, 128, 64, True, False),
        (1, 300, 2, 16, 16, 256, False, True),  # where ssd_chunked overflows
        (1, 100, 1, 8, 4, 256, True, False),  # S < chunk
    ],
)
def test_step_header_matches_plain(host_ssd, bsz, s, h, p, n, chunk, init, softplus_dt):
    x, dt, a, b, c, st = inputs(7, bsz, s, h, p, n, init, softplus_dt)
    y = np.zeros_like(x)
    state = np.zeros((bsz, h, p, n), np.float32) if st is None else st.copy()
    rc = host_ssd.host_ssd_scan(x.ctypes.data, dt.ctypes.data, a.ctypes.data, b.ctypes.data,
                                c.ctypes.data, y.ctypes.data, state.ctypes.data,
                                bsz, s, h, p, n, chunk)
    assert rc == 0
    ref, rfin = ssd_chunked_plain(*tt(x, dt, a, b, c), chunk=chunk, init_state=tt(st)[0])
    np.testing.assert_allclose(y, ref.numpy(), **TOL)
    np.testing.assert_allclose(state, rfin.numpy(), **TOL)
