"""K6's chunk-parallel tensor-core route, emulated on the CPU, against the
plain versions and the JAX package.

``csrc/host_step_test.cpp::host_ssd_scan_tc`` is a g++ build of the step
header ``csrc/ssd_step.h`` (with the shared ``kernels/csrc/tc_frag.h``)
that runs the three passes of ``csrc/ssd_scan.cu`` warp by warp, its 32
lanes emulated on the host: the block-wide running sum, the swizzled
shared-memory tile images (float32 inputs in bf16 parts), ldmatrix from
the lanes' row addresses, each ``mma.sync`` as a loop over the PTX fragment
layout, and the header's fragment builders and bf16 splits.  The kernels
themselves run against the plain version on a card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances, those of ``chip_smoke.SSD_TOL``: y within ``rtol=atol=2e-4`` in
float32 (the JAX package's SSD tolerance, ``tests/test_ssm_moe_attn.py:44``)
and ``rtol=1e-2, atol=1e-3`` in bfloat16 (both versions compute in float32
from the same bfloat16 inputs and round once); the final state within
float32's ``2e-4`` on both routes.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.models.ssm import ssd_chunked as j_ssd_chunked

from repro_torch.kernels.build import INCLUDE_DIR
from repro_torch.kernels.ssd_scan import ssd_scan as t_ssd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain, ssd_naive, ssd_three_pass_plain

# the serial chunk step (ssd_serial_step.h), which host_step_test.cpp includes
SERIAL_DIR = Path(__file__).resolve().parent.parent / "tools" / "kernel_variants_csrc"

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=1e-2, atol=1e-3)
F32_PARTS = 3  # SSD_F32_PARTS, the float32 route's bf16 parts a side


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    src = t_ssd.SOURCE.parent / "host_step_test.cpp"
    out = tmp_path_factory.mktemp("host_ssd_tc") / "libssd_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(INCLUDE_DIR),
                    "-I", str(SERIAL_DIR), "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(out))
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    h.host_ssd_scan_tc.argtypes = [vp] * 8 + [i64, i64, ci, ci, ci, ci, ci, ci]
    h.host_ssd_scan_tc.restype = ci
    h.host_ssd_tiling.argtypes = [ci, ci, ci, ci, vp]
    return h


def inputs(seed, bsz, s, h, p, n, init=False, softplus_dt=False, cancelling=False):
    """Normal x, B, C; dt ~ U(0.1, 0.8) and a ~ -U(0.3, 1.5), or the model's
    init (dt = softplus(N(0, 1)), a = -1).  With ``cancelling``, positions in
    pairs: the second's B 1.05 times the first's, its x the first's negated,
    the same dt, and slow decay (a ~ -U(0.01, 0.05)), so each pair adds a
    small difference of large terms and one bf16 rounding of G, w B or S
    shows (the case K5's cancelling pairs make for P)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, s, h, p)).astype(np.float32)
    if softplus_dt:
        dt = np.log1p(np.exp(rng.normal(size=(bsz, s, h)))).astype(np.float32)
        a = -np.ones(h, np.float32)
    else:
        dt = rng.uniform(0.1, 0.8, (bsz, s, h)).astype(np.float32)
        a = -rng.uniform(0.3, 1.5, h).astype(np.float32)
    b = rng.normal(size=(bsz, s, n)).astype(np.float32)
    c = rng.normal(size=(bsz, s, n)).astype(np.float32)
    if cancelling:
        b[:, 1::2] = b[:, 0::2][:, : b[:, 1::2].shape[1]] * 1.05
        x[:, 1::2] = -x[:, 0::2][:, : x[:, 1::2].shape[1]]
        dt[:, 1::2] = dt[:, 0::2][:, : dt[:, 1::2].shape[1]]
        a = -rng.uniform(0.01, 0.05, h).astype(np.float32)
    st = rng.normal(size=(bsz, h, p, n)).astype(np.float32) if init else None
    return x, dt, a, b, c, st


def bf16_values(*arrs):
    return [torch.from_numpy(t).bfloat16().float().numpy() for t in arrs]


def emulated(lib, x, dt, a, b, c, st, chunk, parts, split=1):
    """The emulated kernels' (y, final state); parts 1 = bfloat16 inputs
    (x, b, c must hold bfloat16 values; y comes back rounded)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    y = np.full_like(x, np.nan)
    fin = np.full((bsz, h, p, n), np.nan, np.float32)
    rc = lib.host_ssd_scan_tc(x.ctypes.data, dt.ctypes.data, a.ctypes.data, b.ctypes.data,
                              c.ctypes.data, None if st is None else st.ctypes.data,
                              y.ctypes.data, fin.ctypes.data, bsz, s, h, p, n, chunk, parts, split)
    assert rc == 0
    return y, fin


def plain(x, dt, a, b, c, st, chunk, bf16):
    """ssd_chunked_plain on the same inputs, y in the route's dtype."""
    tx, tb, tc_ = (torch.from_numpy(t) for t in (x, b, c))
    if bf16:
        tx, tb, tc_ = tx.bfloat16(), tb.bfloat16(), tc_.bfloat16()
    y, fin = ssd_chunked_plain(tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc_, chunk,
                               None if st is None else torch.from_numpy(st))
    return y.float().numpy(), fin.numpy()


def close(got, ref, tol):
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **tol)


# (bsz, s, h, p, n, chunk, init): P 32 / 64, N 16 / 64 / 128, ragged S,
# chunks below 64 (padded to 16-row tiles), 64 and long ones
SHAPES = [
    (2, 50, 3, 32, 16, 16, False),
    (1, 100, 2, 32, 16, 48, True),  # chunk 48: tiles of 16 rows on the float32 route
    (2, 120, 2, 32, 64, 32, True),
    (1, 300, 2, 64, 64, 64, True),
    (1, 333, 2, 32, 128, 128, True),
    (1, 600, 2, 64, 128, 256, False),
    (1, 100, 2, 64, 16, 256, False),  # S < chunk
    (2, 700, 2, 64, 64, 256, True),  # zamba2's head and state widths, three chunks
    (1, 1100, 1, 32, 16, 512, True),  # query tiles of 32 (bf16) / 16 rows
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bsz,s,h,p,n,chunk,init", SHAPES)
def test_emulated_route_matches_plain_versions(lib, dtype, bsz, s, h, p, n, chunk, init):
    """y and the final state against ssd_chunked_plain (the wrapper's CPU
    path) and ssd_three_pass_plain (the same passes in plain PyTorch)."""
    bf16 = dtype == "bfloat16"
    x, dt, a, b, c, st = inputs(s + n, bsz, s, h, p, n, init)
    if bf16:
        x, b, c = bf16_values(x, b, c)
    y, fin = emulated(lib, x, dt, a, b, c, st, chunk, 1 if bf16 else F32_PARTS)
    ry, rfin = plain(x, dt, a, b, c, st, chunk, bf16)
    close(y, ry, BF16 if bf16 else F32)
    close(fin, rfin, F32)
    T = torch.from_numpy
    ty, tfin = ssd_three_pass_plain(T(x), T(dt), T(a), T(b), T(c), chunk,
                                    None if st is None else T(st))
    close(y, torch.from_numpy(ty.numpy()).bfloat16().float().numpy() if bf16 else ty.numpy(),
          BF16 if bf16 else F32)
    close(fin, tfin.numpy(), F32)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_emulated_route_matches_jax_ssd_chunked(lib, chunk):
    """The float32 route against the model's ssd_chunked at the chunks where
    its unmasked exponent stays finite."""
    x, dt, a, b, c, st = inputs(11, 2, 150, 3, 64, 64, init=True)
    y, fin = emulated(lib, x, dt, a, b, c, st, chunk, F32_PARTS)
    jy, jfin = j_ssd_chunked(*(jnp.asarray(t) for t in (x, dt, a, b, c)), chunk=chunk,
                             init_state=jnp.asarray(st))
    assert np.isfinite(np.asarray(jy)).all()
    close(y, np.asarray(jy), F32)
    close(fin, np.asarray(jfin), F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_route_matches_recurrence_at_chunk_256(lib, dtype):
    """zamba2's chunk 256 with the model's init dt, where ssd_chunked gives
    NaN: both routes against the sequential recurrence ssd_naive."""
    bf16 = dtype == "bfloat16"
    x, dt, a, b, c, _ = inputs(12, 1, 512, 2, 64, 64, softplus_dt=True)
    if bf16:
        x, b, c = bf16_values(x, b, c)
    y, fin = emulated(lib, x, dt, a, b, c, None, 256, 1 if bf16 else F32_PARTS)
    ny, nfin = ssd_naive(*(torch.from_numpy(t) for t in (x, dt, a, b, c)))
    ny = ny.numpy()
    close(y, torch.from_numpy(ny).bfloat16().float().numpy() if bf16 else ny,
          BF16 if bf16 else F32)
    close(fin, nfin.numpy(), F32)


@pytest.mark.parametrize("seed", [0, 1])
def test_cancelling_pairs_need_the_split(lib, seed):
    """On the bfloat16 route G, w B and S go in as bf16 hi + lo: with
    cancelling pairs the route holds both tolerances, and with lo dropped
    (one bf16 rounding) it misses both."""
    x, dt, a, b, c, st = inputs(seed, 1, 512, 2, 64, 64, init=True, cancelling=True)
    x, b, c = bf16_values(x, b, c)
    ry, rfin = plain(x, dt, a, b, c, st, 256, bf16=True)
    y, fin = emulated(lib, x, dt, a, b, c, st, 256, 1, split=1)
    close(y, ry, BF16)
    close(fin, rfin, F32)
    y0, fin0 = emulated(lib, x, dt, a, b, c, st, 256, 1, split=0)
    for got, ref, tol in ((y0, ry, BF16), (fin0, rfin, F32)):
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(got, ref, **tol)


@pytest.mark.parametrize("parts,holds", [(2, False), (3, True)])
def test_float32_route_needs_three_parts(lib, parts, holds):
    """Float32 x, B and C in two bf16 parts a side (hi hi + hi lo + lo hi,
    the products lose about 2^-16) miss float32's rtol 2e-4 at N = 128;
    three parts (six products) hold it."""
    x, dt, a, b, c, st = inputs(13, 1, 600, 2, 64, 128)
    ry, rfin = plain(x, dt, a, b, c, st, 256, bf16=False)
    y, fin = emulated(lib, x, dt, a, b, c, st, 256, parts)
    if holds:
        close(y, ry, F32)
        close(fin, rfin, F32)
    else:
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(y, ry, **F32)


@pytest.mark.parametrize("chunk,init", [(16, False), (64, True), (256, True)])
def test_three_pass_plain_matches_ssd_chunked_plain(chunk, init):
    x, dt, a, b, c, st = inputs(14, 2, 300, 3, 32, 16, init)
    T = torch.from_numpy
    st_t = None if st is None else T(st)
    y, fin = ssd_three_pass_plain(T(x), T(dt), T(a), T(b), T(c), chunk, st_t)
    ry, rfin = ssd_chunked_plain(T(x), T(dt), T(a), T(b), T(c), chunk, st_t)
    close(y.numpy(), ry.numpy(), F32)
    close(fin.numpy(), rfin.numpy(), F32)


def test_tiling_divides_the_chunk_and_fits_shared_memory(lib):
    """For every supported chunk, width and route: s-tiles and query tiles
    divide the padded chunk in whole 16-row mma tiles, a scan thread takes
    at most 8 positions, and both passes fit a block's shared memory."""
    out = (ctypes.c_int * 6)()
    for parts in (1, F32_PARTS):
        for chunk in list(range(1, 65)) + list(range(128, 1025, 64)):
            for p in (32, 64):
                for n in (16, 64, 128):
                    lib.host_ssd_tiling(chunk, parts, p, n, out)
                    lpad, stile, qr, per, smem_a, smem_c = out
                    assert lpad >= chunk and lpad % 16 == 0
                    assert lpad % stile == 0 and stile % 16 == 0 and stile <= 64
                    assert lpad % qr == 0 and qr % 16 == 0 and qr <= 64
                    assert per <= 8
                    assert max(smem_a, smem_c) <= 232448, (chunk, parts, p, n)
    lib.host_ssd_tiling(256, 1, 64, 64, out)
    # path F's shape: query tiles of 64 rows, and two blocks of pass C an SM
    assert (out[0], out[1], out[2]) == (256, 64, 64)
    assert 2 * (out[5] + 1024) <= 233472


@pytest.mark.parametrize("shift,copied", [(0, False), (2, True)])
def test_wrapper_reads_projection_slices_in_place(shift, copied):
    """x, B and C sliced from one in-projection (the model's layout) reach
    the kernel as they are, with their batch and position strides; slices
    off 16-byte alignment are copied first."""
    proj = torch.zeros((2, 30, shift + 4 * 32 + 2 * 16), dtype=torch.bfloat16)[..., shift:]
    x = proj[..., :128].reshape(2, 30, 4, 32)
    b = proj[..., 128:144]
    for t, dense in ((x, 2), (b, 1)):
        got = t_ssd._kernel_view(t, dense)
        assert (got.data_ptr() != t.data_ptr()) == copied
        assert got.data_ptr() % 16 == 0 and torch.equal(got, t)
    strides = t_ssd._outer_strides(t_ssd._kernel_view(x, 2))
    assert strides == ((30 * 160, 160) if not copied else (30 * 128, 128))
    one = torch.zeros((1, 5, 4, 32), dtype=torch.float32)
    assert t_ssd._outer_strides(one) == (0, 128)
