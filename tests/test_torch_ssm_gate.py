"""The Mamba2 block's gate (``kernels/ssm_gate``: the D skip, the silu(z)
gate and the gated RMSNorm) on the CPU.

A g++ build of the kernel's row step (``csrc/ssm_gate_step.h``, through the
test-only harness ``csrc/host_step_test.cpp``, which runs every position as
a block of the kernel does: its units a thread, its warp butterflies, its
warps' sums in order) is held to the plain float32 chain
(``ssm_gate_plain``) at d_inner 256 and 4,096 over several head counts,
with x and z read in place from a projection-shaped tensor, on rows of
ordinary, large, tiny and zero values: within float32's reduction-order
tolerance on float32 data, within one bfloat16 step of every element on
bfloat16 data.  ``ssm_block`` picks the kernel only for CUDA tensors that
are no DTensor and that autograd does not record (fake CUDA tensors stand
in for the card), and its CPU output is the plain chain's, bit for bit; the
wrapper refuses what the kernel does not take.  The kernel itself runs
against the plain chain on a card in ``tests/test_torch_cuda.py``.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import DTensor, Shard  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.build import INCLUDE_DIR  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain  # noqa: E402
from repro_torch.kernels.ssm_gate import ssm_gate as g_mod  # noqa: E402
from repro_torch.kernels.ssm_gate.ssm_gate import ssm_gate, ssm_gate_plain  # noqa: E402
from repro_torch.launch.mesh import fake_process_group  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

N_STATE = 16  # the projection's B and C widths, between z and dt
ROW_SCALES = (1.0, 3e4, 1e-4, 0.0, 1e-19)  # ordinary, large, tiny, zero, eps-dominated


def projection(seed, bsz, s, h, p, dtype=np.float32):
    """``(y (B, S, H, P), zxbcdt (B, S, 2 d_inner + 2 N + H), d (H,), w
    (d_inner,))`` in float32; position ``s`` of every batch row scaled by
    ``ROW_SCALES[s % 5]``; with ``dtype`` bfloat16 every value is one."""
    rng = np.random.default_rng(seed)
    d_inner = h * p
    y = rng.normal(size=(bsz, s, h, p)).astype(np.float32)
    zx = rng.normal(size=(bsz, s, 2 * d_inner + 2 * N_STATE + h)).astype(np.float32)
    zx[..., :d_inner] *= 2.0
    zx[..., d_inner:2 * d_inner] *= 3.0  # z: silu's tails on both sides
    scale = np.array([ROW_SCALES[i % len(ROW_SCALES)] for i in range(s)], np.float32)
    y *= scale[None, :, None, None]
    zx *= np.where(scale > 0, np.sqrt(scale), 0)[None, :, None].astype(np.float32)
    d = rng.uniform(0.5, 1.5, h).astype(np.float32)
    w = rng.uniform(0.5, 1.5, d_inner).astype(np.float32)
    if dtype == "bfloat16":
        y, zx, d, w = (torch.from_numpy(t).bfloat16().float().numpy() for t in (y, zx, d, w))
    return y, zx, d, w


def views(y, zx, d, w, h, p, dtype=torch.float32):
    """The torch tensors the block hands the gate: xh and z views of zxbcdt."""
    d_inner = h * p
    zxt = torch.from_numpy(zx).to(dtype)
    xh = zxt[..., :d_inner].reshape(*zx.shape[:2], h, p)
    z = zxt[..., d_inner:2 * d_inner]
    return torch.from_numpy(y).to(dtype), xh, z, torch.from_numpy(d).to(dtype), \
        torch.from_numpy(w).to(dtype)


def bf16_step(ref: torch.Tensor) -> torch.Tensor:
    """One bfloat16 step at each element of ``ref`` (8 significant bits)."""
    exp = torch.frexp(ref.float().abs()).exponent
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exp - 8)


# ---------------------------------------------------- g++ build of the step


@pytest.fixture(scope="module")
def host_gate(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    src = g_mod.SOURCE.parent / "host_step_test.cpp"
    out = tmp_path_factory.mktemp("host_gate") / "libssm_gate_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-I",
                    str(INCLUDE_DIR), "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.host_ssm_gate.argtypes = [vp] * 6 + [i64] * 8 + [ci] * 3
    lib.host_ssm_gate.restype = ci
    return lib


def run_host(lib, y, zx, d, w, h, p, unit):
    bsz, s = y.shape[:2]
    d_inner = h * p
    out = np.zeros((bsz, s, d_inner), np.float32)
    item = zx.itemsize
    rc = lib.host_ssm_gate(y.ctypes.data, zx.ctypes.data, zx.ctypes.data + d_inner * item,
                           d.ctypes.data, w.ctypes.data, out.ctypes.data,
                           *(st // item for st in y.strides[:2]),
                           *(st // item for st in zx.strides[:2]),
                           *(st // item for st in zx.strides[:2]), bsz, s, d_inner, p, unit)
    assert rc == 0
    return out


@pytest.mark.parametrize("h,p", [(8, 32), (4, 64), (64, 64), (128, 32)])
def test_step_header_matches_plain_float32(host_gate, h, p):
    y, zx, d, w = projection(h * p + 1, 2, 5, h, p)
    got = run_host(host_gate, y, zx, d, w, h, p, unit=4)
    ref = ssm_gate_plain(*views(y, zx, d, w, h, p)).numpy()
    # every element's own arithmetic is the plain chain's; the row's mean
    # of squares is summed in another order, and exp may differ by an ulp
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=0)  # ~3 ulps seen
    assert not got[:, 3].any()  # the zero rows


@pytest.mark.parametrize("h,p", [(8, 32), (4, 64), (64, 64), (128, 32)])
def test_step_header_matches_plain_bfloat16(host_gate, h, p):
    y, zx, d, w = projection(h * p + 2, 2, 5, h, p, dtype="bfloat16")
    got = torch.from_numpy(run_host(host_gate, y, zx, d, w, h, p, unit=8))
    ref = ssm_gate_plain(*views(y, zx, d, w, h, p, torch.bfloat16))
    assert torch.equal(got, got.bfloat16().float())  # rounded to bfloat16 once
    assert bool(((got - ref.float()).abs() <= bf16_step(ref)).all())
    assert float((got != ref.float()).float().mean()) < 0.01


# ---------------------------------------------------- routing in the block


def cpu_block_inputs(arch="zamba2_1p2b"):
    cfg = get_config(arch).reduced()
    d_inner = cfg.ssm_expand * cfg.d_model
    h = d_inner // cfg.ssm_head_dim
    rng = np.random.default_rng(4)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    params = ssm.SSMParams(
        w_in=0.1 * t(cfg.d_model, 2 * d_inner + 2 * cfg.ssm_state + h),
        a_log=torch.log(torch.from_numpy(rng.uniform(0.5, 1.5, h).astype(np.float32))),
        d_skip=1 + 0.3 * t(h), dt_bias=0.1 * t(h), norm=1 + 0.1 * t(d_inner),
        w_out=0.1 * t(d_inner, cfg.d_model))
    return cfg, params, 0.5 * t(2, 24, cfg.d_model)


def old_block(params, x, cfg):
    """``ssm_block`` as it was before the gate had a kernel."""
    d_inner = cfg.ssm_expand * cfg.d_model
    h = d_inner // cfg.ssm_head_dim
    zxbcdt = x @ params.w_in.to(x.dtype)
    xi, z, b, c, dt = torch.split(zxbcdt, [d_inner, d_inner, cfg.ssm_state, cfg.ssm_state, h],
                                  dim=-1)
    dt = torch.nn.functional.softplus(dt.float() + params.dt_bias)
    a = -torch.exp(params.a_log.float())
    xh = xi.reshape(*xi.shape[:-1], h, cfg.ssm_head_dim)
    y, _ = ssd_chunked_plain(xh, dt, a, b, c, cfg.ssm_chunk)
    y = y + xh.float() * params.d_skip[None, None, :, None]
    y = y.reshape(xi.shape) * torch.nn.functional.silu(z.float())
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + 1e-6)) * params.norm
    return y.to(x.dtype) @ params.w_out.to(x.dtype)


@pytest.fixture
def spy(monkeypatch):
    """The block's two routes recorded in order: ``ssm.ssm_gate`` (the
    kernel's wrapper) and ``ssm.ssm_gate_plain``, each still giving the
    plain version's output (on fake CUDA tensors an empty one)."""
    calls = []

    def route(name):
        def fn(*args):
            calls.append(name)
            if args[0].is_cuda:  # a fake tensor: shapes only
                return torch.empty(args[2].shape, dtype=args[1].dtype, device=args[2].device)
            return ssm_gate_plain(*args)
        return fn

    monkeypatch.setattr(ssm, "ssm_gate", route("kernel"))
    monkeypatch.setattr(ssm, "ssm_gate_plain", route("plain"))
    return calls


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "mamba2_780m"])
def test_cpu_block_takes_the_plain_ops_bit_for_bit(spy, arch):
    cfg, params, x = cpu_block_inputs(arch)
    y, _ = ssm.ssm_block(params, x, cfg)
    assert spy == ["plain"]
    assert torch.equal(y, old_block(params, x, cfg))


def fake_cuda(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="cuda")


def stub_scan(xh, dt, a, b, c, chunk, init_state):
    """A scan's shapes and dtypes (the routing test's stand-in)."""
    return xh * 1, xh.new_empty((*xh.shape[:1], *xh.shape[2:], b.shape[-1]), dtype=torch.float32)


@pytest.mark.parametrize("params_grad", [False, True])
def test_cuda_block_takes_the_kernel(spy, params_grad):
    """On (fake) CUDA tensors the serving block calls the kernel's wrapper,
    parameters that require grad included (under ``torch.no_grad``, as
    ``forward`` runs)."""
    cfg, params, x = cpu_block_inputs()
    with FakeTensorMode(), torch.no_grad():
        p = ssm.SSMParams(*(fake_cuda(t).requires_grad_(params_grad) for t in params))
        y, _ = ssm.ssm_block(p, fake_cuda(x), cfg, scan=stub_scan)
    assert y.shape == x.shape and y.is_cuda
    assert spy == ["kernel"]


def test_route_refuses_what_autograd_records_dtensors_and_cpu_tensors():
    """The kernel's route: CUDA tensors, none a DTensor, none recorded by
    autograd (the training forward, whose inputs require grad)."""
    with fake_process_group(2):
        mesh = DeviceMesh("cuda", [0, 1])
        with FakeTensorMode():
            t = torch.empty(2, 4, 8, device="cuda")
            w = torch.empty(8, device="cuda").requires_grad_(True)
            assert ssm._fused_gate(t, t)
            assert not ssm._fused_gate(t, w)
            with torch.no_grad():
                assert ssm._fused_gate(t, w)
            on_mesh = DTensor.from_local(t, mesh, [Shard(2)])
            assert on_mesh.is_cuda and not ssm._fused_gate(on_mesh, t)
    assert not ssm._fused_gate(torch.zeros(2, 4, 8))


def test_training_block_takes_the_plain_ops(spy):
    """With inputs that require grad, the block runs the plain ops, which
    autograd follows."""
    cfg, params, x = cpu_block_inputs()
    params = ssm.SSMParams(*(t.requires_grad_(True) for t in params))
    y, _ = ssm.ssm_block(params, x, cfg, scan=ssd_chunked_plain)
    y.sum().backward()
    assert spy == ["plain"] and params.norm.grad is not None


def test_decode_step_keeps_its_own_gate(spy):
    cfg, params, x = cpu_block_inputs()
    d_inner = cfg.ssm_expand * cfg.d_model
    h = d_inner // cfg.ssm_head_dim
    state = torch.zeros(2, h, cfg.ssm_head_dim, cfg.ssm_state)
    y, _ = ssm.ssm_decode_step(params, x[:, :1], state, cfg)
    assert spy == [] and y.shape == (2, 1, cfg.d_model)


# ---------------------------------------------------- the wrapper's checks


def wrapper_inputs(h=8, p=32, dtype=torch.float32, width_extra=0):
    y, zx, d, w = projection(3, 2, 5, h, p)
    zx = np.concatenate([zx, np.zeros((*zx.shape[:2], width_extra), np.float32)], -1)
    return views(y, zx, d, w, h, p, dtype)


def test_wrapper_on_cpu_runs_the_plain_version():
    args = wrapper_inputs(dtype=torch.bfloat16)
    out = ssm_gate(*args)
    assert out.dtype == torch.bfloat16 and out.shape == args[2].shape
    assert torch.equal(out, ssm_gate_plain(*args))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    y, xh, z, d, w = wrapper_inputs()
    with pytest.raises(TypeError):
        ssm_gate(y.double(), xh.double(), z.double(), d, w)
    with pytest.raises(TypeError):
        ssm_gate(y.bfloat16(), xh, z, d, w)  # y, xh and z share one dtype
    with pytest.raises(TypeError):
        ssm_gate(y, xh, z, d.bfloat16(), w)  # d_skip and norm share one dtype
    with pytest.raises(ValueError):
        ssm_gate(y, xh, z[..., :-4], d, w)  # z does not fit y
    with pytest.raises(ValueError):
        ssm_gate(y, xh, z, d[:-1], w)
    with pytest.raises(ValueError):  # P of 4 bfloat16 is half a 16-byte unit
        ssm_gate(*wrapper_inputs(h=32, p=4, dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # more than 4 units for each of 256 threads
        ssm_gate(*wrapper_inputs(h=130, p=64, dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # a position stride of 1 + a whole number of units
        ssm_gate(*wrapper_inputs(width_extra=1))
    zx = torch.from_numpy(projection(3, 2, 5, 8, 32)[1])
    with pytest.raises(ValueError):  # x starting 4 bytes past a 16-byte boundary
        ssm_gate(y, zx[..., 1:1 + 256].reshape(xh.shape), z, d, w)
    with pytest.raises(ValueError):  # channels not dense
        ssm_gate(y.transpose(2, 3).contiguous().transpose(2, 3), xh, z, d, w)


def test_shapes_of_the_zoo_fit_the_kernel():
    """Every SSM configuration's gate (its projection views included) is
    one the kernel takes, in float32 and bfloat16."""
    for arch in ("zamba2_1p2b", "mamba2_780m"):
        for cfg in (get_config(arch), get_config(arch).reduced()):
            h = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
            d_inner = h * cfg.ssm_head_dim
            for dtype in g_mod.DTYPES:
                zx = torch.zeros(2, 3, 2 * d_inner + 2 * cfg.ssm_state + h, dtype=dtype)
                g_mod._check(torch.zeros(2, 3, h, cfg.ssm_head_dim, dtype=dtype),
                             zx[..., :d_inner].reshape(2, 3, h, cfg.ssm_head_dim),
                             zx[..., d_inner:2 * d_inner], torch.zeros(h, dtype=dtype),
                             torch.zeros(d_inner, dtype=dtype))
