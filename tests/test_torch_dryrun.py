"""The port's dry run (``repro_torch.launch.dryrun``) on the dense and
vlm families' reduced configs, in each mode, on a fake (2, 2) device
mesh: one rank's step of the cell traced with its inputs laid out by the
sharding plan.  Every cell must come out ``status: "ok"`` with positive
FLOPs and bytes.  The per-rank argument bytes of the dense training cell,
and of the hybrid's decode cells, must equal the JAX package's
``compiled.memory_analysis()`` of the same cell on a 4-device CPU mesh
(one subprocess with ``--xla_force_host_platform_device_count=4``).

The moe, ssm and encdec cells are in
``tests/test_torch_dryrun_families.py``; the hybrid's, with the layer
probe, the collective counts and the roofline, in
``tests/test_torch_roofline.py`` (the files share the trace's start-up
cost, DTensor's first plans for a layout, evenly).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.dryrun import run_cell  # noqa: E402

FAMILIES = {"dense": "smollm_360m", "moe": "mixtral_8x22b", "ssm": "mamba2_780m",
            "hybrid": "zamba2_1p2b", "encdec": "whisper_tiny", "vlm": "qwen2_vl_7b"}
MODES = ("train", "prefill", "decode")
HERE = ("dense", "vlm")


def tiny_cell(arch, mode, tmp_path, name="tiny"):
    cfg = get_config(arch).reduced()
    assert cfg.family in FAMILIES and FAMILIES[cfg.family] == arch
    shape = ShapeConfig(name, 32, 2, mode)
    return run_cell(arch, f"{name}_{mode}", False, str(tmp_path), cfg=cfg, shape=shape,
                    mesh_shape=(2, 2))


def check_cell(rec, mode):
    assert rec["status"] == "ok", rec.get("error")
    assert rec["devices"] == 4 and rec["mesh"] == "2x2" and rec["mode"] == mode
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0 and rec["trace_s"] > 0
    mem = rec["memory"]
    assert min(mem["argument_size_in_bytes"], mem["output_size_in_bytes"],
               mem["temp_size_in_bytes"]) > 0
    coll = rec["collectives"]
    assert coll["total_bytes"] == sum(v["bytes"] for v in coll.values() if isinstance(v, dict))
    if mode == "train":  # the gradient all-reduce over data, by DTensor
        assert coll["all-reduce"]["count"] > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", HERE)
def test_reduced_cell_traces_on_a_fake_2x2_mesh(family, mode, tmp_path):
    check_cell(tiny_cell(FAMILIES[family], mode, tmp_path), mode)


JAX_MEMORY = """
import sys
import jax
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.steps import cell_step_and_specs
mesh = jax.make_mesh((2, 2), ("data", "model"))
for arch, name, mode in [a.split(":") for a in sys.argv[1:]]:
    cfg = get_config(arch).reduced()
    step, ins, shs = cell_step_and_specs(cfg, ShapeConfig(name, 32, 2 if name == "tiny" else 1,
                                                          mode), mesh)
    with mesh:
        m = jax.jit(step, in_shardings=shs).lower(*ins).compile().memory_analysis()
    print(arch, name, mode, m.argument_size_in_bytes)
"""
MEMORY_CELLS = [("smollm_360m", "tiny", "train"), ("zamba2_1p2b", "tiny", "decode"),
                ("zamba2_1p2b", "long_500k", "decode")]


def test_argument_bytes_equal_jax_memory_analysis(tmp_path):
    """The dense training cell, the hybrid decode cell and the hybrid cell
    named ``long_500k`` (batch 1, so its cache is split by sequence over
    ``data``): the rank's argument bytes equal XLA's."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    jax_run = subprocess.Popen([sys.executable, "-c", JAX_MEMORY]
                               + [":".join(c) for c in MEMORY_CELLS],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    got = {}
    for arch, name, mode in MEMORY_CELLS:
        cfg = get_config(arch).reduced()
        shape = ShapeConfig(name, 32, 2 if name == "tiny" else 1, mode)
        rec = run_cell(arch, f"{name}_{mode}", False, str(tmp_path), cfg=cfg, shape=shape,
                       mesh_shape=(2, 2))
        assert rec["status"] == "ok", rec.get("error")
        got[(arch, name, mode)] = rec["memory"]["argument_size_in_bytes"]
    out, err = jax_run.communicate(timeout=240)
    assert jax_run.returncode == 0, err.decode()[-2000:]
    want = {tuple(ln.split()[:3]): int(ln.split()[3]) for ln in out.decode().splitlines()}
    assert got == want


def test_step_counter_counts_a_rank_s_product_exactly():
    """A (64, 32) @ (32, 16) float32 product on a fake (2, 2) mesh, rows
    split over ``data``, the weight's columns over ``model``: each call
    counts the rank's own (32, 32) @ (32, 8) product, its FLOPs and the
    bytes of its local inputs and output, and no collective.  The first
    call also runs DTensor's shape inference (on whole-shaped fake
    tensors), which must not be counted: both calls count the same."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.dryrun import StepCounter, _dtensor_bookkeeping
    from repro_torch.launch.mesh import fake_process_group

    counts = []
    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        with FakeTensorMode(allow_non_fake_inputs=True), _dtensor_bookkeeping():
            x = distribute_tensor(torch.empty(64, 32), mesh, [Shard(0), Replicate()],
                                  src_data_rank=None)
            w = distribute_tensor(torch.empty(32, 16), mesh, [Replicate(), Shard(1)],
                                  src_data_rank=None)
            for _ in range(2):
                with StepCounter(known=(x, w)) as c:
                    y = x @ w
                counts.append((c.flops, c.op_bytes, len(c.calls)))
    assert y.to_local().shape == (32, 8)
    assert counts == [(2 * 32 * 32 * 8, 4 * (32 * 32 + 32 * 8 + 32 * 8), 0)] * 2
