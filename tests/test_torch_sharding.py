"""The port's sharding plan (``repro_torch.models.sharding``) against the
JAX package's (``repro.models.sharding``), leaf for leaf, for every arch on
both production meshes, and the local shard shapes it gives on a fake
(16, 16) device mesh.

The JAX rules read only a mesh's ``axis_names`` and ``shape``, so they take
a ``jax.sharding.AbstractMesh``: no 512 devices are needed.  The JAX leaf
shapes come from ``repro.launch.specs`` (``eval_shape``, no allocation),
the port's from ``meta`` tensors.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.models import sharding as j_sharding  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models.sharding import leaf_path  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def _jax_param_specs(arch, mesh):
    cfg = j_get_config(arch)
    flat, _ = jax.tree_util.tree_flatten_with_path(j_specs.params_spec(cfg))
    out = {}
    for path, leaf in flat:
        spath = "/".join(p.key if hasattr(p, "key") else str(p) for p in path)
        out[spath] = tuple(j_sharding.param_spec(cfg, mesh, spath, leaf.shape))
    return out


def test_the_port_has_the_jax_archs():
    assert list(ARCH_IDS) == list(J_ARCH_IDS)
    assert set(SHAPES) == set(J_SHAPES)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_use_fsdp_agrees(arch):
    assert sharding._use_fsdp(get_config(arch)) == j_sharding._use_fsdp(j_get_config(arch))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_plan_equals_the_jax_plan(arch, mesh_name):
    """Every port parameter's spec is the JAX spec of the leaf it maps to
    (``convert._leaf``), the stacked layer dim dropped; every JAX leaf is
    reached."""
    mesh = _mesh(mesh_name)
    cfg = get_config(arch)
    jspecs = _jax_param_specs(arch, mesh)
    model = specs.params_spec(cfg)
    plan = sharding.params_shardings(cfg, mesh, model)
    reached = set()
    for name, spec in plan.items():
        path, layer = leaf_path(name)
        want = jspecs[path]
        assert spec == (want[1:] if layer else want), (name, spec, want)
        reached.add(path)
    assert reached == set(jspecs)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_plans_equal_the_jax_plans(arch, mesh_name):
    mesh = _mesh(mesh_name)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for sname in SHAPES:
        shape, jshape = SHAPES[sname], J_SHAPES[sname]
        if shape.mode != "decode":
            got = sharding.batch_shardings(cfg, mesh, specs.batch_spec(cfg, shape))
            want = j_sharding.batch_shardings(jcfg, mesh, j_specs.batch_spec(jcfg, jshape))
            assert got == {k: tuple(v.spec) for k, v in want.items()}, (arch, sname)
            continue
        cspec, jcspec = specs.cache_spec(cfg, shape), j_specs.cache_spec(jcfg, jshape)
        assert {k: tuple(v.shape) for k, v in cspec.items()} == \
            {k: tuple(v.shape) for k, v in jcspec.items()}
        for seq in (False, True):
            got = sharding.cache_shardings(cfg, mesh, cspec, seq_sharded=seq)
            want = j_sharding.cache_shardings(jcfg, mesh, jcspec, seq_sharded=seq)
            assert got == {k: tuple(v.spec) for k, v in want.items()}, (arch, sname, seq)


def test_resolve_spec_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import fake_process_group, make_production_mesh

    with fake_process_group(512):
        mesh = make_production_mesh(multi_pod=True)
        spec = sharding.resolve_spec(mesh, ("batch", None, "model", "nope"))
        assert spec == (("pod", "data"), None, "model", None)
        assert sharding.placements(spec, mesh) == [Shard(0), Shard(0), Shard(2)]
        assert sharding.placements((None, "data"), mesh) == [Replicate(), Shard(1), Replicate()]


def test_shard_hint_is_a_no_op_off_a_mesh():
    x = torch.ones(4, 3)
    assert sharding.shard_hint(x, "batch", None) is x


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_local_shard_shapes_follow_the_plan(arch):
    """On a fake (16, 16) mesh (rank 0 of 256), every parameter's local
    shard is its shape with each split dim divided by its axes' sizes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import fake_process_group, make_production_mesh

    cfg = get_config(arch)
    with fake_process_group(256):
        mesh = make_production_mesh()
        sizes = sharding.mesh_axes(mesh)
        model = specs.params_spec(cfg)
        plan = sharding.params_shardings(cfg, mesh, model)
        with FakeTensorMode():
            fake = {k: torch.empty(p.shape, dtype=p.dtype) for k, p in model.named_parameters()}
            dist = sharding.distribute(fake, plan, mesh)
        for name, d in dist.items():
            want = []
            for n, entry in zip(fake[name].shape, plan[name]):
                for axis in (entry,) if isinstance(entry, str) else (entry or ()):
                    n //= sizes[axis]
                want.append(n)
            assert tuple(d.to_local().shape) == tuple(want), (name, plan[name])
            assert tuple(d.shape) == tuple(fake[name].shape)
