"""The port's checkpoint manager and runtime against the JAX package, on
the CPU (``repro_torch.checkpoint``, ``repro_torch.runtime``).

- The JAX test file's checkpoint cases on the port: round trip with a
  bfloat16 leaf and ``keep=2`` garbage collection, a corrupt newest
  checkpoint skipped and a ``.tmp`` directory never resumed from, an
  exact restart; a checkpoint whose leaf shapes changed is skipped too.
- The format: a nested state (dicts, a tuple, a bfloat16, a float32 and an
  int32 leaf) saved by each manager gives the same ``MANIFEST.json``
  (paths, shapes, dtypes, crc32) and ``arrays.npz`` entries, and each
  manager restores the other's, values equal bit for bit.
- ``plan_mesh`` equal to the JAX function over a grid of (devices,
  model_parallel, pods); ``ElasticMesh`` on a list of devices.
- ``StragglerMonitor``'s actions and weights equal to the JAX class's on
  seeded timing streams.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import ml_dtypes

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.runtime import StragglerMonitor as JStragglerMonitor
from repro.runtime import plan_mesh as j_plan_mesh

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLMData
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime import ElasticMesh, StragglerMonitor, plan_mesh

# ------------------------------------------------------------ the JAX file's cases


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {
        "a": torch.arange(10, dtype=torch.float32),
        "nested": {"b": torch.ones((3, 4), dtype=torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32),
    }
    for s in [10, 20, 30]:
        mgr.save(s, state)
    assert mgr.latest_step() == 30
    assert not os.path.exists(os.path.join(str(tmp_path), "step_000000010"))
    restored, step = mgr.restore(state)
    assert step == 30
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(10))
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert int(restored["step"]) == 7 and restored["step"].dtype == torch.int32


def test_checkpoint_skips_corrupt_and_tmp(tmp_path, capsys):
    mgr = CheckpointManager(str(tmp_path))
    state = {"w": torch.arange(5, dtype=torch.float32)}
    mgr.save(1, state)
    mgr.save(2, state)
    arrs = os.path.join(str(tmp_path), "step_000000002", "arrays.npz")
    with open(arrs, "r+b") as f:
        f.seek(200)
        f.write(b"\xde\xad\xbe\xef")
    restored, step = mgr.restore(state)
    assert step == 1  # fell back past the corrupt one
    assert "[ckpt] step 2 unusable" in capsys.readouterr().out
    os.makedirs(os.path.join(str(tmp_path), "step_000000099.tmp"))
    assert mgr.latest_step() == 2
    mgr.save(3, state)  # the next save removes the torn write
    assert not os.path.exists(os.path.join(str(tmp_path), "step_000000099.tmp"))


def test_checkpoint_skips_changed_shapes(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(4)})
    mgr.save(2, {"w": torch.zeros(5)})
    restored, step = mgr.restore({"w": torch.zeros(4)})
    assert step == 1 and restored["w"].shape == (4,)
    with pytest.raises(FileNotFoundError):
        mgr.restore({"w": torch.zeros(6)})


def test_restart_resumes_training_exactly(tmp_path):
    """Stop/restart produces the same state as uninterrupted training."""
    cfg = AdamWConfig(lr=0.05)
    data = SyntheticLMData(vocab_size=50, seq_len=8, global_batch=4)

    def loss_grads(params, step):
        x = torch.from_numpy(data.batch_at(step)["tokens"]).float().mean()
        return {"w": params["w"] - x}

    def run(steps, ckpt_at=None, resume_from=None):
        params = {"w": torch.zeros(4)}
        state = adamw_init(params, cfg)
        start = 0
        mgr = CheckpointManager(str(tmp_path / "rt"))
        if resume_from is not None:
            (params, state), start = mgr.restore((params, state))
        for t in range(start, steps):
            params, state = adamw_update(params, loss_grads(params, t), state, cfg)
            if ckpt_at is not None and t + 1 == ckpt_at:
                mgr.save(t + 1, (params, state))
        return params

    ref = run(20)
    run(10, ckpt_at=10)
    resumed = run(20, resume_from=True)
    assert torch.equal(ref["w"], resumed["w"])


# ------------------------------------------------------------ the format, both ways


def _state(rng):
    w = rng.normal(size=(3, 5)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    return w, b, (
        {"layers": {"wq": w, "bias": b.astype(ml_dtypes.bfloat16)}, "embed": w[0]},
        {"m": {"x": w * 2}, "step": np.int32(42)},
    )


def _as_torch(x):
    if isinstance(x, dict):
        return {k: _as_torch(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_as_torch(v) for v in x)
    if np.asarray(x).dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(np.asarray(x).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _as_jax(x):
    if isinstance(x, dict):
        return {k: _as_jax(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_as_jax(v) for v in x)
    return jnp.asarray(x)


def _bits(x):
    """A leaf's raw bytes and logical dtype name."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes(), "bfloat16"
        return x.numpy().tobytes(), str(x.numpy().dtype)
    a = np.asarray(x)
    return a.tobytes(), str(a.dtype)


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, tuple):
        return [v for e in x for v in _leaves(e)]
    return [x]


def test_both_managers_write_the_same_checkpoint_and_read_each_other(tmp_path):
    _, _, state = _state(np.random.default_rng(0))
    tstate, jstate = _as_torch(state), _as_jax(state)
    CheckpointManager(str(tmp_path / "port")).save(5, tstate)
    JCheckpointManager(str(tmp_path / "jax")).save(5, jstate)
    manifests = [json.load(open(tmp_path / d / "step_000000005" / "MANIFEST.json"))
                 for d in ("port", "jax")]
    assert manifests[0] == manifests[1]
    assert [leaf["path"] for leaf in manifests[0]["leaves"]] == [
        "[0]['embed']", "[0]['layers']['bias']", "[0]['layers']['wq']",
        "[1]['m']['x']", "[1]['step']"]
    assert manifests[0]["leaves"][1]["dtype"] == "bfloat16"
    with np.load(tmp_path / "port" / "step_000000005" / "arrays.npz") as p, \
            np.load(tmp_path / "jax" / "step_000000005" / "arrays.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for k in p.files:
            assert p[k].dtype == j[k].dtype and np.array_equal(p[k], j[k])
    # each restores the other's
    got, step = CheckpointManager(str(tmp_path / "jax")).restore(tstate)
    assert step == 5
    assert [_bits(x) for x in _leaves(got)] == [_bits(x) for x in _leaves(tstate)]
    assert got[1]["step"].dtype == torch.int32
    got, step = JCheckpointManager(str(tmp_path / "port")).restore(jstate)
    assert step == 5
    assert [_bits(x) for x in _leaves(got)] == [_bits(x) for x in _leaves(jstate)]


# ------------------------------------------------------------ elastic


def test_plan_mesh_equals_jax():
    for devices in (1, 2, 3, 7, 8, 16, 31, 480, 512):
        for mp in (1, 2, 4, 16):
            for pods in (1, 2, 4):
                try:
                    want = j_plan_mesh(devices, mp, pods)
                except ValueError:
                    with pytest.raises(ValueError):
                        plan_mesh(devices, mp, pods)
                    continue
                assert plan_mesh(devices, mp, pods) == want


def test_elastic_mesh_over_devices():
    devs = [torch.device("cuda", i) for i in range(8)]
    em = ElasticMesh(model_parallel=2, pods=2)
    mesh = em.build(devs)
    assert mesh.axis_names == ("pod", "data", "model")
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2}
    assert mesh.devices.shape == (2, 2, 2) and mesh.devices[1, 0, 1] == devs[5]
    assert em.data_shards == 4
    mesh = em.on_failure(dead=[{"id": 3}, torch.device("cuda", 6)])
    assert mesh.shape == {"pod": 2, "data": 1, "model": 2}
    assert 3 not in [d.index for d in mesh.devices.ravel()]
    em1 = ElasticMesh(model_parallel=1)
    mesh = em1.build([torch.device("cpu")])
    assert mesh.axis_names == ("data", "model") and em1.data_shards == 1
    assert em1.on_failure(dead=[9999]) is not None


# ------------------------------------------------------------ straggler


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_monitor_equals_jax(seed):
    rng = np.random.default_rng(seed)
    hosts = 6
    kw = dict(threshold=1.4, patience=3, rebalance_limit=1)
    port, ref = StragglerMonitor(**kw), JStragglerMonitor(**kw)
    slow = rng.random(hosts) < 0.4
    for _ in range(40):
        for h in range(hosts):
            t = float(rng.gamma(4.0, 0.25) * (2.5 if slow[h] else 1.0))
            port.record(h, t)
            ref.record(h, t)
        assert port.check() == ref.check()
        assert port.times == ref.times
    assert port.shard_weights(list(range(hosts))) == ref.shard_weights(list(range(hosts)))


def test_straggler_detect_and_escalate():
    mon = StragglerMonitor(threshold=1.5, patience=3, rebalance_limit=1)
    all_actions = []
    for _ in range(12):
        for h in range(4):
            mon.record(h, 1.0 if h != 2 else 3.0)
        all_actions += mon.check()
    kinds = [a for h, a in all_actions if h == 2]
    assert "rebalance" in kinds and "evict" in kinds
    w = mon.shard_weights([0, 1, 2, 3])
    assert w[2] < w[0]
