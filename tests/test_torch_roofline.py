"""The dry run's accounting against the JAX package's: ``collective_bytes``
on HLO text (``tests/test_dryrun_artifacts.py``'s), ``comm_bytes`` on a
known DTensor redistribution, the layer probe's two-point fit against a
direct count at a third depth, and ``analyze_cell`` with the JAX package's
TPU peaks against the JAX ``analyze_cell`` on the same records; and the
hybrid family's reduced cells on a fake (2, 2) mesh (the checks of
``tests/test_torch_dryrun.py``: its shared attention, SSM states and
sequence-split cache).
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.launch import roofline as j_roofline  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.hlo_analysis import CommBytesMode, collective_bytes, comm_bytes  # noqa: E402
from repro_torch.launch.layer_probe import fit, measure, probe_depths  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_production_mesh  # noqa: E402
from test_torch_dryrun import MODES, check_cell, tiny_cell  # noqa: E402


@pytest.mark.parametrize("mode", MODES)
def test_reduced_hybrid_cell_traces_on_a_fake_2x2_mesh(mode, tmp_path):
    check_cell(tiny_cell("zamba2_1p2b", mode, tmp_path), mode)


def test_collective_parser():
    hlo = """
  %ar = bf16[128,256]{1,0} all-reduce(%x), replica_groups={}
  %ag.1 = (f32[64]{0}, f32[32]{0}) all-gather(%y, %z), dimensions={0}
  %nothing = f32[8]{0} add(%a, %b)
  %cp = u8[4]{0} collective-permute(%w), source_target_pairs={{0,1}}
"""
    out = collective_bytes(hlo)
    assert out["all-reduce"]["count"] == 1
    assert out["all-reduce"]["bytes"] == 128 * 256 * 2
    assert out["all-gather"]["bytes"] == 64 * 4 + 32 * 4
    assert out["collective-permute"]["bytes"] == 4
    assert out["total_bytes"] == 128 * 256 * 2 + 64 * 4 + 32 * 4 + 4


def test_comm_bytes_of_a_known_redistribution():
    """All-gathering a (4096, 4096) bf16 tensor split (16, 16): one gather
    over ``model`` to (256, 4096), one over ``data`` to the whole; a sum of
    a rows-split tensor: one all-reduce of its 4-byte result."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with fake_process_group(256):
        mesh = make_production_mesh()
        with FakeTensorMode():
            w = distribute_tensor(torch.empty(4096, 4096, dtype=torch.bfloat16), mesh,
                                  [Shard(0), Shard(1)], src_data_rank=None)
            x = distribute_tensor(torch.empty(64, 64), mesh, [Shard(0), Replicate()],
                                  src_data_rank=None)
            with CommBytesMode() as mode:
                w.redistribute(mesh, [Replicate(), Replicate()])
                x.sum().redistribute(mesh, [Replicate(), Replicate()])
    out = comm_bytes(mode)
    assert out["all-gather"] == {"count": 2, "bytes": 256 * 4096 * 2 + 4096 * 4096 * 2}
    assert out["all-reduce"] == {"count": 1, "bytes": 4}
    assert out["reduce-scatter"]["count"] == out["all-to-all"]["count"] == 0
    assert out["total_bytes"] == 256 * 4096 * 2 + 4096 * 4096 * 2 + 4


@pytest.mark.parametrize("arch, mode", [("smollm_360m", "prefill"), ("zamba2_1p2b", "decode")])
def test_layer_probe_fit_equals_a_direct_count(arch, mode):
    """Eager steps count every layer, so the fit through depths (L1, L2)
    gives the count at a third depth exactly: flops, op bytes and
    collective bytes."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = get_config(arch).reduced()
    l1, l2, _, mk = probe_depths(cfg)
    l3 = l2 + 1
    shape = ShapeConfig("tiny", 32, 2, mode)
    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        m1, m2, m3 = (measure(mk(n), shape, mesh) for n in (l1, l2, l3))
    got = fit(m1, m2, l1, l2, l3)
    for key in ("flops", "bytes", "coll_bytes"):
        assert got[key + "_per_layer"] > 0 or key == "coll_bytes"
        assert got[key] == m3[key], key


def _records():
    """Dry-run records of three real cells (made up counts, the real
    configs): the analytic memory bound reads the configs and caches."""
    coll = {"all-reduce": {"count": 3, "bytes": 7.0e9}, "all-gather": {"count": 5, "bytes": 2.5e9},
            "reduce-scatter": {"count": 0, "bytes": 0}, "all-to-all": {"count": 1, "bytes": 1e8},
            "collective-permute": {"count": 0, "bytes": 0}, "total_bytes": 9.6e9}
    out = []
    for arch, shape, mode in (("llama3_405b", "train_4k", "train"),
                              ("mixtral_8x22b", "prefill_32k", "prefill"),
                              ("zamba2_1p2b", "long_500k", "decode"),
                              ("qwen3_4b", "decode_32k", "decode")):
        cfg = get_config(arch)
        out.append(dict(arch=arch, shape=shape, mesh="16x16", mode=mode, status="ok",
                        devices=256, flops=3.3e15, collectives=coll,
                        param_count=cfg.param_count(),
                        active_param_count=cfg.active_param_count()))
    return out


@pytest.mark.parametrize("probed", [False, True])
def test_analyze_cell_with_tpu_peaks_equals_jax(probed):
    peaks = roofline.Peaks(flops=j_roofline.PEAK_FLOPS, hbm_bw=j_roofline.HBM_BW,
                           link_bw=j_roofline.ICI_BW)
    probe = {"flops": 4.4e15, "coll_bytes": 1.2e10} if probed else None
    for rec in _records():
        got = roofline.analyze_cell(rec, probe, peaks)
        want = j_roofline.analyze_cell(rec, probe)
        got.pop("hint"), want.pop("hint")  # the port names links, not ICI
        assert got == want, rec["arch"]


def test_h100_peaks_are_the_default():
    assert roofline.H100_SXM == roofline.Peaks(flops=989e12, hbm_bw=3.35e12, link_bw=450e9)
    rec = _records()[2]
    r = roofline.analyze_cell(rec)
    assert r["compute_s"] == rec["flops"] / 989e12
    assert roofline.analyze_cell(dict(rec, status="error")) is None


def test_cells_markdown_lists_every_cell():
    recs = []
    for r in _records():
        for mesh, devices in (("16x16", 256), ("2x16x16", 512)):
            recs.append(dict(r, mesh=mesh, devices=devices, trace_s=1.5,
                             memory={"argument_size_in_bytes": 2e9, "temp_size_in_bytes": 3e9}))
    for mesh in ("16x16", "2x16x16"):
        recs.append(dict(arch="smollm_360m", shape="long_500k", mesh=mesh, mode="decode",
                         status="skipped"))
    text = roofline.cells_markdown(recs)
    rows = text.splitlines()[2:]
    assert len(rows) == 5  # a row an arch
    assert "| llama3_405b | 1.5 s, 2 + 3 GB, " in text
    assert "| smollm_360m | missing / missing | missing / missing | missing / missing | skipped |" \
        in text
