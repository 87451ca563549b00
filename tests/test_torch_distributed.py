"""The port's launchers across processes: the ``COORDINATOR_ADDRESS`` /
``NUM_PROCESSES`` / ``PROCESS_ID`` bootstrap, ``ElasticMesh``'s device mesh,
``serve --model-parallel 2`` on two gloo ranks and a training step of the
reduced smollm on a (data 2 x model 2) mesh of four, its parameters,
optimizer state and batches laid out by the sharding plan, each against
the same launcher in one process.

The ranks run in subprocesses on the CPU (``tests/_dist_ranks.py``), each
call with its own timeout.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dist_ranks as dr  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_tree_from_params  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.train import parse_args, train  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.sharding import params_shardings, placements  # noqa: E402


def test_bootstrap_joins_the_group_and_the_grid_carries_its_mesh(tmp_path):
    ranks = dr.run_ranks("boot_init", 2, tmp_path, timeout=90)
    for r, res in enumerate(ranks):
        assert res["up"] and res["rank"] == r and res["world"] == 2
        assert res["backend"] == "gloo"
        assert res["grid"] == {"data": 1, "model": 2}
        assert res["device_mesh"] == (("data", "model"), (1, 2), "cpu")


def test_serve_model_parallel_gives_the_one_process_tokens(tmp_path):
    ranks = dr.run_ranks("boot_serve", 2, tmp_path, timeout=120)
    want = serve_main(dr.SERVE_ARGV)
    for res in ranks:
        np.testing.assert_array_equal(res["gen"], want)


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    ranks = dr.run_ranks("boot_train", 4, tmp_path_factory.mktemp("train"), timeout=180)
    one = train(parse_args(dr.TRAIN_ARGV))
    return ranks, one


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def test_train_on_a_2x2_mesh_matches_one_process(train_runs):
    """Losses to ``rtol=1e-5`` and every updated parameter and AdamW ``m``
    leaf to ``rtol=1e-4``, ``atol=1e-6`` of the leaf's largest element
    (``tests/test_torch_train.py``'s dense tolerances)."""
    ranks, one = train_runs
    want = dict(_flat(lm_tree_from_params(one.params)))
    want.update(_flat({"m": lm_tree_from_params(one.opt_state["m"])}))
    for res in ranks:
        np.testing.assert_allclose(res["losses"].numpy(), one.losses, rtol=1e-5)
        assert set(res["params"]) == set(want)
        for path, w in want.items():
            w = w.numpy()
            np.testing.assert_allclose(res["params"][path].numpy(), w, rtol=1e-4,
                                       atol=1e-6 * np.abs(w).max(), err_msg=path)


def test_train_lays_the_parameters_out_by_the_plan(train_runs):
    """The parameters the ranks trained are split as the plan says on the
    (data 2, model 2) grid: the heads, d_ff and vocabulary over ``model``
    (the reduced smollm is below the FSDP threshold)."""
    from repro_torch.launch.mesh import fake_process_group
    from torch.distributed.device_mesh import init_device_mesh

    ranks, _ = train_runs
    cfg = get_config("smollm_360m").reduced()
    model = init_params(cfg, 0, device="cpu")
    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        plan = params_shardings(cfg, mesh, model)
        want = {k: [str(p) for p in placements(v, mesh)] for k, v in plan.items()}
    assert any("S(" in " ".join(v) for v in want.values())
    for res in ranks:
        assert res["placements"] == want


def test_a_single_process_cannot_host_model_parallel_2():
    with pytest.raises(ValueError, match="cannot host"):
        serve_main(dr.SERVE_ARGV + ["--model-parallel", "2"])


def check_moe_on_a_mesh(moe_ranks, key, n, top_k):
    from repro_torch.models.moe import MoEParams, moe_ffn

    w, x, c = dr.moe_inputs(n)
    pw = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux, _ = moe_ffn(tx, MoEParams(**pw), top_k)
    dr.moe_loss(y, aux, torch.from_numpy(c)).backward()
    want = dict(y=y, aux=aux, dx=tx.grad, **{"d" + k: v.grad for k, v in pw.items()})
    for res in moe_ranks:
        for k, v in want.items():
            np.testing.assert_allclose(res[key][k].numpy(), v.detach().numpy(), rtol=1e-5,
                                       atol=1e-6 * float(v.detach().abs().max()),
                                       err_msg=f"{key} {k}")


@pytest.mark.parametrize("n", dr.MOE_NS)
def test_moe_on_a_mesh_matches_one_device(tmp_path_factory, n, moe_ranks):
    """``moe_ffn`` with tokens split over ``data`` and the experts' f dim
    over ``model`` of a (2, 2) mesh (its explicit dispatch and combine
    layouts, below and above 16,384 tokens) gives the one-device output,
    aux loss and gradients."""
    check_moe_on_a_mesh(moe_ranks, n, n, 2)


def test_moe_on_a_mesh_matches_one_device_at_top_3(moe_ranks):
    """The same at top-3 of 4 experts, where a token's row sums three
    slots (in another order than on one device)."""
    check_moe_on_a_mesh(moe_ranks, "top3", dr.MOE_TOP3, 3)


@pytest.fixture(scope="module")
def moe_ranks(tmp_path_factory):
    return dr.run_ranks("moe", 4, tmp_path_factory.mktemp("moe"), timeout=150)
