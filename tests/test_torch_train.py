"""The port's training forward and gradients against the JAX package, on
the CPU.

For the reduced configs of the ported families (those of
``tests/test_models.py::test_arch_smoke_train_step``: smollm, qwen3 with
its qk-norm, glm4, llama3, mamba2, zamba2; zamba2 also with 5 layers, so
the hybrid's tail layer runs, and smollm with a vocabulary of 500, so the
padded logits are masked), both packages start from the same
``convert.random_lm_tree`` parameters and take one batch of
``SyntheticLMData``.  ``loss_fn`` must give the JAX package's loss to
``rtol=1e-5`` and, through ``convert.lm_tree_from_params``, every leaf of
its gradient (``jax.value_and_grad``) to ``rtol=1e-4`` with ``atol=1e-6 *
max|g|`` of the leaf for the dense family, and ``atol=3e-5 * max|g|`` for
the ssm and hybrid families.  There the JAX package's own float32
gradient lies up to 1.57e-5 of a leaf's largest element from a float64
evaluation of the same function (zamba2 with 5 layers; mamba2 1.7e-6;
the port 3.2e-5 and 1.1e-5; the dense family 1.2e-6 to 1.7e-6 in both),
so no float32 gradient summed in another order can meet 1e-6 there, and
3e-5 is about twice the reference's own error.  The two packages' largest
difference is 2.2e-5 (zamba2 with 5 layers).  Running this module prints
the float64 measurement for every variant::

    PYTHONPATH=src python tests/test_torch_train.py

The gradients under the ``dots`` and ``full`` remat policies must equal
those under ``none`` to ``rtol=1e-6``, and ``lm_tree_from_params`` must
invert ``lm_params_from_numpy`` bit for bit.  The training forward takes the plain
versions of K5 and K6 by name, never their wrappers.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import loss_fn as j_loss_fn

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_tree_from_params, random_lm_tree
from repro_torch.data import SyntheticLMData
from repro_torch.models import forward, loss_fn

VARIANTS = {  # name -> (arch, config changes beyond reduced())
    "smollm": ("smollm_360m", {}),
    "smollm-v500": ("smollm_360m", {"vocab_size": 500}),
    "qwen3": ("qwen3_4b", {}),
    "glm4": ("glm4_9b", {}),
    "llama3": ("llama3_405b", {}),
    "mamba2": ("mamba2_780m", {}),
    "zamba2": ("zamba2_1p2b", {}),
    "zamba2-5L": ("zamba2_1p2b", {"num_layers": 5}),
}
BATCH, SEQ = 2, 32
# atol of a gradient leaf, in units of its largest element, by family
GRAD_ATOL = {"dense": 1e-6, "ssm": 3e-5, "hybrid": 3e-5}
_RUNS = {}


def configs(variant):
    arch, changes = VARIANTS[variant]
    return (dataclasses.replace(j_get_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


def batch(cfg):
    return SyntheticLMData(cfg.vocab_size, SEQ, BATCH, seed=0).batch_at(0)


def numpy_tree(tree):
    return jax.tree.map(lambda t: t.float().numpy(), tree)


def port_grads(tc, tree, remat):
    """``(loss, nll, aux, gradient tree)`` of the port at ``remat``."""
    cfg = dataclasses.replace(tc, remat_policy=remat)
    model = lm_params_from_numpy(cfg, tree, device="cpu").requires_grad_(True)
    named = dict(model.named_parameters())
    b = {k: torch.from_numpy(v) for k, v in batch(cfg).items()}
    loss, metrics = loss_fn(cfg, model, b)
    grads = torch.autograd.grad(loss, list(named.values()))
    return (loss.item(), metrics["nll"].item(), metrics["aux"].item(),
            numpy_tree(lm_tree_from_params(dict(zip(named, grads)))))


def runs(variant):
    """JAX's and the port's (loss, grads) from one ``random_lm_tree``,
    computed once per variant."""
    if variant not in _RUNS:
        jc, tc = configs(variant)
        tree = random_lm_tree(tc, 0)
        b = {k: jnp.asarray(v) for k, v in batch(jc).items()}
        lf = jax.jit(jax.value_and_grad(functools.partial(j_loss_fn, jc), has_aux=True))
        (loss, aux), grads = lf(jax.tree.map(jnp.asarray, tree), b)
        ref = (float(loss), float(aux["nll"]), float(aux["aux"]), jax.tree.map(np.asarray, grads))
        _RUNS[variant] = (tree, ref, port_grads(tc, tree, "none"))
    return _RUNS[variant]


def paths(tree):
    return [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_gradients_match_jax(variant):
    _, (j_loss, j_nll, j_aux, j_grads), (loss, nll, aux, grads) = runs(variant)
    atol = GRAD_ATOL[configs(variant)[1].family]
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    np.testing.assert_allclose(nll, j_nll, rtol=1e-5)
    assert aux == j_aux == 0.0
    assert paths(grads) == paths(j_grads)
    for path, g, jg in zip(paths(grads), jax.tree.leaves(grads), jax.tree.leaves(j_grads)):
        assert g.shape == jg.shape, path
        assert np.abs(jg).max() > 0, path
        np.testing.assert_allclose(g, jg, rtol=1e-4, atol=atol * np.abs(jg).max(), err_msg=path)


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("variant", ["smollm", "mamba2", "zamba2-5L"])
def test_remat_policies_give_the_gradients_of_none(variant, remat):
    tree, _, (loss, _, _, grads) = runs(variant)
    _, tc = configs(variant)
    r_loss, _, _, r_grads = port_grads(tc, tree, remat)
    assert r_loss == loss
    for path, g, rg in zip(paths(grads), jax.tree.leaves(grads), jax.tree.leaves(r_grads)):
        np.testing.assert_allclose(rg, g, rtol=1e-6, atol=0, err_msg=path)


@pytest.mark.parametrize("variant", ["smollm", "qwen3", "mamba2", "zamba2-5L"])
def test_lm_tree_from_params_inverts_lm_params_from_numpy(variant):
    _, tc = configs(variant)
    tree = random_lm_tree(tc, 1)
    back = numpy_tree(lm_tree_from_params(lm_params_from_numpy(tc, tree, device="cpu")))
    assert paths(back) == paths(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    # and back again into a model: the same bits
    model = lm_params_from_numpy(tc, lm_tree_from_params(
        lm_params_from_numpy(tc, tree, device="cpu")), device="cpu")
    for a, b in zip(jax.tree.leaves(numpy_tree(lm_tree_from_params(model))),
                    jax.tree.leaves(tree)):
        assert np.array_equal(a, b)


def test_bfloat16_tree_keeps_its_bits():
    """A bfloat16 model's tree keeps bfloat16 leaves, and loading it back
    gives the same bits."""
    _, tc = configs("smollm")
    tc = dataclasses.replace(tc, param_dtype="bfloat16", dtype="bfloat16")
    model = lm_params_from_numpy(tc, random_lm_tree(tc, 2), device="cpu")
    tree = lm_tree_from_params(model)
    assert {t.dtype for t in jax.tree.leaves(tree)} == {torch.bfloat16}
    again = lm_params_from_numpy(tc, numpy_tree(tree), device="cpu")
    for (name, a), b in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), name


def test_training_forward_takes_the_plain_versions(monkeypatch):
    """``loss_fn`` never calls the K5 / K6 wrappers (on the card they have
    no backward); the serving forward still does."""
    from repro_torch.models import attention, ssm

    calls = []

    def refuse(name):
        def fn(*args, **kwargs):
            calls.append(name)
            raise AssertionError(f"{name} on the training path")
        return fn

    for variant in ("smollm", "zamba2"):
        _, tc = configs(variant)
        model = lm_params_from_numpy(tc, random_lm_tree(tc, 0), device="cpu")
        model.requires_grad_(True)
        b = {k: torch.from_numpy(v) for k, v in batch(tc).items()}
        with monkeypatch.context() as m:
            m.setattr(attention, "flash_attention", refuse("flash_attention"))
            m.setattr(ssm, "ssd_scan", refuse("ssd_scan"))
            loss, _ = loss_fn(tc, model, b)
            loss.backward()
            assert calls == []
            with pytest.raises(AssertionError):
                forward(tc, model, b["tokens"])
        assert calls
        calls.clear()


def float64_errors(variant):
    """Per leaf, the largest distance of the JAX package's and the port's
    float32 gradients from a float64 evaluation (the port with every
    tensor in float64, ``.float()`` included), over the leaf's largest
    element."""
    tree, (_, _, _, j_grads), (_, _, _, grads) = runs(variant)
    _, tc = configs(variant)
    c64 = dataclasses.replace(tc, dtype="float64", param_dtype="float64")
    as_float = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double  # the plain SSD and the norms cast with .float()
    try:
        model = lm_params_from_numpy(c64, tree, device="cpu").requires_grad_(True)
        named = dict(model.named_parameters())
        loss, _ = loss_fn(c64, model, {k: torch.from_numpy(v) for k, v in batch(c64).items()})
        g64 = torch.autograd.grad(loss, list(named.values()))
    finally:
        torch.Tensor.float = as_float
    g64 = jax.tree.map(lambda t: t.numpy(), lm_tree_from_params(dict(zip(named, g64))))
    out = {}
    for path, jg, g, t in zip(paths(g64), jax.tree.leaves(j_grads), jax.tree.leaves(grads),
                              jax.tree.leaves(g64)):
        top = np.abs(t).max()
        out[path] = (np.abs(jg - t).max() / top, np.abs(g - t).max() / top)
    return out


if __name__ == "__main__":
    for v in VARIANTS:
        errs = float64_errors(v)
        worst_j = max(errs.items(), key=lambda kv: kv[1][0])
        worst_p = max(errs.items(), key=lambda kv: kv[1][1])
        print(f"{v:12s} JAX {worst_j[1][0]:.3g} ({worst_j[0]})  port {worst_p[1][1]:.3g} "
              f"({worst_p[0]})")
