"""The port's ``moe``, ``vlm`` and ``encdec`` families against the JAX
package, on the CPU.

The reduced mixtral (4 experts top-2, a 64-key window under a 96-token
prompt), qwen2-vl (a prompt of ``embeds`` with an M-RoPE text / image /
text layout) and whisper (48 frames under a 40-token decoder prompt) carry
the JAX package's own parameters (``repro.models.init_params``) into the
port through ``convert.lm_params_from_numpy``; inputs come from numpy
seeds.  ``forward`` logits, aux loss and caches, ``decode_step``s (whisper
also from an empty cross cache, ``xlen = 0``), ``decode_cache_from_prefill``
(a ring for mixtral, the cross cache for whisper) fed to the JAX
``decode_step`` as numpy, and ``loss_fn`` with its gradients against
``jax.value_and_grad`` must agree.  Tolerances are
``tests/test_torch_lm.py``'s (``rtol=atol=2e-4`` for logits and caches)
and ``tests/test_torch_train.py``'s (loss ``rtol=1e-5``, gradient leaves
``rtol=1e-4`` with ``atol=1e-6`` of the leaf's largest element).  MoE
plans are equal exactly: the MoE layers' plans are read through a wrapper
of ``moe_ffn`` on both sides.  Every reduced config of ``ARCH_IDS`` takes
a ``make_train_step`` and three decode steps (the JAX package's smoke,
``tests/test_models.py``), and both launchers run the ``moe`` family.
"""
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.models.moe as j_moe_mod
from repro.configs import get_config as j_get_config
from repro.launch.serve import main as j_serve_main
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn

import repro_torch.models.model as model_mod
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import (
    lm_params_from_numpy, lm_tree_from_params, lm_tree_shapes, random_lm_tree,
)
from repro_torch.launch import train as train_mod
from repro_torch.launch.serve import prompt_tokens, serve_loop
from repro_torch.launch.steps import (
    decode_cache_from_prefill, make_prefill_step, make_serve_step, make_train_step, param_grads,
)
from repro_torch.models import LM, decode_step, forward, init_cache, init_params, loss_fn
from repro_torch.optim import AdamWConfig, adamw_init

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import mrope_layout  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
# atol of a gradient leaf, in units of its largest element, by family: the
# JAX package's own float32 gradients lie up to 2.66e-6 (mixtral's router)
# and 1.55e-6 (whisper) of it from a float64 evaluation, and the port's
# 2.07e-6 and 1.42e-6 (``python tests/test_torch_families.py`` prints
# them), so those families take about twice the reference's own error;
# qwen2-vl, whose worst is 1.54e-6 in both, keeps the dense family's 1e-6
# (``tests/test_torch_train.py``), which its rtol of 1e-4 covers
GRAD_ATOL = {"moe": 5e-6, "vlm": 1e-6, "encdec": 5e-6}
ARCHS = {"mixtral": "mixtral_8x22b", "qwen2-vl": "qwen2_vl_7b", "whisper": "whisper_tiny"}
B, S, SE = 2, {"mixtral": 96, "qwen2-vl": 40, "whisper": 40}, 48
_MODELS = {}


def models(variant):
    """(jax cfg, jax params, port cfg, port model), once per variant."""
    if variant not in _MODELS:
        arch = ARCHS[variant]
        jc, tc = j_get_config(arch).reduced(), get_config(arch).reduced()
        jp = j_init_params(jc, jax.random.PRNGKey(0))
        _MODELS[variant] = (jc, jp, tc, lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                                             device="cpu"))
    return _MODELS[variant]


def inputs(variant, seed=1, seq=None):
    """The prefill batch of a variant as numpy: ``tokens`` (mixtral,
    whisper), ``embeds`` and ``positions3`` (qwen2-vl), ``frames``
    (whisper); and ``labels``."""
    cfg = get_config(ARCHS[variant]).reduced()
    rng = np.random.default_rng(seed)
    s = seq or S[variant]
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if variant == "qwen2-vl":
        grid = 4
        layout = mrope_layout(8, grid, grid, s - 8 - grid * grid)
        out["embeds"] = (rng.normal(size=(B, s, cfg.d_model)) / np.sqrt(cfg.d_model)).astype(
            np.float32)
        out["positions3"] = np.broadcast_to(layout, (B, 3, s)).copy()
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    if variant == "whisper":
        out["frames"] = (0.5 * rng.normal(size=(B, SE, cfg.d_model))).astype(np.float32)
    return out


def as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def fwd_kw(batch):
    """forward's keyword arguments of a batch (the same in both packages)."""
    return dict(embeds=batch.get("embeds"), positions3=batch.get("positions3"),
                encoder_frames=batch.get("frames"))


def assert_close(got, ref, **tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), **(tol or TOL))


class Plans:
    """Records the plan of every ``moe_ffn`` call of both packages (the
    JAX one through ``jax.debug.callback``, so the forward may be
    jitted)."""

    def __init__(self, monkeypatch):
        self.port, self.jax = [], []
        port_fn, jax_fn = model_mod.moe_ffn, j_moe_mod.moe_ffn

        def port(x, p, k, *a, **kw):
            y, aux, plan = port_fn(x, p, k, *a, **kw)
            self.port.append(tuple(t.numpy().astype(np.int64) for t in plan))
            return y, aux, plan

        def jx(x, p, k, *a, **kw):
            y, aux, plan = jax_fn(x, p, k, *a, **kw)
            jax.debug.callback(lambda *t: self.jax.append(tuple(np.asarray(v, np.int64)
                                                               for v in t)), *plan)
            return y, aux, plan

        monkeypatch.setattr(model_mod, "moe_ffn", port)
        import repro.models.model as j_model_mod

        monkeypatch.setattr(j_model_mod, "moe_ffn", jx)

    def assert_equal(self, n_calls):
        """The first ``n_calls`` plans of each side are equal (under
        ``jax.checkpoint`` the JAX backward routes each layer once more)."""
        assert len(self.port) == n_calls <= len(self.jax)
        for got, want in zip(self.port, self.jax):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)

    def kept_share(self):
        return min(float(keep.mean()) for _, _, keep in self.port)


# ------------------------------------------------------------ init, conversion


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "grok_1_314b", "qwen2_vl_7b", "whisper_tiny"])
def test_init_params_has_the_jax_shapes_and_scales(arch):
    jc, tc = j_get_config(arch).reduced(), get_config(arch).reduced()
    shapes = jax.eval_shape(lambda: j_init_params(jc, jax.random.PRNGKey(0)))
    want = {tuple(p.key for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert lm_tree_shapes(tc) == want
    model = init_params(tc, 0, device="cpu")
    fan_axis = {"router": 0, "wg": 1, "wu": 1}  # an MoE expert's wd: axis 1 too
    for name, p in model.named_parameters():
        leaf = name.split(".")[-1]
        if leaf.startswith("ln") or leaf == "final_norm":
            assert torch.all(p == 1), name
            continue
        if leaf in ("embed", "lm_head"):
            fan_in = p.shape[1]
        elif ".moe." in name:
            fan_in = p.shape[fan_axis.get(leaf, 1)]
        else:
            fan_in = p.shape[0]
        assert abs(float(p.std()) * fan_in**0.5 - 1) < 0.1, name


def test_whisper_tree_round_trips_and_random_tree_fan_in():
    """``lm_tree_from_params`` inverts ``lm_params_from_numpy`` bit for bit
    on the whisper tree (``encoder.<i>`` stacked, ``encoder.final_norm``
    whole), with the JAX tree's paths; ``random_lm_tree``'s fan-in rule
    (``shape[-2]``) gives the MoE leaves their model width or d_ff."""
    jc, jp, tc, model = models("whisper")
    tree = lm_tree_from_params(model)
    j_paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tree))[0]] == j_paths
    assert tree["encoder"]["final_norm"].shape == (tc.d_model,)
    assert tree["encoder"]["attn"]["wq"].shape[0] == tc.encoder_layers
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tree)), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    back = lm_params_from_numpy(tc, jax.tree.map(lambda t: t.numpy(), tree), device="cpu")
    for (n1, p1), (n2, p2) in zip(model.named_parameters(), back.named_parameters()):
        assert n1 == n2 and torch.equal(p1, p2), n1
    mc = get_config("mixtral_8x22b").reduced()
    moe = random_lm_tree(mc, 0)["blocks"]["moe"]
    for leaf, fan_in in (("router", mc.d_model), ("wg", mc.d_model), ("wu", mc.d_model),
                         ("wd", mc.d_ff)):
        assert abs(float(moe[leaf].std()) * fan_in**0.5 - 1) < 0.1, leaf


# ------------------------------------------------------------ forward, decode


@pytest.mark.parametrize("variant", list(ARCHS))
def test_forward_and_cache_match_jax(variant, monkeypatch):
    jc, jp, tc, model = models(variant)
    plans = Plans(monkeypatch)
    batch = inputs(variant)
    jb, tb = as_jax(batch), as_torch(batch)
    jl, j_aux, jcache = j_forward(jc, jp, jb.get("tokens"), return_cache=True, **fwd_kw(jb))
    logits, aux, cache = forward(tc, model, tb.get("tokens"), return_cache=True, **fwd_kw(tb))
    assert_close(logits, jl)
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-5)
    got = jax.tree.map(lambda t: t.numpy(), cache)
    assert jax.tree.structure(got) == jax.tree.structure(jcache)
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(jcache)):
        assert g.shape == r.shape
        assert_close(g, r)
    if variant == "mixtral":
        plans.assert_equal(tc.num_layers)
        assert float(aux) > 0
        print(f"mixtral prefill: kept share {plans.kept_share():.3f}")
    if variant == "whisper":
        assert cache[1][0].shape[2] == SE  # the cross pair holds the frames


@pytest.mark.parametrize("variant", list(ARCHS))
def test_decode_steps_match_jax(variant, monkeypatch):
    """8 decode steps from ``init_cache`` (whisper's cross cache empty:
    every cross score is the finite NEG_INF, the output zeros, not NaN);
    mixtral's cache of 12 positions under its 64-key window."""
    jc, jp, tc, model = models(variant)
    plans = Plans(monkeypatch)
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (B, 8)).astype(np.int32)
    jcache, cache = j_init_cache(jc, B, 12), init_cache(tc, B, 12, device="cpu")
    assert sorted(jcache) == sorted(cache)
    step = jax.jit(functools.partial(j_decode_step, jc))
    for i in range(8):
        jl, jcache = step(jp, jnp.asarray(toks[:, i:i + 1]), jcache)
        logits, cache = decode_step(tc, model, torch.from_numpy(toks[:, i:i + 1]), cache)
        assert bool(torch.isfinite(logits).all())
        assert_close(logits, jl)
    for k in sorted(jcache):
        assert str(cache[k].dtype) == f"torch.{jcache[k].dtype}"
        assert_close(cache[k], jcache[k])
    if variant == "mixtral":
        plans.assert_equal(8 * tc.num_layers)
        print(f"mixtral decode at B = {B}: kept share {plans.kept_share():.3f}")


@pytest.mark.parametrize("variant", ["mixtral", "whisper"])
def test_cache_from_prefill_feeds_the_jax_decode(variant):
    """``decode_cache_from_prefill``: mixtral's 96-token prefill into a ring
    of 64 slots (position p at slot p % 64, p >= 32), whisper's cross cache
    of the 48 frames with ``xlen = 48``; 6 serve steps from it match the
    JAX ``decode_step`` from the same cache as numpy."""
    jc, jp, tc, model = models(variant)
    batch = inputs(variant)
    s, gen = S[variant], 6
    tb = as_torch(batch)
    last, pcache = make_prefill_step(tc)(model, {k: v for k, v in tb.items() if k != "labels"})
    cache = decode_cache_from_prefill(tc, pcache, s, s + gen + 1)
    k_pre = pcache[0] if variant == "mixtral" else pcache[0][0]
    if variant == "mixtral":
        w = tc.sliding_window
        assert cache["k"].shape[2] == w < s
        pos = np.arange(s - w, s)
        assert torch.equal(cache["k"][:, :, pos % w], k_pre[:, :, pos])
        assert torch.equal(cache["v"][:, :, pos % w], pcache[1][:, :, pos])
    else:
        assert torch.equal(cache["k"][:, :, :s], k_pre)
        assert torch.equal(cache["xk"], pcache[1][0]) and torch.equal(cache["xv"], pcache[1][1])
        assert cache["xlen"].tolist() == [SE] * B
    assert cache["len"].tolist() == [s] * B
    jcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    step, jstep = make_serve_step(tc), jax.jit(functools.partial(j_decode_step, jc))
    tok = torch.from_numpy(batch["labels"][:, -1:])
    for _ in range(gen):
        jl, jcache = jstep(jp, jnp.asarray(tok.numpy()), jcache)
        logits, cache = decode_step(tc, model, tok, cache)
        assert_close(logits, jl)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    for k in sorted(jcache):
        assert_close(cache[k], jcache[k])


@pytest.mark.parametrize("variant", ["mixtral", "mixtral-top4", "qwen2-vl"])
def test_prefill_equals_decoding_the_prompt(variant, monkeypatch):
    """A prefill equals the same prompt fed token by token through
    ``serve_loop`` (cache and last logits) only where no MoE layer drops a
    slot: at batch 1 a decode step never does (capacity 1 an expert, the
    top 2 distinct), but at the default capacity factor 1.25 the reduced
    mixtral's 48-token prefill does (kept share 0.83-0.97 for three
    parameter draws); there the check does not apply, and the test asserts
    that the two differ.  With every expert chosen (``moe_top_k = 4``)
    nothing can drop, and they must agree.  qwen2-vl's prefill takes tokens
    here: its decode rotates by plain rope, as the JAX package's does.  The
    prompt (48 tokens) lies under mixtral's 64-key window."""
    arch = ARCHS[variant.split("-top")[0]]
    tc = get_config(arch).reduced()
    if variant == "mixtral-top4":
        tc = dataclasses.replace(tc, moe_top_k=tc.moe_experts)
    model = lm_params_from_numpy(tc, random_lm_tree(tc, 0), device="cpu")
    plans = Plans(monkeypatch)
    s = 48
    toks = np.random.default_rng(5).integers(0, tc.vocab_size, (1, s + 1)).astype(np.int32)
    last, pcache = make_prefill_step(tc)(model, {"tokens": torch.from_numpy(toks[:, :s])})
    kept = plans.kept_share() if plans.port else 1.0
    res = serve_loop(tc, model, toks, 0, keep_prompt_cache=True)
    if plans.port:
        assert plans.kept_share() == kept  # the decode steps kept every slot
    cache = decode_cache_from_prefill(tc, pcache, s, s + 1)
    print(f"{variant}: prefill kept share {kept:.3f}")
    if kept < 1.0:
        assert variant == "mixtral"
        assert not np.allclose(last.numpy(), res.prompt_logits.numpy(), **TOL)
        return
    assert_close(last, res.prompt_logits)
    for k in sorted(cache):
        assert_close(cache[k], res.prompt_cache[k])


# ------------------------------------------------------------ training


def port_grads(tc, tree, batch):
    """``(loss, aux, gradient tree as numpy)`` of the port's ``loss_fn``."""
    model = lm_params_from_numpy(tc, tree, device="cpu").requires_grad_(True)
    named = dict(model.named_parameters())
    batch = as_torch(batch)
    loss, metrics = loss_fn(tc, model, batch)
    tree = lm_tree_from_params(param_grads(loss, named, batch))
    return loss.item(), metrics["aux"].item(), jax.tree.map(lambda t: t.detach().numpy(), tree)


def grad_runs(variant):
    """The JAX package's and the port's ``(loss, aux, grads)`` from one
    ``random_lm_tree``, on a batch of 2 x 32."""
    jc, _, tc, _ = models(variant)
    tree = random_lm_tree(tc, 0)
    batch = inputs(variant, seed=3, seq=32)
    lf = jax.value_and_grad(functools.partial(j_loss_fn, jc), has_aux=True)
    (j_loss, j_metrics), j_grads = lf(jax.tree.map(jnp.asarray, tree), as_jax(batch))
    ref = (float(j_loss), float(j_metrics["aux"]), jax.tree.map(np.asarray, j_grads))
    return tc, tree, batch, ref, port_grads(tc, tree, batch)


@pytest.mark.parametrize("variant", list(ARCHS))
def test_loss_and_gradients_match_jax(variant, monkeypatch):
    plans = Plans(monkeypatch)
    tc, _, _, (j_loss, j_aux, j_grads), (loss, aux, grads) = grad_runs(variant)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    np.testing.assert_allclose(aux, j_aux, rtol=1e-5)
    assert jax.tree.structure(grads) == jax.tree.structure(j_grads)
    atol = GRAD_ATOL[tc.family]
    for (path, jg), g in zip(jax.tree_util.tree_flatten_with_path(j_grads)[0],
                             jax.tree.leaves(grads)):
        np.testing.assert_allclose(g, jg, rtol=1e-4, atol=atol * np.abs(jg).max(),
                                   err_msg=jax.tree_util.keystr(path))
    if variant == "mixtral":
        plans.assert_equal(tc.num_layers)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_smoke_train_step_and_decode(arch):
    """``tests/test_models.py``'s smoke on the port: one ``make_train_step``
    with finite loss and gradients that are not all zero, then three
    decode steps of the padded vocabulary's width, all finite."""
    cfg = get_config(arch).reduced()
    model = init_params(cfg, 0, device="cpu").requires_grad_(True)
    b, s = 2, 32
    batch = {"labels": torch.zeros((b, s), dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["embeds"] = torch.full((b, s, cfg.d_model), 0.1)
        batch["positions3"] = torch.arange(s).expand(b, 3, s)
    else:
        batch["tokens"] = torch.ones((b, s), dtype=torch.int32)
    if cfg.family == "encdec":
        batch["frames"] = torch.full((b, s, cfg.d_model), 0.1)
    named = dict(model.named_parameters())
    loss, _ = loss_fn(cfg, model, batch)
    grads = param_grads(loss, named, batch)
    assert bool(torch.isfinite(loss)) and sum(float(g.abs().sum()) for g in grads.values()) > 0
    opt = adamw_init(named, AdamWConfig())
    _, _, metrics = make_train_step(cfg)(model, opt, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    model.requires_grad_(False)
    cache = init_cache(cfg, b, 16, device="cpu")
    tok = torch.ones((b, 1), dtype=torch.int32)
    for _ in range(3):
        logits, cache = decode_step(cfg, model, tok, cache)
        assert logits.shape == (b, 1, model.embed.shape[0]) and bool(torch.isfinite(logits).all())
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    assert int(cache["len"][0]) == 3


def test_launchers_run_the_moe_family():
    """The JAX launcher's parameters and prompt draws through the port's
    serve loop give the JAX serve launcher's tokens for the reduced
    mixtral; the port's train launcher takes 3 finite steps of it."""
    batch, plen, gen, seed = 2, 10, 6, 3
    jgen = j_serve_main(["--arch", "mixtral_8x22b", "--reduced", "--batch", str(batch),
                         "--prompt-len", str(plen), "--gen", str(gen), "--seed", str(seed)])
    cfg = get_config("mixtral_8x22b").reduced()
    tree = jax.tree.map(np.asarray, j_init_params(j_get_config("mixtral_8x22b").reduced(),
                                                  jax.random.PRNGKey(seed)))
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    toks = prompt_tokens(np.random.default_rng(seed), cfg.vocab_size, batch, plen)
    np.testing.assert_array_equal(serve_loop(cfg, model, toks, gen).gen, np.asarray(jgen))
    run = train_mod.train(train_mod.parse_args(["--arch", "mixtral_8x22b", "--reduced",
                                                "--steps", "3", "--batch", "2", "--seq", "16",
                                                "--device", "cpu"]))
    assert len(run.losses) == 3 and all(np.isfinite(run.losses))
    assert isinstance(run.params, LM) and hasattr(run.params.blocks[0], "moe")


def float64_errors(variant):
    """Per leaf, the largest distance of the JAX package's and the port's
    float32 gradients from a float64 evaluation of the port (every tensor
    in float64, ``.float()`` included), over the leaf's largest element."""
    tc, tree, batch, (_, _, j_grads), (_, _, grads) = grad_runs(variant)
    c64 = dataclasses.replace(tc, dtype="float64", param_dtype="float64")
    as_float = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}
        _, _, g64 = port_grads(c64, tree, batch)
    finally:
        torch.Tensor.float = as_float
    out = {}
    for (path, t), jg, g in zip(jax.tree_util.tree_flatten_with_path(g64)[0],
                                jax.tree.leaves(j_grads), jax.tree.leaves(grads)):
        top = max(np.abs(t).max(), 1e-30)  # the vlm's embedding gets no gradient
        out[jax.tree_util.keystr(path)] = (np.abs(jg - t).max() / top, np.abs(g - t).max() / top,
                                           np.abs(g - jg).max() / top)
    return out


if __name__ == "__main__":
    for v in ARCHS:
        errs = float64_errors(v)
        for i, who in enumerate(("JAX", "port", "port vs JAX")):
            worst = max(errs.items(), key=lambda kv: kv[1][i])
            print(f"{v:9s} {who:12s} {worst[1][i]:.3g} ({worst[0]})")
