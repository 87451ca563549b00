"""The port's LM serving path against the JAX package, on the CPU.

Reduced configs (zamba2 with 4 and with 5 layers, so the hybrid's tail
runs; smollm; mamba2) carry the JAX package's own parameters
(``repro.models.init_params``) into the port through
``convert.lm_params_from_numpy``.  ``forward`` logits and its
``return_cache`` structures, 8 ``decode_step``s, ``prefill_step`` followed
by ``serve_step``s, and the serve loop's generated tokens (against
``repro.launch.serve.main``) must agree.  The blocked attention and the
SSD scan run their plain versions here (K5 and K6 on a card).  Prompts come
from a numpy seed.

Tolerance: ``rtol=atol=2e-4``, the JAX package's SSD tolerance
(``tests/test_ssm_moe_attn.py:44``), for logits, caches and states, all
float32; generated tokens exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.launch.serve import main as j_serve_main
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params_from_numpy, lm_tree_shapes
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import prompt_tokens, serve_loop
from repro_torch.launch.steps import (
    decode_cache_from_prefill,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.models import LM, decode_step, forward, init_cache, init_params

TOL = dict(rtol=2e-4, atol=2e-4)
VARIANTS = {  # name -> (arch, layers or None for the reduced default)
    "zamba2-4L": ("zamba2_1p2b", 4),
    "zamba2-5L": ("zamba2_1p2b", 5),
    "smollm": ("smollm_360m", None),
    "mamba2": ("mamba2_780m", None),
}
_MODELS = {}


def configs(variant):
    arch, layers = VARIANTS[variant]
    jc, tc = j_get_config(arch).reduced(), get_config(arch).reduced()
    if layers:
        jc = dataclasses.replace(jc, num_layers=layers)
        tc = dataclasses.replace(tc, num_layers=layers)
    return jc, tc


def models(variant):
    """(jax cfg, jax params, port cfg, port model, jitted JAX decode step),
    built once per variant."""
    if variant not in _MODELS:
        jc, tc = configs(variant)
        jp = j_init_params(jc, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jp)
        j_step = jax.jit(functools.partial(j_decode_step, jc))
        _MODELS[variant] = (jc, jp, tc, lm_params_from_numpy(tc, tree, device="cpu"), j_step)
    return _MODELS[variant]


def leaves(x):
    if x is None:
        return []
    if isinstance(x, (tuple, list)):
        return [y for e in x for y in leaves(e)]
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in leaves(x[k])]
    return [x]


def assert_close(got, ref, **tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), **(tol or TOL))


def structure(x):
    """The nesting of a cache: tuples / None / leaf shapes."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(structure(e) for e in x)
    return tuple(x.shape)


# ------------------------------------------------------------ configs, init


def test_every_config_matches_the_jax_package():
    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS:
        for red in (False, True):
            jc, tc = j_get_config(arch), get_config(arch)
            if red:
                jc, tc = jc.reduced(), tc.reduced()
            assert dataclasses.asdict(jc) == dataclasses.asdict(tc), arch
            assert str(tc.activation_dtype) == f"torch.{jc.activation_dtype}"


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_params_has_the_jax_shapes_and_scales(variant):
    jc, tc = configs(variant)
    want = {}
    shapes = jax.eval_shape(lambda: j_init_params(jc, jax.random.PRNGKey(0)))
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        want[tuple(p.key for p in path)] = tuple(leaf.shape)
    assert lm_tree_shapes(tc) == want
    model = init_params(tc, 0, device="cpu")
    for name, p in model.named_parameters():
        leaf = name.split(".")[-1]
        if leaf in ("ln1", "ln2", "final_norm", "norm", "d_skip"):
            assert torch.all(p == 1), name
        elif leaf in ("a_log", "dt_bias"):
            assert torch.all(p == 0), name
        else:
            fan_in = p.shape[1] if leaf in ("embed", "lm_head") else p.shape[0]
            assert abs(float(p.std()) * fan_in**0.5 - 1) < 0.1, name


# ------------------------------------------------------------ forward, decode


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_cache_match_jax(variant):
    jc, jp, tc, model, _ = models(variant)
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    jl, _, jcache = j_forward(jc, jp, jnp.asarray(toks), return_cache=True)
    logits, aux, cache = forward(tc, model, torch.from_numpy(toks), return_cache=True)
    assert float(aux) == 0.0
    assert_close(logits, jl)
    assert structure(cache) == jax.tree.map(lambda a: tuple(a.shape), jcache)
    for got, ref in zip(leaves(cache), jax.tree.leaves(jcache)):
        assert_close(got, ref)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_steps_match_jax(variant):
    jc, jp, tc, model, j_step = models(variant)
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 8)).astype(np.int32)
    jcache, cache = j_init_cache(jc, 2, 12), init_cache(tc, 2, 12, device="cpu")
    assert sorted(jcache) == sorted(cache)
    for i in range(8):
        jl, jcache = j_step(jp, jnp.asarray(toks[:, i:i + 1]), jcache)
        logits, cache = decode_step(tc, model, torch.from_numpy(toks[:, i:i + 1]), cache)
        assert_close(logits, jl)
    for k in sorted(jcache):
        assert str(cache[k].dtype) == f"torch.{jcache[k].dtype}"
        assert_close(cache[k], jcache[k])


@pytest.mark.parametrize("variant", ["zamba2-5L", "smollm", "mamba2"])
def test_prefill_then_serve_equals_decoding_the_prompt(variant):
    """prefill_step's cache, turned into a decode cache, equals the cache
    after feeding the same tokens one by one, and serving continues from
    it to the same tokens; the JAX decode path gives the same tokens."""
    jc, jp, tc, model, j_step = models(variant)
    s, gen = 21, 6
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, s + 1)).astype(np.int32)
    last, pcache = make_prefill_step(tc)(model, {"tokens": torch.from_numpy(toks[:, :s])})
    res = serve_loop(tc, model, toks, gen, keep_prompt_cache=True)
    assert_close(last, res.prompt_logits)
    cache = decode_cache_from_prefill(tc, pcache, s, s + gen + 1)
    for k in sorted(cache):
        assert_close(cache[k], res.prompt_cache[k])
    step = make_serve_step(tc)
    tok, out = torch.from_numpy(toks[:, s:]), []
    for _ in range(gen):
        tok, cache = step(model, tok, cache)
        out.append(tok)
    np.testing.assert_array_equal(torch.cat(out, 1).numpy(), res.gen)
    # the JAX decode path from the same prompt
    jcache = j_init_cache(jc, 2, s + gen + 1)
    for i in range(s):
        _, jcache = j_step(jp, jnp.asarray(toks[:, i:i + 1]), jcache)
    jtok, jout = jnp.asarray(toks[:, s:]), []
    for _ in range(gen):
        jl, jcache = j_step(jp, jtok, jcache)
        jtok = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)[:, None]
        jout.append(np.asarray(jtok))
    np.testing.assert_array_equal(np.concatenate(jout, 1), res.gen)


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "smollm_360m"])
def test_serve_loop_matches_the_jax_launcher(arch):
    """The JAX launcher's parameters and prompt draws through the port's
    serve loop give the JAX launcher's generated tokens."""
    batch, plen, gen, seed = 2, 10, 6, 3
    jgen = j_serve_main(["--arch", arch, "--reduced", "--batch", str(batch), "--prompt-len",
                         str(plen), "--gen", str(gen), "--seed", str(seed)])
    cfg = get_config(arch).reduced()
    tree = jax.tree.map(np.asarray, j_init_params(j_get_config(arch).reduced(),
                                                  jax.random.PRNGKey(seed)))
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    toks = prompt_tokens(np.random.default_rng(seed), cfg.vocab_size, batch, plen)
    res = serve_loop(cfg, model, toks, gen)
    np.testing.assert_array_equal(res.gen, np.asarray(jgen))


def test_serve_main_runs_on_the_cpu_and_refuses_a_mesh():
    """One process runs the launcher and refuses a grid it cannot host
    (``--model-parallel 2`` needs two ranks: ``tests/test_torch_distributed.py``);
    ``seq_sharded`` without a mesh is the unsharded step, as in the JAX
    package's ``decode_step``."""
    gen = serve_main(["--arch", "zamba2_1p2b", "--reduced", "--batch", "2",
                      "--prompt-len", "5", "--gen", "3", "--device", "cpu"])
    assert gen.shape == (2, 3) and gen.dtype == np.int32
    with pytest.raises(ValueError, match="cannot host"):
        serve_main(["--reduced", "--model-parallel", "2", "--device", "cpu"])
    cfg = get_config("zamba2_1p2b").reduced()
    params = init_params(cfg, 0, device="cpu")
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    outs = [make_serve_step(cfg, seq_sharded=sharded)(params, tok, init_cache(cfg, 2, 8,
                                                                               device="cpu"))
            for sharded in (False, True)]
    np.testing.assert_array_equal(outs[0][0].numpy(), outs[1][0].numpy())
    np.testing.assert_array_equal(outs[0][1]["g_k"].numpy(), outs[1][1]["g_k"].numpy())


def test_lm_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("zamba2_1p2b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main(["--arch", "zamba2_1p2b", "--reduced", "--batch", "1", "--prompt-len", "2",
                    "--gen", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_numpy(cfg, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(cfg)


def test_float32_drift_tool_runs_on_the_cpu():
    """``tools/lm_float32_drift.py`` at a tiny size: the prefill and the
    decode agree closely when the model is shallow; on the CPU the witness
    (the plain versions in the kernels' places) is the prefill itself; the
    witness's context swaps the plain versions in and back out; the model
    comes back as it was."""
    import importlib.util
    import os

    from repro_torch.kernels.flash_attn.ref import blocked_attention_plain
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain
    from repro_torch.kernels.ssm_gate.ssm_gate import ssm_gate_plain
    from repro_torch.launch.drift import plain_versions
    from repro_torch.models import attention, ssm

    path = os.path.join(os.path.dirname(__file__), "..", "tools", "lm_float32_drift.py")
    spec = importlib.util.spec_from_file_location("lm_float32_drift", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--layers", "7", "--d-model", "128", "--prompt-len", "40", "--device", "cpu"])
    assert len(out["layer_state"]) == 7 and len(out["layer_state_plain"]) == 7
    assert max(out["prefill_vs_decode"].values()) < 1e-4
    assert out["plain_vs_decode"] == out["prefill_vs_decode"]
    assert set(out["prefill_vs_plain"].values()) == {0.0}
    assert set(out["one_ulp_move"]) == {"g_state", "g_k", "g_v", "t_state", "logits"}
    kernels = attention.flash_attention, ssm.ssd_scan, ssm.ssm_gate
    with plain_versions():
        assert (attention.flash_attention, ssm.ssd_scan, ssm.ssm_gate) == (
            blocked_attention_plain, ssd_chunked_plain, ssm_gate_plain)
    assert (attention.flash_attention, ssm.ssd_scan, ssm.ssm_gate) == kernels


def test_serve_loop_timing_tool_runs_on_the_cpu():
    """``tools/serve_loop_ms.py`` on the reduced zamba2: one repetition's
    tokens are the serve loop's on the same inputs, and one decode step
    dispatches aten ops."""
    import hashlib
    import importlib.util
    import os

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompt_tokens, serve_loop
    from repro_torch.models import init_params

    path = os.path.join(os.path.dirname(__file__), "..", "tools", "serve_loop_ms.py")
    spec = importlib.util.spec_from_file_location("serve_loop_ms", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rep, ops = mod.main(["--reduced", "--device", "cpu", "--reps", "1", "--prompt", "6",
                         "--gen", "3"])
    cfg = get_config("zamba2_1p2b").reduced()
    tokens = prompt_tokens(np.random.default_rng(0), cfg.vocab_size, 4, 7)
    gen = serve_loop(cfg, init_params(cfg, 0, device="cpu"), tokens, 3).gen
    assert rep["tokens_sha256"] == hashlib.sha256(gen.tobytes()).hexdigest()
    assert rep["decode_step_ms"] > 0 and rep["serve_step_ms"] > 0
    assert ops["decode_step_aten_ops"] > 0 and ops["decode_step_python_calls"] > 0
