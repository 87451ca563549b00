"""Golden reference for the port's LM serving path, computed by the JAX
package.

``tests/data/torch_port_golden_lm.json`` holds, for the reduced zamba2 with
4 layers and with 5 (so the hybrid's tail layer runs), in float32 with the
parameters of ``repro_torch.convert.random_lm_tree`` (a numpy recipe, so
the card needs no JAX to rebuild them): the prompt tokens, the
last-position logits of ``prefill_step``, a summary of each prefill cache
component (shape, L2 norm, absolute sum and its first values), and the
tokens of 8 greedy decode steps continuing from the prefill cache, with,
for each step and sequence, every token whose logit lies within
``MIN_GAP`` of the largest (the greedy choices that float32 rounding
elsewhere could make; usually the one greedy token) and the smallest gap
between the two largest logits.
``chip_smoke.py`` (phase 11) holds the port's run on the GPU against this
file with ``lm_golden_check``; the test below holds the port's run on the
CPU against it the same way.

Each record is recomputed on every test run and must equal the file to
``rtol=1e-5`` (float32 on another CPU may sum in another order); tokens
exactly.  The file is written by running this module::

    PYTHONPATH=src python tests/test_torch_golden_lm.py
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_port_golden_lm.json")
ARCH = "zamba2_1p2b"
LAYERS = (4, 5)
PARAM_SEED, PROMPT_SEED = 0, 1
BATCH, PROMPT_LEN, GEN = 2, 40, 8
HEAD = 16  # leading values kept per cache component
# Tokens whose logit lies within MIN_GAP of the step's largest are equally
# valid greedy choices for a run whose logits may differ from these by the
# comparison's tolerance (chip_smoke.LM_TOL, 1e-3).
MIN_GAP = 1e-2


def summary(x: np.ndarray) -> dict:
    x = np.asarray(x, np.float64)
    return dict(shape=list(x.shape), l2=float(np.linalg.norm(x)),
                abs_sum=float(np.abs(x).sum()), head=[float(v) for v in x.ravel()[:HEAD]])


def golden_record(layers: int) -> dict:
    """One record, computed by the JAX package on the CPU."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.launch.steps import make_prefill_step
    from repro.models import decode_step, init_cache

    from repro_torch.configs import get_config
    from repro_torch.convert import random_lm_tree

    jc = dataclasses.replace(j_get_config(ARCH).reduced(), num_layers=layers)
    tree = random_lm_tree(dataclasses.replace(get_config(ARCH).reduced(), num_layers=layers),
                          PARAM_SEED)
    params = jax.tree.map(jnp.asarray, tree)
    tokens = np.random.default_rng(PROMPT_SEED).integers(
        0, jc.vocab_size, (BATCH, PROMPT_LEN + 1)).astype(np.int32)
    last, (g_states, (g_k, g_v), t_states) = jax.jit(make_prefill_step(jc))(
        params, {"tokens": jnp.asarray(tokens[:, :PROMPT_LEN])})
    cache = dict(g_states=g_states, g_k=g_k, g_v=g_v)
    if t_states is not None:
        cache["t_states"] = t_states
    # the decode cache holding the prefill, then greedy decode steps
    dc = init_cache(jc, BATCH, PROMPT_LEN + GEN + 1)
    dc = dict(dc, g_state=g_states, len=jnp.full((BATCH,), PROMPT_LEN, jnp.int32),
              g_k=dc["g_k"].at[:, :, :PROMPT_LEN].set(g_k),
              g_v=dc["g_v"].at[:, :, :PROMPT_LEN].set(g_v))
    if t_states is not None:
        dc["t_state"] = t_states
    step = jax.jit(lambda p, t, c: decode_step(jc, p, t, c))
    tok, gen, near, gaps = jnp.asarray(tokens[:, PROMPT_LEN:]), [], [], []
    for _ in range(GEN):
        logits, dc = step(params, tok, dc)
        last_step = np.asarray(logits[:, -1])
        top2 = np.sort(last_step, axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
        near.append([np.flatnonzero(row >= row.max() - MIN_GAP).tolist() for row in last_step])
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        gen.append(np.asarray(tok))
    return dict(
        name=f"{ARCH}-reduced-{layers}L", arch=ARCH, num_layers=layers, param_seed=PARAM_SEED,
        prompt_seed=PROMPT_SEED, prompt_len=PROMPT_LEN, gen=GEN, tokens=tokens.tolist(),
        last_logits=np.asarray(last, np.float64).tolist(),
        cache={k: summary(v) for k, v in cache.items()},
        gen_tokens=np.concatenate(gen, axis=1).tolist(), near_max_tokens=near,
        min_top2_gap=min(gaps),
    )


def golden() -> dict:
    return dict(records=[golden_record(n) for n in LAYERS])


def load() -> dict:
    with open(GOLDEN) as f:
        return json.load(f)


def test_golden_file_is_current():
    want, got = load(), golden()
    assert [r["name"] for r in got["records"]] == [r["name"] for r in want["records"]]
    for g, w in zip(got["records"], want["records"]):
        for k in ("tokens", "gen_tokens", "near_max_tokens", "prompt_len", "gen", "num_layers",
                  "param_seed"):
            assert g[k] == w[k], (g["name"], k)
        np.testing.assert_allclose(g["last_logits"], w["last_logits"], rtol=1e-5, atol=1e-6)
        assert sorted(g["cache"]) == sorted(w["cache"])
        for k in g["cache"]:
            assert g["cache"][k]["shape"] == w["cache"][k]["shape"]
            for stat in ("l2", "abs_sum", "head"):
                np.testing.assert_allclose(g["cache"][k][stat], w["cache"][k][stat],
                                           rtol=1e-5, atol=1e-6)


def test_port_matches_golden_on_the_cpu():
    """chip_smoke.py's phase-11 check, run on the port's CPU path."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    for rec in load()["records"]:
        chip_smoke.lm_golden_check(rec, torch.device("cpu"))


if __name__ == "__main__":
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    data = golden()
    with open(GOLDEN, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    for r in data["records"]:
        print(r["name"], "gen", r["gen_tokens"], "min top-2 gap", r["min_top2_gap"])
