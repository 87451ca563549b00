"""Golden reference for the port's ``moe``, ``vlm`` and ``encdec`` families,
computed by the JAX package.

``tests/data/torch_port_golden_families.json`` holds one record for each
of the reduced ``mixtral_8x22b`` (4 experts top-2, a 64-key window under a
96-token prompt), ``qwen2_vl_7b`` (a prompt of ``embeds`` with an M-RoPE
text / image / text layout, ``chip_smoke.mrope_layout``) and
``whisper_tiny`` (48 frames under a 40-token decoder prompt), in float32
with the parameters of ``repro_torch.convert.random_lm_tree`` (a numpy
recipe, so the card needs no JAX to rebuild them):

- the inputs: the prompt and train tokens, and the L2 norm of every
  ``embeds`` / ``frames`` draw (``chip_smoke.family_inputs`` draws them
  from the record's seed; another numpy's other draws would show);
- the prefill's last logits and a summary of each cache component (shape,
  L2 norm, absolute sum, first values), as ``torch_port_golden_lm.json``;
- 8 greedy serve steps from the decode cache holding the prefill (built
  here, as ``repro_torch.launch.steps.decode_cache_from_prefill`` builds
  it: a ring of the window's slots for mixtral, the frames' cross keys and
  values for whisper), with every token within ``MIN_GAP`` of each step's
  largest logit and the smallest top-2 gap;
- 5 ``train_step`` losses (``AdamWConfig(lr=1e-2)``, batches of 2 x 32)
  and the step-0 gradient's global norm;
- for mixtral, the smallest margin between the k-th and the (k+1)-th
  router logit over every MoE call of the prefill, the serve steps and the
  training: a plan whose choice lies within float32 rounding of a tie
  could flip on another machine.

``chip_smoke.py`` (phase 17) holds the port's run on the card against this
file with ``family_golden_check``; the test below holds the port's CPU run
against it the same way, after recomputing each record through the JAX
package (``rtol=1e-5``, tokens exactly).  The file is written by::

    PYTHONPATH=src python tests/test_torch_golden_families.py
"""
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_port_golden_families.json")
PARAM_SEED, INPUT_SEED = 0, 1
BATCH, GEN = 2, 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, LR = 2, 32, 5, 1e-2
SPECS = {
    "mixtral_8x22b": dict(prompt_len=96),
    "qwen2_vl_7b": dict(prompt_len=40, layout=[8, 4, 4, 16], train_layout=[8, 4, 4, 8]),
    "whisper_tiny": dict(prompt_len=40, frames=48),
}
MIN_GAP = 1e-2  # as tests/test_torch_golden_lm.py


def jax_decode_cache(jc, cache, s, max_len):
    """The JAX decode cache that holds a prefill of ``s`` tokens, laid out
    as ``decode_cache_from_prefill`` lays out the port's."""
    import jax.numpy as jnp

    from repro.models import init_cache

    dc = init_cache(jc, BATCH, max_len)
    if jc.family == "encdec":
        (k, v), (xk, xv) = cache
        dc = dict(dc, xk=xk, xv=xv, xlen=jnp.full((BATCH,), xk.shape[2], jnp.int32))
    else:
        k, v = cache
    w = dc["k"].shape[2]
    pos = np.arange(max(0, s - w), s)
    dc["k"] = dc["k"].at[:, :, pos % w].set(k[:, :, pos])
    dc["v"] = dc["v"].at[:, :, pos % w].set(v[:, :, pos])
    dc["len"] = jnp.full((BATCH,), s, jnp.int32)
    return dc


def golden_record(arch: str) -> dict:
    """One record, computed by the JAX package on the CPU."""
    import jax
    import jax.numpy as jnp

    import repro.models.moe as j_moe
    from repro.configs import get_config as j_get_config
    from repro.launch.steps import make_prefill_step, make_train_step
    from repro.models import decode_step, loss_fn
    from repro.optim import AdamWConfig, adamw_init
    from repro.optim.adamw import global_norm

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.convert import random_lm_tree

    from test_torch_golden_lm import summary

    jc, tc = j_get_config(arch).reduced(), get_config(arch).reduced()
    spec = SPECS[arch]
    s = spec["prompt_len"]
    params = jax.tree.map(jnp.asarray, random_lm_tree(tc, PARAM_SEED))
    rng = np.random.default_rng(INPUT_SEED)
    rec = dict(name=f"{arch}-reduced", arch=arch, param_seed=PARAM_SEED, input_seed=INPUT_SEED,
               gen=GEN, lr=LR, **spec,
               tokens=rng.integers(0, jc.vocab_size, (BATCH, s + 1)).astype(np.int32).tolist(),
               train_sequences=[rng.integers(0, jc.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))
                                .astype(np.int32).tolist() for _ in range(TRAIN_STEPS)])
    batch, drawn = chip_smoke.family_inputs(tc, rec)
    train = [chip_smoke.family_inputs(tc, rec, i) for i in range(TRAIN_STEPS)]
    rec["draws"] = dict(prefill=drawn, **{f"train{i}": d for i, (_, d) in enumerate(train)})

    margins = []
    route_topk = j_moe.route_topk

    def recording(x, router, k):
        logits = jnp.sort(x.astype(jnp.float32) @ router.astype(jnp.float32), axis=-1)[:, ::-1]
        jax.debug.callback(lambda m: margins.append(float(m)),
                           jnp.min(logits[:, k - 1] - logits[:, k]))
        return route_topk(x, router, k)

    j_moe.route_topk = recording
    try:
        last, cache = jax.jit(make_prefill_step(jc))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        dc = jax_decode_cache(jc, cache, s, s + GEN + 1)
        step = jax.jit(lambda p, t, c: decode_step(jc, p, t, c))
        tok, gen, near, gaps = jnp.asarray(np.asarray(rec["tokens"])[:, s:]), [], [], []
        for _ in range(GEN):
            logits, dc = step(params, tok, dc)
            last_step = np.asarray(logits[:, -1])
            top2 = np.sort(last_step, axis=-1)[:, -2:]
            gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
            near.append([np.flatnonzero(row >= row.max() - MIN_GAP).tolist() for row in last_step])
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
            gen.append(np.asarray(tok))
        ocfg = AdamWConfig(lr=LR, state_dtype=jc.opt_state_dtype)
        opt = adamw_init(params, ocfg)
        jb = [{k: jnp.asarray(v) for k, v in b.items()} for b, _ in train]
        grads = jax.jit(jax.grad(lambda p, b: loss_fn(jc, p, b)[0]))(params, jb[0])
        gn = float(global_norm(grads))
        step_fn = jax.jit(make_train_step(jc, ocfg))
        losses = []
        for b in jb:
            params, opt, metrics = step_fn(params, opt, b)
            losses.append(float(metrics["loss"]))
    finally:
        j_moe.route_topk = route_topk
    rec.update(
        last_logits=np.asarray(last, np.float64).tolist(),
        cache={k: summary(v) for k, v in chip_smoke.family_cache_components(jc, cache).items()},
        gen_tokens=np.concatenate(gen, axis=1).tolist(), near_max_tokens=near,
        min_top2_gap=min(gaps), losses=losses, grad_norm0=gn)
    if margins:
        rec["min_router_margin"] = min(margins)
    return rec


def load() -> dict:
    with open(GOLDEN) as f:
        return json.load(f)


def test_golden_file_is_current():
    want = load()
    assert [r["arch"] for r in want["records"]] == list(SPECS)
    for w in want["records"]:
        g = golden_record(w["arch"])
        for k in ("name", "param_seed", "input_seed", "prompt_len", "gen", "tokens",
                  "train_sequences", "gen_tokens", "near_max_tokens", "layout", "train_layout",
                  "frames"):
            assert g.get(k) == w.get(k), (w["name"], k)
        for k in ("last_logits", "losses", "grad_norm0", "min_top2_gap"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6, err_msg=f"{w['name']} {k}")
        assert sorted(g["draws"]) == sorted(w["draws"])
        for key, d in g["draws"].items():
            for k, v in d.items():
                np.testing.assert_allclose(v, w["draws"][key][k], rtol=1e-6)
        assert sorted(g["cache"]) == sorted(w["cache"])
        for k in g["cache"]:
            assert g["cache"][k]["shape"] == w["cache"][k]["shape"]
            for stat in ("l2", "abs_sum", "head"):
                np.testing.assert_allclose(g["cache"][k][stat], w["cache"][k][stat],
                                           rtol=1e-5, atol=1e-6)
        assert ("min_router_margin" in g) == (w["arch"] == "mixtral_8x22b")


def test_port_matches_golden_on_the_cpu():
    """chip_smoke.py's phase-17 check of the reduced records, run on the
    port's CPU path."""
    import torch

    import chip_smoke

    for rec in load()["records"]:
        chip_smoke.family_golden_check(rec, torch.device("cpu"))


if __name__ == "__main__":
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    data = dict(records=[golden_record(a) for a in SPECS])
    with open(GOLDEN, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    for r in data["records"]:
        print(r["name"], "gen", r["gen_tokens"], "losses", r["losses"], "min top-2 gap",
              r["min_top2_gap"], "router margin", r.get("min_router_margin"))
