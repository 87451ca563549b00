"""Golden reference for the port's LM training path, computed by the JAX
package.

``tests/data/torch_port_golden_train.json`` holds:

- ``records``: for the reduced ``smollm_360m``, ``qwen3_4b`` (qk-norm,
  untied head), ``mamba2_780m`` and ``zamba2_1p2b``, in float32 with the
  parameters of ``repro_torch.convert.random_lm_tree`` (seed 0; a numpy
  recipe, so the card needs no JAX to rebuild them): the token sequences
  of 5 ``SyntheticLMData(seed=0)`` batches of 2 x 32, the losses of 5
  ``train_step``s on them (``AdamWConfig(lr=LR)``, the cosine schedule
  from step 0), the global L2 norm of the step-0 gradient, and the L2 norm
  of every parameter leaf after the fifth step.
- ``full``: smollm-360m at full width (d 960, 15 heads of 64, kv 5, d_ff
  2,560, vocab 49,152, tied) cut to 4 layers, 3 batches of 2 x 128: the
  sequences, and the losses and the step-0 gradient norm in bfloat16 (the
  config's dtypes) and in float32, from the same parameters.

The sequences are stored because ``SyntheticLMData``'s ``rng.zipf`` draws
differ between numpy versions above some value (numpy 2.0.2 and 2.3.5
give other batches at vocabulary 49,152, the same at 512): the card's
machine replays the record's batches, not its own draws.

``chip_smoke.py`` (phase 16) holds the port's run on the card against the
reduced records (losses ``rtol=1e-4``, gradient norm ``rtol=1e-3``, leaf
norms ``rtol=1e-5``) and against the full record (each bfloat16 value
within ``max(2 |bf16 - f32|, 1e-3 |f32|)`` of the JAX package's bfloat16
value).  The test below recomputes the reduced records through the JAX
package on every run (``rtol=1e-5``: float32 on another CPU may sum in
another order) and holds the port's CPU run against them with
``chip_smoke.train_golden_check``.  The full record is written only by::

    PYTHONPATH=src python tests/test_torch_golden_train.py --full

(several minutes of CPU) and checked only on the card.  Without ``--full``
the module rewrites the reduced records and keeps the full one.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_port_golden_train.json")
ARCHS = ("smollm_360m", "qwen3_4b", "mamba2_780m", "zamba2_1p2b")
PARAM_SEED, DATA_SEED = 0, 0
LR = 1e-2
BATCH, SEQ, STEPS = 2, 32, 5
FULL = dict(arch="smollm_360m", num_layers=4, batch=2, seq=128, steps=3)


def sequences(vocab, batch, seq, steps):
    """Each step's ``SyntheticLMData(seed=DATA_SEED)`` batch as one int32
    array ``(batch, seq + 1)``: tokens ``[:, :-1]``, labels ``[:, 1:]``."""
    from repro.data import SyntheticLMData

    data = SyntheticLMData(vocab, seq, batch, seed=DATA_SEED)
    out = []
    for step in range(steps):
        b = data.batch_at(step)
        out.append(np.concatenate([b["tokens"], b["labels"][:, -1:]], axis=1))
    return out


def jax_run(jc, tc, seqs, leaf_norms):
    """The JAX package's training run from ``random_lm_tree(tc)`` on the
    batches ``seqs``: ``(losses, step-0 gradient norm, {leaf path: L2
    norm} or None)``."""
    import jax
    import jax.numpy as jnp

    from repro.launch.steps import make_train_step
    from repro.models import loss_fn
    from repro.optim import AdamWConfig, adamw_init
    from repro.optim.adamw import global_norm

    from repro_torch.convert import random_lm_tree

    pdt = jnp.dtype(jc.param_dtype)
    params = jax.tree.map(lambda x: jnp.asarray(x, pdt), random_lm_tree(tc, PARAM_SEED))
    ocfg = AdamWConfig(lr=LR, state_dtype=jc.opt_state_dtype)
    opt = adamw_init(params, ocfg)

    def batch_at(step):
        return {"tokens": jnp.asarray(seqs[step][:, :-1]), "labels": jnp.asarray(seqs[step][:, 1:])}

    grads = jax.jit(jax.grad(lambda p, b: loss_fn(jc, p, b)[0]))(params, batch_at(0))
    gn = float(global_norm(grads))
    step_fn = jax.jit(make_train_step(jc, ocfg))
    losses = []
    for step in range(len(seqs)):
        params, opt, metrics = step_fn(params, opt, batch_at(step))
        losses.append(float(metrics["loss"]))
    norms = None
    if leaf_norms:
        norms = {jax.tree_util.keystr(p): float(np.linalg.norm(np.asarray(x, np.float64)))
                 for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    return losses, gn, norms


def golden_record(arch: str) -> dict:
    """One reduced record, computed by the JAX package on the CPU."""
    from repro.configs import get_config as j_get_config

    from repro_torch.configs import get_config

    jc = j_get_config(arch).reduced()
    seqs = sequences(jc.vocab_size, BATCH, SEQ, STEPS)
    losses, gn, norms = jax_run(jc, get_config(arch).reduced(), seqs, True)
    return dict(name=f"{arch}-reduced", arch=arch, param_seed=PARAM_SEED, data_seed=DATA_SEED,
                lr=LR, batch=BATCH, seq=SEQ, steps=STEPS, sequences=[q.tolist() for q in seqs],
                losses=losses, grad_norm0=gn, leaf_norms=norms)


def full_record() -> dict:
    from repro.configs import get_config as j_get_config

    from repro_torch.configs import get_config

    seqs = sequences(j_get_config(FULL["arch"]).vocab_size, FULL["batch"], FULL["seq"],
                     FULL["steps"])
    out = dict(name=f"{FULL['arch']}-{FULL['num_layers']}L", param_seed=PARAM_SEED,
               data_seed=DATA_SEED, lr=LR, **FULL, sequences=[q.tolist() for q in seqs])
    for tag, dt in (("bfloat16", {}), ("float32", dict(dtype="float32", param_dtype="float32"))):
        jc, tc = (dataclasses.replace(c(FULL["arch"]), num_layers=FULL["num_layers"], **dt)
                  for c in (j_get_config, get_config))
        losses, gn, _ = jax_run(jc, tc, seqs, False)
        out[tag] = dict(losses=losses, grad_norm0=gn)
        print(tag, losses, gn, flush=True)
    return out


def load() -> dict:
    with open(GOLDEN) as f:
        return json.load(f)


def test_golden_file_is_current():
    want = load()
    assert [r["arch"] for r in want["records"]] == list(ARCHS)
    assert "full" in want
    for w in want["records"]:
        g = golden_record(w["arch"])
        for k in ("name", "param_seed", "data_seed", "lr", "batch", "seq", "steps", "sequences"):
            assert g[k] == w[k], (w["name"], k)
        np.testing.assert_allclose(g["losses"], w["losses"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm0"], w["grad_norm0"], rtol=1e-5)
        assert sorted(g["leaf_norms"]) == sorted(w["leaf_norms"])
        for k in g["leaf_norms"]:
            np.testing.assert_allclose(g["leaf_norms"][k], w["leaf_norms"][k], rtol=1e-5)


def test_port_matches_golden_on_the_cpu():
    """chip_smoke.py's phase-16 check of the reduced records, run on the
    port's CPU path."""
    import torch

    import chip_smoke

    for rec in load()["records"]:
        chip_smoke.train_golden_check(rec, torch.device("cpu"))


if __name__ == "__main__":
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    data = dict(records=[golden_record(a) for a in ARCHS])
    data["full"] = full_record() if "--full" in sys.argv[1:] else load()["full"]
    with open(GOLDEN, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    for r in data["records"]:
        print(r["name"], "losses", r["losses"], "grad norm", r["grad_norm0"])
