"""The port's optimizer substrate and data pipeline against the JAX
package, on the CPU (``repro_torch.optim``, ``repro_torch.data``).

- ``cosine_schedule`` over steps 0-10,000 (and the JAX test's warmup-10 /
  total-100 shape) to 1e-7;
- ``adamw_update`` over 5 steps from the same numpy parameters, gradients
  and state as the JAX function, to ``rtol=1e-6``: float32 state, the clip
  active (gradients of norm ~300 against ``grad_clip=1``) and weight decay
  on, and bfloat16 ``m`` / ``v`` as llama3-405b's config keeps them (with
  ``atol`` 1e-7 of an array's largest element, see ``close``);
- the int8 codes of ``compress_int8`` bit-equal to the JAX package's,
  values exactly half-way between two codes included (both round half to
  even), and the scale equal;
- ``error_feedback_update`` over 20 steps to 1e-7;
- the JAX test file's quadratic-convergence, clip and EF-SGD cases, run on
  the port;
- ``SyntheticLMData`` batches bit-equal for a grid of (seed, step, shard,
  num_shards).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.data import SyntheticLMData as JData
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import compress_int8 as j_compress_int8
from repro.optim import cosine_schedule as j_cosine_schedule
from repro.optim import error_feedback_update as j_error_feedback_update
from repro.optim.grad_compress import init_error_buf as j_init_error_buf

from repro_torch.data import SyntheticLMData, make_batch_iterator
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    compress_int8,
    cosine_schedule,
    decompress_int8,
    error_feedback_update,
)
from repro_torch.optim.grad_compress import init_error_buf


def as_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# ------------------------------------------------------------ schedule


def test_cosine_schedule_equals_jax():
    steps = np.arange(0, 10_001)
    got = np.array([float(cosine_schedule(int(s))) for s in steps[::7]])
    want = np.asarray(jax.vmap(j_cosine_schedule)(jnp.asarray(steps[::7])))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)
    assert float(cosine_schedule(0)) == 0.0
    # a 0-d int32 step tensor, as the optimizer state holds it, and the JAX test's shape
    got = np.array([float(cosine_schedule(torch.tensor(s, dtype=torch.int32), warmup=10,
                                          total=100)) for s in range(120)])
    want = np.array([float(j_cosine_schedule(s, warmup=10, total=100)) for s in range(120)])
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)
    assert cosine_schedule(torch.tensor(5)).dtype == torch.float32


# ------------------------------------------------------------ AdamW


def _params(rng):
    return {"a": rng.normal(size=(17, 9)).astype(np.float32),
            "b": rng.normal(size=(33,)).astype(np.float32),
            "c": rng.normal(size=(4, 5, 6)).astype(np.float32)}


def close(got, want):
    """``rtol=1e-6``, and ``atol`` of 1e-7 of the array's largest element:
    the global norms, and so the clip factors, may differ in their last
    bit (the packages sum in other orders), which moves an element where
    ``b1 m + (1 - b1) g`` cancels by more than 1e-6 of itself."""
    want = as_np(want)
    np.testing.assert_allclose(as_np(got), want, rtol=1e-6, atol=1e-7 * np.abs(want).max())


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_equals_jax(state_dtype):
    rng = np.random.default_rng(3)
    p0 = _params(rng)
    grads = [{k: (40.0 * rng.normal(size=v.shape)).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0, state_dtype=state_dtype)
    jcfg, tcfg = JAdamWConfig(**cfg), AdamWConfig(**cfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = j_adamw_init(jp, jcfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = adamw_init(tp, tcfg)
    assert ts["m"]["a"].dtype == getattr(torch, state_dtype)
    for i, g in enumerate(grads):
        scale = 0.5 + 0.1 * i
        jp, js = j_adamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jcfg, scale)
        tp, ts = adamw_update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, tcfg,
                              torch.tensor(scale, dtype=torch.float32))
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for k in p0:
            close(tp[k], jp[k])
            for part in ("m", "v"):
                close(ts[part][k], js[part][k])


def test_adamw_keeps_bfloat16_parameters_in_bfloat16():
    rng = np.random.default_rng(4)
    p0 = {k: v.astype(np.float32) for k, v in _params(rng).items()}
    cfg = dict(lr=1e-2)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p0.items()}
    js, ts = j_adamw_init(jp, JAdamWConfig(**cfg)), adamw_init(tp, AdamWConfig(**cfg))
    g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
    jp, js = j_adamw_update(jp, {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}, js,
                            JAdamWConfig(**cfg))
    tp, ts = adamw_update(tp, {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in g.items()},
                          ts, AdamWConfig(**cfg))
    for k in p0:
        assert tp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(as_np(tp[k]), np.asarray(jp[k], np.float32))


# the JAX test file's cases (tests/test_distributed.py), on the port


def test_adamw_converges_on_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = adamw_init(params, cfg)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state = adamw_update(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.05
    assert int(state["step"]) == 200


def test_grad_clip_applies():
    cfg = AdamWConfig(lr=0.0, grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    state = adamw_init(params, cfg)
    _, state = adamw_update(params, {"w": torch.full((3,), 1e6)}, state, cfg)
    m_norm = float(torch.linalg.norm(state["m"]["w"])) / (1 - cfg.b1)
    assert m_norm == pytest.approx(1.0, rel=1e-3)


# ------------------------------------------------------------ int8 compression


def test_int8_codes_equal_jax_bit_for_bit():
    rng = np.random.default_rng(5)
    cases = [rng.normal(size=512).astype(np.float32),
             (1e-3 * rng.standard_cauchy(size=(64, 33))).astype(np.float32),
             np.zeros(16, np.float32)]
    # exact ties: max 127 gives scale 1 + 1e-12 == 1.0 in float32, so k + 0.5 is
    # half-way between two codes; both packages round it to the even one
    ties = np.concatenate([[127.0], np.arange(-126, 126) + 0.5]).astype(np.float32)
    assert np.float32(127.0) / np.float32(127.0) + np.float32(1e-12) == np.float32(1.0)
    cases.append(ties)
    for x in cases:
        jq, js = j_compress_int8(jnp.asarray(x))
        tq, ts = compress_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert np.float32(ts) == np.float32(js)
        np.testing.assert_array_equal(decompress_int8(tq, ts).numpy(),
                                      np.asarray(jq, np.float32) * np.float32(js))
    q = compress_int8(torch.from_numpy(ties))[0].numpy()
    np.testing.assert_array_equal(q[1:], np.round(ties[1:]).astype(np.int8))  # half to even


def test_int8_roundtrip_bounded_error():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=512).astype(np.float32))
    q, s = compress_int8(x)
    assert float((decompress_int8(q, s) - x).abs().max()) <= float(s) * 0.5 + 1e-6


def test_error_feedback_equals_jax():
    rng = np.random.default_rng(6)
    shapes = {"a": (31, 7), "b": (100,)}
    jerr = j_init_error_buf({k: jnp.zeros(s) for k, s in shapes.items()})
    terr = init_error_buf({k: torch.zeros(s) for k, s in shapes.items()})
    for _ in range(20):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        jd, jerr = j_error_feedback_update({k: jnp.asarray(v) for k, v in g.items()}, jerr)
        td, terr = error_feedback_update({k: torch.from_numpy(v) for k, v in g.items()}, terr)
        for k in shapes:
            np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), rtol=1e-7, atol=1e-7)
            np.testing.assert_allclose(terr[k].numpy(), np.asarray(jerr[k]), rtol=1e-7, atol=1e-7)


def test_error_feedback_unbiased_over_time():
    """EF-int8 SGD tracks uncompressed SGD on a quadratic."""
    rng = np.random.default_rng(1)
    w_true = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    w1 = {"w": torch.zeros(64)}
    w2 = {"w": torch.zeros(64)}
    err = init_error_buf(w1)
    lr = 0.05
    for _ in range(300):
        g1 = {"w": 2 * (w1["w"] - w_true)}
        g2 = {"w": 2 * (w2["w"] - w_true)}
        g2c, err = error_feedback_update(g2, err)
        w1 = {"w": w1["w"] - lr * g1["w"]}
        w2 = {"w": w2["w"] - lr * g2c["w"]}
    assert float((w2["w"] - w_true).abs().max()) < 0.02


# ------------------------------------------------------------ data


@pytest.mark.parametrize("seed,num_shards", [(0, 1), (1, 2), (7, 4)])
def test_data_batches_equal_jax(seed, num_shards):
    for vocab, seq, gb in ((512, 64, 8), (49152, 33, 4)):
        for shard in range(num_shards):
            port = SyntheticLMData(vocab, seq, gb, seed=seed, num_shards=num_shards, shard=shard)
            ref = JData(vocab, seq, gb, seed=seed, num_shards=num_shards, shard=shard)
            for step in (0, 1, 17, 1000):
                got, want = port.batch_at(step), ref.batch_at(step)
                assert sorted(got) == sorted(want) == ["labels", "tokens"]
                for k in got:
                    assert got[k].dtype == want[k].dtype == np.int32
                    np.testing.assert_array_equal(got[k], want[k])
    it = make_batch_iterator(SyntheticLMData(512, 16, 2, seed=seed), start_step=3)
    step, b = next(it)
    assert step == 3
    np.testing.assert_array_equal(b["tokens"], JData(512, 16, 2, seed=seed).batch_at(3)["tokens"])


def test_data_pure_function_of_step_and_shard():
    d1 = SyntheticLMData(100, 16, 8, seed=1, num_shards=2, shard=0)
    d2 = SyntheticLMData(100, 16, 8, seed=1, num_shards=2, shard=1)
    b1a, b1b = d1.batch_at(5), d1.batch_at(5)
    np.testing.assert_array_equal(b1a["tokens"], b1b["tokens"])
    assert not np.array_equal(d1.batch_at(5)["tokens"], d1.batch_at(6)["tokens"])
    assert not np.array_equal(b1a["tokens"], d2.batch_at(5)["tokens"])
    assert b1a["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(b1a["labels"][:, :-1], b1a["tokens"][:, 1:])
