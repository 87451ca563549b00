"""The port's M-RoPE and MoE layer against the JAX package, on the CPU.

``mrope`` against ``repro.models.layers.mrope`` (and, with three equal
position streams, against ``rope``); ``route_topk``, ``_dispatch_plan``
and ``moe_ffn`` against ``repro.models.moe`` on inputs from numpy seeds.
Tolerances are the JAX package's own (``tests/test_ssm_moe_attn.py``):
``rtol=atol=2e-4`` for outputs, ``rtol=1e-5`` (``atol=1e-6``) for a
replayed plan; routing, plans and drops must be equal exactly.  Every case
logs the smallest margin between the k-th and the (k+1)-th router logit,
the margin below which float32 sums in another order could flip a choice.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.models.layers import mrope as j_mrope
from repro.models.layers import rope as j_rope
from repro.models.moe import MoEParams as JMoEParams
from repro.models.moe import _dispatch_plan as j_dispatch_plan
from repro.models.moe import moe_ffn as j_moe_ffn
from repro.models.moe import route_topk as j_route_topk

from repro_torch.models.layers import mrope, rope
from repro_torch.models.moe import MoEParams, _dispatch_plan, moe_ffn, route_topk

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import mrope_layout  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
REPLAY_TOL = dict(rtol=1e-5, atol=1e-6)


def params(rng, d, f, e, router_scale=1.0):
    arrays = (rng.normal(size=(d, e)) * router_scale, rng.normal(size=(e, d, f)) * 0.2,
              rng.normal(size=(e, d, f)) * 0.2, rng.normal(size=(e, f, d)) * 0.2)
    arrays = [a.astype(np.float32) for a in arrays]
    return JMoEParams(*map(jnp.asarray, arrays)), MoEParams(*map(torch.from_numpy, arrays))


def topk_margin(x, router, k):
    logits = np.sort(np.asarray(x, np.float64) @ np.asarray(router, np.float64), axis=-1)[:, ::-1]
    return float((logits[:, k - 1] - logits[:, k]).min())


def same_plan(plan, j_plan):
    for got, want in zip(plan, j_plan):
        np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(want, np.int64))


# ------------------------------------------------------------ M-RoPE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mrope_matches_jax(dtype):
    """The reduced qwen2-vl's sections (4, 6, 6) at hd 32 and the full
    config's (16, 24, 24) at hd 128, over a text / image / text layout of
    two sequences."""
    rng = np.random.default_rng(0)
    for hd, sections in ((32, (4, 6, 6)), (128, (16, 24, 24))):
        pos = np.stack([mrope_layout(5, 3, 4, 7), mrope_layout(3, 4, 4, 5)])
        x = rng.normal(size=(2, pos.shape[-1], 3, hd)).astype(np.float32)
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        got = mrope(xt, torch.from_numpy(pos), sections, 1e6)
        want = j_mrope(jnp.asarray(x, dtype), jnp.asarray(pos), sections, 1e6)
        assert got.dtype == xt.dtype
        tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_mrope_with_equal_streams_is_rope():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 19, 4, 32)).astype(np.float32))
    positions = torch.arange(19).expand(2, 19)
    got = mrope(x, positions[:, None, :].expand(2, 3, 19), (4, 6, 6), 1e4)
    np.testing.assert_array_equal(got.numpy(), rope(x, positions, 1e4).numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(j_rope(jnp.asarray(x.numpy()),
                                                              jnp.asarray(positions.numpy()))),
                               **TOL)


# ------------------------------------------------------------ routing, plans


@pytest.mark.parametrize("n,e,k", [(64, 4, 2), (96, 8, 2), (50, 8, 1), (33, 4, 3)])
def test_route_topk_and_plan_match_jax(n, e, k):
    rng = np.random.default_rng(n + e + k)
    d = 16
    jp, tp = params(rng, d, 8, e)
    x = rng.normal(size=(n, d)).astype(np.float32)
    j_idx, j_w, j_aux = j_route_topk(jnp.asarray(x), jp.router, k)
    idx, w, aux = route_topk(torch.from_numpy(x), tp.router, k)
    print(f"n {n} e {e} k {k}: smallest top-{k} margin {topk_margin(x, tp.router, k):.3g}")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), **TOL)
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-5)
    for capacity in (1, max(int(1.25 * n * k / e), 1), n * k):
        same_plan(_dispatch_plan(idx, e, capacity), j_dispatch_plan(j_idx, e, capacity))


def test_ties_pick_the_lower_expert_first():
    """Equal router logits: ``jax.lax.top_k`` picks the lower index first,
    and so does the port (``torch.topk`` does not promise it)."""
    x = np.ones((6, 4), np.float32)
    router = np.zeros((4, 8), np.float32)
    router[:, 5] = router[:, 2] = 0.25  # experts 2 and 5 tie on top
    j_idx, _, _ = j_route_topk(jnp.asarray(x), jnp.asarray(router), 3)
    idx, w, _ = route_topk(torch.from_numpy(x), torch.from_numpy(router), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert idx[0].tolist() == [2, 5, 0]
    same_plan(_dispatch_plan(idx, 8, 2), j_dispatch_plan(j_idx, 8, 2))


# ------------------------------------------------------------ moe_ffn


@pytest.mark.parametrize("capacity_factor", [1.25, 4.0])
def test_moe_ffn_matches_jax(capacity_factor):
    """At the default factor 1.25 a skewed router drops slots (the test
    asserts it does); at 4.0 none drop."""
    rng = np.random.default_rng(7)
    n, d, f, e, k = 96, 16, 24, 4, 2
    jp, tp = params(rng, d, f, e, router_scale=0.5)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, 0] += 1.5  # a shared direction: an unbalanced router
    y_j, aux_j, plan_j = j_moe_ffn(jnp.asarray(x), jp, k, capacity_factor)
    y, aux, plan = moe_ffn(torch.from_numpy(x), tp, k, capacity_factor)
    same_plan(plan, plan_j)
    kept = float(plan[2].float().mean())
    print(f"factor {capacity_factor}: kept share {kept:.3f}, smallest top-{k} margin "
          f"{topk_margin(x, tp.router, k):.3g}")
    assert (kept < 1.0) == (capacity_factor == 1.25)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-5)


def test_recorded_plan_replay_matches_jax():
    """A plan replayed on the same input is exact; replayed on an input
    whose first row routes elsewhere (a stale row) the port gives the JAX
    package's output, which zero-weights the stale slots, and the rows
    whose routing held equal the exact run's."""
    rng = np.random.default_rng(4)
    n, d, f, e, k = 16, 8, 12, 4, 2
    jp, tp = params(rng, d, f, e)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y1, _, plan = moe_ffn(torch.from_numpy(x), tp, k, 4.0)
    y2, _, _ = moe_ffn(torch.from_numpy(x), tp, k, 4.0, recorded_plan=plan)
    np.testing.assert_allclose(y2.numpy(), y1.numpy(), **REPLAY_TOL)
    x3 = x.copy()
    x3[0] = -x3[0]
    idx0, _, _ = route_topk(torch.from_numpy(x), tp.router, k)
    idx3, _, _ = route_topk(torch.from_numpy(x3), tp.router, k)
    stale = ~(idx0 == idx3).all(dim=1)
    assert bool(stale[0]) and not bool(stale[1:].any())
    j_plan = tuple(jnp.asarray(t.numpy()) for t in plan)
    y3_j, _, _ = j_moe_ffn(jnp.asarray(x3), jp, k, 4.0, recorded_plan=j_plan)
    y3, _, replayed = moe_ffn(torch.from_numpy(x3), tp, k, 4.0, recorded_plan=plan)
    same_plan(replayed, plan)
    np.testing.assert_allclose(y3.numpy(), np.asarray(y3_j), **REPLAY_TOL)
    y3_exact, _, _ = moe_ffn(torch.from_numpy(x3), tp, k, 4.0)
    np.testing.assert_allclose(y3.numpy()[1:], y3_exact.numpy()[1:], **REPLAY_TOL)


def test_top2_output_is_deterministic_under_any_accumulation_order():
    """With top_k = 2 each token's output is (0 + a) + b, which equals
    (0 + b) + a, and the dispatch adds only zeros onto kept slots: the
    combine reversed slot by slot gives the same bits."""
    rng = np.random.default_rng(11)
    n, d, f, e, k = 64, 16, 24, 4, 2
    _, tp = params(rng, d, f, e, router_scale=0.5)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, 0] += 1.5  # unbalanced, so that slots drop
    x = torch.from_numpy(x)
    y, _, (flat_e, rank, keep) = moe_ffn(x, tp, k)
    assert not bool(keep.all())  # dropped slots add their zeros too
    # the same function with the slots in reverse order
    rev = torch.arange(n * k - 1, -1, -1)
    cap = max(int(1.25 * n * k / e), 1)
    tok = torch.arange(n).repeat_interleave(k)[rev]
    idx, w, _ = route_topk(x, tp.router, k)
    fe, rk, kp = flat_e[rev], rank[rev].long(), keep[rev]
    w_slot = torch.where(kp, w.reshape(-1)[rev], 0.0)
    safe = torch.where(kp, rk, cap - 1)
    disp = torch.zeros((e, cap, d)).index_put((fe, safe), torch.where(kp[:, None], x[tok], 0.0),
                                              accumulate=True)
    h = torch.nn.functional.silu(torch.bmm(disp, tp.w_gate)) * torch.bmm(disp, tp.w_up)
    y_slot = torch.bmm(h, tp.w_down)[fe, safe] * w_slot[:, None]
    y_rev = torch.zeros((n, d)).index_add(0, tok, y_slot)
    assert torch.equal(y, y_rev)
