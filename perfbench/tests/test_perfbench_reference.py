"""The plain reference against the port's ``forward`` (through
``make_prefill_step``) at each configuration's CPU cut
(``tiny_cuts/<config>.json``), in float32, where the two should agree to
rounding: the last logits, the served token, and every cache part."""
from __future__ import annotations

import json

import pytest
import torch

from perfbench import bench, check, family_module, weights
from perfbench.reference.common import Matmul, causal_attention, ssd
from perfbench.tests.tiny import HERE, TINY


def tiny_config(name: str, dtype: str = "float32") -> dict:
    conf = json.loads((HERE / "configs" / f"{name}.json").read_text())
    return dict(conf, **TINY[name], dtype=dtype, param_dtype=dtype)


@pytest.mark.parametrize("name", sorted(TINY))
def test_reference_matches_the_port_in_float32(name):
    from repro_torch.launch.steps import make_prefill_step

    cfg = tiny_config(name)
    seed = 2**31 + 3
    model = bench.build_model(cfg, seed, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (3, 64),
                           generator=torch.Generator().manual_seed(1))
    logits, cache = make_prefill_step(bench.model_config(cfg))(model, {"tokens": tokens})
    readings = check.Readings()
    tree = weights.draw_tree(cfg, seed, "cpu")
    check.compare_batch(cfg, cfg["family"], tree, tokens,
                        check.program_parts(cfg["family"], cfg, cache), logits,
                        logits[:, :cfg["vocab_size"]].argmax(-1), readings)
    values = readings.values()
    assert values["token_gap"] == 0.0
    assert values["logits_err"] < 1e-4 and values["kv_err"] < 1e-4
    assert values.get("state_err", 0.0) < 1e-4
    # every part of the program's cache was compared: k and v of each
    # attention call, the state of each Mamba2 layer, as the family's counts say
    counts = family_module("counts", f"model_{cfg['family']}")
    assert len(check.program_parts(cfg["family"], cfg, cache)) == (
        2 * counts.attention_calls(cfg) + counts.ssm_layers(cfg))


def test_tree_is_the_seed_and_the_programs_parameters():
    cfg = tiny_config("mixtral-8x22b", "bfloat16")
    a = weights.draw_tree(cfg, 5, "cpu")
    b = weights.draw_tree(cfg, 5, "cpu")
    assert torch.equal(a["blocks"]["moe"]["wg"], b["blocks"]["moe"]["wg"])
    assert not torch.equal(a["embed"], weights.draw_tree(cfg, 6, "cpu")["embed"])
    model = bench.build_model(cfg, 5, "cpu")
    assert torch.equal(model.blocks[1].moe.wd, a["blocks"]["moe"]["wd"][1])
    assert torch.equal(model.lm_head, a["lm_head"]) and model.embed.dtype == torch.bfloat16


def test_ssd_reference_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    b, s, h, p, n = 2, 128, 3, 4, 5
    x, bm, cm = (torch.randn(*shape, generator=g) for shape in ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = torch.rand(b, s, h, generator=g)
    a = -torch.rand(h, generator=g) - 0.5
    y, state = ssd(x, dt, a, bm, cm)
    st = torch.zeros(b, h, p, n)
    for t in range(s):
        st = st * torch.exp(dt[:, t] * a)[..., None, None] + torch.einsum(
            "bhp,bn,bh->bhpn", x[:, t], bm[:, t], dt[:, t])
        torch.testing.assert_close(y[:, t], torch.einsum("bhpn,bn->bhp", st, cm[:, t]),
                                   rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(state, st, rtol=1e-4, atol=1e-4)


def test_attention_reference_is_softmax_over_the_past():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 8, generator=g)
    k, v = torch.randn(2, 40, 2, 8, generator=g), torch.randn(2, 40, 2, 8, generator=g)
    out = causal_attention(q, k, v, elements=4 * 40 * 16)  # blocks of 16 queries
    kk, vv = k.repeat_interleave(2, dim=2), v.repeat_interleave(2, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, kk) / 8 ** 0.5
    sc = sc.masked_fill(torch.ones(40, 40, dtype=torch.bool).triu(1), float("-inf"))
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), vv)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block", [1, 256])
def test_last_position_attention_is_the_blocks_last_row(block):
    """The last position's attention from the other positions' keys, as the
    check follows a routing, is the full block's last row."""
    from perfbench.reference.common import attention_block, last_attention_block

    g = torch.Generator().manual_seed(0)
    cfg = dict(head_dim=8, num_heads=6, num_kv_heads=2, rope_theta=1e4)
    d = 16
    shapes = {"wq": (d, 48), "wk": (d, 16), "wv": (d, 16), "wo": (48, d)}
    p = {"ln1": 1 + 0.1 * torch.randn(d, generator=g),
         "attn": {w: torch.randn(*s, generator=g) / 4 for w, s in shapes.items()}}
    x = torch.randn(3, 20, d, generator=g)
    full, k, v = attention_block(p, x, cfg, Matmul(), 1e-6)
    owner = torch.tensor([2, 0, 1, 2])
    last = last_attention_block(p, x[owner, -1], owner, k, v, cfg, Matmul(), 1e-6, block)
    torch.testing.assert_close(last, full[owner, -1], rtol=1e-5, atol=1e-5)


def test_fp8_matmul_rounds_both_operands():
    x, w = torch.tensor([[1.0, 3.3]]), torch.tensor([[1.0], [1.0]])
    assert Matmul("float32")(x, w).item() == pytest.approx(4.3)
    assert Matmul("fp8")(x, w).item() != pytest.approx(4.3, abs=1e-3)


def test_near_tie_routings_are_followed():
    """The last position's routing at a near tie is followed both ways: two
    experts level for the second place give two sets, and a slot whose rank
    lies at the capacity gives a kept and a dropped branch."""
    from perfbench.reference import moe

    d, f, e = 4, 8, 4
    cfg = dict(moe_experts=e, moe_top_k=2)
    g = torch.Generator().manual_seed(0)
    router = torch.zeros(1, d, e)
    router[0, 0] = torch.tensor([3.0, 1.0, 1.0, -5.0])  # experts 1 and 2 level
    blocks = {"ln2": torch.ones(1, d),
              "moe": {"router": router, "wg": torch.randn(1, e, d, f, generator=g),
                      "wu": torch.randn(1, e, d, f, generator=g),
                      "wd": torch.randn(1, e, f, d, generator=g)}}
    xl = torch.tensor([[2.0, 0.0, 0.0, 0.0]])
    owner = torch.tensor([0])
    far = torch.tensor([[0, 0, 0, 0]])
    out, own = moe.branch_moe(blocks, 0, xl, owner, far, 100, cfg, Matmul(), 1e-6)
    assert out.shape[0] == 2 and own.tolist() == [0, 0]
    assert not torch.allclose(out[0], out[1])
    at_capacity = torch.tensor([[100, 0, 0, 0]])  # expert 0's slot at rank 100 of 100
    out, own = moe.branch_moe(blocks, 0, xl, owner, at_capacity, 100, cfg, Matmul(), 1e-6)
    assert out.shape[0] == 4
    router[0, 0] = torch.tensor([3.0, 2.0, 1.0, -5.0])  # clear of ties
    out, _ = moe.branch_moe(blocks, 0, xl, owner, far, 100, cfg, Matmul(), 1e-6)
    assert out.shape[0] == 1


def test_logits_are_judged_against_the_closest_routing(monkeypatch):
    """Each request's logits are held to the closest of the reference's
    routings; a request the reference could not follow is counted
    unjudged."""
    import sys
    import types

    ref = torch.tensor([[4.0, 0.0, 0.0], [0.0, 4.0, 0.0], [0.0, 0.0, 4.0]])
    fake = types.ModuleType("perfbench.reference.fake")

    def run(cfg, tree, tokens, mm):
        yield "branches", (torch.tensor([0, 0, 1]), ref)  # request 2 left unjudged
        yield "logits", ref[:2]

    fake.run = run
    monkeypatch.setitem(sys.modules, "perfbench.reference.fake", fake)
    prog = torch.tensor([[0.0, 4.0, 0.0], [0.0, 0.0, 4.0], [1.0, 0.0, 0.0]])
    readings = check.Readings()
    check.compare_batch({"vocab_size": 3}, "fake", {}, None, {}, prog, prog.argmax(-1),
                        readings)
    values = readings.values()
    assert values["logits_err"] == pytest.approx(0.0)  # request 0 took its second routing
    assert values["unjudged"] == 1 and values["unjudged_of"] == 3
    # request 1 against its one routing: a different token, far apart
    prog[1] = torch.tensor([0.0, 4.0, 0.0])
    readings = check.Readings()
    check.compare_batch({"vocab_size": 3}, "fake", {}, None, {}, prog, prog.argmax(-1),
                        readings)
    assert readings.values()["token_miss"] == 1 and readings.values()["token_miss_of"] == 2


def test_a_check_that_judged_nothing_fails():
    ok, _ = check.judge({"token_miss": 0, "token_miss_of": 0}, {"token_miss": 0})
    assert not ok
    ok, rows = check.judge({}, {"logits_err": 0.1})
    assert not ok and rows[0][1] == float("inf")
    readings = check.Readings()
    readings.add("logits_err", torch.empty(0))
    assert "logits_err" not in readings.values()
    assert check.judge({"token_miss": 0, "token_miss_of": 3}, {"token_miss": 0})[0]
