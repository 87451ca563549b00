"""The frozen operation and byte counts on shapes worked by hand, and a
roofline that reads 100 % when the measured time is the least time."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from perfbench import bench, devtrace
from perfbench.counts import k5, k6, model_hybrid, model_moe
from perfbench.traffic import Traffic

HERE = Path(__file__).resolve().parent.parent
PEAKS = json.loads((HERE / "peaks.json").read_text())

HYB = dict(family="hybrid", num_layers=3, d_model=8, num_heads=2, num_kv_heads=1, head_dim=4,
           d_ff=16, vocab_size=10, ssm_state=2, ssm_head_dim=4, ssm_expand=2, ssm_chunk=2,
           hybrid_attn_every=2)
MOE = dict(family="moe", num_layers=2, d_model=8, num_heads=2, num_kv_heads=1, head_dim=4,
           d_ff=16, vocab_size=10, moe_experts=4, moe_top_k=2)


def test_k5_counts_by_hand():
    # 3 positions: 1 + 2 + 3 = 6 causal pairs; 4 hd = 16 FLOPs a pair, 2 heads, 2 rows
    ops, nbytes = k5.launch(MOE, rows=2, length=3)
    assert ops == 16 * 6 * 2 * 2
    # q and o: 2 rows x 3 x 2 heads x 4; k and v: 2 x 3 x 1 x 4; bf16
    assert nbytes == 2 * (2 * 24 * 2 + 2 * 24)
    assert k5.attention_layers(HYB) == 1 and k5.attention_layers(MOE) == 2


def test_k6_counts_by_hand():
    # chunk 2, 4 positions: 2 chunks; tri = 3; H = 16 / 4 = 4 heads
    ops, nbytes = k6.launch(HYB, rows=1, length=4)
    assert ops == 2 * 1 * 2 * (3 * 2 + 4 * (3 * 4 + 2 * 2 * 2 * 4))
    tokens = 4
    assert nbytes == (2 * tokens * 4 * 4 * 2 + tokens * 4 * 4 + 2 * tokens * 2 * 2
                      + 4 * 4 * 2 * 4 + 4 * 4)
    assert k6.launches(MOE, 1, 4) == [] and len(k6.launches(HYB, 1, 4)) == 3


def test_model_flops_by_hand():
    rows, length = 1, 2
    # moe: q, k, v, o = 8 x 4 x (2 + 1 + 1 + 2) = 192 MACs, router 32, 2 experts x 3 x 128
    per_layer = 2 * 2 * (192 + 32) + 2 * 2 * 2 * 3 * 128 + k5.launch(MOE, 1, 2)[0]
    assert model_moe.flops(MOE, rows, length) == 2 * per_layer + 2 * 8 * 10
    # hybrid: in-proj 8 x (32 + 4 + 4) = 320, out-proj 128 MACs a token
    mamba = 2 * 2 * (320 + 128) + k6.launch(HYB, 1, 2)[0]
    block = 2 * 2 * (8 * 4 * 6 + 3 * 8 * 16) + k5.launch(HYB, 1, 2)[0]
    assert model_hybrid.flops(HYB, rows, length) == 3 * mamba + block + 2 * 8 * 10


@pytest.mark.parametrize("kernel", ["k5", "k6"])
def test_roofline_reads_100_at_the_least_time(kernel):
    cell = bench.Cell("t", dict(HYB, vocab_size=10), Traffic("t", (4,), 8, {}, 1), {}, [], [])
    batches = [bench.Batch(0, 2, 4, 0.0, 0.0, 0.0), bench.Batch(1, 1, 8, 0.0, 0.0, 0.0)]
    ctx = bench.Context(cell, PEAKS, batches, 1.0, traced=batches)
    ideal = ctx.ideal_s(kernel, batches)
    name = ctx.count(kernel).KERNELS[0]
    ctx.trace = devtrace.Trace([(f"void {name}<bf16>(...)", 1.0, 1.0 + ideal),
                                ("other_kernel", 2.0, 3.0)], [], 0.0, 4.0)
    assert bench.read_metric(f"{kernel}_roofline", ctx) == pytest.approx(100.0)
    assert bench.read_metric("device_idle_share", ctx) == pytest.approx(
        100.0 * (1 - (ideal + 1.0) / 4.0))
    ctx.trace = devtrace.Trace([("other_kernel", 2.0, 3.0)], [], 0.0, 4.0)
    assert bench.read_metric(f"{kernel}_roofline", ctx) is None


def test_mfu_over_the_window():
    cell = bench.Cell("t", MOE, Traffic("t", (2, 4), 8, {}, 1), {}, [], [])
    batches = [bench.Batch(0, 4, 2, 0.0, 0.1, 0.5), bench.Batch(1, 2, 4, 0.5, 0.6, 1.0)]
    ctx = bench.Context(cell, PEAKS, batches, 1.0)
    flops = model_moe.flops(MOE, 4, 2) + model_moe.flops(MOE, 2, 4)
    peak = PEAKS["bf16_flops_per_s"]
    assert bench.read_metric("prefill_mfu", ctx) == pytest.approx(100 * flops / peak)
    assert bench.read_metric("prefill_host_ms", ctx) == pytest.approx(100.0)


def test_idle_gaps_and_busy_union():
    t = devtrace.Trace([("a", 1.0, 2.0), ("b", 1.5, 2.5), ("c", 3.0, 3.5)],
                       [("host.sync", 2.4, 3.1), ("host.outer", 0.0, 4.0)], 0.0, 4.0)
    assert t.busy_s == pytest.approx(2.0)
    gaps = t.idle_gaps()
    assert gaps[0] == ["host.outer", pytest.approx(1.0)]
    assert ["host.sync", pytest.approx(0.5)] in gaps
    assert t.top_ops(1) == [["a", 1.0]]
