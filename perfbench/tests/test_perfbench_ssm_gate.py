"""The reader of ``ssm_gate_device_ms`` on synthetic traces: the device
time of the operations launched inside ``models.ssm.gate`` spans, which lie
inside ``models.layer.mamba``, a traced batch; the rest of the Mamba2 layer
goes to ``mamba_layers_device_ms`` alone; a trace without the span (a
program that opens none) reads nothing."""
from __future__ import annotations

import pytest

from perfbench import bench, devtrace

# two Mamba2 layers, each: an op before the gate, the gate, an op after it
SPANS = [("models.layer.mamba", 0.0, 10.0), ("models.ssm.gate", 4.0, 6.0),
         ("models.layer.mamba", 20.0, 30.0), ("models.ssm.gate", 24.0, 26.0)]
OPS = [(("k_proj", 1.0, 2.0), 0.5), (("ssm_gate_kernel", 5.0, 5.5), 4.5),
       (("k_out", 7.0, 9.0), 6.5),
       (("k_proj", 21.0, 22.0), 20.5), (("ssm_gate_kernel", 25.0, 25.25), 24.5),
       (("k_out", 27.0, 29.0), 26.5)]


def context(spans, ops, batches=2):
    calls = [("cudaLaunchKernel", t, t + 0.01) for _, t in ops]
    trace = devtrace.Trace([o for o, _ in ops], spans + calls, 0.0, 40.0)
    return bench.Context(None, {}, [], 1.0, trace, [None] * batches)


def test_reads_the_gate_spans_device_ms_a_batch():
    ctx = context(SPANS, OPS)
    assert bench.read_metric("ssm_gate_device_ms", ctx) == pytest.approx(1e3 * 0.75 / 2)
    assert bench.read_metric("mamba_layers_device_ms", ctx) == pytest.approx(
        1e3 * (3.5 + 3.25) / 2)


@pytest.mark.parametrize("case", ["no_gate_span", "no_trace"])
def test_reads_nothing_without_the_span(case):
    if case == "no_gate_span":  # the program before the gate had a span
        ctx = context([s for s in SPANS if s[0] != "models.ssm.gate"], OPS)
        assert bench.read_metric("mamba_layers_device_ms", ctx) is not None
    else:
        ctx = bench.Context(None, {}, [], 1.0)
    assert bench.read_metric("ssm_gate_device_ms", ctx) is None
