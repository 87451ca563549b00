"""Charging device time to the program's spans (``perfbench/program_spans.py``)
on synthetic traces: the i-th device operation to start pairs with the
i-th launching call on the host, and goes to the innermost program span
open at that call; an operation launched outside every span goes to
``()``; the window clips each operation; a trace whose calls and
operations do not pair, in number or in kind, reads nothing, while a
device clock that reads ahead of the host's does not void the pairing.  The
span readers read device ms a traced batch, and nothing where the trace
holds nothing for them."""
from __future__ import annotations

import pytest

from perfbench import bench, devtrace, program_spans

HOST_SPANS = [("launch.step", 0.0, 6.0), ("models.layer", 1.0, 3.0),
              ("models.attention", 1.5, 2.5), ("models.logits", 7.0, 9.0)]
#  each device op (name, start, end), and the host start of its launching call
OPS = [(("k_attn", 2.0, 2.5), 2.0, "cudaLaunchKernel"),   # in step/layer/attention
       (("k_layer", 3.0, 3.5), 2.75, "cudaLaunchKernelExC"),  # in the layer, attention closed
       (("Memset (Device)", 4.0, 4.5), 3.5, "cudaMemsetAsync"),  # in launch.step alone
       (("k_gap", 6.5, 7.0), 6.5, "cudaLaunchKernel"),     # between spans: ()
       (("k_logits", 8.0, 8.5), 7.0, "cuLaunchKernel"),    # at the span's first instant
       (("Memcpy DtoD (Device -> Device)", 9.5, 10.5), 8.5, "cudaMemcpyAsync"),  # half outside
       (("k_outside", 11.0, 12.0), 8.6, "cudaLaunchKernel")]  # wholly outside: nothing
OTHER_HOST = [("aten::mm", 1.9, 2.2), ("cudaStreamIsCapturing", 1.95, 1.96),
              ("cudaDeviceSynchronize", 9.0, 12.0)]


def synthetic(ops=OPS, host=()):
    calls = [(call, t, t + 0.01) for _, t, call in ops]
    return devtrace.Trace([o for o, _, _ in ops], HOST_SPANS + calls + OTHER_HOST + list(host),
                          0.0, 10.0)


def test_each_op_goes_to_the_innermost_open_span():
    got = program_spans.span_seconds(synthetic())
    want = {("launch.step", "models.layer", "models.attention"): 0.5,
            ("launch.step", "models.layer"): 0.5, ("launch.step",): 0.5, (): 0.5,
            ("models.logits",): 0.5 + 0.5}
    assert got.keys() == want.keys()
    assert all(got[k] == pytest.approx(v) for k, v in want.items())


def test_ops_pair_with_calls_by_order_not_by_list_position():
    shuffled = [OPS[i] for i in (3, 0, 6, 1, 5, 2, 4)]
    assert program_spans.span_seconds(synthetic(shuffled)) == pytest.approx(
        program_spans.span_seconds(synthetic()))


def test_a_device_clock_ahead_of_the_host_still_pairs():
    """The profiler maps device times onto the host's clock with an error
    of up to milliseconds (measured on an H100): ops that seem to start
    before their calls pair all the same, and the window clips them where
    the device's clock puts them."""
    early = [((name, a - 0.3, b - 0.3), t, call) for (name, a, b), t, call in OPS]
    got = program_spans.span_seconds(synthetic(early))
    want = {("launch.step", "models.layer", "models.attention"): 0.5,
            ("launch.step", "models.layer"): 0.5, ("launch.step",): 0.5, (): 0.5,
            ("models.logits",): 0.5 + 0.8}
    assert got.keys() == want.keys()
    assert all(got[k] == pytest.approx(v) for k, v in want.items())


@pytest.mark.parametrize("fault", ["extra_call", "lost_op_record", "kernel_by_a_copy",
                                   "copy_by_a_launch", "fill_by_a_copy"])
def test_a_trace_that_does_not_pair_reads_nothing(fault):
    if fault == "extra_call":
        trace = synthetic(host=[("cudaLaunchKernel", 9.9, 9.91)])
    elif fault == "lost_op_record":  # the call is there, its op's record is not
        trace = synthetic()
        trace.ops.pop(1)
    else:  # the counts and times pair, the kinds do not: the order is shifted
        i, call = {"kernel_by_a_copy": (0, "cudaMemcpyAsync"),
                   "copy_by_a_launch": (5, "cudaLaunchKernel"),
                   "fill_by_a_copy": (2, "cudaMemcpy")}[fault]
        trace = synthetic([(op, t, call if j == i else c) for j, (op, t, c) in enumerate(OPS)])
    assert program_spans.span_seconds(trace) is None


READERS = {"mamba_layers_device_ms": ["models.layer.mamba"],
           "attention_device_ms": ["models.attention"],
           "moe_experts_device_ms": ["models.moe.experts"],
           "moe_dispatch_device_ms": ["models.moe.route", "models.moe.dispatch",
                                      "models.moe.combine"],
           "logits_device_ms": ["models.logits"],
           "cache_device_ms": ["models.cache"],
           "layer_other_device_ms": ["models.layer.shared", "models.layer.moe"],
           "prefill_other_device_ms": ["launch.prefill_step"]}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_readers_read_device_ms_a_batch(metric):
    names = READERS[metric]
    spans = [(n, 10.0 * i, 10.0 * i + 5) for i, n in enumerate(names)]
    spans.append(("models.other", 50.0, 55.0))
    ops = [("k", 10.0 * i + 2, 10.0 * i + 2.25) for i in range(len(names))] + [("k", 51, 52)]
    calls = [("cudaLaunchKernel", 10.0 * i + 1, 10.0 * i + 1.1) for i in range(len(names))]
    calls.append(("cudaLaunchKernel", 50.5, 50.6))
    trace = devtrace.Trace(ops, spans + calls, 0.0, 60.0)
    two_batches = [None, None]
    ctx = bench.Context(None, {}, [], 1.0, trace, two_batches)
    assert bench.read_metric(metric, ctx) == pytest.approx(1e3 * 0.25 * len(names) / 2)
    others = devtrace.Trace(ops[-1:], spans[-1:] + calls[-1:], 0.0, 60.0)
    assert bench.read_metric(metric, bench.Context(None, {}, [], 1.0, others, two_batches)) is None
    no_spans = devtrace.Trace(ops, calls, 0.0, 60.0)  # the parent: no program span
    assert bench.read_metric(metric, bench.Context(None, {}, [], 1.0, no_spans, two_batches)) is None
    assert bench.read_metric(metric, bench.Context(None, {}, [], 1.0)) is None


@pytest.mark.parametrize("metric,outer,inner", [
    ("layer_other_device_ms", "models.layer.shared", "models.attention"),
    ("layer_other_device_ms", "models.layer.moe", "models.moe.experts"),
    ("prefill_other_device_ms", "launch.prefill_step", "models.layer.mamba")])
def test_remainder_readers_take_only_what_no_inner_span_holds(metric, outer, inner):
    spans = [(outer, 0.0, 10.0), (inner, 2.0, 4.0)]
    ops = [("k", 1.0, 1.5), ("k", 3.0, 4.0), ("k", 5.0, 5.25)]  # outer, inner, outer
    calls = [("cudaLaunchKernel", t, t + 0.01) for t in (0.5, 2.5, 4.5)]
    ctx = bench.Context(None, {}, [], 1.0, devtrace.Trace(ops, spans + calls, 0.0, 10.0), [None])
    assert bench.read_metric(metric, ctx) == pytest.approx(1e3 * 0.75)
    assert program_spans.ms_a_batch(ctx, outer) == pytest.approx(1e3 * 1.75)
