"""Device time of the program's spans, read from the traced sub-window's
``devtrace.Trace``.

The program opens its spans (``launch.*``, ``models.*``: ``obs.span`` in
``repro_torch/core/obs/spans.py``) as ``record_function`` ranges while the
profiler records, so they are host events of the trace.  Each device
operation is charged to the spans open on the host when the call that
launched it started.  The trace pairs no device operation with its call,
so they are paired by order: the program runs on one thread and one CUDA
stream, where the device runs its operations in the order the host
launched them, so the i-th operation to start is the i-th launching call
(``LAUNCH_CALLS``).  Where the counts differ (the profiler lost an
operation's record), or a pair's kinds differ (a copy or a fill launched
by a kernel launch, or the other way round), the pairing does not hold and
nothing is read.  Time is no guard: the device's timestamps are mapped
onto the host's clock with an error that reaches milliseconds, so an
operation may appear to start before the call that launched it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

PROGRAM_SPANS = ("launch.", "models.")  # the prefixes of the program's spans
# the host's CUDA calls that each put one operation on the device's timeline
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
    "cudaMemcpy", "cudaMemset"})


def _kind(name: str) -> str:
    """``Memcpy``, ``Memset`` or ``kernel``: of a device operation (``Memcpy
    HtoD (Pageable -> Device)``, ``Memset (Device)``) or of the call that
    launches one (``cudaMemcpyAsync``, ``cudaLaunchKernel``)."""
    for kind in ("Memcpy", "Memset"):
        if name.startswith((kind, "cuda" + kind)):
            return kind
    return "kernel"


def _launch_starts(trace) -> Optional[List[float]]:
    """For each of ``trace.ops`` in order, the host start of the call that
    launched it; None where the pairing does not hold."""
    calls = sorted((a, name) for name, a, _ in trace.host if name in LAUNCH_CALLS)
    order = sorted(range(len(trace.ops)), key=lambda i: trace.ops[i][1])
    if len(calls) != len(order):
        return None
    out = [0.0] * len(order)
    for (t, call), i in zip(calls, order):
        if _kind(trace.ops[i][0]) != _kind(call):
            return None
        out[i] = t
    return out


def span_seconds(trace) -> Optional[Dict[Tuple[str, ...], float]]:
    """Each device operation's seconds inside the window, charged to the
    program spans open at its launch: ``{(outermost, ..., innermost):
    seconds}``, ``()`` for the operations launched inside none; None where
    the trace holds no program span or the pairing does not hold."""
    spans = sorted((a, -b, name) for name, a, b in trace.host if name.startswith(PROGRAM_SPANS))
    if not spans:
        return None
    starts = _launch_starts(trace)
    if starts is None:
        return None
    calls = sorted((t, min(b, trace.end) - max(a, trace.start))
                   for t, (_, a, b) in zip(starts, trace.ops))
    out: Dict[Tuple[str, ...], float] = {}
    stack: list = []  # open spans, the innermost last: (end, name)
    j = 0
    for t, secs in calls:
        while j < len(spans) and spans[j][0] <= t:  # by start, the outer first
            a, neg_b, name = spans[j]
            while stack and stack[-1][0] < a:
                stack.pop()
            stack.append((-neg_b, name))
            j += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        if secs > 0:
            path = tuple(name for _, name in stack)
            out[path] = out.get(path, 0.0) + secs
    return out


def ms_a_batch(ctx, *names: str, innermost: bool = False) -> Optional[float]:
    """Device milliseconds a traced batch charged inside any of the spans
    ``names`` (each operation once); with ``innermost``, only where one of
    ``names`` is the innermost span open.  None where nothing was."""
    if ctx.trace is None or not ctx.traced:
        return None
    charged = span_seconds(ctx.trace) or {}
    hits = [s for path, s in charged.items()
            if set(names) & set(path[-1:] if innermost else path)]
    return 1e3 * sum(hits) / len(ctx.traced) if hits else None
