"""Shared wall-clock timing for the execution engine (ported from
``repro.core.exec.timers``).

All timing goes through ``time.perf_counter`` — monotonic and of the
highest available resolution.

Two layers:

- :func:`time_s` / :func:`time_us` time one callable.
- Pipeline stage instrumentation: the workload driver, the cache passes
  and the experiment scorer wrap their phases in ``with
  stage("trace_gen"): ...``; a caller wanting the breakdown activates
  collection with ``with collect_stages() as times: ...``.  With no
  collector, tracer or metrics registry active ``stage`` is a no-op, so
  the hot path pays nothing.  :func:`record` feeds the same collector with
  values measured out of band.

``stage``/``collect_stages``/``record`` are re-exports of
:mod:`repro_torch.core.obs.spans`: the same stage names double as
structured spans (and per-stage latency histograms) when a tracer or
metrics registry is active.  A stage's clock is the host's: on the card it
covers the stage's device work only where the stage ends by copying its
device results to the host, as the graph path's stages do.  The model
path's spans (``models/``, ``launch/steps.py``) are enqueue intervals on
the host, and their device time is read from the ``torch.profiler`` trace
they enter (:func:`repro_torch.core.obs.spans.span`).
"""

from __future__ import annotations

import time
from typing import Callable

from repro_torch.core.obs.spans import collect_stages, record, stage

__all__ = ["collect_stages", "record", "stage", "time_s", "time_us"]


def time_s(fn: Callable[[], object], repeats: int = 1, warmup: int = 0) -> float:
    """Mean wall-clock seconds per call of ``fn`` over ``repeats`` calls."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    return (time.perf_counter() - t0) / repeats


def time_us(fn: Callable[[], object], repeats: int = 3) -> float:
    """Mean microseconds per call, after one warmup (compile) call."""
    return time_s(fn, repeats=repeats, warmup=1) * 1e6
