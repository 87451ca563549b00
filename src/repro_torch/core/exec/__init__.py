"""Parallel, cache-backed experiment execution (ported from
``repro.core.exec``).

Four pieces, layered under :class:`repro_torch.core.Experiment`:

- :mod:`~repro_torch.core.exec.timers` — ``perf_counter`` timing helpers
  and the zero-overhead pipeline stage instrumentation.
- :mod:`~repro_torch.core.exec.artifacts` — content-addressed on-disk
  cache of built workload traces, their measured-cost sidecars and the
  sharded trace store, under a root and an environment variable of the
  port's own (never the JAX package's cache).
- :mod:`~repro_torch.core.exec.scheduler` — process-pool grid scheduler
  that shards evaluation cells by workload, builds each trace once per
  grid, reassembles results in deterministic (bit-identical-to-serial)
  order, and sizes its pool from a cost model.
- :mod:`~repro_torch.core.exec.sharded` — paper-scale traces as shard
  files, scored with bounded memory.

``Experiment(...).run(workers=1)`` is the serial reference path;
``Experiment(...).run(workers=N)`` opts into the engine.

Only :mod:`timers` is imported eagerly — the workload driver uses its
stage hooks, so the heavier modules (which import the driver back)
resolve lazily through ``__getattr__`` to keep the import graph acyclic.
"""

from repro_torch.core.exec.timers import collect_stages, record, stage, time_s, time_us

__all__ = [
    "ArtifactCache",
    "MaterializePipeline",
    "SchedDecision",
    "collect_stages",
    "default_cache_dir",
    "materialize_specs",
    "plan_execution",
    "record",
    "rows_equal",
    "run_grid",
    "stage",
    "time_s",
    "time_us",
]


def __getattr__(name):
    if name in ("ArtifactCache", "default_cache_dir"):
        from repro_torch.core.exec import artifacts

        return getattr(artifacts, name)
    if name in (
        "MaterializePipeline",
        "SchedDecision",
        "materialize_specs",
        "plan_execution",
        "rows_equal",
        "run_grid",
    ):
        from repro_torch.core.exec import scheduler

        return getattr(scheduler, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
