"""Cache-backed experiment execution (ported from ``repro.core.exec``).

Two pieces, layered under :class:`repro_torch.core.Experiment`:

- :mod:`~repro_torch.core.exec.timers` — ``perf_counter`` timing helpers
  and the zero-overhead pipeline stage instrumentation.
- :mod:`~repro_torch.core.exec.artifacts` — content-addressed on-disk
  cache of built workload traces, under a root and an environment
  variable of the port's own (never the JAX package's cache).

The process-pool grid scheduler and the sharded trace store
(``repro.core.exec.scheduler`` / ``sharded``) are ROADMAP queue 1 item 4
and not ported: the lazy ``scheduler`` attribute raises
``NotImplementedError``.

Only :mod:`timers` is imported eagerly — the workload driver uses its
stage hooks, so :mod:`artifacts` (which imports the driver back) resolves
lazily through ``__getattr__`` to keep the import graph acyclic.
"""

from repro_torch.core.exec.timers import collect_stages, record, stage, time_s, time_us

__all__ = [
    "ArtifactCache",
    "collect_stages",
    "default_cache_dir",
    "record",
    "stage",
    "time_s",
    "time_us",
]

_SCHEDULER_NAMES = ("scheduler", "sharded")


def __getattr__(name):
    if name in ("ArtifactCache", "default_cache_dir"):
        from repro_torch.core.exec import artifacts

        return getattr(artifacts, name)
    if name in _SCHEDULER_NAMES:
        raise NotImplementedError(
            f"repro_torch.core.exec.{name}: the process-pool scheduler and the "
            "sharded trace store are not ported yet (ROADMAP queue 1 item 4)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
