"""Metrics registry: counters, gauges, and log2-bucket histograms.

The registry is deliberately tiny and dependency-free: metric state is
plain dicts of floats so a snapshot is JSON out of the box (committed
into BENCH documents, flushed from workers as JSONL lines) and merging
per-process snapshots is pure arithmetic.

- **Counters** are monotonic sums (cache hits, trace-reuse hits,
  contention events).  Merge = sum.
- **Gauges** are last-written values (peak RSS, pool size).  Merge =
  last writer in pid order; per-process gauges should be namespaced by
  the writer if the distinction matters.
- **Histograms** bucket observations by ``floor(log2(value / 1e-6))``
  — microsecond-resolution exponential buckets that cover nanoseconds
  to hours in ~50 buckets — and also carry count/sum/min/max so means
  and totals are exact even though the distribution is approximate.
  Merge = sum counts per bucket, combine the exact moments.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

_HIST_FLOOR = 1e-6  # bucket 0 boundary: one microsecond


def bucket_of(value: float) -> int:
    """Exponential bucket index for ``value`` (seconds or any unit)."""
    if value <= _HIST_FLOOR:
        return 0
    return max(0, int(math.floor(math.log2(value / _HIST_FLOOR))) + 1)


class MetricsRegistry:
    """Counters, gauges, and histograms for one process."""

    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, dict] = {}

    def __bool__(self) -> bool:
        return bool(self.counters or self.gauges or self.histograms)

    def inc(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = {
                "count": 0,
                "sum": 0.0,
                "min": float(value),
                "max": float(value),
                "buckets": {},
            }
        h["count"] += 1
        h["sum"] += float(value)
        h["min"] = min(h["min"], float(value))
        h["max"] = max(h["max"], float(value))
        b = str(bucket_of(value))
        h["buckets"][b] = h["buckets"].get(b, 0) + 1

    # ------------------------------------------------------------- queries

    def counter(self, name: str) -> float:
        return self.counters.get(name, 0.0)

    def ratio(self, hit: str, miss: str) -> Optional[float]:
        """hit / (hit + miss), or None when nothing was counted."""
        h, m = self.counter(hit), self.counter(miss)
        return h / (h + m) if (h + m) > 0 else None

    def snapshot(self) -> dict:
        """JSON-ready cumulative state (deep-copied)."""
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {
                k: {**h, "buckets": dict(h["buckets"])}
                for k, h in self.histograms.items()
            },
        }


def merge_snapshots(snapshots: Iterable[dict]) -> dict:
    """Merge per-process cumulative snapshots into one.

    Counters and histogram buckets/moments sum; gauges take the last
    writer in iteration order (callers pass snapshots sorted by pid, so
    the merge is deterministic).
    """
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, dict] = {}
    for snap in snapshots:
        for k, v in (snap.get("counters") or {}).items():
            counters[k] = counters.get(k, 0.0) + v
        gauges.update(snap.get("gauges") or {})
        for k, h in (snap.get("histograms") or {}).items():
            agg = hists.get(k)
            if agg is None:
                hists[k] = {**h, "buckets": dict(h["buckets"])}
                continue
            agg["count"] += h["count"]
            agg["sum"] += h["sum"]
            agg["min"] = min(agg["min"], h["min"])
            agg["max"] = max(agg["max"], h["max"])
            for b, n in h["buckets"].items():
                agg["buckets"][b] = agg["buckets"].get(b, 0) + n
    return {"counters": counters, "gauges": gauges, "histograms": hists}


__all__: List[str] = [
    "MetricsRegistry",
    "bucket_of",
    "merge_snapshots",
]
