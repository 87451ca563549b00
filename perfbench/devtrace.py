"""Reading a ``torch.profiler`` trace of the traced sub-window: the device's
operations as intervals, the union of their time (``busy_s``), the idle
gaps between them and what the host was doing in each."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

WINDOW_SPAN = "perfbench.trace_window"
SPANS = "perfbench."  # the prefix of the benchmark's own host spans


@dataclass
class Trace:
    ops: List[Tuple[str, float, float]]  # device operations: (name, start s, end s)
    host: List[Tuple[str, float, float]]  # host spans and ops
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, self.start), min(b, self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_seconds(self, names) -> float:
        """Device seconds of the operations whose names hold any of ``names``."""
        return sum(b - a for n, a, b in self.ops if any(k in n for k in names))

    def top_ops(self, count: int = 10) -> List[list]:
        total: dict = {}
        for n, a, b in self.ops:
            total[n[:96]] = total.get(n[:96], 0.0) + (b - a)
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:count]]

    def idle_gaps(self, count: int = 10) -> List[list]:
        """The longest gaps with no device operation, each named by the
        innermost host span or op running at its middle."""
        edges = [self.start] + [x for iv in self.busy_intervals() for x in iv] + [self.end]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:count]
        out = []
        for length, a in gaps:
            mid = a + length / 2
            covering = [(s, n) for n, s, e in self.host if s <= mid <= e]
            out.append([max(covering)[1] if covering else "(no host span)", length])
        return out


def read(prof) -> Trace:
    """The trace of a finished ``torch.profiler.profile`` whose steps ran
    inside ``record_function(WINDOW_SPAN)``."""
    ops, host = [], []
    start = end = None
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # host ranges (record_function) mirrored on the device's timeline are no work
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith(SPANS)):
                ops.append((e.name, a, b))
        elif e.name == WINDOW_SPAN:
            start, end = a, b
        else:
            host.append((e.name, a, b))
    if start is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    return Trace(ops, host, start, end)
