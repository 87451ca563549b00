"""Straggler detection + mitigation policy (a copy of
``repro/runtime/straggler.py``, numpy only).

Synchronous data parallelism runs at the speed of the slowest participant.
The monitor keeps an EWMA of step time per host and flags sustained
stragglers (step time > threshold x fleet median for ``patience`` steps).
Mitigation escalates:

  1. ``rebalance`` — shrink the straggler's data shard (batch rebalancing,
     cheap, no restart);
  2. ``evict``     — drop the host via the elastic path (checkpoint →
                     re-mesh without it → restore), for hardware-degraded
                     nodes.

The decision logic is host-side and hardware-independent; tests drive it
with synthetic timing streams.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 1.5  # x median
    patience: int = 5  # consecutive flagged steps before action
    ewma: float = 0.7
    rebalance_limit: int = 2  # rebalances before escalating to evict

    def __post_init__(self):
        self.times: Dict[int, float] = {}
        self.flags: Dict[int, int] = defaultdict(int)
        self.rebalances: Dict[int, int] = defaultdict(int)

    def record(self, host: int, step_time: float):
        prev = self.times.get(host, step_time)
        self.times[host] = self.ewma * prev + (1 - self.ewma) * step_time

    def check(self) -> List[tuple]:
        """Returns [(host, action)] with action in {rebalance, evict}."""
        if len(self.times) < 2:
            return []
        med = float(np.median(list(self.times.values())))
        actions = []
        for host, t in self.times.items():
            if t > self.threshold * med:
                self.flags[host] += 1
            else:
                self.flags[host] = 0
            if self.flags[host] >= self.patience:
                if self.rebalances[host] < self.rebalance_limit:
                    self.rebalances[host] += 1
                    actions.append((host, "rebalance"))
                else:
                    actions.append((host, "evict"))
                self.flags[host] = 0
        return actions

    def shard_weights(self, hosts: List[int]) -> Dict[int, float]:
        """Inverse-speed batch weights for the rebalance action."""
        if not self.times:
            return {h: 1.0 / len(hosts) for h in hosts}
        speeds = {h: 1.0 / max(self.times.get(h, 1.0), 1e-9) for h in hosts}
        z = sum(speeds.values())
        return {h: s / z for h, s in speeds.items()}
