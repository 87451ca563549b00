"""Per-stream scoring of prefetchers against a workload (PyTorch port of
``repro.core.experiment``'s :func:`score_prefetcher` and
:func:`score_prefetchers_batched`).

Scoring runs the composite (next-line + X) configuration: the prefetcher's
stream is merged into the demand L2 substream, L2 and LLC are re-simulated
on the workload's device, and :func:`~repro_torch.memsim.metrics.evaluate`
scores issuer X against the baseline run.  The ``Experiment`` grid builder,
its workload cache and scheduler come with the ``exec`` slice.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.driver import WorkloadTrace
from repro_torch.core.registry import Prefetcher
from repro_torch.memsim import (
    PrefetchMetrics,
    current_engine,
    evaluate,
    simulate_with_prefetch,
    simulate_with_prefetch_batch,
)


def _composite_stream(workload: WorkloadTrace, stream):
    """Next-line (issuer 0) + the evaluated prefetcher (issuer 1)."""
    blocks = np.concatenate([workload.nl_blocks, stream.blocks])
    pos = np.concatenate([workload.nl_pos, stream.pos])
    issuer = np.concatenate(
        [
            np.zeros(len(workload.nl_blocks), np.int8),
            np.ones(len(stream.blocks), np.int8),
        ]
    )
    return blocks, pos, issuer


def _metrics(workload: WorkloadTrace, name: str, outcome, info) -> PrefetchMetrics:
    m = evaluate(
        name,
        workload.profile,
        outcome,
        baseline_outcome=workload.nl_outcome,
        eval_from_pos=workload.eval_from_pos,
        issuer=1,
    )
    m.info = info  # attach prefetcher-side stats
    return m


def score_prefetcher(
    workload: WorkloadTrace, name: str, generate: Prefetcher
) -> PrefetchMetrics:
    """Score one prefetcher in the composite (next-line + X) configuration."""
    stream = generate(workload)
    blocks, pos, issuer = _composite_stream(workload, stream)
    outcome = simulate_with_prefetch(
        workload.profile,
        blocks,
        pos,
        pf_issuer=issuer,
        metadata_bytes=stream.metadata_bytes,
    )
    return _metrics(workload, name, outcome, stream.info)


def score_prefetchers_batched(
    workload: WorkloadTrace, pairs: Sequence[Tuple[str, Prefetcher]]
) -> List[PrefetchMetrics]:
    """Score a family of prefetchers against one workload in one dispatch.

    Under the ``fused`` engine every prefetcher's merged L2 stream joins one
    K1 launch per level (:func:`simulate_with_prefetch_batch`); other
    engines, and single-member families, loop :func:`score_prefetcher`.
    Metrics are bit-identical either way.
    """
    if len(pairs) <= 1 or current_engine() != "fused":
        return [score_prefetcher(workload, n, g) for n, g in pairs]
    streams = [gen(workload) for _, gen in pairs]
    outcomes = simulate_with_prefetch_batch(
        workload.profile,
        [_composite_stream(workload, s) for s in streams],
        [s.metadata_bytes for s in streams],
    )
    return [
        _metrics(workload, name, outcome, s.info)
        for (name, _), outcome, s in zip(pairs, outcomes, streams)
    ]


__all__ = ["score_prefetcher", "score_prefetchers_batched"]
