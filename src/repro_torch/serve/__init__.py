"""Multi-tenant serving subsystem: K concurrent query traces over a
shared LLC with per-tenant vs shared AMC correlation tables (ported from
``repro.serve``; unrelated to :mod:`repro_torch.launch.serve`, the LM
serve loop).

Public API:

- :class:`~repro_torch.serve.protocol.TenantSpec` /
  :class:`~repro_torch.serve.protocol.ServeSpec` — declare a scenario; pass the
  ServeSpec in ``Experiment(workloads=[...])`` or to
  :func:`~repro_torch.serve.protocol.run_serve`.
- :func:`~repro_torch.serve.interleave.interleave` — the deterministic
  K-way trace merge.
- :func:`~repro_torch.serve.protocol.contention_payload` — the JAX
  package's ``serve-contention`` JSON schema.
"""
from repro_torch.serve.interleave import (
    INTERLEAVE_POLICIES,
    Interleave,
    deinterleave,
    interleave,
)
from repro_torch.serve.protocol import (
    TABLE_MODES,
    ServeCell,
    ServeResult,
    ServeSpec,
    TenantSpec,
    contention_payload,
    run_serve,
    score_serve,
)
from repro_torch.serve.tables import shared_table_streams

__all__ = [
    "INTERLEAVE_POLICIES",
    "Interleave",
    "ServeCell",
    "ServeResult",
    "ServeSpec",
    "TABLE_MODES",
    "TenantSpec",
    "contention_payload",
    "deinterleave",
    "interleave",
    "run_serve",
    "score_serve",
    "shared_table_streams",
]
