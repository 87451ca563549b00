"""Run manifest: the provenance block attached to every run (ported from
``repro.core.obs.manifest``).

Answers "what code, what configuration, what machine produced this run?":
the git sha, the resolved cache engine and trace emitter, the schema
versions, the interpreter and platform, and — the port's counterpart of
the JAX package's backend — the torch version and the device name.
Captured once per run and attached to ``ExperimentResult.telemetry``.

Everything repo-specific is imported lazily inside :func:`run_manifest`:
this module is imported by ``repro_torch.core.obs``, which the stage-timer
shim imports, so an eager import of the driver here would cycle.
"""

from __future__ import annotations

import os
import platform
import subprocess
import sys
from typing import Optional

_GIT_SHA: Optional[str] = None
_GIT_PROBED = False


def git_sha() -> Optional[str]:
    """HEAD sha of the repo containing this file (cached; None outside
    a git checkout or without a git binary)."""
    global _GIT_SHA, _GIT_PROBED
    if _GIT_PROBED:
        return _GIT_SHA
    _GIT_PROBED = True
    try:
        _GIT_SHA = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True,
            text=True,
            timeout=10,
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        _GIT_SHA = None
    return _GIT_SHA


def device_name(device=None) -> str:
    """``torch.cuda.get_device_name`` of a CUDA ``device`` (the current
    card when ``None`` and one is present), else ``"cpu"``."""
    import torch

    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(dev)


def run_manifest(sched: Optional[dict] = None, device=None, **extra) -> dict:
    """Provenance snapshot: git sha, resolved engine/emitter, schema
    versions, interpreter/platform, torch version and device name, and
    (when the caller has one) a scheduling record plus free-form extras."""
    import torch

    from repro_torch.apps.trace import current_emitter
    from repro_torch.core.driver import TRACE_CODE_VERSION
    from repro_torch.core.exec.artifacts import ARTIFACT_SCHEMA
    from repro_torch.core.obs.spans import TRACE_SCHEMA
    from repro_torch.memsim.engine import current_engine

    doc = {
        "git_sha": git_sha(),
        "engine": current_engine(),
        "emitter": current_emitter(),
        "trace_code_version": TRACE_CODE_VERSION,
        "artifact_schema": ARTIFACT_SCHEMA,
        "trace_schema": TRACE_SCHEMA,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "torch": torch.__version__,
        "device": device_name(device),
        "pid": os.getpid(),
    }
    if sched is not None:
        doc["sched"] = sched
    doc.update(extra)
    return doc


__all__ = ["device_name", "git_sha", "run_manifest"]
