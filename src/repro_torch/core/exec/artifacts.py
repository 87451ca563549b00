"""Content-addressed on-disk cache of built workload traces (ported from
``repro.core.exec.artifacts``).

Building a :class:`~repro_torch.core.driver.WorkloadTrace` (app run ->
access trace -> demand simulation -> next-line baseline outcome) dominates
the cost of an evaluation grid and is fully determined by the
:class:`~repro_torch.core.driver.WorkloadSpec`.  This cache persists every
built component as one compressed ``.npz`` so repeat sweeps skip the
rebuild entirely.

Properties:

- **Content-addressed.**  The filename embeds a SHA-256 digest of the
  canonical spec JSON plus
  :data:`repro_torch.core.driver.TRACE_CODE_VERSION`, the artifact schema
  version and a port marker.  Changing any spec field, bumping the
  trace-code version, or changing the artifact layout all move the key —
  stale artifacts are never read, merely orphaned.
- **The port's own.**  The root and its environment variable are not the
  JAX package's, and the key carries a port marker, so a trace built by
  the JAX package is never loaded here: it would hide a fault in the
  port's trace.
- **Bit-identical round trip.**  Arrays are stored losslessly; derived
  pieces (the L2 substream views, the AMC session) are reconstructed by
  the same code paths a build uses, so metrics computed from a loaded
  trace equal those from a fresh build exactly.  A loaded profile is put
  on the device the caller asks for, where its scoring then runs.
- **Concurrency-safe.**  Writes go to a temp file in the cache directory
  followed by an atomic ``os.replace``; unreadable or truncated artifacts
  read as cache misses and are rebuilt.

Two more stores share the root and the keys:

- **Measured-cost sidecars** (:meth:`ArtifactCache.record_cost`): the
  build and score seconds of earlier runs, which the scheduler's cost
  model prefers to its constants.
- **The sharded trace store** (:meth:`ArtifactCache.save_shard`,
  :meth:`ArtifactCache.save_manifest`): a paper-scale trace as
  fixed-size shard files and one JSON manifest, written last, whose
  presence commits the build.  The port marker is in these keys too, so a
  shard store the JAX package built under the same root reads as absent.

Location: ``$REPRO_TORCH_WORKLOAD_CACHE`` if set, else
``~/.cache/repro-amc-torch/workloads``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np

import repro_torch.core.driver as _driver
from repro_torch.apps.registry import kernel_traits
from repro_torch.apps.trace import TraceConfig
from repro_torch.core.driver import WorkloadSpec, WorkloadTrace, make_session
from repro_torch.core.obs import spans as obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.memsim.hierarchy import DemandProfile, PrefetchOutcome

ENV_VAR = "REPRO_TORCH_WORKLOAD_CACHE"

# Layout version of the .npz payload itself (folded into the content hash
# alongside TRACE_CODE_VERSION, and double-checked on load).
ARTIFACT_SCHEMA = 1

# Folded into every key: the port's artifacts never share a digest with
# the JAX package's, even under a root both were pointed at.
PORT_MARKER = "repro_torch"

# PrefetchOutcome array fields, stored under an ``o_`` prefix.
_OUTCOME_ARRAYS = (
    "pf_pos",
    "pf_issuer",
    "pf_redundant",
    "pf_no_future",
    "pf_llc_in_dram",
    "pf_llc_in_pos",
    "demand_l2_hit",
    "demand_useful",
    "demand_late",
    "demand_fill_issuer",
    "demand_llc_hit",
    "pf_early",
)


def default_cache_dir() -> Path:
    """Artifact root: ``$REPRO_TORCH_WORKLOAD_CACHE`` or the user cache dir."""
    env = os.environ.get(ENV_VAR)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro-amc-torch" / "workloads"


class ArtifactCache:
    """Persist/load :class:`WorkloadTrace` artifacts under one root dir."""

    def __init__(self, root: Optional[os.PathLike] = None):
        self.root = Path(root) if root is not None else default_cache_dir()
        self.loads = 0
        self.saves = 0
        self.misses = 0

    def key(self, spec: WorkloadSpec) -> str:
        """Canonical identity document hashed into the artifact filename.

        The spec's fields, the schema and trace-code versions and the port
        marker.  The kernel's traversal-direction mode is folded in for
        non-push kernels, so a registry change that re-points a kernel
        name at a different direction moves its artifacts.  A spec
        exposing ``content_key()`` is keyed on that document instead (what
        its trace is determined by), so content-identical specs share one
        artifact; other spec types fold in their class name.
        """
        doc = {
            "artifact_schema": ARTIFACT_SCHEMA,
            "trace_code_version": _driver.TRACE_CODE_VERSION,
            "port": PORT_MARKER,
        }
        content = getattr(spec, "content_key", None)
        if callable(content):
            doc["content"] = content()
            return json.dumps(doc, sort_keys=True)
        doc["spec"] = dataclasses.asdict(spec)
        direction = kernel_traits(spec.kernel).direction
        if direction != "push":
            doc["direction"] = direction
        if type(spec) is not WorkloadSpec:
            doc["spec_type"] = type(spec).__name__
        return json.dumps(doc, sort_keys=True)

    def path_for(self, spec: WorkloadSpec) -> Path:
        if getattr(spec, "is_sharded", False):
            return self.manifest_path(spec)
        digest = hashlib.sha256(self.key(spec).encode()).hexdigest()[:20]
        # ``g`` marks a graph-content digest: identical content, one file.
        tag = "g" if callable(getattr(spec, "content_key", None)) else ""
        return self.root / f"{spec.kernel}_{spec.dataset}_s{spec.seed}_{tag}{digest}.npz"

    def has(self, spec: WorkloadSpec) -> bool:
        """Cheap presence + integrity probe (no array decompression).

        Reads only the zip central directory, at the end of the file, so a
        truncated write reads as absent, and the scheduler, which splits
        only materialized workloads, never fans a doomed load out.  Sharded
        specs check the manifest (written last, the commit point) and every
        shard file it names.
        """
        if getattr(spec, "is_sharded", False):
            manifest = self.load_manifest(spec)
            if manifest is None:
                return False
            return all(
                self.shard_path(spec, i).exists()
                for i in range(len(manifest["shard_sizes"]))
            )
        try:
            with zipfile.ZipFile(self.path_for(spec)) as z:
                return "meta.npy" in z.namelist()  # np.savez appends .npy
        except (OSError, zipfile.BadZipFile):
            return False

    # ---------------------------------------------- measured-cost sidecar
    #
    # Workers and the serial runner record measured build/score seconds
    # next to each artifact; the scheduler's cost model prefers them to its
    # per-access constants (``scheduler.estimate_cost``).  The sidecar
    # shares the artifact's digest, so whatever moves the artifact key
    # orphans the stale timings with it.

    def cost_path(self, spec) -> Path:
        return self.path_for(spec).with_suffix(".cost.json")

    def load_cost(self, spec) -> Optional[dict]:
        """Measured timings for ``spec``: ``{"build_s": float,
        "score_s_per_prefetcher": float}`` (either key may be absent), or
        None when nothing was recorded (unreadable == absent)."""
        try:
            with open(self.cost_path(spec)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        return doc if isinstance(doc, dict) else None

    def record_cost(self, spec, **seconds: float) -> None:
        """Merge measured timing fields into ``spec``'s cost sidecar.

        The latest measurement wins per field; the write is atomic and a
        failure is swallowed: a missing sidecar only costs the scheduler
        its constant-based estimate.
        """
        doc = self.load_cost(spec) or {}
        doc.update({k: float(v) for k, v in seconds.items()})
        try:
            self.root.mkdir(parents=True, exist_ok=True)
            _atomic_write(
                self.root, self.cost_path(spec), "w",
                lambda f: json.dump(doc, f, sort_keys=True),
            )
        except OSError:
            pass

    # ---------------------------------------------- sharded trace store
    #
    # Shard ``i`` is keyed on sha256(key(spec) + "#shard" + i): the spec
    # identity (shard size and port marker included) plus the index.  The
    # manifest, keyed on the spec alone, is written after every shard, so
    # a build killed midway reads as absent.

    def _shard_digest(self, spec, index: Optional[int] = None) -> str:
        doc = self.key(spec)
        if index is not None:
            doc = f"{doc}#shard{index}"
        return hashlib.sha256(doc.encode()).hexdigest()[:20]

    def manifest_path(self, spec) -> Path:
        name = (
            f"{spec.kernel}_{spec.dataset}_s{spec.seed}"
            f"_{self._shard_digest(spec)}.manifest.json"
        )
        return self.root / name

    def shard_path(self, spec, index: int) -> Path:
        name = (
            f"{spec.kernel}_{spec.dataset}_s{spec.seed}"
            f"_k{index}_{self._shard_digest(spec, index)}.npz"
        )
        return self.root / name

    def load_manifest(self, spec) -> Optional[dict]:
        try:
            with open(self.manifest_path(spec)) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None
        if manifest.get("schema") != ARTIFACT_SCHEMA:
            return None
        return manifest

    def save_manifest(self, spec, manifest: dict) -> Path:
        path = self.manifest_path(spec)
        self.root.mkdir(parents=True, exist_ok=True)
        doc = {"schema": ARTIFACT_SCHEMA, **manifest}
        _atomic_write(
            self.root, path, "w", lambda f: json.dump(doc, f, sort_keys=True)
        )
        return path

    def save_shard(self, spec, index: int, arrays: dict) -> Path:
        path = self.shard_path(spec, index)
        self.root.mkdir(parents=True, exist_ok=True)
        _atomic_write(
            self.root, path, "wb", lambda f: np.savez_compressed(f, **arrays)
        )
        self.saves += 1
        return path

    def load_shard(self, spec, index: int) -> dict:
        with np.load(self.shard_path(spec, index), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def load(self, spec: WorkloadSpec, device: DeviceLike = None) -> Optional[WorkloadTrace]:
        """The cached trace for ``spec`` with its profile on ``device``
        (default the CUDA card), or None (unreadable == miss)."""
        dev = resolve_device(device)
        path = self.path_for(spec)
        with obs.span("artifact_load", cache_key=path.name) as sp:
            try:
                with np.load(path, allow_pickle=False) as z:
                    trace = _unpack(spec, z, dev)
            except Exception:
                self.misses += 1
                obs.inc("artifact_cache.misses")
                if sp:
                    sp.attrs["hit"] = False
                return None
            self.loads += 1
            obs.inc("artifact_cache.hits")
            if sp:
                sp.attrs["hit"] = True
            return trace

    def save(self, spec: WorkloadSpec, trace: WorkloadTrace) -> Path:
        """Persist ``trace`` atomically; returns the artifact path."""
        path = self.path_for(spec)
        self.root.mkdir(parents=True, exist_ok=True)
        with obs.span("artifact_save", cache_key=path.name):
            _atomic_write(
                self.root, path, "wb",
                lambda f: np.savez_compressed(f, **_pack(trace)),
            )
            self.saves += 1
            obs.inc("artifact_cache.saves")
            return path


def _atomic_write(root: Path, path: Path, mode: str, write) -> None:
    """``write(f)`` into a temp file under ``root``, then ``os.replace`` it
    onto ``path``: readers see the old file or the whole new one."""
    fd, tmp = tempfile.mkstemp(dir=root, suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _pack(trace: WorkloadTrace) -> dict:
    o = trace.nl_outcome
    meta = {
        "schema": ARTIFACT_SCHEMA,
        "kernel": trace.kernel,
        "dataset": trace.dataset,
        "num_vertices": trace.cfg_trace.num_vertices,
        "num_edges": trace.cfg_trace.num_edges,
        "base": trace.cfg_trace.base,
        "eval_from_pos": trace.eval_from_pos,
        "nl_evicted_early_total": o.evicted_early_total,
        "nl_metadata_bytes": o.metadata_bytes,
    }
    arrays = dict(
        meta=json.dumps(meta, sort_keys=True),
        block=trace.block,
        array_id=trace.array_id,
        epoch_id=trace.epoch_id,
        iter_id=trace.iter_id,
        elem=trace.elem,
        iter_epochs=np.asarray(trace.iter_epochs, dtype=np.int64).reshape(-1, 2),
        l1_hit=trace.profile.l1_hit,
        l2_hit=trace.profile.l2_hit,
        llc_hit=trace.profile.llc_hit,
        nl_blocks=trace.nl_blocks,
        nl_pos=trace.nl_pos,
    )
    for field in _OUTCOME_ARRAYS:
        arrays[f"o_{field}"] = getattr(o, field)
    return arrays


def _unpack(spec: WorkloadSpec, z, device) -> WorkloadTrace:
    meta = json.loads(str(z["meta"][()]))
    if meta.get("schema") != ARTIFACT_SCHEMA:
        raise ValueError(f"artifact schema {meta.get('schema')!r}")

    block = z["block"]
    iter_id = z["iter_id"]
    l1_hit = z["l1_hit"]
    # The L2 substream is derived exactly as simulate_demand derives it.
    l2_pos = np.flatnonzero(~l1_hit).astype(np.int64)
    profile = DemandProfile(
        blocks=block,
        iter_id=iter_id,
        l1_hit=l1_hit,
        l2_pos=l2_pos,
        l2_blocks=block[l2_pos],
        l2_iter=iter_id[l2_pos],
        l2_hit=z["l2_hit"],
        llc_hit=z["llc_hit"],
        cfg=spec.hierarchy,
        device=device,
    )
    outcome = PrefetchOutcome(
        evicted_early_total=meta["nl_evicted_early_total"],
        metadata_bytes=meta["nl_metadata_bytes"],
        **{field: z[f"o_{field}"] for field in _OUTCOME_ARRAYS},
    )
    cfg_trace = TraceConfig(
        num_vertices=meta["num_vertices"],
        num_edges=meta["num_edges"],
        base=meta["base"],
    )
    return WorkloadTrace(
        spec=spec,
        kernel=meta["kernel"],
        dataset=meta["dataset"],
        cfg_trace=cfg_trace,
        block=block,
        array_id=z["array_id"],
        epoch_id=z["epoch_id"],
        iter_id=iter_id,
        elem=z["elem"],
        iter_epochs=[(int(a), int(b)) for a, b in z["iter_epochs"]],
        profile=profile,
        nl_blocks=z["nl_blocks"],
        nl_pos=z["nl_pos"],
        nl_outcome=outcome,
        eval_from_pos=meta["eval_from_pos"],
        session=make_session(spec, cfg_trace),
    )


__all__ = [
    "ARTIFACT_SCHEMA",
    "ArtifactCache",
    "ENV_VAR",
    "PORT_MARKER",
    "default_cache_dir",
]
