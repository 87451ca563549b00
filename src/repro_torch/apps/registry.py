"""First-class kernel registry: the declarative half of the apps layer.

The paper's workloads are Ligra kernels, and each one carries protocol
metadata that used to live as string special-cases scattered through the
driver and the stream protocol: whether the input graph is weighted
(``kernel == "bellmanford"``), whether the paper's two-run evolving
protocol applies (``TWO_RUN_KERNELS``), whether a traversal root must be
shared across runs, and which traversal directions the kernel supports.
Here those properties are carried as a declarative :class:`KernelSpec`
attached at definition site, mirroring the prefetcher registry
(:mod:`repro_torch.core.registry`):

    @register_kernel(
        "pgd", epoch_protocol="per_iteration", directions=("push", "pull"),
    )
    def pagerank_delta(graph, *, direction="push", ...) -> AppRun: ...

Direction *variants* register the same implementation under a new name with
a different default traversal mode — this is how the direction-optimizing
BFS and the pull-mode PageRankDelta become first-class grid scenarios:

    register_kernel_variant("bfs_do", base="bfs", direction="auto")

Lookup is by name (``get_kernel("bfs_do")``); the workload driver, the
experiment builder, the stream protocol, and the artifact cache all
dispatch on the spec's metadata instead of on kernel-name strings.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict, List, Optional, Tuple

# Traversal directions a kernel step can run in.  "push" is Ligra's sparse
# EDGEMAP (iterate out-edges of active sources), "pull" its dense EDGEMAP
# (iterate in-edges of every destination), "auto" the direction-optimizing
# frontier-threshold switch between the two.
DIRECTIONS = ("push", "pull", "auto")

# AMC epoch protocols (paper §VI): "per_iteration" gives each kernel
# iteration its own epoch (PGD/CC); "per_run" runs the kernel twice on an
# evolving input pair, one epoch per run, evaluating the second (BFS/BF).
EPOCH_PROTOCOLS = ("per_iteration", "per_run")


class DuplicateKernelError(ValueError):
    """A kernel name was registered twice without ``replace=True``."""


class UnknownKernelError(KeyError):
    """Requested kernel name is not in the registry."""


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Declarative description of one graph kernel.

    ``fn`` is the kernel implementation ``(graph, **kw) -> AppRun``;
    :meth:`run` applies the spec's traversal ``direction`` and threads the
    present-mask / shared-root protocol arguments the metadata calls for.
    A *variant* spec (``bfs_do``, ``pgd_pull``) shares its base kernel's
    ``fn`` and differs only in ``direction``.
    """

    name: str
    fn: Callable
    weighted: bool = False  # input graph carries edge weights (BellmanFord)
    epoch_protocol: str = "per_iteration"
    directions: Tuple[str, ...] = ("push",)  # modes the implementation supports
    direction: str = "push"  # mode this spec runs in
    needs_root: bool = False  # traversal kernel: share one root across runs
    description: str = ""

    def __post_init__(self):
        if self.epoch_protocol not in EPOCH_PROTOCOLS:
            raise ValueError(
                f"epoch_protocol must be one of {EPOCH_PROTOCOLS}; "
                f"got {self.epoch_protocol!r}"
            )
        bad = set(self.directions) - set(DIRECTIONS)
        if bad or not self.directions:
            raise ValueError(
                f"directions must be a non-empty subset of {DIRECTIONS}; "
                f"got {self.directions!r}"
            )
        if self.direction not in self.directions:
            raise ValueError(
                f"direction {self.direction!r} not among supported "
                f"directions {self.directions!r}"
            )

    @property
    def two_run(self) -> bool:
        """The §VI two-run evolving protocol applies to this kernel."""
        return self.epoch_protocol == "per_run"

    def run(self, graph, present_mask=None, root=None, **overrides):
        """Run the kernel on ``graph`` under this spec's protocol.

        ``present_mask`` and ``root`` are threaded only when given /
        relevant, so push-only kernels registered without those parameters
        keep working.
        """
        kw = dict(overrides)
        if present_mask is not None:
            kw["present_mask"] = present_mask
        if self.needs_root and root is not None:
            kw["root"] = root
        if self.directions != ("push",):
            kw.setdefault("direction", self.direction)
        return self.fn(graph, **kw)


_REGISTRY: Dict[str, KernelSpec] = {}
_BUILTINS_LOADED = False  # False | "loading" | True


def _ensure_builtins_loaded() -> None:
    """Import the kernel modules so their decorators have run."""
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:  # True, or "loading" during the import below
        return
    _BUILTINS_LOADED = "loading"
    before = set(_REGISTRY)
    modules_before = set(sys.modules)
    try:
        # Each kernel module self-registers at import time (including the
        # direction variants declared next to their base kernels): the
        # paper's four Ligra kernels, as in the JAX package.
        import repro_torch.apps.pagerank_delta  # noqa: F401
        import repro_torch.apps.connected_components  # noqa: F401
        import repro_torch.apps.bfs  # noqa: F401
        import repro_torch.apps.bellman_ford  # noqa: F401
    except BaseException:
        # Roll back this attempt's registrations and evict the modules it
        # imported, so a retry re-executes the decorators instead of dying
        # on DuplicateKernelError or silently losing kernels.
        for name in set(_REGISTRY) - before:
            del _REGISTRY[name]
        for mod in set(sys.modules) - modules_before:
            if mod.startswith("repro_torch.apps."):
                del sys.modules[mod]
        _BUILTINS_LOADED = False
        raise
    _BUILTINS_LOADED = True


def register_kernel(
    name: str,
    *,
    weighted: bool = False,
    epoch_protocol: str = "per_iteration",
    directions: Tuple[str, ...] = ("push",),
    direction: str = "push",
    needs_root: bool = False,
    description: Optional[str] = None,
    replace: bool = False,
) -> Callable:
    """Decorator: register ``fn`` under ``name`` with its declarative spec.

    The decorated function is returned unchanged (with a ``.kernel_spec``
    attribute), so plain-function call sites keep working.
    """

    def decorate(fn: Callable) -> Callable:
        _ensure_builtins_loaded()
        if name in _REGISTRY and not replace:
            raise DuplicateKernelError(
                f"kernel {name!r} already registered "
                f"(by {_REGISTRY[name].fn!r}); pass replace=True to override"
            )
        desc = description
        if desc is None:
            doc_lines = (fn.__doc__ or "").strip().splitlines()
            desc = doc_lines[0] if doc_lines else ""
        spec = KernelSpec(
            name=name,
            fn=fn,
            weighted=weighted,
            epoch_protocol=epoch_protocol,
            directions=tuple(directions),
            direction=direction,
            needs_root=needs_root,
            description=desc,
        )
        _REGISTRY[name] = spec
        fn.kernel_spec = spec
        return fn

    return decorate


def register_kernel_variant(
    name: str,
    base: str,
    *,
    direction: str,
    description: str = "",
    replace: bool = False,
) -> KernelSpec:
    """Register ``base``'s implementation under a new name with a different
    default traversal direction (e.g. ``bfs_do`` = ``bfs`` with the
    direction-optimizing switch).  Protocol metadata is inherited."""
    b = get_kernel(base)
    if name in _REGISTRY and not replace:
        raise DuplicateKernelError(
            f"kernel {name!r} already registered; pass replace=True to override"
        )
    spec = dataclasses.replace(
        b,
        name=name,
        direction=direction,
        description=description or f"{b.description} [{direction} traversal]",
    )
    _REGISTRY[name] = spec
    return spec


def get_kernel(name: str) -> KernelSpec:
    """Look up a registered kernel spec by name."""
    _ensure_builtins_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownKernelError(
            f"unknown kernel {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def has_kernel(name: str) -> bool:
    _ensure_builtins_loaded()
    return name in _REGISTRY


def list_kernels() -> List[str]:
    """All registered names, in registration order."""
    _ensure_builtins_loaded()
    return list(_REGISTRY)


def kernel_traits(name: str) -> KernelSpec:
    """The spec for ``name``, or a default push/per-iteration spec for
    ad-hoc names (the driver allows caller-supplied runs under a purely
    descriptive kernel name — those get the plain protocol, exactly what
    unknown names got under the old string checks)."""
    _ensure_builtins_loaded()
    spec = _REGISTRY.get(name)
    if spec is None:
        return KernelSpec(name=name, fn=_no_kernel)
    return spec


def _no_kernel(graph, **kw):  # pragma: no cover - traits-only placeholder
    raise UnknownKernelError("ad-hoc kernel spec has no implementation")


__all__ = [
    "DIRECTIONS",
    "EPOCH_PROTOCOLS",
    "DuplicateKernelError",
    "KernelSpec",
    "UnknownKernelError",
    "get_kernel",
    "has_kernel",
    "kernel_traits",
    "list_kernels",
    "register_kernel",
    "register_kernel_variant",
]
