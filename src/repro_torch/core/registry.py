"""First-class prefetcher registry: the declarative half of the suite.

The paper compares AMC against seven prior prefetchers (Table I), each with
its own training stream, storage budget, and composite policy.  Those
properties used to live as prose in docstrings and as convention in a bare
``Dict[str, Callable]``; here they are carried as a declarative
:class:`PrefetcherSpec` attached at definition site:

    @register_prefetcher(
        "vldp", trains_on="l2_access", storage="on-chip delta tables",
        family="spatial",
    )
    def vldp(workload) -> PrefetchStream: ...

Configurable prefetchers (AMC) register a *factory* instead — a callable
taking config kwargs and returning a stream generator:

    @register_prefetcher("amc", trains_on="target_access+baseline_l2_miss",
                         configurable=True, ...)
    def amc(**overrides) -> Prefetcher:
        return AMCPrefetcher(AMCConfig(**overrides)).generate

Lookup is by name (``get_prefetcher("vldp")``), and the
:class:`~repro_torch.core.experiment.Experiment` builder resolves its
``prefetchers=[...]`` argument through :func:`resolve_prefetchers`.  The
built-in suite modules are imported lazily on first lookup, so importing
this module alone is enough to reach every registered prefetcher.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict, List, Optional, Protocol, Tuple, runtime_checkable


@runtime_checkable
class Prefetcher(Protocol):
    """A stream generator: ``WorkloadTrace -> PrefetchStream``.

    Every evaluated prefetcher — AMC and all baselines — reduces to this one
    callable shape; the registry layers metadata on top without changing it.
    """

    def __call__(self, workload) -> "PrefetchStream":  # noqa: F821
        ...


class DuplicatePrefetcherError(ValueError):
    """A prefetcher name was registered twice without ``replace=True``."""


class UnknownPrefetcherError(KeyError):
    """Requested prefetcher name is not in the registry."""


@dataclasses.dataclass(frozen=True)
class PrefetcherSpec:
    """Declarative description of one evaluated prefetcher.

    ``trains_on`` names the training stream (paper Table I): ``l2_access``
    (the L1-miss stream), ``l2_miss``, ``baseline_l2_miss`` (composite
    demand + next-line misses), ``software`` (programmer-marked), or
    ``oracle``.  ``composite`` marks whether the prefetcher is scored in the
    paper's composite (next-line + X) L2 configuration.
    """

    name: str
    fn: Callable  # generator itself, or a factory when ``configurable``
    trains_on: str
    storage: str = ""
    family: str = ""  # spatial | temporal | replay | dataflow | amc | bound
    composite: bool = True
    configurable: bool = False
    description: str = ""

    def instantiate(self, **overrides) -> Prefetcher:
        """Return a stream generator, applying config ``overrides``.

        Non-configurable prefetchers reject overrides loudly rather than
        silently ignoring them.
        """
        if self.configurable:
            return self.fn(**overrides)
        if overrides:
            raise TypeError(
                f"prefetcher {self.name!r} is not configurable; "
                f"got overrides {sorted(overrides)}"
            )
        return self.fn


_REGISTRY: Dict[str, PrefetcherSpec] = {}
_BUILTINS_LOADED = False  # False | "loading" | True


def _ensure_builtins_loaded() -> None:
    """Import the suite modules so their decorators have run."""
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:  # True, or "loading" during the import below
        return
    _BUILTINS_LOADED = "loading"
    before = set(_REGISTRY)
    modules_before = set(sys.modules)
    try:
        # repro_torch.core.prefetchers imports every baseline module and the AMC
        # pipeline, each of which self-registers at import time.
        import repro_torch.core.prefetchers  # noqa: F401
    except BaseException:
        # Roll back this attempt's registrations (a retry would otherwise
        # die on DuplicatePrefetcherError instead of the root cause) AND
        # evict the suite modules this attempt imported: modules that
        # succeeded stay cached in sys.modules, so without eviction a retry
        # would never re-execute their decorators and their prefetchers
        # would be unresolvable for the life of the process.
        for name in set(_REGISTRY) - before:
            del _REGISTRY[name]
        for mod in set(sys.modules) - modules_before:
            if mod.startswith("repro_torch.core."):
                del sys.modules[mod]
        _BUILTINS_LOADED = False
        raise
    _BUILTINS_LOADED = True


def register_prefetcher(
    name: str,
    *,
    trains_on: str,
    storage: str = "",
    family: str = "",
    composite: bool = True,
    configurable: bool = False,
    description: Optional[str] = None,
    replace: bool = False,
) -> Callable:
    """Decorator: register ``fn`` under ``name`` with its declarative spec.

    The decorated function is returned unchanged (with a ``.spec``
    attribute), so plain-function call sites keep working.
    """

    def decorate(fn: Callable) -> Callable:
        # Load the built-in suite first so a user registration colliding
        # with a builtin fails here, in the caller's frame, instead of
        # poisoning a later lazy import of the suite modules.
        _ensure_builtins_loaded()
        if name in _REGISTRY and not replace:
            raise DuplicatePrefetcherError(
                f"prefetcher {name!r} already registered "
                f"(by {_REGISTRY[name].fn!r}); pass replace=True to override"
            )
        desc = description
        if desc is None:
            doc_lines = (fn.__doc__ or "").strip().splitlines()
            desc = doc_lines[0] if doc_lines else ""
        spec = PrefetcherSpec(
            name=name,
            fn=fn,
            trains_on=trains_on,
            storage=storage,
            family=family,
            composite=composite,
            configurable=configurable,
            description=desc,
        )
        _REGISTRY[name] = spec
        fn.spec = spec
        return fn

    return decorate


def get_prefetcher(name: str) -> PrefetcherSpec:
    """Look up a registered prefetcher spec by name."""
    _ensure_builtins_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownPrefetcherError(
            f"unknown prefetcher {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def list_prefetchers() -> List[str]:
    """All registered names, in registration order."""
    _ensure_builtins_loaded()
    return list(_REGISTRY)


def resolve_prefetchers(refs) -> List[Tuple[str, Prefetcher]]:
    """Normalize an ``Experiment(prefetchers=...)`` argument.

    Accepts an iterable mixing registry names, :class:`PrefetcherSpec`
    instances, and ``(name, generator)`` pairs, or a ``{name: generator}``
    mapping.  Returns ordered ``(name, generator)`` pairs; duplicate names
    are rejected.
    """
    if isinstance(refs, str):  # a bare name would otherwise iterate per-char
        refs = [refs]
    elif hasattr(refs, "items"):
        refs = list(refs.items())
    out: List[Tuple[str, Prefetcher]] = []
    seen = set()
    for ref in refs:
        if isinstance(ref, str):
            pair = (ref, get_prefetcher(ref).instantiate())
        elif isinstance(ref, PrefetcherSpec):
            pair = (ref.name, ref.instantiate())
        elif isinstance(ref, tuple) and len(ref) == 2 and callable(ref[1]):
            pair = (str(ref[0]), ref[1])
        else:
            raise TypeError(
                "prefetcher reference must be a registry name, a "
                f"PrefetcherSpec, or a (name, generator) pair; got {ref!r}"
            )
        if pair[0] in seen:
            raise ValueError(f"duplicate prefetcher name {pair[0]!r} in experiment")
        seen.add(pair[0])
        out.append(pair)
    return out


__all__ = [
    "Prefetcher",
    "PrefetcherSpec",
    "DuplicatePrefetcherError",
    "UnknownPrefetcherError",
    "register_prefetcher",
    "get_prefetcher",
    "list_prefetchers",
    "resolve_prefetchers",
]
