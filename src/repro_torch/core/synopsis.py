"""Synopsis protocol + runtime registry (port of ``repro/core/synopsis.py``).

A synopsis *kind* is a frozen dataclass holding static parameters (Table 1
of the paper) and exposing the paper's methods over tensors:

    init(device)                             -> state   (device required)
    add_batch(state, items, values, mask)    -> state   (in place)
    estimate(state, ...)                     -> estimation
    merge(a, b)                              -> state

Where the reference's methods are pure, the port's ``add_batch`` and
``stacked_add_batch`` update ``state`` in place and return it. The
registry is the reference's: ``make_kind`` raises ``KeyError`` for an
unknown name, which the engine turns into an ``ok=False`` response.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Protocol, runtime_checkable


@runtime_checkable
class Synopsis(Protocol):
    """Structural protocol every synopsis kind satisfies."""

    def init(self, device) -> Any: ...

    def add_batch(self, state: Any, items: Any, values: Any,
                  mask: Any) -> Any: ...

    def estimate(self, state: Any, *args: Any) -> Any: ...

    def merge(self, a: Any, b: Any) -> Any: ...


_REGISTRY: Dict[str, Callable[..., Synopsis]] = {}

# name -> concrete type the factory produced (filled lazily by make_kind):
# a factory may be any callable, so name_of_kind needs the produced type
_PRODUCED_TYPES: Dict[str, type] = {}


def register_kind(name: str, factory: Callable[..., Synopsis],
                  *, overwrite: bool = False) -> None:
    """Register a synopsis kind at runtime (paper: Load Synopsis request)."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"synopsis kind {name!r} already registered")
    _REGISTRY[name] = factory
    _PRODUCED_TYPES.pop(name, None)


def make_kind(name: str, **params: Any) -> Synopsis:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown synopsis kind {name!r}; known: {sorted(_REGISTRY)}")
    kind = _REGISTRY[name](**params)
    _PRODUCED_TYPES[name] = type(kind)
    return kind


def known_kinds() -> list[str]:
    return sorted(_REGISTRY)


def kind_params(kind: Synopsis) -> Dict[str, Any]:
    """Static parameters of a kind (for SDE Status reports)."""
    if dataclasses.is_dataclass(kind):
        return {f.name: getattr(kind, f.name) for f in dataclasses.fields(kind)}
    return {}


def name_of_kind(kind: Synopsis) -> str:
    """Registry name of a kind instance: the class-registered name, else
    the type a (non-class) factory produced."""
    for name, factory in _REGISTRY.items():
        if factory is type(kind):
            return name
    for name, produced in _PRODUCED_TYPES.items():
        if produced is type(kind):
            return name
    raise KeyError(f"kind {type(kind).__name__} not in registry")
