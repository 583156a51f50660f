"""Strategy registry: named, discoverable partition/placement/joint algorithms.

Every algorithm that the declarative API can invoke self-registers here by
name via the ``@register_strategy(kind, name)`` decorator applied at its
definition site (``core/partitioner.py``, ``core/placement.py``,
``core/joint.py``).  The registry is the single source of truth for

  * which strategies exist (``list_strategies(kind)``),
  * which one a ``DeploymentSpec`` means by a name (``get_strategy``), and
  * what runs when no name is given (``default_strategy`` -- the paper's
    pipeline: ``min_bottleneck`` partitioning + ``color_coding`` placement).

Unknown names raise ``UnknownStrategyError`` carrying did-you-mean
suggestions, so a typo in a spec fails at validation time with a readable
message instead of deep inside placement.

The table mechanics (defaults-first listing, duplicate rejection, lazy
import of the registering modules, suggestion rendering) live in the shared
``repro_torch.core.registry`` helper; this module keeps the strategy-specific
surface: the ``kind`` axis, the ``Strategy`` dataclass, and the historical
error type and message format.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.registry import (
    Registry,
    UnknownNameError,
    suggest,
    unknown_message,
)

KINDS = ("partitioner", "placer", "joint")


@dataclasses.dataclass(frozen=True)
class Strategy:
    """One registered algorithm: callable + metadata for specs/docs/CLI."""

    kind: str
    name: str
    fn: Callable
    description: str = ""
    default: bool = False

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


class UnknownStrategyError(UnknownNameError):
    """Raised for a name not in the registry; carries suggestions."""

    def __init__(self, kind: str, name: str, known: tuple[str, ...]):
        suggestions = suggest(name, known)
        super().__init__(
            unknown_message(f"{kind} strategy", name, known, suggestions),
            name=name, known=known, suggestions=suggestions,
        )
        self.kind = kind


def _ensure_registered() -> None:
    """Import the algorithm modules so their decorators have run."""
    import repro_torch.core.joint  # noqa: F401
    import repro_torch.core.partitioner  # noqa: F401
    import repro_torch.core.placement  # noqa: F401


_REGISTRIES: dict[str, Registry] = {
    kind: Registry(
        f"{kind} strategy",
        ensure=_ensure_registered,
        error=lambda name, known, kind=kind: UnknownStrategyError(
            kind, name, known),
    )
    for kind in KINDS
}


def _registry(kind: str) -> Registry:
    if kind not in KINDS:
        raise ValueError(f"unknown strategy kind {kind!r}; one of {KINDS}")
    return _REGISTRIES[kind]


def register_strategy(
    kind: str, name: str, *, default: bool = False, description: str = ""
) -> Callable[[Callable], Callable]:
    """Decorator: register ``fn`` as the ``kind`` strategy called ``name``."""
    reg = _registry(kind)

    def deco(fn: Callable) -> Callable:
        reg.register(name, Strategy(kind, name, fn, description, default),
                     default=default)
        return fn

    return deco


def get_strategy(kind: str, name: str) -> Strategy:
    """Look up a strategy by name; unknown names raise with suggestions."""
    return _registry(kind).get(name)


def list_strategies(kind: str) -> tuple[str, ...]:
    """Registered names for one kind, sorted (default first)."""
    return _registry(kind).names()


def default_strategy(kind: str) -> str:
    """The name used when a spec leaves the strategy unset."""
    return _registry(kind).default()


def strategy_table() -> list[dict[str, str]]:
    """All registered strategies as rows (kind/name/default/description)."""
    rows = []
    for kind in KINDS:
        reg = _registry(kind)
        for name in reg.names():
            s = reg.get(name)
            rows.append(
                {
                    "kind": kind,
                    "name": name,
                    "default": "yes" if s.default else "",
                    "description": s.description,
                }
            )
    return rows
