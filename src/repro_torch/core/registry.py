"""Shared registry machinery for named, discoverable components.

Three subsystems keep a name -> implementation table with the same
behaviours: self-registration via a decorator, did-you-mean lookup errors,
a single optional default listed first, and lazy import of the defining
module so enumeration works no matter which side was imported first.  They
used to be three copy-pasted implementations (``api/registry.py`` for
strategies, ``dataplane/registry.py`` for codecs, ``workload`` for traces);
this module is the one implementation they now share.

The public modules keep their existing names and error types
(``UnknownStrategyError``, ``UnknownCodecError``, ``UnknownTraceError``) --
those are thin subclasses of :class:`UnknownNameError` that preserve each
registry's historical message format, so callers and tests are unaffected.
"""

from __future__ import annotations

import difflib
from typing import Callable, Iterable


def suggest(name: str, known: Iterable[str], *, n: int = 3,
            cutoff: float = 0.4) -> tuple[str, ...]:
    """Close matches for a misspelled name (the did-you-mean candidates)."""
    return tuple(difflib.get_close_matches(name, list(known), n=n, cutoff=cutoff))


def unknown_message(subject: str, name: str, known: Iterable[str],
                    suggestions: tuple[str, ...], *,
                    style: str = "suffix") -> str:
    """Render an unknown-name message in one of the two historical formats.

    ``suffix``  -- "unknown codec 'x'; registered: a, b (did you mean 'a'?)"
    ``inline``  -- "unknown trace 'x' -- did you mean 'a'? (registered: a, b)"
    """
    known = list(known)
    if style == "inline":
        hint = (f" -- did you mean {', '.join(repr(c) for c in suggestions)}?"
                if suggestions else "")
        return f"unknown {subject} {name!r}{hint} (registered: {', '.join(known)})"
    msg = f"unknown {subject} {name!r}; registered: {', '.join(known)}"
    if suggestions:
        msg += f" (did you mean {' or '.join(map(repr, suggestions))}?)"
    return msg


class UnknownNameError(KeyError):
    """Base for registry lookup failures; carries name/known/suggestions."""

    def __init__(self, msg: str, *, name: str, known: Iterable[str],
                 suggestions: tuple[str, ...]):
        super().__init__(msg)
        self.name = name
        self.known = tuple(known)
        self.suggestions = suggestions

    def __str__(self) -> str:  # KeyError.__str__ repr-quotes; keep it readable
        return self.args[0]


class Registry:
    """One name -> value table with defaults, lazy imports, and rich errors.

    Parameters
    ----------
    subject:
        Human-readable noun for messages ("codec", "partitioner strategy").
    ensure:
        Zero-arg callable that imports the module(s) whose decorators
        populate this registry; invoked lazily before every read.
    error:
        ``(name, known) -> Exception`` factory for unknown-name lookups.
        Defaults to a plain :class:`UnknownNameError` in ``suffix`` style.
    allow_overwrite:
        When False (the default), re-registering a name raises ``ValueError``
        ("duplicate ..."); the trace registry historically allows overwrite.
    """

    def __init__(self, subject: str, *,
                 ensure: Callable[[], None] | None = None,
                 error: Callable[[str, tuple[str, ...]], Exception] | None = None,
                 allow_overwrite: bool = False):
        self.subject = subject
        self._ensure = ensure
        self._error = error
        self._allow_overwrite = allow_overwrite
        self._items: dict[str, object] = {}
        self._default: str | None = None

    # -- writes ------------------------------------------------------------

    def register(self, name: str, value, *, default: bool = False):
        if name in self._items and not self._allow_overwrite:
            raise ValueError(f"duplicate {self.subject} {name!r}")
        self._items[name] = value
        if default:
            if self._default is not None and self._default != name:
                raise ValueError(
                    f"conflicting defaults for {self.subject}: "
                    f"{self._default!r}, {name!r}")
            self._default = name
        return value

    # -- reads -------------------------------------------------------------

    def ensure(self) -> None:
        """Run the lazy-import hook (idempotent: imports cache themselves)."""
        if self._ensure is not None:
            self._ensure()

    def get(self, name: str):
        self.ensure()
        try:
            return self._items[name]
        except KeyError:
            known = self.names()
            if self._error is not None:
                raise self._error(name, known) from None
            raise UnknownNameError(
                unknown_message(self.subject, name, known, suggest(name, known)),
                name=name, known=known, suggestions=suggest(name, known),
            ) from None

    def names(self) -> tuple[str, ...]:
        """Registered names, sorted (the default, if any, first)."""
        self.ensure()
        names = sorted(self._items)
        if self._default in names:
            names.remove(self._default)
            names.insert(0, self._default)
        return tuple(names)

    def default(self) -> str | None:
        """The name used when a spec leaves the field unset."""
        self.ensure()
        return self._default

    def __contains__(self, name: str) -> bool:
        self.ensure()
        return name in self._items
