"""Codec registry: named, discoverable inter-stage transfer codecs.

Mirrors ``repro_torch.api.registry`` (the partitioner/placer registry): every codec
the data plane can put on a link self-registers by name via the
``@register_codec(name)`` decorator applied at its definition site
(``dataplane/codecs.py``).  The registry is the single source of truth for

  * which codecs exist (``list_codecs()``),
  * which one a ``DeploymentSpec.codec`` name means (``get_codec``), and
  * what rides a link when no codec is named (``default_codec`` --
    ``identity``, the uncompressed wire format every PR before this one
    implicitly used).

Unknown names raise ``UnknownCodecError`` carrying did-you-mean suggestions,
so a typo in a spec fails at validation time with a readable message instead
of deep inside the serving engine.

The table mechanics are the shared ``repro_torch.core.registry`` helper; this
module keeps the codec-specific surface (instance storage, the ``auto``
sentinel, and the historical error type).
"""

from __future__ import annotations

from repro_torch.core.registry import (
    Registry,
    UnknownNameError,
    suggest,
    unknown_message,
)

AUTO = "auto"  # spec sentinel: the planner picks the codec per link


class UnknownCodecError(UnknownNameError):
    """Raised for a codec name not in the registry; carries suggestions."""

    def __init__(self, name: str, known: tuple[str, ...]):
        suggestions = suggest(name, known)
        super().__init__(
            unknown_message("codec", name, known, suggestions),
            name=name, known=known, suggestions=suggestions,
        )


def _ensure_registered() -> None:
    """Import the codec module so its decorators have run."""
    import repro_torch.dataplane.codecs  # noqa: F401


_REGISTRY = Registry(
    "codec",
    ensure=_ensure_registered,
    error=UnknownCodecError,
)


def register_codec(name: str, *, default: bool = False):
    """Class decorator: register one instance of ``cls`` as codec ``name``.

    Codecs are stateless singletons (their parameters -- block size, keep
    fraction -- are class-level configuration), so the registry stores an
    instance, not the class.
    """

    def deco(cls):
        inst = cls()
        inst.name = name
        _REGISTRY.register(name, inst, default=default)
        return cls

    return deco


def get_codec(name: str):
    """Look up a codec by name; unknown names raise with suggestions."""
    return _REGISTRY.get(name)


def list_codecs() -> tuple[str, ...]:
    """Registered codec names, sorted (default first)."""
    return _REGISTRY.names()


def default_codec() -> str:
    """The codec used when a spec leaves ``codec`` unset."""
    return _REGISTRY.default()


def codec_table() -> list[dict[str, str]]:
    """All registered codecs as rows (name/ratio/error/description)."""
    rows = []
    for name in list_codecs():
        c = _REGISTRY.get(name)
        rows.append({
            "name": name,
            "default": "yes" if default_codec() == name else "",
            "wire_ratio_f32": f"{c.wire_ratio():.3f}",
            "error_bound": f"{c.error_bound:.3g}",
            "description": type(c).__doc__.splitlines()[0] if type(c).__doc__ else "",
        })
    return rows
