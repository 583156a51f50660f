"""The program's calls that a traced run records, with their arguments' shapes.

A per-layer metric that reads a kernel's roofline needs the shape of each
launch to count its work; the profiler names a kernel but not its shapes.
Its reader names the program's entry points it needs (``CALLS``, each
``"module:attribute"``, the attribute being a function the program looks up
at call time), and in a traced run ``record`` wraps each for the window: a
call appends ``(site, args, kwargs)``, tensors given by shape and element
size, then runs the original.  Outside a traced run nothing is wrapped.
"""

from __future__ import annotations

import contextlib
import importlib


def _describe(v):
    shape = getattr(v, "shape", None)
    if shape is not None and hasattr(v, "element_size"):
        return ("tensor", tuple(int(n) for n in shape), int(v.element_size()))
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)  # a dtype reads "torch.float32"


@contextlib.contextmanager
def record(sites, log: list):
    """Wrap every ``"module:attribute"`` of ``sites`` so that its calls are
    appended to ``log`` while the block runs."""
    saved = []
    try:
        for site in sorted(set(sites)):
            mod_name, attr = site.split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)

            def wrapper(*args, _orig=orig, _site=site, **kwargs):
                log.append((_site, tuple(_describe(a) for a in args),
                            {k: _describe(v) for k, v in kwargs.items()}))
                return _orig(*args, **kwargs)

            wrapper.__name__ = getattr(orig, "__name__", attr)
            setattr(mod, attr, wrapper)
            saved.append((mod, attr, orig))
        yield log
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)
