"""Observability: the control-plane journal.

The JAX package's span tracing, metrics registry and critical-path
attribution are not ported yet.
"""

from repro_torch.obs.journal import Journal, JournalRecord

__all__ = ["Journal", "JournalRecord"]
