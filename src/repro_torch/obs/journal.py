"""The control-plane journal: one append-only, monotonic event log.

Every control-plane decision lands here as a :class:`JournalRecord` --
reconcile actions (``ControlPlane.history``), scoped-recovery records
(``Dispatcher.last_recovery``) and tenancy routing
(``MultiTenantControlPlane.routed``) -- so a single ordered read
reconstructs the control-plane story of a run.

Timestamps come from registered virtual-clock providers (the serving
loops / router), clamped monotone non-decreasing: a record is stamped
``max(last_t, max(clocks))``, so the journal is totally ordered by
``(t_s, seq)`` even when multiple engines with skewed clocks share it
(multi-tenant deployments share one journal across tenants).

Only JSON-scalar detail values are accepted -- the journal is part of the
metrics surface and must survive ``normalize_metrics`` byte-identically
across same-seed runs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class JournalRecord:
    """One control-plane decision.

    ``kind`` is the decision class (``reconcile``, ``recovery``,
    ``route``, ...); ``source`` names the emitting component (``control``,
    ``alpha/control``, ``tenancy``...); ``detail`` is a flat JSON-scalar
    dict specific to the kind.
    """

    seq: int
    t_s: float
    kind: str
    source: str
    detail: dict

    def as_dict(self) -> dict:
        return {"seq": self.seq, "t_s": self.t_s, "kind": self.kind,
                "source": self.source, "detail": dict(self.detail)}


class Journal:
    """Append-only, monotonically-timestamped control-plane event log."""

    def __init__(self):
        self.records: list[JournalRecord] = []
        self._clocks: list = []  # callables -> current virtual time
        self._last_t = 0.0

    def bind_clock(self, clock) -> None:
        """Register a virtual-clock provider (callable -> seconds).

        Several providers may be registered (one per serving loop sharing
        the journal); records are stamped with the max across providers,
        clamped non-decreasing.
        """
        self._clocks.append(clock)

    def now(self) -> float:
        ts = [float(c()) for c in self._clocks]
        t = max(ts) if ts else self._last_t
        return max(t, self._last_t)

    def append(self, kind: str, source: str, detail: dict | None = None,
               *, t_s: float | None = None) -> JournalRecord:
        """Record a decision; returns the appended record.

        ``t_s`` overrides the clock when the caller knows the decision
        time precisely; it is still clamped monotone so the log stays
        ordered.
        """
        t = self.now() if t_s is None else max(float(t_s), self._last_t)
        self._last_t = t
        rec = JournalRecord(len(self.records), t, str(kind), str(source),
                            dict(detail or {}))
        self.records.append(rec)
        return rec

    # -- views -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.records)

    def select(self, kind: str | None = None,
               source: str | None = None) -> list[JournalRecord]:
        return [r for r in self.records
                if (kind is None or r.kind == kind)
                and (source is None or r.source == source)]

    def as_dicts(self) -> list[dict]:
        return [r.as_dict() for r in self.records]

    def summary(self) -> dict:
        """Metrics-payload digest: counts per kind + last stamp."""
        kinds: dict[str, int] = {}
        for r in self.records:
            kinds[r.kind] = kinds.get(r.kind, 0) + 1
        return {
            "records": len(self.records),
            "kinds": kinds,
            "last_t_s": self.records[-1].t_s if self.records else 0.0,
        }
