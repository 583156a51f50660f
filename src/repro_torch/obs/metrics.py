"""Metrics registry: counter/gauge/histogram primitives with label sets.

Each deployment owns one :class:`MetricsRegistry`.  Components update
instruments directly on the hot path (engines count
completions/failures/requeues and observe latencies), and
``Deployment.metrics()`` additionally mirrors its assembled JSON payload
into gauges via :meth:`MetricsRegistry.ingest` -- so
:meth:`MetricsRegistry.snapshot` is the one schema-validated superset
view while the legacy payload shape stays byte-identical on top of it.

Everything recorded here must be a finite native number derived from the
virtual clock / request counts -- :meth:`snapshot` validates this, so a
wall-clock read or a NaN sneaking into the registry fails loudly instead
of silently breaking same-seed determinism.
"""

from __future__ import annotations

import math

from repro_torch.obs.stats import percentile


class SnapshotSchemaError(ValueError):
    """A registry snapshot violates the metrics schema."""


def _labelkey(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically non-decreasing count."""

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = {str(k): str(v) for k, v in labels.items()}
        self.value = 0

    def inc(self, by: int | float = 1) -> None:
        if by < 0:
            raise ValueError(f"counter {self.name} cannot decrease (by={by})")
        self.value += by


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = {str(k): str(v) for k, v in labels.items()}
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value


class Histogram:
    """Streaming distribution: count/sum/min/max + retained observations
    for nearest-rank percentiles (bounded; oldest dropped past the cap)."""

    def __init__(self, name: str, labels: dict, *, keep: int = 4096):
        self.name = name
        self.labels = {str(k): str(v) for k, v in labels.items()}
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self._keep = int(keep)
        self._obs: list[float] = []

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        self._obs.append(value)
        if len(self._obs) > self._keep:
            del self._obs[: len(self._obs) - self._keep]

    def quantile(self, q: float) -> float:
        return percentile(sorted(self._obs), q)


class MetricsRegistry:
    """One deployment-wide home for every instrument."""

    def __init__(self):
        self._counters: dict[tuple, Counter] = {}
        self._gauges: dict[tuple, Gauge] = {}
        self._histograms: dict[tuple, Histogram] = {}

    # -- instrument accessors (create on first use) ------------------------
    def counter(self, name: str, **labels) -> Counter:
        key = (name, _labelkey(labels))
        if key not in self._counters:
            self._counters[key] = Counter(name, labels)
        return self._counters[key]

    def gauge(self, name: str, **labels) -> Gauge:
        key = (name, _labelkey(labels))
        if key not in self._gauges:
            self._gauges[key] = Gauge(name, labels)
        return self._gauges[key]

    def histogram(self, name: str, **labels) -> Histogram:
        key = (name, _labelkey(labels))
        if key not in self._histograms:
            self._histograms[key] = Histogram(name, labels)
        return self._histograms[key]

    # -- payload mirroring -------------------------------------------------
    def ingest(self, prefix: str, payload) -> None:
        """Mirror every numeric leaf of a metrics payload into gauges.

        The gauge name is the dotted path (list indices become an ``i``
        label component), so the registry snapshot subsumes the legacy
        ``metrics()`` dict without changing its shape.
        """
        def walk(value, path):
            if isinstance(value, dict):
                for k, v in value.items():
                    walk(v, f"{path}.{k}")
            elif isinstance(value, (list, tuple)):
                for i, v in enumerate(value):
                    walk(v, f"{path}[{i}]")
            elif isinstance(value, bool) or value is None or isinstance(value, str):
                return
            elif isinstance(value, (int, float)):
                if isinstance(value, float) and not math.isfinite(value):
                    return
                self.gauge(path).set(value)

        walk(payload, prefix)

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """One schema-validated export of every instrument."""
        snap = {
            "counters": [
                {"name": c.name, "labels": c.labels, "value": c.value}
                for _, c in sorted(self._counters.items())
            ],
            "gauges": [
                {"name": g.name, "labels": g.labels, "value": g.value}
                for _, g in sorted(self._gauges.items())
            ],
            "histograms": [
                {"name": h.name, "labels": h.labels, "count": h.count,
                 "sum": h.sum, "min": h.min if h.min is not None else 0.0,
                 "max": h.max if h.max is not None else 0.0,
                 "p50": h.quantile(0.50), "p95": h.quantile(0.95),
                 "p99": h.quantile(0.99)}
                for _, h in sorted(self._histograms.items())
            ],
        }
        validate_snapshot(snap)
        return snap

    def summary(self) -> dict:
        """Tiny digest for embedding in metrics payloads."""
        return {"counters": len(self._counters), "gauges": len(self._gauges),
                "histograms": len(self._histograms)}


def validate_snapshot(snap: dict) -> None:
    """Schema check: str names, str->str labels, finite native numbers."""
    for family in ("counters", "gauges", "histograms"):
        entries = snap.get(family)
        if not isinstance(entries, list):
            raise SnapshotSchemaError(f"{family} must be a list")
        for e in entries:
            if not isinstance(e.get("name"), str) or not e["name"]:
                raise SnapshotSchemaError(f"{family} entry without a name: {e!r}")
            labels = e.get("labels")
            if not isinstance(labels, dict) or any(
                    not isinstance(k, str) or not isinstance(v, str)
                    for k, v in labels.items()):
                raise SnapshotSchemaError(
                    f"{family} entry {e['name']}: labels must be str->str")
            for k, v in e.items():
                if k in ("name", "labels"):
                    continue
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise SnapshotSchemaError(
                        f"{family} entry {e['name']}.{k}: non-numeric {v!r}")
                if isinstance(v, float) and not math.isfinite(v):
                    raise SnapshotSchemaError(
                        f"{family} entry {e['name']}.{k}: non-finite value")
