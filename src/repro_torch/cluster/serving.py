"""Request-level serving records: ``Request``, latency statistics, metrics.

The paper's inference step (Sec. 2.3) is a continuous stream of requests
through the pod chain.  ``cluster.engine.PipelinedServingLoop`` serves that
stream; this module holds what it records: one ``Request`` per admitted
sample, the nearest-rank latency percentiles over completed requests, and
the JSON-stable metrics normalization.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any


@dataclasses.dataclass
class Request:
    """One admitted inference request (a single sample).

    ``submitted_s`` is the arrival time on the virtual clock (the loop's
    clock at ``submit()``), so ``completed_s - submitted_s`` is the
    request's full admit-to-complete latency, queueing included.
    ``slo_class`` names the request's latency class (``None`` =
    unclassified); ``priority`` orders continuous-batch admission (higher
    first, FIFO within a class).  ``result`` is a ``torch.Tensor`` on the
    deployment's device once the request completes.
    """

    req_id: int
    x: Any
    submitted_s: float
    attempts: int = 0
    completed_s: float | None = None
    result: Any = None
    slo_class: str | None = None
    priority: int = 0

    @property
    def done(self) -> bool:
        return self.completed_s is not None

    @property
    def latency_s(self) -> float | None:
        """Admit-to-complete time on the virtual clock; None while pending."""
        if self.completed_s is None:
            return None
        return self.completed_s - self.submitted_s


def normalize_metrics(payload):
    """Canonical metrics payload: the JSON round-trip identity.

    Every mapping key is coerced to ``str``, tuples become lists, and numpy
    scalars become native Python numbers.  Applied once at the metrics
    facades (``Deployment.metrics``, the engine), so
    ``json.loads(json.dumps(m)) == m`` holds for every metrics dict.
    """
    if isinstance(payload, dict):
        return {str(k): normalize_metrics(v) for k, v in payload.items()}
    if isinstance(payload, (list, tuple)):
        return [normalize_metrics(v) for v in payload]
    if isinstance(payload, bool) or payload is None:
        return payload
    if isinstance(payload, (int, float, str)):
        return payload
    import numpy as _np

    if isinstance(payload, _np.integer):
        return int(payload)
    if isinstance(payload, _np.floating):
        return float(payload)
    return payload


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile (q in [0, 1]) over pre-sorted values."""
    if not sorted_vals:
        return 0.0
    rank = max(1, math.ceil(q * len(sorted_vals)))
    return float(sorted_vals[rank - 1])


def latency_stats(requests) -> dict:
    """p50/p95/p99 + mean/max admit-to-complete latency of completed requests."""
    lats = sorted(r.latency_s for r in requests if r.done)
    n = len(lats)
    return {
        "count": n,
        "mean_s": sum(lats) / n if n else 0.0,
        "p50_s": percentile(lats, 0.50),
        "p95_s": percentile(lats, 0.95),
        "p99_s": percentile(lats, 0.99),
        "max_s": lats[-1] if n else 0.0,
    }


def latency_report(requests, class_targets: dict | None = None) -> dict:
    """Latency percentiles overall and per SLO class.

    ``class_targets`` maps class name -> target latency (seconds) or None;
    classed entries gain ``target_s`` and ``attainment`` (fraction of the
    class's completions within target).  Requests without a class report
    under ``"default"``.
    """
    by_class: dict[str, list] = {}
    for r in requests:
        if r.done:
            by_class.setdefault(r.slo_class or "default", []).append(r)
    classes = {}
    for name in sorted(by_class):
        reqs = by_class[name]
        entry = latency_stats(reqs)
        target = (class_targets or {}).get(name)
        entry["target_s"] = target
        entry["attainment"] = (
            sum(1 for r in reqs if r.latency_s <= target) / len(reqs)
            if target is not None and reqs else None
        )
        classes[name] = entry
    return {"overall": latency_stats(r for r in requests if r.done),
            "classes": classes}
