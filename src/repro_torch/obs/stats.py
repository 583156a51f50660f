"""Shared latency statistics: ONE nearest-rank percentile implementation.

``cluster/serving.latency_report``, ``tenancy/router.latency_report`` and
the autoscaler's recent-window p99 each used to carry their own copy of
the nearest-rank computation; they all route here now, so a percentile
quoted anywhere in a metrics payload means exactly the same thing.
"""

from __future__ import annotations

import math


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
