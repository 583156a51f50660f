"""Unified observability plane: spans, journal, metrics registry, attribution.

One package owns every "what happened and where did the time go" question:

* ``obs.trace`` -- per-request span timelines on the virtual clock
  (``TraceConfig``/``SpanTracer``: the modelled cluster's timeline), with
  JSON-timeline and Chrome trace-event (Perfetto-loadable) exporters; and
  ``region``, the ``seifer.*`` labels around real work that a
  ``torch.profiler`` trace shows on the device's clock.
* ``obs.journal`` -- the append-only, monotonically-timestamped
  control-plane journal unifying reconcile decisions, scoped-recovery
  records, rollout transitions, autoscaler scale events, and tenancy
  event routing.
* ``obs.metrics`` -- counter/gauge/histogram primitives with label sets,
  exported as one schema-validated snapshot.
* ``obs.stats`` -- the single nearest-rank percentile + latency report
  implementation (serving, tenancy, and the autoscaler all route here).
* ``obs.critical_path`` -- folds span timelines into per-request and
  aggregate latency attributions (queue/compute/wire/transcode) and pins
  observed per-stage service times against the plan's
  ``core.bottleneck.service_times`` predictions.

Nothing in this package imports from ``repro_torch.api``/``repro_torch.cluster`` --
it sits below them so every layer can depend on it without cycles.
"""

from repro_torch.obs.critical_path import analyze_spans, request_attribution
from repro_torch.obs.journal import Journal, JournalRecord
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.stats import latency_report, latency_stats, percentile
from repro_torch.obs.trace import Span, SpanTracer, TraceConfig, region

__all__ = [
    "Journal",
    "JournalRecord",
    "MetricsRegistry",
    "Span",
    "SpanTracer",
    "TraceConfig",
    "analyze_spans",
    "latency_report",
    "latency_stats",
    "percentile",
    "region",
    "request_attribution",
]
