"""Per-request span timelines on the virtual clock, and named regions on
the profiler's clock.

``SpanTracer`` is the modelled cluster's timeline, not a measurement.  A
**span** is one contiguous interval ``[t0_s, t1_s)`` of a request's life on
the serving engines' virtual clock, which simulates the edge cluster
(probed link bandwidths, node FLOP rates), labelled with a phase --
``queue`` (admission or stage-input wait, out-buffer backpressure
included), ``exec`` (stage compute), and the link window decomposed into
``encode``/``wire``/``decode`` via the codec cost model.  Spans are emitted
by the serving engines at every microbatch state transition, so a
completed request's spans tile ``[submitted_s, completed_s)`` exactly:
monotone, contiguous, no gaps or overlaps.

Everything is driven by the engines' virtual clocks -- no wall-clock
reads -- so same-seed runs produce byte-identical trace output.  Sampling
is a deterministic hash of the request id (``crc32``), not an RNG draw, so
enabling tracing at any rate never perturbs the simulation itself.

``SpanTracer`` is deliberately dumb storage plus a couple of bookkeeping
maps; all interpretation lives in :mod:`repro_torch.obs.critical_path`, and the
exporters (:meth:`SpanTracer.timeline`, :meth:`SpanTracer.chrome_trace`)
are pure views.  The Chrome export loads directly in ``chrome://tracing``
or https://ui.perfetto.dev: one process per replica, one track per
request.

``region(name)`` is the measured view: a ``torch.profiler.record_function``
label around real work (the engine's step, admission, each stage's compute
and each hop's codec; ``make_gpipe``'s compute, boundary codec, exchanges
and broadcast), so a trace taken with ``torch.profiler`` shows the
``seifer.*`` regions on its own clock, beside the kernels they launched.
With no profiler running it returns a shared null context.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import zlib

from torch.autograd import profiler as _profiler

_U32 = float(1 << 32)
_NO_REGION = contextlib.nullcontext()


def region(name: str):
    """A ``record_function(name)`` label while ``torch.profiler`` records,
    else a shared null context: with the profiler off the cost is one flag
    check, so callers pass names built once, never formatted per call."""
    if not _profiler._is_profiler_enabled:
        return _NO_REGION
    return _profiler.record_function(name)


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Spec-level tracing knob (zero overhead when absent from the spec).

    ``sample`` is the fraction of requests traced, decided per ``req_id``
    by a deterministic hash seeded with ``seed`` -- 1.0 traces everything,
    0.01 traces ~1%.  ``max_spans`` bounds retained spans; past it new
    spans are counted in ``SpanTracer.dropped`` instead of stored.
    """

    sample: float = 1.0
    max_spans: int = 200_000
    seed: int = 0

    def issues(self) -> list[str]:
        """Validation problems, empty when the config is well-formed."""
        out = []
        if not isinstance(self.sample, (int, float)) or isinstance(self.sample, bool) \
                or not (0.0 <= float(self.sample) <= 1.0):
            out.append(f"trace.sample must be in [0, 1], got {self.sample!r}")
        if not isinstance(self.max_spans, int) or isinstance(self.max_spans, bool) \
                or self.max_spans < 1:
            out.append(f"trace.max_spans must be a positive int, got {self.max_spans!r}")
        return out


@dataclasses.dataclass(frozen=True)
class Span:
    """One attributed interval of one request's timeline."""

    req_id: int
    phase: str  # queue | exec | encode | wire | decode
    t0_s: float
    t1_s: float
    stage: int | None = None  # pipeline stage index (exec / stage-input queue)
    hop: int | None = None    # link hop index (encode / wire / decode)
    replica: int | None = None
    tenant: str | None = None
    codec: str | None = None
    generation: int = 0
    attempt: int = 0

    @property
    def duration_s(self) -> float:
        return self.t1_s - self.t0_s

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["duration_s"] = self.duration_s
        return d


PHASES = ("queue", "exec", "encode", "wire", "decode")


class SpanTracer:
    """Append-only span store shared by every engine of one deployment.

    The engines own the *when* (they call :meth:`record` at microbatch
    state transitions); the tracer owns sampling, retention, and the
    admission bookkeeping map ``queue_since`` (req_id -> time the request
    last entered an admission queue, so the queue span survives
    engine-internal requeues without the engine holding per-request state).

    Storage is a flat list of field tuples (``Span``'s fields, in order):
    the serving hot path pays one tuple append per span, and the ``Span``
    objects the views hand out are materialized lazily (cached until the
    store mutates).
    """

    def __init__(self, config: TraceConfig | None = None):
        self.config = config or TraceConfig()
        self._raw: list[tuple] = []
        self._cache: list[Span] | None = None
        self._max_spans = int(self.config.max_spans)
        self.dropped = 0
        self.queue_since: dict[int, float] = {}
        self._sample = float(self.config.sample)
        self._seed = int(self.config.seed)
        # hash threshold precomputed once: sampled iff crc32 < _threshold
        self._threshold = int(self._sample * _U32)

    @property
    def spans(self) -> list[Span]:
        """Materialized ``Span`` views of the raw store (cached)."""
        if self._cache is None:
            self._cache = [Span(*t) for t in self._raw]
        return self._cache

    # -- sampling ----------------------------------------------------------
    def sampled(self, req_id: int) -> bool:
        """Deterministic per-request sampling decision (no RNG state)."""
        if self._sample >= 1.0:
            return True
        if self._sample <= 0.0:
            return False
        h = zlib.crc32(f"{self._seed}:{req_id}".encode())
        return h < self._threshold

    # -- recording ---------------------------------------------------------
    def record(self, req_id: int, phase: str, t0_s: float, t1_s: float,
               stage=None, hop=None, replica=None, tenant=None, codec=None,
               generation: int = 0, attempt: int = 0) -> None:
        """Record one span from its fields (the serving hot path: one tuple
        append, no ``Span`` construction).  Zero-length spans are skipped
        (phase boundaries at the same clock tick carry no time), over-cap
        spans are counted in ``dropped`` instead of stored."""
        if t1_s <= t0_s:
            return
        if len(self._raw) >= self._max_spans:
            self.dropped += 1
            return
        self._raw.append((req_id, phase, t0_s, t1_s, stage, hop,
                          replica, tenant, codec, generation, attempt))
        self._cache = None

    def record_many(self, reqs, phase: str, t0_s: float, t1_s: float,
                    stage=None, hop=None, codec=None,
                    generation: int = 0) -> None:
        """Record one identical window for every request riding a
        microbatch -- the engine fan-out path, one call per transition."""
        if t1_s <= t0_s:
            return
        raw = self._raw
        cap = self._max_spans
        for req in reqs:
            if len(raw) >= cap:
                self.dropped += 1
                continue
            raw.append((req.req_id, phase, t0_s, t1_s, stage, hop,
                        req.replica, req.tenant, codec, generation,
                        req.attempts))
        self._cache = None

    def queue_open(self, req_id: int, t_s: float) -> None:
        """Mark a request (re-)entering an admission queue at ``t_s``."""
        self.queue_since[req_id] = t_s

    def queue_take(self, req) -> float:
        """Pop the request's queue-entry time (default: its arrival)."""
        return self.queue_since.pop(req.req_id, req.submitted_s)

    def restart(self, req_id: int) -> None:
        """Drop one request's timeline (it is restarting on another engine
        whose clock is unrelated; its life will be re-attributed there)."""
        self.restart_many({req_id})

    def restart_many(self, req_ids) -> None:
        ids = set(req_ids)
        if not ids:
            return
        self._raw = [t for t in self._raw if t[0] not in ids]
        self._cache = None
        for rid in ids:
            self.queue_since.pop(rid, None)

    def forget(self, req_id: int) -> None:
        """Drop bookkeeping for a request leaving the system (failed)."""
        self.queue_since.pop(req_id, None)

    # -- views -------------------------------------------------------------
    def spans_for(self, req_id: int) -> list[Span]:
        return [s for s in self.spans if s.req_id == req_id]

    def timeline(self) -> list[dict]:
        """JSON timeline: one flat dict per span, time-ordered per request."""
        return [s.as_dict()
                for s in sorted(self.spans, key=lambda s: (s.req_id, s.t0_s))]

    def chrome_trace(self, *, process_prefix: str = "replica") -> dict:
        """Chrome trace-event export (``chrome://tracing`` / Perfetto).

        Complete ("X") events, microsecond timestamps; ``pid`` is the
        replica index (0 when single-pipeline), ``tid`` the request id, so
        every request renders as its own track and spans on one track
        never overlap (they tile the request's life by construction).
        """
        events = []
        pids = {}
        for s in sorted(self.spans, key=lambda s: (s.t0_s, s.req_id)):
            pid = s.replica if s.replica is not None else 0
            pids.setdefault(pid, s.tenant)
            where = ""
            if s.stage is not None:
                where = f"[s{s.stage}]"
            elif s.hop is not None:
                where = f"[h{s.hop}]"
            events.append({
                "ph": "X",
                "name": f"{s.phase}{where}",
                "cat": s.phase,
                "ts": s.t0_s * 1e6,
                "dur": (s.t1_s - s.t0_s) * 1e6,
                "pid": pid,
                "tid": s.req_id,
                "args": {
                    "stage": s.stage, "hop": s.hop, "codec": s.codec,
                    "tenant": s.tenant, "generation": s.generation,
                    "attempt": s.attempt,
                },
            })
        meta = []
        for pid in sorted(pids):
            tenant = pids[pid]
            name = f"{process_prefix} {pid}" + (f" ({tenant})" if tenant else "")
            meta.append({"ph": "M", "name": "process_name", "pid": pid,
                         "tid": 0, "args": {"name": name}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def summary(self) -> dict:
        """Small metrics-payload-safe digest (counts only)."""
        by_phase: dict[str, int] = {}
        for t in self._raw:
            by_phase[t[1]] = by_phase.get(t[1], 0) + 1
        return {
            "sample": self._sample,
            "spans": len(self._raw),
            "dropped": self.dropped,
            "requests": len({t[0] for t in self._raw}),
            "by_phase": by_phase,
        }


# -- link-window decomposition --------------------------------------------

def split_hop(link_s: float, codec, raw_bytes: int,
              src_flops: float = 0.0, dst_flops: float = 0.0):
    """Analytic ``(encode_s, wire_s, decode_s)`` decomposition of one hop.

    Uses the codec cost model (the same one ``dataplane.link_charge_s``
    charges), so the three parts sum to the hop's total service time.
    Codec-free hops are pure wire; dead links (inf) stay pure wire so the
    infinity never leaks into encode/decode.
    """
    link_s = float(link_s)
    if codec is None or not math.isfinite(link_s):
        return (0.0, link_s, 0.0)
    enc = float(codec.encode_cost_s(raw_bytes, src_flops))
    dec = float(codec.decode_cost_s(raw_bytes, dst_flops))
    wire = max(0.0, link_s - enc - dec)
    return (enc, wire, dec)


def split_window(t0: float, t1: float, parts) -> list[tuple[str, float, float]]:
    """Tile the observed window ``[t0, t1)`` into encode/wire/decode spans
    proportionally to the analytic ``parts`` -- exact when the ride ran to
    completion (window == sum(parts)), proportional when churn truncated
    it, pure wire when the analytic total is zero or infinite.  Segments
    share boundaries, so their durations telescope to ``t1 - t0``."""
    dur = t1 - t0
    if dur <= 0:
        return []
    enc, wire, dec = (float(p) for p in parts)
    total = enc + wire + dec
    if total <= 0 or not math.isfinite(total):
        return [("wire", t0, t1)]
    b1 = t0 + dur * (enc / total)
    b2 = t1 - dur * (dec / total)
    segs = [("encode", t0, b1), ("wire", b1, b2), ("decode", b2, t1)]
    return [(phase, a, b) for phase, a, b in segs if b > a]
