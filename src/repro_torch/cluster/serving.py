"""Request-level serving over the control plane: admission + microbatching.

The paper's inference step (Sec. 2.3) is a continuous stream of requests
through the pod chain; this module makes that stream first-class.  A
``ServingLoop`` owns an admission queue of single-sample ``Request``s,
stacks up to ``microbatch`` of them per admission round, and runs the
stacked batch through the control plane's current ``InferencePipeline``.

Failure semantics: when the pipeline is degraded mid-stream (dead pod,
failed node), the in-flight microbatch is **re-queued at the front**, the
control plane reconciles (which is where the event-class-aware recovery
happens), and the requests are retried on the repaired pipeline -- so
every admitted request either completes or is retried across a recovery,
never silently lost (up to ``max_attempts``).

Time is simulated: each successful round advances the clock by the
**end-to-end time** (sum of stage compute and link times, dispatcher
input/output hops included, on the probed bandwidths -- the same
``service_times`` model the pipelined engine uses) -- the honest cost of
synchronous execution, where the next microbatch is only admitted once
the previous one has left the last stage.  Each non-trivial reconcile adds
``recovery_penalty_s`` (pod restart + re-placement cost).  Completion
timestamps let benchmarks window throughput before/during/after churn.

This loop is the *baseline*.  ``cluster.engine.PipelinedServingLoop`` keeps
every partition busy on a different microbatch and reaches the bottleneck
rate ``1 / max(stage, link time)`` instead of ``1 / sum`` -- the paper's
pipeline-parallel throughput model (and the source of its 200% claim).

Both loops stack a microbatch with ``stack_batch``, onto the pipeline's
device; a completed request's ``result`` is a ``torch.Tensor`` there.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any

import torch

from repro_torch.cluster.controlplane import ControlPlane, ReconcileAction
from repro_torch.obs.stats import latency_report, latency_stats, percentile  # noqa: F401 -- re-exported; the single nearest-rank implementation lives in obs.stats
from repro_torch.obs.trace import split_hop, split_window


@dataclasses.dataclass
class Request:
    """One admitted inference request (a single sample).

    ``replica`` is stamped by the cluster-wide router when the request is
    dispatched to a pipeline replica (re-stamped if it is re-routed after a
    replica retires); ``None`` under single-pipeline serving.

    ``submitted_s`` is the *arrival* time on the virtual clock: the loop's
    clock at ``submit()``, or the trace timestamp under open-loop
    ``schedule()`` -- so ``completed_s - submitted_s`` is the request's full
    admit-to-complete latency, queueing included.  ``slo_class`` names the
    request's latency class (``None`` = unclassified); ``priority`` orders
    continuous-batch admission (higher first, FIFO within a class).
    ``tenant`` is stamped by the tenancy router under multi-tenant serving
    (``None`` for single-tenant deployments).  ``result`` is a
    ``torch.Tensor`` on the deployment's device once the request completes.
    """

    req_id: int
    x: Any
    submitted_s: float
    attempts: int = 0
    completed_s: float | None = None
    result: Any = None
    replica: int | None = None
    slo_class: str | None = None
    priority: int = 0
    tenant: str | None = None

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

    Every mapping key is coerced to ``str`` (some sub-dicts -- per-replica,
    per-link, per-tenant -- were historically keyed by whatever the
    producer used, so ints and stringified ints could coexist in one
    payload), tuples become lists, and numpy scalars become native Python
    numbers.  Applied once at the metrics facades (``Deployment.metrics``,
    the engines, the tenancy router), so ``json.loads(json.dumps(m)) == m``
    holds for every metrics dict the benchmarks persist.
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


def stack_batch(xs: list, device) -> torch.Tensor:
    """One microbatch on ``device`` (the pipeline's; ``None`` leaves each
    input where it is).  ``torch.as_tensor`` also takes numpy inputs and
    Python numbers (an open-loop trace's default payload is the arrival
    index); a tensor already on ``device`` is not copied."""
    return torch.stack([torch.as_tensor(x, device=device) for x in xs])


class ServingLoop:
    def __init__(
        self,
        control: ControlPlane,
        *,
        microbatch: int = 4,
        max_attempts: int = 5,
        recovery_penalty_s: float = 0.25,
        tracer=None,
        registry=None,
    ):
        self.control = control
        self.microbatch = int(microbatch)
        self.max_attempts = int(max_attempts)
        self.recovery_penalty_s = float(recovery_penalty_s)
        self.tracer = tracer
        self._registry = registry
        self.queue: deque[Request] = deque()
        self.completed: list[Request] = []
        self.failed: list[Request] = []
        self.clock_s = 0.0
        self._next_id = 0

    # -- admission -----------------------------------------------------------
    def submit(self, x: Any) -> Request:
        req = Request(self._next_id, x, submitted_s=self.clock_s)
        self._next_id += 1
        self.queue.append(req)
        return req

    def admit(self, req: Request) -> Request:
        """Admit an already-created request (ids minted by the caller)."""
        self.queue.append(req)
        return req

    @property
    def backlog(self) -> int:
        return len(self.queue)

    # -- one admission round ---------------------------------------------------
    def step(self) -> list[Request]:
        """Run one microbatch; returns the requests completed this round.

        Pending control-plane events are reconciled *before* admission (the
        watch/failure detectors enqueue between rounds), and a degraded run
        triggers reconcile + retry instead of losing the batch.
        """
        if self.control.pending:
            self._reconcile()
        if not self.queue:
            return []
        take = min(self.microbatch, len(self.queue))
        batch = [self.queue.popleft() for _ in range(take)]
        xs = stack_batch([r.x for r in batch], self.control.pipeline.device)
        try:
            ys, trace = self.control.pipeline.run(xs)
        except RuntimeError:
            self._requeue(batch)
            self._reconcile()
            return []
        t0_round = self.clock_s
        self.clock_s += self._round_e2e_s(trace)
        if self.tracer is not None:
            self._trace_round(batch, t0_round, self.clock_s)
        for i, req in enumerate(batch):
            req.result = ys[i]
            req.completed_s = self.clock_s
            self.completed.append(req)
            if self._registry is not None:
                self._registry.counter(
                    "requests_completed", engine="sync").inc()
                self._registry.histogram(
                    "request_latency_s", engine="sync",
                ).observe(req.latency_s)
        return batch

    def metrics(self) -> dict:
        """Serving-side counters for ``Deployment.metrics()`` / benchmarks."""
        done = len(self.completed)
        return {
            "mode": "sync",
            "completed": done,
            "failed": len(self.failed),
            "rejected": 0,  # the sync baseline has no admission bound
            "backlog": len(self.queue),
            "clock_s": self.clock_s,
            "throughput": done / self.clock_s if self.clock_s > 0 else 0.0,
            "retries": sum(r.attempts for r in self.completed),
            "latency": latency_report(self.completed),
        }

    def drain(self, max_rounds: int = 10_000) -> list[Request]:
        """Step until the queue empties (or max_rounds); returns completions."""
        done: list[Request] = []
        for _ in range(max_rounds):
            if not self.queue and not self.control.pending:
                break
            done.extend(self.step())
        return done

    def _round_times(self):
        """Per-stage/per-hop service times for one synchronous round, on
        the SAME timing model as the pipelined engine
        (``core.bottleneck.service_times``: probed bandwidths, dispatcher
        input/output hops included).  ``None`` when the dispatcher has no
        probed view (direct lifecycle use)."""
        control = self.control
        disp = control.dispatcher
        pipe = control.pipeline
        if disp.probed is None or control.desired is None:
            return None
        from repro_torch.core.bottleneck import service_times

        graph = control.desired.graph
        return service_times(
            [p.partition for p in pipe.pods],
            [p.node_id for p in pipe.pods],
            disp.probed.bw,
            flops_per_node=[n.flops_per_s for n in control.cluster.nodes],
            in_bytes=graph.in_bytes,
            out_bytes=graph.layers[-1].out_bytes,
            dispatcher=disp.leader,
            compression_ratio=pipe.compression_ratio,
            codecs=pipe.link_codecs,
        )

    def _round_e2e_s(self, trace) -> float:
        """End-to-end cost of one synchronous round -- the honest sum of
        stage and link times (so the pipelined-vs-sync comparison isolates
        execution discipline, not a timing-model delta).  Falls back to the
        pipeline's own trace when no probed view exists."""
        times = self._round_times()
        if times is None:
            return trace.e2e_s
        compute_s, link_s = times
        finite = [s for s in compute_s + link_s if s != float("inf")]
        return sum(finite)

    def _trace_round(self, batch: list[Request], t0: float, t1: float) -> None:
        """Emit one synchronous round's spans for the sampled requests of
        ``batch``: the admission-queue wait up to the round start, then the
        sequential hop/stage walk the round actually paid for (link windows
        tiled into encode/wire/decode via the codec cost model).  The walk
        replays the same per-resource times ``_round_e2e_s`` summed, so the
        spans tile ``[queue-entry, t1)``."""
        tr = self.tracer
        traced = [r for r in batch if tr.sampled(r.req_id)]
        if not traced:
            return
        control = self.control
        pipe = control.pipeline
        gen = control.generation

        def emit(req, phase, a, b, stage=None, hop=None, codec=None):
            tr.record(req.req_id, phase, a, b, stage, hop,
                      req.replica, req.tenant, codec, gen, req.attempts)

        for req in traced:
            emit(req, "queue", tr.queue_take(req), t0)
        times = self._round_times()
        if times is None or t1 <= t0:
            for req in traced:  # no probed decomposition: one opaque window
                emit(req, "exec", t0, t1)
            return
        compute_s, link_s = times
        path = [p.node_id for p in pipe.pods]
        k = len(path)
        graph = control.desired.graph
        hop_bytes = [graph.in_bytes, *pipe.boundary_bytes,
                     graph.layers[-1].out_bytes]
        ends = [(control.dispatcher.leader, path[0] if path else None)]
        ends += [(path[i], path[i + 1]) for i in range(k - 1)]
        ends += [(path[-1] if path else None, control.dispatcher.leader)]
        flops = [n.flops_per_s for n in control.cluster.nodes]
        cursor = t0
        for h in range(k + 1):
            if math.isfinite(link_s[h]) and link_s[h] > 0:
                raw = float(hop_bytes[h]) / pipe.compression_ratio
                a, b = ends[h]
                active = raw > 0 and a is not None and b is not None and a != b
                codec = pipe.hop_codec(h) if active else None
                parts = split_hop(
                    link_s[h], codec, raw,
                    src_flops=flops[a] if a is not None else 0.0,
                    dst_flops=flops[b] if b is not None else 0.0)
                for phase, pa, pb in split_window(
                        cursor, cursor + link_s[h], parts):
                    for req in traced:
                        emit(req, phase, pa, pb, hop=h,
                             codec=codec.name if codec is not None else None)
                cursor += link_s[h]
            if h < k and math.isfinite(compute_s[h]):
                for req in traced:
                    emit(req, "exec", cursor, cursor + compute_s[h], stage=h)
                cursor += compute_s[h]

    # -- recovery internals ----------------------------------------------------
    def _requeue(self, batch: list[Request]) -> None:
        for req in reversed(batch):
            req.attempts += 1
            if req.attempts >= self.max_attempts:
                self.failed.append(req)
            else:
                self.queue.appendleft(req)

    def _reconcile(self) -> list[ReconcileAction]:
        actions = self.control.reconcile()
        if any(a.kind != "noop" for a in actions):
            self.clock_s += self.recovery_penalty_s
        return actions
