"""Pipelined discrete-event serving engine (the paper's actual throughput model).

SEIFER's headline claim -- ~200% more inference throughput from partitioning
across resource-constrained nodes -- rests on *pipeline parallelism*: each
partition works on a different microbatch concurrently, so steady-state
throughput equals the bottleneck stage's rate, independent of pipeline depth
(same model as DEFER and the companion placement paper).  The synchronous
``ServingLoop`` pushes one microbatch through the whole chain per round and
therefore pays the *sum* of stage times; this module replaces it with a
virtual-clock scheduler in which every placed partition advances
independently:

  * **virtual clock** -- ``clock_s`` advances to the earliest pending event
    (a compute or a transfer finishing); nothing is wall-clock timed.
  * **bounded in-queues** -- each stage owns a ``queue_depth``-bounded input
    queue; a transfer may only start once it can reserve a slot downstream,
    so a slow stage stalls its upstream neighbours and ultimately admission
    (backpressure), bounding memory everywhere.
  * **serial resources** -- each stage computes one microbatch at a time
    (service time = ``partition.flops / node.flops_per_s``) and each link
    carries one transfer at a time (``boundary_bytes / probed_bandwidth``,
    compression-adjusted), including the dispatcher's input/output hops.
    Steady-state throughput is therefore ``1 / max(stage, link times)`` --
    exactly what ``Planner`` predicts via the shared
    ``core.bottleneck.service_times`` model.
  * **in-flight tracking** -- every admitted request lives in exactly one
    place: the admission queue, one in-flight microbatch, ``completed``, or
    ``failed``.  When reconciliation disturbs the pipeline, microbatches
    resident on *affected* stages (the dead node's pods, or every stage on a
    version bump / full restart) are requeued to admission with an attempt
    count; batches elsewhere keep their partial progress, because the
    re-placement recovery path preserves partitions.

The engine exposes the same surface as ``ServingLoop`` (``submit`` /
``step`` / ``drain`` / ``metrics`` / ``backlog``), so ``Deployment`` and the
benchmarks can switch between the honest synchronous baseline and the
pipelined engine with one spec field.

Stage executors run for real on the deployment's device: each admitted
microbatch is stacked onto it (``serving.stack_batch``), every stage compute
runs the executor (kernels included), and every hop applies its codec's
transform.  The virtual clock is floats only; no tensor reduction enters it.
That real work runs inside ``obs.region`` labels (``seifer.engine.step``,
``seifer.engine.admit``, ``seifer.stage.<s>``, ``seifer.hop.<h>.encode`` /
``.transcode``), which a ``torch.profiler`` trace shows on its own clock,
and the host's wait from submission to admission is counted on the host
clock (``host_counters``).
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from collections import deque
from typing import Any

from repro_torch.cluster.controlplane import ControlPlane, ReconcileAction, ReplicaSet
from repro_torch.cluster.events import NodeFailed
from repro_torch.cluster.lifecycle import Pod
from repro_torch.cluster.serving import (
    Request,
    latency_report,
    normalize_metrics,
    stack_batch,
)
from repro_torch.core.bottleneck import service_times
from repro_torch.dataplane.base import EncodedActivation
from repro_torch.obs.trace import region, split_hop, split_window

_ALL = "all"  # sentinel: every stage is affected (version bump, restart)


@dataclasses.dataclass
class Microbatch:
    """A stacked group of requests moving through the stage chain.

    ``location`` is the single source of truth for where the batch is:

      ``("queue", s)``    waiting in stage s's bounded in-queue
      ``("compute", s)``  being computed by stage s (``ready_at`` = finish)
      ``("out", s)``      computed by stage s, waiting for the next hop
      ``("link", h)``     riding hop h (0 = dispatcher->0, k = last->out)
    """

    mb_id: int
    requests: list[Request]
    x: Any  # current activation (input stack before stage ``stage``)
    stage: int  # next stage whose compute this batch still needs
    location: tuple
    ready_at: float = 0.0
    # span tracing (populated only for sampled requests; empty = untraced)
    traced: list = dataclasses.field(default_factory=list)
    phase: tuple | None = None  # open span phase, e.g. ("exec", s)
    phase_t0: float = 0.0


@dataclasses.dataclass
class StageState:
    """One placed partition: bounded in-queue + serial compute + out buffer."""

    index: int
    pod: Pod
    compute_s: float
    queue: deque
    out: deque  # computed batches awaiting their outgoing hop (normally <= 1)
    reserved: int = 0  # in-queue slots reserved by in-flight transfers
    current: Microbatch | None = None
    busy_s: float = 0.0  # total time spent computing
    queue_area: float = 0.0  # integral of queue length over virtual time
    max_queue: int = 0  # peak of len(queue) + reserved
    completed: int = 0  # microbatches computed by this stage


class PipelinedServingLoop:
    """Discrete-event pipelined serving over a ``ControlPlane``.

    Drop-in for ``ServingLoop``: same constructor shape, same
    ``submit``/``step``/``drain``/``metrics`` surface, same recovery
    semantics (reconcile pending events before advancing; a non-trivial
    reconcile costs ``recovery_penalty_s`` of virtual time).
    """

    def __init__(
        self,
        control: ControlPlane,
        *,
        microbatch: int = 4,
        queue_depth: int = 2,
        max_attempts: int = 5,
        recovery_penalty_s: float = 0.25,
        max_batch: int | None = None,
        admission_depth: int | None = None,
        class_priority: dict[str, int] | None = None,
        class_targets: dict[str, float | None] | None = None,
        tracer=None,
        registry=None,
    ):
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if max_batch is not None and max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if admission_depth is not None and admission_depth < 1:
            raise ValueError("admission_depth must be >= 1")
        self.control = control
        self.microbatch = int(microbatch)
        self.queue_depth = int(queue_depth)
        self.max_attempts = int(max_attempts)
        self.recovery_penalty_s = float(recovery_penalty_s)
        # continuous batching: coalesce up to max_batch queued requests per
        # admission (None keeps the fixed microbatch target of closed loops)
        self.max_batch = None if max_batch is None else int(max_batch)
        # open-loop admission bound: arrivals beyond this queue depth are
        # rejected (load shedding), never silently dropped
        self.admission_depth = (
            None if admission_depth is None else int(admission_depth))
        self.class_priority = dict(class_priority or {})
        self.class_targets = dict(class_targets or {})
        # observability plane: both default None (zero overhead -- every
        # tracing/counting site is behind an ``is not None`` guard)
        self.tracer = tracer
        self._registry = registry
        self.queue: deque[Request] = deque()  # admission queue
        self.completed: list[Request] = []
        self.failed: list[Request] = []
        self.rejected: list[Request] = []
        self._arrivals: list[tuple[float, int, Request]] = []  # future arrivals
        self._arrival_seq = 0  # heap tiebreak for externally-minted ids
        self._max_batch_seen = 0
        self.clock_s = 0.0
        self._next_id = 0
        self._next_mb = 0
        self._inflight: list[Microbatch] = []
        self._stages: list[StageState] = []
        self._link_s: list[float] = []  # per-hop transfer time, len k+1
        self._links_busy: list[Microbatch | None] = []
        self._link_codecs: list = []  # Codec per hop (None = raw / no wire)
        self._link_parts: list = []  # (encode_s, wire_s, decode_s) per hop
        self._link_raw: list[float] = []  # raw boundary bytes per hop
        self._link_wire: list[float] = []  # on-wire bytes per hop
        self._link_busy_s: list[float] = []  # time each link spent occupied
        self._link_xfers: list[int] = []  # completed transfers per hop
        # region names, built once a binding: seifer.stage.<s>, and
        # (seifer.hop.<h>.encode, seifer.hop.<h>.transcode)
        self._stage_regions: tuple[str, ...] = ()
        self._hop_regions: tuple[tuple[str, str], ...] = ()
        # host clock (time.monotonic) of each queued request's entry into
        # admission, and the admitted requests' count and summed wait
        self._host_queued: dict[int, float] = {}
        self._admission_waits = 0
        self._admission_wait_s = 0.0
        self._mb_completed = 0
        self._requeues = 0  # microbatches pulled off affected stages
        self._bound_pipeline = None  # identity of the pipeline we're bound to
        self._pod_sig: list[tuple[int, int, int]] = []
        if control.pipeline is not None:
            self._rebind(affected=frozenset())

    # -- admission -----------------------------------------------------------
    def submit(self, x: Any, *, slo_class: str | None = None) -> Request:
        req = Request(
            self._next_id, x, submitted_s=self.clock_s, slo_class=slo_class,
            priority=self.class_priority.get(slo_class, 0),
        )
        self._next_id += 1
        self._enqueue(req)
        return req

    def schedule(self, x: Any, at_s: float, *,
                 slo_class: str | None = None) -> Request:
        """Open-loop admission: the request arrives at virtual time ``at_s``
        (a trace timestamp), not when the caller happened to invoke us.
        Future arrivals wait in a heap and are admitted -- or rejected, when
        the admission queue is at ``admission_depth`` -- as the clock passes
        them."""
        req = Request(
            self._next_id, x, submitted_s=float(at_s), slo_class=slo_class,
            priority=self.class_priority.get(slo_class, 0),
        )
        self._next_id += 1
        return self.schedule_request(req)

    def schedule_request(self, req: Request) -> Request:
        """Timestamped admission of an already-created request (the router's
        dispatch path: per-replica clocks must never complete a request
        before its cluster-wide arrival time)."""
        if req.submitted_s <= self.clock_s:
            self._admit_bounded(req)
        else:
            self._arrival_seq += 1
            heapq.heappush(
                self._arrivals, (req.submitted_s, self._arrival_seq, req))
        return req

    def admit(self, req: Request) -> Request:
        """Admit an already-created request (the replica router's path: ids
        are minted cluster-wide, so the per-replica loop must not renumber).
        Unbounded: the router already applied its own admission policy."""
        self._enqueue(req)
        return req

    def _enqueue(self, req: Request) -> None:
        self.queue.append(req)
        self._host_queued[req.req_id] = time.monotonic()

    def _admit_bounded(self, req: Request) -> None:
        if (self.admission_depth is not None
                and len(self.queue) >= self.admission_depth):
            self.rejected.append(req)
            if self._registry is not None:
                self._registry.counter(
                    "requests_rejected", engine="pipelined").inc()
        else:
            self._enqueue(req)

    def _admit_due(self) -> None:
        """Move every arrival whose timestamp has passed into the queue."""
        while self._arrivals and self._arrivals[0][0] <= self.clock_s:
            _, _, req = heapq.heappop(self._arrivals)
            self._admit_bounded(req)

    @property
    def arrivals(self) -> list[Request]:
        """Scheduled requests whose arrival time is still in the future."""
        return [req for _, _, req in self._arrivals]

    @property
    def pending_arrivals(self) -> int:
        return len(self._arrivals)

    @property
    def next_arrival_s(self) -> float | None:
        return self._arrivals[0][0] if self._arrivals else None

    @property
    def backlog(self) -> int:
        """Requests not yet delivered: admission queue + in-flight batches.
        (Future arrivals are offered load, not backlog -- they have not
        entered the system yet.)"""
        return len(self.queue) + sum(len(m.requests) for m in self._inflight)

    # -- one serving round -----------------------------------------------------
    def step(self) -> list[Request]:
        """Advance the virtual clock until the next completion (or idle).

        Pending control-plane events (and unannounced failures discovered by
        the health check) are reconciled first, requeueing exactly the
        in-flight microbatches resident on affected stages.
        """
        with region("seifer.engine.step"):
            done0 = len(self.completed)
            pipe = self.control.pipeline
            if pipe is None:
                raise RuntimeError("bootstrap the control plane before serving")
            if pipe is not self._bound_pipeline:
                # out-of-band swap (e.g. Deployment.replan): nothing carries over
                self._rebind(affected=_ALL)
            elif self._pod_signature() != self._pod_sig:
                # out-of-band in-place recovery (reconcile() called directly, not
                # through step): restarted pods lost their resident batches, moved
                # pods migrated with theirs; timings re-derive either way
                restarted = {
                    s for s, (pod, (_, _, restarts0)) in
                    enumerate(zip(pipe.pods, self._pod_sig))
                    if pod.restarts != restarts0
                }
                self._rebind(affected=frozenset(restarted))
            if self.control.pending or not pipe.healthy():
                self._reconcile()
            self._admit_due()
            self._schedule()
            while len(self.completed) == done0:
                if not self._advance():
                    break
            return self.completed[done0:]

    def drain(self, max_rounds: int = 100_000) -> list[Request]:
        """Step until every admitted request completes (or max_rounds).
        Open-loop schedules keep draining through future arrivals: the clock
        jumps across idle gaps in the trace."""
        done: list[Request] = []
        for _ in range(max_rounds):
            if (not self.backlog and not self._arrivals
                    and not self.control.pending):
                break
            done.extend(self.step())
        return done

    # -- metrics ---------------------------------------------------------------
    def metrics(self) -> dict:
        """Serving counters + per-stage occupancy/queue statistics.

        The payload is normalized (``serving.normalize_metrics``): string
        keys everywhere, native Python numbers, JSON round-trip stable.
        """
        done = len(self.completed)
        t = self.clock_s
        return normalize_metrics({
            "mode": "pipelined",
            "completed": done,
            "failed": len(self.failed),
            "rejected": len(self.rejected),
            "backlog": self.backlog,
            "pending_arrivals": self.pending_arrivals,
            "clock_s": t,
            "throughput": done / t if t > 0 else 0.0,
            "retries": sum(r.attempts for r in self.completed),
            "latency": latency_report(self.completed, self.class_targets),
            "microbatches": self._mb_completed,
            "in_flight": len(self._inflight),
            "requeued_microbatches": self._requeues,
            "queue_depth": self.queue_depth,
            "batching": {
                "max_batch": self.max_batch,
                "admission_depth": self.admission_depth,
                "max_batch_seen": self._max_batch_seen,
                "mean_batch": (
                    done / self._mb_completed if self._mb_completed else 0.0),
            },
            "link_s": list(self._link_s),
            "links": [
                {
                    "hop": h,
                    "codec": codec.name if codec is not None else "identity",
                    "raw_bytes": self._link_raw[h],
                    "wire_bytes": self._link_wire[h],
                    "compression_x": (
                        self._link_raw[h] / self._link_wire[h]
                        if self._link_wire[h] > 0 else 1.0
                    ),
                    "link_s": self._link_s[h],
                    "utilization": self._link_busy_s[h] / t if t > 0 else 0.0,
                    "transfers": self._link_xfers[h],
                }
                for h, codec in enumerate(self._link_codecs)
            ],
            "stages": [
                {
                    "stage": st.index,
                    "node": st.pod.node_id,
                    "compute_s": st.compute_s,
                    "occupancy": st.busy_s / t if t > 0 else 0.0,
                    "mean_queue": st.queue_area / t if t > 0 else 0.0,
                    "max_queue": st.max_queue,
                    "microbatches": st.completed,
                }
                for st in self._stages
            ],
        })

    def host_counters(self) -> dict:
        """Counters on the host clock, kept out of ``metrics()`` (whose
        payload is deterministic): ``admission_wait`` is the number of
        admissions and their summed seconds from a request's entry into the
        admission queue (``submit``/``admit``, an arrival falling due, a
        requeue) to the microbatch that took it."""
        return {"admission_wait": {"count": self._admission_waits,
                                   "sum_s": self._admission_wait_s}}

    def steady_state_throughput(self, skip_frac: float = 0.5) -> float:
        """Requests/s over the tail of the completions (fill/drain excluded).

        Falls back to the overall mean when the tail window is degenerate
        (too few completions, or the whole window shares one timestamp --
        e.g. a short run whose tail is a single microbatch)."""
        reqs = self.completed
        mean = len(reqs) / self.clock_s if self.clock_s > 0 else 0.0
        if len(reqs) < 4:
            return mean
        i0 = int(len(reqs) * skip_frac)
        t0, t1 = reqs[i0].completed_s, reqs[-1].completed_s
        if t1 <= t0:
            return mean
        return (len(reqs) - 1 - i0) / (t1 - t0)

    # -- reconciliation bridge -------------------------------------------------
    def _pod_signature(self) -> list[tuple[int, int, int]]:
        return [
            (id(pod), pod.node_id, pod.restarts)
            for pod in self.control.pipeline.pods
        ]

    def _reconcile(self) -> list[ReconcileAction]:
        pipe_before = self.control.pipeline
        # stages a pending NodeFailed is about to kill, plus any pod already
        # dead/unhealthy (unannounced failure -> drift repair)
        doomed_nodes = {
            e.node_id
            for e in self.control.pending_events()
            if isinstance(e, NodeFailed)
        }
        affected = {
            s
            for s, pod in enumerate(pipe_before.pods)
            if not pod.alive
            or not self.control.cluster.nodes[pod.node_id].healthy
            or pod.node_id in doomed_nodes
        }
        actions = self.control.reconcile()
        if any(a.kind != "noop" for a in actions):
            self.clock_s += self.recovery_penalty_s
            if self._registry is not None:
                self._registry.counter("reconciles", engine="pipelined").inc()
        if self.control.pipeline is not pipe_before:
            # new pipeline object: version bump, full restart, or reconfigure
            # fallback -- partitions/weights may differ, nothing carries over
            self._rebind(affected=_ALL)
        else:
            # in-place re-placement: partitions preserved, so batches on
            # unaffected stages keep their progress; timings are re-derived
            # (nodes moved, bandwidths re-probed)
            self._rebind(affected=frozenset(affected))
        return actions

    def _rebind(self, affected) -> None:
        """Rebuild stage/link state from the current pipeline.

        ``affected`` is the set of stage indices whose resident microbatches
        must be requeued (or ``"all"``).  Batches elsewhere are re-seated at
        their current position and rescheduled from the current clock.
        """
        control = self.control
        pipe = control.pipeline
        disp = control.dispatcher
        graph = control.desired.graph
        if self.tracer is not None:
            # close every traced batch's open span on the OLD hop/stage
            # geometry (the decomposition tables are about to be rebuilt);
            # re-seated batches reopen below, requeued ones restart from
            # admission
            for mb in self._inflight:
                if mb.traced:
                    self._trace_close(mb, self.clock_s)
        comm = disp.probed if disp.probed is not None else control.cluster.comm
        path = [p.node_id for p in pipe.pods]
        parts = [p.partition for p in pipe.pods]
        codecs = [pipe.hop_codec(h) for h in range(len(path) + 1)]
        compute_s, link_s = service_times(
            parts, path, comm.bw,
            flops_per_node=[n.flops_per_s for n in control.cluster.nodes],
            in_bytes=graph.in_bytes,
            out_bytes=graph.layers[-1].out_bytes,
            dispatcher=disp.leader,
            compression_ratio=pipe.compression_ratio,
            codecs=None if pipe.link_codecs is None else pipe.link_codecs,
        )
        k = len(path)
        # per-hop byte model for the link report: raw boundary bytes (after
        # the legacy compression knob) vs what the codec puts on the wire;
        # a hop with colocated endpoints or zero bytes carries no codec
        hop_bytes = [graph.in_bytes, *pipe.boundary_bytes,
                     graph.layers[-1].out_bytes]
        ends = [(disp.leader, path[0] if path else None)]
        ends += [(path[i], path[i + 1]) for i in range(k - 1)]
        ends += [(path[-1] if path else None, disp.leader)]
        self._link_codecs, self._link_raw, self._link_wire = [], [], []
        for h in range(k + 1):
            raw = float(hop_bytes[h]) / pipe.compression_ratio
            a, b = ends[h]
            active = raw > 0 and a is not None and b is not None and a != b
            codec = codecs[h] if active else None
            self._link_codecs.append(codec)
            self._link_raw.append(raw if active else 0.0)
            self._link_wire.append(
                codec.wire_bytes(raw) if codec is not None
                else (raw if active else 0.0))
        # analytic encode/wire/decode decomposition of each hop window, on
        # the same codec cost model link_s itself was built from -- the
        # tracer tiles observed link windows with these proportions
        flops = [n.flops_per_s for n in control.cluster.nodes]
        self._link_parts = [
            split_hop(
                link_s[h], self._link_codecs[h], self._link_raw[h],
                src_flops=flops[ends[h][0]] if ends[h][0] is not None else 0.0,
                dst_flops=flops[ends[h][1]] if ends[h][1] is not None else 0.0,
            )
            for h in range(k + 1)
        ]
        old_stages = self._stages
        carry_stats = len(old_stages) == k and affected is not _ALL
        self._stages = []
        for i, pod in enumerate(pipe.pods):
            st = StageState(i, pod, compute_s[i], deque(), deque())
            if carry_stats:  # keep occupancy accounting across a re-placement
                prev = old_stages[i]
                st.busy_s, st.queue_area = prev.busy_s, prev.queue_area
                st.max_queue, st.completed = prev.max_queue, prev.completed
            self._stages.append(st)
        self._link_s = link_s
        self._stage_regions = tuple(f"seifer.stage.{s}" for s in range(k))
        self._hop_regions = tuple((f"seifer.hop.{h}.encode", f"seifer.hop.{h}.transcode")
                                  for h in range(k + 1))
        self._links_busy = [None] * (k + 1)
        if not (carry_stats and len(self._link_busy_s) == k + 1):
            self._link_busy_s = [0.0] * (k + 1)
            self._link_xfers = [0] * (k + 1)
        self._bound_pipeline = pipe
        self._pod_sig = self._pod_signature()

        old = sorted(self._inflight, key=lambda m: m.mb_id)
        self._inflight = []
        requeue: list[Microbatch] = []  # resident on an affected stage: retry
        readmit: list[Microbatch] = []  # on the input hop: free retransmission
        for mb in old:
            kind, idx = mb.location
            if kind == "link" and idx == 0:
                # the dispatcher still holds the input: re-admit without an
                # attempt (no stage ever hosted this batch, nothing was
                # lost) -- true even across a version bump or full restart
                readmit.append(mb)
                continue
            if affected is _ALL:
                requeue.append(mb)
                continue
            if kind in ("queue", "compute", "out"):
                bad = idx in affected
            else:  # riding hop idx: data is between stages idx-1 and idx
                bad = (idx - 1) in affected or (idx < k and idx in affected)
            if bad:
                requeue.append(mb)
                continue
            self._inflight.append(mb)
            if kind in ("queue", "compute"):
                # a compute in progress restarts: mb.x is still the stage input
                mb.location = ("queue", idx)
                self._stages[idx].queue.append(mb)
                if mb.traced:
                    self._trace_open(mb, ("squeue", idx), self.clock_s)
            elif kind == "out":
                self._stages[idx].out.append(mb)
                if mb.traced:
                    self._trace_open(mb, ("out", idx), self.clock_s)
            else:  # hop idx >= 1: retransmit from the source stage's out buffer
                mb.location = ("out", idx - 1)
                self._stages[idx - 1].out.append(mb)
                if mb.traced:
                    self._trace_open(mb, ("out", idx - 1), self.clock_s)
        # back to admission newest-first so it re-admits in original order
        self._requeues += len(requeue)
        if requeue and self._registry is not None:
            self._registry.counter(
                "requeued_microbatches", engine="pipelined").inc(len(requeue))
        retried = {id(mb) for mb in requeue}
        for mb in sorted(requeue + readmit, key=lambda m: -m.mb_id):
            self._readmit(mb.requests, retry=id(mb) in retried)

    def evacuate(self) -> list[tuple[Request, bool]]:
        """Strip every undelivered request out of the engine (the router's
        replica-retirement path) and reset the stage/link state.

        Returns ``(request, charged)`` pairs in admission order, applying
        the same classification ``_rebind`` uses on recovery: a request
        resident on a stage or a non-input link is charged (its work was
        lost), an input-hop rider or a still-queued request is free (the
        dispatcher still holds the input)."""
        out: list[tuple[Request, bool]] = []
        for mb in sorted(self._inflight, key=lambda m: m.mb_id):
            charged = mb.location != ("link", 0)
            if charged:
                self._requeues += 1
            out.extend((req, charged) for req in mb.requests)
        out.extend((req, False) for req in self.queue)
        # future arrivals ride along uncharged: they never entered the system
        out.extend(
            (req, False)
            for _, _, req in sorted(self._arrivals)
        )
        if self.tracer is not None:
            # evacuated requests restart on another engine whose clock is
            # unrelated to ours: drop their partial timelines here so the
            # receiving engine re-attributes their whole life (lost work
            # shows up as queueing there, never as overlapping spans)
            self.tracer.restart_many(
                {req.req_id for req, _ in out
                 if self.tracer.sampled(req.req_id)})
        self._inflight.clear()
        self.queue.clear()
        self._host_queued.clear()
        self._arrivals.clear()
        self._links_busy = [None] * len(self._links_busy)
        for st in self._stages:
            st.queue.clear()
            st.out.clear()
            st.current = None
            st.reserved = 0
        return out

    # -- discrete-event core ---------------------------------------------------
    def _elapse(self, t: float) -> None:
        """Advance the clock to ``t``, integrating queue occupancy."""
        dt = max(0.0, t - self.clock_s)
        for st in self._stages:
            st.queue_area += len(st.queue) * dt
        self.clock_s = max(self.clock_s, t)

    def _advance(self) -> bool:
        """Pop the earliest event batch off the virtual clock; False if idle.

        A scheduled arrival is an event like any other: when it precedes
        every pending compute/transfer (or the pipeline is idle), the clock
        jumps to it and admission re-runs."""
        pend = [m for m in self._inflight if m.location[0] in ("compute", "link")]
        times = [m.ready_at for m in pend]
        arrival = self.next_arrival_s
        if not times:
            if arrival is None:
                return False  # idle
            self._elapse(arrival)  # idle gap in the trace: jump to the arrival
            self._admit_due()
            self._schedule()
            return True
        t = min(times)
        if t == float("inf"):
            # every pending event is a transfer on a dead link: it can never
            # finish, so retry the riders instead of hanging callers that
            # loop on backlog.  attempts bound the retries (-> failed), the
            # sync loop's liveness guarantee.
            self._requeue_stalled([m for m in pend if m.ready_at == float("inf")])
            self._schedule()
            return True
        if arrival is not None and arrival < t:
            self._elapse(arrival)
            self._admit_due()
            self._schedule()
            return True
        self._elapse(t)
        self._admit_due()
        k = len(self._stages)
        for mb in sorted(pend, key=lambda m: m.mb_id):
            if mb.ready_at > t:
                continue
            kind, idx = mb.location
            if kind == "compute":
                st = self._stages[idx]
                part = st.pod.partition
                with region(self._stage_regions[idx]):
                    mb.x = self.control.pipeline.executor(part.start, part.stop, mb.x)
                st.busy_s += st.compute_s
                st.completed += 1
                st.current = None
                mb.stage = idx + 1
                mb.location = ("out", idx)
                st.out.append(mb)
                if mb.traced:
                    self._trace_close(mb, self.clock_s)  # exec span
                    self._trace_open(mb, ("out", idx), self.clock_s)
            else:  # transfer on hop idx finished
                self._links_busy[idx] = None
                self._link_busy_s[idx] += self._link_s[idx]
                self._link_xfers[idx] += 1
                if mb.traced:
                    self._trace_close(mb, self.clock_s)  # encode/wire/decode
                codec = self._link_codecs[idx] if idx < len(self._link_codecs) else None
                if codec is not None:
                    executor = self.control.pipeline.executor
                    if (idx != k and codec.name
                            in getattr(executor, "fused_codecs", ())):
                        # fused decode: the receiving stage's first op
                        # consumes the wire payload directly (e.g. int8 ->
                        # dequant-matmul), so hand over the still-encoded
                        # activation instead of eagerly decoding it
                        with region(self._hop_regions[idx][0]):
                            mb.x = EncodedActivation(codec, codec.encode(mb.x))
                    else:
                        # the receiver sees decode(encode(x)): the codec's
                        # real transform (the int8 kernels on CUDA, fp16,
                        # top-k) runs on the activations riding the wire
                        with region(self._hop_regions[idx][1]):
                            mb.x = codec.transcode(mb.x)
                if idx == k:
                    self._complete(mb)
                else:
                    st = self._stages[idx]
                    st.reserved -= 1
                    st.queue.append(mb)
                    mb.location = ("queue", idx)
                    if mb.traced:
                        self._trace_open(mb, ("squeue", idx), self.clock_s)
        self._schedule()
        return True

    def _schedule(self) -> None:
        """Start every action the current state allows (fixpoint)."""
        k = len(self._stages)
        progress = True
        while progress:
            progress = False
            # sends, downstream-first, so freed slots propagate upstream
            for s in range(k - 1, -1, -1):
                st = self._stages[s]
                if not st.out:
                    continue
                h = s + 1  # outgoing hop index
                if self._links_busy[h] is not None:
                    continue
                if h < k:
                    dst = self._stages[h]
                    if len(dst.queue) + dst.reserved >= self.queue_depth:
                        continue  # backpressure: no slot downstream
                    dst.reserved += 1
                    dst.max_queue = max(dst.max_queue, len(dst.queue) + dst.reserved)
                mb = st.out.popleft()
                if mb.traced:
                    self._trace_close(mb, self.clock_s)  # out-buffer wait
                    self._trace_open(mb, ("xfer", h), self.clock_s)
                mb.location = ("link", h)
                mb.ready_at = self.clock_s + self._link_s[h]
                self._links_busy[h] = mb
                progress = True
            # compute starts: serial stage, blocked while its out buffer holds
            for s in range(k):
                st = self._stages[s]
                if st.current is None and not st.out and st.queue:
                    mb = st.queue.popleft()
                    if mb.traced:
                        self._trace_close(mb, self.clock_s)  # stage-queue wait
                        self._trace_open(mb, ("exec", s), self.clock_s)
                    st.current = mb
                    mb.location = ("compute", s)
                    mb.ready_at = self.clock_s + st.compute_s
                    progress = True
            # admission: one microbatch per free input hop + free slot.
            # Continuous batching: with max_batch set, coalesce everything
            # queued (up to the cap) into one batch instead of the fixed
            # microbatch target -- queue pressure dynamically widens batches.
            st0 = self._stages[0]
            if (
                self.queue
                and self._links_busy[0] is None
                and len(st0.queue) + st0.reserved < self.queue_depth
            ):
                cap = self.max_batch if self.max_batch is not None else self.microbatch
                take = min(cap, len(self.queue))
                with region("seifer.engine.admit"):
                    batch = self._take_batch(take)
                    now = time.monotonic()
                    for r in batch:
                        since = self._host_queued.pop(r.req_id, None)
                        if since is not None:
                            self._admission_waits += 1
                            self._admission_wait_s += now - since
                    self._max_batch_seen = max(self._max_batch_seen, len(batch))
                    mb = Microbatch(
                        self._next_mb, batch,
                        stack_batch([r.x for r in batch],
                                    self.control.pipeline.device),
                        stage=0, location=("link", 0),
                        ready_at=self.clock_s + self._link_s[0],
                    )
                tr = self.tracer
                if tr is not None:
                    traced = [r for r in batch if tr.sampled(r.req_id)]
                    if traced:
                        mb.traced = traced
                        for r in traced:
                            # the admission-queue span runs from the last
                            # (re-)entry into admission to now
                            self._emit_span(
                                r, "queue", tr.queue_take(r), self.clock_s)
                        self._trace_open(mb, ("xfer", 0), self.clock_s)
                self._next_mb += 1
                self._links_busy[0] = mb
                st0.reserved += 1
                st0.max_queue = max(st0.max_queue, len(st0.queue) + st0.reserved)
                self._inflight.append(mb)
                progress = True

    def _take_batch(self, take: int) -> list[Request]:
        """Pop ``take`` requests off admission, highest priority class first,
        FIFO within a class (the common all-one-priority case stays a pure
        popleft loop)."""
        if take >= len(self.queue) or all(
            r.priority == self.queue[0].priority for r in self.queue
        ):
            return [self.queue.popleft() for _ in range(take)]
        order = sorted(range(len(self.queue)),
                       key=lambda i: (-self.queue[i].priority, i))
        chosen = sorted(order[:take])  # admission order within the batch
        batch = [self.queue[i] for i in chosen]
        left = set(chosen)
        self.queue = deque(
            r for i, r in enumerate(self.queue) if i not in left)
        return batch

    def _readmit(self, requests: list[Request], *, retry: bool) -> None:
        """Send a microbatch's requests back to the front of admission.

        ``retry=True`` charges an attempt (the batch was resident on a
        failed resource) and moves exhausted requests to ``failed``;
        ``retry=False`` is a free retransmission (input hop)."""
        tr = self.tracer
        for req in reversed(requests):
            if retry:
                req.attempts += 1
                if req.attempts >= self.max_attempts:
                    self.failed.append(req)
                    self._host_queued.pop(req.req_id, None)
                    if tr is not None:
                        tr.forget(req.req_id)
                    if self._registry is not None:
                        self._registry.counter(
                            "requests_failed", engine="pipelined").inc()
                    continue
            self.queue.appendleft(req)
            self._host_queued[req.req_id] = time.monotonic()
            if tr is not None and tr.sampled(req.req_id):
                tr.queue_open(req.req_id, self.clock_s)

    def _requeue_stalled(self, stalled: list[Microbatch]) -> None:
        """Pull transfers off dead links and send their requests back to
        admission with an attempt (only link rides can be infinite -- a
        stage compute is finite whenever its node models flops at all)."""
        self._requeues += len(stalled)
        for mb in sorted(stalled, key=lambda m: -m.mb_id):
            if mb.traced:
                self._trace_close(mb, self.clock_s)  # truncated dead-link ride
            h = mb.location[1]
            self._links_busy[h] = None
            if h < len(self._stages):  # hop h had reserved stage h's in-slot
                self._stages[h].reserved -= 1
            self._inflight.remove(mb)
            self._readmit(mb.requests, retry=True)

    def _complete(self, mb: Microbatch) -> None:
        self._inflight.remove(mb)
        self._mb_completed += 1
        reg = self._registry
        if reg is not None:
            reg.counter("requests_completed", engine="pipelined").inc(
                len(mb.requests))
            reg.counter("microbatches_completed", engine="pipelined").inc()
        for i, req in enumerate(mb.requests):
            req.result = mb.x[i]
            req.completed_s = self.clock_s
            self.completed.append(req)
            if reg is not None:
                reg.histogram(
                    "request_latency_s", engine="pipelined",
                ).observe(req.latency_s)

    # -- span tracing ----------------------------------------------------------
    # A microbatch carries at most one OPEN phase (``mb.phase``): the
    # engine-internal state it is currently occupying, tagged by location
    # kind -- ("squeue", s) stage-input wait, ("exec", s) compute,
    # ("out", s) out-buffer wait, ("xfer", h) riding hop h.  Every state
    # transition closes the open phase (emitting one span per traced
    # request -- link windows are tiled into encode/wire/decode via the
    # per-hop analytic parts) and opens the next at the same clock tick,
    # so a completed request's spans tile [submitted_s, completed_s)
    # exactly.

    def _trace_open(self, mb: Microbatch, phase: tuple, t: float) -> None:
        mb.phase = phase
        mb.phase_t0 = t

    def _trace_close(self, mb: Microbatch, t1: float) -> None:
        if mb.phase is None:
            return
        name, idx = mb.phase
        t0 = mb.phase_t0
        mb.phase = None
        if t1 <= t0:
            return
        emit = self.tracer.record_many
        gen = self.control.generation
        if name == "xfer":
            parts = (self._link_parts[idx] if idx < len(self._link_parts)
                     else (0.0, t1 - t0, 0.0))
            codec = (self._link_codecs[idx]
                     if idx < len(self._link_codecs) else None)
            cname = codec.name if codec is not None else None
            for phase, a, b in split_window(t0, t1, parts):
                emit(mb.traced, phase, a, b, hop=idx, codec=cname,
                     generation=gen)
        elif name == "exec":
            emit(mb.traced, "exec", t0, t1, stage=idx, generation=gen)
        else:  # "squeue" / "out": stage-attributed queueing
            emit(mb.traced, "queue", t0, t1, stage=idx, generation=gen)

    def _emit_span(self, req: Request, phase: str, t0: float, t1: float, *,
                   stage: int | None = None, hop: int | None = None,
                   codec: str | None = None) -> None:
        self.tracer.record(
            req.req_id, phase, t0, t1, stage, hop,
            req.replica, req.tenant, codec,
            self.control.generation, req.attempts)


class ReplicatedServingLoop:
    """Cluster-wide request router over R per-replica pipelined engines.

    Each replica runs its own ``PipelinedServingLoop`` (its own stages,
    links, and virtual clock); the router co-simulates them on one shared
    timeline by always advancing the *lagging* replica (the discrete-event
    rule: process the earliest pending event first).  Admission policy:

      * **shortest expected wait** -- a request goes to the replica whose
        ``clock + backlog x predicted microbatch period`` is smallest (the
        period comes from the replica's as-deployed plan, so routing adapts
        when a replica is re-placed onto slower links);
      * **bounded per-replica backlog** -- a replica holds at most
        ``replica_backlog`` undelivered requests; when every live replica is
        full, requests wait in the cluster-wide queue (backpressure composes
        with the per-stage ``queue_depth`` bounds inside each engine);
      * **retirement** -- when a replica's group can no longer host the
        model (its control plane's recovery raises), the replica is retired:
        its resident requests are reclaimed into the cluster-wide queue
        (stage residents charged an attempt, input-hop riders and
        still-queued requests free) and re-routed to the survivors.

    Same surface as ``PipelinedServingLoop`` (``submit`` / ``step`` /
    ``drain`` / ``metrics`` / ``backlog`` / ``steady_state_throughput``), so
    ``Deployment`` and the benchmarks treat R pipelines as one.
    """

    def __init__(
        self,
        replicaset: ReplicaSet,
        *,
        microbatch: int = 4,
        queue_depth: int = 2,
        max_attempts: int = 5,
        recovery_penalty_s: float = 0.25,
        replica_backlog: int = 32,
        max_batch: int | None = None,
        admission_depth: int | None = None,
        class_priority: dict[str, int] | None = None,
        class_targets: dict[str, float | None] | None = None,
        tracer=None,
        registry=None,
    ):
        if replica_backlog < 1:
            raise ValueError("replica_backlog must be >= 1")
        if admission_depth is not None and admission_depth < 1:
            raise ValueError("admission_depth must be >= 1")
        self.replicaset = replicaset
        self.tracer = tracer
        self._registry = registry
        # the admission bound lives at the router (cluster-wide queue); the
        # per-replica engines are bound by replica_backlog, never rejecting.
        # tracer/registry ride along so autoscaler-grown replicas
        # (add_replica) record into the same deployment-wide plane
        self._engine_kw = dict(
            microbatch=microbatch, queue_depth=queue_depth,
            max_attempts=max_attempts, recovery_penalty_s=recovery_penalty_s,
            max_batch=max_batch, class_priority=class_priority,
            class_targets=class_targets, tracer=tracer, registry=registry,
        )
        self.loops = [
            PipelinedServingLoop(control, **self._engine_kw)
            for control in replicaset.controls
        ]
        self.microbatch = int(microbatch)
        self.max_attempts = int(max_attempts)
        self.replica_backlog = int(replica_backlog)
        self.admission_depth = (
            None if admission_depth is None else int(admission_depth))
        self.class_priority = dict(class_priority or {})
        self.class_targets = dict(class_targets or {})
        self.autoscaler = None  # attached by deploy() when the spec asks
        self.queue: deque[Request] = deque()  # cluster-wide admission
        self.completed: list[Request] = []
        self.rejected: list[Request] = []
        self._arrivals: list[tuple[float, int, Request]] = []
        self._arrival_seq = 0
        self._router_failed: list[Request] = []
        self._next_id = 0
        self.dispatched = [0] * len(self.loops)
        self._reclaimed = [False] * len(self.loops)

    # -- aggregate views -------------------------------------------------------
    @property
    def clock_s(self) -> float:
        return max((loop.clock_s for loop in self.loops), default=0.0)

    @property
    def failed(self) -> list[Request]:
        return self._router_failed + [
            req for loop in self.loops for req in loop.failed
        ]

    @property
    def backlog(self) -> int:
        """Undelivered requests anywhere: router queue + every replica
        (dispatched-but-not-yet-arrived requests included -- they are
        committed to a replica even though its clock lags their timestamp)."""
        return len(self.queue) + sum(
            loop.backlog + loop.pending_arrivals for loop in self.loops)

    @property
    def pending(self) -> int:
        return self.replicaset.pending

    @property
    def arrivals(self) -> list[Request]:
        """Scheduled requests the router has not admitted yet."""
        return [req for _, _, req in self._arrivals]

    @property
    def pending_arrivals(self) -> int:
        return len(self._arrivals)

    # -- admission -------------------------------------------------------------
    def submit(self, x: Any, *, slo_class: str | None = None) -> Request:
        req = Request(
            self._next_id, x, submitted_s=self.clock_s, slo_class=slo_class,
            priority=self.class_priority.get(slo_class, 0),
        )
        self._next_id += 1
        self.queue.append(req)
        return req

    def schedule(self, x: Any, at_s: float, *,
                 slo_class: str | None = None) -> Request:
        """Open-loop admission by trace timestamp (see the engine's
        ``schedule``); the router admits arrivals as its clock passes them
        and sheds load past ``admission_depth``."""
        req = Request(
            self._next_id, x, submitted_s=float(at_s), slo_class=slo_class,
            priority=self.class_priority.get(slo_class, 0),
        )
        self._next_id += 1
        if req.submitted_s <= self.clock_s:
            self.queue.append(req)
            self._shed()
        else:
            self._arrival_seq += 1
            heapq.heappush(
                self._arrivals, (req.submitted_s, self._arrival_seq, req))
        return req

    def _admit_due(self) -> None:
        """Admit every arrival the router clock has passed, dispatch, then
        shed whatever exceeds the cluster-wide admission bound (newest
        first, so earlier arrivals keep their place in line)."""
        due = False
        while self._arrivals and self._arrivals[0][0] <= self.clock_s:
            _, _, req = heapq.heappop(self._arrivals)
            self.queue.append(req)
            due = True
        if due:
            self._dispatch()
            self._shed()

    def _shed(self) -> None:
        if self.admission_depth is None:
            return
        while len(self.queue) > self.admission_depth:
            self.rejected.append(self.queue.pop())
            if self._registry is not None:
                self._registry.counter(
                    "requests_rejected", engine="router").inc()

    # -- one serving round -----------------------------------------------------
    def step(self) -> list[Request]:
        """Advance the lagging replica until some replica completes a
        request (or the whole set is idle)."""
        done0 = len(self.completed)
        rset = self.replicaset
        for r in range(len(self.loops)):
            if rset.retired[r] and not self._reclaimed[r]:
                self._reclaim(r)  # retired out of band (direct reconcile())
        rset.advance_rollout()
        if self.autoscaler is not None:
            self.autoscaler.observe(self)
        self._admit_due()
        self._dispatch()
        guard = 0
        while len(self.completed) == done0:
            guard += 1
            if guard > 1_000_000:
                raise RuntimeError("replica router made no progress")
            live = rset.live_indices()
            if not live:
                # every replica retired: grow from the standby pool if an
                # autoscaler can, else nothing left can ever serve
                if (self.autoscaler is not None
                        and self.autoscaler.restore(self)):
                    continue
                while self.queue:
                    self._router_failed.append(self.queue.popleft())
                while self._arrivals:
                    _, _, req = heapq.heappop(self._arrivals)
                    self._router_failed.append(req)
                break
            active = [
                r for r in live
                if self.loops[r].backlog or self.loops[r].pending_arrivals
                or self.loops[r].control.pending
            ]
            if not active:
                if self._arrivals:
                    # idle gap in the trace: jump every live clock to the
                    # next arrival (the replicas share one timeline)
                    t = self._arrivals[0][0]
                    for i in live:
                        self.loops[i]._elapse(t)
                    self._admit_due()
                    self._dispatch()
                    continue
                break  # idle (the dispatch above drained the router queue)
            r = min(active, key=lambda i: (self.loops[i].clock_s, i))
            try:
                self.completed.extend(self.loops[r].step())
            except RuntimeError as e:
                rset.mark_retired(r, str(e))
                self._reclaim(r)
            rset.advance_rollout()
            if self.autoscaler is not None:
                self.autoscaler.observe(self)
            self._admit_due()
            self._dispatch()
        return self.completed[done0:]

    def drain(self, max_rounds: int = 100_000) -> list[Request]:
        done: list[Request] = []
        for _ in range(max_rounds):
            if (not self.backlog and not self._arrivals
                    and not self.pending):
                break
            done.extend(self.step())
        return done

    # -- routing ---------------------------------------------------------------
    def _expected_ready_s(self, r: int) -> float:
        """Shortest-expected-wait estimate: the replica's clock plus its
        backlog served at the planner-predicted microbatch period."""
        loop = self.loops[r]
        plan = self.replicaset.controls[r].last_plan
        rate = plan.predicted_throughput if plan is not None else 0.0
        period = 1.0 / rate if rate > 0 and rate != float("inf") else 0.0
        batches = loop.backlog // max(1, loop.microbatch) + 1
        return loop.clock_s + batches * period

    def _dispatch(self) -> None:
        """Route router-queue requests to replicas; stop at backpressure."""
        while self.queue:
            best = None
            for r in self.replicaset.live_indices():
                held = self.loops[r].backlog + self.loops[r].pending_arrivals
                if held >= self.replica_backlog:
                    continue
                key = (self._expected_ready_s(r), held, r)
                if best is None or key < best[0]:
                    best = (key, r)
            if best is None:
                return  # every live replica is full (or none is live)
            r = best[1]
            req = self.queue.popleft()
            req.replica = r
            # timestamped handoff: a lagging replica must not serve the
            # request before its cluster-wide arrival time
            self.loops[r].schedule_request(req)
            self.dispatched[r] += 1

    def add_replica(self, control: ControlPlane, group) -> int:
        """Attach a freshly-bootstrapped replica (the autoscaler's grow
        path).  The new engine's clock starts at the router's current time,
        so its completions never predate its birth."""
        r = self.replicaset.add_replica(control, group)
        loop = PipelinedServingLoop(control, **self._engine_kw)
        loop.clock_s = self.clock_s
        self.loops.append(loop)
        self.dispatched.append(0)
        self._reclaimed.append(False)
        self._dispatch()
        return r

    def _reclaim(self, r: int) -> None:
        """Pull every request out of a retired replica and re-route it.

        The engine owns the requeue semantics (``evacuate``): requests
        resident on the replica's stages/links come back charged an attempt
        (their work was lost), input-hop riders and still-queued requests
        free."""
        self._reclaimed[r] = True
        # front of the router queue, original relative order preserved
        for req, charged in reversed(self.loops[r].evacuate()):
            if charged:
                req.attempts += 1
                if req.attempts >= self.max_attempts:
                    self._router_failed.append(req)
                    continue
            self.queue.appendleft(req)

    # -- metrics ---------------------------------------------------------------
    def metrics(self) -> dict:
        done = len(self.completed)
        t = self.clock_s
        live = set(self.replicaset.live_indices())
        out = {
            "mode": "replicated",
            "completed": done,
            "failed": len(self.failed),
            "rejected": len(self.rejected),
            "backlog": self.backlog,
            "pending_arrivals": self.pending_arrivals,
            "clock_s": t,
            "throughput": done / t if t > 0 else 0.0,
            "retries": sum(r.attempts for r in self.completed),
            "latency": latency_report(self.completed, self.class_targets),
            "n_replicas": len(self.loops),
            "live_replicas": len(live),
            "router": {
                "policy": "shortest_expected_wait",
                "replica_backlog": self.replica_backlog,
                "admission_depth": self.admission_depth,
                "queued": len(self.queue),
                "dispatched": list(self.dispatched),
            },
            "replicas": [
                {"replica": r, "retired": r not in live, **loop.metrics()}
                for r, loop in enumerate(self.loops)
            ],
        }
        if self.autoscaler is not None:
            out["autoscaler"] = self.autoscaler.metrics()
        return normalize_metrics(out)

    def steady_state_throughput(self, skip_frac: float = 0.5) -> float:
        """Aggregate requests/s: the sum of the live replicas' steady-state
        rates (each measured on its own completion tail)."""
        return float(sum(
            self.loops[r].steady_state_throughput(skip_frac)
            for r in self.replicaset.live_indices()
        ))
