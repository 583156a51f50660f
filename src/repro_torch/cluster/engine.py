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

Stage executors run for real on the deployment's device: each admitted
microbatch is ``torch.stack``-ed onto it, every stage compute runs the
executor (kernels included), and every hop applies its codec's transform.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import torch

from repro_torch.cluster.controlplane import ControlPlane, ReconcileAction
from repro_torch.cluster.events import NodeFailed
from repro_torch.cluster.lifecycle import Pod
from repro_torch.cluster.serving import Request, latency_report, normalize_metrics
from repro_torch.core.bottleneck import service_times
from repro_torch.dataplane.base import EncodedActivation

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

    Reconciles pending events before advancing; a non-trivial reconcile
    costs ``recovery_penalty_s`` of virtual time.
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
        class_priority: dict[str, int] | None = None,
        class_targets: dict[str, float | None] | None = None,
    ):
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if max_batch is not None and max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.control = control
        self.microbatch = int(microbatch)
        self.queue_depth = int(queue_depth)
        self.max_attempts = int(max_attempts)
        self.recovery_penalty_s = float(recovery_penalty_s)
        # continuous batching: coalesce up to max_batch queued requests per
        # admission (None keeps the fixed microbatch target of closed loops)
        self.max_batch = None if max_batch is None else int(max_batch)
        self.class_priority = dict(class_priority or {})
        self.class_targets = dict(class_targets or {})
        self.queue: deque[Request] = deque()  # admission queue
        self.completed: list[Request] = []
        self.failed: list[Request] = []
        self._max_batch_seen = 0
        self.clock_s = 0.0
        self._next_id = 0
        self._next_mb = 0
        self._inflight: list[Microbatch] = []
        self._stages: list[StageState] = []
        self._link_s: list[float] = []  # per-hop transfer time, len k+1
        self._links_busy: list[Microbatch | None] = []
        self._link_codecs: list = []  # Codec per hop (None = raw / no wire)
        self._link_raw: list[float] = []  # raw boundary bytes per hop
        self._link_wire: list[float] = []  # on-wire bytes per hop
        self._link_busy_s: list[float] = []  # time each link spent occupied
        self._link_xfers: list[int] = []  # completed transfers per hop
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
        self.queue.append(req)
        return req

    @property
    def backlog(self) -> int:
        """Requests not yet delivered: admission queue + in-flight batches."""
        return len(self.queue) + sum(len(m.requests) for m in self._inflight)

    # -- one serving round -----------------------------------------------------
    def step(self) -> list[Request]:
        """Advance the virtual clock until the next completion (or idle).

        Pending control-plane events (and unannounced failures discovered by
        the health check) are reconciled first, requeueing exactly the
        in-flight microbatches resident on affected stages.
        """
        done0 = len(self.completed)
        pipe = self.control.pipeline
        if pipe is None:
            raise RuntimeError("bootstrap the control plane before serving")
        if pipe is not self._bound_pipeline:
            # out-of-band swap (a redeploy reconciled outside step()): nothing
            # carries over
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
        self._schedule()
        while len(self.completed) == done0:
            if not self._advance():
                break
        return self.completed[done0:]

    def drain(self, max_rounds: int = 100_000) -> list[Request]:
        """Step until every admitted request completes (or max_rounds)."""
        done: list[Request] = []
        for _ in range(max_rounds):
            if not self.backlog and not self.control.pending:
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
            "backlog": self.backlog,
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
            elif kind == "out":
                self._stages[idx].out.append(mb)
            else:  # hop idx >= 1: retransmit from the source stage's out buffer
                mb.location = ("out", idx - 1)
                self._stages[idx - 1].out.append(mb)
        # back to admission newest-first so it re-admits in original order
        self._requeues += len(requeue)
        retried = {id(mb) for mb in requeue}
        for mb in sorted(requeue + readmit, key=lambda m: -m.mb_id):
            self._readmit(mb.requests, retry=id(mb) in retried)

    # -- discrete-event core ---------------------------------------------------
    def _elapse(self, t: float) -> None:
        """Advance the clock to ``t``, integrating queue occupancy."""
        dt = max(0.0, t - self.clock_s)
        for st in self._stages:
            st.queue_area += len(st.queue) * dt
        self.clock_s = max(self.clock_s, t)

    def _advance(self) -> bool:
        """Pop the earliest event batch off the virtual clock; False if idle."""
        pend = [m for m in self._inflight if m.location[0] in ("compute", "link")]
        times = [m.ready_at for m in pend]
        if not times:
            return False  # idle
        t = min(times)
        if t == float("inf"):
            # every pending event is a transfer on a dead link: it can never
            # finish, so retry the riders instead of hanging callers that
            # loop on backlog.  attempts bound the retries (-> failed), the
            # sync loop's liveness guarantee.
            self._requeue_stalled([m for m in pend if m.ready_at == float("inf")])
            self._schedule()
            return True
        self._elapse(t)
        k = len(self._stages)
        for mb in sorted(pend, key=lambda m: m.mb_id):
            if mb.ready_at > t:
                continue
            kind, idx = mb.location
            if kind == "compute":
                st = self._stages[idx]
                part = st.pod.partition
                mb.x = self.control.pipeline.executor(part.start, part.stop, mb.x)
                st.busy_s += st.compute_s
                st.completed += 1
                st.current = None
                mb.stage = idx + 1
                mb.location = ("out", idx)
                st.out.append(mb)
            else:  # transfer on hop idx finished
                self._links_busy[idx] = None
                self._link_busy_s[idx] += self._link_s[idx]
                self._link_xfers[idx] += 1
                codec = self._link_codecs[idx] if idx < len(self._link_codecs) else None
                if codec is not None:
                    executor = self.control.pipeline.executor
                    if (idx != k and codec.name
                            in getattr(executor, "fused_codecs", ())):
                        # fused decode: the receiving stage's first op
                        # consumes the wire payload directly (e.g. int8 ->
                        # dequant-matmul), so hand over the still-encoded
                        # activation instead of eagerly decoding it
                        mb.x = EncodedActivation(codec, codec.encode(mb.x))
                    else:
                        # the receiver sees decode(encode(x)): the codec's
                        # real transform (the int8 kernels on CUDA) runs on
                        # the activations riding the wire
                        mb.x = codec.transcode(mb.x)
                if idx == k:
                    self._complete(mb)
                else:
                    st = self._stages[idx]
                    st.reserved -= 1
                    st.queue.append(mb)
                    mb.location = ("queue", idx)
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
                mb.location = ("link", h)
                mb.ready_at = self.clock_s + self._link_s[h]
                self._links_busy[h] = mb
                progress = True
            # compute starts: serial stage, blocked while its out buffer holds
            for s in range(k):
                st = self._stages[s]
                if st.current is None and not st.out and st.queue:
                    mb = st.queue.popleft()
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
                batch = self._take_batch(take)
                self._max_batch_seen = max(self._max_batch_seen, len(batch))
                mb = Microbatch(
                    self._next_mb, batch,
                    self._stack([r.x for r in batch]),
                    stage=0, location=("link", 0),
                    ready_at=self.clock_s + self._link_s[0],
                )
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
        for req in reversed(requests):
            if retry:
                req.attempts += 1
                if req.attempts >= self.max_attempts:
                    self.failed.append(req)
                    continue
            self.queue.appendleft(req)

    def _requeue_stalled(self, stalled: list[Microbatch]) -> None:
        """Pull transfers off dead links and send their requests back to
        admission with an attempt (only link rides can be infinite -- a
        stage compute is finite whenever its node models flops at all)."""
        self._requeues += len(stalled)
        for mb in sorted(stalled, key=lambda m: -m.mb_id):
            h = mb.location[1]
            self._links_busy[h] = None
            if h < len(self._stages):  # hop h had reserved stage h's in-slot
                self._stages[h].reserved -= 1
            self._inflight.remove(mb)
            self._readmit(mb.requests, retry=True)

    def _stack(self, xs: list) -> torch.Tensor:
        """One microbatch on the pipeline's device (``torch.as_tensor`` also
        takes numpy inputs; a tensor already there is not copied)."""
        device = self.control.pipeline.device
        return torch.stack([torch.as_tensor(x, device=device) for x in xs])

    def _complete(self, mb: Microbatch) -> None:
        self._inflight.remove(mb)
        self._mb_completed += 1
        for i, req in enumerate(mb.requests):
            req.result = mb.x[i]
            req.completed_s = self.clock_s
            self.completed.append(req)
