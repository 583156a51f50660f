"""Continuous-reconciliation control plane for the SEIFER edge cluster.

The one-shot ``configure -> deploy`` calls in ``dispatcher.py`` are the
*mechanism*; this module is the *policy* loop that keeps a cluster converged
under churn.  A ``ControlPlane`` owns

  * a **desired state** (``DesiredState``): model version + layer graph,
    per-node capacity, boundary compression,
  * an **observed state** (``ObservedState``): deployed version, restart
    generation, pod path, node health, leader, measured bottleneck,

and drives observed -> desired through typed events (``cluster/events.py``).
Convergence is *event-class-aware*, exactly the paper's Sec. 2.3 rules:

  ===============  ========================================================
  event            convergence action
  ===============  ========================================================
  VersionBumped    in-place redeploy: stop pods, re-partition/place the new
                   graph on the already-probed bandwidths; no restart
  NodeFailed       re-place existing partitions onto healthy nodes (store
                   restart path); full reconfigure only as fallback
  NodeJoined       FULL cluster restart: re-elect, re-probe, re-partition,
                   re-place, re-deploy (generation += 1)
  LinkDegraded     re-place only if an active boundary rides the link and
                   the bottleneck worsens past ``link_tolerance``
  ===============  ========================================================

``reconcile()`` drains the event queue, applies the actions, then runs a
drift check (unhealthy pipeline with no explaining event -> re-place), and
returns the ``ReconcileAction`` log so callers can assert on *what* the
control plane did, not just the end state.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Sequence

from repro_torch.api.planner import Plan, Planner, ReplicatedPlan
from repro_torch.cluster.dispatcher import UNSET, Dispatcher
from repro_torch.cluster.events import (
    ClusterEvent,
    LinkDegraded,
    NodeFailed,
    NodeJoined,
    VersionBumped,
)
from repro_torch.cluster.lifecycle import EdgeCluster, ExecutorFn, InferencePipeline
from repro_torch.cluster.store import ArtifactStore
from repro_torch.core.graph import LayerGraph


@dataclasses.dataclass
class DesiredState:
    """What should be running: the spec the reconciler converges toward."""

    version: int
    graph: LayerGraph
    capacity: float | None = None
    compression_ratio: float = 1.0


@dataclasses.dataclass(frozen=True)
class ObservedState:
    """Snapshot of what *is* running."""

    version: int
    generation: int  # full-restart counter (bumps only on node join)
    leader: int | None
    path: tuple[int, ...]
    n_nodes: int
    healthy: bool
    bottleneck_latency: float


@dataclasses.dataclass(frozen=True)
class ReconcileAction:
    """One convergence step taken by ``reconcile()``."""

    event: ClusterEvent | None  # None for drift-check repairs
    kind: str  # "redeploy" | "replace" | "restart" | "noop"
    detail: str = ""


class ControlPlane:
    """Event-driven reconciler over the dispatcher/watch/lifecycle mechanism.

    Parameters
    ----------
    graph_for_version:
        version -> LayerGraph, the external model repository's view.
    executor_for_version:
        version -> ExecutorFn running partition [start, stop) on an input.
        Versions may change weights, so the executor is versioned too.
    planner:
        strategy resolution (``repro_torch.api.Planner``); ``None`` builds the
        default (``min_bottleneck`` + ``color_coding``, the paper pipeline).
    """

    def __init__(
        self,
        cluster: EdgeCluster,
        store: ArtifactStore,
        graph_for_version: Callable[[int], LayerGraph],
        executor_for_version: Callable[[int], ExecutorFn],
        *,
        planner: Planner | None = None,
        capacity: float | None = None,
        compression_ratio: float = 1.0,
        n_classes: int | None = UNSET,
        link_tolerance: float = 1.25,
        seed: int = 0,
        allowed_nodes: set[int] | None = None,
        hosting_nodes: set[int] | None = None,
        scoped_recovery: bool = True,
        recovery_width: int | None = None,
        device=None,
        journal=None,
        journal_source: str = "control",
    ):
        self.cluster = cluster
        self.store = store
        self.graph_for_version = graph_for_version
        self.executor_for_version = executor_for_version
        self.dispatcher = Dispatcher(
            cluster, store, planner=planner, n_classes=n_classes, seed=seed,
            allowed_nodes=allowed_nodes, hosting_nodes=hosting_nodes,
            device=device,
        )
        self.link_tolerance = link_tolerance
        # NodeFailed recovery scope: re-solve only the failure neighborhood
        # (surviving path + recovery_width best-connected spares), falling
        # back to a full re-solve when the scoped one is infeasible
        self.scoped_recovery = scoped_recovery
        self.recovery_width = recovery_width
        self._default_capacity = capacity
        self._default_compression = compression_ratio
        self.desired: DesiredState | None = None
        self.pipeline: InferencePipeline | None = None
        self.generation = 0
        self._events: deque[ClusterEvent] = deque()
        self.history: list[ReconcileAction] = []
        # shared control-plane journal (obs.journal.Journal); every non-noop
        # decision ALSO lands there, tagged with this plane's source name
        self.journal = journal
        self.journal_source = str(journal_source)

    # -- bootstrap -----------------------------------------------------------
    def bootstrap(
        self,
        version: int,
        *,
        capacity: float | None = None,
        compression_ratio: float | None = None,
    ) -> InferencePipeline:
        """Initial convergence: elect, probe, configure, deploy (Sec. 2.1-2.2).

        ``capacity`` / ``compression_ratio`` default to the constructor's
        values; pass them here only to override per-bootstrap.
        """
        if capacity is None:
            capacity = self._default_capacity
        if compression_ratio is None:
            compression_ratio = self._default_compression
        graph = self.graph_for_version(version)
        self.desired = DesiredState(version, graph, capacity, compression_ratio)
        self.dispatcher.elect_leader()
        self.dispatcher.probe_bandwidths()
        plan = self._configure(graph, version)
        self.pipeline = self.dispatcher.deploy(
            plan, self.executor_for_version(version),
            compression_ratio=compression_ratio,
        )
        self.store.publish(version)
        return self.pipeline

    def _configure(self, graph: LayerGraph, version: int) -> Plan:
        plan = self.dispatcher.configure(
            graph, version, capacity=self.desired.capacity,
            compression_ratio=self.desired.compression_ratio,
        )
        if not plan.feasible:
            raise RuntimeError(f"version {version} does not fit the cluster")
        return plan

    @property
    def last_plan(self) -> Plan | None:
        """The plan matching what is deployed: the dispatcher keeps it
        current across configure AND the re-placement recovery path."""
        return self.dispatcher.last_plan

    # -- strategy swap -------------------------------------------------------
    @property
    def planner(self) -> Planner:
        return self.dispatcher.planner

    def replan(self, planner: Planner | None = None) -> Plan:
        """Re-plan the desired state (optionally under a new ``Planner``) and
        redeploy in place -- probed bandwidths, leader, and generation are
        reused, exactly like a version bump without the version.

        This is how a live deployment swaps strategies
        (``Deployment.replan(partitioner=..., placer=...)`` builds the
        planner and calls here).  Raises if the new plan is infeasible,
        leaving the running pipeline untouched.
        """
        if self.desired is None or self.pipeline is None:
            raise RuntimeError("bootstrap() before replan()")
        old_planner = self.dispatcher.planner
        if planner is not None:
            self.dispatcher.planner = planner
        try:
            plan = self._configure(self.desired.graph, self.desired.version)
        except RuntimeError:
            self.dispatcher.planner = old_planner  # keep a working strategy
            raise
        for pod in self.pipeline.pods:  # stop the old inference pods
            pod.alive = False
        self.pipeline = self.dispatcher.deploy(
            plan, self.executor_for_version(self.desired.version),
            compression_ratio=self.desired.compression_ratio,
        )
        self.history.append(ReconcileAction(
            None, "redeploy",
            f"replan with {dict(plan.strategies)}",
        ))
        self._journal_action(self.history[-1])
        return plan

    # -- event intake --------------------------------------------------------
    def submit(self, event: ClusterEvent) -> None:
        """Enqueue an observation; convergence happens at ``reconcile()``."""
        self._events.append(event)

    def owned_nodes(self) -> set[int] | None:
        """Nodes within this control plane's view (``None`` = unmasked,
        the whole cluster).  Tenant- and replica-scoped event routing
        delivers a node's churn only to the planes that own it."""
        allowed = self.dispatcher.allowed_nodes
        return None if allowed is None else set(allowed)

    def adopt_node(self, node_id: int) -> None:
        """Extend a masked view by one node (tenancy/replica-set growth);
        a no-op for unmasked planes, which already see everything."""
        disp = self.dispatcher
        if disp.allowed_nodes is not None:
            disp.allowed_nodes.add(node_id)
        if disp.hosting_nodes is not None:
            disp.hosting_nodes.add(node_id)

    @property
    def pending(self) -> int:
        return len(self._events)

    def pending_events(self) -> tuple[ClusterEvent, ...]:
        """Snapshot of the queued (not yet reconciled) events.

        The pipelined serving engine reads this *before* calling
        ``reconcile()`` to compute which stages a pending ``NodeFailed``
        is about to kill -- the pods are only marked dead during
        reconciliation, but the in-flight microbatches resident on them
        must be requeued, not carried."""
        return tuple(self._events)

    # -- reconciliation ------------------------------------------------------
    def reconcile(self) -> list[ReconcileAction]:
        """Drain the queue, converge observed -> desired, log the actions."""
        if self.desired is None or self.pipeline is None:
            raise RuntimeError("bootstrap() before reconcile()")
        actions: list[ReconcileAction] = []
        while self._events:
            event = self._events.popleft()
            actions.append(self._handle(event))
        # drift check: anything unhealthy that no event explained
        if not self.pipeline.healthy():
            actions.append(
                ReconcileAction(None, "replace", "drift: unhealthy pipeline")
            )
            self._replace()
        self.history.extend(actions)
        for a in actions:
            self._journal_action(a)
        return actions

    def _journal_action(self, action: ReconcileAction) -> None:
        """Record a non-noop reconcile decision on the shared journal."""
        if self.journal is None or action.kind == "noop":
            return
        self.journal.append("reconcile", self.journal_source, {
            "event": (type(action.event).__name__
                      if action.event is not None else None),
            "action": action.kind,
            "detail": action.detail,
        })

    def _handle(self, event: ClusterEvent) -> ReconcileAction:
        if isinstance(event, VersionBumped):
            return self._on_version_bumped(event)
        if isinstance(event, NodeFailed):
            return self._on_node_failed(event)
        if isinstance(event, NodeJoined):
            return self._on_node_joined(event)
        if isinstance(event, LinkDegraded):
            return self._on_link_degraded(event)
        return ReconcileAction(event, "noop", "unknown event class")

    # VersionBumped: in-place redeploy, NO cluster restart (Sec. 2.3).
    def _on_version_bumped(self, event: VersionBumped) -> ReconcileAction:
        if event.version <= self.desired.version:
            return ReconcileAction(event, "noop", "not newer than deployed")
        graph = self.graph_for_version(event.version)
        # plan BEFORE touching the running pods: an infeasible version must
        # not take down a healthy deployment (the watcher will re-emit the
        # event while the store pointer stays ahead of the deployed version)
        try:
            plan = self._configure(graph, event.version)
        except RuntimeError as e:
            return ReconcileAction(
                event, "noop",
                f"rejected: {e}; keeping v{self.desired.version}",
            )
        self.desired = dataclasses.replace(
            self.desired, version=event.version, graph=graph
        )
        for pod in self.pipeline.pods:  # stop the old inference pods
            pod.alive = False
        # reuse the probed bandwidths: no re-election, no re-probe
        self.pipeline = self.dispatcher.deploy(
            plan, self.executor_for_version(event.version),
            compression_ratio=self.desired.compression_ratio,
        )
        if self.store.current_version() < event.version:
            self.store.publish(event.version)
        return ReconcileAction(
            event, "redeploy", f"in-place redeploy at v{event.version}"
        )

    # NodeFailed: re-place surviving partitions; store restart path.
    def _on_node_failed(self, event: NodeFailed) -> ReconcileAction:
        self.cluster.fail(event.node_id)
        dead = self.pipeline.mark_node_failed(event.node_id)
        leader_died = event.node_id == self.dispatcher.leader
        if not dead and not leader_died:
            # no pod to move, but the probed view must not keep showing the
            # dead node as usable for later configures
            self.dispatcher.probe_bandwidths()
            return ReconcileAction(event, "noop", "node hosted no pod")
        scope = (
            self._failure_neighborhood(event.node_id)
            if self.scoped_recovery else None
        )
        self._replace(scope=scope)
        detail = f"re-placed {len(dead)} pod(s) off node {event.node_id}"
        rec = self.dispatcher.last_recovery
        if rec is not None and rec.get("scoped"):
            detail += f"; scoped to {rec['scope_size']} node(s)"
        elif scope is not None:
            detail += "; scoped solve infeasible, full re-solve"
        if leader_died:
            detail += f"; re-elected leader {self.dispatcher.leader}"
        return ReconcileAction(event, "replace", detail)

    # NodeJoined: the paper's full-cluster-restart rule.
    def _on_node_joined(self, event: NodeJoined) -> ReconcileAction:
        if event.node_id is not None:
            self.cluster.heal(event.node_id)
            joined = event.node_id
        else:
            joined = self.cluster.add_node(event.comm)
        self.dispatcher.reset()  # forget leader + probes: full restart
        self.dispatcher.elect_leader()
        self.dispatcher.probe_bandwidths()
        # plan BEFORE stopping the running pods: if the post-join cluster
        # cannot host the model, the old pipeline must keep serving
        try:
            plan = self._configure(self.desired.graph, self.desired.version)
        except RuntimeError as e:
            return ReconcileAction(
                event, "noop", f"rejected: {e}; keeping current deployment"
            )
        for pod in self.pipeline.pods:
            pod.alive = False
        self.generation += 1
        self.pipeline = self.dispatcher.deploy(
            plan, self.executor_for_version(self.desired.version),
            compression_ratio=self.desired.compression_ratio,
        )
        return ReconcileAction(
            event, "restart", f"full restart (gen {self.generation}) after node {joined} joined"
        )

    # LinkDegraded: re-place only when the slow link hurts an active boundary.
    def _on_link_degraded(self, event: LinkDegraded) -> ReconcileAction:
        before = self._current_bottleneck()
        self.cluster.degrade_link(event.a, event.b, event.factor)
        after = self._current_bottleneck()
        if after <= before * self.link_tolerance:
            self.dispatcher.probe_bandwidths()  # keep the probed view current
            return ReconcileAction(
                event, "noop", "bottleneck within tolerance on current path"
            )
        self._replace()
        return ReconcileAction(
            event, "replace",
            f"bottleneck {before:.2e}s -> {after:.2e}s, re-placed",
        )

    def _failure_neighborhood(self, failed: int) -> list[int]:
        """The node slice a ``NodeFailed`` re-solve is scoped to: surviving
        path nodes plus the ``recovery_width`` healthy visible spares with
        the fattest link into the old path (incl. the failed node's
        neighborhood, since the replacement inherits its role)."""
        pipe = self.pipeline
        surviving = [
            p.node_id for p in pipe.pods
            if p.node_id != failed and self.cluster.nodes[p.node_id].healthy
        ]
        allowed = self.dispatcher.allowed_nodes
        anchors = set(surviving) | {failed}
        spares = []
        for node in self.cluster.nodes:
            i = node.node_id
            if (not node.healthy or i in anchors
                    or (allowed is not None and i not in allowed)):
                continue
            bw = max((self.cluster.true_bandwidth(i, a) for a in anchors),
                     default=0.0)
            spares.append((bw, i))
        width = self.recovery_width
        if width is None:
            width = max(4, len(pipe.pods))
        spares.sort(key=lambda t: (-t[0], t[1]))
        return surviving + [i for _, i in spares[:width]]

    def _replace(self, scope: Sequence[int] | None = None) -> None:
        self.pipeline = self.dispatcher.replace_placement(
            self.pipeline, self.desired.graph, self.desired.version,
            capacity=self.desired.capacity, scope_nodes=scope,
        )
        if self.journal is not None and self.dispatcher.last_recovery:
            # the scoped-recovery record (affected stages included) lands on
            # the journal next to the reconcile action that triggered it
            self.journal.append(
                "recovery", self.journal_source,
                dict(self.dispatcher.last_recovery))

    def _current_bottleneck(self) -> float:
        """Max link time of the deployed path on the TRUE bandwidths,
        including the dispatcher round-trip (input to the first partition,
        output from the last) when the leader is not colocated.

        Note the deliberate asymmetry with ``InferencePipeline.run``: the
        serving trace charges only pod-to-pod links (the dispatcher feeds
        requests out-of-band), so measured serving throughput can exceed
        ``1 / bottleneck_latency`` when a leader link is the slowest edge.
        This metric matches the *placement objective* (which also scores
        in_bytes/out_bytes/dispatcher), not the serving clock."""
        pipe = self.pipeline
        lat = 0.0
        for i in range(len(pipe.pods) - 1):
            bw = self.cluster.true_bandwidth(
                pipe.pods[i].node_id, pipe.pods[i + 1].node_id
            )
            bytes_ = pipe.wire_bytes(i)  # compression_ratio + hop codec
            lat = max(lat, float("inf") if bw <= 0 else bytes_ / bw)
        graph = self.desired.graph if self.desired else None
        lead = self.dispatcher.leader
        if graph is not None and lead is not None:
            for bytes_, node in (
                (graph.in_bytes, pipe.pods[0].node_id),
                (graph.layers[-1].out_bytes, pipe.pods[-1].node_id),
            ):
                if bytes_ > 0 and node != lead:
                    bw = self.cluster.true_bandwidth(lead, node)
                    lat = max(lat, float("inf") if bw <= 0 else bytes_ / bw)
        return lat

    # -- observation ---------------------------------------------------------
    def observed(self) -> ObservedState:
        pipe = self.pipeline
        return ObservedState(
            version=self.desired.version if self.desired else -1,
            generation=self.generation,
            leader=self.dispatcher.leader,
            path=tuple(pipe.path()) if pipe else (),
            n_nodes=self.cluster.n,
            healthy=bool(pipe and pipe.healthy()),
            bottleneck_latency=self._current_bottleneck() if pipe else float("inf"),
        )


class ReplicaSet:
    """R ``ControlPlane``s over one shared ``EdgeCluster``, one per disjoint
    node group -- the control side of pipeline replica sets.

    Each replica reconciles independently within its own sub-cluster (its
    dispatcher is masked to the group + the shared dispatcher node), so a
    ``NodeFailed`` re-places -- or, when the group can no longer host the
    model, *retires* -- only the touched replica while the others keep
    serving.  Event routing:

      ===============  ======================================================
      event            routed to
      ===============  ======================================================
      NodeFailed       every live replica whose view contains the node (its
                       owner; all replicas when the shared dispatcher dies)
      NodeJoined       heal: the group that owns the node (or, if its
                       replica retired, adopted by the weakest live one);
                       grow: the node is added to the cluster at intake and
                       adopted by the weakest live replica (full restart of
                       that replica only -- the paper's rule, scoped)
      LinkDegraded     the one live replica hosting an endpoint (replica
                       paths never ride cross-group links, so one tolerance
                       check suffices); no owner -> applied to the cluster
      VersionBumped    ROLLED one replica at a time: the next replica only
                       receives the event after the previous one converged,
                       so aggregate throughput never drops to zero
      ===============  ======================================================
    """

    def __init__(
        self,
        cluster: EdgeCluster,
        controls: Sequence[ControlPlane],
        groups: Sequence[Sequence[int]],
        *,
        dispatcher_node: int = 0,
        journal=None,
    ):
        if len(controls) != len(groups):
            raise ValueError("one node group per control plane")
        self.cluster = cluster
        self.controls = list(controls)
        self.groups = [set(g) for g in groups]
        self.dispatcher_node = dispatcher_node
        self.journal = journal  # rollout/retire transitions land here
        self.retired = [False] * len(self.controls)
        self._rollout_queue: deque[VersionBumped] = deque()
        self._rollout_targets: deque[int] | None = None
        self._rollout_current: int | None = None
        self._rollout_event: VersionBumped | None = None

    # -- introspection -------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return len(self.controls)

    def live_indices(self) -> list[int]:
        return [r for r in range(len(self.controls)) if not self.retired[r]]

    @property
    def pending(self) -> int:
        """Queued events across live replicas + rollout still in flight."""
        n = sum(self.controls[r].pending for r in self.live_indices())
        if self._rollout_event is not None or self._rollout_queue:
            n += 1
        return n

    def observed(self) -> tuple[ObservedState, ...]:
        return tuple(c.observed() for c in self.controls)

    def owned_nodes(self) -> set[int] | None:
        """Union of the live replicas' views (+ the shared dispatcher);
        ``None`` when any live replica is unmasked."""
        out = {self.dispatcher_node}
        for r in self.live_indices():
            allowed = self.controls[r].dispatcher.allowed_nodes
            if allowed is None:
                return None
            out |= set(allowed)
        return out

    def recovery_log(self) -> list[dict | None]:
        """Per-replica ``Dispatcher.last_recovery`` records (``None`` =
        that replica never ran a recovery re-solve).  Chaos tests assert
        scoped recoveries stayed inside the failed replica's neighborhood."""
        return [c.dispatcher.last_recovery for c in self.controls]

    def deployed_plan(self) -> ReplicatedPlan:
        """The as-deployed aggregate: live replicas' current plans."""
        live = self.live_indices()
        return ReplicatedPlan(
            version=max(
                (self.controls[r].desired.version for r in live
                 if self.controls[r].desired), default=-1,
            ),
            replicas=tuple(self.controls[r].last_plan for r in live),
            groups=tuple(tuple(sorted(self.groups[r])) for r in live),
            requested=len(self.controls),
        )

    def rolling_version(self) -> int:
        """Highest version in the rollout machinery; -1 when idle."""
        versions = [e.version for e in self._rollout_queue]
        if self._rollout_event is not None:
            versions.append(self._rollout_event.version)
        return max(versions, default=-1)

    # -- event intake --------------------------------------------------------
    def submit(self, event: ClusterEvent) -> None:
        """Route one cluster disturbance to the replica(s) it touches."""
        if isinstance(event, VersionBumped):
            self._rollout_queue.append(event)
            self.advance_rollout()
            return
        if isinstance(event, NodeFailed):
            owners = [
                r for r in self.live_indices()
                if (allowed := self.controls[r].dispatcher.allowed_nodes) is None
                or event.node_id in allowed
            ]
            if not owners:
                # a retired replica's node (or an unknown one): keep the
                # shared cluster state honest, no pipeline is affected
                self.cluster.fail(event.node_id)
                return
            for r in owners:
                self.controls[r].submit(event)
            return
        if isinstance(event, NodeJoined):
            self._route_node_joined(event)
            return
        if isinstance(event, LinkDegraded):
            owners = [
                r for r in self.live_indices()
                if event.a in self.groups[r] or event.b in self.groups[r]
            ]
            if not owners:
                self.cluster.degrade_link(event.a, event.b, event.factor)
                return
            # replica paths stay inside their group (+ the shared
            # dispatcher), so at most one live pipeline can ride this link;
            # route to its owner, which applies the cluster mutation once
            self.controls[owners[0]].submit(event)
            return
        # unknown event class: let every live replica log a noop
        for r in self.live_indices():
            self.controls[r].submit(event)

    def _route_node_joined(self, event: NodeJoined) -> None:
        live = self.live_indices()
        if event.comm is not None:
            # grow: adopt the node at intake (serializes concurrent grows)
            # and hand the weakest live replica a heal-style event
            new_id = self.cluster.add_node(event.comm)
            if not live:
                return
            target = self._weakest(live)
            self._adopt(target, new_id)
            self.controls[target].submit(NodeJoined(node_id=new_id))
            return
        owners = [r for r in live if event.node_id in self.groups[r]]
        if owners:
            self.controls[owners[0]].submit(event)
            return
        self.cluster.heal(event.node_id)
        if not live:
            return
        # a retired replica's node coming back: the weakest live replica
        # absorbs it (and pays that group's full restart)
        target = self._weakest(live)
        self._adopt(target, event.node_id)
        self.controls[target].submit(NodeJoined(node_id=event.node_id))

    def _weakest(self, live: list[int]) -> int:
        def throughput(r: int) -> float:
            plan = self.controls[r].last_plan
            return plan.predicted_throughput if plan is not None else 0.0

        return min(live, key=lambda r: (throughput(r), r))

    def _adopt(self, r: int, node_id: int) -> None:
        self.groups[r].add(node_id)
        self.controls[r].adopt_node(node_id)

    # -- rolling version bumps ----------------------------------------------
    def advance_rollout(self) -> None:
        """Move the one-replica-at-a-time version rollout forward.

        Called by the router between serving steps (and by ``reconcile``):
        the next replica receives the ``VersionBumped`` event only once the
        current one has drained its event queue -- by then it either
        redeployed at the new version or rejected it, and in both cases it
        is serving again, so at most one replica is ever mid-redeploy.
        """
        if self._rollout_event is None:
            if not self._rollout_queue:
                return
            self._rollout_event = self._rollout_queue.popleft()
            self._rollout_targets = deque(self.live_indices())
            self._rollout_current = None
        cur = self._rollout_current
        if cur is not None and not self.retired[cur] and self.controls[cur].pending:
            return  # still digesting; the others keep serving
        while self._rollout_targets:
            nxt = self._rollout_targets.popleft()
            if self.retired[nxt]:
                continue
            self.controls[nxt].submit(self._rollout_event)
            if self.journal is not None:
                self.journal.append("rollout", "replicaset", {
                    "version": self._rollout_event.version,
                    "replica": nxt, "phase": "submit",
                })
            self._rollout_current = nxt
            return
        if self.journal is not None and self._rollout_event is not None:
            self.journal.append("rollout", "replicaset", {
                "version": self._rollout_event.version,
                "replica": None, "phase": "complete",
            })
        self._rollout_event = None
        self._rollout_current = None
        self._rollout_targets = None
        if self._rollout_queue:
            self.advance_rollout()

    # -- convergence ---------------------------------------------------------
    def reconcile(self) -> list[ReconcileAction]:
        """Reconcile every live replica; a replica whose group can no longer
        host the model is retired instead of taking the set down."""
        actions: list[ReconcileAction] = []
        for r in self.live_indices():
            try:
                actions.extend(self.controls[r].reconcile())
            except RuntimeError as e:
                self.mark_retired(r, str(e))
                actions.append(self.controls[r].history[-1])
        self.advance_rollout()
        return actions

    def add_replica(self, control: ControlPlane, group: Sequence[int]) -> int:
        """Append a freshly-bootstrapped replica over ``group`` (the
        autoscaler's grow path).  Replica indices are append-only -- retired
        slots keep their history -- so routers indexing by replica id stay
        consistent across grow/retire cycles."""
        self.controls.append(control)
        self.groups.append(set(group))
        self.retired.append(False)
        return len(self.controls) - 1

    def mark_retired(self, r: int, reason: str = "") -> None:
        if self.retired[r]:
            return
        self.retired[r] = True
        control = self.controls[r]
        if control.pipeline is not None:
            for pod in control.pipeline.pods:
                pod.alive = False
        control.history.append(ReconcileAction(
            None, "retire",
            reason or f"replica {r}'s group can no longer host the model",
        ))
        if self.journal is not None:
            self.journal.append("retire", "replicaset", {
                "replica": r, "reason": control.history[-1].detail,
            })
