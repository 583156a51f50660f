"""``deploy(spec) -> Deployment``: the one-call serving facade.

Before the declarative API, standing up a SEIFER deployment meant hand-wiring
six objects (``LayerGraph`` -> ``EdgeCluster`` -> ``ArtifactStore`` ->
``ControlPlane`` -> bootstrap -> ``ServingLoop``), repeated in every example
and benchmark.  ``deploy()`` collapses that to one call: it validates the
spec, materializes the cluster, bootstraps the control plane through the
spec's strategies (Sec. 2.1-2.2: elect -> probe -> partition -> place ->
deploy), and wraps serving + churn + strategy-swap behind a ``Deployment``:

  * ``submit(x)`` / ``step()`` / ``drain()`` -- request-level serving, the
    stage executors computing on ``spec.device``,
  * ``schedule(x, at_s)`` / ``submit_trace()`` -- open-loop arrivals by
    timestamp on the virtual clock (``spec.arrival``),
  * ``inject(event)`` / ``reconcile()``     -- churn + convergence (Sec. 2.3),
  * ``poll_model_updates()``                -- the model watcher's tick
    (``cluster.watch.ModelWatcher``),
  * ``replan(partitioner=..., placer=...)``  -- swap strategies on a LIVE
    deployment (probed bandwidths and generation reused),
  * ``metrics()``                            -- predicted vs. observed
    bottleneck, serving counters, reconcile history,
  * ``trace_timeline()`` / ``chrome_trace()`` / ``attribution()`` -- the
    span plane (``spec.trace``).

``spec.serving`` picks the synchronous baseline loop or the pipelined
engine; ``spec.replicas`` (or ``spec.autoscale``) serves R data-parallel
pipelines over disjoint node groups behind one router.  A list of specs
deploys several tenants onto one shared cluster (``repro_torch.tenancy``).
"""

from __future__ import annotations

import sys
import tempfile
from typing import Any

import numpy as np

from repro_torch.api.planner import Plan, Planner, ReplicatedPlan, subcluster
from repro_torch.api.spec import DeploymentSpec, InfeasibleSpecError, SpecIssue
from repro_torch.cluster.controlplane import (
    ControlPlane,
    ObservedState,
    ReconcileAction,
    ReplicaSet,
)
from repro_torch.cluster.engine import PipelinedServingLoop, ReplicatedServingLoop
from repro_torch.cluster.events import ClusterEvent, NodeJoined, VersionBumped
from repro_torch.cluster.lifecycle import EdgeCluster
from repro_torch.cluster.serving import Request, ServingLoop
from repro_torch.cluster.store import ArtifactStore
from repro_torch.cluster.watch import ModelWatcher
from repro_torch.core.execution import resolve_device
from repro_torch.obs import Journal, MetricsRegistry, SpanTracer, analyze_spans


def _passthrough_executor(start: int, stop: int, x):
    """Timing-only serving: latency still comes from bytes/bandwidth+flops."""
    return x


def deploy(
    spec: DeploymentSpec,
    *,
    store_root: str | None = None,
    version: int = 0,
    flops_per_s: float = 1e9,
    **tenancy_kw,
) -> "Deployment":
    """Validate ``spec``, build the stack, bootstrap, return the facade.

    Raises ``InfeasibleSpecError`` with structured reasons when the spec
    cannot deploy (unknown strategy, layer over capacity, missed SLO, ...).

    A *list* of specs (``DeploymentSpec`` or ``TenantSpec``) deploys every
    tenant onto ONE shared cluster and returns a ``MultiTenantDeployment``
    (``repro_torch.tenancy``): the tenancy scheduler carves the hosting nodes
    under per-tenant capacity fractions, and churn on one tenant's nodes
    never perturbs another's pipelines.
    """
    if isinstance(spec, (list, tuple)):
        from repro_torch.tenancy import deploy_tenants

        return deploy_tenants(
            spec, store_root=store_root, version=version,
            flops_per_s=flops_per_s, **tenancy_kw,
        )
    if tenancy_kw:
        raise TypeError(
            f"unexpected keyword(s) {sorted(tenancy_kw)} -- tenancy options "
            f"apply only when deploying a list of specs")
    spec.check()
    graph, model_executor = spec.resolve_model()
    comm, positions = spec.cluster.build()
    executor_for_version = (
        spec.executor_for_version or model_executor or
        (lambda v: _passthrough_executor)
    )
    cluster = EdgeCluster(comm, flops_per_s=flops_per_s)
    store = ArtifactStore(
        store_root if store_root is not None
        else tempfile.mkdtemp(prefix="seifer-deploy-")
    )
    return _build_deployment(
        spec, graph, executor_for_version, cluster, store, positions,
        version=version, flops_per_s=flops_per_s,
    )


def _build_deployment(
    spec: DeploymentSpec,
    graph,
    executor_for_version,
    cluster: EdgeCluster,
    store: ArtifactStore,
    positions,
    *,
    version: int,
    flops_per_s: float,
    nodes=None,
    seed_offset: int = 0,
    journal: Journal | None = None,
    source_prefix: str = "",
) -> "Deployment":
    """Bootstrap one deployment's control + serving stack on ``cluster``.

    ``nodes`` restricts planning and placement to a hosting-node subset
    (the tenancy scheduler's carve): plans are compiled on the subset's
    ``subcluster`` view and every control plane is masked to it, so the
    deployment can never place -- or be perturbed -- outside its slice.
    ``seed_offset`` keeps per-tenant probe-noise streams distinct.
    ``journal``/``source_prefix`` let the tenancy layer share ONE
    control-plane journal across tenants (records keyed ``<tenant>/...``).
    """
    comm = cluster.comm
    device = resolve_device(spec.device)
    if journal is None:
        journal = Journal()
    if spec.autoscale is not None:
        return _deploy_autoscaled(
            spec, graph, executor_for_version, cluster, store, positions,
            version=version, flops_per_s=flops_per_s,
            nodes=nodes, seed_offset=seed_offset,
            journal=journal, source_prefix=source_prefix,
        )
    view = comm if nodes is None else subcluster(comm, nodes, keep=(0,))
    rplan = None
    if spec.replicas != 1:
        # split the cluster BEFORE any probing: groups are decided on the
        # true bandwidths, each replica then bootstraps within its group
        rplan = Planner.from_spec(spec).plan_replicated(
            graph, view,
            replicas=spec.replicas, capacity=spec.capacity, version=version,
            dispatcher=0, device_flops=flops_per_s,
            compression_ratio=spec.compression_ratio,
        )
        if not rplan.feasible:
            raise InfeasibleSpecError((SpecIssue(
                "infeasible_replicas",
                f"could not plan {spec.replicas!r} replica pipeline(s) on "
                f"this cluster (hosting nodes per group too few, or a group "
                f"cannot host the model)",
            ),))
        if rplan.n_replicas == 1:
            rplan = None  # replicas="auto" chose a single pipeline
    if rplan is None:
        control = ControlPlane(
            cluster, store,
            lambda v: graph, executor_for_version,
            planner=Planner.from_spec(spec),
            capacity=spec.capacity, compression_ratio=spec.compression_ratio,
            seed=spec.seed + seed_offset,
            allowed_nodes=None if nodes is None else set(nodes) | {0},
            hosting_nodes=None if nodes is None else set(nodes),
            device=device,
            journal=journal, journal_source=source_prefix + "control",
        )
        control.bootstrap(version)
        dep = Deployment(spec, control, positions=positions, journal=journal)
    else:
        controls = []
        for r, group in enumerate(rplan.groups):
            control = ControlPlane(
                cluster, store,
                lambda v: graph, executor_for_version,
                planner=Planner.from_spec(spec),
                capacity=spec.capacity,
                compression_ratio=spec.compression_ratio,
                # distinct probe-noise streams per replica (and per tenant)
                seed=spec.seed + seed_offset + 7919 * r,
                allowed_nodes=set(group) | {0},
                hosting_nodes=set(group),
                device=device,
                journal=journal,
                journal_source=f"{source_prefix}replica:{r}",
            )
            control.bootstrap(version)
            controls.append(control)
        replicaset = ReplicaSet(
            cluster, controls, [set(g) for g in rplan.groups],
            dispatcher_node=0, journal=journal,
        )
        dep = Deployment(spec, replicaset=replicaset, positions=positions,
                         journal=journal)
    dep._check_slos()
    return dep


def _deploy_autoscaled(
    spec: DeploymentSpec,
    graph,
    executor_for_version,
    cluster: EdgeCluster,
    store: ArtifactStore,
    positions,
    *,
    version: int,
    flops_per_s: float,
    nodes=None,
    seed_offset: int = 0,
    journal: Journal | None = None,
    source_prefix: str = "",
) -> "Deployment":
    """Autoscaling path: plan the widest feasible replica split, activate
    ``min_replicas`` groups, park the rest as the autoscaler's standby pool."""
    from repro_torch.cluster.autoscale import Autoscaler

    comm = cluster.comm
    device = resolve_device(spec.device)
    view = comm if nodes is None else subcluster(comm, nodes, keep=(0,))
    auto = spec.autoscale
    plan_width = "max" if auto.max_replicas == "auto" else auto.max_replicas
    rplan = Planner.from_spec(spec).plan_replicated(
        graph, view,
        replicas=plan_width, capacity=spec.capacity, version=version,
        dispatcher=0, device_flops=flops_per_s,
        compression_ratio=spec.compression_ratio,
    )
    if not rplan.feasible or rplan.n_replicas < auto.min_replicas:
        raise InfeasibleSpecError((SpecIssue(
            "infeasible_replicas",
            f"autoscaling needs at least {auto.min_replicas} feasible replica "
            f"group(s) (max_replicas={auto.max_replicas!r}) but the planner "
            f"found {rplan.n_replicas if rplan.feasible else 0} on this cluster",
        ),))

    def make_control(group, r: int) -> ControlPlane:
        # one control plane per replica slot; r indexes the *router's*
        # append-only replica list so regrown slots get fresh noise streams
        control = ControlPlane(
            cluster, store,
            lambda v: graph, executor_for_version,
            planner=Planner.from_spec(spec),
            capacity=spec.capacity,
            compression_ratio=spec.compression_ratio,
            seed=spec.seed + seed_offset + 7919 * r,
            allowed_nodes=set(group) | {0},
            hosting_nodes=set(group),
            device=device,
            journal=journal,
            journal_source=f"{source_prefix}replica:{r}",
        )
        control.bootstrap(max(version, store.current_version()))
        return control

    active = [tuple(g) for g in rplan.groups[:auto.min_replicas]]
    standby = [tuple(g) for g in rplan.groups[auto.min_replicas:]]
    controls = [make_control(g, r) for r, g in enumerate(active)]
    replicaset = ReplicaSet(
        cluster, controls, [set(g) for g in active], dispatcher_node=0,
        journal=journal,
    )
    dep = Deployment(spec, replicaset=replicaset, positions=positions,
                     journal=journal)
    max_replicas = (
        None if auto.max_replicas == "auto" else int(auto.max_replicas))
    dep.autoscaler = Autoscaler(
        make_control, standby,
        min_replicas=auto.min_replicas, max_replicas=max_replicas,
        backlog_high=auto.backlog_high, backlog_low=auto.backlog_low,
        target_p99_s=auto.target_p99_s, cooldown_s=auto.cooldown_s,
        window=auto.window,
        name=source_prefix.rstrip("/") or None, journal=journal,
    )
    dep.loop.autoscaler = dep.autoscaler
    dep._check_slos()
    return dep


class Deployment:
    """A live deployment: serving loop + control plane + strategy registry.

    Constructed by ``deploy()``; everything the five old wiring copies did by
    hand is a method here.
    """

    def __init__(
        self,
        spec: DeploymentSpec,
        control: ControlPlane | None = None,
        *,
        replicaset: ReplicaSet | None = None,
        positions: np.ndarray | None = None,
        journal: Journal | None = None,
    ):
        if (control is None) == (replicaset is None):
            raise ValueError("give exactly one of control= or replicaset=")
        self.spec = spec
        self.replicaset = replicaset
        self.autoscaler = None  # set by deploy() when spec.autoscale is given
        self.journal = journal if journal is not None else Journal()
        self.tracer = (
            SpanTracer(spec.trace) if spec.trace is not None else None)
        self.registry = MetricsRegistry()
        if replicaset is not None:
            # replica 0 as the representative for shared resources
            # (cluster/store are one object across every replica)
            self.control = replicaset.controls[0]
            self.loop = ReplicatedServingLoop(
                replicaset, microbatch=spec.microbatch,
                queue_depth=spec.queue_depth,
                max_batch=spec.max_batch,
                admission_depth=spec.admission_depth,
                class_priority=spec.class_priority(),
                class_targets=spec.class_targets(),
                tracer=self.tracer, registry=self.registry,
            )
        else:
            self.control = control
            if spec.serving == "sync":
                self.loop = ServingLoop(
                    control, microbatch=spec.microbatch,
                    tracer=self.tracer, registry=self.registry,
                )
            else:
                self.loop = PipelinedServingLoop(
                    control, microbatch=spec.microbatch,
                    queue_depth=spec.queue_depth,
                    max_batch=spec.max_batch,
                    admission_depth=spec.admission_depth,
                    class_priority=spec.class_priority(),
                    class_targets=spec.class_targets(),
                    tracer=self.tracer, registry=self.registry,
                )
        # journal records are stamped off the serving clock from here on
        self.journal.bind_clock(lambda: self.loop.clock_s)
        self.watcher = ModelWatcher(self.control.store)
        self.positions = positions  # node positions for random clusters (growth)

    # -- introspection -------------------------------------------------------
    @property
    def replicated(self) -> bool:
        return self.replicaset is not None

    @property
    def plan(self) -> Plan | ReplicatedPlan:
        """What is deployed: the control plane's plan, or (replicated) the
        aggregate of the live replicas' plans (summed throughput)."""
        if self.replicaset is not None:
            return self.replicaset.deployed_plan()
        return self.control.last_plan

    @property
    def cluster(self) -> EdgeCluster:
        return self.control.cluster

    @property
    def store(self) -> ArtifactStore:
        return self.control.store

    @property
    def pending(self) -> int:
        """Cluster events not yet reconciled (rollouts included)."""
        if self.replicaset is not None:
            return self.replicaset.pending
        return self.control.pending

    def observed(self) -> ObservedState:
        """Single-pipeline observation; replicated deployments report per
        replica (``observed_replicas``), so this returns replica 0's view."""
        return self.control.observed()

    def observed_replicas(self) -> tuple[ObservedState, ...]:
        if self.replicaset is None:
            return (self.control.observed(),)
        return self.replicaset.observed()

    # -- serving -------------------------------------------------------------
    def submit(self, x: Any, *, slo_class: str | None = None) -> Request:
        """Admit one inference request."""
        if self.spec.serving == "sync":
            return self.loop.submit(x)
        return self.loop.submit(x, slo_class=slo_class)

    def schedule(
        self, x: Any, at_s: float, *, slo_class: str | None = None,
    ) -> Request:
        """Register one open-loop arrival at virtual time ``at_s``."""
        if self.spec.serving == "sync":
            raise RuntimeError("open-loop arrivals need pipelined serving")
        return self.loop.schedule(x, at_s, slo_class=slo_class)

    def submit_trace(self, trace=None, make_input=None) -> int:
        """Schedule every arrival of an open-loop trace onto the engine.

        With no ``trace`` argument, generates one from ``spec.arrival``
        (trace name, rate, duration, seed) and the spec's SLO class weights.
        ``make_input(i, arrival)`` builds each request payload; the default
        sends the arrival index.  Returns the number of arrivals scheduled.
        """
        if trace is None:
            arr = self.spec.arrival
            if arr is None:
                raise RuntimeError("spec has no arrival process; pass a trace")
            from repro_torch.workload import make_trace

            trace = make_trace(
                arr.trace, rate=arr.rate, duration_s=arr.duration_s,
                seed=arr.seed, classes=self.spec.slo_classes,
            )
        if make_input is None:
            make_input = lambda i, a: i  # noqa: E731
        from repro_torch.workload import schedule_trace

        return schedule_trace(self, trace, make_input)

    def step(self) -> list[Request]:
        """One admission round (reconciles pending events first)."""
        return self.loop.step()

    def drain(self, max_rounds: int = 10_000) -> list[Request]:
        """Serve until the queue empties; returns the completed requests."""
        return self.loop.drain(max_rounds=max_rounds)

    # -- churn + convergence -------------------------------------------------
    def inject(self, event: ClusterEvent) -> None:
        """Enqueue a cluster disturbance; ``reconcile()`` converges on it.

        Replicated deployments route the event to the replica(s) it touches
        (``ReplicaSet.submit``); the others never see it.
        """
        (self.replicaset or self.control).submit(event)

    def reconcile(self) -> list[ReconcileAction]:
        """Drain the event queue and converge observed -> desired state."""
        return (self.replicaset or self.control).reconcile()

    def poll_model_updates(self) -> bool:
        """Watch tick: emit ``VersionBumped`` if the store moved past us.

        Replicated deployments start a rolling bump (one replica at a time)
        when any live replica is behind the store pointer and that version
        is not already rolling.
        """
        if self.replicaset is None:
            return self.watcher.poll_events(self.control)
        rset = self.replicaset
        latest = self.store.current_version()
        behind = any(
            rset.controls[r].desired is not None
            and rset.controls[r].desired.version < latest
            for r in rset.live_indices()
        )
        if not behind or rset.rolling_version() >= latest:
            return False
        rset.submit(VersionBumped(latest))
        return True

    def grow_cluster(self, seed: int = 0) -> NodeJoined:
        """Convenience churn: add one random node (full-restart event).

        Only available for random clusters (the spec kept the positions);
        returns the injected ``NodeJoined`` event -- call ``reconcile()``
        (or keep serving) to converge.
        """
        if self.positions is None:
            raise RuntimeError(
                "grow_cluster() needs a position-seeded random cluster; "
                "inject NodeJoined(comm=...) yourself for explicit CommGraphs"
            )
        from repro_torch.core.simulate import expand_cluster

        arena = self.spec.cluster.arena_m
        cap = self.spec.cluster.capacity_bytes
        grown, self.positions = expand_cluster(self.positions, cap, arena, seed)
        event = NodeJoined(comm=grown)
        self.inject(event)
        return event

    # -- strategy swap -------------------------------------------------------
    def replan(
        self,
        *,
        partitioner: str | None = None,
        placer: str | None = None,
        joint: str | None = None,
    ) -> Plan:
        """Swap strategies on the live deployment and redeploy in place.

        Unset kinds keep their current strategy, with one asymmetry: naming
        a ``partitioner`` or ``placer`` switches a joint-optimized deployment
        back to the two-step pipeline (a joint strategy *replaces* that
        pipeline, so keeping it would make the swap a silent no-op).  The
        running pipeline is only replaced if the new plan is feasible.

        On a replicated deployment the swap applies to every live replica
        (each keeps its own sub-cluster); the aggregate plan is returned.
        """
        current = self.control.planner
        if joint is not None:
            new_joint = joint
        elif partitioner is not None or placer is not None:
            new_joint = None  # explicit pipeline strategies drop the joint
        else:
            new_joint = current.joint.name if current.joint else None
        planner = Planner(
            partitioner=partitioner or current.partitioner.name,
            placer=placer or current.placer.name,
            joint=new_joint,
            n_classes=current.n_classes,
            seed=current.seed,
            codec=current.codec,
            accuracy_tolerance=current.accuracy_tolerance,
        )
        if self.replicaset is None:
            return self.control.replan(planner)
        for r in self.replicaset.live_indices():
            self.replicaset.controls[r].replan(planner)
        return self.replicaset.deployed_plan()

    # -- metrics -------------------------------------------------------------
    def metrics(self) -> dict:
        """Predicted vs. observed placement quality + serving counters.

        Replicated deployments report the aggregate (summed predicted
        throughput, live/retired counts) plus one entry per replica.
        """
        if self.replicaset is not None:
            return self._replicated_metrics()
        obs = self.observed()
        plan = self.plan
        out = {
            "version": obs.version,
            "generation": obs.generation,
            "leader": obs.leader,
            "path": list(obs.path),
            "n_nodes": obs.n_nodes,
            "healthy": obs.healthy,
            "bottleneck_latency_s": obs.bottleneck_latency,
            "strategies": dict(plan.strategies) if plan else {},
            "codecs": list(plan.codecs) if plan else [],
            "predicted_bottleneck_s": plan.predicted_bottleneck_s if plan else None,
            "predicted_throughput": plan.predicted_throughput if plan else None,
            "reconcile_actions": [a.kind for a in self.control.history],
            "serving": self.loop.metrics(),
            "recovery": {
                "last": self.control.dispatcher.last_recovery,
                "log": list(self.control.dispatcher.recovery_log),
            },
            "journal": self.journal.summary(),
        }
        return self._finalize_metrics(out)

    def _replicated_metrics(self) -> dict:
        rset = self.replicaset
        plan = rset.deployed_plan()
        replicas = []
        for r, control in enumerate(rset.controls):
            obs = control.observed()
            replicas.append({
                "replica": r,
                "retired": rset.retired[r],
                "group": sorted(rset.groups[r]),
                "version": obs.version,
                "generation": obs.generation,
                "leader": obs.leader,
                "path": list(obs.path),
                "healthy": obs.healthy,
                "bottleneck_latency_s": obs.bottleneck_latency,
                "predicted_throughput": (
                    control.last_plan.predicted_throughput
                    if control.last_plan else None
                ),
                "codecs": (
                    list(control.last_plan.codecs)
                    if control.last_plan else []
                ),
                "reconcile_actions": [a.kind for a in control.history],
                "recovery": {
                    "last": control.dispatcher.last_recovery,
                    "log": list(control.dispatcher.recovery_log),
                },
            })
        return self._finalize_metrics({
            "version": plan.version,
            "n_nodes": self.cluster.n,
            "n_replicas": rset.n_replicas,
            "live_replicas": len(rset.live_indices()),
            "strategies": dict(plan.strategies) if plan.replicas else {},
            "predicted_bottleneck_s": plan.predicted_bottleneck_s,
            "predicted_throughput": plan.predicted_throughput,
            "replicas": replicas,
            "serving": self.loop.metrics(),
            "journal": self.journal.summary(),
        })

    def _finalize_metrics(self, out: dict) -> dict:
        """Mirror the payload into the metrics registry, then attach the
        registry snapshot + trace digest (additive keys: everything the
        payload held before observability landed is untouched)."""
        self.registry.ingest("deployment", out)
        out["observability"] = {
            "metrics": self.registry.snapshot(),
            "trace": (self.tracer.summary()
                      if self.tracer is not None else None),
        }
        from repro_torch.cluster.serving import normalize_metrics

        return normalize_metrics(out)

    # -- observability --------------------------------------------------------
    def trace_timeline(self) -> list[dict]:
        """The span timeline as flat JSON dicts ([] when tracing is off)."""
        return self.tracer.timeline() if self.tracer is not None else []

    def chrome_trace(self) -> dict | None:
        """Chrome trace-event export (None when tracing is off)."""
        return (self.tracer.chrome_trace()
                if self.tracer is not None else None)

    def attribution(self) -> dict | None:
        """Critical-path attribution over every recorded span (None when
        tracing is off); see ``repro_torch.obs.analyze_spans``."""
        if self.tracer is None:
            return None
        return analyze_spans(self.tracer.spans)

    def _check_slos(self) -> None:
        """SLOs re-checked on the as-deployed plan (probed bandwidths)."""
        issues = self.plan.slo_issues(self.spec)
        if issues:
            raise InfeasibleSpecError(issues)


# The function and this module share the name "deploy", and a prior
# ``import repro_torch.api.deploy`` binds the MODULE onto the package before the
# package's lazy __getattr__ can pin the function -- so make the module
# itself callable; either object a caller ends up with deploys the spec.
class _CallableDeployModule(sys.modules[__name__].__class__):
    def __call__(self, *args, **kwargs):
        return deploy(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableDeployModule
