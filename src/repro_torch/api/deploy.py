"""``deploy(spec) -> Deployment``: the one-call serving facade.

``deploy()`` validates the spec, materializes the cluster, bootstraps the
control plane through the spec's strategies (Sec. 2.1-2.2: elect -> probe ->
partition -> place -> deploy), and wraps serving + churn behind a
``Deployment``:

  * ``submit(x)`` / ``step()`` / ``drain()`` -- request-level serving through
    the pipelined engine, the stage executors computing on ``spec.device``,
  * ``inject(event)`` / ``reconcile()``     -- churn + convergence (Sec. 2.3),
  * ``poll_model_updates()``                -- watch the artifact store for a
    new model version,
  * ``metrics()``                            -- predicted vs. observed
    bottleneck, serving counters, reconcile history.

A list of specs deploys several tenants onto one shared cluster
(``repro_torch.tenancy``).  One pipeline per deployment: the JAX package's
replica sets, autoscaling, tracing and strategy swap (``replan``) are not
ported yet, and the spec rejects the fields that would ask for them.
"""

from __future__ import annotations

import sys
import tempfile
from typing import Any

from repro_torch.api.planner import Plan, Planner
from repro_torch.api.spec import DeploymentSpec, InfeasibleSpecError
from repro_torch.cluster.controlplane import ControlPlane, ObservedState, ReconcileAction
from repro_torch.cluster.engine import PipelinedServingLoop
from repro_torch.cluster.events import ClusterEvent, VersionBumped
from repro_torch.cluster.lifecycle import EdgeCluster
from repro_torch.cluster.serving import Request, normalize_metrics
from repro_torch.cluster.store import ArtifactStore
from repro_torch.core.execution import resolve_device
from repro_torch.obs import Journal


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
    cannot deploy (unknown strategy, layer over capacity, missed SLO, a
    field whose branch is not ported, ...).

    A *list* of specs (``DeploymentSpec`` or ``TenantSpec``) deploys every
    tenant onto ONE shared cluster and returns a ``MultiTenantDeployment``
    (``repro_torch.tenancy``): the tenancy scheduler carves the hosting
    nodes under per-tenant capacity fractions, and churn on one tenant's
    nodes never perturbs another's pipelines.
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
    comm, _ = spec.cluster.build()
    executor_for_version = (
        spec.executor_for_version or model_executor or
        (lambda v: _passthrough_executor)
    )
    cluster = EdgeCluster(comm, flops_per_s=flops_per_s)
    store = ArtifactStore(
        store_root if store_root is not None
        else tempfile.mkdtemp(prefix="seifer-deploy-")
    )
    return _build_deployment(spec, graph, executor_for_version, cluster, store,
                             version=version)


def _build_deployment(
    spec: DeploymentSpec,
    graph,
    executor_for_version,
    cluster: EdgeCluster,
    store: ArtifactStore,
    *,
    version: int,
    nodes=None,
    seed_offset: int = 0,
    journal: Journal | None = None,
    source_prefix: str = "",
) -> "Deployment":
    """Bootstrap one deployment's control + serving stack on ``cluster``.

    ``nodes`` restricts planning and placement to a hosting-node subset
    (the tenancy scheduler's carve): the control plane is masked to it, so
    the deployment can never place -- or be perturbed -- outside its slice.
    ``seed_offset`` keeps per-tenant probe-noise streams distinct.
    ``journal``/``source_prefix`` let the tenancy layer share ONE
    control-plane journal across tenants (records keyed ``<tenant>/...``).
    """
    if journal is None:
        journal = Journal()
    control = ControlPlane(
        cluster, store,
        lambda v: graph, executor_for_version,
        planner=Planner.from_spec(spec),
        capacity=spec.capacity, compression_ratio=spec.compression_ratio,
        seed=spec.seed + seed_offset,
        allowed_nodes=None if nodes is None else set(nodes) | {0},
        hosting_nodes=None if nodes is None else set(nodes),
        device=resolve_device(spec.device),
        journal=journal, journal_source=source_prefix + "control",
    )
    control.bootstrap(version)
    dep = Deployment(spec, control, journal=journal)
    dep._check_slos()
    return dep


class Deployment:
    """A live deployment: serving loop + control plane.

    Constructed by ``deploy()``; everything the old hand wiring did is a
    method here.
    """

    def __init__(self, spec: DeploymentSpec, control: ControlPlane, *,
                 journal: Journal | None = None):
        self.spec = spec
        self.control = control
        self.journal = journal if journal is not None else Journal()
        self.loop = PipelinedServingLoop(
            control, microbatch=spec.microbatch,
            queue_depth=spec.queue_depth,
            max_batch=spec.max_batch,
            admission_depth=spec.admission_depth,
            class_priority=spec.class_priority(),
            class_targets=spec.class_targets(),
        )
        # journal records are stamped off the serving clock from here on
        self.journal.bind_clock(lambda: self.loop.clock_s)

    # -- introspection -------------------------------------------------------
    @property
    def plan(self) -> Plan:
        """What is deployed: the control plane's current plan."""
        return self.control.last_plan

    @property
    def cluster(self) -> EdgeCluster:
        return self.control.cluster

    @property
    def store(self) -> ArtifactStore:
        return self.control.store

    @property
    def pending(self) -> int:
        """Cluster events not yet reconciled."""
        return self.control.pending

    def observed(self) -> ObservedState:
        return self.control.observed()

    # -- serving -------------------------------------------------------------
    def submit(self, x: Any, *, slo_class: str | None = None) -> Request:
        """Admit one inference request (a tensor or array; it is moved to
        the deployment's device when its microbatch is admitted)."""
        return self.loop.submit(x, slo_class=slo_class)

    def schedule(
        self, x: Any, at_s: float, *, slo_class: str | None = None,
    ) -> Request:
        """Register one open-loop arrival at virtual time ``at_s`` (rejected
        when the admission queue is at ``spec.admission_depth``)."""
        return self.loop.schedule(x, at_s, slo_class=slo_class)

    def step(self) -> list[Request]:
        """One admission round (reconciles pending events first)."""
        return self.loop.step()

    def drain(self, max_rounds: int = 10_000) -> list[Request]:
        """Serve until the queue empties; returns the completed requests."""
        return self.loop.drain(max_rounds=max_rounds)

    # -- churn + convergence -------------------------------------------------
    def inject(self, event: ClusterEvent) -> None:
        """Enqueue a cluster disturbance; ``reconcile()`` converges on it."""
        self.control.submit(event)

    def reconcile(self) -> list[ReconcileAction]:
        """Drain the event queue and converge observed -> desired state."""
        return self.control.reconcile()

    def poll_model_updates(self) -> bool:
        """Watch tick: emit ``VersionBumped`` if the store moved past the
        deployed version.  Compares against the control plane's desired
        version, so a bump the reconciler rejected is re-emitted while the
        store pointer stays ahead."""
        latest = self.store.current_version()
        if latest <= self.control.desired.version:
            return False
        self.control.submit(VersionBumped(latest))
        return True

    # -- metrics -------------------------------------------------------------
    def metrics(self) -> dict:
        """Predicted vs. observed placement quality + serving counters."""
        obs = self.observed()
        plan = self.plan
        return normalize_metrics({
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
        })

    def _check_slos(self) -> None:
        """SLOs re-checked on the as-deployed plan (probed bandwidths)."""
        issues = self.plan.slo_issues(self.spec)
        if issues:
            raise InfeasibleSpecError(issues)


# The function and this module share the name "deploy", and a prior
# ``import repro_torch.api.deploy`` binds the MODULE onto the package before
# the package's lazy __getattr__ can pin the function -- so make the module
# itself callable; either object a caller ends up with deploys the spec.
class _CallableDeployModule(sys.modules[__name__].__class__):
    def __call__(self, *args, **kwargs):
        return deploy(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableDeployModule
