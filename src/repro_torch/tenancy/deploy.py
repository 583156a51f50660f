"""``deploy_tenants(specs) -> MultiTenantDeployment``: one shared cluster.

``api.deploy.deploy()`` dispatches here when handed a *list* of specs.  The
flow generalizes the single-tenant bootstrap:

  1. validate the tenant set (quota sums, duplicate names, one cluster),
  2. build the shared ``EdgeCluster`` from the first tenant's cluster spec,
  3. ``TenantScheduler.carve`` the hosting nodes into per-tenant slices
     (or fractional co-residency under the ``"shared"`` policy),
  4. bootstrap each tenant through the ordinary ``_build_deployment`` path
     restricted to its slice (masked control planes, subcluster planning,
     per-tenant artifact store + probe-noise stream),
  5. wire the cluster-level pair that makes it multi-tenant: a
     ``MultiTenantControlPlane`` (tenant-scoped churn) and a
     ``TenancyRouter`` (quota admission + weighted-fair serving).

Each tenant gets its own ``ArtifactStore`` subdirectory -- tenants serve
*different models*, so sharing one version pointer would alias their
rollouts (which is also why ``VersionBumped`` requires ``tenant=``).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Sequence

from repro_torch.api.spec import (
    InfeasibleSpecError,
    SpecIssue,
    TenantSpec,
    as_tenants,
    validate_tenants,
)
from repro_torch.cluster.events import ClusterEvent
from repro_torch.cluster.lifecycle import EdgeCluster
from repro_torch.cluster.serving import Request
from repro_torch.cluster.store import ArtifactStore
from repro_torch.obs import Journal
from repro_torch.tenancy.controlplane import MultiTenantControlPlane
from repro_torch.tenancy.router import TenancyRouter
from repro_torch.tenancy.scheduler import TenancyPlan, TenantScheduler

# per-tenant probe-noise stream separation (prime-strided, like the
# 7919 * replica stride inside one deployment)
_TENANT_SEED_STRIDE = 104_729


def deploy_tenants(
    specs: Sequence,
    *,
    store_root: str | None = None,
    version: int = 0,
    flops_per_s: float = 1e9,
    policy: str = "partition",
) -> "MultiTenantDeployment":
    """Deploy every tenant onto ONE shared edge cluster.

    ``specs`` mixes ``TenantSpec`` and bare ``DeploymentSpec`` entries
    (bare specs become ``tenant<i>`` with default quota/weight).  Raises
    ``InfeasibleSpecError`` with structured, tenant-prefixed issues when
    the set cannot deploy.
    """
    from repro_torch.api.deploy import _build_deployment, _passthrough_executor

    tenants = as_tenants(specs)
    issues = validate_tenants(tenants)
    if issues:
        raise InfeasibleSpecError(tuple(issues))

    comm, positions = tenants[0].spec.cluster.build()
    cluster = EdgeCluster(comm, flops_per_s=flops_per_s)
    scheduler = TenantScheduler(policy=policy)
    try:
        plan = scheduler.carve(comm, tenants)
    except ValueError as e:
        raise InfeasibleSpecError((SpecIssue("infeasible_tenancy", str(e)),))

    root = (store_root if store_root is not None
            else tempfile.mkdtemp(prefix="seifer-tenants-"))
    journal = Journal()  # ONE control-plane journal shared by every tenant
    deployments: dict[str, Any] = {}
    for idx, (tenant, placement) in enumerate(zip(tenants, plan.placements)):
        spec = _effective_spec(tenant, plan, comm)
        graph, model_executor = spec.resolve_model()
        executor_for_version = (
            spec.executor_for_version or model_executor or
            (lambda v: _passthrough_executor)
        )
        store = ArtifactStore(os.path.join(root, tenant.name))
        try:
            dep = _build_deployment(
                spec, graph, executor_for_version, cluster, store, positions,
                version=version, flops_per_s=flops_per_s,
                nodes=placement.nodes,
                seed_offset=_TENANT_SEED_STRIDE * idx,
                journal=journal, source_prefix=f"{tenant.name}/",
            )
        except (InfeasibleSpecError, RuntimeError) as e:
            detail = ("; ".join(i.message for i in e.issues)
                      if isinstance(e, InfeasibleSpecError) else str(e))
            raise InfeasibleSpecError((SpecIssue(
                "infeasible_tenancy",
                f"tenant {tenant.name!r} cannot deploy on its "
                f"{len(placement.nodes)}-node slice: {detail}",
            ),))
        if dep.autoscaler is not None:
            dep.autoscaler.name = tenant.name
        deployments[tenant.name] = dep

    entries = {
        name: (dep.replicaset or dep.control)
        for name, dep in deployments.items()
    }
    weights = {t.name: t.weight for t in tenants}
    mtcp = MultiTenantControlPlane(
        cluster, entries, weights=weights, journal=journal)
    router = TenancyRouter(
        {name: dep.loop for name, dep in deployments.items()},
        weights=weights,
        quotas={t.name: t.quota() for t in tenants},
    )
    return MultiTenantDeployment(
        tuple(tenants), plan, deployments, mtcp, router,
        cluster=cluster, positions=positions, journal=journal,
    )


def _effective_spec(tenant: TenantSpec, plan: TenancyPlan, comm):
    """The tenant's spec with its quota applied.

    The tenant-level ``admission_depth`` override lands on the spec (so the
    tenant's own engine enforces it), and under the ``"shared"`` policy the
    ``capacity_fraction`` scales the per-node capacity the planner sees --
    fractional co-residency instead of node carving.
    """
    spec = tenant.spec
    quota = tenant.quota()
    if quota != spec.admission_depth:
        spec = dataclasses.replace(spec, admission_depth=quota)
    if plan.policy == "shared" and tenant.capacity_fraction is not None:
        base = spec.capacity
        if base is None:
            base = spec.cluster.capacity_bytes
        if base is None:
            hosting = plan.nodes_for(tenant.name)
            base = float(min(comm.node_capacity[i] for i in hosting))
        spec = dataclasses.replace(
            spec, capacity=tenant.capacity_fraction * float(base))
    return spec


class MultiTenantDeployment:
    """Live multi-tenant serving: per-tenant deployments + shared control.

    The per-tenant ``Deployment`` facades stay fully usable (strategy
    swaps, model-watch polling, per-tenant metrics); this object adds the
    cluster-level views -- tenant-keyed serving through the weighted-fair
    router, and churn injection that routes each disturbance only to the
    tenant(s) whose slice it touches.
    """

    def __init__(
        self,
        tenants: tuple[TenantSpec, ...],
        plan: TenancyPlan,
        deployments: dict,
        mtcp: MultiTenantControlPlane,
        router: TenancyRouter,
        *,
        cluster: EdgeCluster,
        positions=None,
        journal: Journal | None = None,
    ):
        self.tenants = tenants
        self.plan = plan
        self.deployments = deployments
        self.controlplane = mtcp
        self.router = router
        self.cluster = cluster
        self.positions = positions
        self.journal = journal if journal is not None else Journal()

    # -- introspection -------------------------------------------------------
    def names(self) -> tuple[str, ...]:
        return tuple(self.deployments)

    def deployment(self, tenant: str):
        """The tenant's own ``Deployment`` facade."""
        return self.deployments[tenant]

    def nodes_for(self, tenant: str) -> tuple[int, ...]:
        return self.plan.nodes_for(tenant)

    @property
    def pending(self) -> int:
        return self.controlplane.pending

    # -- serving -------------------------------------------------------------
    def submit(self, tenant: str, x: Any, *,
               slo_class: str | None = None) -> Request:
        return self.router.submit(tenant, x, slo_class=slo_class)

    def schedule(self, tenant: str, x: Any, at_s: float, *,
                 slo_class: str | None = None) -> Request:
        return self.router.schedule(tenant, x, at_s, slo_class=slo_class)

    def submit_trace(self, tenant: str | None = None, trace=None,
                     make_input=None) -> int:
        """Schedule open-loop arrivals.  With ``tenant=None`` every tenant
        whose spec declares an arrival process schedules its own trace (per
        tenant seeds, merged by the router on the shared timeline)."""
        if tenant is None:
            if trace is not None:
                raise ValueError("an explicit trace needs a tenant=")
            return sum(
                self.submit_trace(t.name)
                for t in self.tenants if t.spec.arrival is not None
            )
        dep = self.deployments[tenant]
        if trace is None:
            arr = dep.spec.arrival
            if arr is None:
                raise RuntimeError(
                    f"tenant {tenant!r} has no arrival process; pass a trace")
            from repro_torch.workload import make_trace

            trace = make_trace(
                arr.trace, rate=arr.rate, duration_s=arr.duration_s,
                seed=arr.seed, classes=dep.spec.slo_classes,
            )
        if make_input is None:
            make_input = lambda i, a: i  # noqa: E731
        for i, a in enumerate(trace.arrivals):
            self.schedule(tenant, make_input(i, a), a.t_s,
                          slo_class=a.slo_class)
        return len(trace.arrivals)

    def step(self) -> list[Request]:
        return self.router.step()

    def drain(self, max_rounds: int = 100_000) -> list[Request]:
        return self.router.drain(max_rounds=max_rounds)

    def completed(self, tenant: str | None = None) -> list[Request]:
        return self.router.completed(tenant)

    # -- churn + convergence -------------------------------------------------
    def inject(self, event: ClusterEvent, *, tenant: str | None = None) -> None:
        """Route one disturbance (tenant-scoped when ``tenant=`` is given;
        otherwise ownership routing decides who sees it)."""
        self.controlplane.submit(event, tenant=tenant)

    def reconcile(self, *, tenant: str | None = None) -> dict:
        return self.controlplane.reconcile(tenant=tenant)

    # -- reporting -----------------------------------------------------------
    def latency_report(self) -> dict:
        return self.router.latency_report({
            t.name: t.spec.class_targets() for t in self.tenants
        })

    def metrics(self) -> dict:
        """Cluster-level view: the carve, fairness counters, and every
        tenant's own ``Deployment.metrics()`` under its name."""
        from repro_torch.cluster.serving import normalize_metrics

        return normalize_metrics({
            "mode": "multi-tenant",
            "policy": self.plan.policy,
            "n_nodes": self.cluster.n,
            "placements": self.plan.summary(),
            "routing": [
                {"tenant": t, "event": kind}
                for t, kind in self.controlplane.routed
            ],
            "serving": self.router.metrics(),
            "tenants": {
                name: dep.metrics()
                for name, dep in self.deployments.items()
            },
            "journal": self.journal.summary(),
        })

    # -- observability --------------------------------------------------------
    def trace_timeline(self) -> list[dict]:
        """Every tenant's span timeline merged (spans carry ``tenant``)."""
        out = [s for dep in self.deployments.values()
               for s in dep.trace_timeline()]
        out.sort(key=lambda s: (s["tenant"] or "", s["req_id"], s["t0_s"]))
        return out

    def chrome_trace(self) -> dict | None:
        """One Chrome trace across tenants: per-tenant pid blocks (each
        tenant's replica pids offset past the previous tenant's), process
        names prefixed with the tenant.  None when no tenant traces."""
        events: list[dict] = []
        offset = 0
        any_traced = False
        for name, dep in self.deployments.items():
            ct = dep.chrome_trace()
            if ct is None:
                continue
            any_traced = True
            max_pid = 0
            for ev in ct["traceEvents"]:
                ev = dict(ev)
                max_pid = max(max_pid, int(ev["pid"]))
                ev["pid"] = int(ev["pid"]) + offset
                if ev.get("ph") == "M":
                    ev["args"] = {"name": f"{name}: {ev['args']['name']}"}
                events.append(ev)
            offset += max_pid + 1
        if not any_traced:
            return None
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def attribution(self) -> dict:
        """Per-tenant critical-path attributions (None entries: no tracer)."""
        return {name: dep.attribution()
                for name, dep in self.deployments.items()}
