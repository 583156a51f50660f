"""``MultiTenantControlPlane``: tenant-scoped event routing (churn isolation).

Ownership routing at the tenant level: every tenant's control entry (its
``ControlPlane``) is masked to the tenant's node slice,
and a cluster disturbance is delivered only to the tenant(s) whose view
contains it.  One tenant's ``NodeFailed`` re-plan therefore never perturbs
another tenant's live pipelines -- the isolation the chaos suite and the
multi-tenant benchmark assert.

Routing rules (``submit``):

  ===============  ======================================================
  event            routed to
  ===============  ======================================================
  NodeFailed       every tenant whose view owns the node (all tenants
                   when the shared dispatcher dies); no owner -> the
                   shared cluster state is updated and no pipeline moves
  NodeJoined       heal: the owning tenant; grow (or an orphaned heal):
                   the node joins the cluster at intake and the weakest
                   tenant -- lowest live throughput per unit weight --
                   adopts it into its slice
  LinkDegraded     the one tenant whose view contains BOTH endpoints
                   (under the partition policy tenant paths never ride
                   cross-slice links, so one tolerance check suffices;
                   under the shared policy the first owner checks, an
                   approximation);  no owner -> cluster-only mutation
  VersionBumped    tenant-scoped by nature (each tenant rolls its own
                   model): requires an explicit ``tenant=``
  ===============  ======================================================

``reconcile()`` converges tenants independently and reports per tenant,
so one tenant's recovery actions are attributable -- and billable -- to
that tenant alone.
"""

from __future__ import annotations

from repro_torch.cluster.controlplane import ControlPlane, ReconcileAction
from repro_torch.cluster.events import (
    ClusterEvent,
    LinkDegraded,
    NodeFailed,
    NodeJoined,
    VersionBumped,
)


def _entry_throughput(entry: ControlPlane) -> float:
    """Live predicted throughput of a tenant's control entry."""
    plan = entry.last_plan
    return float(plan.predicted_throughput) if plan is not None else 0.0


class MultiTenantControlPlane:
    """Per-tenant control entries over one shared ``EdgeCluster``."""

    def __init__(
        self,
        cluster,
        entries: dict[str, ControlPlane],
        *,
        weights: dict[str, float] | None = None,
        dispatcher_node: int = 0,
        journal=None,
    ):
        if not entries:
            raise ValueError("at least one tenant entry is required")
        self.cluster = cluster
        self.entries = dict(entries)
        self.weights = {
            name: float((weights or {}).get(name, 1.0)) for name in entries}
        self.dispatcher_node = dispatcher_node
        # routing log: (tenant | None, event class name) per delivery;
        # mirrored into the shared control-plane journal when one is given
        self.routed: list[tuple[str | None, str]] = []
        self.journal = journal

    def _route(self, tenant: str | None, kind: str) -> None:
        self.routed.append((tenant, kind))
        if self.journal is not None:
            self.journal.append(
                "route", "tenancy", {"tenant": tenant, "event": kind})

    # -- introspection -------------------------------------------------------
    def names(self) -> tuple[str, ...]:
        return tuple(self.entries)

    @property
    def pending(self) -> int:
        return sum(e.pending for e in self.entries.values())

    def observed(self) -> dict:
        return {name: e.observed() for name, e in self.entries.items()}

    def recovery_log(self) -> dict:
        """Per-tenant ``Dispatcher.last_recovery`` records; ``None`` entries
        mean no recovery re-solve has run there yet."""
        return {name: e.dispatcher.last_recovery
                for name, e in self.entries.items()}

    def owners_of_node(self, node_id: int) -> list[str]:
        return [
            name for name, e in self.entries.items()
            if (owned := e.owned_nodes()) is None or node_id in owned
        ]

    def owners_of_link(self, a: int, b: int) -> list[str]:
        return [
            name for name, e in self.entries.items()
            if (owned := e.owned_nodes()) is None
            or (a in owned and b in owned)
        ]

    def _weakest(self) -> str:
        """The tenant furthest below its fair share: lowest live predicted
        throughput per unit weight (ties break by name for determinism)."""
        return min(
            self.entries,
            key=lambda n: (_entry_throughput(self.entries[n])
                           / self.weights[n], n),
        )

    # -- event intake --------------------------------------------------------
    def submit(self, event: ClusterEvent, *, tenant: str | None = None) -> None:
        """Route one disturbance to the tenant(s) it touches."""
        kind = type(event).__name__
        if tenant is not None:
            entry = self.entries[tenant]  # KeyError on unknown tenant
            entry.submit(event)
            self._route(tenant, kind)
            return
        if isinstance(event, VersionBumped):
            raise ValueError(
                "VersionBumped is tenant-scoped under multi-tenant serving; "
                "pass tenant=<name> to roll that tenant's model")
        if isinstance(event, NodeFailed):
            owners = self.owners_of_node(event.node_id)
            if not owners:
                # a spare node (or a retired slice's): keep the shared
                # cluster honest; no tenant pipeline is affected
                self.cluster.fail(event.node_id)
                self._route(None, kind)
                return
            for name in owners:
                self.entries[name].submit(event)
                self._route(name, kind)
            return
        if isinstance(event, NodeJoined):
            self._route_node_joined(event)
            return
        if isinstance(event, LinkDegraded):
            owners = self.owners_of_link(event.a, event.b)
            if not owners:
                self.cluster.degrade_link(event.a, event.b, event.factor)
                self._route(None, kind)
                return
            self.entries[owners[0]].submit(event)
            self._route(owners[0], kind)
            return
        # unknown event class: every tenant logs its own noop
        for name, entry in self.entries.items():
            entry.submit(event)
            self._route(name, kind)

    def _route_node_joined(self, event: NodeJoined) -> None:
        if event.comm is not None:
            # grow: the node joins the shared cluster exactly once at
            # intake, then the weakest tenant adopts it into its slice
            new_id = self.cluster.add_node(event.comm)
            self._adopt(self._weakest(), new_id)
            return
        owners = [
            name for name, e in self.entries.items()
            if (owned := e.owned_nodes()) is None or event.node_id in owned
        ]
        if owners:
            self.entries[owners[0]].submit(event)
            self._route(owners[0], "NodeJoined")
            return
        # a spare node coming back: the weakest tenant absorbs it
        self.cluster.heal(event.node_id)
        self._adopt(self._weakest(), event.node_id)

    def _adopt(self, name: str, node_id: int) -> None:
        entry = self.entries[name]
        # extend the masked view first, or the heal-style event would be
        # invisible to the tenant's dispatcher
        entry.adopt_node(node_id)
        entry.submit(NodeJoined(node_id=node_id))
        self._route(name, "NodeJoined")

    # -- convergence ---------------------------------------------------------
    def reconcile(
        self, *, tenant: str | None = None,
    ) -> dict[str, list[ReconcileAction]]:
        """Converge tenants independently; per-tenant action lists."""
        names = [tenant] if tenant is not None else list(self.entries)
        return {name: self.entries[name].reconcile() for name in names}
