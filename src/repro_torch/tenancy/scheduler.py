"""``TenantScheduler``: co-plan tenant placements on one shared cluster.

The scheduler answers the cluster-level packing question multi-tenant
serving opens: *which hosting nodes does each tenant get?*  Two policies:

  * ``"partition"`` (default) -- carve the hosting nodes into disjoint,
    bandwidth-coherent slices, one per tenant, sized by the tenants'
    ``capacity_fraction`` quotas (largest-remainder apportionment; every
    tenant gets at least one node).  The carve is
    ``api.planner.split_cluster`` with per-group ``targets``, so each
    slice grows around a well-connected neighbourhood.  Disjoint slices are
    what make churn isolation *structural*: a tenant's control planes are
    masked to its slice, so another tenant's node failures are events it
    never owns.
  * ``"shared"`` -- every tenant sees every hosting node, with its
    ``capacity_fraction`` applied to per-node capacity instead (fractional
    co-residency).  Tenants' pipelines may then pack onto the same nodes;
    contention is approximated by the router's weighted-fair service and
    churn on a shared node reaches every tenant hosting it.

Unspecified fractions split whatever the explicit ones leave over equally.
When the fractions sum below 1 under ``"partition"``, the unclaimed nodes
stay *spare* -- unowned capacity later growth can adopt.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.api.planner import split_cluster
from repro_torch.api.spec import TenantSpec

POLICIES = ("partition", "shared")


@dataclasses.dataclass(frozen=True)
class TenantPlacement:
    """One tenant's share of the cluster: its hosting-node slice + quota."""

    name: str
    nodes: tuple[int, ...]
    fraction: float  # resolved capacity fraction (explicit or equal-share)
    weight: float

    def summary(self) -> dict:
        return {
            "name": self.name,
            "nodes": list(self.nodes),
            "fraction": self.fraction,
            "weight": self.weight,
        }


@dataclasses.dataclass(frozen=True)
class TenancyPlan:
    """The scheduler's carve: per-tenant placements + unclaimed spares."""

    policy: str
    placements: tuple[TenantPlacement, ...]
    spare: tuple[int, ...]

    def nodes_for(self, name: str) -> tuple[int, ...]:
        for p in self.placements:
            if p.name == name:
                return p.nodes
        raise KeyError(name)

    def summary(self) -> dict:
        return {
            "policy": self.policy,
            "tenants": [p.summary() for p in self.placements],
            "spare": list(self.spare),
        }


def resolve_fractions(tenants: Sequence[TenantSpec]) -> list[float]:
    """Explicit ``capacity_fraction``s pass through; ``None`` entries split
    the remainder equally (0 when the explicit ones already claim it all)."""
    explicit = sum(t.capacity_fraction for t in tenants
                   if t.capacity_fraction is not None)
    auto_n = sum(1 for t in tenants if t.capacity_fraction is None)
    share = max(0.0, 1.0 - explicit) / auto_n if auto_n else 0.0
    return [t.capacity_fraction if t.capacity_fraction is not None else share
            for t in tenants]


class TenantScheduler:
    """Carve a cluster's hosting nodes into per-tenant slices."""

    def __init__(self, *, policy: str = "partition", dispatcher: int = 0):
        if policy not in POLICIES:
            raise ValueError(
                f"policy must be one of {POLICIES}, got {policy!r}")
        self.policy = policy
        self.dispatcher = dispatcher

    def carve(self, comm, tenants: Sequence[TenantSpec]) -> TenancyPlan:
        """Place every tenant; raises ``ValueError`` when the cluster has
        fewer hosting nodes than tenants (no slice can be empty)."""
        tenants = list(tenants)
        hosting = [
            i for i in range(comm.n)
            if comm.node_capacity[i] > 0 and i != self.dispatcher
        ]
        fracs = resolve_fractions(tenants)
        if self.policy == "shared":
            placements = tuple(
                TenantPlacement(t.name, tuple(hosting), f, t.weight)
                for t, f in zip(tenants, fracs)
            )
            return TenancyPlan("shared", placements, spare=())

        if len(tenants) > len(hosting):
            raise ValueError(
                f"{len(tenants)} tenant(s) need at least one hosting node "
                f"each but the cluster has {len(hosting)}")
        counts = self._apportion(fracs, len(hosting))
        groups = split_cluster(
            comm, len(tenants), dispatcher=self.dispatcher, targets=counts)
        taken = {i for g in groups for i in g}
        placements = tuple(
            TenantPlacement(t.name, g, f, t.weight)
            for t, g, f in zip(tenants, groups, fracs)
        )
        spare = tuple(i for i in hosting if i not in taken)
        return TenancyPlan("partition", placements, spare=spare)

    @staticmethod
    def _apportion(fracs: Sequence[float], n_hosting: int) -> list[int]:
        """Largest-remainder node counts: every tenant >= 1 node, total =
        what the fractions entitle (spares stay unclaimed)."""
        raw = [f * n_hosting for f in fracs]
        budget = int(math.floor(sum(raw) + 1e-9))
        budget = min(n_hosting, max(len(fracs), budget))
        counts = [1] * len(fracs)
        for _ in range(budget - len(fracs)):
            i = max(range(len(fracs)),
                    key=lambda j: (raw[j] - counts[j], -j))
            counts[i] += 1
        return counts
