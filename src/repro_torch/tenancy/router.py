"""``TenancyRouter``: multiplex per-tenant serving loops on one timeline.

Each tenant serves through its own engine (``PipelinedServingLoop``) over
its own node slice; the router co-simulates them on one shared virtual
timeline by one discrete-event rule -- always advance the *lagging* tenant
-- so the merged completion stream is in time order across tenants.

Admission is quota-scoped: each tenant's ``admission_depth`` (its
``TenantSpec`` quota) is enforced inside that tenant's own loop, so one
tenant's overload sheds *its* arrivals without starving another's queue.
Ties on the shared timeline break by **weighted-fair deficit**: every
completion charges ``1 / weight`` to its tenant, and the tenant with the
smallest accumulated charge is served first among equally-lagging loops --
on shared nodes (the scheduler's ``"shared"`` policy) this is what
apportions service ``weight``-proportionally.

Completions are stamped with their tenant (``Request.tenant``), and
metrics/latency reports come back keyed per tenant.
"""

from __future__ import annotations

from typing import Any

from repro_torch.cluster.serving import Request, latency_report, normalize_metrics


class TenancyRouter:
    """Weighted-fair multiplexer over per-tenant serving loops."""

    def __init__(
        self,
        loops: dict[str, Any],
        *,
        weights: dict[str, float] | None = None,
        quotas: dict[str, int | None] | None = None,
    ):
        if not loops:
            raise ValueError("at least one tenant loop is required")
        self.loops = dict(loops)
        self.weights = {
            name: float((weights or {}).get(name, 1.0)) for name in loops}
        if any(w <= 0 for w in self.weights.values()):
            raise ValueError("tenant weights must be > 0")
        self.quotas = {
            name: (quotas or {}).get(name) for name in loops}
        self.served = {name: 0 for name in loops}
        self._deficit = {name: 0.0 for name in loops}

    # -- aggregate views -----------------------------------------------------
    @property
    def clock_s(self) -> float:
        return max((loop.clock_s for loop in self.loops.values()), default=0.0)

    def loop(self, tenant: str):
        return self.loops[tenant]

    def completed(self, tenant: str | None = None) -> list[Request]:
        if tenant is not None:
            return list(self.loops[tenant].completed)
        out = [r for loop in self.loops.values() for r in loop.completed]
        out.sort(key=lambda r: (r.completed_s, r.tenant or "", r.req_id))
        return out

    @property
    def backlog(self) -> int:
        return sum(loop.backlog for loop in self.loops.values())

    @property
    def pending_arrivals(self) -> int:
        return sum(loop.pending_arrivals for loop in self.loops.values())

    # -- admission -----------------------------------------------------------
    def submit(self, tenant: str, x: Any, *,
               slo_class: str | None = None) -> Request:
        req = self.loops[tenant].submit(x, slo_class=slo_class)
        req.tenant = tenant
        return req

    def schedule(self, tenant: str, x: Any, at_s: float, *,
                 slo_class: str | None = None) -> Request:
        req = self.loops[tenant].schedule(x, at_s, slo_class=slo_class)
        req.tenant = tenant
        return req

    # -- serving -------------------------------------------------------------
    def _has_work(self, loop) -> bool:
        return loop.backlog > 0 or loop.pending_arrivals > 0

    def _pick(self) -> str | None:
        """The lagging tenant among those with work; weighted-fair deficit
        breaks clock ties (served/weight lowest first), then name."""
        ready = [n for n, loop in self.loops.items() if self._has_work(loop)]
        if not ready:
            return None
        return min(
            ready,
            key=lambda n: (self.loops[n].clock_s, self._deficit[n], n),
        )

    def step(self) -> list[Request]:
        """Advance the picked tenant's engine by one completion burst."""
        name = self._pick()
        if name is None:
            return []
        out = self.loops[name].step()
        for req in out:
            req.tenant = name
        self.served[name] += len(out)
        self._deficit[name] += len(out) / self.weights[name]
        return out

    def drain(self, max_rounds: int = 100_000) -> list[Request]:
        """Serve until every tenant's queue empties (stall-guarded: a pass
        where no loop advances -- e.g. a tenant with a dead slice -- stops
        instead of spinning)."""
        done: list[Request] = []
        stalled = 0
        for _ in range(max_rounds):
            if not any(self._has_work(loop) for loop in self.loops.values()):
                return done
            before = self._fingerprint()
            done.extend(self.step())
            if self._fingerprint() == before:
                stalled += 1
                if stalled > len(self.loops):
                    return done
            else:
                stalled = 0
        raise RuntimeError(f"drain did not converge in {max_rounds} rounds")

    def _fingerprint(self) -> tuple:
        return tuple(
            (loop.clock_s, loop.backlog, loop.pending_arrivals,
             len(loop.completed))
            for loop in self.loops.values()
        )

    # -- reporting -----------------------------------------------------------
    def latency_report(
        self, class_targets: dict[str, dict] | None = None,
    ) -> dict:
        """Per-tenant latency percentiles (``class_targets`` maps tenant ->
        that tenant's SLO-class targets)."""
        return {
            name: latency_report(
                loop.completed, (class_targets or {}).get(name))
            for name, loop in self.loops.items()
        }

    def metrics(self) -> dict:
        return normalize_metrics({
            "mode": "multi-tenant",
            "clock_s": self.clock_s,
            "backlog": self.backlog,
            "pending_arrivals": self.pending_arrivals,
            "fairness": {
                name: {
                    "weight": self.weights[name],
                    "quota": self.quotas[name],
                    "served": self.served[name],
                    "deficit": self._deficit[name],
                }
                for name in self.loops
            },
            "tenants": {
                name: loop.metrics() for name, loop in self.loops.items()
            },
        })
