"""Load-driven replica autoscaling over the replicated serving router.

The ``ReplicaSet`` changes replica count only on churn (a group that can
no longer host the model retires).  Heavy traffic needs the other direction
too: capacity that tracks *load*.  The ``Autoscaler`` watches the router's
observed backlog and recent p99 latency each serving round and

  * **grows** -- bootstraps a standby node group into a brand-new replica
    (control plane + engine appended to the router) when the per-replica
    backlog crosses ``backlog_high`` or the recent p99 drifts past
    ``target_p99_s``;
  * **shrinks** -- retires the weakest live replica through the exact
    split/retire machinery churn uses (``ReplicaSet.mark_retired`` + router
    reclaim, so in-flight requests are re-routed, never dropped) when the
    per-replica backlog falls below ``backlog_low``, returning its group to
    the standby pool;
  * **restores** -- when churn retires the *last* live replica, the router
    asks the autoscaler to grow from standby before failing the queue, so a
    cluster with spare groups self-heals.

Groups come from the planner's widest feasible split
(``plan_replicated(replicas="max")``): ``deploy()`` activates
``min_replicas`` of them and parks the rest here as standby capacity.  A
``cooldown_s`` of virtual time between actions damps oscillation, and every
decision is logged as a ``ScaleEvent`` so tests and benchmarks can assert on
*why* capacity moved, not just how much.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

from repro_torch.obs.stats import percentile


@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    """One autoscaling decision, on the virtual clock.

    ``measurement`` is the observed value that crossed the threshold named
    in ``reason`` (backlog-per-replica, or the recent-window p99 in
    seconds), so dashboards can plot the trigger alongside the decision
    without parsing the reason string.  ``None`` for restore events, where
    the trigger is total replica loss, not a measurement.
    """

    t_s: float
    action: str  # "grow" | "retire" | "restore"
    replica: int
    reason: str
    live_after: int
    measurement: float | None = None

    def summary(self) -> dict:
        return dataclasses.asdict(self)


class Autoscaler:
    """Backlog- and tail-latency-driven replica scaling policy.

    Parameters
    ----------
    make_control:
        ``(group, replica_index) -> bootstrapped ControlPlane`` -- built by
        ``deploy()`` so the autoscaler stays free of planner/store wiring.
        May raise ``RuntimeError`` when the group can no longer host the
        model (e.g. its nodes died while on standby); the group is discarded
        and the next standby group is tried.
    standby_groups:
        disjoint node groups not yet serving; ``grow`` consumes from the
        front, ``shrink`` returns groups to the back (LRU rotation).
    backlog_high / backlog_low:
        per-live-replica backlog thresholds for growing / shrinking.
    target_p99_s:
        optional tail-latency target: p99 over the last ``window``
        completions above this triggers a grow even with modest backlog,
        and shrinking is suppressed until the tail is comfortably (2x)
        inside the target.
    cooldown_s:
        minimum virtual time between scale actions.
    name:
        optional label (the owning tenant under multi-tenant serving) --
        each tenant's autoscaler scales only that tenant's standby budget,
        and the label keys its events in cluster-wide metrics.
    journal:
        optional ``repro_torch.obs.Journal``: every ``ScaleEvent`` is also
        appended there as a ``kind="scale"`` record, so scaling decisions
        interleave with reconciles/recoveries/rollouts on one timeline.
    """

    def __init__(
        self,
        make_control: Callable,
        standby_groups: Sequence[Sequence[int]],
        *,
        min_replicas: int = 1,
        max_replicas: int | None = None,
        backlog_high: float = 16.0,
        backlog_low: float = 2.0,
        target_p99_s: float | None = None,
        cooldown_s: float = 0.5,
        window: int = 32,
        name: str | None = None,
        journal=None,
    ):
        self.make_control = make_control
        self.name = name
        self.journal = journal
        self.standby: list[tuple[int, ...]] = [
            tuple(sorted(g)) for g in standby_groups]
        self.min_replicas = int(min_replicas)
        self.max_replicas = max_replicas
        self.backlog_high = float(backlog_high)
        self.backlog_low = float(backlog_low)
        self.target_p99_s = target_p99_s
        self.cooldown_s = float(cooldown_s)
        self.window = int(window)
        self.events: list[ScaleEvent] = []
        self.discarded: list[tuple[int, ...]] = []  # standby groups gone bad
        self._last_action_s = -math.inf

    # -- observation ---------------------------------------------------------
    def recent_p99(self, router) -> float | None:
        """p99 latency over the last ``window`` completions (None when too
        few completions to call a tail)."""
        done = router.completed
        if len(done) < 8:
            return None
        lats = sorted(r.latency_s for r in done[-self.window:])
        return float(percentile(lats, 0.99))

    def observe(self, router) -> None:
        """One policy tick: called by the router between serving events."""
        now = router.clock_s
        if now - self._last_action_s < self.cooldown_s:
            return
        live = router.replicaset.live_indices()
        if not live:
            return  # the router's restore path handles total loss
        per_replica = router.backlog / len(live)
        p99 = self.recent_p99(router)
        reason = None
        measurement = None
        if per_replica > self.backlog_high:
            reason = (f"backlog/replica {per_replica:.1f} > "
                      f"{self.backlog_high:g}")
            measurement = per_replica
        elif (self.target_p99_s is not None and p99 is not None
              and p99 > self.target_p99_s):
            reason = f"recent p99 {p99:.3g}s > target {self.target_p99_s:g}s"
            measurement = p99
        if reason is not None:
            cap = self.max_replicas
            if cap is None or len(live) < cap:
                self._grow(router, reason, measurement=measurement)
            return
        if (
            per_replica < self.backlog_low
            and len(live) > self.min_replicas
            and not router.pending_arrivals
            and (self.target_p99_s is None or p99 is None
                 or p99 <= 0.5 * self.target_p99_s)
        ):
            self._shrink(
                router,
                f"backlog/replica {per_replica:.1f} < {self.backlog_low:g}",
                measurement=per_replica)

    def restore(self, router) -> bool:
        """Last-live-replica-retired path: grow unconditionally (no
        cooldown -- an outage outranks oscillation damping)."""
        self._last_action_s = -math.inf
        return self._grow(router, "no live replicas", action="restore")

    # -- actions -------------------------------------------------------------
    def _record(self, event: ScaleEvent) -> None:
        self.events.append(event)
        if self.journal is not None:
            source = "autoscaler" if self.name is None \
                else f"{self.name}/autoscaler"
            self.journal.append("scale", source, event.summary(),
                                t_s=event.t_s)

    def _grow(self, router, reason: str, action: str = "grow",
              measurement: float | None = None) -> bool:
        while self.standby:
            group = self.standby.pop(0)
            try:
                control = self.make_control(group, len(router.loops))
            except RuntimeError:
                # the group lost nodes while parked; it cannot host anymore
                self.discarded.append(group)
                continue
            r = router.add_replica(control, group)
            self._last_action_s = router.clock_s
            self._record(ScaleEvent(
                router.clock_s, action, r, reason,
                len(router.replicaset.live_indices()),
                measurement=measurement,
            ))
            return True
        return False

    def _shrink(self, router, reason: str,
                measurement: float | None = None) -> None:
        rset = router.replicaset
        live = rset.live_indices()
        r = rset._weakest(live)
        rset.mark_retired(r, f"autoscale: {reason}")
        router._reclaim(r)  # resident requests re-route to the survivors
        self.standby.append(tuple(sorted(rset.groups[r])))
        self._last_action_s = router.clock_s
        self._record(ScaleEvent(
            router.clock_s, "retire", r, reason,
            len(rset.live_indices()),
            measurement=measurement,
        ))

    # -- reporting -----------------------------------------------------------
    def metrics(self) -> dict:
        return {
            "name": self.name,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "backlog_high": self.backlog_high,
            "backlog_low": self.backlog_low,
            "target_p99_s": self.target_p99_s,
            "cooldown_s": self.cooldown_s,
            "standby_groups": len(self.standby),
            "discarded_groups": len(self.discarded),
            "grows": sum(1 for e in self.events if e.action in ("grow", "restore")),
            "shrinks": sum(1 for e in self.events if e.action == "retire"),
            "events": [e.summary() for e in self.events],
        }
