"""``Planner``: compile a spec (or a raw graph + cluster) into a ``Plan``.

The planner is the *policy-free* middle of the API: it resolves strategy
names through the registry, runs partition -> placement (or a joint
optimizer), and scores the result with the simulator's pipeline metrics --
no cluster machinery, no pods.  ``Plan`` subsumes the old
``dispatcher.DeploymentPlan`` (same ``version``/``partition``/``placement``
fields, so ``Dispatcher.deploy`` consumes it unchanged) and adds the
predicted bottleneck/throughput plus the strategy names that produced it.

Strategy functions keep their natural signatures; the planner passes each
one only the keyword arguments it accepts (``inspect.signature``-filtered),
so e.g. ``place_greedy`` never sees ``n_classes`` and ``place_random``
still gets its ``seed``.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import TYPE_CHECKING, Sequence

import numpy as np

from repro_torch.api.registry import default_strategy, get_strategy
from repro_torch.core.bottleneck import evaluate_pipeline
from repro_torch.core.graph import LayerGraph
from repro_torch.core.partitioner import PartitionResult
from repro_torch.core.placement import CommGraph, PlacementResult

if TYPE_CHECKING:
    from repro_torch.api.spec import DeploymentSpec, SpecIssue


@dataclasses.dataclass(frozen=True)
class Plan:
    """A compiled deployment: partition + placement + predicted metrics.

    Drop-in for the old ``dispatcher.DeploymentPlan`` (which is now an alias
    of this class): ``Dispatcher.deploy`` reads ``version``, ``partition``,
    ``placement``, ``feasible``.
    """

    version: int
    partition: PartitionResult
    placement: PlacementResult
    # the placement objective: max link latency on UNCOMPRESSED boundaries
    predicted_bottleneck_s: float = float("inf")
    # 1 / pipeline period, codec-, compression- and compute-aware
    predicted_throughput: float = 0.0
    strategies: tuple[tuple[str, str], ...] = ()  # (kind, name) pairs
    # transfer codec per hop (len n_parts + 1); () = all-identity legacy plan
    codecs: tuple[str, ...] = ()

    @property
    def feasible(self) -> bool:
        return self.partition.feasible and self.placement.feasible

    @property
    def n_parts(self) -> int:
        return self.partition.n_parts

    @property
    def path(self) -> tuple[int, ...]:
        return self.placement.path

    def strategy(self, kind: str) -> str | None:
        return dict(self.strategies).get(kind)

    def slo_issues(self, spec: "DeploymentSpec") -> tuple["SpecIssue", ...]:
        """Check the plan's predictions against the spec's SLOs."""
        from repro_torch.api.spec import SpecIssue

        issues = []
        if not self.feasible:
            issues.append(SpecIssue(
                "infeasible_plan",
                f"{self.partition.algorithm}/{self.placement.algorithm} found "
                f"no feasible partition+placement on this cluster",
            ))
            return tuple(issues)
        if (spec.max_bottleneck_s is not None
                and self.predicted_bottleneck_s > spec.max_bottleneck_s):
            issues.append(SpecIssue(
                "slo_bottleneck",
                f"predicted bottleneck {self.predicted_bottleneck_s:.3e} s "
                f"exceeds the max_bottleneck_s SLO {spec.max_bottleneck_s:.3e} s",
            ))
        if (spec.min_throughput is not None
                and self.predicted_throughput < spec.min_throughput):
            issues.append(SpecIssue(
                "slo_throughput",
                f"predicted throughput {self.predicted_throughput:.3e}/s is "
                f"below the min_throughput SLO {spec.min_throughput:.3e}/s",
            ))
        return tuple(issues)

    def summary(self) -> dict:
        """JSON-ready description (stored by the dispatcher, logged by benches)."""
        return {
            "version": self.version,
            "feasible": self.feasible,
            "cuts": list(self.partition.cuts),
            "path": list(self.placement.path),
            "bottleneck_latency": self.placement.bottleneck_latency,
            "predicted_bottleneck_s": self.predicted_bottleneck_s,
            "predicted_throughput": self.predicted_throughput,
            "algorithm": self.placement.algorithm,
            "strategies": {k: v for k, v in self.strategies},
            "codecs": list(self.codecs),
        }


def _filter_kwargs(fn, kwargs: dict) -> dict:
    """Keep only the kwargs ``fn``'s signature accepts."""
    params = inspect.signature(fn).parameters
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return kwargs
    return {k: v for k, v in kwargs.items() if k in params}


class PlanCache:
    """Memo for the expensive per-plan sublattices, keyed by (cluster
    generation / comm digest, spec knobs).

    Every recovery re-solves placement on every churn event; without the
    cache each of those recomputes the bandwidth quantization from
    scratch.  Entries are keyed on explicit
    content keys (``CommGraph.key()`` digests, ``EdgeCluster.generation``
    counters), so a stale hit is impossible as long as the key captures
    every input -- the property the planner call sites maintain.
    """

    def __init__(self, max_entries: int = 512):
        self.max_entries = int(max_entries)
        self._store: dict = {}
        self.hits = 0
        self.misses = 0

    def lookup(self, key, build):
        """Return the cached value for ``key``, building (and storing) it on
        a miss.  FIFO-evicts when full; a raising ``build`` caches nothing."""
        if key in self._store:
            self.hits += 1
            return self._store[key]
        value = build()
        self.misses += 1
        if len(self._store) >= self.max_entries:
            self._store.pop(next(iter(self._store)))
        self._store[key] = value
        return value

    def invalidate(self) -> None:
        self._store.clear()

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._store)}


class Planner:
    """Resolve strategy names once; compile graphs + clusters into ``Plan``s.

    One planner instance is shared by a ``Dispatcher``/``ControlPlane`` and
    reused across reconfigurations; per-call ``seed`` overrides keep the
    dispatcher's probe-noise RNG stream in charge of placement randomness
    (exactly the pre-API behavior, which the parity regression test pins).
    """

    def __init__(
        self,
        partitioner: str | None = None,
        placer: str | None = None,
        joint: str | None = None,
        *,
        n_classes: int | None = 4,
        seed: int = 0,
        codec: str | None = None,
        accuracy_tolerance: float | None = None,
        cache: PlanCache | None = None,
    ):
        from repro_torch.dataplane import AUTO, default_codec, get_codec

        self.partitioner = get_strategy(
            "partitioner", partitioner or default_strategy("partitioner"))
        self.placer = get_strategy("placer", placer or default_strategy("placer"))
        self.joint = get_strategy("joint", joint) if joint is not None else None
        self.n_classes = n_classes
        self.seed = seed
        self.cache = cache if cache is not None else PlanCache()
        self.codec = codec or default_codec()
        if self.codec != AUTO:
            get_codec(self.codec)  # typos raise here, with suggestions
        self.accuracy_tolerance = accuracy_tolerance

    @classmethod
    def from_spec(cls, spec: "DeploymentSpec") -> "Planner":
        return cls(
            partitioner=spec.partitioner,
            placer=spec.placer,
            joint=spec.joint,
            n_classes=spec.n_classes,
            seed=spec.seed,
            codec=spec.codec,
            accuracy_tolerance=spec.accuracy_tolerance,
        )

    def strategy_names(self) -> tuple[tuple[str, str], ...]:
        """The strategies that actually plan: a joint optimizer REPLACES the
        partitioner+placer pipeline, so only it is reported when set."""
        if self.joint is not None:
            return (("joint", self.joint.name),)
        return (("partitioner", self.partitioner.name),
                ("placer", self.placer.name))

    # -- core compilation ----------------------------------------------------
    def plan(
        self,
        graph: LayerGraph,
        comm: CommGraph,
        *,
        capacity: float | None = None,
        version: int = 0,
        max_parts: int | None = None,
        seed: int | None = None,
        include_dispatcher: bool = True,
        dispatcher: int | None = None,
        device_flops: float | Sequence[float] | None = None,
        compression_ratio: float = 1.0,
    ) -> Plan:
        """Partition + place ``graph`` on ``comm``; score the result.

        ``capacity`` defaults to the cluster's max node capacity.  ``seed``
        overrides the planner's own (the dispatcher threads its RNG stream
        through here).  With a joint strategy set, partitioning and placement
        are solved together and the partitioner/placer names are ignored.
        """
        if seed is None:
            seed = self.seed
        cap = capacity if capacity is not None else float(max(comm.node_capacity))
        in_bytes = graph.in_bytes if include_dispatcher else 0.0
        out_bytes = graph.layers[-1].out_bytes if include_dispatcher else 0.0

        if self.joint is not None:
            res = self.joint.fn(
                graph, comm, int(cap),
                **_filter_kwargs(self.joint.fn, dict(
                    n_classes=self.n_classes, seed=seed, max_parts=max_parts,
                    include_dispatcher=include_dispatcher, dispatcher=dispatcher,
                )),
            )
            part, place = res.partition, res.placement
        else:
            part = self.partitioner.fn(
                graph, int(cap),
                **_filter_kwargs(self.partitioner.fn, dict(max_parts=max_parts)),
            )
            if not part.feasible:
                return Plan(version, part,
                            PlacementResult(False, (), float("inf"), "n/a"),
                            strategies=self.strategy_names())
            place = self.place(
                part.boundaries, [p.param_bytes for p in part.partitions], comm,
                seed=seed, in_bytes=in_bytes, out_bytes=out_bytes,
                dispatcher=dispatcher,
            )

        if not (part.feasible and place.feasible):
            return Plan(version, part, place, strategies=self.strategy_names())
        codecs = self.assign_codecs(
            [in_bytes, *(p.out_bytes for p in part.partitions[:-1]), out_bytes],
            place.path, comm.bw,
            dispatcher=dispatcher, flops_per_node=device_flops,
            compression_ratio=compression_ratio,
        )
        metrics = evaluate_pipeline(
            part.partitions, place.path, comm,
            device_flops=device_flops, in_bytes=in_bytes, out_bytes=out_bytes,
            dispatcher=dispatcher, compression_ratio=compression_ratio,
            codecs=codecs,
        )
        return Plan(
            version, part, place,
            predicted_bottleneck_s=float(place.bottleneck_latency),
            predicted_throughput=float(metrics.effective_throughput),
            strategies=self.strategy_names(),
            codecs=codecs,
        )

    def assign_codecs(
        self,
        hop_bytes,
        path,
        bw,
        *,
        dispatcher: int | None = None,
        flops_per_node=None,
        compression_ratio: float = 1.0,
    ) -> tuple[str, ...]:
        """Codec-per-hop for a placed pipeline, under this planner's codec
        config (a fixed name on every inter-stage hop, or the ``"auto"``
        per-link optimum within ``accuracy_tolerance``).  Also the recovery
        path's entry point: a re-placement changes the links, so the
        dispatcher re-runs the assignment for the new path."""
        from repro_torch.dataplane import assign_link_codecs

        return assign_link_codecs(
            hop_bytes, path, bw,
            codec=self.codec, tolerance=self.accuracy_tolerance,
            flops_per_node=flops_per_node, dispatcher=dispatcher,
            compression_ratio=compression_ratio,
        )

    def place(
        self,
        boundaries,
        part_bytes,
        comm: CommGraph,
        *,
        seed: int | None = None,
        in_bytes: float = 0.0,
        out_bytes: float = 0.0,
        dispatcher: int | None = None,
    ) -> PlacementResult:
        """Placement only -- the dispatcher's re-placement (recovery) path."""
        if seed is None:
            seed = self.seed
        kwargs = dict(
            n_classes=self.n_classes, seed=seed,
            in_bytes=in_bytes, out_bytes=out_bytes, dispatcher=dispatcher,
        )
        params = inspect.signature(self.placer.fn).parameters
        if "quantized" in params:
            # the quantized bandwidth-class sublattice is pure in (comm,
            # n_classes): share it across every recovery re-solve on an
            # unchanged comm
            from repro_torch.core.placement import quantize_bandwidths

            kwargs["quantized"] = self.cache.lookup(
                ("quantize", comm.key(), self.n_classes),
                lambda: quantize_bandwidths(comm.bw, self.n_classes),
            )
        return self.placer.fn(
            boundaries, part_bytes, comm, **_filter_kwargs(self.placer.fn, kwargs),
        )

    # -- spec front door -----------------------------------------------------
    def compile(self, spec: "DeploymentSpec", *, version: int = 0) -> Plan:
        """Validate a spec, build its cluster, plan, and enforce SLOs.

        Raises ``InfeasibleSpecError`` (with structured reasons) on a bad
        spec, an infeasible plan, or a missed SLO.  This is the pure-planning
        entry point; ``api.deploy`` adds the serving stack on top.
        """
        from repro_torch.api.spec import InfeasibleSpecError

        spec.check()
        graph = spec.graph()
        comm, _ = spec.cluster.build()
        # mirror Dispatcher.configure at bootstrap (all nodes healthy, leader
        # = lowest id = 0, dispatcher round-trip always scored) so the pure
        # planning answer agrees with what deploy() would deploy -- modulo
        # probe noise, which only deploy() sees
        plan = self.plan(
            graph, comm,
            capacity=spec.capacity, version=version, max_parts=comm.n,
            dispatcher=0,
            include_dispatcher=True,
            compression_ratio=spec.compression_ratio,
        )
        issues = plan.slo_issues(spec)
        if issues:
            raise InfeasibleSpecError(issues)
        return plan


# ---------------------------------------------------------------------------
# Disjoint sub-clusters: the tenancy scheduler's carve
# ---------------------------------------------------------------------------

def split_cluster(
    comm: CommGraph,
    n_replicas: int,
    *,
    dispatcher: int | None = None,
    nodes: Sequence[int] | None = None,
    targets: Sequence[int] | None = None,
) -> list[tuple[int, ...]]:
    """Partition the hosting nodes into ``n_replicas`` disjoint groups.

    Greedy bandwidth-aware split: seed one group per replica with mutually
    far-apart (low-bandwidth) nodes -- so each group can grow around a
    distinct well-connected neighbourhood -- then repeatedly attach the
    (node, group) pair with the highest mean bandwidth from the node to the
    group's members, keeping group sizes balanced (within one node).  The
    dispatcher node never joins a group; it is shared by every replica.

    ``targets`` overrides the balanced sizing with one node count per group
    (the tenancy scheduler's quota carve): group ``r`` stops growing at
    ``targets[r]`` members, and when the targets sum to fewer than the
    hosting nodes the leftovers stay ungrouped (spare capacity).

    Deterministic; raises ``ValueError`` when fewer hosting nodes than
    replicas are available or the targets cannot be honored.
    """
    hosting = [
        i for i in range(comm.n)
        if comm.node_capacity[i] > 0 and i != dispatcher
        and (nodes is None or i in set(nodes))
    ]
    if n_replicas < 1:
        raise ValueError("n_replicas must be >= 1")
    if n_replicas > len(hosting):
        raise ValueError(
            f"cannot split {len(hosting)} hosting node(s) into "
            f"{n_replicas} replica group(s)"
        )
    if targets is not None:
        targets = [int(t) for t in targets]
        if len(targets) != n_replicas:
            raise ValueError(
                f"targets has {len(targets)} entries for "
                f"{n_replicas} group(s)")
        if any(t < 1 for t in targets):
            raise ValueError("every group target must be >= 1")
        if sum(targets) > len(hosting):
            raise ValueError(
                f"targets sum to {sum(targets)} but only "
                f"{len(hosting)} hosting node(s) are available")
    if n_replicas == 1 and targets is None:
        return [tuple(hosting)]

    bw = comm.bw
    # seeds: farthest-point traversal on bandwidth (low bw = far), starting
    # from the best-connected node, so replica neighbourhoods don't overlap
    totals = {i: float(sum(bw[i, j] for j in hosting if j != i)) for i in hosting}
    first = max(hosting, key=lambda i: (totals[i], -i))
    seeds = [first]
    while len(seeds) < n_replicas:
        # the node whose strongest link INTO the seed set is weakest
        cand = max(
            (i for i in hosting if i not in seeds),
            key=lambda i: (-max(float(bw[i, s]) for s in seeds), totals[i], -i),
        )
        seeds.append(cand)

    if targets is None:
        base, extra = divmod(len(hosting), n_replicas)
        targets = [base + (1 if r < extra else 0) for r in range(n_replicas)]
    groups: list[list[int]] = [[s] for s in seeds]
    remaining = [i for i in hosting if i not in seeds]
    while remaining:
        best = None  # (score, -node, r, node)
        for r, g in enumerate(groups):
            if len(g) >= targets[r]:
                continue
            for i in remaining:
                score = float(np.mean([bw[i, j] for j in g]))
                key = (score, -i, -r)
                if best is None or key > best[0]:
                    best = (key, r, i)
        if best is None:
            break  # every group is at target; leftovers stay spare
        _, r, i = best
        groups[r].append(i)
        remaining.remove(i)
    return [tuple(sorted(g)) for g in groups]


def subcluster(
    comm: CommGraph, group: Sequence[int], *, keep: Sequence[int] = ()
) -> CommGraph:
    """A replica's view of the cluster: the group's nodes plus the shared
    dispatcher (``keep``).  Nodes outside the view lose links and capacity;
    kept-but-not-hosting nodes (the dispatcher) keep links only -- so a
    plan compiled on the sub-cluster can never place outside the group."""
    allowed = set(group) | set(keep)
    bw = comm.bw.copy()
    cap = comm.node_capacity.copy()
    group_set = set(group)
    for i in range(comm.n):
        if i not in allowed:
            bw[i, :] = 0.0
            bw[:, i] = 0.0
            cap[i] = 0.0
        elif i not in group_set:
            cap[i] = min(cap[i], 0.0)
    return CommGraph(bw=bw, node_capacity=cap)
