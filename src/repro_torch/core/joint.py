"""Joint partition + placement optimization (SEIFER Sec. 4, future work #3).

The paper's pipeline optimizes partitioning and placement *sequentially*:
first min-cut partitions, then bottleneck placement.  This module implements
the joint strategy the paper proposes to compare against: enumerate the
Pareto frontier of partitions (each distinct max-cut threshold yields a
different partition count / boundary profile), solve placement for each, and
keep the best end-to-end bottleneck.  Because fewer partitions means fewer
(possibly slow) links but larger per-node memory, neither extreme dominates
-- the joint search closes the gap, and `benchmarks/joint_opt.py` quantifies
it against the sequential baseline.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.api.registry import register_strategy
from repro_torch.core.graph import LayerGraph
from repro_torch.core.partitioner import (
    PartitionResult,
    partition_exact_k,
    partition_min_bottleneck,
)
from repro_torch.core.placement import CommGraph, PlacementResult, place_color_coding


@dataclasses.dataclass(frozen=True)
class JointResult:
    partition: PartitionResult
    placement: PlacementResult

    @property
    def feasible(self) -> bool:
        return self.partition.feasible and self.placement.feasible

    @property
    def bottleneck_latency(self) -> float:
        return self.placement.bottleneck_latency if self.feasible else float("inf")


@register_strategy(
    "joint", "sequential", default=True,
    description="paper's pipeline: min-bottleneck partition, then placement",
)
def sequential(
    graph: LayerGraph,
    comm: CommGraph,
    capacity: int,
    n_classes: int | None = 4,
    seed: int = 0,
    include_dispatcher: bool = False,
    dispatcher: int | None = None,
    max_parts: int | None = None,
) -> JointResult:
    """The paper's pipeline: min-bottleneck partition, then placement.

    ``max_parts`` caps the part count (callers exclude non-hosting nodes,
    e.g. the dispatcher); ``None`` allows up to one part per node.
    """
    if max_parts is None:
        max_parts = comm.n
    part = partition_min_bottleneck(graph, capacity, max_parts=max_parts)
    if not part.feasible:
        return JointResult(part, PlacementResult(False, (), float("inf"), "n/a"))
    place = place_color_coding(
        part.boundaries,
        [p.param_bytes for p in part.partitions],
        comm,
        n_classes=n_classes,
        seed=seed,
        in_bytes=graph.in_bytes if include_dispatcher else 0.0,
        out_bytes=graph.layers[-1].out_bytes if include_dispatcher else 0.0,
        dispatcher=dispatcher,
    )
    return JointResult(part, place)


@register_strategy(
    "joint", "joint",
    description="joint search over the partition-count frontier (future work #3)",
)
def joint(
    graph: LayerGraph,
    comm: CommGraph,
    capacity: int,
    n_classes: int | None = 4,
    seed: int = 0,
    include_dispatcher: bool = False,
    dispatcher: int | None = None,
    max_candidates: int | None = None,
    max_parts: int | None = None,
) -> JointResult:
    """Joint search over the partition-count frontier.

    For each feasible part count k in [k_min, max_parts], compute the exact-k
    min-max-cut partition, place it, and keep the lowest true bottleneck.
    """
    if max_parts is None:
        max_parts = comm.n
    base = partition_min_bottleneck(graph, capacity, max_parts=max_parts)
    if not base.feasible:
        return JointResult(base, PlacementResult(False, (), float("inf"), "n/a"))
    k_min = base.n_parts
    ks: Sequence[int] = range(k_min, max_parts + 1)
    if max_candidates is not None:
        ks = list(ks)[:max_candidates]
    # the sequential solution is always on the frontier: joint can only improve
    seq = sequential(graph, comm, capacity, n_classes=n_classes, seed=seed,
                     include_dispatcher=include_dispatcher, dispatcher=dispatcher,
                     max_parts=max_parts)
    best: JointResult | None = seq if seq.feasible else None
    for k in ks:
        part = partition_exact_k(graph, capacity, k)
        if not part.feasible:
            continue
        place = place_color_coding(
            part.boundaries,
            [p.param_bytes for p in part.partitions],
            comm,
            n_classes=n_classes,
            seed=seed,
            in_bytes=graph.in_bytes if include_dispatcher else 0.0,
            out_bytes=graph.layers[-1].out_bytes if include_dispatcher else 0.0,
            dispatcher=dispatcher,
        )
        if not place.feasible:
            continue
        cand = JointResult(part, place)
        if best is None or cand.bottleneck_latency < best.bottleneck_latency:
            best = cand
    if best is None:
        return JointResult(base, PlacementResult(False, (), float("inf"), "n/a"))
    return best
