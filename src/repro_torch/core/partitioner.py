"""DNN partitioning: contiguous layer ranges under a per-node memory cap.

The paper (SEIFER Sec. 2.2-1b): "Find the model partitions such that the
least amount of data is transferred between model layers, and such that each
model partition will fit within the compute node's memory."

Because the end-to-end objective is *bottleneck* latency (max over links),
the primary partitioner here minimizes the **maximum** cut-edge weight
(min-max cut).  We also provide:

  * ``partition_paper_greedy``   -- the paper's capacity-filling greedy that
    backtracks to the cheapest recent edge (SEIFER's published description is
    a sketch; this is the natural reading and serves as the paper baseline).
  * ``partition_min_sum``        -- DP minimizing *total* transferred bytes
    (the natural alternative objective; used in the ablation benchmark).
  * ``partition_min_bottleneck`` -- optimal min-max cut via binary search
    over edge weights + greedy feasibility (exact, O(E log E * n)).
  * ``partition_exact_k``        -- min-max cut with exactly k parts (DP).
  * ``partition_exhaustive``     -- brute-force oracle for tests.

All functions return a ``PartitionResult``; infeasible inputs (a single
layer exceeding capacity, or more parts required than allowed) yield
``feasible=False`` rather than raising, so the placement layer / simulator
can score infeasible configs.

Every algorithm self-registers in the strategy registry
(``repro_torch.api.registry``) under the names the declarative API uses:
``min_bottleneck`` (default), ``paper_greedy``, ``min_sum``, ``exact_k``
(minimal-part-count variant), ``uniform`` (equal-layer-count baseline),
``exhaustive``.  The shared registered signature is
``fn(graph, capacity, max_parts=None) -> PartitionResult``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

from repro_torch.api.registry import register_strategy
from repro_torch.core.graph import LayerGraph, Partition, boundary_bytes, make_partitions


@dataclasses.dataclass(frozen=True)
class PartitionResult:
    feasible: bool
    cuts: tuple[int, ...]  # edge indices that were cut
    partitions: tuple[Partition, ...]
    max_cut_bytes: int  # max activation bytes over cut edges (0 if no cut)
    total_cut_bytes: int
    algorithm: str

    @property
    def n_parts(self) -> int:
        return len(self.partitions)

    @property
    def boundaries(self) -> tuple[int, ...]:
        return boundary_bytes(self.partitions)


def _result(graph: LayerGraph, cuts: Sequence[int], algo: str) -> PartitionResult:
    parts = make_partitions(graph, cuts)
    bounds = boundary_bytes(parts)
    return PartitionResult(
        feasible=True,
        cuts=tuple(sorted(cuts)),
        partitions=parts,
        max_cut_bytes=max(bounds, default=0),
        total_cut_bytes=sum(bounds),
        algorithm=algo,
    )


def _infeasible(algo: str) -> PartitionResult:
    return PartitionResult(
        feasible=False,
        cuts=(),
        partitions=(),
        max_cut_bytes=0,
        total_cut_bytes=0,
        algorithm=algo,
    )


def _fits(graph: LayerGraph, capacity: int) -> bool:
    """Every single layer must fit on a node, else no partition exists."""
    return all(l.param_bytes <= capacity for l in graph.layers)


# ---------------------------------------------------------------------------
# Paper greedy
# ---------------------------------------------------------------------------

@register_strategy(
    "partitioner", "paper_greedy",
    description="paper's capacity-filling greedy, cheapest-recent-edge backtracking",
)
def partition_paper_greedy(
    graph: LayerGraph, capacity: int, max_parts: int | None = None
) -> PartitionResult:
    """Capacity-filling greedy with cheapest-recent-edge backtracking.

    Walk the chain accumulating layers.  When the running segment would
    exceed ``capacity``, cut at the minimum-weight edge *inside* the current
    segment (not necessarily the last edge), then restart accumulation after
    the cut.  This realizes "least data transferred subject to fitting".
    A ``max_parts`` budget the greedy overruns yields ``feasible=False``.
    """
    algo = "paper_greedy"
    if not _fits(graph, capacity):
        return _infeasible(algo)
    n = len(graph)
    cuts: list[int] = []
    seg_start = 0
    acc = 0
    i = 0
    while i < n:
        w = graph.layers[i].param_bytes
        if acc + w <= capacity:
            acc += w
            i += 1
            continue
        # must cut inside [seg_start, i); pick the cheapest edge
        best_edge = min(
            range(seg_start, i), key=lambda e: (graph.edge_bytes(e), e)
        )
        cuts.append(best_edge)
        seg_start = best_edge + 1
        acc = graph.segment_param_bytes(seg_start, i)
        # re-check: remaining prefix may still exceed capacity; loop continues
        if acc > capacity:
            # the cheapest edge was too early; fall back to cutting just
            # before i (always reduces the segment)
            cuts[-1] = i - 1
            seg_start = i
            acc = 0
    if max_parts is not None and len(cuts) + 1 > max_parts:
        return _infeasible(algo)
    return _result(graph, cuts, algo)


# ---------------------------------------------------------------------------
# Optimal min-max cut
# ---------------------------------------------------------------------------

def _feasible_with_threshold(
    graph: LayerGraph, capacity: int, thresh: int, max_parts: int | None
) -> list[int] | None:
    """Greedy feasibility: partition using only edges with weight <= thresh.

    Cut as *late* as possible (minimizes part count).  Returns cuts or None.
    """
    n = len(graph)
    cuts: list[int] = []
    seg_start = 0
    acc = 0
    last_ok_edge = -1  # latest allowed edge index inside the current segment
    for i in range(n):
        w = graph.layers[i].param_bytes
        if acc + w > capacity:
            if last_ok_edge < seg_start:
                return None  # no allowed cut inside the segment
            cuts.append(last_ok_edge)
            seg_start = last_ok_edge + 1
            acc = graph.segment_param_bytes(seg_start, i)
            last_ok_edge = seg_start - 1
            if acc + w > capacity:
                return None  # even after the cut, prefix too big (rare)
        acc += w
        if i < n - 1 and graph.edge_bytes(i) <= thresh:
            last_ok_edge = i
    if max_parts is not None and len(cuts) + 1 > max_parts:
        return None
    return cuts


@register_strategy(
    "partitioner", "min_bottleneck", default=True,
    description="exact min of max cut-edge bytes (binary search + late-cut greedy)",
)
def partition_min_bottleneck(
    graph: LayerGraph, capacity: int, max_parts: int | None = None
) -> PartitionResult:
    """Exact minimum of max-cut-edge weight, subject to capacity/part count.

    Binary search over the sorted distinct edge weights; each candidate is
    checked with the late-cut greedy (optimal for interval feasibility).
    If the whole model fits on one node, returns the trivial partition.
    """
    algo = "min_bottleneck"
    if not _fits(graph, capacity):
        return _infeasible(algo)
    if graph.total_param_bytes <= capacity:
        return _result(graph, [], algo)
    weights = sorted(set(graph.edges))
    lo, hi = 0, len(weights) - 1
    best: list[int] | None = None
    while lo <= hi:
        mid = (lo + hi) // 2
        cuts = _feasible_with_threshold(graph, capacity, weights[mid], max_parts)
        if cuts is not None:
            best = cuts
            hi = mid - 1
        else:
            lo = mid + 1
    if best is None:
        return _infeasible(algo)
    return _result(graph, best, algo)


# ---------------------------------------------------------------------------
# Min total transfer (DP)
# ---------------------------------------------------------------------------

@register_strategy(
    "partitioner", "min_sum",
    description="DP minimizing total transferred bytes over all cuts",
)
def partition_min_sum(
    graph: LayerGraph, capacity: int, max_parts: int | None = None
) -> PartitionResult:
    """DP minimizing the total bytes over all cuts. O(n^2 * k)."""
    algo = "min_sum"
    if not _fits(graph, capacity):
        return _infeasible(algo)
    n = len(graph)
    kmax = max_parts if max_parts is not None else n
    prefix = graph.prefix_param_bytes()
    INF = float("inf")
    # dp[j][i] = min total cut bytes splitting layers[:i] into j parts
    dp = [[INF] * (n + 1) for _ in range(kmax + 1)]
    par: dict[tuple[int, int], int] = {}
    dp[0][0] = 0.0
    for j in range(1, kmax + 1):
        for i in range(1, n + 1):
            for s in range(i):  # previous boundary: layers[s:i] is part j
                if prefix[i] - prefix[s] > capacity:
                    continue
                cost = dp[j - 1][s] + (graph.edge_bytes(s - 1) if s > 0 else 0)
                if cost < dp[j][i]:
                    dp[j][i] = cost
                    par[(j, i)] = s
    best_j = min(
        (j for j in range(1, kmax + 1) if dp[j][n] < INF),
        key=lambda j: dp[j][n],
        default=None,
    )
    if best_j is None:
        return _infeasible(algo)
    cuts: list[int] = []
    i, j = n, best_j
    while j > 0:
        s = par[(j, i)]
        if s > 0:
            cuts.append(s - 1)
        i, j = s, j - 1
    return _result(graph, cuts, algo)


# ---------------------------------------------------------------------------
# Exactly-k min-max cut (DP)
# ---------------------------------------------------------------------------

def partition_exact_k(graph: LayerGraph, capacity: int, k: int) -> PartitionResult:
    """Minimize max cut weight with *exactly* k parts. O(n^2 k)."""
    algo = "exact_k"
    if k < 1 or not _fits(graph, capacity):
        return _infeasible(algo)
    n = len(graph)
    if k > n:
        return _infeasible(algo)
    prefix = graph.prefix_param_bytes()
    INF = float("inf")
    dp = [[INF] * (n + 1) for _ in range(k + 1)]
    par: dict[tuple[int, int], int] = {}
    dp[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(1, n + 1):
            for s in range(i):
                if prefix[i] - prefix[s] > capacity:
                    continue
                edge = graph.edge_bytes(s - 1) if s > 0 else 0
                cost = max(dp[j - 1][s], edge)
                if cost < dp[j][i]:
                    dp[j][i] = cost
                    par[(j, i)] = s
    if dp[k][n] == INF:
        return _infeasible(algo)
    cuts: list[int] = []
    i, j = n, k
    while j > 0:
        s = par[(j, i)]
        if s > 0:
            cuts.append(s - 1)
        i, j = s, j - 1
    return _result(graph, cuts, algo)


@register_strategy(
    "partitioner", "exact_k",
    description="min-max cut at the minimal feasible part count (fewest pods)",
)
def partition_fewest_parts(
    graph: LayerGraph, capacity: int, max_parts: int | None = None
) -> PartitionResult:
    """Min-max cut with the *fewest* parts that fit capacity.

    ``min_bottleneck`` happily spends extra parts to shave the max cut; this
    strategy first finds the minimal feasible part count (late-cut greedy
    with every edge allowed), then runs the exact-k DP at that count -- the
    cheapest deployment in pods, optimal among same-size partitions.
    """
    algo = "exact_k"
    if not _fits(graph, capacity):
        return _infeasible(algo)
    max_edge = max(graph.edges, default=0)
    cuts = _feasible_with_threshold(graph, capacity, max_edge, max_parts)
    if cuts is None:
        return _infeasible(algo)
    return partition_exact_k(graph, capacity, len(cuts) + 1)


# ---------------------------------------------------------------------------
# Uniform split (algorithm-free baseline)
# ---------------------------------------------------------------------------

@register_strategy(
    "partitioner", "uniform",
    description="equal-layer-count split at the fewest feasible parts (baseline)",
)
def partition_uniform(
    graph: LayerGraph, capacity: int, max_parts: int | None = None
) -> PartitionResult:
    """Split into k near-equal-layer-count parts, smallest feasible k.

    The no-algorithm baseline: cut positions ignore edge weights entirely
    (cut after layer ``round(i * n / k)`` for i = 1..k-1), so its min-max cut
    is whatever those arbitrary edges happen to weigh.  ``exact_k`` at the
    same k is optimal among k-part partitions, which the property suite
    exploits as an ordering oracle.
    """
    algo = "uniform"
    if not _fits(graph, capacity):
        return _infeasible(algo)
    n = len(graph)
    kmax = min(max_parts, n) if max_parts is not None else n
    for k in range(1, kmax + 1):
        # strictly increasing for k <= n (consecutive targets differ by
        # n/k >= 1), so every part is non-empty
        bounds = [round(i * n / k) for i in range(k + 1)]
        if all(
            graph.segment_param_bytes(bounds[i], bounds[i + 1]) <= capacity
            for i in range(k)
        ):
            cuts = [b - 1 for b in bounds[1:-1]]
            return _result(graph, cuts, algo)
    return _infeasible(algo)


# ---------------------------------------------------------------------------
# Exhaustive oracle (tests only)
# ---------------------------------------------------------------------------

@register_strategy(
    "partitioner", "exhaustive",
    description="brute-force oracle over all cut subsets (<= 18 layers)",
)
def partition_exhaustive(
    graph: LayerGraph, capacity: int, max_parts: int | None = None
) -> PartitionResult:
    """Brute force over all cut subsets; minimizes (max_cut, total_cut, k)."""
    algo = "exhaustive"
    n = len(graph)
    if n > 18:
        raise ValueError("exhaustive oracle limited to 18 layers")
    if not _fits(graph, capacity):
        return _infeasible(algo)
    best: PartitionResult | None = None
    for r in range(n):
        if max_parts is not None and r + 1 > max_parts:
            break
        for cuts in itertools.combinations(range(n - 1), r):
            parts = make_partitions(graph, cuts)
            if any(p.param_bytes > capacity for p in parts):
                continue
            cand = _result(graph, cuts, algo)
            key = (cand.max_cut_bytes, cand.total_cut_bytes, cand.n_parts)
            if best is None or key < (
                best.max_cut_bytes,
                best.total_cut_bytes,
                best.n_parts,
            ):
                best = cand
    return best if best is not None else _infeasible(algo)
