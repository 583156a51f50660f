"""Paper Fig. 3 simulation: spatially-random edge clusters, wireless links.

"we simulated a set of randomly placed edge devices with a wireless network
whose link bandwidths are modeled realistically as a function of inter-node
distances" -- nodes are placed uniformly at random in a square arena; link
bandwidth follows a log-distance path-loss model mapped through Shannon
capacity (a standard 802.11-style model).  Each (model, capacity, n_nodes,
n_classes) cell is run ``trials`` times (paper: 50) and averaged.

Node 0 is the *dispatcher* (leader): it feeds model input to the first
partition and receives the final output; it never hosts a partition
(capacity -1), matching the paper's dispatcher/compute-node split.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.graph import LayerGraph
from repro_torch.core.partitioner import partition_min_bottleneck
from repro_torch.core.placement import CommGraph, place_color_coding

# ---------------------------------------------------------------------------
# Wireless link model
# ---------------------------------------------------------------------------

TX_POWER_DBM = 20.0  # typical AP/client
PATHLOSS_1M_DB = 40.0  # free-space at 2.4/5 GHz, 1 m
PATHLOSS_EXP = 3.0  # indoor/obstructed
NOISE_FLOOR_DBM = -90.0
CHANNEL_HZ = 20e6
MAX_LINK_BPS = 600e6  # PHY cap
MIN_SNR_DB = 0.0  # below this the link is unusable


def wireless_bandwidth_bps(dist_m: np.ndarray) -> np.ndarray:
    """Log-distance path loss -> Shannon capacity, in bits/s."""
    d = np.maximum(np.asarray(dist_m, dtype=float), 1.0)
    pl = PATHLOSS_1M_DB + 10.0 * PATHLOSS_EXP * np.log10(d)
    snr_db = TX_POWER_DBM - pl - NOISE_FLOOR_DBM
    snr = 10.0 ** (snr_db / 10.0)
    cap = CHANNEL_HZ * np.log2(1.0 + snr)
    cap = np.minimum(cap, MAX_LINK_BPS)
    return np.where(snr_db >= MIN_SNR_DB, cap, 0.0)


def cluster_from_positions(
    pos: np.ndarray, capacity_bytes: float, dispatcher_idx: int | None = 0
) -> CommGraph:
    """Wireless CommGraph from (n, 2) node positions.

    ``dispatcher_idx`` (if set) gets capacity -1: it hosts no partition,
    matching the paper's dispatcher/compute-node split.
    """
    pos = np.asarray(pos, dtype=float)
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    bw_bps = wireless_bandwidth_bps(d)
    np.fill_diagonal(bw_bps, 0.0)
    bw_bytes = bw_bps / 8.0
    cap = np.full(len(pos), float(capacity_bytes))
    if dispatcher_idx is not None:
        cap[dispatcher_idx] = -1.0
    return CommGraph(bw=bw_bytes, node_capacity=cap)


def random_cluster(
    n_nodes: int,
    capacity_bytes: float,
    arena_m: float = 100.0,
    seed: int = 0,
    *,
    with_positions: bool = False,
) -> CommGraph | tuple[CommGraph, np.ndarray]:
    """n_nodes compute nodes + dispatcher (index 0), random positions.

    With ``with_positions=True`` also returns the (n+1, 2) position array so
    the cluster can later be grown with ``expand_cluster`` (node-join churn).
    """
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, arena_m, size=(n_nodes + 1, 2))
    comm = cluster_from_positions(pos, capacity_bytes)
    return (comm, pos) if with_positions else comm


def expand_cluster(
    positions: np.ndarray,
    capacity_bytes: float,
    arena_m: float = 100.0,
    seed: int = 0,
) -> tuple[CommGraph, np.ndarray]:
    """Add one node at a random position; bandwidths re-derived from geometry.

    Existing pairwise links are unchanged (same positions -> same distances),
    so the result is valid for ``EdgeCluster.add_node``.  Returns the grown
    CommGraph and the grown position array.
    """
    rng = np.random.default_rng(seed)
    new_pos = np.vstack([positions, rng.uniform(0.0, arena_m, size=(1, 2))])
    return cluster_from_positions(new_pos, capacity_bytes), new_pos


# ---------------------------------------------------------------------------
# Single trial & sweep
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrialResult:
    model: str
    capacity: float
    n_nodes: int
    n_classes: int
    seed: int
    feasible: bool
    n_parts: int
    bottleneck_latency: float  # seconds; inf if infeasible
    throughput: float  # inferences/s


def run_trial(
    graph: LayerGraph,
    capacity_bytes: float,
    n_nodes: int,
    n_classes: int | None,
    seed: int,
    arena_m: float = 100.0,
    placer: Callable = place_color_coding,
    include_dispatcher: bool = True,
) -> TrialResult:
    comm = random_cluster(n_nodes, capacity_bytes, arena_m, seed)
    part = partition_min_bottleneck(graph, int(capacity_bytes), max_parts=n_nodes)
    if not part.feasible:
        return TrialResult(
            graph.name, capacity_bytes, n_nodes, n_classes or 0, seed,
            False, 0, float("inf"), 0.0,
        )
    kwargs = dict(
        in_bytes=graph.in_bytes if include_dispatcher else 0.0,
        out_bytes=graph.layers[-1].out_bytes if include_dispatcher else 0.0,
        dispatcher=0 if include_dispatcher else None,
    )
    if placer is place_color_coding:
        kwargs["n_classes"] = n_classes
        kwargs["seed"] = seed
    place = placer(
        part.boundaries, [p.param_bytes for p in part.partitions], comm, **kwargs
    )
    return TrialResult(
        graph.name,
        capacity_bytes,
        n_nodes,
        n_classes or 0,
        seed,
        place.feasible,
        part.n_parts,
        place.bottleneck_latency,
        place.throughput if place.feasible else 0.0,
    )


def sweep(
    models: Mapping[str, Callable[[], LayerGraph]],
    capacities: Sequence[float],
    node_counts: Sequence[int],
    class_counts: Sequence[int | None],
    trials: int = 50,
    arena_m: float = 100.0,
    placer: Callable = place_color_coding,
    base_seed: int = 0,
) -> list[TrialResult]:
    """Full Fig.3-style sweep.  Returns one TrialResult per trial."""
    results: list[TrialResult] = []
    graphs = {name: fn() for name, fn in models.items()}
    for (mname, graph), cap, n, c in itertools.product(
        graphs.items(), capacities, node_counts, class_counts
    ):
        for t in range(trials):
            seed = base_seed + 7919 * t + hash((mname, cap, n, c)) % 10007
            results.append(
                run_trial(graph, cap, n, c, seed, arena_m, placer=placer)
            )
    return results


def aggregate(results: Iterable[TrialResult]) -> dict[tuple, dict[str, float]]:
    """Mean bottleneck latency / throughput per (model, cap, nodes, classes).

    Infeasible trials are excluded from the latency mean but reported via
    ``feasible_frac`` (the paper averages over feasible runs).
    """
    cells: dict[tuple, list[TrialResult]] = {}
    for r in results:
        cells.setdefault((r.model, r.capacity, r.n_nodes, r.n_classes), []).append(r)
    out: dict[tuple, dict[str, float]] = {}
    for key, rs in sorted(cells.items()):
        feas = [r for r in rs if r.feasible and np.isfinite(r.bottleneck_latency)]
        out[key] = {
            "mean_bottleneck_s": float(np.mean([r.bottleneck_latency for r in feas]))
            if feas
            else float("inf"),
            "mean_throughput": float(np.mean([r.throughput for r in feas])) if feas else 0.0,
            "mean_parts": float(np.mean([r.n_parts for r in feas])) if feas else 0.0,
            "feasible_frac": len(feas) / len(rs),
            "n_trials": float(len(rs)),
        }
    return out
