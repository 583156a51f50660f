"""Partition placement on a communication graph (SEIFER Sec. 2.2-1c).

"Place the partitions such that the ones which transfer the most data are
placed on the highest bandwidth edges in the communication graph."

Formally: given k partitions with boundary weights w_0..w_{k-2} (bytes) and a
node graph with link bandwidths, find an injective node path p_0..p_{k-1}
minimizing  max_i  w_i / bw(p_i, p_{i+1}),  subject to node capacities.
This is a minimum-bottleneck k-path problem (NP-hard in general); per the
paper's acknowledgements we use the Alon-Yuster-Zwick *color-coding* k-path
algorithm on a *bandwidth-class*-quantized graph, with binary search over the
finite set of candidate bottleneck latencies.  For small clusters an exact
subset-DP is used (and doubles as the oracle in tests / the approximation-
ratio benchmark).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Sequence

import numpy as np

from repro_torch.api.registry import register_strategy

EXACT_NODE_LIMIT = 16  # subset DP up to 2^16 states (vectorized per level)

# flat color-coding binary search above this many nodes is replaced by the
# hierarchical coarsen -> k-path -> refine pipeline (near-linear in the
# comm-matrix size instead of superlinear in n)
HIERARCHICAL_NODE_LIMIT = 64


# ---------------------------------------------------------------------------
# Communication graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CommGraph:
    """Symmetric link-bandwidth matrix (bytes/s; 0 = no link) + capacities."""

    bw: np.ndarray  # (n, n) float
    node_capacity: np.ndarray  # (n,) float bytes

    def __post_init__(self) -> None:
        bw = np.asarray(self.bw, dtype=float)
        if bw.ndim != 2 or bw.shape[0] != bw.shape[1]:
            raise ValueError("bw must be square")
        if not np.allclose(bw, bw.T):
            raise ValueError("bw must be symmetric")
        if np.any(bw < 0):
            raise ValueError("bw must be nonnegative")
        object.__setattr__(self, "bw", bw)
        cap = np.asarray(self.node_capacity, dtype=float)
        if cap.shape != (bw.shape[0],):
            raise ValueError("node_capacity shape mismatch")
        object.__setattr__(self, "node_capacity", cap)

    @property
    def n(self) -> int:
        return self.bw.shape[0]

    def key(self) -> int:
        """Content digest for planner-cache keying (computed once: the
        matrices are frozen, so the digest can be memoized on the instance)."""
        k = getattr(self, "_key", None)
        if k is None:
            k = hash((self.bw.tobytes(), self.node_capacity.tobytes()))
            object.__setattr__(self, "_key", k)
        return k

    @staticmethod
    def uniform(bw: np.ndarray, capacity: float) -> "CommGraph":
        n = np.asarray(bw).shape[0]
        return CommGraph(bw=np.asarray(bw, float), node_capacity=np.full(n, float(capacity)))


def quantize_bandwidths(
    bw: np.ndarray, n_classes: int | None, scheme: str = "quantile"
) -> tuple[np.ndarray, np.ndarray]:
    """Discretize link bandwidths into ``n_classes`` classes (paper's knob).

    Each positive edge is replaced by the *floor* of its class (conservative:
    the algorithm never assumes more bandwidth than the link has).  With
    ``n_classes=None`` the graph is returned unquantized (infinite classes).
    Returns (quantized bw matrix, ascending class floor values).
    """
    bw = np.asarray(bw, dtype=float)
    pos = bw[bw > 0]
    if n_classes is None or pos.size == 0:
        vals = np.unique(pos) if pos.size else np.array([])
        return bw.copy(), vals
    n_classes = max(1, int(n_classes))
    lo, hi = pos.min(), pos.max()
    if scheme == "quantile":
        qs = np.quantile(pos, np.linspace(0.0, 1.0, n_classes + 1))
    elif scheme == "geometric":
        qs = np.geomspace(lo, hi, n_classes + 1) if lo > 0 else np.linspace(lo, hi, n_classes + 1)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    floors = qs[:-1]
    # map each edge to the floor of its bucket
    idx = np.clip(np.searchsorted(qs, bw, side="right") - 1, 0, n_classes - 1)
    out = np.where(bw > 0, floors[idx], 0.0)
    return out, np.unique(floors)


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlacementResult:
    feasible: bool
    path: tuple[int, ...]
    bottleneck_latency: float  # on the TRUE (unquantized) bandwidths
    algorithm: str
    trials_used: int = 0

    @property
    def throughput(self) -> float:
        if not self.feasible:
            return 0.0
        return float("inf") if self.bottleneck_latency == 0 else 1.0 / self.bottleneck_latency


def _true_bottleneck(
    boundaries: Sequence[float],
    path: Sequence[int],
    comm: CommGraph,
    in_bytes: float = 0.0,
    out_bytes: float = 0.0,
    dispatcher: int | None = None,
) -> float:
    lat = 0.0
    for i, w in enumerate(boundaries):
        b = comm.bw[path[i], path[i + 1]]
        lat = max(lat, np.inf if b <= 0 else w / b)
    if dispatcher is not None:
        if in_bytes > 0:
            b = comm.bw[dispatcher, path[0]]
            lat = max(lat, np.inf if b <= 0 else in_bytes / b)
        if out_bytes > 0:
            b = comm.bw[path[-1], dispatcher]
            lat = max(lat, np.inf if b <= 0 else out_bytes / b)
    return lat


def _infeasible(algo: str, trials_used: int = 0) -> PlacementResult:
    return PlacementResult(False, (), float("inf"), algo, trials_used)


# ---------------------------------------------------------------------------
# Exact subset DP (minimax) -- oracle + small-n fast path
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _subset_tables(n: int) -> tuple[np.ndarray, tuple[np.ndarray, ...]]:
    """Memoized ``(popcount, subsets_by_popcount)`` tables over ``2^n`` states.

    Both the exact subset DP and the color-coding DP rebuild these on every
    call otherwise -- and ``replicas="auto"`` calls the DP R times per plan,
    so the tables dominated small-cluster planning time.  ``n <=
    EXACT_NODE_LIMIT`` (or k for color coding), so the cache stays tiny.
    """
    nstates = 1 << n
    popcount = np.array([bin(s).count("1") for s in range(nstates)], dtype=np.int32)
    subsets_by_pc = tuple(np.flatnonzero(popcount == p) for p in range(n + 1))
    return popcount, subsets_by_pc


def _exact_minimax_path(
    boundaries: Sequence[float],
    part_bytes: Sequence[float],
    bwq: np.ndarray,
    cap: np.ndarray,
) -> tuple[float, list[int]] | None:
    """Subset DP: dp[S][v] = min bottleneck placing first |S| parts, end v.

    Vectorized per popcount level: O(2^n * n^2) flops but only O(n*k) python
    iterations, so the Fig.3 simulation sweep stays fast.  Exact on the given
    (possibly quantized) bandwidth matrix.
    """
    n = bwq.shape[0]
    k = len(part_bytes)
    if k > n:
        return None
    if k == 1:
        idx = np.flatnonzero(cap >= part_bytes[0])
        return (0.0, [int(idx[0])]) if idx.size else None
    INF = np.inf
    nstates = 1 << n
    dp = np.full((nstates, n), INF)
    # latency matrices per boundary position: lat[pos][v, u] = w/bw(v,u)
    with np.errstate(divide="ignore"):
        lat = [np.where(bwq > 0, w / np.maximum(bwq, 1e-300), INF) for w in boundaries]
        for L in lat:
            np.fill_diagonal(L, INF)
    ok0 = np.flatnonzero(cap >= part_bytes[0])
    if ok0.size == 0:
        return None
    dp[1 << ok0, ok0] = 0.0
    _, subsets_by_pc = _subset_tables(n)
    for p in range(1, k):
        Ss = subsets_by_pc[p]
        block = dp[Ss]  # (m, n)
        finite_rows = np.isfinite(block).any(axis=1)
        if not finite_rows.any():
            return None  # dead end: no placement of first p partitions
        Ss, block = Ss[finite_rows], block[finite_rows]
        pos = p - 1
        # cand[m, u] = min over v of max(block[m, v], lat[pos][v, u])
        cand = np.min(np.maximum(block[:, :, None], lat[pos][None, :, :]), axis=1)
        okc = cap >= part_bytes[p]
        for u in range(n):
            if not okc[u]:
                continue
            bit = 1 << u
            mask = (Ss & bit) == 0
            if not mask.any():
                continue
            np.minimum.at(dp, (Ss[mask] | bit, u), cand[mask, u])
    # best over |S| == k
    Sk = subsets_by_pc[k]
    vals = dp[Sk]
    flat = int(np.argmin(vals))
    best_state = int(Sk[flat // n])
    best_v = flat % n
    best_val = float(vals[flat // n, flat % n])
    if not np.isfinite(best_val):
        return None
    # reconstruct by walking equalities backwards (maxes are exact copies)
    path = [best_v]
    S, v, val = best_state, best_v, best_val
    for p in range(k - 1, 0, -1):
        Sp = S & ~(1 << v)
        found = False
        for u in range(n):
            if not (Sp >> u) & 1:
                continue
            step = max(dp[Sp, u], lat[p - 1][u, v])
            if step == val or (np.isfinite(step) and step <= val + 1e-18):
                S, v, val = Sp, u, float(dp[Sp, u])
                path.append(u)
                found = True
                break
        if not found:  # pragma: no cover - defensive
            return None
    path.reverse()
    return best_val, path


# ---------------------------------------------------------------------------
# Color-coding k-path feasibility (large n)
# ---------------------------------------------------------------------------

def _color_coding_feasible(
    feas: list[np.ndarray],  # per-position boolean edge feasibility (n, n)
    cap_ok: list[np.ndarray],  # per-position boolean node feasibility (n,)
    k: int,
    trials: int,
    rng: np.random.Generator,
) -> tuple[list[int] | None, int]:
    """Alon-Yuster-Zwick color coding: random k-colorings + color-subset DP.

    Returns ``(path, trials_used)`` -- a feasible path (list of k node ids)
    or None, plus the number of colorings actually drawn (1 on a first-trial
    hit; ``trials`` on failure).  Monte-Carlo: may miss a feasible path with
    probability <= (1 - k!/k^k)^trials.
    """
    if k == 1:
        idx = np.flatnonzero(cap_ok[0])
        return ([int(idx[0])] if idx.size else None), 0
    n = feas[0].shape[0]
    nstates = 1 << k
    popcount, _ = _subset_tables(k)
    order = np.argsort(popcount, kind="stable")
    for trial in range(trials):
        colors = rng.integers(0, k, size=n)
        color_bit = (1 << colors).astype(np.int64)
        dp = np.zeros((nstates, n), dtype=bool)
        parent = np.full((nstates, n), -1, dtype=np.int32)
        for v in range(n):
            if cap_ok[0][v]:
                dp[color_bit[v], v] = True
        found: tuple[int, int] | None = None
        for S in order:
            pc = popcount[S]
            if pc == 0 or pc >= k:
                continue
            row = dp[S]
            if not row.any():
                continue
            pos = pc - 1
            # reach[u] = any_v row[v] & feas[pos][v, u]
            reach = row @ feas[pos]  # bool matmul
            newmask = reach & cap_ok[pc] & ((color_bit & S) == 0)
            if not newmask.any():
                continue
            vs = np.flatnonzero(row)
            for u in np.flatnonzero(newmask):
                S2 = S | int(color_bit[u])
                if not dp[S2, u]:
                    dp[S2, u] = True
                    # any predecessor works; pick the first feasible
                    pred = vs[feas[pos][vs, u]][0]
                    parent[S2, u] = pred
                    if popcount[S2] == k:
                        found = (S2, u)
            if found:
                break
        if found:
            S, v = found
            path = [v]
            while parent[S, v] >= 0:
                u = int(parent[S, v])
                S &= ~int(1 << int(np.log2(int(color_bit[v]))))
                v = u
                path.append(v)
            path.reverse()
            return [int(x) for x in path], trial + 1
    return None, trials


# ---------------------------------------------------------------------------
# Color-coding binary search over candidate bottleneck latencies
# ---------------------------------------------------------------------------

def _search_color_coding(
    boundaries: Sequence[float],
    part_bytes: Sequence[float],
    bwq: np.ndarray,
    class_vals: np.ndarray,
    cap: np.ndarray,
    trials: int,
    seed: int,
) -> tuple[list[int] | None, int]:
    """Binary search the finite candidate-latency lattice with Monte-Carlo
    color-coding feasibility checks.  Returns ``(path, trials_used)``.

    Each feasibility check draws its colorings from an RNG seeded by
    ``(seed, candidate_index)``, so whether level ``i`` is judged feasible is
    a pure function of the instance -- not of the order the binary search
    happened to visit levels through a shared RNG stream.  A color-coding
    *false negative* at ``mid`` would otherwise prune the lower (better)
    half outright, so after the search converges a confirmation pass spends
    a doubled trial budget one level below the found candidate (and keeps
    descending while that succeeds).
    """
    k = len(part_bytes)
    cands = sorted(
        {w / c for w in boundaries for c in class_vals if c > 0 and w > 0} | {0.0}
    )
    cap_ok = [cap >= pb for pb in part_bytes]

    def check(idx: int, n_trials: int) -> list[int] | None:
        nonlocal trials_used
        L = cands[idx]
        feas = [
            (bwq > 0) & (bwq * max(L, 1e-300) >= w) if w > 0 else (bwq > 0)
            for w in boundaries
        ]
        rng = np.random.default_rng((seed, idx))
        path, used = _color_coding_feasible(feas, cap_ok, k, n_trials, rng)
        trials_used += used
        return path

    lo, hi = 0, len(cands) - 1
    best_path: list[int] | None = None
    best_idx: int | None = None
    trials_used = 0
    while lo <= hi:
        mid = (lo + hi) // 2
        path = check(mid, trials)
        if path is not None:
            best_path, best_idx = path, mid
            hi = mid - 1
        else:
            lo = mid + 1
    # confirmation pass: a false negative during the search may have pruned
    # strictly better levels; re-try below the found candidate harder
    while best_idx is not None and best_idx > 0:
        path = check(best_idx - 1, 2 * trials)
        if path is None:
            break
        best_path, best_idx = path, best_idx - 1
    return best_path, trials_used


# ---------------------------------------------------------------------------
# Public placement algorithms
# ---------------------------------------------------------------------------

@register_strategy(
    "placer", "color_coding", default=True,
    description="paper's placer: bandwidth-class quantization + min-bottleneck "
                "k-path (exact subset DP small n, color coding mid n, "
                "hierarchical coarsen+refine large n)",
)
def place_color_coding(
    boundaries: Sequence[float],
    part_bytes: Sequence[float],
    comm: CommGraph,
    n_classes: int | None = 4,
    trials: int = 60,
    seed: int = 0,
    exact_limit: int = EXACT_NODE_LIMIT,
    in_bytes: float = 0.0,
    out_bytes: float = 0.0,
    dispatcher: int | None = None,
    hierarchical_limit: int | None = HIERARCHICAL_NODE_LIMIT,
    quantized: tuple[np.ndarray, np.ndarray] | None = None,
) -> PlacementResult:
    """SEIFER placement: bandwidth-class quantization + min-bottleneck k-path.

    Small clusters (n <= exact_limit) use the exact subset DP on the
    quantized graph; mid-size clusters binary-search the candidate
    bottleneck latencies with color-coding feasibility checks; clusters
    above ``hierarchical_limit`` nodes (``None`` disables) delegate to
    ``place_hierarchical`` -- coarsen into bandwidth-tiered groups, solve
    the k-path over groups, refine within the winning groups.  The reported
    bottleneck latency is always evaluated on the TRUE bandwidths of the
    found path.  ``quantized`` short-circuits ``quantize_bandwidths`` with
    a precomputed ``(bwq, class_vals)`` pair (the planner's cache).
    """
    algo = f"color_coding(c={n_classes})"
    k = len(part_bytes)
    if k == 0 or k > comm.n:
        return _infeasible(algo)
    if hierarchical_limit is not None and comm.n > hierarchical_limit:
        return place_hierarchical(
            boundaries, part_bytes, comm,
            n_classes=n_classes, trials=trials, seed=seed,
            exact_limit=exact_limit, in_bytes=in_bytes, out_bytes=out_bytes,
            dispatcher=dispatcher, quantized=quantized,
        )
    bwq, class_vals = (
        quantized if quantized is not None
        else quantize_bandwidths(comm.bw, n_classes)
    )
    cap = comm.node_capacity

    if comm.n <= exact_limit:
        res = _exact_minimax_path(boundaries, part_bytes, bwq, cap)
        if res is None:
            return _infeasible(algo)
        _, path = res
        lat = _true_bottleneck(boundaries, path, comm, in_bytes, out_bytes, dispatcher)
        return PlacementResult(True, tuple(path), float(lat), algo)

    best_path, trials_used = _search_color_coding(
        boundaries, part_bytes, bwq, class_vals, cap, trials, seed)
    if best_path is None:
        return _infeasible(algo, trials_used)
    lat = _true_bottleneck(boundaries, best_path, comm, in_bytes, out_bytes, dispatcher)
    return PlacementResult(True, tuple(best_path), float(lat), algo, trials_used)


# ---------------------------------------------------------------------------
# Hierarchical large-n placement: coarsen -> group k-path -> refine
# ---------------------------------------------------------------------------

def _bandwidth_groups(
    bw: np.ndarray, hosting: Sequence[int], group_size: int
) -> list[list[int]]:
    """Cluster hosting nodes into bandwidth-tiered groups of <= group_size.

    Greedy: seed each group at the best-connected unassigned node (largest
    total bandwidth into the remaining hosting set), then attach its
    strongest unassigned neighbors.  One numpy pass per group, so the whole
    coarsening is near-linear in the comm-matrix size.
    """
    hosting = np.asarray(sorted(hosting), dtype=int)
    sub = bw[np.ix_(hosting, hosting)]
    unassigned = np.ones(len(hosting), dtype=bool)
    totals = sub.sum(axis=1)
    groups: list[list[int]] = []
    while unassigned.any():
        live = np.flatnonzero(unassigned)
        seed_local = live[int(np.argmax(totals[live]))]
        row = np.where(unassigned, sub[seed_local], -1.0)
        row[seed_local] = -1.0
        nbrs = np.argsort(-row, kind="stable")[: group_size - 1]
        members = [seed_local] + [int(u) for u in nbrs if row[u] > 0]
        unassigned[members] = False
        groups.append([int(hosting[m]) for m in members])
    return groups


def _coarse_group_path(
    boundaries: Sequence[float],
    part_bytes: Sequence[float],
    groups: list[list[int]],
    bw: np.ndarray,
    cap: np.ndarray,
    in_bytes: float,
    out_bytes: float,
    dispatcher: int | None,
) -> list[int] | None:
    """Min-bottleneck k-path over group representatives.

    DP over (group, run-length) states: position ``p`` ends in group ``g``
    having placed the last ``c+1`` consecutive partitions there.  Staying
    inside a group is charged its median intra-group bandwidth; crossing to
    another group its best inter-group link (the refinement stage picks the
    actual members, so the aggregate is a planning estimate, not a claim).
    Returns one group index per partition position, or None when no
    capacity-feasible group sequence exists.
    """
    k = len(part_bytes)
    G = len(groups)
    gmax = max(len(g) for g in groups)
    INF = np.inf
    # aggregate bandwidths
    intra = np.zeros(G)
    for gi, g in enumerate(groups):
        block = bw[np.ix_(g, g)]
        pos_links = block[block > 0]
        intra[gi] = float(np.median(pos_links)) if pos_links.size else 0.0
    inter = np.zeros((G, G))
    for gi in range(G):
        for hj in range(gi + 1, G):
            m = float(bw[np.ix_(groups[gi], groups[hj])].max())
            inter[gi, hj] = inter[hj, gi] = m
    # cap_count[g, p] = members of g able to host partition p
    cap_count = np.array([
        [int(np.sum(cap[np.asarray(g)] >= pb)) for pb in part_bytes]
        for g in groups
    ])
    disp_bw = np.array([
        float(bw[dispatcher, g].max()) if dispatcher is not None else 0.0
        for g in groups
    ])

    def edge(w: float, rate: np.ndarray) -> np.ndarray:
        rate = np.asarray(rate, dtype=float)
        if w <= 0:
            return np.zeros_like(rate)
        return np.where(rate > 0, w / np.maximum(rate, 1e-300), INF)

    # dp[g, c]: bottleneck; wmin[g, c]: min cap_count over the current run
    dp = np.full((G, gmax), INF)
    wmin = np.zeros((G, gmax), dtype=int)
    start_lat = edge(in_bytes, disp_bw) if dispatcher is not None else np.zeros(G)
    feas0 = cap_count[:, 0] >= 1
    dp[feas0, 0] = start_lat[feas0]
    wmin[:, 0] = cap_count[:, 0]
    parents: list[np.ndarray] = []  # per position: (G, gmax, 2) parent state
    for p in range(1, k):
        w = float(boundaries[p - 1])
        inter_lat = edge(w, inter)
        np.fill_diagonal(inter_lat, INF)
        intra_lat = edge(w, intra)
        m = dp.min(axis=1)  # best run-length per group
        mc = dp.argmin(axis=1)
        # move into h from the best source group
        move_scores = np.maximum(m[:, None], inter_lat)  # (src g, dst h)
        move = move_scores.min(axis=0)
        move_src = move_scores.argmin(axis=0)
        new_dp = np.full((G, gmax), INF)
        new_wmin = np.zeros((G, gmax), dtype=int)
        parent = np.full((G, gmax, 2), -1, dtype=np.int32)
        ok_h = cap_count[:, p] >= 1
        new_dp[ok_h, 0] = move[ok_h]
        new_wmin[:, 0] = cap_count[:, p]
        parent[ok_h, 0, 0] = move_src[ok_h]
        parent[ok_h, 0, 1] = mc[move_src[ok_h]]
        # stay in g, run length c+1 (needs c+1 hostable members in the run)
        stay = np.maximum(dp[:, :-1], intra_lat[:, None])
        run_wmin = np.minimum(wmin[:, :-1], cap_count[:, p][:, None])
        run_len = np.arange(2, gmax + 1)[None, :]
        stay = np.where(run_wmin >= run_len, stay, INF)
        better = stay < new_dp[:, 1:]
        new_dp[:, 1:] = np.where(better, stay, new_dp[:, 1:])
        new_wmin[:, 1:] = np.where(better, run_wmin, new_wmin[:, 1:])
        gg = np.arange(G)[:, None].repeat(gmax - 1, axis=1)
        cc = np.arange(gmax - 1)[None, :].repeat(G, axis=0)
        parent[:, 1:, 0] = np.where(better, gg, parent[:, 1:, 0])
        parent[:, 1:, 1] = np.where(better, cc, parent[:, 1:, 1])
        dp, wmin = new_dp, new_wmin
        parents.append(parent)
    final = dp.copy()
    if dispatcher is not None and out_bytes > 0:
        final = np.maximum(final, np.asarray(edge(out_bytes, disp_bw))[:, None])
    if not np.isfinite(final.min()):
        return None
    flat = int(np.argmin(final))
    g, c = flat // gmax, flat % gmax
    seq = [g]
    for p in range(k - 1, 0, -1):
        g, c = (int(x) for x in parents[p - 1][g, c])
        if g < 0:  # pragma: no cover - defensive
            return None
        seq.append(g)
    seq.reverse()
    return seq


@register_strategy(
    "placer", "hierarchical",
    description="hierarchical large-n placer: bandwidth-tiered groups, "
                "coarse k-path over group representatives, refinement "
                "within the winning groups (near-linear in cluster size)",
)
def place_hierarchical(
    boundaries: Sequence[float],
    part_bytes: Sequence[float],
    comm: CommGraph,
    n_classes: int | None = 4,
    trials: int = 60,
    seed: int = 0,
    exact_limit: int = EXACT_NODE_LIMIT,
    group_size: int | None = None,
    refine_limit: int | None = None,
    in_bytes: float = 0.0,
    out_bytes: float = 0.0,
    dispatcher: int | None = None,
    quantized: tuple[np.ndarray, np.ndarray] | None = None,
) -> PlacementResult:
    """Hierarchical min-bottleneck placement for large clusters.

    Three stages, each bounded so total work is near-linear in the size of
    the comm matrix instead of superlinear in ``n``:

      1. **coarsen** -- cluster hosting nodes into bandwidth-tiered groups
         of <= ``group_size`` (default ``EXACT_NODE_LIMIT``),
      2. **coarse solve** -- min-bottleneck k-path over group
         representatives (DP over (group, run-length) states),
      3. **refine** -- re-solve exactly (or by flat color coding when the
         union exceeds ``exact_limit``) inside the union of the winning
         groups, trimmed to <= ``refine_limit`` nodes.

    Falls back to the flat full-graph color-coding search when the coarse
    stage or the refinement finds no feasible path, so it is never less
    complete than the flat algorithm -- only cheaper.
    """
    k = len(part_bytes)
    n = comm.n
    if group_size is None:
        group_size = EXACT_NODE_LIMIT
    if refine_limit is None:
        refine_limit = max(exact_limit, k + 4)
    algo = f"hierarchical(c={n_classes},g={group_size})"
    if k == 0 or k > n:
        return _infeasible(algo)
    cap = comm.node_capacity
    hosting = [
        i for i in range(n)
        if cap[i] >= min(part_bytes) and i != dispatcher and comm.bw[i].max() > 0
    ]
    if len(hosting) < k:
        return _infeasible(algo)

    def flat_fallback() -> PlacementResult:
        res = place_color_coding(
            boundaries, part_bytes, comm,
            n_classes=n_classes, trials=trials, seed=seed,
            exact_limit=exact_limit, in_bytes=in_bytes, out_bytes=out_bytes,
            dispatcher=dispatcher, hierarchical_limit=None, quantized=quantized,
        )
        return dataclasses.replace(res, algorithm=algo + "+flat_fallback")

    groups = _bandwidth_groups(comm.bw, hosting, group_size)
    if len(groups) <= 1:
        return flat_fallback()  # one tier: the flat solve IS the refinement
    seq = _coarse_group_path(
        boundaries, part_bytes, groups, comm.bw, cap,
        in_bytes, out_bytes, dispatcher,
    )
    if seq is None:
        return flat_fallback()

    # union of winning groups, trimmed to refine_limit by per-group quota
    chosen = sorted(set(seq), key=seq.index)
    positions = {g: sum(1 for s in seq if s == g) for g in chosen}
    union: list[int] = []
    budget = max(refine_limit, k)
    for g in chosen:
        quota = max(positions[g] + 1,
                    int(round(budget * positions[g] / k)))
        members = groups[g]
        if len(members) > quota:
            arr = np.asarray(members)
            conn = comm.bw[np.ix_(arr, arr)].sum(axis=1)
            members = [int(arr[i]) for i in np.argsort(-conn, kind="stable")[:quota]]
        union.extend(m for m in members if m not in union)
    union = union[: max(budget, k)]
    if len(union) < k:
        return flat_fallback()

    # refinement sub-cluster: winning members + the dispatcher (links only)
    sub_nodes = list(union)
    sub_disp = None
    if dispatcher is not None:
        sub_disp = len(sub_nodes)
        sub_nodes.append(dispatcher)
    idx = np.asarray(sub_nodes)
    sub_cap = cap[idx].copy()
    if sub_disp is not None:
        sub_cap[sub_disp] = min(float(sub_cap[sub_disp]), 0.0)
    sub = CommGraph(bw=comm.bw[np.ix_(idx, idx)], node_capacity=sub_cap)
    res = place_color_coding(
        boundaries, part_bytes, sub,
        n_classes=n_classes, trials=trials, seed=seed, exact_limit=exact_limit,
        in_bytes=in_bytes, out_bytes=out_bytes, dispatcher=sub_disp,
        hierarchical_limit=None,
    )
    if not res.feasible:
        return flat_fallback()
    path = tuple(int(idx[v]) for v in res.path)
    lat = _true_bottleneck(boundaries, path, comm, in_bytes, out_bytes, dispatcher)
    return PlacementResult(True, path, float(lat), algo, res.trials_used)


@register_strategy(
    "placer", "greedy",
    description="left-to-right greedy: always take the fastest feasible link",
)
def place_greedy(
    boundaries: Sequence[float],
    part_bytes: Sequence[float],
    comm: CommGraph,
    in_bytes: float = 0.0,
    out_bytes: float = 0.0,
    dispatcher: int | None = None,
) -> PlacementResult:
    """Left-to-right greedy: from every start node, repeatedly take the
    highest-bandwidth feasible edge.  Cheap baseline (paper's 'edge
    matching' in its simplest form)."""
    algo = "greedy"
    k = len(part_bytes)
    n = comm.n
    if k == 0 or k > n:
        return _infeasible(algo)
    best: tuple[float, list[int]] | None = None
    cap_ok = [comm.node_capacity >= pb for pb in part_bytes]
    for start in range(n):
        if not cap_ok[0][start]:
            continue
        path = [start]
        avail = np.ones(n, dtype=bool)
        avail[start] = False
        ok = True
        for pos in range(k - 1):
            cand_bw = np.where(avail & cap_ok[pos + 1], comm.bw[path[-1]], -1.0)
            u = int(np.argmax(cand_bw))
            if cand_bw[u] <= 0:
                ok = False
                break
            path.append(u)
            avail[u] = False
        if not ok:
            continue
        lat = _true_bottleneck(boundaries, path, comm, in_bytes, out_bytes, dispatcher)
        if best is None or lat < best[0]:
            best = (lat, path)
    if best is None:
        return _infeasible(algo)
    return PlacementResult(True, tuple(best[1]), float(best[0]), algo)


@register_strategy(
    "placer", "random",
    description="random feasible path -- the no-algorithm baseline",
)
def place_random(
    boundaries: Sequence[float],
    part_bytes: Sequence[float],
    comm: CommGraph,
    seed: int = 0,
    attempts: int = 20,
    in_bytes: float = 0.0,
    out_bytes: float = 0.0,
    dispatcher: int | None = None,
) -> PlacementResult:
    """Random feasible path -- the no-algorithm baseline."""
    algo = "random"
    rng = np.random.default_rng(seed)
    k = len(part_bytes)
    n = comm.n
    if k == 0 or k > n:
        return _infeasible(algo)
    for _ in range(attempts):
        perm = rng.permutation(n)[:k]
        if any(comm.node_capacity[perm[j]] < part_bytes[j] for j in range(k)):
            continue
        if any(comm.bw[perm[i], perm[i + 1]] <= 0 for i in range(k - 1)):
            continue
        lat = _true_bottleneck(boundaries, list(perm), comm, in_bytes, out_bytes, dispatcher)
        return PlacementResult(True, tuple(int(x) for x in perm), float(lat), algo)
    return _infeasible(algo)


@register_strategy(
    "placer", "optimal",
    description="exact optimum on TRUE bandwidths (subset DP, n <= 16)",
)
def place_optimal(
    boundaries: Sequence[float],
    part_bytes: Sequence[float],
    comm: CommGraph,
    in_bytes: float = 0.0,
    out_bytes: float = 0.0,
    dispatcher: int | None = None,
) -> PlacementResult:
    """Exact optimum on the TRUE bandwidths (subset DP).

    Limited to ``n <= EXACT_NODE_LIMIT`` (16) -- the guard below enforces
    exactly that bound.  Used for the approximation-ratio benchmark (paper
    Sec. 4, item 2) and as the refinement oracle inside
    ``place_hierarchical``.
    """
    algo = "optimal"
    if comm.n > EXACT_NODE_LIMIT:
        raise ValueError(f"place_optimal limited to n <= {EXACT_NODE_LIMIT}")
    k = len(part_bytes)
    if k == 0 or k > comm.n:
        return _infeasible(algo)
    res = _exact_minimax_path(boundaries, part_bytes, comm.bw, comm.node_capacity)
    if res is None:
        return _infeasible(algo)
    _, path = res
    lat = _true_bottleneck(boundaries, path, comm, in_bytes, out_bytes, dispatcher)
    return PlacementResult(True, tuple(path), float(lat), algo)


def place_brute_force(
    boundaries: Sequence[float],
    part_bytes: Sequence[float],
    comm: CommGraph,
) -> PlacementResult:
    """Permutation brute force (n <= 8) -- test oracle for place_optimal."""
    algo = "brute_force"
    n, k = comm.n, len(part_bytes)
    if n > 8:
        raise ValueError("brute force limited to n <= 8")
    if k == 0 or k > n:
        return _infeasible(algo)
    best: tuple[float, tuple[int, ...]] | None = None
    for perm in itertools.permutations(range(n), k):
        if any(comm.node_capacity[perm[j]] < part_bytes[j] for j in range(k)):
            continue
        lat = _true_bottleneck(boundaries, perm, comm)
        if np.isfinite(lat) and (best is None or lat < best[0]):
            best = (lat, perm)
    if best is None:
        return _infeasible(algo)
    return PlacementResult(True, best[1], float(best[0]), algo)
