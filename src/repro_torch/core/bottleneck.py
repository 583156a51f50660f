"""Bottleneck-latency / throughput metrics (SEIFER Sec. 2.2-1a).

Latency of a link = bytes transferred / bandwidth.  The *bottleneck latency*
of an inference pipeline is the maximum link latency; pipeline throughput is
its reciprocal.  The extended metric additionally accounts for per-stage
compute time (used when mapping placements onto TPU pods, where stage compute
can dominate the link): steady-state pipeline period = max over all stage
compute times and link latencies.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.graph import Partition
from repro_torch.core.placement import CommGraph


@dataclasses.dataclass(frozen=True)
class PipelineMetrics:
    bottleneck_latency: float  # s, max link latency (paper metric)
    pipeline_period: float  # s, max(link latency, stage compute) (extended)
    end_to_end_latency: float  # s, sum of stage compute + link latencies
    throughput: float  # 1 / bottleneck_latency (paper)
    effective_throughput: float  # 1 / pipeline_period (extended)


def link_latencies(
    boundaries: Sequence[float], path: Sequence[int], comm: CommGraph
) -> list[float]:
    out = []
    for i, w in enumerate(boundaries):
        b = comm.bw[path[i], path[i + 1]]
        out.append(float("inf") if b <= 0 else w / b)
    return out


def node_flops(flops_per_node, node: int | None) -> float:
    """Resolve a scalar-or-per-node flops model for one node (0 = unmodelled).

    The single dispatch point for ``flops_per_node``: ``service_times`` and
    the data plane's codec cost model both price compute through it."""
    if flops_per_node is None or node is None:
        return 0.0
    if np.isscalar(flops_per_node):
        return float(flops_per_node)
    return float(flops_per_node[node])


def service_times(
    partitions: Sequence[Partition],
    path: Sequence[int],
    bw: np.ndarray,
    *,
    flops_per_node: float | Sequence[float] | None = None,
    in_bytes: float = 0.0,
    out_bytes: float = 0.0,
    dispatcher: int | None = None,
    compression_ratio: float = 1.0,
    codecs: Sequence | None = None,
) -> tuple[list[float], list[float]]:
    """The single timing model shared by the discrete-event serving engine,
    the planner's prediction, and the TPU pipeline planner.

    Returns ``(compute_s, link_s)``:

      * ``compute_s[i]`` -- stage i's service time, ``partition.flops /
        flops_per_node[path[i]]`` (0 when flops are unmodelled),
      * ``link_s`` -- one entry per *hop*, ``len(path) + 1`` long:
        ``link_s[0]`` is the dispatcher -> first-stage input transfer,
        ``link_s[h]`` (1 <= h <= k-1) is the stage h-1 -> stage h boundary,
        ``link_s[k]`` is the last-stage -> dispatcher output transfer.
        Colocated endpoints (or zero bytes, or no dispatcher) cost 0.

    ``codecs`` (one ``repro_torch.dataplane.Codec`` or registered name per hop)
    puts a transfer codec on each link: the hop's serial window is then
    charged ``codec_encode (sender flops) + wire_bytes / bandwidth +
    codec_decode (receiver flops)`` -- compressed bytes ride the wire, and
    the codec's compute rides the link window it serializes.  ``None``
    keeps every hop raw.  The legacy ``compression_ratio`` divides bytes
    *before* the codec sees them (the knobs compose; both default off).

    The pipeline's steady-state period is ``max(compute_s + link_s)`` --
    every stage and every link is a serial resource, so the bottleneck one
    sets the cadence once the pipe is full.
    """
    if codecs is not None:
        from repro_torch.dataplane import resolve_codecs

        codecs = resolve_codecs(codecs)
        if len(codecs) != len(path) + 1:
            raise ValueError(
                f"expected {len(path) + 1} hop codecs, got {len(codecs)}")

    def flops_at(node: int | None) -> float:
        return node_flops(flops_per_node, node)

    def hop(a: int | None, b: int | None, bytes_: float, h: int) -> float:
        if bytes_ <= 0 or a is None or b is None or a == b:
            return 0.0
        rate = float(bw[a, b])
        raw = bytes_ / compression_ratio
        if codecs is None:
            return float("inf") if rate <= 0 else raw / rate
        from repro_torch.dataplane import link_charge_s

        return link_charge_s(
            codecs[h], raw, rate,
            src_flops=flops_at(a), dst_flops=flops_at(b),
        )

    compute = []
    for part, node in zip(partitions, path):
        f = flops_at(node)
        compute.append(part.flops / f if f > 0 else 0.0)
    links = [hop(dispatcher, path[0] if path else None, in_bytes, 0)]
    for i in range(len(path) - 1):
        links.append(
            hop(path[i], path[i + 1], float(partitions[i].out_bytes), i + 1))
    links.append(hop(path[-1] if path else None, dispatcher, out_bytes, len(path)))
    return compute, links


def evaluate_pipeline(
    partitions: Sequence[Partition],
    path: Sequence[int],
    comm: CommGraph,
    device_flops: float | Sequence[float] | None = None,
    in_bytes: float = 0.0,
    out_bytes: float = 0.0,
    dispatcher: int | None = None,
    compression_ratio: float = 1.0,
    codecs: Sequence | None = None,
) -> PipelineMetrics:
    """Score a (partition, placement) pair.

    ``compression_ratio`` models boundary compression (paper: ZFP/LZ4; ours:
    blockwise int8): transferred bytes are divided by it.  ``codecs`` (one
    per hop, see ``service_times``) charges each link with its transfer
    codec's ``encode + compressed transfer + decode`` window.  ``in_bytes``
    / ``out_bytes`` charge the dispatcher round-trip hops when
    ``dispatcher`` is given (colocation costs nothing).
    """
    if len(path) != len(partitions):
        raise ValueError("path length != number of partitions")
    compute, hops = service_times(
        partitions, path, comm.bw,
        flops_per_node=device_flops,
        in_bytes=in_bytes if dispatcher is not None else 0.0,
        out_bytes=out_bytes if dispatcher is not None else 0.0,
        dispatcher=dispatcher,
        compression_ratio=compression_ratio,
        codecs=codecs,
    )
    lats = [h for h in hops if h > 0]
    bottleneck = max(lats, default=0.0)
    period = max([bottleneck] + compute)
    e2e = sum(compute) + sum(l for l in lats if np.isfinite(l))
    return PipelineMetrics(
        bottleneck_latency=float(bottleneck),
        pipeline_period=float(period),
        end_to_end_latency=float(e2e),
        throughput=0.0 if bottleneck == float("inf") else (float("inf") if bottleneck == 0 else 1.0 / bottleneck),
        effective_throughput=0.0 if period == float("inf") else (float("inf") if period == 0 else 1.0 / period),
    )
