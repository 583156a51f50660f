"""Cluster + pod lifecycle simulation (the microK8s layer, in-process).

``EdgeCluster`` holds nodes and the true link bandwidths; ``Pod``s host one
partition each and forward intermediate activations to the next pod --
latency is simulated from bytes / bandwidth (the paper's FIFO+TCP transport)
with optional boundary int8 compression (the ZFP/LZ4 analogue); the stage
compute and the codecs' transforms run for real, on the pipeline's device.
Node failures mark pods dead; the dispatcher reschedules onto healthy nodes and
pods re-instantiate their partition from the artifact store, exactly the
SEIFER recovery path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch.core.graph import Partition
from repro_torch.core.placement import CommGraph


@dataclasses.dataclass
class Node:
    node_id: int
    capacity_bytes: float
    flops_per_s: float = 0.0
    healthy: bool = True


class EdgeCluster:
    """Nodes + symmetric link bandwidths; node 0 is the dispatcher host."""

    def __init__(self, comm: CommGraph, flops_per_s: float = 0.0):
        self.comm = comm
        self.nodes = [
            Node(i, comm.node_capacity[i], flops_per_s) for i in range(comm.n)
        ]
        # topology/health generation: bumped on every mutation, so planner
        # and dispatcher caches can key their sublattices on it
        self.generation = 0

    @property
    def n(self) -> int:
        return len(self.nodes)

    def healthy_ids(self) -> list[int]:
        return [n.node_id for n in self.nodes if n.healthy]

    def fail(self, node_id: int) -> None:
        self.nodes[node_id].healthy = False
        self.generation += 1

    def heal(self, node_id: int) -> None:
        self.nodes[node_id].healthy = True
        self.generation += 1

    def add_node(self, comm: CommGraph, flops_per_s: float | None = None) -> int:
        """Grow the cluster by one node; ``comm`` is the expanded graph.

        Existing nodes keep their ids and health state.  Returns the new
        node's id.  Per the paper, a node *addition* forces a full cluster
        restart -- that policy lives in the control plane, not here.
        """
        if comm.n != self.n + 1:
            raise ValueError(f"expected a {self.n + 1}-node comm graph, got {comm.n}")
        new_id = self.n
        # keep the existing block (incl. any degraded links); adopt only the
        # joining node's row/column and capacity from the expanded graph
        bw = comm.bw.copy()
        bw[:new_id, :new_id] = self.comm.bw
        cap = np.append(self.comm.node_capacity, comm.node_capacity[new_id])
        self.comm = CommGraph(bw=bw, node_capacity=cap)
        if flops_per_s is None:
            flops_per_s = self.nodes[-1].flops_per_s if self.nodes else 0.0
        self.nodes.append(Node(new_id, cap[new_id], flops_per_s))
        self.generation += 1
        return new_id

    def degrade_link(self, a: int, b: int, factor: float) -> None:
        """Scale the true bandwidth of link (a, b) by ``factor`` (symmetric)."""
        bw = self.comm.bw.copy()
        bw[a, b] *= factor
        bw[b, a] *= factor
        self.comm = CommGraph(bw=bw, node_capacity=self.comm.node_capacity.copy())
        self.generation += 1

    def degraded_comm(self) -> CommGraph:
        """CommGraph with failed nodes' capacity zeroed and links cut."""
        bw = self.comm.bw.copy()
        cap = self.comm.node_capacity.copy()
        for node in self.nodes:
            if not node.healthy:
                bw[node.node_id, :] = 0.0
                bw[:, node.node_id] = 0.0
                cap[node.node_id] = 0.0
        return CommGraph(bw=bw, node_capacity=cap)

    def true_bandwidth(self, a: int, b: int) -> float:
        return float(self.comm.bw[a, b])


@dataclasses.dataclass
class Pod:
    """One inference pod: runtime container + IO container, simulated."""

    pod_id: str
    node_id: int
    partition: Partition
    version: int
    restarts: int = 0
    alive: bool = True

    def restart_on(self, node_id: int) -> None:
        self.node_id = node_id
        self.restarts += 1
        self.alive = True


ExecutorFn = Callable[[int, int, Any], Any]  # (start_layer, stop_layer, x) -> y


@dataclasses.dataclass
class StepTrace:
    compute_s: list[float]
    link_s: list[float]

    @property
    def bottleneck_s(self) -> float:
        return max(self.link_s, default=0.0)

    @property
    def period_s(self) -> float:
        return max(self.compute_s + self.link_s, default=0.0)

    @property
    def e2e_s(self) -> float:
        return sum(self.compute_s) + sum(self.link_s)


class InferencePipeline:
    """Chain of pods executing a partitioned model over simulated links."""

    def __init__(
        self,
        cluster: EdgeCluster,
        pods: Sequence[Pod],
        executor: ExecutorFn,
        boundary_bytes: Sequence[float],
        compression_ratio: float = 1.0,
        link_codecs: Sequence[str] | None = None,
        device=None,
    ):
        self.cluster = cluster
        self.pods = list(pods)
        self.executor = executor
        self.boundary_bytes = list(boundary_bytes)
        self.compression_ratio = compression_ratio
        # transfer codec per hop (len k+1, service_times indexing); None =
        # all-identity (direct lifecycle construction, pre-dataplane tests)
        self.link_codecs = list(link_codecs) if link_codecs is not None else None
        # the deployment's device (None = unpinned): requests are stacked
        # onto it, and hop_codec() configures device-aware codecs with it
        self.device = device

    def hop_codec(self, h: int):
        """The ``repro_torch.dataplane.Codec`` riding hop ``h`` (None = raw).

        Device-aware codecs (those with a ``device`` attribute) are
        returned as ``configured()`` copies pinned to the pipeline's device,
        so they refuse an activation on any other device; the registry
        singletons stay untouched."""
        if self.link_codecs is None or not 0 <= h < len(self.link_codecs):
            return None
        from repro_torch.dataplane import get_codec

        codec = get_codec(self.link_codecs[h])
        if self.device is not None and hasattr(codec, "device"):
            codec = codec.configured(device=self.device)
        return codec

    def wire_bytes(self, boundary_idx: int) -> float:
        """On-wire bytes of partition boundary ``boundary_idx`` (hop
        ``boundary_idx + 1``) after compression_ratio and the hop codec."""
        raw = self.boundary_bytes[boundary_idx] / self.compression_ratio
        codec = self.hop_codec(boundary_idx + 1)
        return codec.wire_bytes(raw) if codec is not None else raw

    def path(self) -> list[int]:
        return [p.node_id for p in self.pods]

    def healthy(self) -> bool:
        return all(
            p.alive and self.cluster.nodes[p.node_id].healthy for p in self.pods
        )

    def run(self, x: Any) -> tuple[Any, StepTrace]:
        """One inference through the chain; raises if a pod is dead."""
        if not self.healthy():
            raise RuntimeError("pipeline degraded: dead pod or failed node")
        compute_s, link_s = [], []
        for idx, pod in enumerate(self.pods):
            x = self.executor(pod.partition.start, pod.partition.stop, x)
            node = self.cluster.nodes[pod.node_id]
            compute_s.append(
                pod.partition.flops / node.flops_per_s if node.flops_per_s else 0.0
            )
            if idx < len(self.pods) - 1:
                bw = self.cluster.true_bandwidth(
                    pod.node_id, self.pods[idx + 1].node_id
                )
                bytes_ = self.wire_bytes(idx)
                link_s.append(float("inf") if bw <= 0 else bytes_ / bw)
                codec = self.hop_codec(idx + 1)
                if codec is not None and pod.node_id != self.pods[idx + 1].node_id:
                    if codec.name in getattr(self.executor, "fused_codecs", ()):
                        # the receiving stage decodes inside its first op
                        # (fused dequant-matmul): hand over the wire payload
                        from repro_torch.dataplane.base import EncodedActivation

                        x = EncodedActivation(codec, codec.encode(x))
                    else:
                        # the receiver sees the decoded payload: lossy codecs
                        # really alter the activations crossing the wire
                        x = codec.transcode(x)
        return x, StepTrace(compute_s, link_s)

    def mark_node_failed(self, node_id: int) -> list[Pod]:
        """k8s node-down event: pods on the node become dead."""
        dead = []
        for p in self.pods:
            if p.node_id == node_id:
                p.alive = False
                dead.append(p)
        return dead
