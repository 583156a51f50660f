"""Dispatcher: leader election, bandwidth probing, configure + deploy.

The SEIFER system-initialization and configuration steps (Sec. 2.1-2.2):

  1. leader election -- lowest-id healthy node wins (bully-style),
  2. IPerf jobs -- pairwise bandwidth probes, leader-directed; measurements
     are the true link bandwidth with multiplicative log-normal noise,
  3. partitioning + placement containers -- compiled by the ``Planner``
     (strategy names resolved through ``repro_torch.api.registry``) on the PROBED
     bandwidths; partition artifacts + the plan go to the store,
  4. deploy -- one pod per partition, wired in a chain,
  5. node-failure recovery -- re-place on the degraded graph (the planner's
     ``place``) and restart crashed pods from the store.

The dispatcher is pure *mechanism*: which algorithms run is the planner's
business, so swapping ``min_bottleneck``/``color_coding`` for any registered
strategy pair is a constructor argument, not a code edit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.api.planner import Plan, Planner
from repro_torch.cluster.lifecycle import EdgeCluster, InferencePipeline, Pod
from repro_torch.cluster.store import ArtifactStore
from repro_torch.core.graph import LayerGraph
from repro_torch.core.placement import CommGraph

# sentinel: n_classes=None legitimately means "unquantized", so "not given"
# needs its own marker to detect a planner/n_classes conflict
UNSET = object()


class Dispatcher:
    def __init__(
        self,
        cluster: EdgeCluster,
        store: ArtifactStore,
        *,
        planner: Planner | None = None,
        n_classes: int | None = UNSET,
        probe_noise: float = 0.05,
        seed: int = 0,
        allowed_nodes: set[int] | None = None,
        hosting_nodes: set[int] | None = None,
        device=None,
    ):
        self.cluster = cluster
        self.store = store
        # the deployment's device, threaded into every InferencePipeline
        # this dispatcher deploys (requests and codecs run there)
        self.device = device
        # replica-set masking: ``allowed_nodes`` bounds what this dispatcher
        # can see at all (its group + the shared dispatcher node); within
        # that, only ``hosting_nodes`` may host partitions.  ``None`` (the
        # default, single-pipeline mode) sees the whole cluster.
        self.allowed_nodes = allowed_nodes
        self.hosting_nodes = hosting_nodes
        if planner is not None:
            if n_classes is not UNSET:
                raise ValueError(
                    "pass n_classes via the Planner when supplying one "
                    "(planner.n_classes would silently win otherwise)"
                )
            self.planner = planner
        else:
            self.planner = Planner(
                n_classes=4 if n_classes is UNSET else n_classes
            )
        self.probe_noise = probe_noise
        self.rng = np.random.default_rng(seed)
        self.leader: int | None = None
        self.probed: CommGraph | None = None
        self.last_plan: Plan | None = None  # most recent feasible plan
        # cache keys: the cluster generation (+ mask fingerprint) the cached
        # probe / flops sublattices were computed at
        self._probe_key: tuple | None = None
        self._flops_key: int | None = None
        self._flops: list[float] | None = None
        # recovery bookkeeping: how the last replace_placement was solved
        # ({"scoped": bool, "scope_size": int, "fallback": str,
        # "affected_stages": [int, ...]}); None until the first recovery.
        # recovery_log accumulates every such record in order, so the full
        # recovery history is auditable (metrics surface it).
        self.last_recovery: dict | None = None
        self.recovery_log: list[dict] = []

    def node_flops(self) -> list[float]:
        """Per-node compute rates, indexed by node id (0 = unmodelled).

        Cached by cluster generation: one of ``service_times``'s inputs the
        planner re-reads on every (re-)plan."""
        gen = self.cluster.generation
        if self._flops is None or self._flops_key != gen:
            self._flops = [n.flops_per_s for n in self.cluster.nodes]
            self._flops_key = gen
        return self._flops

    # -- Sec 2.1: system initialization --------------------------------------
    def reset(self) -> None:
        """Forget leader + probed bandwidths (the paper's full cluster
        restart, required when a node is *added*)."""
        self.leader = None
        self.probed = None
        self._probe_key = None

    def visible_healthy_ids(self) -> list[int]:
        """Healthy nodes this dispatcher may see (its replica group, or the
        whole cluster in single-pipeline mode)."""
        healthy = self.cluster.healthy_ids()
        if self.allowed_nodes is None:
            return healthy
        return [i for i in healthy if i in self.allowed_nodes]

    def elect_leader(self) -> int:
        healthy = self.visible_healthy_ids()
        if not healthy:
            raise RuntimeError("no healthy nodes")
        self.leader = min(healthy)
        return self.leader

    def _mask_fingerprint(self) -> tuple:
        return (
            None if self.allowed_nodes is None else frozenset(self.allowed_nodes),
            None if self.hosting_nodes is None else frozenset(self.hosting_nodes),
        )

    def probe_bandwidths(self) -> CommGraph:
        """IPerf-analogue: noisy symmetric measurements of live links.

        Cached by (cluster generation, view mask): re-probing an unchanged
        cluster returns the stored measurement instead of re-drawing an
        O(n^2) noise matrix -- the recovery path re-probes on every
        re-solve, and at fleet scale the redraw dominated small re-plans.
        A topology or health mutation bumps ``EdgeCluster.generation`` and
        invalidates the entry."""
        key = (self.cluster.generation, self._mask_fingerprint())
        if self.probed is not None and self._probe_key == key:
            return self.probed
        true = self.cluster.degraded_comm()
        n = true.n
        noise = self.rng.lognormal(0.0, self.probe_noise, size=(n, n))
        noise = np.tril(noise) + np.tril(noise, -1).T  # symmetric
        bw = true.bw * noise
        cap = true.node_capacity
        if self.allowed_nodes is not None:
            bw = bw.copy()
            cap = cap.copy()
            for i in range(n):
                if i not in self.allowed_nodes:
                    bw[i, :] = 0.0
                    bw[:, i] = 0.0
                    cap[i] = 0.0
                elif self.hosting_nodes is not None and i not in self.hosting_nodes:
                    cap[i] = min(cap[i], 0.0)
        self.probed = CommGraph(bw=bw, node_capacity=cap)
        self._probe_key = key
        return self.probed

    # -- Sec 2.2: configuration step -----------------------------------------
    def configure(
        self,
        graph: LayerGraph,
        version: int,
        *,
        capacity: float | None = None,
        include_dispatcher: bool = True,
        compression_ratio: float = 1.0,
    ) -> Plan:
        if self.leader is None:
            self.elect_leader()
        comm = self.probed if self.probed is not None else self.probe_bandwidths()
        cap = capacity if capacity is not None else float(np.max(comm.node_capacity))
        plan = self.planner.plan(
            graph, comm,
            capacity=cap,
            version=version,
            max_parts=len(self.visible_healthy_ids()),
            seed=int(self.rng.integers(1 << 31)),
            include_dispatcher=include_dispatcher,
            dispatcher=self.leader if include_dispatcher else None,
            device_flops=self.node_flops(),
            compression_ratio=compression_ratio,
        )
        if plan.feasible:
            self.last_plan = plan
            self.store.put_json(version, "plan", plan.summary())
        return plan

    def deploy(
        self,
        plan: Plan,
        executor: Callable,
        *,
        compression_ratio: float = 1.0,
    ) -> InferencePipeline:
        if not plan.feasible:
            raise RuntimeError("cannot deploy infeasible plan")
        pods = [
            Pod(f"inf-{plan.version}-{i}", node, part, plan.version)
            for i, (node, part) in enumerate(zip(plan.placement.path, plan.partition.partitions))
        ]
        return InferencePipeline(
            self.cluster,
            pods,
            executor,
            boundary_bytes=list(plan.partition.boundaries),
            compression_ratio=compression_ratio,
            link_codecs=list(plan.codecs) if plan.codecs else None,
            device=self.device,
        )

    # -- fault tolerance -------------------------------------------------------
    def recover(
        self,
        pipeline: InferencePipeline,
        graph: LayerGraph,
        version: int,
        *,
        capacity: float | None = None,
    ) -> InferencePipeline:
        """Manual recovery entry point.

        Kept for direct use; the control plane drives the same mechanism via
        ``replace_placement`` in response to ``NodeFailed`` events.
        """
        return self.replace_placement(pipeline, graph, version, capacity=capacity)

    def scoped_comm(self, comm: CommGraph, scope_nodes) -> CommGraph:
        """``comm`` restricted to ``scope_nodes`` + the leader (links only):
        nodes outside the scope lose links and capacity, so a scoped
        recovery solve can only place within the neighborhood."""
        allowed = set(int(i) for i in scope_nodes)
        if self.leader is not None:
            allowed.add(self.leader)
        mask = np.zeros(comm.n, dtype=bool)
        mask[list(allowed)] = True
        bw = np.where(mask[:, None] & mask[None, :], comm.bw, 0.0)
        cap = np.where(mask, comm.node_capacity, 0.0)
        return CommGraph(bw=bw, node_capacity=cap)

    def replace_placement(
        self,
        pipeline: InferencePipeline,
        graph: LayerGraph,
        version: int,
        *,
        capacity: float | None = None,
        scope_nodes=None,
    ) -> InferencePipeline:
        """Re-place on the degraded cluster; restart dead pods from the store.

        The paper reschedules pods onto healthy nodes; partitions are reused
        (their files live on NFS), only the placement is re-solved through
        the planner's placer strategy.  With ``scope_nodes`` (the control
        plane's failure neighborhood) the solve is first attempted on the
        comm graph restricted to that neighborhood -- churn re-plans then
        touch only the affected slice -- and falls back to the full graph
        when the scoped solve is infeasible.  Falls back further to a full
        reconfigure when even the full graph cannot host the existing
        partitions.
        """
        if self.leader is not None and not self.cluster.nodes[self.leader].healthy:
            self.elect_leader()  # leader itself died -> re-elect
        self.probe_bandwidths()
        comm = self.probed
        part = pipeline_partition(pipeline)
        part_bytes = [p.param_bytes for p in part]
        place_kwargs = dict(
            # score the dispatcher round-trip like configure() does, so a
            # recovery placement doesn't strand the first/last partition
            # behind a dead-slow link to the leader
            in_bytes=graph.in_bytes,
            out_bytes=graph.layers[-1].out_bytes,
            dispatcher=self.leader,
        )
        # stages whose pod is dead or stranded on an unhealthy node -- the
        # serving engines requeue exactly these; recorded so recovery
        # records are comparable with the engine's requeue decisions
        affected = sorted(
            s for s, pod in enumerate(pipeline.pods)
            if not pod.alive or not self.cluster.nodes[pod.node_id].healthy
        )
        place = None
        self.last_recovery = {"scoped": False, "scope_size": 0,
                              "fallback": "none", "affected_stages": affected}
        if scope_nodes is not None:
            place = self.planner.place(
                pipeline.boundary_bytes, part_bytes,
                self.scoped_comm(comm, scope_nodes),
                seed=int(self.rng.integers(1 << 31)), **place_kwargs,
            )
            if place.feasible:
                self.last_recovery = {
                    "scoped": True, "scope_size": len(set(scope_nodes)),
                    "fallback": "none", "affected_stages": affected,
                }
            else:
                place = None
                self.last_recovery["fallback"] = "full"
        if place is None:
            place = self.planner.place(
                pipeline.boundary_bytes, part_bytes, comm,
                seed=int(self.rng.integers(1 << 31)), **place_kwargs,
            )
        if not place.feasible:
            self.last_recovery["fallback"] = "reconfigure"
            self.recovery_log.append(dict(self.last_recovery))
            # partitions no longer fit the surviving nodes: full reconfigure
            plan = self.configure(graph, version, capacity=capacity,
                                  compression_ratio=pipeline.compression_ratio)
            if not plan.feasible:
                raise RuntimeError("cluster too degraded to host the model")
            return self.deploy(plan, pipeline.executor,
                               compression_ratio=pipeline.compression_ratio)
        for pod, node in zip(pipeline.pods, place.path):
            if not pod.alive or not self.cluster.nodes[pod.node_id].healthy:
                pod.restart_on(node)
            else:
                pod.node_id = node
        # joint codec x placement: the links changed, so the codec-per-link
        # assignment is re-solved for the new path and follows the pipeline
        codecs = self.planner.assign_codecs(
            [graph.in_bytes, *pipeline.boundary_bytes,
             graph.layers[-1].out_bytes],
            place.path, comm.bw,
            dispatcher=self.leader, flops_per_node=self.node_flops(),
            compression_ratio=pipeline.compression_ratio,
        )
        pipeline.link_codecs = list(codecs)
        # the plan record must track what is actually deployed: same
        # partitions, new placement, metrics re-scored on the re-probed comm
        if self.last_plan is not None:
            from repro_torch.core.bottleneck import evaluate_pipeline

            metrics = evaluate_pipeline(
                part, place.path, comm,
                device_flops=self.node_flops(),
                in_bytes=graph.in_bytes,
                out_bytes=graph.layers[-1].out_bytes,
                dispatcher=self.leader,
                compression_ratio=pipeline.compression_ratio,
                codecs=codecs,
            )
            self.last_plan = dataclasses.replace(
                self.last_plan,
                placement=place,
                predicted_bottleneck_s=float(place.bottleneck_latency),
                predicted_throughput=float(metrics.effective_throughput),
                codecs=codecs,
            )
        self.recovery_log.append(dict(self.last_recovery))
        return pipeline


def pipeline_partition(pipeline: InferencePipeline) -> Sequence:
    return [p.partition for p in pipeline.pods]
