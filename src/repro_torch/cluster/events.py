"""Typed cluster events consumed by the control plane's reconciler.

SEIFER Sec. 2.3 prescribes a different convergence action per disturbance
class, and the event types encode exactly that taxonomy:

  * ``NodeFailed``    -- pods on the node die; *re-place* the existing
    partitions onto the surviving nodes (partitions live on the store, only
    the placement is re-solved; full reconfigure only as fallback).
  * ``NodeJoined``    -- the paper requires a **full cluster restart** when a
    node is added: re-elect, re-probe, re-partition, re-place, re-deploy.
  * ``VersionBumped`` -- a new model version in the artifact store triggers
    an **in-place redeploy**: stop the inference pods and reconfigure on the
    already-probed bandwidths, no cluster restart.
  * ``LinkDegraded``  -- bandwidth loss on one link; re-place only if the
    link carries an active boundary and the bottleneck worsens past a
    tolerance (otherwise the current placement still maximizes throughput).

Events are plain frozen dataclasses so they can be queued, logged, and
asserted on in tests.  ``ControlPlane.submit`` enqueues; ``reconcile``
drains and converges.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.placement import CommGraph


@dataclasses.dataclass(frozen=True)
class ClusterEvent:
    """Base class; carries nothing, exists for isinstance dispatch."""


@dataclasses.dataclass(frozen=True)
class NodeFailed(ClusterEvent):
    node_id: int


@dataclasses.dataclass(frozen=True)
class NodeJoined(ClusterEvent):
    """A node joins the cluster.

    Either an existing failed node coming back (``node_id``) or a brand-new
    node with its link bandwidths (``comm``: the expanded (n+1)-node graph,
    e.g. from ``core.simulate.expand_cluster``).  Exactly one must be set.
    """

    node_id: int | None = None
    comm: CommGraph | None = None

    def __post_init__(self) -> None:
        if (self.node_id is None) == (self.comm is None):
            raise ValueError("NodeJoined needs exactly one of node_id / comm")


@dataclasses.dataclass(frozen=True)
class VersionBumped(ClusterEvent):
    version: int


@dataclasses.dataclass(frozen=True)
class LinkDegraded(ClusterEvent):
    a: int
    b: int
    factor: float  # multiplies the link bandwidth; 0 < factor <= 1 degrades

    def __post_init__(self) -> None:
        if self.factor < 0:
            raise ValueError("factor must be nonnegative")
