from repro_torch.cluster.controlplane import (
    ControlPlane,
    DesiredState,
    ObservedState,
    ReconcileAction,
)
from repro_torch.cluster.dispatcher import Dispatcher
from repro_torch.cluster.engine import Microbatch, PipelinedServingLoop, StageState
from repro_torch.cluster.events import (
    ClusterEvent,
    LinkDegraded,
    NodeFailed,
    NodeJoined,
    VersionBumped,
)
from repro_torch.cluster.lifecycle import EdgeCluster, InferencePipeline, Node, Pod
from repro_torch.cluster.serving import Request, latency_report, latency_stats
from repro_torch.cluster.store import ArtifactStore

__all__ = [
    "ArtifactStore",
    "ClusterEvent",
    "ControlPlane",
    "DesiredState",
    "Dispatcher",
    "EdgeCluster",
    "InferencePipeline",
    "LinkDegraded",
    "Microbatch",
    "Node",
    "NodeFailed",
    "NodeJoined",
    "ObservedState",
    "PipelinedServingLoop",
    "Pod",
    "ReconcileAction",
    "Request",
    "StageState",
    "VersionBumped",
    "latency_report",
    "latency_stats",
]
