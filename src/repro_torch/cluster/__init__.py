from repro_torch.cluster.autoscale import Autoscaler, ScaleEvent
from repro_torch.cluster.controlplane import (
    ControlPlane,
    DesiredState,
    ObservedState,
    ReconcileAction,
    ReplicaSet,
)
from repro_torch.cluster.dispatcher import Dispatcher
from repro_torch.cluster.events import (
    ClusterEvent,
    LinkDegraded,
    NodeFailed,
    NodeJoined,
    VersionBumped,
)
from repro_torch.cluster.engine import (
    Microbatch,
    PipelinedServingLoop,
    ReplicatedServingLoop,
    StageState,
)
from repro_torch.cluster.lifecycle import EdgeCluster, InferencePipeline, Node, Pod
from repro_torch.cluster.serving import (
    Request,
    ServingLoop,
    latency_report,
    latency_stats,
)
from repro_torch.cluster.store import ArtifactStore
from repro_torch.cluster.watch import ModelWatcher

__all__ = [
    "ArtifactStore",
    "Autoscaler",
    "ClusterEvent",
    "ControlPlane",
    "DesiredState",
    "Dispatcher",
    "EdgeCluster",
    "InferencePipeline",
    "LinkDegraded",
    "Microbatch",
    "ModelWatcher",
    "Node",
    "NodeFailed",
    "NodeJoined",
    "ObservedState",
    "PipelinedServingLoop",
    "Pod",
    "ReconcileAction",
    "ReplicaSet",
    "ReplicatedServingLoop",
    "Request",
    "ScaleEvent",
    "ServingLoop",
    "StageState",
    "VersionBumped",
    "latency_report",
    "latency_stats",
]
