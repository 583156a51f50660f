"""``DeploymentSpec``: a frozen, validated description of one deployment.

A spec names *what* to deploy (a ``LayerGraph`` or a model-zoo name), *where*
(a ``ClusterSpec``: explicit ``CommGraph`` or a seeded random wireless
cluster), *how* (strategy names from the registry, compression, bandwidth
classes, the compute ``device``), and *how well* (optional SLOs).
``validate()`` returns structured ``SpecIssue``s explaining *why* a spec is
unusable -- an unknown strategy name, a single layer that exceeds node
capacity, a model that cannot fit the cluster, a field this port does not
serve yet -- instead of letting the failure surface deep in the solver.

The fields keep the JAX package's names and defaults.  Those whose serving
branch is not ported yet (``serving="sync"``, ``replicas``, ``arrival``,
``autoscale``, ``trace``) are rejected with a ``not_ported`` issue when set
to anything but their default.

``TenantSpec`` wraps a ``DeploymentSpec`` with a tenant's quota for
multi-tenant serving on one shared cluster (``deploy([...])``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.api.registry import UnknownStrategyError, get_strategy
from repro_torch.core.graph import LayerGraph
from repro_torch.core.placement import CommGraph


@dataclasses.dataclass(frozen=True)
class SpecIssue:
    """One structured reason a spec cannot be deployed."""

    code: str  # machine-readable: "unknown_strategy", "layer_exceeds_capacity", ...
    message: str  # human-readable explanation

    def __str__(self) -> str:
        return f"[{self.code}] {self.message}"


class InfeasibleSpecError(ValueError):
    """Spec validation failed; ``issues`` lists every reason found."""

    def __init__(self, issues: tuple[SpecIssue, ...]):
        self.issues = tuple(issues)
        super().__init__(
            "infeasible deployment spec:\n  " + "\n  ".join(str(i) for i in issues)
        )


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Where to deploy: an explicit ``CommGraph``, or a seeded random cluster.

    Exactly one description must be given:

      * ``comm`` -- a prebuilt communication graph (bandwidths + capacities);
      * ``n_nodes`` + ``capacity_bytes`` -- generate a wireless cluster with
        ``core.simulate.random_cluster`` (n compute nodes + dispatcher node 0,
        positions seeded by ``seed`` in an ``arena_m``-sized arena).
    """

    n_nodes: int | None = None
    capacity_bytes: float | None = None
    comm: CommGraph | None = None
    arena_m: float = 100.0
    seed: int = 0

    def validate(self) -> tuple[SpecIssue, ...]:
        issues = []
        any_random = self.n_nodes is not None or self.capacity_bytes is not None
        all_random = self.n_nodes is not None and self.capacity_bytes is not None
        if self.comm is not None and any_random:
            issues.append(SpecIssue(
                "ambiguous_cluster",
                "comm= and n_nodes=/capacity_bytes= both given; the random-"
                "cluster arguments would be silently ignored",
            ))
        elif self.comm is None and not all_random:
            issues.append(SpecIssue(
                "ambiguous_cluster",
                "give exactly one of comm= or (n_nodes= and capacity_bytes=)",
            ))
        if self.n_nodes is not None and self.n_nodes < 1:
            issues.append(SpecIssue("bad_cluster", "n_nodes must be >= 1"))
        if self.capacity_bytes is not None and self.capacity_bytes <= 0:
            issues.append(SpecIssue("bad_cluster", "capacity_bytes must be > 0"))
        return tuple(issues)

    def build(self):
        """Materialize ``(comm, positions)``; positions is None for explicit comm."""
        from repro_torch.core.simulate import random_cluster

        if self.comm is not None:
            return self.comm, None
        return random_cluster(
            self.n_nodes, self.capacity_bytes, self.arena_m, self.seed,
            with_positions=True,
        )


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One request latency class.

    ``priority`` orders continuous-batch admission (higher drains first);
    ``target_latency_s`` is the class's admit-to-complete target, reported
    as attainment in the latency metrics (``None`` = best-effort);
    ``weight`` is the class's share of generated trace traffic (kept for
    the JAX package's spec; open-loop traces are not ported yet).
    """

    name: str
    priority: int = 0
    target_latency_s: float | None = None
    weight: float = 1.0

    def validate(self) -> tuple[SpecIssue, ...]:
        issues = []
        if not self.name or not isinstance(self.name, str):
            issues.append(SpecIssue(
                "bad_slo_class", f"SLO class name must be a non-empty "
                                 f"string, got {self.name!r}"))
        if self.target_latency_s is not None and self.target_latency_s <= 0:
            issues.append(SpecIssue(
                "bad_slo_class",
                f"SLO class {self.name!r}: target_latency_s must be > 0, "
                f"got {self.target_latency_s!r}"))
        if self.weight <= 0:
            issues.append(SpecIssue(
                "bad_slo_class",
                f"SLO class {self.name!r}: weight must be > 0, "
                f"got {self.weight!r}"))
        return tuple(issues)


def _resolve_model(model, *, device="cuda") -> tuple[LayerGraph, Callable | None]:
    """model field -> (graph, executor_for_version | None).

    Accepts a ``LayerGraph``, a model-zoo name (``vgg16``, ``resnet50``,
    ``inceptionv3``, ``mobilenetv2``), or one of the executable demo models
    (``demo_mlp`` / ``demo_ssm`` / ``demo_transformer``, which also supply
    versioned executors on ``device``).
    """
    if isinstance(model, LayerGraph):
        return model, None
    if not isinstance(model, str):
        raise TypeError(f"model must be a LayerGraph or name, got {type(model)}")
    from repro_torch.core.model_zoo import PAPER_MODELS, demo_mlp, demo_ssm, demo_transformer

    if model in PAPER_MODELS:
        return PAPER_MODELS[model](), None
    if model in ("demo_mlp", "mlp"):
        return demo_mlp(device=device)
    if model in ("demo_transformer", "transformer"):
        return demo_transformer(device=device)
    if model in ("demo_ssm", "ssm"):
        return demo_ssm(device=device)
    raise KeyError(model)


# field -> default: the JAX package's serving branches this port does not
# serve yet; a spec setting any of them to another value is rejected
NOT_PORTED_FIELDS = {
    "serving": "pipelined",
    "replicas": 1,
    "arrival": None,
    "autoscale": None,
    "trace": None,
}


@dataclasses.dataclass(frozen=True)
class DeploymentSpec:
    """Everything ``deploy()`` needs, declared up front.

    Fields
    ------
    model:
        ``LayerGraph``, model-zoo name, or an executable demo model name
        (``"demo_mlp"``, ``"demo_ssm"``, ``"demo_transformer"``).
    cluster:
        ``ClusterSpec`` (or a raw ``CommGraph``, wrapped automatically).
    capacity:
        per-node memory cap handed to the partitioner; ``None`` uses the
        cluster's max node capacity.
    compression_ratio:
        boundary compression (paper: ZFP/LZ4; ours: int8 analogue).
    codec:
        inter-stage transfer codec, by registry name (``identity`` /
        ``fp16`` / ``int8`` / ``topk-sparse``; see
        ``repro_torch.dataplane.list_codecs``).  ``"auto"`` lets the planner
        pick the throughput-maximizing codec *per link* among those whose
        reported error bound fits ``accuracy_tolerance``; ``None`` is the
        registry default (``identity``).
    accuracy_tolerance:
        per-link SLO: every inter-stage transfer's codec must report a
        round-trip error bound (relative to ``max|x|``) at most this value.
    partitioner / placer:
        registry names; ``None`` means the registered default.
    joint:
        optional joint-optimizer name (``sequential`` / ``joint``); when set
        the planner runs it *instead of* the partitioner+placer pipeline.
    n_classes / seed:
        bandwidth-class count for quantization, and the planning seed.
    max_bottleneck_s / min_throughput:
        optional SLOs checked against the plan's predicted metrics.
    executor_for_version:
        version -> ExecutorFn for real serving; ``None`` falls back to the
        model's own executor (the demo models) or a pass-through executor
        (timing-only simulation).
    microbatch:
        admission batch size of the pipelined serving engine.
    queue_depth:
        bound on each stage's in-queue (backpressure).
    max_batch:
        continuous batching: coalesce up to this many queued requests into
        one microbatch per admission.  ``None`` keeps ``microbatch``.
    admission_depth:
        open-loop admission bound: a ``schedule``d arrival that finds this
        many requests queued is rejected (load shedding); ``None`` admits
        everything.
    slo_classes:
        request latency classes (``SLOClass``): batch-admission priority and
        per-class latency targets (reported as attainment).
    device:
        where the stage executors and codecs compute: ``"cuda"`` (default)
        runs the hand-written kernels, ``"cpu"`` their plain versions.
        It replaces the JAX package's ``use_pallas``/``interpret`` knob.
    serving / replicas / arrival / autoscale / trace:
        the JAX package's fields for branches not ported yet; only their
        defaults are accepted.
    """

    model: Any
    cluster: Any
    capacity: float | None = None
    compression_ratio: float = 1.0
    codec: str | None = None
    accuracy_tolerance: float | None = None
    partitioner: str | None = None
    placer: str | None = None
    joint: str | None = None
    n_classes: int | None = 4
    seed: int = 0
    max_bottleneck_s: float | None = None
    min_throughput: float | None = None
    executor_for_version: Callable | None = None
    microbatch: int = 4
    serving: str = "pipelined"
    queue_depth: int = 2
    replicas: int | str = 1
    max_batch: int | None = None
    admission_depth: int | None = None
    slo_classes: tuple[SLOClass, ...] | None = None
    arrival: Any = None
    autoscale: Any = None
    trace: Any = None
    device: str = "cuda"

    def __post_init__(self) -> None:
        if isinstance(self.cluster, CommGraph):
            object.__setattr__(self, "cluster", ClusterSpec(comm=self.cluster))
        if isinstance(self.slo_classes, (list, tuple)):
            object.__setattr__(self, "slo_classes", tuple(self.slo_classes))

    # -- SLO-class views ------------------------------------------------------
    def class_priority(self) -> dict[str, int]:
        return {c.name: c.priority for c in (self.slo_classes or ())}

    def class_targets(self) -> dict[str, float | None]:
        return {c.name: c.target_latency_s for c in (self.slo_classes or ())}

    # -- resolution ----------------------------------------------------------
    def resolve_model(self) -> tuple[LayerGraph, Callable | None]:
        return _resolve_model(self.model, device=self.device)

    def graph(self) -> LayerGraph:
        return self.resolve_model()[0]

    def strategy_names(self) -> dict[str, str | None]:
        from repro_torch.api.registry import default_strategy

        return {
            "partitioner": self.partitioner or default_strategy("partitioner"),
            "placer": self.placer or default_strategy("placer"),
            "joint": self.joint,
        }

    # -- validation ----------------------------------------------------------
    def _device_issues(self) -> tuple[SpecIssue, ...]:
        try:
            dev = torch.device(self.device)
        except (RuntimeError, TypeError) as e:
            return (SpecIssue("bad_device", str(e)),)
        if dev.type not in ("cpu", "cuda"):
            return (SpecIssue("bad_device",
                              f"device must be cpu or cuda, got {self.device!r}"),)
        if dev.type == "cuda" and not torch.cuda.is_available():
            return (SpecIssue(
                "bad_device",
                "device='cuda' but no CUDA device is available; pass "
                "device='cpu' to serve through the plain versions"),)
        return ()

    def validate(self) -> tuple[SpecIssue, ...]:
        """Every reason this spec cannot deploy; empty tuple when clean.

        Static checks only -- SLOs need a plan and are checked by the
        planner (``Plan.slo_issues``) after prediction.
        """
        issues: list[SpecIssue] = []

        for name, default in NOT_PORTED_FIELDS.items():
            value = getattr(self, name)
            if value != default:
                issues.append(SpecIssue(
                    "not_ported",
                    f"{name}={value!r}: that serving branch is not ported to "
                    f"the torch package yet (only {name}={default!r})",
                ))

        # strategy names exist in the registry
        for kind, name in (("partitioner", self.partitioner),
                           ("placer", self.placer),
                           ("joint", self.joint)):
            if name is None:
                continue
            try:
                get_strategy(kind, name)
            except UnknownStrategyError as e:
                issues.append(SpecIssue("unknown_strategy", str(e)))

        device_issues = self._device_issues()
        issues.extend(device_issues)

        # model resolves (an executable model needs a usable device)
        graph = None
        if not device_issues or isinstance(self.model, LayerGraph):
            try:
                graph, _ = self.resolve_model()
            except KeyError as e:
                from repro_torch.core.model_zoo import PAPER_MODELS

                known = ", ".join([*PAPER_MODELS, "demo_mlp", "demo_ssm",
                                   "demo_transformer"])
                issues.append(SpecIssue(
                    "unknown_model", f"model {e.args[0]!r} not in the zoo ({known})"
                ))
            except TypeError as e:
                issues.append(SpecIssue("bad_model", str(e)))

        # cluster description is well-formed
        if not isinstance(self.cluster, ClusterSpec):
            issues.append(SpecIssue(
                "bad_cluster", f"cluster must be ClusterSpec/CommGraph, "
                               f"got {type(self.cluster).__name__}"
            ))
            cluster_ok = False
        else:
            cluster_issues = self.cluster.validate()
            issues.extend(cluster_issues)
            cluster_ok = not cluster_issues

        if self.compression_ratio <= 0:
            issues.append(SpecIssue("bad_compression",
                                    "compression_ratio must be > 0"))

        # transfer codec + per-link accuracy tolerance
        from repro_torch.dataplane import AUTO, UnknownCodecError, get_codec

        named_codec = None
        if self.codec is not None and self.codec != AUTO:
            try:
                named_codec = get_codec(self.codec)
            except UnknownCodecError as e:
                issues.append(SpecIssue("unknown_codec", str(e)))
        if self.accuracy_tolerance is not None:
            if self.accuracy_tolerance < 0:
                issues.append(SpecIssue(
                    "bad_tolerance",
                    f"accuracy_tolerance must be >= 0, "
                    f"got {self.accuracy_tolerance!r}",
                ))
            elif (named_codec is not None
                  and named_codec.error_bound > self.accuracy_tolerance):
                issues.append(SpecIssue(
                    "codec_exceeds_tolerance",
                    f"codec {self.codec!r} reports a per-link error bound of "
                    f"{named_codec.error_bound:.3g} but accuracy_tolerance is "
                    f"{self.accuracy_tolerance:.3g}; raise the tolerance or "
                    f"use codec='auto' to let the planner pick within it",
                ))

        if self.queue_depth < 1:
            issues.append(SpecIssue("bad_serving", "queue_depth must be >= 1"))
        if self.max_batch is not None and (
            not isinstance(self.max_batch, int)
            or isinstance(self.max_batch, bool) or self.max_batch < 1
        ):
            issues.append(SpecIssue(
                "bad_batching",
                f"max_batch must be an int >= 1 or None, got {self.max_batch!r}",
            ))
        if self.admission_depth is not None and (
            not isinstance(self.admission_depth, int)
            or isinstance(self.admission_depth, bool)
            or self.admission_depth < 1
        ):
            issues.append(SpecIssue(
                "bad_batching",
                f"admission_depth must be an int >= 1 or None, "
                f"got {self.admission_depth!r}",
            ))
        if self.slo_classes is not None:
            seen = set()
            for c in self.slo_classes:
                if not isinstance(c, SLOClass):
                    issues.append(SpecIssue(
                        "bad_slo_class",
                        f"slo_classes entries must be SLOClass, "
                        f"got {type(c).__name__}",
                    ))
                    continue
                issues.extend(c.validate())
                if c.name in seen:
                    issues.append(SpecIssue(
                        "bad_slo_class", f"duplicate SLO class {c.name!r}"))
                seen.add(c.name)

        # capacity feasibility: report WHY, naming the offending layer
        if graph is not None and cluster_ok:
            comm, _ = self.cluster.build()
            cap = self.capacity
            if cap is None:
                cap = float(max(comm.node_capacity, default=0.0))
            worst = max(graph.layers, key=lambda l: l.param_bytes)
            if worst.param_bytes > cap:
                issues.append(SpecIssue(
                    "layer_exceeds_capacity",
                    f"layer {worst.name!r} needs {worst.param_bytes} B but the "
                    f"per-node capacity is {cap:.0f} B -- no contiguous "
                    f"partition can host it; raise capacity or split the layer",
                ))
            hostable = sum(c for c in comm.node_capacity if c > 0)
            if graph.total_param_bytes > hostable:
                issues.append(SpecIssue(
                    "model_exceeds_cluster",
                    f"model needs {graph.total_param_bytes} B but the cluster's "
                    f"hosting nodes hold {hostable:.0f} B total -- add nodes or "
                    f"raise per-node capacity",
                ))

        return tuple(issues)

    def check(self) -> "DeploymentSpec":
        """Raise ``InfeasibleSpecError`` with every issue found; else self."""
        issues = self.validate()
        if issues:
            raise InfeasibleSpecError(issues)
        return self


# ---------------------------------------------------------------------------
# Multi-tenant serving: one shared cluster, many deployments
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant of a shared cluster: a ``DeploymentSpec`` plus its quota.

    ``capacity_fraction`` is the tenant's share of the cluster's hosting
    nodes (0 < f <= 1); ``None`` splits whatever the explicit fractions
    leave over equally among the unspecified tenants.  ``weight`` orders
    the router's weighted-fair service across tenants.  ``admission_depth``
    is the tenant's open-loop admission quota (overrides the wrapped
    spec's own ``admission_depth``; ``None`` falls back to it).
    """

    name: str
    spec: DeploymentSpec
    capacity_fraction: float | None = None
    weight: float = 1.0
    admission_depth: int | None = None

    def quota(self) -> int | None:
        """The effective admission bound: tenant override, else the spec's."""
        if self.admission_depth is not None:
            return self.admission_depth
        return self.spec.admission_depth

    def validate(self) -> tuple[SpecIssue, ...]:
        issues = []
        if not self.name or not isinstance(self.name, str):
            issues.append(SpecIssue(
                "bad_tenant",
                f"tenant name must be a non-empty string, got {self.name!r}"))
        if not isinstance(self.spec, DeploymentSpec):
            issues.append(SpecIssue(
                "bad_tenant",
                f"tenant {self.name!r}: spec must be a DeploymentSpec, "
                f"got {type(self.spec).__name__}"))
        if self.capacity_fraction is not None and not (
            0.0 < self.capacity_fraction <= 1.0
        ):
            issues.append(SpecIssue(
                "bad_quota",
                f"tenant {self.name!r}: capacity_fraction must be in (0, 1], "
                f"got {self.capacity_fraction!r}"))
        if self.weight <= 0:
            issues.append(SpecIssue(
                "bad_quota",
                f"tenant {self.name!r}: weight must be > 0, "
                f"got {self.weight!r}"))
        if self.admission_depth is not None and (
            not isinstance(self.admission_depth, int)
            or isinstance(self.admission_depth, bool)
            or self.admission_depth < 1
        ):
            issues.append(SpecIssue(
                "bad_quota",
                f"tenant {self.name!r}: admission_depth must be an int >= 1 "
                f"or None, got {self.admission_depth!r}"))
        return tuple(issues)


def as_tenants(specs) -> tuple[TenantSpec, ...]:
    """Normalize a tenant list: bare ``DeploymentSpec``s become equal-share
    tenants named ``tenant0``, ``tenant1``, ... in list order."""
    tenants = []
    for i, s in enumerate(specs):
        if isinstance(s, TenantSpec):
            tenants.append(s)
        elif isinstance(s, DeploymentSpec):
            tenants.append(TenantSpec(name=f"tenant{i}", spec=s))
        else:
            raise TypeError(
                f"tenant entries must be TenantSpec or DeploymentSpec, "
                f"got {type(s).__name__}")
    return tuple(tenants)


def _same_cluster(a, b) -> bool:
    """Two ClusterSpecs describe one physical cluster (ndarray-safe)."""
    if a is b:
        return True
    if not (isinstance(a, ClusterSpec) and isinstance(b, ClusterSpec)):
        return False
    if a.comm is not None or b.comm is not None:
        return a.comm is b.comm
    return (a.n_nodes, a.capacity_bytes, a.arena_m, a.seed) == (
        b.n_nodes, b.capacity_bytes, b.arena_m, b.seed)


def validate_tenants(tenants: tuple[TenantSpec, ...]) -> tuple[SpecIssue, ...]:
    """Cross-tenant checks for one shared cluster; per-tenant issues are
    prefixed with the tenant name so one report covers the whole fleet."""
    issues: list[SpecIssue] = []
    if not tenants:
        return (SpecIssue("bad_tenant", "tenant list is empty"),)
    seen: set[str] = set()
    for t in tenants:
        issues.extend(t.validate())
        if t.name in seen:
            issues.append(SpecIssue(
                "duplicate_tenant", f"duplicate tenant name {t.name!r}"))
        seen.add(t.name)
        if isinstance(t.spec, DeploymentSpec):
            issues.extend(SpecIssue(i.code, f"tenant {t.name!r}: {i.message}")
                          for i in t.spec.validate())
    given = [t.capacity_fraction for t in tenants
             if t.capacity_fraction is not None]
    if sum(given) > 1.0 + 1e-9:
        issues.append(SpecIssue(
            "quota_exceeded",
            f"tenant capacity fractions sum to {sum(given):.3f} > 1 -- the "
            f"cluster cannot honor every quota"))
    first = tenants[0].spec
    for t in tenants[1:]:
        if (isinstance(t.spec, DeploymentSpec)
                and isinstance(first, DeploymentSpec)
                and not _same_cluster(first.cluster, t.spec.cluster)):
            issues.append(SpecIssue(
                "tenant_cluster_mismatch",
                f"tenant {t.name!r} declares a different cluster than "
                f"{tenants[0].name!r}; multi-tenant deployments share one "
                f"EdgeCluster"))
    return tuple(issues)
