"""GPipe pipeline over pods with SEIFER cuts + compressed boundaries.

The JAX package's ``runtime/pipeline.py`` in PyTorch:

  * **cuts** come from ``core.partitioner`` on the arch's exported
    LayerGraph (min-bottleneck contiguous cuts under per-stage memory),
  * **placement** of stages onto pods comes from ``core.placement`` on the
    pods' bandwidth table -- the heaviest boundary rides the fastest link,
  * **boundary transport** is point-to-point along the placement's route
    (the FIFO+TCP analogue), optionally int8-compressed
    (``kernels/quantize`` -- the ZFP/LZ4 analogue), halving the bytes.

GPipe schedule: ``n_micro + n_stages - 1`` ticks; stage s computes microbatch
``t - s`` at tick t.  Steady-state period = max(stage compute, link time) --
literally the paper's bottleneck-latency objective.

Plus the edge-cluster bridge, ``make_layer_executor``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.bottleneck import evaluate_pipeline
from repro_torch.core.graph import LayerGraph
from repro_torch.core.partitioner import partition_exact_k
from repro_torch.core.placement import CommGraph, place_optimal
from repro_torch.dataplane.base import EncodedActivation
from repro_torch.kernels.quantize.ops import dequantize_int8, quantize_int8
from repro_torch.models.common import tree_map


# ---------------------------------------------------------------------------
# Planning: SEIFER cuts + stage->pod placement
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    n_stages: int
    cuts: tuple[int, ...]  # layer-graph edges cut
    stage_order: tuple[int, ...]  # stage i runs on pod stage_order[i]
    bottleneck_bytes: float
    est_bottleneck_s: float
    # steady-state GPipe period under the serving engine's timing model
    # (max over stage compute and link times); 1/est_period_s is the
    # pipeline's predicted per-microbatch throughput once full
    est_period_s: float = 0.0


def plan_pipeline(
    graph: LayerGraph,
    n_stages: int,
    *,
    stage_capacity: float,
    pod_bw: np.ndarray | None = None,
    device_flops: float | Sequence[float] | None = None,
) -> PipelinePlan:
    """Cut the layer graph and place stages on the pod graph.

    ``pod_bw``: (n_stages, n_stages) inter-pod bandwidth (bytes/s).  Defaults
    to a uniform ring of 6.25e9 B/s.  Placement maximizes throughput by
    matching the heaviest boundaries to the fastest links (exact
    min-bottleneck path).

    ``device_flops`` (per-pod compute rate) feeds the same
    ``core.bottleneck.service_times`` model the edge serving engine uses, so
    ``est_period_s`` is comparable across the pipeline and edge backends.
    """
    part = partition_exact_k(graph, int(stage_capacity), n_stages)
    if not part.feasible:
        raise ValueError(
            f"model does not fit {n_stages} stages of {stage_capacity/1e9:.1f} GB"
        )
    if pod_bw is None:
        pod_bw = np.full((n_stages, n_stages), 6.25e9)
        np.fill_diagonal(pod_bw, 0.0)
    comm = CommGraph(bw=pod_bw, node_capacity=np.full(n_stages, stage_capacity))
    place = place_optimal(
        list(part.boundaries), [p.param_bytes for p in part.partitions], comm
    )
    if not place.feasible:
        raise ValueError("no feasible stage placement on the pod graph")
    # ONE steady-state definition: est_period_s IS
    # core.bottleneck.PipelineMetrics.pipeline_period on the same inputs --
    # max over every serial resource (stage compute times and link latencies)
    metrics = evaluate_pipeline(
        part.partitions, place.path, comm, device_flops=device_flops
    )
    return PipelinePlan(
        n_stages=n_stages,
        cuts=part.cuts,
        stage_order=place.path,
        bottleneck_bytes=float(max(part.boundaries, default=0)),
        est_bottleneck_s=float(place.bottleneck_latency),
        est_period_s=float(metrics.pipeline_period),
    )


# ---------------------------------------------------------------------------
# GPipe execution: every position in turn, or one rank a position
# ---------------------------------------------------------------------------

# the backend group mode runs over, and the device it sends tensors on
_BACKEND_DEVICE = {"gloo": "cpu", "nccl": "cuda"}


def _check_backend_device(group, device: torch.device) -> None:
    """Raise unless ``group``'s backend is one group mode runs over and
    sends tensors on ``device``: a send never copies a tensor to another
    device behind the caller's back."""
    backend = str(dist.get_backend(group))
    # "gloo", or per-device pairs such as "cpu:gloo,cuda:nccl"
    pairs = [part.split(":") if ":" in part else (_BACKEND_DEVICE.get(part), part)
             for part in backend.split(",")]
    kinds = {dev for dev, name in pairs if _BACKEND_DEVICE.get(name) == dev}
    if device.type not in kinds:
        raise ValueError(
            f"make_gpipe: group mode sends {sorted(kinds)} tensors over the {backend} group "
            f"(gloo on the CPU, nccl on CUDA), but x lies on {device}; move x and the params "
            f"there, or run in turn (group=None) (no boundary is copied across devices)")


def make_gpipe(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    n_stages: int,
    *,
    n_micro: int,
    compress: bool = False,
    quant_block: int = 256,
    stage_order: tuple[int, ...] | None = None,
    group: dist.ProcessGroup | None = None,
):
    """Build a pipelined forward: (stage_params, x (n_micro, mb, ...)) -> y.

    ``stage_params`` leaves have a leading ``n_stages`` dim in MESH order
    (use ``reorder_stage_params`` to realize a SEIFER placement); mesh
    position p runs ``stage_fn(leaf[p] of every leaf, x_mb)``, whose output
    has the microbatch's shape and dtype.  The output is (n_micro, mb, ...):
    the last LOGICAL stage's rows.

    ``stage_order[j]`` = mesh position hosting logical stage j; boundaries
    move from position ``stage_order[j]`` to ``stage_order[j + 1]``, so the
    heaviest boundary rides the link the placement chose.  With
    ``compress``, each boundary is int8-coded at ``quant_block``
    (``kernels.quantize``: the CUDA kernels on CUDA tensors, the plain
    versions on CPU tensors) and decoded to ``x.dtype`` on arrival.

    Two modes, the same arithmetic:

    * ``group=None``: this process runs every mesh position in turn on
      ``x``'s device (one card runs the whole pipeline so).
    * ``group``, a ``torch.distributed`` group of ``n_stages`` ranks: rank p
      runs mesh position p and exchanges boundaries point to point (the
      codes and the f32 scales as two tensors when compressed).  A rank
      passes either the whole stack or only its own position's params, with
      a leading dim of 1 (the block ``shard_map`` hands a device), so a
      model that fits no one device still runs; every rank passes the same
      ``x`` and returns the output.  Group mode runs over gloo on CPU
      tensors and over NCCL on CUDA tensors (one card a rank); any other
      pair raises before any send.  One collective over the group runs
      before the first tick: NCCL's first point-to-point batch on a group
      must involve every rank, and at tick 0 only the first stage sends.
      On NCCL a ``wait()`` orders the current stream after the transfer,
      not the host: the kernels that decode a received boundary run on
      that stream, and nothing here synchronizes the device.

    A (stage, tick) pair with no microbatch is skipped, not masked: its
    input would come from a pair that was itself idle one tick earlier.
    The JAX package's ``execution=`` knob is dropped: the tensors' device
    picks the kernel or the plain version.
    """
    order = list(stage_order) if stage_order is not None else list(range(n_stages))
    if sorted(order) != list(range(n_stages)):
        raise ValueError(f"stage_order {order} is not a permutation of {n_stages} positions")
    # logical stage index of each mesh position
    logical = [int(s) for s in np.argsort(np.asarray(order))]

    def active(stage: int, t: int) -> bool:
        return 0 <= t - stage < n_micro

    def encode(y):
        return quantize_int8(y, quant_block) if compress else (y,)

    def decode(wire, dtype):
        return dequantize_int8(*wire, dtype, block=quant_block) if compress else wire[0]

    def in_turn(stage_params, x):
        local = [tree_map(lambda t, p=p: t[p], stage_params) for p in range(n_stages)]
        bufs: dict[int, torch.Tensor] = {}  # incoming activation of each position
        outs: list[torch.Tensor | None] = [None] * n_micro
        for t in range(n_micro + n_stages - 1):
            sent = {}
            for p in range(n_stages):
                s = logical[p]
                if not active(s, t):
                    continue
                y = stage_fn(local[p], x[t] if s == 0 else bufs.pop(p))
                if s == n_stages - 1:
                    outs[t - s] = y
                else:
                    sent[order[s + 1]] = encode(y)
            bufs = {dst: decode(wire, x.dtype) for dst, wire in sent.items()}
        return torch.stack(outs)

    def on_ranks(stage_params, x):
        if dist.get_world_size(group) != n_stages:
            raise ValueError(f"make_gpipe: the group has {dist.get_world_size(group)} ranks, "
                             f"the pipeline {n_stages} stages")
        _check_backend_device(group, x.device)
        p = dist.get_rank(group)
        s = logical[p]

        def own(t):
            if t.shape[0] not in (1, n_stages):
                raise ValueError(f"make_gpipe: a stage param's leading dim is {t.shape[0]}, "
                                 f"neither 1 (this rank's own) nor {n_stages} (the stack)")
            return t[0] if t.shape[0] == 1 else t[p]

        local = tree_map(own, stage_params)
        rank_of = lambda pos: dist.get_global_rank(group, pos)  # noqa: E731
        mb_shape = x.shape[1:]
        if compress:
            nb = -(-mb_shape[-1] // quant_block)
            wire_like = ((mb_shape, torch.int8), ((*mb_shape[:-1], nb), torch.float32))
        else:
            wire_like = ((mb_shape, x.dtype),)
        outs = torch.empty_like(x)
        buf = None
        dist.all_reduce(torch.zeros(1, device=x.device), group=group)  # every rank, once
        for t in range(n_micro + n_stages - 1):
            ops, recv = [], []
            if active(s, t):
                y = stage_fn(local, x[t] if s == 0 else buf)
                if s == n_stages - 1:
                    outs[t - s] = y
                else:
                    ops += [dist.P2POp(dist.isend, w.contiguous(), rank_of(order[s + 1]), group)
                            for w in encode(y)]
            if s > 0 and active(s, t + 1):  # the previous stage sends this tick
                recv = [torch.empty(shape, dtype=dtype, device=x.device)
                        for shape, dtype in wire_like]
                ops += [dist.P2POp(dist.irecv, w, rank_of(order[s - 1]), group) for w in recv]
            if ops:
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
            if recv:
                buf = decode(recv, x.dtype)
        dist.broadcast(outs, rank_of(order[-1]), group=group)
        return outs

    def run(stage_params, x):
        if x.shape[0] != n_micro:
            raise ValueError(f"x has {x.shape[0]} microbatches, the pipeline {n_micro}")
        if group is None:
            return in_turn(stage_params, x)
        return on_ranks(stage_params, x)

    return run


def reorder_stage_params(stage_params: Any, plan: PipelinePlan) -> Any:
    """Permute logically-ordered stage params into mesh order.

    Input leaves are stacked in LOGICAL stage order; mesh position p must
    hold logical stage argsort(stage_order)[p] so that, combined with the
    route in ``make_gpipe``, logical stage j physically runs on pod
    ``plan.stage_order[j]``.
    """
    inv = np.argsort(np.asarray(plan.stage_order))
    return tree_map(lambda t: t[torch.as_tensor(inv, device=t.device)], stage_params)


# ---------------------------------------------------------------------------
# Edge-cluster bridge: run the same stage execution through simulated pods
# ---------------------------------------------------------------------------

def make_layer_executor(layer_fns: list[Callable[[torch.Tensor], torch.Tensor]]):
    """Adapt per-layer callables into the cluster ``ExecutorFn`` signature.

    The edge control plane's ``InferencePipeline`` drives pods with
    ``executor(start, stop, x)`` over the partition's layer range.

    **Fused decode protocol.**  A layer fn may carry a ``fused`` attribute --
    a ``{codec_name: handler}`` dict whose handler consumes a still-encoded
    boundary activation (``dataplane.base.EncodedActivation``) directly,
    e.g. int8 wire payloads feeding ``kernels.quantize.dequant_matmul``
    instead of a separate dequantize pass.  The executor advertises
    ``executor.fused_codecs`` -- codec names EVERY layer can consume, so the
    engine's gating stays correct for any partition cut point -- and
    falls back to ``EncodedActivation.decode()`` when the entry layer has no
    handler.
    """
    fused_codecs: frozenset[str] | None = None
    for fn in layer_fns:
        keys = frozenset(getattr(fn, "fused", {}) or {})
        fused_codecs = keys if fused_codecs is None else fused_codecs & keys

    def executor(start: int, stop: int, x):
        if isinstance(x, EncodedActivation):
            handler = None
            if start < stop:
                handler = getattr(layer_fns[start], "fused", {}).get(x.codec.name)
            if handler is not None:
                x = handler(x)
                start += 1
            else:
                x = x.decode()
        for i in range(start, stop):
            x = layer_fns[i](x)
        return x

    executor.fused_codecs = fused_codecs or frozenset()
    return executor
