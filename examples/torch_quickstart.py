"""Quickstart (PyTorch port): declare a deployment spec, compile it into a plan.

``examples/quickstart.py`` over ``repro_torch``: the declarative API in one
screen.  Describe the model, the cluster, and the strategies by NAME
(``repro_torch.api.list_strategies`` shows what's registered), then let the
``Planner`` run SEIFER's two steps -- min-bottleneck partitioning (Sec.
2.2-1b) and bandwidth-aware placement (Sec. 2.2-1c) -- and score the result.
No cluster machinery and no tensor: the spec names the CPU, since a plan
needs no card.  For serving + churn see ``examples/torch_edge_serving_failover.py``.

    PYTHONPATH=src python examples/torch_quickstart.py

It prints the same lines as ``examples/quickstart.py``.
"""

from repro_torch.api import (
    ClusterSpec,
    DeploymentSpec,
    Planner,
    default_strategy,
    list_strategies,
)
from repro_torch.core import evaluate_pipeline
from repro_torch.core.model_zoo import resnet50

# 0. every algorithm is a named, registered strategy (default marked *)
print("registered strategies:")
for kind in ("partitioner", "placer", "joint"):
    names = [n + "*" if n == default_strategy(kind) else n
             for n in list_strategies(kind)]
    print(f"  {kind}: {', '.join(names)}")

# 1. the spec: model + cluster + strategy names, declared up front
graph = resnet50()
capacity = graph.total_param_bytes / 3  # each node holds ~1/3 of the model
spec = DeploymentSpec(
    model="resnet50",  # zoo name; a LayerGraph works too
    cluster=ClusterSpec(n_nodes=8, capacity_bytes=capacity, seed=0),
    partitioner="min_bottleneck",  # SEIFER step 1 (Sec. 2.2-1b)
    placer="color_coding",         # SEIFER step 2 (Sec. 2.2-1c)
    device="cpu",  # planning only: no tensor is touched
)
print(f"model: {graph.name}, {len(graph)} layers, "
      f"{graph.total_param_bytes/1e6:.1f} MB int8 weights")

# 2. compile: validate the spec, partition, place, predict metrics
plan = Planner.from_spec(spec).compile(spec)
part, place = plan.partition, plan.placement
print(f"partitions: {part.n_parts}, cuts at {part.cuts}, "
      f"max boundary {part.max_cut_bytes/1e6:.2f} MB")
print(f"placement: nodes {place.path}, "
      f"bottleneck {place.bottleneck_latency*1e3:.2f} ms, "
      f"throughput {place.throughput:.1f} inf/s")

# 3. end-to-end metrics, with and without boundary compression (ZFP/LZ4
#    on the edge; blockwise int8 on the card -- see kernels/quantize)
comm, _ = spec.cluster.build()
for ratio in (1.0, 2.0):
    m = evaluate_pipeline(part.partitions, place.path, comm,
                          device_flops=5e9, compression_ratio=ratio)
    print(f"compression {ratio:.0f}x: period {m.pipeline_period*1e3:.2f} ms, "
          f"effective throughput {m.effective_throughput:.1f} inf/s")
