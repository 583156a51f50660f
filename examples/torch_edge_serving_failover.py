"""End-to-end SEIFER lifecycle through the ``deploy(spec)`` facade (PyTorch port).

``examples/edge_serving_failover.py`` over ``repro_torch``.  One
``DeploymentSpec`` bootstraps (elect -> probe -> partition/place -> deploy),
then the ``Deployment`` serves a request stream, absorbs a node failure
mid-stream (reconcile: re-place), an in-place model-version update, a
strategy swap on the LIVE deployment (``replan``), and a node join (full
cluster restart) -- every convergence step driven by typed events.  The
stages compute on ``--device`` (default cuda; raises without a card).

    PYTHONPATH=src python examples/torch_edge_serving_failover.py [--device cpu]

It prints the same lines as ``examples/edge_serving_failover.py``: every
number is the engine's virtual clock or the plan's, which do not depend on
the device.
"""

import argparse

import torch

from repro_torch.api import ClusterSpec, DeploymentSpec, deploy
from repro_torch.cluster import NodeFailed
from repro_torch.core.execution import resolve_device
from repro_torch.core.model_zoo import demo_mlp

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
device = resolve_device(ap.parse_args().device)

# --- the spec: an executable 8-layer tanh-MLP (weights keyed by model
# version, so a VersionBumped redeploy visibly changes the function) on a
# seeded random wireless cluster, int8 boundary compression ------------------
D = 32
graph, executor_for_version = demo_mlp(d=D, device=device)
spec = DeploymentSpec(
    model=graph,  # "demo_mlp" (zoo name) works too and brings its own executor
    executor_for_version=executor_for_version,
    cluster=ClusterSpec(
        n_nodes=8, capacity_bytes=graph.total_param_bytes / 3, seed=3,
    ),
    compression_ratio=2.0,  # int8 boundaries
    seed=0,
    microbatch=4,
    device=str(device),
)

# --- bootstrap: Sec 2.1 init + Sec 2.2 configuration, in one call ------------
d = deploy(spec)
obs = d.observed()
print(f"bootstrap: {len(obs.path)} partitions on nodes {list(obs.path)}, "
      f"bottleneck {obs.bottleneck_latency*1e3:.3f} ms")

# --- inference step (Sec 2.3): request stream through the admission queue ----
for _ in range(8):
    d.submit(torch.ones((D,), device=device) * 0.1)
d.drain()
y0 = d.loop.completed[0].result
print(f"served {len(d.loop.completed)} requests, clock {d.loop.clock_s*1e3:.3f} ms")

# --- node failure: the reconciler re-places partitions on healthy nodes ------
victim = d.control.pipeline.pods[1].node_id
d.inject(NodeFailed(victim))
actions = d.reconcile()
print(f"NodeFailed({victim}) -> {[(a.kind, a.detail) for a in actions]}")
d.submit(torch.ones((D,), device=device) * 0.1)
d.drain()
identical = bool(torch.allclose(y0, d.loop.completed[-1].result))
assert identical, "recovered pipeline must compute identically"
print(f"recovered: path {list(d.observed().path)}, outputs identical: {identical}")

# --- model-version update: watch container emits, reconciler redeploys -------
d.store.publish(1)  # the external model repository pushes v1
d.poll_model_updates()
actions = d.reconcile()
print(f"VersionBumped(1) -> {[(a.kind, a.detail) for a in actions]}")
assert d.control.generation == 0
print("generation still 0 (no cluster restart on a version bump)")

# --- strategy swap on the LIVE deployment: replan, no restart ----------------
plan = d.replan(placer="greedy")
obs = d.observed()
print(f"replan(placer='greedy') -> path {list(obs.path)}, "
      f"still v{obs.version}, generation {obs.generation}")
assert dict(plan.strategies)["placer"] == "greedy"

# --- node join: per the paper this is the one event needing a full restart ---
d.grow_cluster(seed=11)
actions = d.reconcile()
print(f"NodeJoined(new node {d.cluster.n - 1}) -> "
      f"{[(a.kind, a.detail) for a in actions]}")

obs = d.observed()
print(f"lifecycle complete: v{obs.version}, generation {obs.generation}, "
      f"{len(d.loop.failed)} lost requests")
