"""Open-loop traces, the port (``repro_torch.workload``) against the JAX
package (``repro.workload``): both are the same numpy code, so every
generated arrival, every scheduled completion time on the virtual clock and
every refusal must be *equal*, not close.

Fixtures follow ``tests/test_workload_properties.py``: an 8-layer
``LayerGraph`` on an explicit 8-node ``CommGraph`` with pass-through
executors, so the served payload is the trace's own default (the arrival
index, an ``int``) or a small tensor.
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jax_api
import repro.cluster as jax_cluster
import repro.core.graph as jax_graph
import repro.core.placement as jax_placement
import repro.workload as jax_workload
import repro_torch.api as api
import repro_torch.cluster as cluster
import repro_torch.core.graph as graph_mod
import repro_torch.core.placement as placement
import repro_torch.workload as workload

N_HOSTING = 8
CAPACITY = 1.05e6  # 2 layers a node -> 4-stage pipelines, 2 feasible replicas


def _side(api_mod, cluster_mod, graph, place, wl, ones, **spec_kw):
    return SimpleNamespace(api=api_mod, NodeFailed=cluster_mod.NodeFailed,
                           Layer=graph.Layer, LayerGraph=graph.LayerGraph,
                           CommGraph=place.CommGraph, workload=wl, ones=ones,
                           spec_kw=spec_kw)


JAX = _side(jax_api, jax_cluster, jax_graph, jax_placement, jax_workload, jnp.ones)
PORT = _side(api, cluster, graph_mod, placement, workload, torch.ones, device="cpu")
SIDES = (PORT, JAX)


def _spec(side, **kw):
    layers = tuple(side.Layer(f"l{i}", param_bytes=500_000, out_bytes=100_000,
                              flops=5_000_000) for i in range(8))
    bw = np.full((N_HOSTING + 1, N_HOSTING + 1), 20e6)
    np.fill_diagonal(bw, 0.0)
    cap = np.full(N_HOSTING + 1, CAPACITY)
    cap[0] = -1.0
    return side.api.DeploymentSpec(
        model=side.LayerGraph("synth8", layers, in_bytes=50_000),
        cluster=side.api.ClusterSpec(comm=side.CommGraph(bw=bw, node_capacity=cap)),
        capacity=CAPACITY, microbatch=1, **side.spec_kw, **kw)


def _drive(side, dep, kill=None, kill_after=0):
    """``test_workload_properties._drive``: serve everything, killing node
    ``kill`` once ``kill_after`` requests have completed."""
    killed = kill is None
    while dep.loop.backlog or dep.loop.pending_arrivals or dep.pending:
        if not killed and len(dep.loop.completed) >= kill_after:
            dep.inject(side.NodeFailed(kill))
            killed = True
        progressed = bool(dep.step()) or dep.pending
        if not (progressed or dep.loop.pending_arrivals or dep.loop.backlog):
            break


def _completions(dep):
    return [(r.req_id, r.submitted_s, r.completed_s, r.replica, r.attempts)
            for r in dep.loop.completed]


@pytest.mark.parametrize("name", jax_workload.list_traces())
@pytest.mark.parametrize("seed,rate", [(0, 50.0), (7, 120.0), (1234, 400.0)])
def test_generators_give_the_same_arrivals(name, seed, rate):
    assert workload.list_traces() == jax_workload.list_traces()
    classes = {"gold": 1.0, "std": 3.0}
    got = workload.make_trace(name, rate=rate, duration_s=1.5, seed=seed, classes=classes)
    want = jax_workload.make_trace(name, rate=rate, duration_s=1.5, seed=seed,
                                   classes=classes)
    assert got.n > 0
    assert [(a.t_s, a.slo_class) for a in got.arrivals] == \
        [(a.t_s, a.slo_class) for a in want.arrivals]
    assert got.summary() == want.summary()


@pytest.mark.parametrize("trace", ["poisson", "bursty", "heavy-tailed"])
def test_submit_trace_gives_the_same_completion_times(trace):
    """Default payloads (the arrival index, an int the port stacks into a
    tensor) through the pipelined engine, with a node killed mid-trace."""
    runs = []
    for side in SIDES:
        dep = side.api.deploy(_spec(side, seed=3, max_batch=4, admission_depth=48,
                                    arrival=side.api.ArrivalSpec(
                                        trace=trace, rate=200.0, duration_s=1.0, seed=11)))
        reqs = dep.submit_trace()
        _drive(side, dep, kill=2, kill_after=25)
        runs.append((dep, reqs))
    (d, reqs), (jd, jreqs) = runs
    assert len(reqs) == len(jreqs) > 25
    assert _completions(d) == _completions(jd)
    assert [r.req_id for r in d.loop.rejected] == [r.req_id for r in jd.loop.rejected]
    for r, jr in zip(d.loop.completed, jd.loop.completed):
        assert isinstance(r.result, torch.Tensor) and r.result.dtype == torch.int64
        assert int(r.result) == int(jr.result) == r.req_id  # pass-through payload
    assert json.dumps(d.metrics()["serving"], sort_keys=True) == \
        json.dumps(jd.metrics()["serving"], sort_keys=True)


def test_replicated_autoscaled_trace_matches():
    """A tensor payload under a heavy-tailed trace, autoscaled replicas."""
    runs = []
    for side in SIDES:
        dep = side.api.deploy(_spec(
            side, seed=3, max_batch=4, admission_depth=48,
            arrival=side.api.ArrivalSpec(trace="heavy-tailed", rate=200.0,
                                         duration_s=1.0, seed=11),
            autoscale=side.api.AutoscaleSpec(min_replicas=1, backlog_high=6.0,
                                             backlog_low=1.0, cooldown_s=0.05)))
        dep.submit_trace(make_input=lambda i, a, side=side: side.ones((4,)) * i)
        _drive(side, dep, kill=2, kill_after=25)
        runs.append(dep)
    d, jd = runs
    assert _completions(d) == _completions(jd)
    assert [e.summary() for e in d.autoscaler.events] == \
        [e.summary() for e in jd.autoscaler.events]
    for r in d.loop.completed:
        assert torch.equal(r.result, torch.ones(4) * r.req_id)
    assert json.dumps(d.metrics()["serving"], sort_keys=True) == \
        json.dumps(jd.metrics()["serving"], sort_keys=True)


def test_unknown_trace_gives_the_same_issue():
    issues = []
    for side in SIDES:
        spec = _spec(side, arrival=side.api.ArrivalSpec(trace="poison"))
        issues.append([(i.code, i.message) for i in spec.validate()])
        with pytest.raises(side.workload.UnknownTraceError) as ei:
            side.workload.make_trace("poison", rate=1.0, duration_s=1.0)
        issues.append(str(ei.value))
    assert issues[0] == issues[2] and issues[1] == issues[3]
    assert [code for code, _ in issues[0]] == ["unknown_trace"]
    assert "poisson" in issues[0][0][1]


@pytest.mark.parametrize("kw", [dict(rate=0.0), dict(duration_s=-1.0)])
def test_bad_arrivals_give_the_same_issues(kw):
    got, want = ([(i.code, i.message) for i in
                  _spec(side, arrival=side.api.ArrivalSpec(**kw)).validate()]
                 for side in SIDES)
    assert got == want and [c for c, _ in got] == ["bad_arrival"]
