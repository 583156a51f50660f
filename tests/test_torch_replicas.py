"""Replica sets, the port (``device="cpu"``) against the JAX package.

The replica planner, the ``ReplicaSet`` control side, the cluster-wide
``ReplicatedServingLoop`` router and the ``Autoscaler`` are copies of the
same Python and numpy code, so their plans, groups, virtual clocks, routing
decisions, scale events, metrics and journal records must be *equal*.  Only
served tensors differ, by the frameworks' f32 arithmetic: demo_mlp with the
JAX package's weights and int8 hops is held to ``INT8_MAX_REL_ERROR`` of
max|ref| (a code can flip at a .5 tie between the two f32 sums).

Fixtures follow ``tests/test_replica_planner.py`` (random chains on random
wireless clusters) and ``tests/test_replica_router.py`` (a 6-layer
``LayerGraph`` at two layers a node, pass-through executors).
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
import repro.core.simulate as jax_simulate
import repro.workload as jax_workload
import repro_torch.api as api
import repro_torch.cluster as cluster
import repro_torch.core.graph as graph_mod
import repro_torch.core.simulate as simulate
import repro_torch.workload as workload
from _router_helpers import assert_router_conserved
from repro.core import model_zoo as jax_zoo
from repro_torch.cluster.serving import normalize_metrics
from repro_torch.core import model_zoo
from repro_torch.kernels.quantize import INT8_MAX_REL_ERROR
from test_torch_slice import jax_mlp_params


def _side(api_mod, cluster_mod, graph, sim, wl, ones, **spec_kw):
    return SimpleNamespace(
        api=api_mod, NodeFailed=cluster_mod.NodeFailed,
        LinkDegraded=cluster_mod.LinkDegraded, Layer=graph.Layer,
        LayerGraph=graph.LayerGraph, chain=graph.chain,
        random_cluster=sim.random_cluster, workload=wl, ones=ones, spec_kw=spec_kw)


JAX = _side(jax_api, jax_cluster, jax_graph, jax_simulate, jax_workload, jnp.ones)
PORT = _side(api, cluster, graph_mod, simulate, workload, torch.ones, device="cpu")
SIDES = (PORT, JAX)

PARAM = 1_000_000
CAPACITY = 2 * PARAM * 1.05  # 2 layers a node -> 3-stage pipelines


def _graph(side, flops=8_000_000):
    layers = tuple(side.Layer(f"l{i}", param_bytes=PARAM, out_bytes=120_000, flops=flops)
                   for i in range(6))
    return side.LayerGraph("router6", layers, in_bytes=60_000)


def _spec(side, n_nodes=12, seed=4, **kw):
    kw.setdefault("microbatch", 2)
    return side.api.DeploymentSpec(
        model=_graph(side), capacity=CAPACITY, seed=seed,
        cluster=side.api.ClusterSpec(n_nodes=n_nodes, capacity_bytes=CAPACITY, seed=seed),
        **side.spec_kw, **kw)


def _journal(dep):
    return [(r.seq, r.t_s, r.kind, r.source, json.dumps(r.detail, sort_keys=True))
            for r in dep.journal.records]


def _completions(dep):
    return [(r.req_id, r.replica, r.submitted_s, r.completed_s, r.attempts)
            for r in dep.loop.completed]


def _same_metrics(d, jd):
    m, jm = normalize_metrics(d.metrics()), normalize_metrics(jd.metrics())
    assert json.dumps(m, sort_keys=True) == json.dumps(jm, sort_keys=True)


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("replicas", [2, 3, "auto"])
@pytest.mark.parametrize("seed", [0, 17, 4242])
def test_plan_replicated_matches_jax(replicas, seed):
    """``test_replica_planner``'s fixtures: a random chain on a random
    wireless cluster, capacity a multiple of the largest layer."""
    rng = np.random.default_rng(seed)
    sizes = [(int(rng.integers(1, 50)), int(rng.integers(1, 1000)))
             for _ in range(int(rng.integers(2, 9)))]
    n_nodes = int(rng.integers(4, 11))
    cap = max(p for p, _ in sizes) * int(rng.integers(2, 6))
    plans = []
    for side in SIDES:
        comm = side.random_cluster(n_nodes, float(cap), seed=seed)
        plans.append(side.api.Planner().plan_replicated(
            side.chain("prop", sizes), comm, replicas=replicas, capacity=float(cap),
            seed=seed, dispatcher=0))
    got, want = plans
    assert got.summary() == want.summary()
    assert got.groups == want.groups
    assert [tuple(p.path) for p in got.replicas] == [tuple(p.path) for p in want.replicas]
    assert got.predicted_throughput == want.predicted_throughput
    assert got.feasible == want.feasible


@pytest.mark.parametrize("targets", [None, (4, 4, 4), (2, 5, 3)])
def test_split_cluster_matches_jax(targets):
    groups = [side.api.split_cluster(side.random_cluster(12, 1000.0, seed=9), 3,
                                     dispatcher=0, targets=targets) for side in SIDES]
    assert groups[0] == groups[1]


# ---------------------------------------------------------------------------
# The router under scripted churn
# ---------------------------------------------------------------------------

def _churn(side, dep, ids, log):
    """Serve 48 requests while the script below runs; ``log`` collects what
    each side saw at every step (conservation is walked at every step)."""
    rset = dep.replicaset
    for i in range(48):
        ids.append(dep.submit(side.ones((4,)) * i).req_id)
    script = {
        4: "link", 8: "retire", 14: "bump", 22: "grow",
    }
    step = 0
    while dep.loop.backlog or dep.pending:
        step += 1
        assert step < 5_000, "router did not drain"
        what = script.get(step)
        if what == "link":  # a link inside replica 1's group
            a, b = sorted(rset.groups[1])[:2]
            dep.inject(side.LinkDegraded(a, b, 0.4))
        elif what == "retire":  # two of replica 0's nodes: it can no longer host
            for node in sorted(rset.groups[0])[:2]:
                dep.inject(side.NodeFailed(node))
        elif what == "bump":
            dep.store.publish(1)
            assert dep.poll_model_updates()
        elif what == "grow":
            dep.grow_cluster(seed=5)
        done = dep.step()
        log.append(([r.req_id for r in done], dep.loop.clock_s, list(rset.retired),
                    dep.pending))
        assert_router_conserved(dep, ids)


def test_router_under_churn_matches_jax():
    runs = []
    for side in SIDES:
        dep = side.api.deploy(_spec(side, replicas=3))
        ids, log = [], []
        _churn(side, dep, ids, log)
        runs.append((dep, ids, log))
    (d, ids, log), (jd, jids, jlog) = runs
    rset = d.replicaset
    assert ids == jids and log == jlog
    assert rset.retired == [True, False, False], "replica 0 retired alone"
    assert sorted(len(g) for g in rset.groups) == [4, 4, 5]  # the joined node adopted
    assert "restart" in [a.kind for c in rset.controls for a in c.history]
    assert [c.desired.version for c, r in zip(rset.controls, rset.retired) if not r] \
        == [1, 1]
    assert _completions(d) == _completions(jd)
    assert len(d.loop.completed) + len(d.loop.failed) == 48
    assert {r.replica for r in d.loop.completed} == {0, 1, 2}
    assert d.loop.clock_s == jd.loop.clock_s
    assert d.loop.steady_state_throughput() == jd.loop.steady_state_throughput()
    assert [[a.kind for a in c.history] for c in rset.controls] == \
        [[a.kind for a in c.history] for c in jd.replicaset.controls]
    assert _journal(d) == _journal(jd)
    _same_metrics(d, jd)
    for r in d.loop.completed:  # pass-through: every payload comes back as sent
        assert torch.equal(r.result, torch.ones(4) * r.req_id)


def test_replan_matches_jax():
    deps = [side.api.deploy(_spec(side, replicas=2)) for side in SIDES]
    plans = [dep.replan(placer="greedy") for dep in deps]
    assert plans[0].summary() == plans[1].summary()
    single = [side.api.deploy(_spec(side)) for side in SIDES]
    plans = [dep.replan(partitioner="uniform") for dep in single]
    assert plans[0].summary() == plans[1].summary()
    assert [a.kind for a in single[0].control.history] == \
        [a.kind for a in single[1].control.history]


# ---------------------------------------------------------------------------
# The autoscaler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trace", ["bursty", "heavy-tailed"])
def test_autoscaler_scale_events_match_jax(trace):
    runs = []
    for side in SIDES:
        dep = side.api.deploy(_spec(
            side, microbatch=1, max_batch=4, admission_depth=64,
            arrival=side.api.ArrivalSpec(trace=trace, rate=150.0, duration_s=1.5, seed=2),
            autoscale=side.api.AutoscaleSpec(min_replicas=1, max_replicas=3,
                                             backlog_high=4.0, backlog_low=1.0,
                                             cooldown_s=0.05)))
        dep.submit_trace(make_input=lambda i, a, side=side: side.ones((4,)))
        dep.drain()
        runs.append(dep)
    d, jd = runs
    events = [e.summary() for e in d.autoscaler.events]
    assert events == [e.summary() for e in jd.autoscaler.events]
    assert any(e["action"] == "grow" for e in events)
    assert _completions(d) == _completions(jd)
    assert _journal(d) == _journal(jd)
    _same_metrics(d, jd)


def test_autoscale_and_replica_checks_match_jax():
    cases = [dict(replicas=0), dict(replicas=99), dict(replicas=2, serving="sync"),
             dict(autoscale=True, replicas=2), dict(autoscale=True, serving="sync"),
             dict(autoscale=dict(min_replicas=0)), dict(autoscale=dict(backlog_low=20.0)),
             dict(arrival=True, serving="sync")]
    for case in cases:
        got = []
        for side in SIDES:
            kw = dict(case)
            if isinstance(kw.get("autoscale"), dict):
                kw["autoscale"] = side.api.AutoscaleSpec(**kw["autoscale"])
            if kw.get("arrival") is True:
                kw["arrival"] = side.api.ArrivalSpec()
            got.append([(i.code, i.message) for i in _spec(side, **kw).validate()])
        assert got[0] == got[1] and got[0], case


# ---------------------------------------------------------------------------
# A real model: demo_mlp with int8 hops
# ---------------------------------------------------------------------------

def test_replicated_demo_mlp_matches_jax():
    deps = []
    for side in SIDES:
        if side is PORT:
            graph, ex = model_zoo.demo_mlp(device="cpu", params_for_version=jax_mlp_params)
        else:
            graph, ex = jax_zoo.demo_mlp()
        deps.append(side.api.deploy(side.api.DeploymentSpec(
            model=graph, executor_for_version=ex, codec="int8", seed=3, replicas=2,
            cluster=side.api.ClusterSpec(n_nodes=12, capacity_bytes=graph.total_param_bytes / 2.5,
                                         seed=5), **side.spec_kw)))
    d, jd = deps
    assert d.plan.summary() == jd.plan.summary()
    assert all("int8" in p.codecs for p in d.plan.replicas)
    xs = [np.full((32,), 0.1 * (i + 1), np.float32) for i in range(8)]
    for x in xs:
        d.submit(torch.from_numpy(x))
        jd.submit(jnp.asarray(x))
    got, want = d.drain(), jd.drain()
    assert [(r.req_id, r.replica) for r in got] == [(r.req_id, r.replica) for r in want]
    assert {r.replica for r in got} == {0, 1}
    for r, w in zip(got, want):
        assert isinstance(r.result, torch.Tensor) and r.result.device == torch.device("cpu")
        ref = np.asarray(w.result)
        np.testing.assert_allclose(r.result.numpy(), ref, rtol=0,
                                   atol=INT8_MAX_REL_ERROR * np.abs(ref).max())
    assert [o.path for o in d.observed_replicas()] == [o.path for o in jd.observed_replicas()]
