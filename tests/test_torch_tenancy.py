"""Multi-tenant serving, the port (``device="cpu"``) against the JAX package:
the same tenants on the same cluster must give identical carves, identical
per-tenant plans, identical event routing and reconcile actions, identical
quota shedding and the same weighted-fair completion order.

Fixtures follow ``tests/test_tenancy.py`` (LayerGraph tenants on an explicit
``CommGraph``, pass-through executors), plus one demo_mlp + demo_ssm pair
with the JAX package's weights, whose outputs are pinned at
``INT8_MAX_REL_ERROR`` of max|ref| (int8 hops; a code can flip at a .5 tie
between the frameworks' f32 sums, so the int8 bound is as tight as it gets).
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jax_api
import repro.api.planner as jax_planner
import repro.cluster as jax_cluster
import repro.core.graph as jax_graph
import repro.core.placement as jax_placement
import repro.tenancy as jax_tenancy
import repro_torch.api as api
import repro_torch.api.planner as planner
import repro_torch.cluster as cluster
import repro_torch.core.graph as graph_mod
import repro_torch.core.placement as placement
import repro_torch.tenancy as tenancy
from repro.api.spec import validate_tenants as jax_validate_tenants
from repro.core import model_zoo as jax_zoo
from repro_torch.api.spec import as_tenants, validate_tenants
from repro_torch.core import model_zoo
from repro_torch.kernels.quantize import INT8_MAX_REL_ERROR
from test_torch_slice import jax_mlp_params, jax_ssm_params

N_HOSTING = 12
CAPACITY = 1.05e6


def _side(api_mod, cluster_mod, graph, place, ten, **spec_kw):
    return SimpleNamespace(
        ClusterSpec=api_mod.ClusterSpec, DeploymentSpec=api_mod.DeploymentSpec,
        TenantSpec=api_mod.TenantSpec, deploy=api_mod.deploy,
        InfeasibleSpecError=api_mod.InfeasibleSpecError,
        NodeFailed=cluster_mod.NodeFailed, NodeJoined=cluster_mod.NodeJoined,
        LinkDegraded=cluster_mod.LinkDegraded, VersionBumped=cluster_mod.VersionBumped,
        Layer=graph.Layer, LayerGraph=graph.LayerGraph, CommGraph=place.CommGraph,
        TenantScheduler=ten.TenantScheduler, spec_kw=spec_kw)


JAX = _side(jax_api, jax_cluster, jax_graph, jax_placement, jax_tenancy)
PORT = _side(api, cluster, graph_mod, placement, tenancy, device="cpu")
SIDES = (PORT, JAX)


def _comm(side, n_hosting=N_HOSTING, cap=CAPACITY):
    bw = np.full((n_hosting + 1, n_hosting + 1), 20e6)
    np.fill_diagonal(bw, 0.0)
    caps = np.full(n_hosting + 1, cap)
    caps[0] = -1.0
    return side.CommGraph(bw=bw, node_capacity=caps)


def _graph(side, name, n_layers=8, param_bytes=500_000):
    layers = tuple(side.Layer(f"{name}{i}", param_bytes=param_bytes, out_bytes=100_000,
                              flops=5_000_000) for i in range(n_layers))
    return side.LayerGraph(name, layers, in_bytes=50_000)


def _spec(side, name, comm, **kw):
    kw.setdefault("microbatch", 1)
    kw.setdefault("capacity", CAPACITY)
    return side.DeploymentSpec(model=_graph(side, name), cluster=side.ClusterSpec(comm=comm),
                               **side.spec_kw, **kw)


def _tenants(side, quotas, comm=None):
    """quotas: [(name, TenantSpec kwargs)], one LayerGraph tenant each."""
    comm = comm if comm is not None else _comm(side)
    return [side.TenantSpec(name, _spec(side, name[0], comm), **kw) for name, kw in quotas]


TWO = [("alpha", {}), ("beta", {})]
QUOTAS = {
    "equal": TWO,
    "75-25": [("alpha", {"capacity_fraction": 0.75}), ("beta", {"capacity_fraction": 0.25})],
    "spares": [("alpha", {"capacity_fraction": 0.4}), ("beta", {"capacity_fraction": 0.4})],
    "three": [("alpha", {"capacity_fraction": 0.5}), ("beta", {}), ("gamma", {})],
}


def _both(quotas, **deploy_kw):
    return [side.deploy(_tenants(side, quotas), **deploy_kw) for side in SIDES]


def _same_plans(d, jd):
    assert d.plan.summary() == jd.plan.summary()
    assert d.names() == jd.names()
    for name in d.names():
        assert d.deployment(name).plan.summary() == jd.deployment(name).plan.summary()
        assert list(d.deployment(name).observed().path) == list(jd.deployment(name).observed().path)


def _kinds(actions):
    return {name: [a.kind for a in acts] for name, acts in actions.items()}


# ---------------------------------------------------------------------------
# the carve and the per-tenant plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["partition", "shared"])
@pytest.mark.parametrize("quotas", list(QUOTAS))
def test_carve_matches_jax(policy, quotas):
    plans = [side.TenantScheduler(policy=policy).carve(
        _comm(side), _tenants(side, QUOTAS[quotas])) for side in SIDES]
    assert plans[0].summary() == plans[1].summary()


@pytest.mark.parametrize("policy,quotas", [
    ("partition", "equal"), ("partition", "spares"), ("shared", "equal")])
def test_deployed_tenant_plans_match_jax(policy, quotas):
    d, jd = _both(QUOTAS[quotas], policy=policy)
    assert isinstance(d, tenancy.MultiTenantDeployment)
    _same_plans(d, jd)
    for name in d.names():  # each tenant planned strictly inside its slice
        assert set(d.deployment(name).observed().path) <= set(d.nodes_for(name))


@pytest.mark.parametrize("targets", [None, (3, 5), (2, 2)])
def test_split_cluster_and_subcluster_match_jax(targets):
    comms = []
    for side in SIDES:  # a bandwidth spread, so the greedy split has choices
        comm = _comm(side)
        comm.bw[:] = np.fromfunction(lambda i, j: 1e6 * (1 + (i * 7 + j * 3) % 11), comm.bw.shape)
        comm.bw[:] = np.minimum(comm.bw, comm.bw.T)
        np.fill_diagonal(comm.bw, 0.0)
        comms.append(comm)
    n = 2 if targets is None else len(targets)
    groups = planner.split_cluster(comms[0], n, dispatcher=0, targets=targets)
    assert groups == jax_planner.split_cluster(comms[1], n, dispatcher=0, targets=targets)
    view = planner.subcluster(comms[0], groups[0], keep=(0,))
    jview = jax_planner.subcluster(comms[1], groups[0], keep=(0,))
    np.testing.assert_array_equal(view.bw, jview.bw)
    np.testing.assert_array_equal(view.node_capacity, jview.node_capacity)


# ---------------------------------------------------------------------------
# tenant-scoped event routing
# ---------------------------------------------------------------------------

def _grow(side, d):
    n = d.cluster.n
    bw = np.full((n + 1, n + 1), 20e6)
    np.fill_diagonal(bw, 0.0)
    caps = np.append(np.asarray(d.cluster.comm.node_capacity), CAPACITY)
    return side.NodeJoined(comm=side.CommGraph(bw=bw, node_capacity=caps))


SCENARIOS = {
    "node_failed_owner": (TWO, lambda s, d: [(s.NodeFailed(
        d.deployment("alpha").control.pipeline.pods[0].node_id), None)]),
    "node_failed_spare": (QUOTAS["spares"], lambda s, d: [(s.NodeFailed(d.plan.spare[0]), None)]),
    "node_failed_dispatcher": (TWO, lambda s, d: [(s.NodeFailed(0), None)]),
    "link_degraded_cross_slice": (TWO, lambda s, d: [(s.LinkDegraded(
        d.nodes_for("alpha")[0], d.nodes_for("beta")[0], 0.5), None)]),
    "link_degraded_on_path": (TWO, lambda s, d: [(s.LinkDegraded(
        *d.deployment("beta").observed().path[:2], 0.01), None)]),
    "node_joined_grow": ([("alpha", {"weight": 1.0}), ("beta", {"weight": 3.0})],
                         lambda s, d: [(_grow(s, d), None)]),
    "node_failed_then_healed": (TWO, lambda s, d: [
        (s.NodeFailed(d.deployment("beta").control.pipeline.pods[0].node_id), None),
        (s.NodeJoined(node_id=d.deployment("beta").control.pipeline.pods[0].node_id), None)]),
    "version_bumped_scoped": (TWO, lambda s, d: [(s.VersionBumped(1), "alpha")]),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_event_routing_matches_jax(scenario):
    quotas, events = SCENARIOS[scenario]
    d, jd = _both(quotas)
    if scenario == "version_bumped_scoped":
        d.deployment("alpha").store.publish(1)
        jd.deployment("alpha").store.publish(1)
    for (ev, tenant), (jev, jtenant) in zip(events(PORT, d), events(JAX, jd)):
        d.inject(ev, tenant=tenant)
        jd.inject(jev, tenant=jtenant)
    assert _kinds(d.reconcile()) == _kinds(jd.reconcile())
    assert d.controlplane.routed == jd.controlplane.routed
    assert d.cluster.n == jd.cluster.n
    assert [n.healthy for n in d.cluster.nodes] == [n.healthy for n in jd.cluster.nodes]
    np.testing.assert_array_equal(d.cluster.comm.bw, jd.cluster.comm.bw)
    _same_plans(d, jd)
    assert [(r.kind, r.source) for r in d.journal.records] == [
        (r.kind, r.source) for r in jd.journal.records]
    for name in d.names():
        assert d.deployment(name).observed().version == jd.deployment(name).observed().version


def test_version_bump_requires_a_tenant_scope():
    d = PORT.deploy(_tenants(PORT, TWO))
    with pytest.raises(ValueError, match="tenant-scoped"):
        d.inject(PORT.VersionBumped(1))
    with pytest.raises(KeyError):
        d.inject(PORT.NodeFailed(1), tenant="nope")


# ---------------------------------------------------------------------------
# admission quotas and weighted-fair service
# ---------------------------------------------------------------------------

def _order(d):
    return [(r.tenant, r.req_id, r.completed_s) for r in d.completed()]


def test_quota_shedding_matches_jax():
    quotas = [("greedy", {"capacity_fraction": 0.5, "admission_depth": 2}),
              ("modest", {"capacity_fraction": 0.5})]
    d, jd = _both(quotas)
    for dep in (d, jd):
        for i in range(20):  # a same-instant burst: 2 fit the queue, 18 shed
            dep.schedule("greedy", i, 0.0)
            dep.schedule("modest", i, 0.0)
        dep.drain()
    for name in ("greedy", "modest"):
        m, jm = d.router.loop(name).metrics(), jd.router.loop(name).metrics()
        for key in ("rejected", "completed", "pending_arrivals"):
            assert m[key] == jm[key], (name, key)
        assert m["batching"]["admission_depth"] == jm["batching"]["admission_depth"]
    assert d.router.loop("greedy").metrics()["rejected"] == 18
    assert d.router.loop("modest").metrics()["rejected"] == 0
    assert _order(d) == _order(jd)


def test_staggered_arrivals_match_jax():
    """Open-loop arrivals spread in time: the clock jumps across idle gaps."""
    d, jd = _both([("alpha", {"admission_depth": 3}), ("beta", {})])
    for dep in (d, jd):
        for i in range(12):
            dep.schedule("alpha", i, 0.01 * (i // 4))
            dep.schedule("beta", i, 0.5 + 0.02 * i)
        dep.drain()
    assert _order(d) == _order(jd)
    for name in ("alpha", "beta"):
        assert (d.router.loop(name).metrics()["rejected"]
                == jd.router.loop(name).metrics()["rejected"])


def test_single_deployment_admission_matches_jax():
    """``admission_depth`` on one deployment: ``schedule`` sheds past it."""
    deps = [side.deploy(_spec(side, "a", _comm(side), admission_depth=3)) for side in SIDES]
    for dep in deps:
        for i in range(10):
            dep.schedule(i, 0.002 * (i // 5))
        dep.drain()
    (m, jm) = (dep.metrics()["serving"] for dep in deps)
    for key in ("completed", "rejected", "pending_arrivals", "clock_s"):
        assert m[key] == jm[key], key
    assert m["rejected"] > 0
    assert [r.req_id for r in deps[0].loop.rejected] == [r.req_id for r in deps[1].loop.rejected]


@pytest.mark.parametrize("weights", [(3.0, 1.0), (1.0, 1.0)])
def test_weighted_fair_order_matches_jax(weights):
    quotas = [("heavy", {"capacity_fraction": 0.5, "weight": weights[0]}),
              ("light", {"capacity_fraction": 0.5, "weight": weights[1]})]
    d, jd = _both(quotas)
    for dep in (d, jd):
        for i in range(12):
            dep.submit("heavy", i)
            dep.submit("light", i)
        dep.drain()
    assert _order(d) == _order(jd)
    assert d.router.metrics()["fairness"] == jd.router.metrics()["fairness"]
    assert d.router.metrics()["fairness"]["heavy"]["deficit"] == pytest.approx(12 / weights[0])


def test_metrics_are_tenant_keyed_json_and_torch():
    d = PORT.deploy(_tenants(PORT, TWO))
    for i in range(4):
        d.submit("alpha", i)
        d.submit("beta", i)
    done = d.drain()
    assert all(isinstance(r.result, torch.Tensor) and r.result.device == torch.device("cpu")
               for r in done)
    m = d.metrics()
    assert m["mode"] == "multi-tenant" and set(m["tenants"]) == {"alpha", "beta"}
    json.dumps(m, allow_nan=False)
    assert d.latency_report()["alpha"]["overall"]["count"] == 4


# ---------------------------------------------------------------------------
# spec-level checks, against the JAX package's codes
# ---------------------------------------------------------------------------

def test_tenant_validation_codes_match_jax():
    def bad(side):
        comm = _comm(side)
        return [side.TenantSpec("a", _spec(side, "a", comm), capacity_fraction=0.8),
                side.TenantSpec("a", _spec(side, "b", comm), capacity_fraction=0.5),
                side.TenantSpec("c", _spec(side, "c", comm), weight=-1.0),
                side.TenantSpec("d", _spec(side, "d", _comm(side)))]
    codes = [i.code for i in validate_tenants(as_tenants(bad(PORT)))]
    assert codes == [i.code for i in jax_validate_tenants(bad(JAX))]
    assert {"duplicate_tenant", "quota_exceeded", "bad_quota",
            "tenant_cluster_mismatch"} <= set(codes)
    comm = _comm(PORT)
    assert [t.name for t in as_tenants([_spec(PORT, "a", comm), PORT.TenantSpec(
        "named", _spec(PORT, "b", comm))])] == ["tenant0", "named"]
    assert PORT.TenantSpec("a", _spec(PORT, "a", comm, admission_depth=16),
                           admission_depth=4).quota() == 4


def test_infeasible_carve_and_single_spec_kwargs():
    for side in SIDES:
        comm = _comm(side, n_hosting=2, cap=4.2e6)
        ts = [side.TenantSpec(f"t{i}", _spec(side, f"t{i}", comm, capacity=4.2e6))
              for i in range(3)]
        with pytest.raises(side.InfeasibleSpecError) as ei:
            side.deploy(ts)
        assert {i.code for i in ei.value.issues} == {"infeasible_tenancy"}
    with pytest.raises(TypeError, match="tenancy"):
        PORT.deploy(_spec(PORT, "a", _comm(PORT)), policy="partition")


def test_unported_tenancy_branches_refuse():
    """These branches refused with ``not_ported`` until replica sets, traces
    and spans were ported; now a replicated, traced, open-loop tenant beside
    an autoscaled one deploys, and ``submit_trace``, ``trace_timeline``,
    ``chrome_trace`` and ``attribution`` return what the JAX package's do."""
    runs = []
    for side in SIDES:
        api_mod = api if side is PORT else jax_api
        comm = _comm(side, cap=2.2e6)  # 4 layers a node: 2-stage pipelines
        arrival = api_mod.ArrivalSpec("bursty", rate=300.0, duration_s=0.2, seed=4)
        ts = [side.TenantSpec("a", _spec(side, "a", comm, capacity=2.2e6, replicas=2,
                                         arrival=arrival,
                                         trace=api_mod.TraceConfig(sample=1.0))),
              side.TenantSpec("b", _spec(side, "b", comm, capacity=2.2e6, arrival=arrival,
                                         trace=True,
                                         autoscale=api_mod.AutoscaleSpec(
                                             min_replicas=1, max_replicas=2,
                                             backlog_high=3.0, backlog_low=1.0)))]
        assert (validate_tenants if side is PORT else jax_validate_tenants)(ts) == ()
        d = side.deploy(ts)
        n = d.submit_trace()
        d.drain()
        runs.append((d, n))
    (d, n), (jd, jn) = runs
    assert n == jn > 0 and len(d.completed("a")) + len(d.completed("b")) == n
    _same_plans(d, jd)
    assert d.deployment("a").replicated and d.deployment("b").autoscaler is not None
    for call in ("trace_timeline", "chrome_trace", "attribution"):
        got, want = getattr(d, call)(), getattr(jd, call)()
        assert got and json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True), call
    assert d.router.steady_state_throughput() == jd.router.steady_state_throughput()
    assert [e.summary() for e in d.deployment("b").autoscaler.events] == \
        [e.summary() for e in jd.deployment("b").autoscaler.events]


def test_tenant_stores_are_isolated(tmp_path):
    d = PORT.deploy(_tenants(PORT, TWO), store_root=str(tmp_path))
    sa, sb = d.deployment("alpha").store, d.deployment("beta").store
    assert sa.root != sb.root
    sa.publish(5)
    assert sb.current_version() != 5


# ---------------------------------------------------------------------------
# two real models: demo_mlp + demo_ssm with int8 hops
# ---------------------------------------------------------------------------

def _model_pair(side):
    if side is PORT:
        mlp = model_zoo.demo_mlp(device="cpu", params_for_version=jax_mlp_params)
        ssm = model_zoo.demo_ssm(device="cpu", params_for_version=jax_ssm_params)
    else:
        mlp, ssm = jax_zoo.demo_mlp(), jax_zoo.demo_ssm()
    cl = side.ClusterSpec(n_nodes=10, capacity_bytes=20_000, seed=5)
    return [side.TenantSpec(name, side.DeploymentSpec(
        model=g, executor_for_version=ex, cluster=cl, codec="int8", seed=3,
        capacity=g.total_param_bytes / 2.5, **side.spec_kw))
        for name, (g, ex) in (("mlp", mlp), ("ssm", ssm))]


SHAPES = {"mlp": (32,), "ssm": (8, 24)}


def _serve_pair(d, jd, n, offset):
    for i in range(n):
        for name, shape in SHAPES.items():
            x = np.full(shape, 0.1 * (i + 1) + offset, np.float32)
            d.submit(name, torch.from_numpy(x))
            jd.submit(name, jnp.asarray(x))
    got, want = d.drain(), jd.drain()
    assert len(got) == len(want) == 2 * n
    assert [(r.tenant, r.req_id) for r in got] == [(r.tenant, r.req_id) for r in want]
    for r, w in zip(got, want):
        assert isinstance(r.result, torch.Tensor) and r.result.device == torch.device("cpu")
        ref = np.asarray(w.result)
        np.testing.assert_allclose(r.result.numpy(), ref, rtol=0,
                                   atol=INT8_MAX_REL_ERROR * np.abs(ref).max())


def test_demo_mlp_and_demo_ssm_tenants_match_jax():
    d, jd = (side.deploy(_model_pair(side)) for side in SIDES)
    _same_plans(d, jd)
    for name in d.names():
        assert "int8" in d.deployment(name).plan.codecs
    _serve_pair(d, jd, 3, 0.0)
    # a NodeFailed on a node only the ssm tenant hosts on: mlp's plan stays
    mlp_path = list(d.deployment("mlp").plan.path)
    victim = d.deployment("ssm").control.pipeline.pods[1].node_id
    assert victim not in mlp_path
    d.inject(PORT.NodeFailed(victim))
    jd.inject(JAX.NodeFailed(victim))
    acts = d.reconcile()
    assert _kinds(acts) == _kinds(jd.reconcile())
    assert acts["mlp"] == [] and d.controlplane.routed == [("ssm", "NodeFailed")]
    assert list(d.deployment("mlp").plan.path) == mlp_path
    _same_plans(d, jd)
    _serve_pair(d, jd, 2, 0.03)
