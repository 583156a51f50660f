"""The observability plane, the port (``repro_torch.obs``) against the JAX
package (``repro.obs``): span timelines, Chrome traces, critical-path
attribution and the metrics registry come from copies of the same Python
code driven by the same virtual clock, so they must serialise
*byte-identically* (``json.dumps(..., sort_keys=True)``).

One ``LayerGraph`` spec with pass-through executors (as in
``tests/test_observability.py``'s router fixtures) serves through each of
the three loops -- pipelined, synchronous and replicated -- with a node
killed mid-run, under ``TraceConfig(sample=1.0)`` and ``sample=0.3``.
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
import repro.obs as jax_obs
import repro_torch.api as api
import repro_torch.cluster as cluster
import repro_torch.core.graph as graph_mod
import repro_torch.obs as obs

PARAM = 1_000_000
CAPACITY = 2 * PARAM * 1.05  # 2 layers a node -> 3-stage pipelines


def _side(api_mod, cluster_mod, graph, obs_mod, ones, **spec_kw):
    return SimpleNamespace(api=api_mod, NodeFailed=cluster_mod.NodeFailed,
                           Layer=graph.Layer, LayerGraph=graph.LayerGraph, obs=obs_mod,
                           ones=ones, spec_kw=spec_kw)


JAX = _side(jax_api, jax_cluster, jax_graph, jax_obs, jnp.ones)
PORT = _side(api, cluster, graph_mod, obs, torch.ones, device="cpu")
SIDES = (PORT, JAX)

LOOPS = {"pipelined": {}, "sync": {"serving": "sync"}, "replicated": {"replicas": 2}}


def _deploy(side, sample, loop):
    layers = tuple(side.Layer(f"l{i}", param_bytes=PARAM, out_bytes=120_000,
                              flops=8_000_000) for i in range(6))
    return side.api.deploy(side.api.DeploymentSpec(
        model=side.LayerGraph("router6", layers, in_bytes=60_000), capacity=CAPACITY,
        cluster=side.api.ClusterSpec(n_nodes=12, capacity_bytes=CAPACITY, seed=4),
        seed=4, microbatch=2, trace=side.api.TraceConfig(sample=sample),
        **LOOPS[loop], **side.spec_kw))


def _serve(side, d, n=24, kill_after=6):
    """``n`` requests; the second stage's node of (replica 0's) pipeline
    fails once ``kill_after`` have completed."""
    for i in range(n):
        d.submit(side.ones((4,)) * i)
    victim = d.control.pipeline.pods[1].node_id
    killed = False
    for _ in range(10_000):
        if not killed and len(d.loop.completed) >= kill_after:
            d.inject(side.NodeFailed(victim))
            killed = True
        if not d.loop.backlog and not d.pending:
            break
        d.step()
    assert killed and not d.loop.backlog and not d.pending
    assert len(d.loop.completed) == n
    return d


def _dumps(x):
    return json.dumps(x, sort_keys=True)


@pytest.fixture(scope="module", params=[(loop, s) for loop in LOOPS for s in (1.0, 0.3)],
                ids=lambda p: f"{p[0]}-sample{p[1]}")
def served(request):
    loop, sample = request.param
    d, jd = (_serve(side, _deploy(side, sample, loop)) for side in SIDES)
    return loop, sample, d, jd


def test_chrome_trace_is_byte_identical(served):
    loop, sample, d, jd = served
    ct = d.chrome_trace()
    assert _dumps(ct) == _dumps(jd.chrome_trace())
    assert _dumps(d.trace_timeline()) == _dumps(jd.trace_timeline())
    traced = {s.req_id for s in d.tracer.spans}
    if sample == 1.0:
        assert traced == {r.req_id for r in d.loop.completed}
    else:
        assert 0 < len(traced) < len(d.loop.completed)  # partial sampling
    if loop == "replicated":
        assert {s.replica for s in d.tracer.spans} == {0, 1}


def test_spans_tile_each_completed_request(served):
    loop, sample, d, jd = served
    for req in d.loop.completed:
        spans = sorted(d.tracer.spans_for(req.req_id), key=lambda s: s.t0_s)
        if not d.tracer.sampled(req.req_id):
            assert spans == []
            continue
        assert spans, req.req_id
        for a, b in zip(spans, spans[1:]):
            assert abs(b.t0_s - a.t1_s) <= 1e-9, (a, b)
        assert abs(spans[0].t0_s - req.submitted_s) <= 1e-9
        assert abs(spans[-1].t1_s - req.completed_s) <= 1e-9
        assert abs(sum(s.duration_s for s in spans) - req.latency_s) <= 1e-8


def test_attribution_matches_jax(served):
    loop, sample, d, jd = served
    att = d.attribution()
    assert _dumps(att) == _dumps(jd.attribution())
    assert abs(sum(att["fractions"].values()) - 1.0) <= 1e-6
    for req in d.loop.completed[:4]:
        spans = d.tracer.spans_for(req.req_id)
        if spans:
            assert _dumps(obs.request_attribution(spans)) == \
                _dumps(jax_obs.request_attribution(jd.tracer.spans_for(req.req_id)))


def test_registry_snapshot_matches_jax(served):
    loop, sample, d, jd = served
    m, jm = d.metrics(), jd.metrics()
    snap = m["observability"]["metrics"]
    assert _dumps(snap) == _dumps(jm["observability"]["metrics"])
    assert _dumps(m["observability"]["trace"]) == _dumps(jm["observability"]["trace"])
    from repro_torch.obs.metrics import validate_snapshot

    validate_snapshot(snap)
    assert _dumps(m) == _dumps(jm)


def test_registry_primitives_match_jax():
    regs = []
    for side in SIDES:
        reg = side.obs.MetricsRegistry()
        reg.counter("requests_completed", engine="pipelined").inc(3)
        reg.gauge("live_replicas").set(2)
        h = reg.histogram("request_latency_s", engine="sync")
        for v in np.random.default_rng(0).exponential(0.1, 40):
            h.observe(float(v))
        reg.ingest("deployment", {"serving": {"completed": 7, "clock_s": 1.5}})
        regs.append(reg.snapshot())
    assert _dumps(regs[0]) == _dumps(regs[1])


def test_percentile_has_one_implementation():
    from repro_torch.cluster import serving
    from repro_torch.cluster.autoscale import percentile as autoscale_percentile
    from repro_torch.obs.metrics import percentile as metrics_percentile

    assert serving.percentile is obs.percentile is autoscale_percentile is metrics_percentile
    assert serving.latency_report is obs.latency_report
    assert serving.latency_stats is obs.latency_stats
    vals = sorted(float(v) for v in range(1, 101))
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert obs.percentile(vals, q) == jax_obs.percentile(vals, q)


def test_trace_config_issues_match_jax():
    for kw in (dict(sample=2.0), dict(sample=-0.1), dict(max_spans=0), {}):
        got, want = (side.api.TraceConfig(**kw).issues() for side in SIDES)
        assert got == want
    for side in SIDES:
        spec = side.api.DeploymentSpec(
            model="demo_mlp", cluster=side.api.ClusterSpec(n_nodes=8, capacity_bytes=1e9),
            trace=side.api.TraceConfig(sample=7.0), **side.spec_kw)
        assert [i.code for i in spec.validate()] == ["bad_trace"]


def test_untraced_deploy_has_no_span_surface():
    d = api.deploy(api.DeploymentSpec(
        model="demo_mlp", cluster=api.ClusterSpec(n_nodes=6, capacity_bytes=11_000, seed=5),
        device="cpu"))
    d.submit(torch.ones(32))
    d.drain()
    assert d.tracer is None and d.trace_timeline() == []
    assert d.chrome_trace() is None and d.attribution() is None
    assert d.metrics()["observability"]["trace"] is None
