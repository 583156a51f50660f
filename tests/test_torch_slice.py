"""The slice as a whole: ``deploy`` + pipelined serving with int8 hops, the
port (on ``device="cpu"``) against the JAX package (its jnp path), on the
same requests and the same weights (the JAX package's draws, carried into
the port through ``params_for_version``).

Pins: equal plans; outputs within ``INT8_MAX_REL_ERROR`` of max|ref| -- a
code can flip at a .5 tie between the frameworks' f32 sums, so the int8
round-trip bound is as tight as it gets; results are ``torch.Tensor``s on
the requested device.  Again after a ``NodeFailed`` and after a
``VersionBumped``.

Requests are constant activations (0.1, 0.2, ...), the input family
``benchmarks/kernel_path.py`` holds the JAX package's own e2e to this bound
with.  With N(0, 0.5) requests a tie flip lands in about one request in
five, and three more transformer layers carry it up to ~1e-2 of max|ref|
(see ROADMAP, queue 3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ClusterSpec as JaxClusterSpec
from repro.api import DeploymentSpec as JaxDeploymentSpec
from repro.api import deploy as jax_deploy
from repro.cluster import NodeFailed as JaxNodeFailed
from repro.core import model_zoo as jax_zoo
from repro_torch.api import ClusterSpec, DeploymentSpec, deploy
from repro_torch.cluster import NodeFailed
from repro_torch.core import model_zoo
from repro_torch.kernels.quantize import INT8_MAX_REL_ERROR


def jax_mlp_params(version, d=32, n_layers=8):
    """The JAX package's ``demo_mlp`` weights (``core/model_zoo.py``)."""
    ws = jax.random.normal(jax.random.PRNGKey(version), (n_layers, d, d)) * 0.3
    return {"ws": np.asarray(ws)}


def jax_transformer_params(version, d=32, n_layers=4, heads=4, kv_heads=2, mlp_mult=2):
    """The JAX package's ``demo_transformer`` weights (``core/model_zoo.py``)."""
    hd = d // heads
    proj = (heads + 2 * kv_heads) * hd
    f = mlp_mult * d
    key = jax.random.fold_in(jax.random.PRNGKey(version), 0xA77)
    kq, ko, k1, k2 = jax.random.split(key, 4)
    shapes = {"wqkv": (kq, (n_layers, d, proj)), "wo": (ko, (n_layers, d, d)),
              "w1": (k1, (n_layers, d, f)), "w2": (k2, (n_layers, f, d))}
    return {n: np.asarray(jax.random.normal(k, s) * 0.3) for n, (k, s) in shapes.items()}


MODELS = {
    "demo_transformer": (jax_zoo.demo_transformer, model_zoo.demo_transformer,
                         jax_transformer_params, (256, 32)),
    "demo_mlp": (jax_zoo.demo_mlp, model_zoo.demo_mlp, jax_mlp_params, (32,)),
}


def _pair(name):
    jax_ctor, ctor, params, shape = MODELS[name]
    jgraph, jexec = jax_ctor()
    graph, ex = ctor(device="cpu", params_for_version=params)
    assert repr(graph) == repr(jgraph)  # the same layer graph
    cluster = dict(n_nodes=6, capacity_bytes=graph.total_param_bytes / 2.5, seed=5)
    d = deploy(DeploymentSpec(model=graph, executor_for_version=ex,
                              cluster=ClusterSpec(**cluster), codec="int8",
                              seed=3, device="cpu"))
    jd = jax_deploy(JaxDeploymentSpec(model=jgraph, executor_for_version=jexec,
                                      cluster=JaxClusterSpec(**cluster),
                                      codec="int8", seed=3))
    return d, jd, shape


def _serve(d, jd, shape, n, offset):
    xs = [np.full(shape, 0.1 * (i + 1) + offset, np.float32) for i in range(n)]
    for x in xs:
        d.submit(torch.from_numpy(x))
        jd.submit(jnp.asarray(x))
    got, want = d.drain(), jd.drain()
    assert len(got) == len(want) == n
    assert sorted(r.req_id for r in got) == sorted(r.req_id for r in want)
    by_id = {r.req_id: r for r in want}
    for r in got:
        assert isinstance(r.result, torch.Tensor)
        assert r.result.device == torch.device("cpu")
        assert r.result.shape == shape and torch.isfinite(r.result).all()
        ref = np.asarray(by_id[r.req_id].result)
        np.testing.assert_allclose(r.result.numpy(), ref, rtol=0,
                                   atol=INT8_MAX_REL_ERROR * np.abs(ref).max())


def _same_plan(d, jd):
    assert d.plan.summary() == jd.plan.summary()
    assert list(d.observed().path) == list(jd.observed().path)


@pytest.fixture(scope="module", params=list(MODELS))
def deployed(request):
    d, jd, shape = _pair(request.param)
    assert "int8" in d.plan.codecs and len(d.control.pipeline.pods) >= 2
    return request.param, d, jd, shape


def test_plans_equal_and_outputs_agree(deployed):
    name, d, jd, shape = deployed
    _same_plan(d, jd)
    fused = d.control.pipeline.executor.fused_codecs
    assert fused == jd.control.pipeline.executor.fused_codecs
    assert ("int8" in fused) == (name == "demo_transformer")
    _serve(d, jd, shape, 5, offset=0.0)


def test_pipeline_run_matches_jax(deployed):
    """One synchronous pass through the pod chain (``InferencePipeline.run``)."""
    name, d, jd, shape = deployed
    x = np.full((2, *shape), 0.2, np.float32)
    y, trace = d.control.pipeline.run(torch.from_numpy(x))
    jy, jtrace = jd.control.pipeline.run(jnp.asarray(x))
    assert isinstance(y, torch.Tensor) and y.shape == x.shape
    ref = np.asarray(jy)
    np.testing.assert_allclose(y.numpy(), ref, rtol=0,
                               atol=INT8_MAX_REL_ERROR * np.abs(ref).max())
    assert trace.link_s == jtrace.link_s and trace.compute_s == jtrace.compute_s


def test_agree_after_node_failed(deployed):
    name, d, jd, shape = deployed
    victim = d.control.pipeline.pods[1].node_id
    assert victim == jd.control.pipeline.pods[1].node_id
    d.inject(NodeFailed(victim))
    jd.inject(JaxNodeFailed(victim))
    assert [a.kind for a in d.reconcile()] == [a.kind for a in jd.reconcile()]
    assert victim not in d.plan.path
    _same_plan(d, jd)
    _serve(d, jd, shape, 3, offset=0.03)


def test_agree_after_version_bumped(deployed):
    name, d, jd, shape = deployed
    d.store.publish(1)
    jd.store.publish(1)
    assert d.poll_model_updates() and jd.poll_model_updates()
    _serve(d, jd, shape, 3, offset=0.06)
    assert d.metrics()["version"] == jd.metrics()["version"] == 1
    _same_plan(d, jd)
    kinds = [a.kind for a in d.control.history]
    assert kinds == [a.kind for a in jd.control.history]
    assert "replace" in kinds and "redeploy" in kinds


def test_serving_metrics_match(deployed):
    name, d, jd, shape = deployed
    m, jm = d.metrics()["serving"], jd.metrics()["serving"]
    for key in ("completed", "failed", "backlog", "clock_s", "microbatches",
                "requeued_microbatches", "retries"):
        assert m[key] == jm[key], key
    assert [h["codec"] for h in m["links"]] == [h["codec"] for h in jm["links"]]


def test_unported_fields_rejected():
    from repro_torch.api import InfeasibleSpecError

    graph, _ = model_zoo.demo_mlp(device="cpu")
    base = dict(model=graph, cluster=ClusterSpec(n_nodes=4, capacity_bytes=1e9),
                device="cpu")
    for field, value in (("serving", "sync"), ("replicas", 2), ("trace", True),
                         ("admission_depth", 8), ("autoscale", True),
                         ("arrival", object())):
        spec = DeploymentSpec(**base, **{field: value})
        assert [i.code for i in spec.validate()] == ["not_ported"], field
        with pytest.raises(InfeasibleSpecError):
            deploy(spec)
    ssm = DeploymentSpec(model="demo_ssm", cluster=base["cluster"], device="cpu")
    assert [i.code for i in ssm.validate()] == ["not_ported"]


def test_default_device_is_cuda():
    assert DeploymentSpec(model="demo_mlp", cluster=ClusterSpec(
        n_nodes=4, capacity_bytes=1e9)).device == "cuda"


def test_standalone_weights_from_a_torch_generator():
    _, ex1 = model_zoo.demo_mlp(device="cpu")
    _, ex2 = model_zoo.demo_mlp(device="cpu")
    x = torch.ones(2, 32) * 0.1
    assert torch.equal(ex1(0)(0, 8, x), ex2(0)(0, 8, x))  # seeded: reproducible
    assert not torch.equal(ex1(0)(0, 8, x), ex1(1)(0, 8, x))  # keyed by version
