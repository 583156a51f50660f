"""The synchronous ``ServingLoop`` and the ``ModelWatcher``, the port
(``device="cpu"``) against the JAX package.

The sync loop's virtual clock (``service_times`` summed over every stage and
hop), its retries and its metrics are copies of the same Python code, so
they must be *equal*; served tensors are held to the frameworks' f32
difference: ``INT8_MAX_REL_ERROR`` of max|ref| through int8 hops (a code can
flip at a .5 tie between the two f32 sums), and an absolute 1e-5 through
identity hops (the CPU shows 1.4e-6 on demo_mlp and 1.8e-7 on demo_ssm with
these constant requests).
In the port itself the sync loop and the pipelined engine run the same
stage executors and the same hop transforms, so their outputs must be
``torch.equal``.

The watcher tests follow ``tests/test_controlplane.py``: an 8-layer tanh MLP
chain on a random 8-node cluster, a store bump, a bump the reconciler
rejects (the new version does not fit) and a stale watcher.
"""

from __future__ import annotations

import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jax_api
import repro.cluster as jax_cluster
import repro_torch.api as api
import repro_torch.cluster as cluster
from repro.core import model_zoo as jax_zoo
from repro.core.graph import chain as jax_chain
from repro.core.simulate import random_cluster as jax_random_cluster
from repro.runtime.pipeline import make_layer_executor as jax_layer_executor
from repro_torch.core import model_zoo
from repro_torch.core.graph import chain
from repro_torch.core.simulate import random_cluster
from repro_torch.kernels.quantize import INT8_MAX_REL_ERROR
from repro_torch.runtime.pipeline import make_layer_executor
from test_torch_slice import jax_mlp_params, jax_ssm_params

MODELS = {
    "demo_mlp": (jax_zoo.demo_mlp, model_zoo.demo_mlp, jax_mlp_params, (32,)),
    "demo_ssm": (jax_zoo.demo_ssm, model_zoo.demo_ssm, jax_ssm_params, (8, 24)),
}
IDENTITY_ATOL = 1e-5


def _specs(name, codec, **kw):
    jax_ctor, ctor, params, shape = MODELS[name]
    jgraph, jex = jax_ctor()
    graph, ex = ctor(device="cpu", params_for_version=params)
    cl = dict(n_nodes=6, capacity_bytes=graph.total_param_bytes / 2.5, seed=5)
    spec = api.DeploymentSpec(model=graph, executor_for_version=ex, codec=codec, seed=3,
                              cluster=api.ClusterSpec(**cl), device="cpu", **kw)
    jspec = jax_api.DeploymentSpec(model=jgraph, executor_for_version=jex, codec=codec,
                                   seed=3, cluster=jax_api.ClusterSpec(**cl), **kw)
    return spec, jspec, shape


def _requests(shape, n, offset=0.0):
    return [np.full(shape, 0.1 * (i + 1) + offset, np.float32) for i in range(n)]


def _serve(d, xs, to_tensor):
    reqs = [d.submit(to_tensor(x)) for x in xs]
    done = d.drain()
    assert [r.req_id for r in done] == [r.req_id for r in reqs]
    return done


def _check_close(got, want, codec):
    for r, w in zip(got, want):
        assert isinstance(r.result, torch.Tensor) and r.result.device == torch.device("cpu")
        ref = np.asarray(w.result)
        atol = INT8_MAX_REL_ERROR * np.abs(ref).max() if codec == "int8" else IDENTITY_ATOL
        np.testing.assert_allclose(r.result.numpy(), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("codec", ["int8", "identity"])
@pytest.mark.parametrize("name", list(MODELS))
def test_sync_deploy_matches_jax(name, codec):
    """Six requests, a NodeFailed on the second stage's node, three more:
    the same plans, clocks and metrics; outputs within the stated pins."""
    spec, jspec, shape = _specs(name, codec, serving="sync")
    d, jd = api.deploy(spec), jax_api.deploy(jspec)
    assert d.plan.summary() == jd.plan.summary()
    assert type(d.loop).__name__ == "ServingLoop"
    _check_close(_serve(d, _requests(shape, 6), torch.from_numpy),
                 _serve(jd, _requests(shape, 6), jnp.asarray), codec)
    victim = d.control.pipeline.pods[1].node_id
    d.inject(cluster.NodeFailed(victim))
    jd.inject(jax_cluster.NodeFailed(victim))
    _check_close(_serve(d, _requests(shape, 3, 0.05), torch.from_numpy),
                 _serve(jd, _requests(shape, 3, 0.05), jnp.asarray), codec)
    assert d.loop.clock_s == jd.loop.clock_s > 0
    assert [r.completed_s for r in d.loop.completed] == \
        [r.completed_s for r in jd.loop.completed]
    assert [a.kind for a in d.control.history] == [a.kind for a in jd.control.history]
    m, jm = d.metrics(), jd.metrics()
    assert m["serving"]["mode"] == "sync"
    assert json.dumps(m, sort_keys=True) == json.dumps(jm, sort_keys=True)


@pytest.mark.parametrize("codec", ["int8", "identity"])
@pytest.mark.parametrize("name", list(MODELS))
def test_sync_equals_pipelined_in_the_port(name, codec):
    spec, _, shape = _specs(name, codec)
    outs = {}
    for serving in ("sync", "pipelined"):
        d = api.deploy(api.DeploymentSpec(**{**spec.__dict__, "serving": serving}))
        outs[serving] = (d.plan.summary(),
                         [r.result for r in _serve(d, _requests(shape, 5), torch.from_numpy)])
    assert outs["sync"][0] == outs["pipelined"][0]
    for a, b in zip(outs["sync"][1], outs["pipelined"][1]):
        assert torch.equal(a, b)


def test_sync_serves_the_new_version_after_a_bump():
    spec, jspec, shape = _specs("demo_mlp", "int8", serving="sync")
    d, jd = api.deploy(spec), jax_api.deploy(jspec)
    xs = _requests(shape, 4)
    v0 = _serve(d, xs, torch.from_numpy)
    _serve(jd, xs, jnp.asarray)
    for dep in (d, jd):
        dep.store.publish(1)
        assert dep.poll_model_updates()
    v1, jv1 = _serve(d, xs, torch.from_numpy), _serve(jd, xs, jnp.asarray)
    assert d.observed().version == jd.observed().version == 1
    _check_close(v1, jv1, "int8")
    for a, b in zip(v0, v1):
        assert not torch.allclose(a.result, b.result, atol=1e-3)
    assert d.loop.clock_s == jd.loop.clock_s
    assert [a.kind for a in d.control.history] == [a.kind for a in jd.control.history]


# ---------------------------------------------------------------------------
# ModelWatcher
# ---------------------------------------------------------------------------

D, LAYERS = 16, 8
CAPACITY = 3 * D * D * 4


def _ws(version):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(version), (LAYERS, D, D)) * 0.3)


def _jax_executor(version):
    ws = _ws(version)
    return jax_layer_executor([lambda x, w=ws[i]: jnp.tanh(x @ w) for i in range(LAYERS)])


def _executor(version):
    ws = torch.from_numpy(_ws(version))
    return make_layer_executor([lambda x, w=ws[i]: torch.tanh(x @ w) for i in range(LAYERS)])


def _control(jax_side, rejected=False):
    mod = jax_cluster if jax_side else cluster
    ch, rc = (jax_chain, jax_random_cluster) if jax_side else (chain, random_cluster)
    graph = ch("mlp", [(D * D * 4, 4 * D * 4)] * LAYERS, in_bytes=4 * D * 4)
    huge = ch("huge", [(100 * CAPACITY, 4)] * LAYERS)
    def gfv(v):  # a rejected bump: every later version is too big to place
        return huge if rejected and v > 0 else graph

    kw = {} if jax_side else {"device": torch.device("cpu")}
    control = mod.ControlPlane(
        mod.EdgeCluster(rc(8, CAPACITY, seed=3), flops_per_s=1e9),
        mod.ArtifactStore(tempfile.mkdtemp(prefix="seifer-watch-")), gfv,
        _jax_executor if jax_side else _executor, capacity=CAPACITY, **kw)
    control.bootstrap(0)
    return mod, control, graph


def _events(control):
    return [(type(e).__name__, e.version) for e in control.pending_events()]


def _watch_story(jax_side, rejected):
    """What a watcher emits and the control plane does, tick by tick."""
    mod, control, _ = _control(jax_side, rejected)
    watcher = mod.ModelWatcher(control.store)
    story = [watcher.poll_events(control), _events(control)]
    control.store.publish(1)
    story += [watcher.poll_events(control), _events(control)]
    story += [(a.kind, a.detail) for a in control.reconcile()]
    # a bump the reconciler rejected is re-emitted while the store is ahead
    story += [watcher.poll_events(control), _events(control), watcher.deployed_version]
    control.reconcile()
    stale = mod.ModelWatcher(control.store)  # created after the pointer moved
    control.store.publish(0)  # the store pointer falls behind the deployment
    story += [stale.poll_events(control), watcher.poll_events(control),
              control.observed().version, _events(control)]
    return story


@pytest.mark.parametrize("rejected", [False, True], ids=["bump", "rejected-bump"])
def test_watcher_poll_events_matches_jax(rejected):
    got, want = _watch_story(False, rejected), _watch_story(True, rejected)
    assert got == want
    assert got[2] is True and got[3] == [("VersionBumped", 1)]
    if rejected:
        assert got[4][0] == "noop" and "rejected" in got[4][1]


def test_watcher_legacy_poll_matches_jax():
    """The one-shot ``poll``: no change keeps the pipeline, a bump stops its
    pods and deploys the new version, which computes with the new weights."""
    results = []
    for jax_side in (False, True):
        mod, control, graph = _control(jax_side)
        watcher = mod.ModelWatcher(control.store, control.dispatcher,
                                   graph_for_version=lambda v, g=graph: g)
        executor = _jax_executor(1) if jax_side else _executor(1)
        pipe = control.pipeline
        assert watcher.poll(pipe, executor) is pipe
        control.store.publish(1)
        new = watcher.poll(pipe, executor)
        assert new is not pipe and all(not p.alive for p in pipe.pods)
        assert watcher.poll(new, executor) is new and watcher.deployed_version == 1
        x = np.full((2, D), 0.1, np.float32)
        y, trace = new.run(jnp.asarray(x) if jax_side else torch.from_numpy(x))
        results.append((np.asarray(y), new.path(), trace.link_s))
    (y, path, link_s), (jy, jpath, jlink_s) = results
    assert path == jpath and link_s == jlink_s
    np.testing.assert_allclose(y, jy, rtol=0, atol=1e-5)
    ref = np.full((2, D), 0.1, np.float32)
    for w in _ws(1):
        ref = np.tanh(ref @ w)
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-5)


def test_watcher_legacy_poll_without_dispatcher_raises():
    _, control, _ = _control(False)
    watcher = cluster.ModelWatcher(control.store)
    control.store.publish(99)
    with pytest.raises(RuntimeError, match="poll_events"):
        watcher.poll(control.pipeline, _executor(0))
