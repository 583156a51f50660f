"""The port's planner (its copy of the numpy partition/placement stack)
against the JAX package's: the same specs must compile to identical cuts,
placement paths, link codecs and predicted metrics."""

from __future__ import annotations

import itertools

import jax  # noqa: F401  (the JAX package's demo models import it)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.api import ClusterSpec as JaxClusterSpec
from repro.api import DeploymentSpec as JaxDeploymentSpec
from repro.api import Planner as JaxPlanner
from repro.api import list_strategies as jax_list_strategies
from repro_torch.api import ClusterSpec, DeploymentSpec, Planner, list_strategies

MODELS = ["demo_mlp", "demo_transformer", "resnet50"]
CASES = list(itertools.product(MODELS, [0, 1, 2], ["identity", "int8"]))


def _capacity(model: str) -> float:
    from repro_torch.api.spec import _resolve_model

    graph, _ = _resolve_model(model, device="cpu")
    return graph.total_param_bytes / 2.5


def _plans(model, seed, codec, **kw):
    cluster = dict(n_nodes=6, capacity_bytes=_capacity(model), seed=seed)
    spec = DeploymentSpec(model=model, cluster=ClusterSpec(**cluster), codec=codec,
                          seed=seed, device="cpu", **kw)
    jspec = JaxDeploymentSpec(model=model, cluster=JaxClusterSpec(**cluster),
                              codec=codec, seed=seed, **kw)
    return Planner.from_spec(spec).compile(spec), JaxPlanner.from_spec(jspec).compile(jspec)


def _assert_same(plan, jplan):
    assert plan.feasible and jplan.feasible
    assert plan.partition.cuts == jplan.partition.cuts
    assert plan.placement.path == jplan.placement.path
    assert plan.codecs == jplan.codecs
    assert plan.strategies == jplan.strategies
    assert plan.predicted_throughput == jplan.predicted_throughput
    assert plan.predicted_bottleneck_s == jplan.predicted_bottleneck_s
    assert plan.summary() == jplan.summary()


@pytest.mark.parametrize("model,seed,codec", CASES)
def test_plans_identical(model, seed, codec):
    _assert_same(*_plans(model, seed, codec))


@pytest.mark.parametrize("placer", ["greedy", "optimal"])
def test_other_placers_plan_identically(placer):
    _assert_same(*_plans("demo_transformer", 0, "int8", placer=placer))


def test_auto_codec_plans_identically():
    plan, jplan = _plans("demo_mlp", 1, "auto", accuracy_tolerance=0.01)
    _assert_same(plan, jplan)


def test_same_strategy_registry():
    for kind in ("partitioner", "placer", "joint"):
        assert list_strategies(kind) == jax_list_strategies(kind)


def test_random_cluster_identical():
    comm, _ = ClusterSpec(n_nodes=8, capacity_bytes=1e6, seed=3).build()
    jcomm, _ = JaxClusterSpec(n_nodes=8, capacity_bytes=1e6, seed=3).build()
    np.testing.assert_array_equal(comm.bw, jcomm.bw)
    np.testing.assert_array_equal(comm.node_capacity, jcomm.node_capacity)
