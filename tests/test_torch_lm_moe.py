"""The port's LM zoo against the JAX package: the MoE archs.

For phi3.5-moe and kimi-k2 at ``reduced()``: the configs and the
``export_graph`` of every shape cell equal, ``init_params``' tree, shapes
and dtypes equal, ``forward_hidden`` (and the load-balancing aux loss) in
f32 and bf16, three decode steps, a greedy serve step and the prefill step
against the JAX package (tolerances: ``tests/_lm_parity.py``), and the
GShard dispatch against the JAX package's at a size where tokens overflow
an expert's capacity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (
    MOE,
    TOL_F32,
    check_config,
    check_decode_and_prefill,
    check_export_graph,
    check_forward,
    check_init_params,
    configs,
    params_from_numpy,
    rel_err,
    to_numpy,
)
from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe


@pytest.mark.parametrize("name", MOE)
def test_config_matches(name):
    check_config(name)


@pytest.mark.parametrize("name", MOE)
def test_export_graph_matches(name):
    check_export_graph(name)


@pytest.mark.parametrize("name", MOE)
def test_init_params_tree(name):
    check_init_params(name)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", MOE)
def test_forward_hidden(name, f32):
    check_forward(name, f32=f32)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", MOE)
def test_decode_serve_and_prefill(name, f32):
    check_decode_and_prefill(name, f32=f32)


@pytest.mark.parametrize("group_size", [512, 16])
def test_moe_dispatch_drops_past_capacity_as_jax(group_size):
    """64 tokens over 4 experts with top-2 routing, in one group (capacity
    40) or in groups of 16 (capacity 12): a router skewed towards expert 0
    sends it every token, past its capacity, so tokens are dropped.  The
    expert choices (topk) equal the JAX package's and the outputs are within
    1e-4."""
    jcfg, tcfg = configs("phi3.5-moe-42b-a6.6b")
    p = jmoe.init_moe(jcfg, jax.random.PRNGKey(3))
    p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    p["router"] = p["router"].at[:, 0].add(0.2)  # expert 0's logit +0.2 sum(x)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 32, jcfg.d_model), dtype=np.float32) + 1.0
    jy, jaux = jmoe.moe_mlp(jcfg, p, jnp.asarray(x), group_size=group_size)
    tp = params_from_numpy(to_numpy(p), "cpu")
    ty, taux = tmoe.moe_mlp(tcfg, tp, torch.from_numpy(x), group_size=group_size)
    _, _, je = jmoe.route(jcfg, p, jnp.asarray(x))
    _, _, te = tmoe.route(tcfg, tp, torch.from_numpy(x))
    assert np.array_equal(te.numpy(), np.asarray(je))
    cap = tmoe._capacity(min(group_size, 64), 2, 4, tcfg.moe_capacity_factor)
    assert cap == jmoe._capacity(min(group_size, 64), 2, 4, jcfg.moe_capacity_factor)
    g_sz = min(group_size, 64)
    assert np.bincount(np.asarray(je).reshape(64 // g_sz, -1)[0], minlength=4).max() > cap
    assert rel_err(ty, jy) <= TOL_F32
    assert abs(float(taux) - float(jaux)) <= 1e-6 * float(jaux)


def test_route_promotes_a_bf16_router_as_jax():
    """A bf16 router (a param tree cast whole to bf16) routes in f32, as the
    JAX package's einsum promotes it: probabilities and expert choices equal
    the JAX package's, where the port's product used to refuse the mix."""
    jcfg, tcfg = configs("phi3.5-moe-42b-a6.6b")
    p = jmoe.init_moe(jcfg, jax.random.PRNGKey(4))
    p["router"] = p["router"].astype(jnp.bfloat16)
    x = np.random.default_rng(10).standard_normal((2, 16, jcfg.d_model), dtype=np.float32)
    jprobs, _, je = jmoe.route(jcfg, p, jnp.asarray(x, jnp.bfloat16))
    tp = params_from_numpy(to_numpy(p), "cpu")
    assert tp["router"].dtype == torch.bfloat16
    tprobs, _, te = tmoe.route(tcfg, tp, torch.from_numpy(x).bfloat16())
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert rel_err(tprobs, jprobs) <= 1e-6
