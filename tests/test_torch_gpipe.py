"""The port's GPipe (``repro_torch.runtime.pipeline``) against the JAX package.

``plan_pipeline`` equals the JAX one field for field; ``reorder_stage_params``
permutes as the JAX one does; ``make_gpipe`` run in turn in one process
equals the sequential ``tanh(x @ w)`` chain that JAX computes from the same
numpy weights (within 1e-6), also with int8 boundaries, against the chain
that round-trips each boundary through the jitted JAX ``quantize_int8`` /
``dequantize_int8``.  With 4 gloo ranks (``tests/_gpipe_ranks.py``) it is
bit-equal to the in-turn run, a rank holding the whole stack of stage params
or only its own stage's.

The chain, not a live JAX ``make_gpipe``, is the reference: that raises
``ShardingTypeError`` under this JAX (``tests/test_pipeline_multidev.py``).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import chain as jax_chain
from repro.kernels.quantize import ops as jax_quant
from repro.runtime import pipeline as jax_pipe
from _gpipe_ranks import (
    CASES, D, LAYERS, MB, MULTIDEV_BW, N_MICRO, gpipe, inputs, run_ranks, stage_fn,
)
from repro_torch.core.graph import chain
from repro_torch.runtime.pipeline import make_gpipe, plan_pipeline, reorder_stage_params

# examples/pipeline_pods.py's pods
PODS_BW = np.array([[0, 12e9, 2e9, 2e9], [12e9, 0, 6e9, 2e9],
                    [2e9, 6e9, 0, 3e9], [2e9, 2e9, 3e9, 0]], float)
PLANS = {
    "multidev": (D, 16, MULTIDEV_BW, None),
    "multidev_flops": (D, 16, MULTIDEV_BW, 1e9),
    "pipeline_pods": (64, 32, PODS_BW, None),
}


def _plans(d, rows, bw, flops):
    sizes = [(d * d * 4, rows * d * 4)] * LAYERS
    kw = dict(stage_capacity=2 * d * d * 4, pod_bw=bw, device_flops=flops)
    return (plan_pipeline(chain("mlp", sizes), 4, **kw),
            jax_pipe.plan_pipeline(jax_chain("mlp", sizes), 4, **kw))


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_equals_the_jax_plan(case):
    plan, ref = _plans(*PLANS[case])
    for field in dataclasses.fields(ref):
        got, want = getattr(plan, field.name), getattr(ref, field.name)
        if isinstance(want, tuple):
            got, want = tuple(int(v) for v in got), tuple(int(v) for v in want)
        assert got == want, field.name
    assert plan.cuts == (1, 3, 5)


def test_reorder_stage_params_equals_the_jax_one():
    plan, ref_plan = _plans(*PLANS["multidev"])
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((4, 2, 3, 3)).astype(np.float32),
            "b": [rng.standard_normal((4, 5)).astype(np.float32)]}
    want = jax_pipe.reorder_stage_params(tree, ref_plan)
    got = reorder_stage_params({"w": torch.from_numpy(tree["w"]),
                                "b": [torch.from_numpy(tree["b"][0])]}, plan)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"][0].numpy(), np.asarray(want["b"][0]))


def _jax_chain(ws, x, *, compress: bool):
    """JAX's sequential chain, each stage's boundary (every second layer)
    round-tripped through the jitted int8 ops when ``compress``."""
    y = jnp.asarray(x)
    for i in range(LAYERS):
        y = jnp.tanh(y @ jnp.asarray(ws[i]))
        if compress and i % 2 == 1 and i < LAYERS - 1:
            q, s = jax_quant.quantize_int8(y, 32)
            y = jax_quant.dequantize_int8(q, s, dtype=y.dtype)
    return np.asarray(y)


@pytest.mark.parametrize("case", ["identity", "seifer"])
def test_in_turn_gpipe_equals_the_jax_chain(case):
    ws, x = inputs()
    plan, _ = _plans(*PLANS["multidev"])
    assert list(plan.stage_order) != [0, 1, 2, 3]  # the placement permutes
    y = gpipe(case)
    assert y.shape == (N_MICRO, MB, D) and y.dtype == torch.float32
    err = float(np.abs(y.numpy() - _jax_chain(ws, x, compress=False)).max())
    assert err < 1e-6, err


def test_in_turn_gpipe_int8_boundaries_equal_the_jax_round_trip():
    ws, x = inputs()
    y = gpipe("compressed").numpy()
    err = float(np.abs(y - _jax_chain(ws, x, compress=True)).max())
    assert err < 1e-6, err
    lossy = float(np.abs(y - _jax_chain(ws, x, compress=False)).max())
    assert 0 < lossy < 0.05, lossy  # the JAX test's bound on the compressed pipeline


def test_in_turn_gpipe_skips_idle_pairs():
    """12 of the 4 x (4 + 3) (stage, tick) pairs carry no microbatch: only
    n_micro x n_stages stage calls run, and 3 x n_micro boundaries go out."""
    calls = []

    def counted(w, x):
        calls.append(1)
        return stage_fn(w, x)

    ws, x = inputs()
    pipe = make_gpipe(counted, 4, n_micro=4, compress=True, quant_block=32)
    pipe(torch.from_numpy(ws).reshape(4, 2, D, D), torch.from_numpy(x[:4]))
    assert len(calls) == 16


def test_gpipe_rejects_a_bad_order_and_microbatch_count():
    with pytest.raises(ValueError, match="permutation"):
        make_gpipe(stage_fn, 4, n_micro=2, stage_order=(0, 1, 1, 3))
    pipe = make_gpipe(stage_fn, 4, n_micro=2)
    with pytest.raises(ValueError, match="microbatches"):
        pipe(torch.zeros(4, 2, D, D), torch.zeros(3, MB, D))


def test_four_gloo_ranks_equal_the_in_turn_run(tmp_path):
    """Bit-equal to the in-turn run in every case, on every rank; the
    "seifer" and "compressed" ranks hold only their own stage's params."""
    for p, got in enumerate(run_ranks(tmp_path)):
        for case in CASES:
            assert torch.equal(got[case], gpipe(case)), (p, case)


def test_group_mode_refuses_a_tensor_its_backend_does_not_send(monkeypatch):
    """A gloo group sends CPU tensors, an NCCL group CUDA tensors; a tensor
    elsewhere raises before any send (no copy to the host behind the
    caller's back)."""
    from repro_torch.runtime import pipeline

    monkeypatch.setattr(pipeline.dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(pipeline.dist, "get_backend", lambda group=None: "gloo")
    pipe = make_gpipe(stage_fn, 4, n_micro=2, group=object())
    with pytest.raises(ValueError, match="lies on meta"):
        pipe(torch.zeros(4, 2, D, D, device="meta"), torch.zeros(2, MB, D, device="meta"))
    # nccl sends CUDA tensors only: refused on the CPU
    monkeypatch.setattr(pipeline.dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match=r"sends \['cuda'\] tensors .* lies on cpu"):
        pipe(torch.zeros(4, 2, D, D), torch.zeros(2, MB, D))
    monkeypatch.setattr(pipeline.dist, "get_backend", lambda group=None: "cpu:gloo,cuda:nccl")
    with pytest.raises(ValueError, match=r"sends \['cpu', 'cuda'\] tensors .* lies on meta"):
        pipe(torch.zeros(4, 2, D, D, device="meta"), torch.zeros(2, MB, D, device="meta"))


def test_group_mode_takes_the_stack_or_the_ranks_own_stage(monkeypatch):
    """A rank's stage params have a leading dim of n_stages (the stack) or
    1 (its own stage); any other leading dim raises before any send."""
    from repro_torch.runtime import pipeline

    monkeypatch.setattr(pipeline.dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(pipeline.dist, "get_backend", lambda group=None: "gloo")
    monkeypatch.setattr(pipeline.dist, "get_rank", lambda group=None: 1)
    pipe = make_gpipe(stage_fn, 4, n_micro=2, group=object())
    with pytest.raises(ValueError, match="leading dim is 2, neither 1"):
        pipe(torch.zeros(2, 2, D, D), torch.zeros(2, MB, D))
