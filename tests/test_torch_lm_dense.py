"""The port's LM zoo against the JAX package: dense, vlm and audio archs.

For every such arch of ``ARCHS`` at ``reduced()``: the configs and the
``export_graph`` of every shape cell equal, ``init_params``' tree, shapes
and dtypes equal, ``forward_hidden`` in f32 and bf16, three decode steps,
a greedy serve step and the prefill step against the JAX package, on the
same seeded inputs and the JAX package's params (tolerances:
``tests/_lm_parity.py``).  gemma2 also at S = 2048, where ``attend`` takes
the flash-attention op.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from _lm_parity import (
    DENSE,
    TOL_F32,
    both_params,
    batch_np,
    check_config,
    check_decode_and_prefill,
    check_export_graph,
    check_forward,
    check_init_params,
    configs,
    jlm,
    rel_err,
    tlm,
    to_jax,
    to_torch,
)
from repro_torch.models import layers as tlayers
from repro_torch.models.common import params_from_numpy


@pytest.mark.parametrize("name", DENSE)
def test_config_matches(name):
    check_config(name)


@pytest.mark.parametrize("name", DENSE)
def test_export_graph_matches(name):
    check_export_graph(name)


@pytest.mark.parametrize("name", DENSE)
def test_init_params_tree(name):
    check_init_params(name)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", DENSE)
def test_forward_hidden(name, f32):
    check_forward(name, f32=f32)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", DENSE)
def test_decode_serve_and_prefill(name, f32):
    check_decode_and_prefill(name, f32=f32)


def test_gemma2_long_sequence_takes_the_flash_op(monkeypatch):
    """S = 2048: both windowed (8 at reduced size) and global layers go
    through the port's flash_attention op (its plain version on the CPU),
    within 1e-4 of the JAX package's blockwise flash path, in f32."""
    calls = []

    def counting(q, k, v, **kw):
        calls.append(kw["window"])
        return flash(q, k, v, **kw)

    flash = tlayers.flash_attention
    monkeypatch.setattr(tlayers, "flash_attention", counting)
    jcfg, tcfg = configs("gemma2-27b")
    jp, tp = both_params(jcfg, f32=True)
    batch = batch_np(jcfg, 1, 2048, seed=0, f32=True)
    jh, _ = jax.jit(lambda p, bt: jlm.forward_hidden(jcfg, p, bt))(jp, to_jax(batch))
    th, _ = tlm.forward_hidden(tcfg, tp, to_torch(batch))
    assert sorted(calls) == [0, tcfg.sliding_window]
    assert rel_err(th, jh) <= TOL_F32


def test_bf16_leaves_cross_bit_for_bit():
    x = jax.numpy.asarray(np.linspace(-3, 3, 97, dtype=np.float32), jax.numpy.bfloat16)
    t = params_from_numpy({"a": (np.asarray(x),)}, "cpu")["a"][0]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(), np.asarray(x).view(np.int16))
