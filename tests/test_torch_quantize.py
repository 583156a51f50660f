"""The port's int8 codec kernels' plain versions against the JAX package.

Same seeded numpy inputs through both: the JAX side as its own tests run
it (its jitted ``quantize_int8`` op on the jnp path, and the Pallas kernels
in interpret mode), the port on the CPU (its plain versions).  Codes must be
byte-identical and scales equal, including ragged trailing dims and leading
dims.  The JAX package's eager ``quantize_ref`` divides by 127 where its
jitted op and its Pallas kernel multiply by f32(1/127) (XLA rewrites the
division by a constant); the port follows the served path, so against the
eager oracle the codes are identical and the scales within one ulp.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quantize import dequant_matmul as jax_dequant_matmul
from repro.kernels.quantize import quantize_int8 as jax_quantize_int8
from repro.kernels.quantize.kernel import dequantize_int8_tpu, quantize_int8_tpu
from repro.kernels.quantize.ref import dequantize_ref as jax_dequantize_ref
from repro.kernels.quantize.ref import quantize_ref as jax_quantize_ref
from repro_torch.kernels.quantize import (
    INT8_MAX_REL_ERROR,
    dequant_matmul,
    dequantize_int8,
    quantize_int8,
)
from repro_torch.kernels.quantize.ref import dequant_matmul_ref, dequantize_ref, quantize_ref

CASES = [  # (shape, block): ragged trailing dims and leading dims
    ((4, 256), 128),
    ((3, 300), 128),
    ((2, 5, 700), 256),
    ((7, 1000), 256),
    ((2, 3, 4, 64), 32),
]


def _x(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape, dtype=np.float32) * scale


@pytest.mark.parametrize("shape,block", CASES)
def test_codes_and_scales_identical_to_jax_op(shape, block):
    x = _x(shape, 0)
    q, s = quantize_ref(torch.from_numpy(x), block)
    jq, js = jax_quantize_int8(jnp.asarray(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("shape,block", CASES)
def test_codes_identical_to_eager_jax_ref(shape, block):
    x = _x(shape, 9)
    q, s = quantize_ref(torch.from_numpy(x), block)
    jq, js = jax_quantize_ref(jnp.asarray(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    # max/127 divided vs multiplied by f32(1/127): at most one ulp apart
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1.2e-7, atol=0)


@pytest.mark.parametrize("shape,block", CASES[:3])
def test_codes_identical_to_pallas_interpret(shape, block):
    x = _x(shape, 1)
    q, s = quantize_int8(torch.from_numpy(x), block)
    jq, js = quantize_int8_tpu(jnp.asarray(x), block=block, interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_codes_identical_on_half_ties():
    """Values that land exactly on .5 steps: round half to even on both."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]], np.float32)
    q, s = quantize_ref(torch.from_numpy(x), 8)
    jq, js = jax_quantize_ref(jnp.asarray(x), 8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -2, 4]]


@pytest.mark.parametrize("shape,block", CASES)
def test_dequantize_exact_in_f32(shape, block):
    x = _x(shape, 2)
    jq, js = jax_quantize_ref(jnp.asarray(x), block)
    q, s = torch.tensor(np.asarray(jq)), torch.tensor(np.asarray(js))
    out = dequantize_int8(q, s, torch.float32, block=block)
    want = jax_dequantize_ref(jq, js, dtype=jnp.float32, block=block)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_dequantize_matches_pallas_interpret_and_defaults_to_bf16():
    x = _x((8, 512), 3)
    jq, js = quantize_int8_tpu(jnp.asarray(x), block=128, interpret=True)
    q, s = torch.tensor(np.asarray(jq)), torch.tensor(np.asarray(js))
    out = dequantize_ref(q, s)
    assert out.dtype == torch.bfloat16
    want = dequantize_int8_tpu(jq, js, interpret=True)  # bf16 default
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_dequantize_ragged_requires_block():
    q, s = quantize_ref(torch.from_numpy(_x((2, 301), 4)), 128)
    assert s.shape[-1] == 3  # 301 over 128-wide blocks
    with pytest.raises(ValueError, match="ragged"):
        dequantize_ref(q, s)
    assert dequantize_ref(q, s, block=128).shape == (2, 301)


@pytest.mark.parametrize("n,d,dout,block", [(16, 256, 48, 128), (9, 300, 40, 128),
                                            (32, 512, 64, 256)])
def test_dequant_matmul_matches_pallas_interpret(n, d, dout, block):
    x = _x((n, d), 5)
    w = _x((d, dout), 6, scale=0.3)
    jq, js = jax_quantize_ref(jnp.asarray(x), block)
    q, s = torch.tensor(np.asarray(jq)), torch.tensor(np.asarray(js))
    out = dequant_matmul(q, s, torch.from_numpy(w), dtype=torch.float32, block=block)
    want = jax_dequant_matmul(jq, js, jnp.asarray(w), dtype=jnp.float32, block=block,
                              use_pallas=True, interpret=True)
    # f32 sums in another order: rtol and atol 1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_dequant_matmul_leading_dims_and_default_dtype():
    x = _x((2, 3, 256), 7)
    w = torch.from_numpy(_x((256, 16), 8)).to(torch.bfloat16)
    q, s = quantize_ref(torch.from_numpy(x), 128)
    out = dequant_matmul_ref(q, s, w)
    assert out.shape == (2, 3, 16) and out.dtype == torch.bfloat16


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roundtrip_within_int8_bound(seed):
    x = torch.from_numpy(_x((16, 1024), 10 + seed, scale=3.0))
    q, s = quantize_int8(x, 256)
    y = dequantize_int8(q, s, torch.float32)
    err = (y - x).abs().max().item() / x.abs().max().item()
    assert err <= INT8_MAX_REL_ERROR * (1 + 1e-5)  # f32 rounding slack


def test_zero_block_gives_zero_codes_and_scale():
    x = torch.zeros((2, 256))
    q, s = quantize_ref(x, 128)
    assert not q.any() and not s.any()

