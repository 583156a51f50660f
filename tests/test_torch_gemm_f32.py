"""demo_transformer's f32 products and the split-TF32 GEMM, on the CPU.

``repro_torch.kernels.gemm`` sends a CUDA product to the hand-written
split-TF32 GEMM (``csrc/gemm_f32.cu``, held to its plain version on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``) and a CPU one to
the plain version.  Here: what the wrapper refuses, that the CPU path is
``x @ w`` bit for bit, that the model of the kernel's arithmetic
(``split_precision.matmul_3xtf32``) errs against an f64 product no more
than twice the plain f32 product does, and that demo_transformer routes
its four products (three on the fused int8 path) through ``matmul_f32``
with each version's own weight planes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.model_zoo import demo_transformer
from repro_torch.dataplane.base import EncodedActivation
from repro_torch.dataplane.registry import get_codec
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.gemm.kernel import matmul_f32_cuda
from repro_torch.kernels.split_precision import TF32_LOW_BITS, matmul_3xtf32


def _normal(shape, seed, scale=1.0) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * scale)


def _planes(k: int, n: int, seed: int = 1):
    return gemm_ops.split_planes(_normal((k, n), seed))


@pytest.mark.parametrize("dtype,which", [
    (torch.float64, "a"), (torch.bfloat16, "a"), (torch.float16, "w_hi"), (torch.float64, "w_lo"),
])
def test_wrapper_refuses_a_non_f32_operand(dtype, which):
    a, (hi, lo) = _normal((8, 32), 0), _planes(32, 16)
    args = {"a": a, "w_hi": hi, "w_lo": lo}
    args[which] = args[which].to(dtype)
    with pytest.raises(TypeError, match=f"{which} must be torch.float32"):
        matmul_f32_cuda(args["a"], args["w_hi"], args["w_lo"])


@pytest.mark.parametrize("k,n", [(30, 16), (32, 18), (6, 6), (0, 16)])
def test_wrapper_refuses_unaligned_n_or_k(k, n):
    hi, lo = _planes(k, n)
    with pytest.raises(ValueError, match="multiples of 4"):
        matmul_f32_cuda(_normal((8, k), 0), hi, lo)


@pytest.mark.parametrize("a_shape,k,n", [((8, 32), 36, 16), ((2, 3, 64), 32, 8), ((8,), 16, 8)])
def test_wrapper_refuses_a_mismatched_inner_dimension(a_shape, k, n):
    hi, lo = _planes(k, n)
    with pytest.raises(ValueError, match=r"a \(\.\.\., \d+\) expected"):
        matmul_f32_cuda(_normal(a_shape, 0), hi, lo)


def test_wrapper_refuses_planes_of_two_shapes_and_cpu_tensors():
    hi, lo = _planes(32, 16)
    with pytest.raises(ValueError, match="must both be"):
        matmul_f32_cuda(_normal((8, 32), 0), hi, lo[:8])
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        matmul_f32_cuda(_normal((8, 32), 0), hi, lo)


def test_kernel_path_reads_planes_and_raises_without_them():
    """On the kernel's path (shapes on the meta device) the planes are split,
    and ``matmul_f32`` given none raises rather than run ``@``."""
    x, w = torch.empty((8, 32), device="meta"), torch.empty((32, 16), device="meta")
    hi, lo = gemm_ops.weight_planes(w)
    assert hi.shape == lo.shape == (16, 32)
    with pytest.raises(ValueError, match="reads weight_planes"):
        gemm_ops.matmul_f32(x, w, None)


@pytest.mark.parametrize("x_shape,k,n", [((5, 32), 32, 64), ((2, 7, 64), 64, 32),
                                         ((3, 30), 30, 18), ((1, 2560), 2560, 12)])
def test_cpu_path_is_x_at_w_bit_for_bit(x_shape, k, n):
    x, w = _normal(x_shape, 2), _normal((k, n), 3, 0.3)
    planes = gemm_ops.weight_planes(w)
    assert planes is None  # the plain version reads none
    out = gemm_ops.matmul_f32(x, w, planes)
    assert out.dtype == torch.float32 and out.shape == (*x_shape[:-1], n)
    assert torch.equal(out, x @ w)
    assert torch.equal(gemm_ops.matmul_f32_ref(x, w), x @ w)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 40.0])
def test_weight_planes_are_tf32_and_rebuild_w(scale):
    w = _normal((48, 20), 4, scale)
    hi, lo = gemm_ops.split_planes(w)
    assert hi.shape == lo.shape == (20, 48) and hi.is_contiguous() and lo.is_contiguous()
    for part in (hi, lo):  # what a TF32 wgmma reads: nothing in the dropped bits
        assert not (part.view(torch.int32) & TF32_LOW_BITS).any()
    err = ((hi.double() + lo.double()) - w.t().double()).abs()
    assert (err <= 2.0**-22 * w.t().double().abs()).all()


@pytest.mark.parametrize("k", [2560, 10240])
def test_three_pass_model_errs_within_twice_the_f32_product(k):
    """The kernel's arithmetic against an f64 product at demo_transformer's
    inner dims (phi-2's d and MLP width): within 2x the plain f32 product's
    own error, max-abs and Frobenius, of the f64 product's scale."""
    a, b = _normal((64, k), 5), _normal((k, 48), 6, k**-0.5)
    exact = a.double() @ b.double()
    scale, norm = exact.abs().max(), exact.norm()
    got, plain = matmul_3xtf32(a, b).double(), (a @ b).double()
    assert (got - exact).abs().max() / scale <= 2 * (plain - exact).abs().max() / scale
    assert (got - exact).norm() / norm <= 2 * (plain - exact).norm() / norm


def _counting(monkeypatch) -> list:
    seen = []
    real = gemm_ops.matmul_f32

    def counted(x, w, planes):
        seen.append((tuple(x.shape), tuple(w.shape), planes))
        return real(x, w, planes)

    monkeypatch.setattr(gemm_ops, "matmul_f32", counted)
    return seen


def test_layer_sends_its_products_through_matmul_f32(monkeypatch):
    d, seq = 32, 16
    _, ex_for = demo_transformer(d=d, n_layers=2, seq=seq, device="cpu")
    ex = ex_for(0)
    seen = _counting(monkeypatch)
    x = _normal((2, seq, d), 7)
    ex(0, 1, x)
    assert [s[1] for s in seen] == [(32, 64), (32, 32), (32, 64), (64, 32)]
    seen.clear()
    codec = get_codec("int8")
    ex(1, 2, EncodedActivation(codec, codec.encode(x)))  # the fused receive: q|k|v elsewhere
    assert [s[1] for s in seen] == [(32, 32), (32, 64), (64, 32)]


def test_unaligned_widths_go_through_matmul_f32_too(monkeypatch):
    """n or k not a multiple of 4 (d=6, hd 3): on the CPU every product still
    goes through ``matmul_f32`` (on the card the wrapper would raise)."""
    _, ex_for = demo_transformer(d=6, n_layers=1, seq=8, heads=2, kv_heads=1, mlp_mult=2,
                                 device="cpu")
    seen = _counting(monkeypatch)
    out = ex_for(0)(0, 1, _normal((8, 6), 8))
    assert [s[1:] for s in seen] == [((6, 12), None), ((6, 6), None), ((6, 12), None),
                                     ((12, 6), None)]
    assert out.shape == (8, 6)


def test_weight_planes_follow_the_version(monkeypatch):
    """A version bump rebuilds the planes: hi + lo of version v is W^T of
    version v, for every product of every layer (the planes split here as
    on the card, where ``weight_planes`` is ``split_planes``)."""
    d, seq, n_layers = 32, 16, 2
    shapes = {"wqkv": (d, 64), "wo": (d, d), "w1": (d, 64), "w2": (64, d)}
    params = {v: {name: _normal((n_layers, *shape), 10 * v + j, 0.3)
                  for j, (name, shape) in enumerate(shapes.items())} for v in (1, 2)}
    _, ex_for = demo_transformer(d=d, n_layers=n_layers, seq=seq, device="cpu",
                                 params_for_version=lambda v: {k: t.numpy()
                                                               for k, t in params[v].items()})
    monkeypatch.setattr(gemm_ops, "weight_planes", gemm_ops.split_planes)
    seen = _counting(monkeypatch)
    x = _normal((1, seq, d), 9)
    for v in (1, 2):
        seen.clear()
        ex_for(v)(0, n_layers, x)
        assert len(seen) == 4 * n_layers
        for j, (_, w_shape, (hi, lo)) in enumerate(seen):
            layer, name = divmod(j, 4)
            w = params[v][list(shapes)[name]][layer]
            assert w_shape == tuple(w.shape)
            other = params[3 - v][list(shapes)[name]][layer]
            rebuilt = hi.double() + lo.double()
            assert (rebuilt - w.t().double()).abs().max() <= 2.0**-22 * w.abs().max()
            assert not torch.allclose(rebuilt, other.t().double())
