"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Marked ``gpu``: skipped (from the fixture) where ``torch.cuda.is_available()``
is False.  Run on a CUDA machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Shapes: small ragged ones, and the shapes the served path gives each kernel
(``chip_smoke.py`` phase 4: demo_transformer at d=4096, H=32, KH=16,
hd=128, S=8192, 4 requests per microbatch).  This file imports no JAX: the
machine with the card has none.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.execution import resolve_device
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.quantize.kernel import (
    dequant_matmul_cuda,
    dequantize_int8_cuda,
    quantize_int8_cuda,
)
from repro_torch.kernels.quantize.ref import (
    INT8_MAX_REL_ERROR,
    dequant_matmul_ref,
    dequantize_ref,
    quantize_ref,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")  # also pins f32 matmuls to full f32


def _randn(shape, seed, device, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32) * scale,
                           device=device)


@pytest.mark.parametrize("shape,block", [
    ((3, 300), 128), ((2, 5, 256), 256), ((7, 1000), 256), ((4, 8192, 4096), 256),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_codes_equal_plain(cuda, shape, block, dtype):
    x = _randn(shape, 0, cuda).to(dtype)
    q, s = quantize_int8_cuda(x, block)
    q_ref, s_ref = quantize_ref(x, block)
    torch.cuda.synchronize()
    assert torch.equal(q, q_ref)  # bit-identical codes
    assert torch.equal(s, s_ref)


@pytest.mark.parametrize("shape,block", [((3, 300), 128), ((4, 4096), 256),
                                         ((2, 8192, 4096), 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_exact(cuda, shape, block, dtype):
    q, s = quantize_ref(_randn(shape, 1, cuda), block)
    out = dequantize_int8_cuda(q, s, dtype=dtype, block=block)
    torch.cuda.synchronize()
    assert torch.equal(out, dequantize_ref(q, s, dtype=dtype, block=block))


def test_roundtrip_bounded(cuda):
    x = _randn((64, 2048), 2, cuda)
    q, s = quantize_int8_cuda(x, 256)
    y = dequantize_int8_cuda(q, s, dtype=torch.float32)
    err = (y - x).abs().max().item() / x.abs().max().item()
    assert err <= INT8_MAX_REL_ERROR * (1 + 1e-5)


@pytest.mark.parametrize("n,d,dout,block", [
    (5, 300, 70, 128), (130, 256, 129, 256), (256, 512, 384, 256),
    (32768, 4096, 8192, 256),
])
def test_dequant_matmul_matches_plain(cuda, n, d, dout, block):
    q, s = quantize_ref(_randn((n, d), 3, cuda), block)
    w = _randn((d, dout), 4, cuda, scale=0.3)
    out = dequant_matmul_cuda(q, s, w, dtype=torch.float32, block=block)
    ref = dequant_matmul_ref(q, s, w, dtype=torch.float32, block=block)
    torch.cuda.synchronize()
    # f32 sums in another order: 1e-5 of the output's magnitude
    rel = (out - ref).abs().max().item() / ref.abs().max().item()
    assert rel <= 1e-5


def _flash_case(cuda, b, s, h, kh, hd, seed):
    q = _randn((b, s, h, hd), seed, cuda)
    k = _randn((b, s, kh, hd), seed + 1, cuda)
    v = _randn((b, s, kh, hd), seed + 2, cuda)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s,hd", [(128, 64), (100, 128), (192, 256)])
def test_flash_matches_plain(cuda, causal, window, softcap, g, s, hd):
    q, k, v = _flash_case(cuda, 2, s, 2 * g, 2, hd, 5)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)
    ref = attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-5


def test_flash_takes_strided_projection_slices(cuda):
    """q/k/v as slices of one fused projection, as demo_transformer feeds them."""
    b, s, h, kh, hd = 2, 128, 4, 2, 64
    qkv = _randn((b, s, (h + 2 * kh) * hd), 6, cuda)
    q = qkv[..., : h * hd].reshape(b, s, h, hd)
    k = qkv[..., h * hd:(h + kh) * hd].reshape(b, s, kh, hd)
    v = qkv[..., (h + kh) * hd:].reshape(b, s, kh, hd)
    out = flash_attention_cuda(q, k, v, causal=True, window=0, softcap=50.0)
    ref = attention_ref(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=True, softcap=50.0)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-5


@pytest.mark.parametrize("window", [0, 4096])
def test_flash_main_path_shape(cuda, window):
    """S=8192, H=32, KH=16, hd=128: the plain version one kv-head group at a
    time (the full logits of all heads would take 8.6 GB each)."""
    b, s, h, kh, hd = 1, 8192, 32, 16, 128
    q, k, v = _flash_case(cuda, b, s, h, kh, hd, 7)
    out = flash_attention_cuda(q, k, v, causal=True, window=window, softcap=50.0)
    g = h // kh
    worst = 0.0
    for j in range(0, kh, 4):  # 4 groups checked, spread over the heads
        ref = attention_ref(q[:, :, j * g:(j + 1) * g], k[:, :, j:j + 1],
                            v[:, :, j:j + 1], causal=True, window=window,
                            softcap=50.0)
        worst = max(worst, (out[:, :, j * g:(j + 1) * g] - ref).abs().max().item())
    assert worst <= 2e-5


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = _randn((4, 64), 8, cuda)
    with pytest.raises(TypeError):
        quantize_int8_cuda(x.to(torch.float16))
    with pytest.raises(ValueError):
        quantize_int8_cuda(x.t())  # not contiguous
    q = _randn((1, 64, 2, 32), 9, cuda)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q)  # hd=32 has no kernel
