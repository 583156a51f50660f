"""Boundary int8 compression, dispatched by the tensors' device.

A CUDA tensor goes to the hand-written kernel (``kernel.py``), a CPU tensor
to the plain version (``ref.py``); any other device raises.  There is no
fallback: a CUDA input the kernel cannot take raises.  The kernels have no
backward: on CUDA a gradient through one raises (``require_no_grad``).
"""

from __future__ import annotations

import torch

from repro_torch.core.execution import on_kernel_path, require_no_grad
from repro_torch.kernels.quantize.kernel import (
    dequant_matmul_cuda,
    dequantize_int8_cuda,
    quantize_int8_cuda,
)
from repro_torch.kernels.quantize.ref import dequant_matmul_ref, dequantize_ref, quantize_ref


def quantize_int8(x: torch.Tensor, block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    if on_kernel_path(x):
        require_no_grad("quantize_int8", x)
        return quantize_int8_cuda(x, block=block)
    return quantize_ref(x, block=block)


def dequantize_int8(
    q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16, *,
    block: int | None = None,
) -> torch.Tensor:
    if on_kernel_path(q, scale):
        require_no_grad("dequantize_int8", q, scale)
        return dequantize_int8_cuda(q, scale, dtype=dtype, block=block)
    return dequantize_ref(q, scale, dtype=dtype, block=block)


def dequant_matmul(
    q: torch.Tensor, scale: torch.Tensor, w: torch.Tensor, dtype=None, *,
    block: int | None = None,
) -> torch.Tensor:
    """``dequantize_int8(q, scale) @ w`` as one fused kernel.

    The receiving stage of an int8-coded link feeds its first matmul straight
    from the wire payload: the dequantized activation is never written to
    device memory."""
    if on_kernel_path(q, scale, w):
        require_no_grad("dequant_matmul", q, scale, w)
        return dequant_matmul_cuda(q, scale, w, dtype=dtype, block=block)
    return dequant_matmul_ref(q, scale, w, dtype=dtype, block=block)
