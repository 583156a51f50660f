"""f32 matrix products of demo_transformer, dispatched by the tensors' device.

``matmul_f32(x, w, planes)`` is ``x @ w`` in f32.  A CUDA tensor goes to the
hand-written split-TF32 GEMM (``kernel.py``), which reads the weight as its
TF32 planes, ``planes = weight_planes(w)``, split once per weight version
by the caller; a CPU tensor goes to the plain version, ``matmul_f32_ref``,
and its planes are ``None``.  Any other device raises, and there is no
fallback: a CUDA input the kernel cannot take raises.  The kernel has no
backward: on CUDA a gradient through it raises (``require_no_grad``).
"""

from __future__ import annotations

import torch

from repro_torch.core.execution import on_kernel_path, require_no_grad
from repro_torch.kernels.gemm.kernel import matmul_f32_cuda
from repro_torch.kernels.split_precision import split


def split_planes(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w (..., k, n) f32 -> its TF32 planes (hi, lo), each (..., n, k) and
    contiguous: hi = tf32_rna(w^T), lo = tf32_rna(w^T - hi), so hi + lo is
    w within 2^-22 of it."""
    hi, lo = split(w.transpose(-1, -2).contiguous())
    return hi, lo


def weight_planes(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor] | None:
    """What ``matmul_f32`` reads in place of w: its ``split_planes`` where the
    product runs the kernel, ``None`` on the CPU, where it reads none."""
    return split_planes(w) if on_kernel_path(w) else None


def matmul_f32_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version: ``x @ w`` (f32, TF32 off)."""
    return x @ w


def matmul_f32(x: torch.Tensor, w: torch.Tensor,
               planes: tuple[torch.Tensor, torch.Tensor] | None) -> torch.Tensor:
    """``x (..., k) @ w (k, n)`` in f32; ``planes`` is ``weight_planes(w)``,
    which the kernel reads in place of w."""
    if on_kernel_path(x, w):
        require_no_grad("matmul_f32", x, w)
        if planes is None:
            raise ValueError("matmul_f32 on the kernel path reads weight_planes(w), got None")
        return matmul_f32_cuda(x, *planes)
    return matmul_f32_ref(x, w)
