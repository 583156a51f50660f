"""Wrapper of the split-TF32 f32 GEMM (``csrc/gemm_f32.cu``).

``matmul_f32_cuda(a, w_hi, w_lo)`` computes ``a (..., k) @ w (k, n)`` in
f32 on the tensor cores, from w's TF32 planes (``ops.weight_planes``: hi and
lo, each (n, k), K-major, as a TF32 ``wgmma`` takes them).  It checks what
the kernel takes and raises on anything else: float32 CUDA tensors, a
contiguous and planes of one shape (n, k) matching a's last dim, n and k
multiples of 4 (the kernel's TMA loads want 16-byte row strides), every
base 16-byte aligned.  It allocates the output with ``torch.empty``,
launches on the current stream and counts the launch in ``launches``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

ALIGN = 4  # n and k: multiples of 4 f32 (16 bytes)
TILE = 128  # the kernel's output tile, 128 x 128


def _shape(a: torch.Tensor, w_hi: torch.Tensor, w_lo: torch.Tensor) -> tuple[int, int, int]:
    """(m, n, k) of a product the kernel takes; raises on anything else."""
    for t, name in ((a, "a"), (w_hi, "w_hi"), (w_lo, "w_lo")):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    if w_hi.dim() != 2 or w_lo.shape != w_hi.shape:
        raise ValueError(f"w_hi and w_lo must both be (n, k), got {tuple(w_hi.shape)} "
                         f"and {tuple(w_lo.shape)}")
    n, k = w_hi.shape
    if a.dim() < 1 or a.shape[-1] != k:
        raise ValueError(f"a (..., {k}) expected for planes of (n, k) = ({n}, {k}), "
                         f"got {tuple(a.shape)}")
    if not (k > 0 and n > 0 and k % ALIGN == 0 and n % ALIGN == 0):
        raise ValueError(f"the f32 GEMM kernel takes n and k multiples of {ALIGN}, "
                         f"got n={n}, k={k}")
    m = math.prod(a.shape[:-1])
    if m >= 2**31 - TILE or -(-m // TILE) * -(-n // TILE) >= 2**31:
        raise ValueError(f"the f32 GEMM kernel takes fewer than 2**31 rows and output tiles "
                         f"of {TILE} x {TILE}, got ({m}, {n})")
    for t, name in ((a, "a"), (w_hi, "w_hi"), (w_lo, "w_lo")):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start at a 16-byte aligned address")
    return m, n, k


def matmul_f32_cuda(a: torch.Tensor, w_hi: torch.Tensor, w_lo: torch.Tensor) -> torch.Tensor:
    """a (..., k) f32 @ w (k, n), w given as its planes w_hi, w_lo (n, k)
    -> (..., n) f32."""
    m, n, k = _shape(a, w_hi, w_lo)
    out = torch.empty((*a.shape[:-1], n), dtype=torch.float32, device=a.device)
    if m:
        err = _build.lib().seifer_gemm_f32(
            a.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(), out.data_ptr(), m, n, k,
            torch.cuda.current_stream(a.device).cuda_stream)
        _build.check(err, "matmul_f32")
        matmul_f32_cuda.launches += 1
    return out


matmul_f32_cuda.launches = 0
