"""Wrappers of the CUDA int8 codec kernels (``csrc/quantize.cu``).

Each wrapper checks what its kernel takes (a CUDA tensor of the right dtype,
contiguous, of matching shapes) and raises on anything else, allocates the
outputs with ``torch.empty``, launches on the current stream, and counts the
launch in its ``launches`` attribute.  The kernel library is built at the
first call (``kernels._build``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quantize.ref import block_of

_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _require(t: torch.Tensor, name: str, dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _codes_layout(q: torch.Tensor, scale: torch.Tensor, block: int | None):
    """(rows, d, nb, block) of int8 codes q (..., d) with scales (..., nb)."""
    _require(q, "q", torch.int8)
    _require(scale, "scale", torch.float32)
    *lead, d = q.shape
    nb = scale.shape[-1]
    block = block_of(d, nb, block)
    if tuple(scale.shape) != (*lead, -(-d // block)):
        raise ValueError(f"scale shape {tuple(scale.shape)} does not match q "
                         f"{tuple(q.shape)} at block {block}")
    return math.prod(lead), d, nb, block


def quantize_int8_cuda(x: torch.Tensor, block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., d) f32/bf16 -> (int8 (..., d), f32 scales (..., ceil(d/block)))."""
    _require(x, "x", tuple(_IN_DTYPES))
    *lead, d = x.shape
    if block < 1 or d < 1:
        raise ValueError(f"need block >= 1 and d >= 1, got block={block}, d={d}")
    nb = -(-d // block)
    n = math.prod(lead)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((*lead, nb), dtype=torch.float32, device=x.device)
    if n:
        err = _build.lib().seifer_quantize_int8(
            x.data_ptr(), _IN_DTYPES[x.dtype], q.data_ptr(), s.data_ptr(),
            n, d, block, nb, _stream(x))
        _build.check(err, "quantize_int8")
        quantize_int8_cuda.launches += 1
    return q, s


def dequantize_int8_cuda(
    q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16,
    block: int | None = None,
) -> torch.Tensor:
    """``q * scale`` per block -> ``dtype`` (float32 or bfloat16)."""
    if dtype not in _IN_DTYPES:
        raise TypeError(f"dequantize kernel writes float32 or bfloat16, not {dtype}")
    n, d, nb, block = _codes_layout(q, scale, block)
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    if n:
        err = _build.lib().seifer_dequantize_int8(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), _IN_DTYPES[dtype],
            n, d, block, nb, _stream(q))
        _build.check(err, "dequantize_int8")
        dequantize_int8_cuda.launches += 1
    return out


def dequant_matmul_cuda(
    q: torch.Tensor, scale: torch.Tensor, w: torch.Tensor, dtype=None,
    block: int | None = None,
) -> torch.Tensor:
    """``dequant(q, scale) @ w`` in one kernel: q (..., d) int8, w (d, dout)
    float32 -> (..., dout), accumulated in f32 and cast to ``dtype``
    (default ``w.dtype``)."""
    _require(w, "w", torch.float32)
    n, d, nb, block = _codes_layout(q, scale, block)
    if w.dim() != 2 or w.shape[0] != d:
        raise ValueError(f"w must be ({d}, dout), got {tuple(w.shape)}")
    dout = w.shape[1]
    if -(-n // 128) > 65535:
        raise ValueError(f"dequant_matmul kernel takes at most {65535 * 128} rows, got {n}")
    out = torch.empty((*q.shape[:-1], dout), dtype=torch.float32, device=q.device)
    if n and dout:
        err = _build.lib().seifer_dequant_matmul(
            q.data_ptr(), scale.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, d, dout, block, nb, _stream(q))
        _build.check(err, "dequant_matmul")
        dequant_matmul_cuda.launches += 1
    want = w.dtype if dtype is None else dtype
    return out if want == torch.float32 else out.to(want)


quantize_int8_cuda.launches = 0
dequantize_int8_cuda.launches = 0
dequant_matmul_cuda.launches = 0
