"""Wrapper of the CUDA flash-attention forward kernel (``csrc/flash_attention.cu``).

Checks what the kernel takes and raises on anything else: float32 CUDA
tensors, self-attention (``Sq == Skv``), ``hd`` in {64, 128, 256},
``H`` a multiple of ``KH``, and rows whose (heads, hd) block is packed --
the batch and sequence strides may be anything, so the q/k/v slices of a
fused projection go in without a copy.  The output is a new contiguous
(B, S, H, hd) tensor; the launch is counted in ``launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 128, 256)


def _require_rows(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 4:
        raise ValueError(f"{name} must be (B, S, heads, hd), got {tuple(t.shape)}")
    if t.stride(3) != 1 or t.stride(2) != t.shape[3]:
        raise ValueError(f"{name}: each row's (heads, hd) block must be packed, "
                         f"got strides {t.stride()}")


def flash_attention_cuda(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, KH, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _require_rows(t, name)
    b, s, h, hd = q.shape
    kh = k.shape[2]
    if tuple(k.shape) != (b, s, kh, hd) or tuple(v.shape) != (b, s, kh, hd):
        raise ValueError(f"k/v must be ({b}, {s}, KH, {hd}) self-attention, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"kernel takes hd in {HEAD_DIMS}, got {hd}")
    if kh < 1 or h % kh:
        raise ValueError(f"heads {h} must be a multiple of kv heads {kh}")
    if h > 65535 or b > 65535:
        raise ValueError("kernel grid takes at most 65535 heads and batch rows")
    o = torch.empty((b, s, h, hd), dtype=torch.float32, device=q.device)
    if b and s:
        err = _build.lib().seifer_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, s, h, kh, hd,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1),
            int(bool(causal)), int(window), float(softcap), float(hd**-0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, "flash_attention_fwd")
        flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0
