"""Wrappers of the CUDA flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and the backward (``csrc/flash_attention_bwd.cu``).

Each checks what its kernel takes and raises on anything else: float32 CUDA
tensors, self-attention (``Sq == Skv``), ``hd`` in ``HEAD_DIMS`` (every
head dim of the LM zoo's configs: 64, 80, 112, 128, 160, 256),
``H`` a multiple of ``KH``, and q, k, v rows whose (heads, hd) block is
packed and 16-byte aligned (the kernels stage rows by 16-byte ``cp.async``
copies) -- the batch and sequence strides may be anything else that keeps
rows aligned, so the q/k/v slices of a fused projection go in without a
copy.  The backward's o and dO must be contiguous (B, S, H, hd) and its lse
a contiguous (B, H, S) f32 tensor.  Outputs are new contiguous tensors.

``flash_attention_cuda`` counts its launches in ``launches`` (and those
with a sliding window also in ``launches_windowed``); with ``lse=True`` it
also returns each row's logsumexp, the residual of the backward.
``flash_attention_bwd_cuda`` counts its launches (one call runs its three
kernels: D = rowsum(o dO), dK/dV, dQ) in ``launches``, and those with a
window also in ``launches_windowed``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 80, 112, 128, 160, 256)
# the backward's tiles (csrc/flash_attention_bwd.cu, Cfg): rows a block
# owns (keys in the dK/dV kernel, queries in the dQ kernel) by head dim, and
# the rows of the tiles each streams past them
BWD_ROWS = {64: 64, 80: 64, 112: 128, 128: 128, 160: 64, 256: 32}
BWD_TILE = 32


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
    if t.data_ptr() % 16 or t.stride(0) % 4 or t.stride(1) % 4:
        raise ValueError(f"{name}: rows must start on 16-byte boundaries, got "
                         f"address {t.data_ptr():#x} and strides {t.stride()}")


def _require_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[int, ...]:
    """Check q, k, v as both kernels take them; returns (B, S, H, KH, hd)."""
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
    if -(-s // 64) > 65535 or b * h >= 2**31:
        raise ValueError(f"kernel grid takes S <= {65535 * 64} and B*H < 2**31, "
                         f"got S={s}, B*H={b * h}")
    return b, s, h, kh, hd


def _strides(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[int, ...]:
    return q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1)


def flash_attention_cuda(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, KH, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """o (B, S, H, hd) f32; with ``lse=True``, (o, lse (B, H, S) f32)."""
    b, s, h, kh, hd = _require_qkv(q, k, v)
    o = torch.empty((b, s, h, hd), dtype=torch.float32, device=q.device)
    lse_t = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if lse else None
    if b and s:
        err = _build.lib().seifer_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse_t is None else lse_t.data_ptr(),
            b, s, h, kh, hd, *_strides(q, k, v),
            int(bool(causal)), int(window), float(softcap), float(hd**-0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, "flash_attention_fwd")
        flash_attention_cuda.launches += 1
        if window > 0:
            flash_attention_cuda.launches_windowed += 1
    return (o, lse_t) if lse else o


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_windowed = 0


def flash_attention_bwd_cuda(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, KH, hd)
    v: torch.Tensor,
    o: torch.Tensor,  # (B, S, H, hd), the forward's output
    lse: torch.Tensor,  # (B, H, S), the forward's logsumexp
    do: torch.Tensor,  # (B, S, H, hd), the output's cotangent
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), f32 and contiguous, in the shapes of q, k, v."""
    b, s, h, kh, hd = _require_qkv(q, k, v)
    if -(-s // BWD_ROWS[hd]) > 65535:
        raise ValueError(f"backward grid takes S <= {65535 * BWD_ROWS[hd]} at hd {hd}, got S={s}")
    for t, name, shape in ((o, "o", q.shape), (do, "do", q.shape), (lse, "lse", (b, h, s))):
        if t.device != q.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {q.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(shape)} tensor, got "
                             f"{tuple(t.shape)} with strides {t.stride()}")
    dq = torch.empty((b, s, h, hd), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, s, kh, hd), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    dsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)  # D = rowsum(o dO)
    if b and s:
        err = _build.lib().seifer_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, h, kh, hd, *_strides(q, k, v),
            int(bool(causal)), int(window), float(softcap), float(hd**-0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, "flash_attention_bwd")
        flash_attention_bwd_cuda.launches += 1
        if window > 0:
            flash_attention_bwd_cuda.launches_windowed += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.launches_windowed = 0
