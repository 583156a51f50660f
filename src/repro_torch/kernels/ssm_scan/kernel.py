"""Wrapper of the CUDA chunked SSD scan kernel (``csrc/ssd_scan.cu``).

Checks what the kernel takes and raises on anything else: contiguous
float32 CUDA tensors xs (B, S, H, dh), bm and cm (B, S, N), dt (B, S, H),
a (H,), with dh and N at most 64.  ``chunk`` keeps the JAX package's
precondition (``q = min(chunk, S)`` must divide S, else ``ValueError``), but
the kernel tiles at its own ``KERNEL_CHUNK`` rows whatever chunk the caller
asks for: the scan is chunk-invariant, and a Q x Q score tile at the
demo model's ``chunk=seq`` would not fit a block.  A ragged last chunk is
masked inside the kernel.  The output is a new (B, S, H, dh) f32 tensor;
the launch is counted in ``launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan.ref import chunk_of

KERNEL_CHUNK = 64  # rows per chunk inside the kernel (Q in ssd_scan.cu)
MAX_WIDTH = 64  # largest dh and N the kernel's shared tiles hold


def _require(t: torch.Tensor, name: str, shape: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ssd_chunked_cuda(
    xs: torch.Tensor,  # (B, S, H, dh)
    bm: torch.Tensor,  # (B, S, N)
    cm: torch.Tensor,  # (B, S, N)
    dt: torch.Tensor,  # (B, S, H)
    a: torch.Tensor,  # (H,)
    *,
    chunk: int = 128,
) -> torch.Tensor:
    if xs.dim() != 4 or bm.dim() != 3:
        raise ValueError(f"xs must be (B, S, H, dh) and bm (B, S, N), got "
                         f"{tuple(xs.shape)} / {tuple(bm.shape)}")
    b, s, h, dh = xs.shape
    n = bm.shape[-1]
    for t, name, shape in ((xs, "xs", (b, s, h, dh)), (bm, "bm", (b, s, n)),
                           (cm, "cm", (b, s, n)), (dt, "dt", (b, s, h)),
                           (a, "a", (h,))):
        _require(t, name, shape)
    if s:
        chunk_of(s, chunk)
    if not (1 <= dh <= MAX_WIDTH and 1 <= n <= MAX_WIDTH):
        raise ValueError(f"kernel takes dh and N in 1..{MAX_WIDTH}, got dh={dh}, N={n}")
    if b > 65535:
        raise ValueError("kernel grid takes at most 65535 batch rows")
    y = torch.empty((b, s, h, dh), dtype=torch.float32, device=xs.device)
    if b and s and h:
        err = _build.lib().seifer_ssd_scan(
            xs.data_ptr(), bm.data_ptr(), cm.data_ptr(), dt.data_ptr(),
            a.data_ptr(), y.data_ptr(), b, s, h, dh, n,
            torch.cuda.current_stream(xs.device).cuda_stream)
        _build.check(err, "ssd_scan")
        ssd_chunked_cuda.launches += 1
    return y


ssd_chunked_cuda.launches = 0
