"""Plain PyTorch version of blockwise int8 quantization (boundary compression).

Each ``block``-wide slice of the trailing dim gets an f32 scale
``max|x| * f32(1/127)`` and int8 codes ``clip(round(x / max(scale, 1e-12)),
-127, 127)``.  This is the function the CUDA kernels in ``csrc/quantize.cu``
compute; the CPU tests run it, and ``chip_smoke.py`` holds the kernels
against it on the card.

A trailing dim that does not divide ``block`` is zero-padded to the next
block boundary (a ragged last block); padding zeros never raise a block's
max-abs, so the scales equal an exact ragged computation.  ``torch.round``
rounds half to even, as ``jnp.round`` does, so the codes match the JAX
reference byte for byte.

``INT8_MAX_REL_ERROR`` is the codec's contract: the round-trip error of any
element is at most ``scale / 2 = max|x_block| / 254``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# max |dequant(quant(x)) - x| / max|x_block|: round-off is half a step of
# size scale = max/127, so 0.5/127 (plus f32 rounding slack in the tests).
INT8_MAX_REL_ERROR = 0.5 / 127.0


def _pad_to_block(x: torch.Tensor, block: int) -> tuple[torch.Tensor, int]:
    """Zero-pad the trailing dim up to a block multiple; returns (x, nb)."""
    d = x.shape[-1]
    nb = -(-d // block)
    pad = nb * block - d
    if pad:
        x = F.pad(x, (0, pad))
    return x, nb


def quantize_ref(x: torch.Tensor, block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., d) -> (q int8 (..., d), scales f32 (..., ceil(d/block)))."""
    *lead, d = x.shape
    xp, nb = _pad_to_block(x.to(torch.float32), block)
    xb = xp.reshape(*lead, nb, block)
    # max/127 as a multiply by f32(1/127): what the JAX package computes
    # where it serves (XLA rewrites the division by a constant inside jit and
    # inside the Pallas kernel), and what the CUDA kernel computes
    scale = xb.abs().amax(dim=-1) * (1.0 / 127.0)
    safe = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(xb / safe[..., None]), -127, 127).to(torch.int8)
    return q.reshape(*lead, nb * block)[..., :d].contiguous(), scale


def block_of(d: int, nb: int, block: int | None) -> int:
    """The quantization block of a (..., d) code tensor with ``nb`` scales.

    ``block`` may be omitted only when ``d`` divides the scale count exactly
    (no ragged last block)."""
    if block is not None:
        return block
    if d % nb:
        raise ValueError(
            f"trailing dim {d} is ragged over {nb} scale blocks; "
            f"pass the block= used to quantize"
        )
    return d // nb


def dequantize_ref(
    q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16,
    block: int | None = None,
) -> torch.Tensor:
    """Inverse of ``quantize_ref``: ``q * scale`` per block, cast to ``dtype``."""
    *lead, d = q.shape
    nb = scale.shape[-1]
    block = block_of(d, nb, block)
    qp, _ = _pad_to_block(q, block)
    xb = qp.reshape(*lead, nb, block).to(torch.float32) * scale[..., None]
    return xb.reshape(*lead, nb * block)[..., :d].to(dtype).contiguous()


def dequant_matmul_ref(
    q: torch.Tensor,
    scale: torch.Tensor,
    w: torch.Tensor,
    dtype=None,
    block: int | None = None,
) -> torch.Tensor:
    """``dequantize_ref(q, scale) @ w`` in one f32 pass.

    ``q`` is (..., d) int8 with blockwise ``scale`` (..., ceil(d/block));
    ``w`` is (d, dout).  The product is accumulated in f32 and cast to
    ``dtype`` (default: ``w.dtype``)."""
    x = dequantize_ref(q, scale, dtype=torch.float32, block=block)
    out = x @ w.to(torch.float32)
    return out.to(w.dtype if dtype is None else dtype)
