"""The split-precision arithmetic of the tensor-core kernels, in plain PyTorch.

``csrc/flash_attention.cu`` and ``csrc/quantize.cu`` (dequant_matmul) take
their products on the TF32 tensor cores.  One TF32 pass keeps 10 mantissa
bits, too few for the f32 pins, so each f32 operand x is split into
``hi = tf32_rna(x)`` and ``lo = tf32_rna(x - hi)`` and a product is
``a_lo.b_hi + a_hi.b_lo + a_hi.b_hi`` (3 passes).  int8 codes are exact in
TF32, so dequant_matmul takes ``q.w_lo + q.w_hi`` (2 passes) per
quantisation block and scales each block's sum by its scale.

This module models that arithmetic with every product exact and every sum
rounded to nearest (an f32 matmul with TF32 off): it is what the scheme
costs in accuracy, apart from the order and rounding of the tensor cores'
own accumulation, which the card adds.  It also models the bf16 routes the
bounds in ``chip_smoke.py`` weigh (``split_bf16``).  The served path never
calls it; ``tests/test_torch_split_precision.py`` and ``chip_smoke.py
--profile`` do.
"""

from __future__ import annotations

import torch

TF32_LOW_BITS = 0x1FFF  # the 13 mantissa bits TF32 drops


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32, to nearest with ties away from zero (``cvt.rna``):
    add half of the dropped range to the magnitude bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~TF32_LOW_BITS).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x as TF32 hi + lo, 21 bits of it."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def split_bf16(x: torch.Tensor, pieces: int) -> list[torch.Tensor]:
    """x as a sum of ``pieces`` bf16 values (round to nearest even), largest
    first: two keep 16 bits of x, three all 24."""
    out, rest = [], x
    for _ in range(pieces):
        part = rest.to(torch.bfloat16).to(torch.float32)
        out.append(part)
        rest = rest - part
    return out


def matmul_split3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32-accurate a @ b from three TF32 products, small terms first."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 pass: what the tensor cores give without the split."""
    return tf32_rna(a) @ tf32_rna(b)


def matmul_bf16x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from two bf16 pieces of each operand, three bf16 products."""
    ah, al = split_bf16(a, 2)
    bh, bl = split_bf16(b, 2)
    return al @ bh + ah @ bl + ah @ bh


def attention_emulated(q, k, v, *, causal, window, softcap, matmul=matmul_split3):
    """The flash kernel's arithmetic: q pre-scaled by hd^-0.5, S = Q K^T and
    O = P V through ``matmul``, P = exp(s - rowmax) unnormalised, O / l."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    qg = (q * hd**-0.5).reshape(b, s, kh, h // kh, hd).permute(0, 2, 3, 1, 4)
    logits = matmul(qg, k.permute(0, 2, 3, 1)[:, :, None])  # (b, kh, g, s, s)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= pos[:, None] >= pos[None, :]
    if window > 0:
        ok &= pos[:, None] - pos[None, :] < window
    logits = logits.masked_fill(~ok, float("-inf"))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    o = matmul(p, v.permute(0, 2, 1, 3)[:, :, None]) / p.sum(-1, keepdim=True)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)


def dequant_matmul_emulated(q, scale, w, block, w_pieces=None):
    """The fused receive's arithmetic: per quantisation block, the codes
    (exact in TF32 and in bf16) times each piece of w, small pieces first,
    summed; the block's sum scaled by its scale into the output.  w is
    split as the kernel splits it (TF32 hi + lo), or into ``w_pieces`` bf16
    pieces."""
    codes = q.to(torch.float32)
    parts = split(w)[::-1] if w_pieces is None else split_bf16(w, w_pieces)[::-1]
    out = torch.zeros((q.shape[0], w.shape[1]), dtype=torch.float32, device=w.device)
    for blk, k0 in enumerate(range(0, q.shape[1], block)):
        c = codes[:, k0:k0 + block]
        part = sum(c @ p[k0:k0 + block] for p in parts)
        out = torch.addcmul(out, scale[:, blk:blk + 1], part)
    return out
