"""Plain PyTorch attention: naive softmax with GQA/causal/window/softcap.

Materializes the full (Sq, Skv) logits -- use only at test shapes, or one
kv-head group at a time at served shapes.
"""

from __future__ import annotations

import torch


def attention_ref(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KH, hd)
    v: torch.Tensor,  # (B, Skv, KH, hd)
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, hd).to(torch.float32) * hd**-0.5
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg, k.to(torch.float32))
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        ok &= qpos[:, None] - kpos[None, :] < window
    logits = logits.masked_fill(~ok, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqs,bshk->bqhgk", w, v.to(torch.float32))
    return o.reshape(b, sq, h, hd).to(q.dtype)
