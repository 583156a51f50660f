"""Plain PyTorch attention: naive softmax with GQA/causal/window/softcap,
the forward with its logsumexp, and the flash backward's formula.

Materializes the full (Sq, Skv) logits -- use only at test shapes, or one
kv-head group at a time at served shapes.  Computes in f32, or in f64 for
f64 inputs (an exact yardstick for the f32 versions and the kernels).
"""

from __future__ import annotations

import torch


NEG_INF = -1e30  # masked logits, as the JAX backward (``ops._NEG_INF``) writes them


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _mask(sq: int, skv: int, causal: bool, window: int, device, q_offset: int = 0) -> torch.Tensor:
    """(Sq, Skv) bool: True where a query may attend to a key."""
    qpos = q_offset + torch.arange(sq, device=device)
    kpos = torch.arange(skv, device=device)
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        ok &= qpos[:, None] - kpos[None, :] < window
    return ok


def _logits(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int, softcap: float,
            q_offset: int = 0) -> torch.Tensor:
    """(B, KH, G, Sq, Skv) f32: the scaled, capped logits of each query head
    against its kv head, -inf where masked."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    ct = _compute_dtype(q)
    qg = q.reshape(b, sq, kh, h // kh, hd).to(ct) * hd**-0.5
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg, k.to(ct))
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits.masked_fill(~_mask(sq, skv, causal, window, q.device, q_offset),
                              float("-inf"))


def _weighted(w: torch.Tensor, v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, Sq, H, hd) in ``dtype``: the weights (B, KH, G, Sq, Skv) times v."""
    o = torch.einsum("bhgqs,bshk->bqhgk", w, v.to(w.dtype))
    b, sq, kh, g, hd = o.shape
    return o.reshape(b, sq, kh * g, hd).to(dtype)


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
    logits = _logits(q, k, causal, window, softcap, q_offset)
    return _weighted(torch.softmax(logits, dim=-1), v, q.dtype)


def attention_ref_lse(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, Skv, KH, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``attention_ref`` and its logsumexp: (o in q.dtype, lse (B, H, S) f32).

    lse is the log of each row's softmax denominator over the capped, scaled
    logits (the residual the flash backward recomputes probabilities from)."""
    b, sq, h, _ = q.shape
    logits = _logits(q, k, causal, window, softcap)
    lse = torch.logsumexp(logits, dim=-1)  # (B, KH, G, S)
    return _weighted(torch.exp(logits - lse[..., None]), v, q.dtype), lse.reshape(b, h, sq)


def flash_backward_ref(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, Skv, KH, hd)
    v: torch.Tensor,
    o: torch.Tensor,  # (B, S, H, hd), the forward's output
    lse: torch.Tensor,  # (B, H, S) f32
    do: torch.Tensor,  # (B, S, H, hd), the output's cotangent
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in f32 (f64 for f64 q): the JAX package's ``_bwd_block``
    written densely (``src/repro/kernels/flash_attention/ops.py``), not
    obtained by autograd.

    s = q.k scale, capped c tanh(s / c), masked to -1e30; p = exp(capped -
    lse); D = rowsum(o do); ds = p (dp - D) (1 - (capped / c)^2); dk and dv
    summed over the G query heads of each kv head; scale applied to dq and
    dk.  Materializes (B, H, S, Skv) f32 several times over: test shapes, or
    one kv-head group at a time."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = hd**-0.5
    ct = _compute_dtype(q)
    qg = q.reshape(b, sq, kh, g, hd).to(ct)
    dog = do.reshape(b, sq, kh, g, hd).to(ct)
    kf, vf = k.to(ct), v.to(ct)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, kf) * scale
    if softcap > 0:
        capped = softcap * torch.tanh(s / softcap)
        dcap = 1.0 - (capped / softcap) ** 2
    else:
        capped, dcap = s, None
    capped = capped.masked_fill(~_mask(sq, skv, causal, window, q.device), NEG_INF)
    p = torch.exp(capped - lse.reshape(b, kh, g, sq)[..., None].to(ct))
    dp = torch.einsum("bqhgd,bshd->bhgqs", dog, vf)
    d = (o.to(ct) * do.to(ct)).sum(-1).reshape(b, sq, kh, g).permute(0, 2, 3, 1)
    ds = p * (dp - d[..., None])
    if dcap is not None:
        ds = ds * dcap
    dv = torch.einsum("bhgqs,bqhgd->bshd", p, dog)
    dk = torch.einsum("bhgqs,bqhgd->bshd", ds, qg) * scale
    dq = torch.einsum("bhgqs,bshd->bqhgd", ds, kf) * scale
    return dq.reshape(b, sq, h, hd), dk, dv
