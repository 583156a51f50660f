"""Flash attention with its gradient, dispatched by the tensors' device.

``FlashAttention`` is the JAX package's custom VJP
(``src/repro/kernels/flash_attention/ops.py``) as a
``torch.autograd.Function``: its forward keeps only O(S) residuals (q, k, v,
the output and each row's logsumexp) and its backward recomputes the
probabilities tile by tile.  The same Function runs on both devices:

- CUDA tensors go to the hand-written kernels (``kernel.py``): the forward,
  which masks ragged sequence edges itself, and the backward.  There is no
  fall-through for shapes they cannot tile: such a shape raises.
- CPU tensors go to the plain versions (``ref.py``): ``attention_ref_lse``
  and ``flash_backward_ref``.

The kernels compute in f32: bf16 or f16 q, k, v are upcast for them
(exactly) outside the Function and the output is cast to ``q.dtype``, as
the JAX op computes f32 scores and returns ``q.dtype``; autograd rounds the
gradients back through those casts.  The CPU path takes the same casts, so
the Function always sees f32.  Where no gradient is wanted (serving:
``torch.no_grad()``, ``inference_mode``, or inputs that do not require
grad) the forward runs without writing the logsumexp, and a CPU tensor goes
straight to ``attention_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.core.execution import on_kernel_path
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    attention_ref_lse,
    flash_backward_ref,
)


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) over f32 (B, S, H, hd) tensors; the backward
    returns (dq, dk, dv) from the saved q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, softcap: float):
        if on_kernel_path(q, k, v):
            o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                          softcap=softcap, lse=True)
        else:
            o, lse = attention_ref_lse(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = dict(causal=causal, window=window, softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if on_kernel_path(q, k, v, do):
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse, do.contiguous(),
                                                  **ctx.mask)
        else:
            dq, dk, dv = flash_backward_ref(q, k, v, o, lse, do, **ctx.mask)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KH, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Attention over the (B, S, H, hd) layout: GQA (H = G*KH), causal and
    sliding-``window`` masks, logit ``softcap``, ``hd**-0.5`` scaling;
    differentiable in q, k and v."""
    cuda = on_kernel_path(q, k, v)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        if cuda:
            o = flash_attention_cuda(*(t.float() for t in (q, k, v)), causal=causal,
                                     window=window, softcap=softcap)
            return o.to(q.dtype)
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    o = FlashAttention.apply(q.float(), k.float(), v.float(), causal, window, softcap)
    return o.to(q.dtype)
