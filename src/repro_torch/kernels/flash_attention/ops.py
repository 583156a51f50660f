"""Flash-attention forward, dispatched by the tensors' device.

A CUDA tensor always goes to the hand-written kernel, which masks ragged
sequence edges itself, so there is no fall-through for shapes it cannot tile:
a shape it cannot take raises.  The kernel computes in f32: bf16 or f16 q,
k, v are upcast for it (exactly) and the output is cast to ``q.dtype``, as
the JAX op computes f32 scores and returns ``q.dtype``.  A CPU tensor goes
to the plain ``attention_ref``.  Forward only: the gradient (the JAX
package's custom VJP) comes with the training slice.
"""

from __future__ import annotations

import torch

from repro_torch.core.execution import on_kernel_path
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


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
    sliding-``window`` masks, logit ``softcap``, ``hd**-0.5`` scaling."""
    if on_kernel_path(q, k, v):
        o = flash_attention_cuda(*(t.float() for t in (q, k, v)), causal=causal,
                                 window=window, softcap=softcap)
        return o.to(q.dtype)
    return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
