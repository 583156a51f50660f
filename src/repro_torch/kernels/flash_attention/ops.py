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

Both devices reach the kernels and plain versions through three custom ops
(``torch.ops.repro_torch.flash_attention_fwd``, ``..._fwd_lse``,
``..._bwd``), so fake tensors and DTensors reach them too (``library.py``):
each has a fake implementation, a cost (4 hd FLOPs a live pair forward, 10
backward, ``kernels/costs.py``) and a sharding rule.  The rule shards the
batch, or the heads, or both over different mesh dims, where q and k/v
shard their heads alike: each rank's q heads then map to its own kv heads
(H and KH divide evenly, so GQA groups stay whole).  Where the policy
shards q's heads but replicates k/v (KV heads that do not divide the
axis), the rule asks for replicated heads, since the kernel on local q
heads against all kv heads would map the groups wrongly.
"""

from __future__ import annotations

import torch

from repro_torch.core.execution import on_kernel_path
from repro_torch.kernels import costs
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    attention_ref_lse,
    flash_backward_ref,
)
from repro_torch.kernels.library import (
    fake_empty,
    register_cost,
    register_dtensor_rule,
)

Tensor = torch.Tensor


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
                        softcap: float, scale: float | None = None) -> Tensor:
    """o (B, S, H, hd): the forward kernel on CUDA tensors, ``attention_ref``
    on CPU tensors (in their own dtype); logits scaled by ``scale``, or
    hd^-0.5 when it is None."""
    if on_kernel_path(q, k, v):
        return flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap,
                                    scale=scale)
    return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)


@torch.library.custom_op("repro_torch::flash_attention_fwd_lse", mutates_args=())
def flash_attention_fwd_lse(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
                            softcap: float) -> tuple[Tensor, Tensor]:
    """(o, lse (B, H, S) f32): the forward kernel writing each row's
    logsumexp, or ``attention_ref_lse``."""
    if on_kernel_path(q, k, v):
        return flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap,
                                    lse=True)
    return attention_ref_lse(q, k, v, causal=causal, window=window, softcap=softcap)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor, do: Tensor,
                        causal: bool, window: int, softcap: float
                        ) -> tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv): the backward kernel, or ``flash_backward_ref``."""
    if on_kernel_path(q, k, v, do):
        return flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal, window=window,
                                        softcap=softcap)
    return flash_backward_ref(q, k, v, o, lse, do, causal=causal, window=window,
                              softcap=softcap)


@flash_attention_fwd.register_fake
def _(q, k, v, causal, window, softcap, scale=None):
    return fake_empty(q, q.shape)


@flash_attention_fwd_lse.register_fake
def _(q, k, v, causal, window, softcap):
    b, s, h, _ = q.shape
    return fake_empty(q, q.shape), fake_empty(q, (b, h, s), torch.float32)


@flash_attention_bwd.register_fake
def _(q, k, v, o, lse, do, causal, window, softcap):
    return fake_empty(q, q.shape), fake_empty(k, k.shape), fake_empty(v, v.shape)


def _fwd_cost(q, k, v, causal, window, softcap, scale=None, *, lse=False):
    b, s, h, hd = q.shape
    return (costs.flash_fwd_flops(b, s, h, hd, causal=causal, window=window),
            costs.flash_fwd_bytes(b, s, h, k.shape[2], hd, lse=lse))


def _bwd_cost(q, k, v, o, lse, do, causal, window, softcap):
    b, s, h, hd = q.shape
    return (costs.flash_bwd_flops(b, s, h, hd, causal=causal, window=window),
            costs.flash_bwd_bytes(b, s, h, k.shape[2], hd))


register_cost(torch.ops.repro_torch.flash_attention_fwd.default, _fwd_cost)
register_cost(torch.ops.repro_torch.flash_attention_fwd_lse.default,
              lambda *a: _fwd_cost(*a, lse=True))
register_cost(torch.ops.repro_torch.flash_attention_bwd.default, _bwd_cost)
# one mesh dim's placements: outputs, then inputs; batch (dim 0) or heads
# (dim 2 of q, k, v, o, dO; dim 1 of the (B, H, S) logsumexp)
register_dtensor_rule(torch.ops.repro_torch.flash_attention_fwd.default,
                      ["R R R R", "S0 S0 S0 S0", "S2 S2 S2 S2"], n_out=1, static_argnum=3)
register_dtensor_rule(torch.ops.repro_torch.flash_attention_fwd_lse.default,
                      ["R R R R R", "S0 S0 S0 S0 S0", "S2 S1 S2 S2 S2"], n_out=2,
                      static_argnum=3)
register_dtensor_rule(torch.ops.repro_torch.flash_attention_bwd.default,
                      [" ".join("R" * 9), " ".join(["S0"] * 9),
                       "S2 S2 S2 S2 S2 S2 S2 S1 S2"], n_out=3, static_argnum=6)


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) over f32 (B, S, H, hd) tensors; the backward
    returns (dq, dk, dv) from the saved q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, softcap: float):
        o, lse = flash_attention_fwd_lse(q, k, v, causal, window, softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if on_kernel_path(q, k, v, do):
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, *ctx.mask)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KH, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention over the (B, S, H, hd) layout: GQA (H = G*KH), causal and
    sliding-``window`` masks, logit ``softcap``, logits scaled by ``scale``
    (``hd**-0.5`` when None); differentiable in q, k and v at the default
    scale."""
    cuda = on_kernel_path(q, k, v)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        if cuda:
            o = flash_attention_fwd(q.float(), k.float(), v.float(), causal, window, softcap,
                                    scale)
            return o.to(q.dtype)
        return flash_attention_fwd(q, k, v, causal, window, softcap, scale)
    if scale is not None:
        raise ValueError("a given scale is served by the forward only: the backward "
                         "scales by hd**-0.5")
    o = FlashAttention.apply(q.float(), k.float(), v.float(), causal, window, softcap)
    return o.to(q.dtype)
