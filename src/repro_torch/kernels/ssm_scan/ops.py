"""Chunked SSD (Mamba2) scan with its gradient, dispatched by the tensors'
device.

A CUDA tensor always goes to the hand-written kernels, which tile at their
own chunk and mask a ragged last chunk themselves, so nothing falls
through: a shape they cannot take raises.  A CPU tensor goes to the plain
versions at the caller's ``chunk``.  The JAX package's
``use_pallas``/``interpret`` knob is the tensors' device here.

Where a gradient is wanted (grad mode on and a floating input requiring
grad) the scan runs as ``SSDScan``, whose forward keeps only its inputs
(the backward recomputes the chunk states, so a rematerialized layer holds
nothing more) and whose backward runs ``ssd_chunked_bwd_cuda`` on CUDA and
``ssd_backward_ref`` on the CPU.  The JAX package differentiates its jnp
scan with ``jax.grad``; the CPU tests hold the two gradients together.
Otherwise (serving) the forward runs directly.

Both devices reach the kernels and plain versions through two custom ops
(``torch.ops.repro_torch.ssd_chunked_fwd`` and ``..._bwd``), so fake
tensors and DTensors reach them too (``kernels/library.py``): each has a
fake implementation, a cost (``ssd_flops`` / ``ssd_bwd_flops`` at the
cheapest chunking, ``kernels/costs.py``) and a sharding rule.  The scan
shards batch and heads (xs and dt on their head dim, a on its only one);
B and C stay replicated across heads, and their gradients, summed over the
heads, come out as partial sums where the heads are sharded (and da where
the batch is).  Grouped B and C ((B, S, G, N), Zamba2-7B's mixer) are
served only, and only unsharded: the rule's head sharding assumes one
group.
"""

from __future__ import annotations

import torch

from repro_torch.core.execution import on_kernel_path
from repro_torch.kernels import costs
from repro_torch.kernels.library import (
    fake_empty,
    register_cost,
    register_dtensor_rule,
)
from repro_torch.kernels.ssm_scan.kernel import ssd_chunked_bwd_cuda, ssd_chunked_cuda
from repro_torch.kernels.ssm_scan.ref import ssd_backward_ref, ssd_ref

Tensor = torch.Tensor


@torch.library.custom_op("repro_torch::ssd_chunked_fwd", mutates_args=())
def ssd_chunked_fwd(xs: Tensor, bm: Tensor, cm: Tensor, dt: Tensor, a: Tensor,
                    chunk: int) -> Tensor:
    """y (B, S, H, dh) f32: the forward kernel on CUDA tensors, ``ssd_ref``
    at ``chunk`` on CPU tensors."""
    if on_kernel_path(xs, bm, cm, dt, a):
        return ssd_chunked_cuda(xs, bm, cm, dt, a, chunk=chunk)
    return ssd_ref(xs, bm, cm, dt, a, chunk=chunk)[0]


@torch.library.custom_op("repro_torch::ssd_chunked_bwd", mutates_args=())
def ssd_chunked_bwd(xs: Tensor, bm: Tensor, cm: Tensor, dt: Tensor, a: Tensor, dy: Tensor,
                    chunk: int) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(dxs, dbm, dcm, ddt, da): the backward kernel, or ``ssd_backward_ref``."""
    if on_kernel_path(xs, bm, cm, dt, a, dy):
        return ssd_chunked_bwd_cuda(xs, bm, cm, dt, a, dy, chunk=chunk)
    return ssd_backward_ref(xs, bm, cm, dt, a, dy, chunk=chunk)


@ssd_chunked_fwd.register_fake
def _(xs, bm, cm, dt, a, chunk):
    return fake_empty(xs, xs.shape, torch.float32)


@ssd_chunked_bwd.register_fake
def _(xs, bm, cm, dt, a, dy, chunk):
    return tuple(fake_empty(t, t.shape, torch.float32) for t in (xs, bm, cm, dt, a))


def _dims(xs, bm):
    b, s, h, dh = xs.shape
    return b, s, h, dh, bm.shape[-1]


register_cost(torch.ops.repro_torch.ssd_chunked_fwd.default,
              lambda xs, bm, *_: costs.ssd_fwd_cost(*_dims(xs, bm)))
register_cost(torch.ops.repro_torch.ssd_chunked_bwd.default,
              lambda xs, bm, *_: costs.ssd_bwd_cost(*_dims(xs, bm)))
# one mesh dim's placements: outputs, then inputs (xs, bm, cm, dt, a[, dy])
register_dtensor_rule(torch.ops.repro_torch.ssd_chunked_fwd.default,
                      [" ".join("R" * 6), "S0 S0 S0 S0 S0 R", "S2 S2 R R S2 S0"],
                      n_out=1, static_argnum=5)
register_dtensor_rule(torch.ops.repro_torch.ssd_chunked_bwd.default,
                      [" ".join("R" * 11), "S0 S0 S0 S0 P S0 S0 S0 S0 R S0",
                       "S2 P P S2 S0 S2 R R S2 S0 S2"], n_out=5, static_argnum=6)


class SSDScan(torch.autograd.Function):
    """y = scan(xs, bm, cm, dt, a) over f32 tensors; the backward returns
    the five inputs' gradients from the saved inputs."""

    @staticmethod
    def forward(ctx, xs, bm, cm, dt, a, chunk: int):
        y = ssd_chunked_fwd(xs, bm, cm, dt, a, chunk)
        ctx.save_for_backward(xs, bm, cm, dt, a)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        xs, bm, cm, dt, a = ctx.saved_tensors
        return *ssd_chunked_bwd(xs, bm, cm, dt, a, dy.contiguous(), ctx.chunk), None


def ssd_chunked(xs: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                dt: torch.Tensor, a: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """Chunked selective-state scan.  bm and cm are (B, S, N), or (B, S, G,
    N) in G groups, head h reading group h // (H / G).  Returns y (B, S, H,
    dh) f32; differentiable in all five inputs with one group."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xs, bm, cm, dt, a)):
        if bm.dim() == 4:
            raise ValueError("the scan with grouped B and C has no backward yet")
        return SSDScan.apply(xs, bm, cm, dt, a, chunk)
    return ssd_chunked_fwd(xs, bm, cm, dt, a, chunk)
