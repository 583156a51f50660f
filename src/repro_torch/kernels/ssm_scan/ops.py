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
"""

from __future__ import annotations

import torch

from repro_torch.core.execution import on_kernel_path
from repro_torch.kernels.ssm_scan.kernel import ssd_chunked_bwd_cuda, ssd_chunked_cuda
from repro_torch.kernels.ssm_scan.ref import ssd_backward_ref, ssd_ref


class SSDScan(torch.autograd.Function):
    """y = scan(xs, bm, cm, dt, a) over f32 tensors; the backward returns
    the five inputs' gradients from the saved inputs."""

    @staticmethod
    def forward(ctx, xs, bm, cm, dt, a, chunk: int):
        if on_kernel_path(xs, bm, cm, dt, a):
            y = ssd_chunked_cuda(xs, bm, cm, dt, a, chunk=chunk)
        else:
            y, _ = ssd_ref(xs, bm, cm, dt, a, chunk=chunk)
        ctx.save_for_backward(xs, bm, cm, dt, a)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        xs, bm, cm, dt, a = ctx.saved_tensors
        dy = dy.contiguous()
        if on_kernel_path(xs, bm, cm, dt, a, dy):
            grads = ssd_chunked_bwd_cuda(xs, bm, cm, dt, a, dy, chunk=ctx.chunk)
        else:
            grads = ssd_backward_ref(xs, bm, cm, dt, a, dy, chunk=ctx.chunk)
        return *grads, None


def ssd_chunked(xs: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                dt: torch.Tensor, a: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """Chunked selective-state scan.  Returns y (B, S, H, dh) f32;
    differentiable in all five inputs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xs, bm, cm, dt, a)):
        return SSDScan.apply(xs, bm, cm, dt, a, chunk)
    if on_kernel_path(xs, bm, cm, dt, a):
        return ssd_chunked_cuda(xs, bm, cm, dt, a, chunk=chunk)
    y, _ = ssd_ref(xs, bm, cm, dt, a, chunk=chunk)
    return y
