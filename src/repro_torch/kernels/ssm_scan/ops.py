"""Chunked SSD (Mamba2) scan, dispatched by the tensors' device.

A CUDA tensor always goes to the hand-written kernel, which tiles at its
own chunk and masks a ragged last chunk itself, so nothing falls through:
a shape it cannot take raises.  A CPU tensor goes to the plain ``ssd_ref``
at the caller's ``chunk``.  The JAX package's ``use_pallas``/``interpret``
knob is the tensors' device here.  The kernel has no backward yet: on CUDA
a gradient through it raises (``require_no_grad``); the CPU path
differentiates the plain version, as the JAX package differentiates its jnp
scan.
"""

from __future__ import annotations

import torch

from repro_torch.core.execution import on_kernel_path, require_no_grad
from repro_torch.kernels.ssm_scan.kernel import ssd_chunked_cuda
from repro_torch.kernels.ssm_scan.ref import ssd_ref


def ssd_chunked(xs: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                dt: torch.Tensor, a: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """Chunked selective-state scan.  Returns y (B, S, H, dh) f32."""
    if on_kernel_path(xs, bm, cm, dt, a):
        require_no_grad("ssd_chunked", xs, bm, cm, dt, a)
        return ssd_chunked_cuda(xs, bm, cm, dt, a, chunk=chunk)
    y, _ = ssd_ref(xs, bm, cm, dt, a, chunk=chunk)
    return y
