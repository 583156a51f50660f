"""Execution device: which compute path the deployed executors and codecs run.

The JAX package threads an ``ExecutionKnob(use_pallas, interpret)`` from the
spec down to the kernels.  Here the knob is the tensor's device:

- a CUDA tensor always goes to the hand-written kernel (there is no
  fallback: a shape the kernel cannot take raises);
- a CPU tensor always goes to the kernel's plain PyTorch version;
- any other device raises.

``resolve_device`` is what the entry points call on the caller's device
argument (default ``"cuda"``).  It also turns TF32 off for float32 matrix
products and convolutions: the JAX reference computes in full f32, and the
tolerances the port is held to (1e-5 on the fused dequant-matmul, 2e-5 on
flash attention) are f32 tolerances that TF32's ~1e-3 would break.  And it
makes bf16 matrix products sum in f32 (no reduced-precision reductions), as
the JAX package's bf16 products do (``preferred_element_type=f32``).

``require_no_grad`` guards the CUDA path of an op whose kernel has no
backward: a gradient wanted through it raises instead of being dropped.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Validate an entry point's device, pin f32 products to full f32 and
    bf16 products to f32 sums."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, got {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for, but no CUDA device is "
                               "available; pass device='cpu' to run the plain path")
        if dev.index is None:  # name the card, so device comparisons hold
            dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


def on_kernel_path(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on CUDA (run the kernel), False when every
    tensor lies on the CPU (run the plain version); raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all lie on cpu or all on cuda, got {sorted(kinds)}")


def require_no_grad(op: str, *tensors: torch.Tensor) -> None:
    """Raise on the CUDA path of an op that has no backward kernel yet, when
    autograd would want a gradient through it.

    A kernel wrapper writes into a fresh tensor that has no ``grad_fn``, so
    ``loss.backward()`` would silently drop the gradient of everything
    upstream.  The CPU path keeps autograd through the plain version."""
    if not torch.is_grad_enabled():
        return
    if any(t.requires_grad for t in tensors if t.is_floating_point()):
        raise NotImplementedError(
            f"{op}: the CUDA kernel has no backward (ROADMAP.md queue 1: the int8 "
            f"codec's kernels serve inference only); call it under torch.no_grad(), "
            f"or on CPU tensors, where autograd runs through the plain version")
