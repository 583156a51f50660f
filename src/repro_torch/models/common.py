"""Shared model plumbing: dtype policy, init helpers, sharding hook, trees.

The JAX package's ``models/common.py`` in PyTorch.  Parameters are nested
dicts (and, for the sLSTM state, tuples) of tensors, laid out as the JAX
package lays out its pytrees, so a tree crosses between the two packages
leaf for leaf (``params_from_numpy``).

Layer groups are stacked on leading axes, as the JAX package stacks them
for ``lax.scan``.  The init helpers take those axes as ``lead`` and draw
the values one layer at a time, in f32 on the target device, then cast:
at full width the transient stays one layer's tensor.  The numbers differ
from ``jax.random``'s (another generator); the distributions are the same.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Callable

import numpy as np
import torch

class NoSharding:
    """The sharding layer's activation hook, as an identity: it keeps the
    JAX package's signatures (sharding policies come with a later slice)."""

    def act(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        return x


NO_SHARDING = NoSharding()


def _fill(out: torch.Tensor, lead: tuple[int, ...], draw: Callable[[torch.Tensor], None]) -> torch.Tensor:
    """Fill ``out`` (lead + shape) one ``shape`` slice at a time: ``draw``
    fills an f32 scratch slice, which is then cast into ``out``."""
    scratch = torch.empty(out.shape[len(lead):], dtype=torch.float32, device=out.device)
    for idx in itertools.product(*(range(n) for n in lead)):
        draw(scratch)
        out[idx].copy_(scratch)
    return out


def dense_init(gen: torch.Generator, shape: tuple[int, ...], dtype=torch.bfloat16,
               scale: float | None = None, *, lead: tuple[int, ...] = (),
               device: str | torch.device = "cpu") -> torch.Tensor:
    """Truncated-normal fan-in init (LM standard): N(0, 1) cut at +-3 std,
    times ``scale`` (default ``fan_in ** -0.5``)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else fan_in**-0.5

    def draw(t: torch.Tensor) -> None:
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
        t.mul_(std)

    return _fill(torch.empty(lead + tuple(shape), dtype=dtype, device=device), lead, draw)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.bfloat16, *,
               device: str | torch.device = "cpu") -> torch.Tensor:
    """N(0, 0.02^2) token embeddings (not truncated, as in the JAX package)."""

    def draw(t: torch.Tensor) -> None:
        t.normal_(0.0, 1.0, generator=gen).mul_(0.02)

    return _fill(torch.empty((vocab, d), dtype=dtype, device=device), (), draw)


def full(shape: tuple[int, ...], value: float, dtype=torch.bfloat16, *,
         lead: tuple[int, ...] = (), device: str | torch.device = "cpu") -> torch.Tensor:
    return torch.full(lead + tuple(shape), value, dtype=dtype, device=device)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, ...) in the working dtype.  bf16 products sum in
    f32 (``resolve_device`` turns the library's reduced-precision bf16
    reductions off), as the JAX package's ``preferred_element_type=f32``;
    the result is rounded once to x's dtype."""
    out = x @ w.reshape(w.shape[0], -1)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


# Activations, written op for op as ``jax.nn`` writes them: each op rounds
# to x's dtype where the JAX package's does, so in bf16 they equal the JAX
# package's bit for bit (the fused torch forms round once, and differ in a
# third of all bf16 values).


def _const(v: float, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=x.dtype, device=x.device)


class _Logistic(torch.autograd.Function):
    """``lax.logistic``: the forward as XLA expands it, 1 / (1 + exp(-x)),
    rounded op by op; the backward as its JVP, g * (s * (1 - s)).  Autograd
    through the expansion would give 0 * inf = NaN wherever exp(-x)
    overflows (x below -88 in f32 and bf16), where the JAX gradient is 0."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1.0 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``lax.logistic`` (see ``_Logistic``)."""
    return _Logistic.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``."""
    cdf = 0.5 * (1.0 + torch.tanh(_const(math.sqrt(2 / math.pi), x)
                                  * (x + _const(0.044715, x) * (x * x * x))))
    return x * cdf


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as jnp computes it."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.maximum(x, zero) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -softplus(-x)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts, tuples and lists (and of
    ``rest``, trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_index(tree: Any, i: int) -> Any:
    """Entry ``i`` of every leaf's leading axis (views, no copy): one layer
    group of stacked params or caches."""
    return tree_map(lambda t: t[i], tree)


def tree_leaves(tree: Any) -> list:
    """Leaves in the tree's own (insertion) order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def sorted_leaves(tree: Any) -> list:
    """Leaves in ``jax.tree.leaves``' order: dict keys sorted, tuples and
    lists in order.  Sums over leaves and checkpoint files follow it, so
    they match the JAX package's."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in sorted_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in sorted_leaves(v)]
    return [tree]


def sorted_unflatten(like: Any, leaves: list) -> Any:
    """A tree shaped as ``like`` whose leaves, in ``sorted_leaves`` order,
    are ``leaves`` (``jax.tree.unflatten``)."""
    it = iter(leaves)

    def build(t: Any) -> Any:
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _from_numpy(a: Any, device: torch.device) -> Any:
    if isinstance(a, (int, float)):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree: Any, device: str | torch.device = "cpu") -> Any:
    """A tree of numpy arrays (the JAX package's params or caches, each leaf
    through ``np.asarray``) as tensors on ``device``, each leaf's dtype kept;
    bfloat16 leaves go across bit for bit."""
    dev = torch.device(device)
    return tree_map(lambda a: _from_numpy(a, dev), tree)
