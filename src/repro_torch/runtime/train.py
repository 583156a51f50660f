"""Training loop substrate: AdamW, grad clipping, LR schedule, microbatching.

The JAX package's ``runtime/train.py`` in PyTorch, with its fields,
defaults and math.  Optimizer moments are stored in ``cfg.opt_state_dtype``
(bf16 for the 1T MoE); all update math is f32.  Gradients come from
``torch.autograd.grad`` through ``lm.loss_fn`` (every layer group
rematerialized), and are accumulated over microbatches in
``opt.accum_dtype`` when ``opt.microbatch`` cuts the batch.

Unlike the JAX package's pure functions, ``adamw_update`` (and so the
train step) updates the state's tensors IN PLACE, leaf by leaf in slices, and
returns a dict holding them: a second copy of a full-width state
(llama3.2-1b's bf16 params and f32 moments, 15 GB) would not fit beside it.
The state passed in is consumed.  Everything stays on the params' device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import lm
from repro_torch.models.common import (
    NO_SHARDING,
    sorted_leaves,
    tree_leaves,
    tree_map,
)

UPDATE_SLICE = 1 << 26  # elements a leaf is updated in at a time (f32 temporaries of 256 MB)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    microbatch: int = 0  # 0 = no gradient accumulation
    accum_dtype: str = "float32"  # bf16 for the 1T MoE (HBM: grads = params)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_state(cfg, params: Any) -> dict:
    """{"params", "m", "v", "step"}: zero moments in ``cfg.opt_state_dtype``
    on each param's device, ``step`` an int32 0-d tensor."""
    dt = _dtype(cfg.opt_state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {
        "params": params,
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, summed leaf by leaf
    in the JAX package's leaf order (sorted dict keys)."""
    total = None
    for x in sorted_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _lr_at(opt: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(opt.warmup_steps, 1), max=1.0)
    return opt.lr * warm


def _slices(t: torch.Tensor, *, written: bool = True):
    """``t`` flattened, in slices of ``UPDATE_SLICE`` elements.  A tensor
    that is ``written`` must be contiguous (``view`` raises otherwise): its
    slices are views that the update writes through."""
    flat = t.view(-1) if written else t.reshape(-1)
    for lo in range(0, flat.numel(), UPDATE_SLICE):
        yield flat[lo:lo + UPDATE_SLICE]


@torch.no_grad()
def adamw_update(cfg, opt: OptConfig, state: dict, grads: Any) -> dict:
    """One AdamW step with global-norm clipping and linear warmup, written
    into ``state``'s params and moments in place (the state is consumed);
    returns {"params", "m", "v", "step"} holding the updated tensors."""
    step = state["step"] + 1
    lr = _lr_at(opt, step)
    b1, b2 = opt.b1, opt.b2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    gnorm = _global_norm(grads)
    scale = torch.clamp(opt.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    # leaves matched by key (sorted), whatever order each dict was built in
    for p_all, g_all, m_all, v_all in zip(*map(sorted_leaves, (state["params"], grads,
                                                               state["m"], state["v"]))):
        for p, g, m, v in zip(_slices(p_all), _slices(g_all, written=False),
                              _slices(m_all), _slices(v_all)):
            g = g.float() * scale
            m32 = b1 * m.float() + (1 - b1) * g
            v32 = b2 * v.float() + (1 - b2) * g * g
            mhat = m32 / c1
            vhat = v32 / c2
            upd = mhat / (torch.sqrt(vhat) + opt.eps) + opt.weight_decay * p.float()
            p.copy_(p.float() - lr * upd)
            m.copy_(m32)
            v.copy_(v32)
    return {"params": state["params"], "m": state["m"], "v": state["v"], "step": step}


def _value_and_grad(loss_of: Callable, params: Any, batch: dict):
    """((loss, parts), grads): ``loss_of(params, batch)`` and its gradient
    in every leaf of ``params`` (zeros where the loss does not reach one, as
    ``jax.grad`` gives), each in its leaf's dtype."""
    leaves = tree_leaves(params)
    try:
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss, parts = loss_of(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(g if g is not None else torch.zeros_like(p) for g, p in zip(grads, leaves))
    detached = {k: (v.detach() if isinstance(v, torch.Tensor) else v) for k, v in parts.items()}
    return (loss.detach(), detached), tree_map(lambda _: next(it), params)


def make_train_step(cfg, opt: OptConfig | None = None, policy=NO_SHARDING) -> Callable:
    """(state, batch) -> (state', metrics).  Microbatched when configured.
    The state is updated in place (see the module docstring)."""
    opt = opt or OptConfig()

    def loss_of(params, batch):
        return lm.loss_fn(cfg, params, batch, policy=policy)

    def train_step(state, batch):
        if opt.microbatch and opt.microbatch < _batch_dim(batch):
            grads, (loss, parts) = _accumulated_grads(
                loss_of, state["params"], batch, opt.microbatch, _dtype(opt.accum_dtype))
        else:
            (loss, parts), grads = _value_and_grad(loss_of, state["params"], batch)
        grad_norm = _global_norm(grads)
        new_state = adamw_update(cfg, opt, state, grads)
        metrics = {"loss": loss, "xent": parts["xent"], "aux": parts["aux"],
                   "grad_norm": grad_norm}
        return new_state, metrics

    return train_step


def _batch_dim(batch) -> int:
    return sorted_leaves(batch)[0].shape[0]


def _accumulated_grads(loss_of, params, batch, micro: int, accum_dtype=torch.float32):
    """Gradient accumulation over batch slices, in order: each microbatch's
    gradient divided by their number in f32, cast to ``accum_dtype`` and
    added.  Returns (grads, (loss, {"xent", "aux"})).  The batch must be a
    whole number of microbatches, as the JAX package's reshape requires."""
    size = _batch_dim(batch)
    if size % micro:
        raise ValueError(f"batch of {size} is not a multiple of the microbatch {micro}")
    n = size // micro
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype, device=p.device), params)
    loss = xent = aux = 0.0
    for i in range(n):
        mb = tree_map(lambda x: x[i * micro:(i + 1) * micro], batch)
        (l_i, parts), g = _value_and_grad(loss_of, params, mb)
        for a, b in zip(tree_leaves(g_acc), tree_leaves(g)):
            a.add_((b.float() / n).to(accum_dtype))
        del g
        loss = loss + l_i / n
        xent = xent + parts["xent"] / n
        aux = aux + parts["aux"] / n
    return g_acc, (loss, {"xent": xent, "aux": aux})
