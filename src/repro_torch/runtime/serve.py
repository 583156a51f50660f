"""Serving steps: prefill (last-position logits) and decode (one token).

The JAX package's ``runtime/serve.py`` in PyTorch.  ``make_prefill_step``
and ``make_serve_step`` build the functions a serving loop drives; they run
under ``torch.inference_mode()`` (``no_grad`` on DTensors) on the device of
the params they are given
(``lm.init_params``/``lm.init_caches`` put them on CUDA by default).
Given a ``ShardingPolicy`` (params and caches DTensors placed by it), a
step runs in the policy's ``scope``.
"""

from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.common import NO_SHARDING, whole_last_dim


def _no_grad(policy):
    """``inference_mode``; ``no_grad`` for DTensors, whose views cannot be
    taken of inference tensors."""
    return torch.no_grad() if policy.dtensors else torch.inference_mode()


def make_prefill_step(cfg, policy=NO_SHARDING):
    """(params, batch) -> last-position logits (B, V) f32, final softcap
    applied."""

    def prefill_step(params, batch):
        with _no_grad(policy), policy.scope():
            hidden, _ = lm.forward_hidden(cfg, params, batch, policy=policy)
            return lm.final_logits(cfg, params, hidden[:, -1])

    return prefill_step


def make_serve_step(cfg, policy=NO_SHARDING, *, enc_len: int = 0):
    """(params, caches, tokens (B, 1)) -> (next_token (B, 1) int32, caches'):
    one greedy decode step; the caches are updated in place."""

    def serve_step(params, caches, tokens):
        with _no_grad(policy), policy.scope():
            logits, caches = lm.decode_step(cfg, params, caches, tokens, enc_len=enc_len)
            # the vocabulary gathered first on DTensors: torch 2.11's argmax
            # over a sharded dim fails at a batch of one
            next_tok = torch.argmax(whole_last_dim(logits[:, -1]), dim=-1).to(torch.int32)[:, None]
        return next_tok, caches

    return serve_step
