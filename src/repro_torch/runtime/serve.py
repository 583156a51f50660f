"""Serving steps: prefill (last-position logits) and decode (one token).

The JAX package's ``runtime/serve.py`` in PyTorch.  ``make_prefill_step``
and ``make_serve_step`` build the functions a serving loop drives; they run
under ``torch.inference_mode()`` on the device of the params they are given
(``lm.init_params``/``lm.init_caches`` put them on CUDA by default).
"""

from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.common import NO_SHARDING


def make_prefill_step(cfg, policy=NO_SHARDING):
    """(params, batch) -> last-position logits (B, V) f32, final softcap
    applied."""

    @torch.inference_mode()
    def prefill_step(params, batch):
        hidden, _ = lm.forward_hidden(cfg, params, batch, policy=policy)
        return lm.final_logits(cfg, params, hidden[:, -1])

    return prefill_step


def make_serve_step(cfg, policy=NO_SHARDING, *, enc_len: int = 0):
    """(params, caches, tokens (B, 1)) -> (next_token (B, 1) int32, caches'):
    one greedy decode step; the caches are updated in place."""

    @torch.inference_mode()
    def serve_step(params, caches, tokens):
        logits, caches = lm.decode_step(cfg, params, caches, tokens, enc_len=enc_len)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return next_tok, caches

    return serve_step
