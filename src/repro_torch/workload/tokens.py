"""Synthetic LM token stream: a Zipf-like first token, then a fixed bigram
table, so the next token is learnable (``examples/train_lm.py``'s stream,
drawn in torch).  ``bigram_tokens`` draws one batch and its table from one
seed; ``bigram_stream`` keeps the table fixed across batches."""

from __future__ import annotations

from typing import Iterator

import torch


def bigram_table(vocab: int, generator: torch.Generator) -> torch.Tensor:
    """A random successor for every token, on the generator's device."""
    return torch.randint(0, vocab, (vocab,), generator=generator, device=generator.device)


def bigram_batch(table: torch.Tensor, batch: int, seq: int,
                 generator: torch.Generator) -> torch.Tensor:
    """(batch, seq) int32 tokens: the first drawn with weight 1/(rank + 1),
    each next one the table's successor of the one before."""
    vocab = table.shape[0]
    law = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float32, device=table.device)
    tok = torch.multinomial(law, batch, replacement=True, generator=generator)
    out = torch.empty((batch, seq), dtype=torch.int32, device=table.device)
    for i in range(seq):
        out[:, i] = tok
        tok = table[tok]
    return out


def bigram_tokens(vocab: int, batch: int, seq: int, seed: int,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    """One batch; its table and first tokens from one generator seeded ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return bigram_batch(bigram_table(vocab, gen), batch, seq, gen)


def bigram_stream(vocab: int, batch: int, seq: int, seed: int = 0,
                  device: str | torch.device = "cuda") -> Iterator[dict]:
    """``{"tokens": (batch, seq)}`` batches over one table (seed 7), first
    tokens drawn anew from ``seed``'s generator for every batch."""
    table = bigram_table(vocab, torch.Generator(device=device).manual_seed(7))
    gen = torch.Generator(device=device).manual_seed(seed)
    while True:
        yield {"tokens": bigram_batch(table, batch, seq, gen)}
