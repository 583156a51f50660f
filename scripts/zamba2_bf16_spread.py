"""How far a small zamba2-2.7b's bf16 gradients move on the CPU alone when
the SSD scan is chunked at 64 instead of 256.

    PYTHONPATH=src python scripts/zamba2_bf16_spread.py [--seeds 1]

The model, weights, tokens and step are those of
``tests/test_torch_gpu.py::test_small_train_step_card_matches_cpu[zamba2-2.7b-bf16]``
(d = 320, 12 Mamba2 layers, S = 2048, 2 microbatches of 1; weights from
seed 0, tokens from seed 3).  The two chunkings are equal in exact
arithmetic; their f32 roundings differ, and bf16 roundings downstream flip
with them.  The spread of each gradient leaf, max|g64 - g256| / max|g256|,
is the size of the noise of the reference itself, against which that test's
bf16 tolerance for the card is set.  ``--seeds N`` repeats it for weight
seeds 0..N-1 (tokens from seed 3 + the weight seed).  Runs on the CPU; the
last line is a JSON object of every seed's worst leaf.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.models import lm
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.runtime import train


def grads_at(cfg, base, tokens, chunk: int) -> list[torch.Tensor]:
    """The accumulated gradient leaves of one step with the scan at ``chunk``."""
    defaults = ssm_lib.mamba_forward.__kwdefaults__
    old = defaults["chunk"]
    defaults["chunk"] = chunk
    try:
        params = tree_map(lambda t: t.clone(), base)
        grads, _ = train._accumulated_grads(lambda p, b: lm.loss_fn(cfg, p, b), params,
                                            {"tokens": torch.as_tensor(tokens)}, 1)
    finally:
        defaults["chunk"] = old
    return tree_leaves(grads)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=1)
    args = ap.parse_args()
    cfg = reduced(ARCHS["zamba2-2.7b"], d_model=320, vocab=512)
    worst = {}
    for seed in range(args.seeds):
        base = lm.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu",
                              max_pos=64)
        base = tree_map(lambda t: t.to(torch.bfloat16), base)
        tokens = np.random.default_rng(3 + seed).integers(0, cfg.vocab_size, (2, 2048),
                                                          dtype=np.int32)
        g256 = grads_at(cfg, base, tokens, 256)
        g64 = grads_at(cfg, base, tokens, 64)
        spreads = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                   for a, b in zip(g64, g256)]
        worst[seed] = max(spreads)
        print(f"seed {seed}: {len(spreads)} leaves, spread max {worst[seed]:.4e}, median "
              f"{sorted(spreads)[len(spreads) // 2]:.4e}", flush=True)
    print(json.dumps({"worst_leaf_spread": worst}))


if __name__ == "__main__":
    main()
