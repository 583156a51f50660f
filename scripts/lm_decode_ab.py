"""LM decode time of two checkouts of the repository, interleaved, on one card.

    python scripts/lm_decode_ab.py TREE_A TREE_B [--turns 2]

Each run is a fresh process that imports ``repro_torch`` from one tree's
``src/`` and times what ``chip_smoke.py``'s phase 8b times: gemma2-27b whole
(B=2) and zamba2-2.7b whole (B=4), bf16 weights drawn from the same seeds,
caches of 8192, 32 greedy steps through ``make_serve_step``, the mean wall
time a step after the first.  A decode step launches no hand-written kernel,
so nothing is built.  A turn runs A, B, B, A, so drift on the host or the
card falls on both trees alike; the last line is a JSON object of every run.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# the shapes and seeds of chip_smoke.py's LM_MODELS and LM_DECODE_STEPS
MODELS = (("gemma2-27b", 2, 8192, 31), ("zamba2-2.7b", 4, 8192, 32))
STEPS = 32


def child(tree: str) -> None:
    """Time the decode of each model with the port of ``tree``; print
    {arch: ms a step} as JSON."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.execution import resolve_device
    from repro_torch.models import lm
    from repro_torch.runtime.serve import make_serve_step

    resolve_device("cuda")
    out = {}
    for arch, batch, seq, seed in MODELS:
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = lm.init_params(cfg, gen, device="cuda", max_pos=seq)
        caches = lm.init_caches(cfg, batch, seq, device="cuda")
        tok = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen, device="cuda",
                            dtype=torch.int32)
        serve = make_serve_step(cfg)
        steps = []
        for _ in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, caches = serve(params, caches, tok)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        out[arch] = sum(steps[1:]) / (len(steps) - 1) * 1e3
        del params, caches
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> None:
    if sys.argv[1] == "--child":
        return child(sys.argv[2])
    trees = sys.argv[1:3]
    turns = int(sys.argv[sys.argv.index("--turns") + 1]) if "--turns" in sys.argv else 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    runs = []
    for turn in range(turns):
        for tree in (trees[0], trees[1], trees[1], trees[0]):
            got = subprocess.run([sys.executable, __file__, "--child", tree], check=True,
                                 capture_output=True, text=True, timeout=600)
            ms = json.loads(got.stdout.strip().splitlines()[-1])
            runs.append({"turn": turn, "tree": tree, "ms": ms})
            print(f"turn {turn} {tree}: " + ", ".join(f"{a} {v:.2f} ms" for a, v in ms.items()),
                  flush=True)
    for arch, *_ in MODELS:
        means = {t: sum(r["ms"][arch] for r in runs if r["tree"] == t)
                 / sum(r["tree"] == t for r in runs) for t in trees}
        print(f"{arch} decode, mean ms a step: "
              + ", ".join(f"{t} {v:.2f}" for t, v in means.items()) + f"; {card}", flush=True)
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()
