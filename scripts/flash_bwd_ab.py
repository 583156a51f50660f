"""The flash-attention backward kernel of checkouts, interleaved, on one card.

    python scripts/flash_bwd_ab.py TREE_A [TREE_B ...] [--turns 1] [--rows llama,pixtral]

Each run is a fresh process that imports ``repro_torch`` from one tree's
``src/``, builds that tree's kernels, and times ``flash_attention_bwd_cuda``
(CUDA events, the mean of 3 launches after one warm-up) at the shapes of
``chip_smoke.py``'s phase 11e rows (PERF.md §6, rows 4'a-h), on inputs
drawn from fixed seeds, with o and lse from the tree's own forward kernel;
it checks that two launches give equal gradients.  With several trees a
turn runs them in order, then in reverse (A, B, B, A), so drift on the card
falls on each alike.  The card's name
and power limit come first; the last line is a JSON object of every run.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# (b, s, h, kh, hd, causal, window, softcap): phase 11e's rows
ROWS = {
    "llama": (8, 4096, 32, 8, 64, True, 0, 0.0),
    "gemma2": (1, 8192, 32, 16, 128, True, 0, 50.0),
    "window_gemma2": (1, 8192, 32, 16, 128, True, 4096, 50.0),
    "hd80_zamba2": (4, 4096, 32, 32, 80, True, 0, 0.0),
    "hd128_phi35moe": (4, 4096, 32, 8, 128, True, 0, 0.0),
    "hd112_kimi": (4, 4096, 64, 8, 112, True, 0, 0.0),
    "hd160_pixtral": (4, 4096, 32, 8, 160, True, 0, 0.0),
    "noncausal_whisper": (16, 4096, 12, 12, 64, False, 0, 0.0),
}


def child(tree: str, rows: list[str]) -> None:
    """Time the backward of ``tree`` at each row; print {row: ms} as JSON."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import numpy as np
    import torch

    from repro_torch.core.execution import resolve_device
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda,
        flash_attention_cuda,
    )

    dev = resolve_device("cuda")
    out = {}
    for n, name in enumerate(rows):
        b, s, h, kh, hd, causal, window, softcap = ROWS[name]
        rng = np.random.default_rng(90 + n)
        q, k, v, do = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)
                       for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd), (b, s, h, hd)))
        kw = dict(causal=causal, window=window, softcap=softcap)
        o, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
        first = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        again = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        if not all(torch.equal(a, c) for a, c in zip(first, again)):
            raise SystemExit(f"{name}: two runs of the backward differ")
        del first, again
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(3):
            flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / 3
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> None:
    args, opts, trees = sys.argv[1:], {}, []
    while args:
        a = args.pop(0)
        if a.startswith("--"):
            opts[a] = args.pop(0)
        else:
            trees.append(a)
    rows = opts["--rows"].split(",") if "--rows" in opts else list(ROWS)
    if "--child" in opts:
        return child(opts["--child"], rows)
    turns = int(opts.get("--turns", 1))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    order = trees if len(trees) == 1 else trees + trees[::-1]
    runs = []
    for turn in range(turns):
        for tree in order:
            got = subprocess.run([sys.executable, __file__, "--child", tree, "--rows", ",".join(rows)],
                                 capture_output=True, text=True, timeout=900)
            if got.returncode != 0:
                raise SystemExit(f"{tree} failed:\n{got.stderr[-3000:]}")
            ms = json.loads(got.stdout.strip().splitlines()[-1])
            runs.append({"turn": turn, "tree": tree, "ms": ms})
            print(f"turn {turn} {tree}: " + ", ".join(f"{r} {v:.3f} ms" for r, v in ms.items()),
                  flush=True)
    for name in rows:
        means = {t: [r["ms"][name] for r in runs if r["tree"] == t] for t in trees}
        print(f"{name} {ROWS[name]}: " + "; ".join(
            f"{t} {sum(v) / len(v):.3f} ms" for t, v in means.items()), flush=True)
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()
