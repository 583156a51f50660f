"""Peak device memory and seconds a step of one training run, for checkouts
of the repository side by side on one card.

    python scripts/train_peak_ab.py TREE_A [TREE_B ...] [--run TRAIN_ZAMBA] [--turns 1]

Each run is a fresh process that imports ``chip_smoke.py`` and
``repro_torch`` from one tree, builds that tree's kernels and runs the tree's
own ``train_lm`` on the configuration named by ``--run`` (one of
``chip_smoke.py``'s ``TRAIN_*`` dicts, by default zamba2-2.7b whole at B=8 x
4096 as 2 microbatches of 4): the same steps, seeds and launch checks as
phase 11, and its peak of ``torch.cuda.max_memory_allocated`` over the
steps.  With several trees a turn runs them in order, then in reverse.  The
card's name and power limit come first; the last line is a JSON object of
every run.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def child(tree: str, run: str) -> None:
    """Run ``run`` with ``tree``'s chip_smoke; print its peak and seconds as JSON."""
    root = Path(tree).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke

    card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    got = chip_smoke.train_lm(card, **getattr(chip_smoke, run))
    print(json.dumps({"peak_bytes": got["peak_bytes"], "secs": got["secs"]}), flush=True)


def main() -> None:
    args, opts, trees = sys.argv[1:], {}, []
    while args:
        a = args.pop(0)
        if a.startswith("--"):
            opts[a] = args.pop(0)
        else:
            trees.append(a)
    run = opts.get("--run", "TRAIN_ZAMBA")
    if "--child" in opts:
        return child(opts["--child"], run)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    order = trees if len(trees) == 1 else trees + trees[::-1]
    runs = []
    for turn in range(int(opts.get("--turns", 1))):
        for tree in order:
            got = subprocess.run([sys.executable, __file__, "--child", tree, "--run", run],
                                 capture_output=True, text=True, timeout=900)
            if got.returncode != 0:
                raise SystemExit(f"{tree} failed:\n{got.stdout[-2000:]}\n{got.stderr[-3000:]}")
            res = json.loads(got.stdout.strip().splitlines()[-1])
            runs.append({"turn": turn, "tree": tree, **res})
            print(f"turn {turn} {tree} {run}: peak {res['peak_bytes'] / 2**30:.2f} GiB, seconds "
                  f"a step " + ", ".join(f"{s:.3f}" for s in res["secs"]), flush=True)
    print(json.dumps({"card": card, "run": run, "runs": runs}))


if __name__ == "__main__":
    main()
