"""The SSD-scan backward kernel of checkouts, interleaved, on one card.

    python scripts/ssd_bwd_ab.py TREE_A [TREE_B ...] [--turns 1] [--rows zamba2,ragged]

Each run is a fresh process that imports ``repro_torch`` from one tree's
``src/``, builds that tree's kernels, and times ``ssd_chunked_bwd_cuda``
(CUDA events, the mean of 5 launches after one warm-up) at each row's
shape, on inputs drawn from fixed seeds as ``chip_smoke.py`` draws the
scan's (dt a softplus, a = -exp(0.3 z)); it checks that two launches give
equal gradients.  With several trees a turn runs them in order, then in
reverse (A, B, B, A), so drift on the card falls on each alike.  The
card's name and power limit come first; the last line is a JSON object of
every run.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# (b, s, h, dh, n): zamba2-2.7b's Mamba2 layer at its training microbatch,
# demo_ssm's layer (zamba2's width at S=8192), a ragged last chunk, and
# zamba2's layer at batch 1
ROWS = {
    "zamba2": (4, 4096, 80, 64, 64),
    "demo_ssm": (4, 8192, 80, 64, 64),
    "ragged": (4, 4000, 80, 64, 64),
    "zamba2_b1": (1, 4096, 80, 64, 64),
}


def child(tree: str, rows: list[str]) -> None:
    """Time the backward of ``tree`` at each row; print {row: ms} as JSON."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import numpy as np
    import torch

    from repro_torch.core.execution import resolve_device
    from repro_torch.kernels.ssm_scan.kernel import ssd_chunked_bwd_cuda

    dev = resolve_device("cuda")
    out = {}
    for i, name in enumerate(rows):
        b, s, h, dh, n = ROWS[name]
        rng = np.random.default_rng(120 + i)

        def draw(shape, scale=1.0):
            return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32) * scale, device=dev)

        xs, bm, cm = draw((b, s, h, dh), 0.5), draw((b, s, n), 0.5), draw((b, s, n), 0.5)
        dt = torch.nn.functional.softplus(draw((b, s, h)))
        a = -torch.exp(draw((h,), 0.3))
        dy = draw((b, s, h, dh))
        args = (xs, bm, cm, dt, a, dy)
        first = ssd_chunked_bwd_cuda(*args, chunk=s)
        again = ssd_chunked_bwd_cuda(*args, chunk=s)
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            raise SystemExit(f"{name}: two runs of the backward differ")
        if not all(bool(torch.isfinite(x).all()) for x in first):
            raise SystemExit(f"{name}: a gradient is not finite")
        del first, again
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(5):
            ssd_chunked_bwd_cuda(*args, chunk=s)
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / 5
        del args, xs, bm, cm, dt, a, dy
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main(argv: list[str] | None = None) -> None:
    args, opts, trees = list(sys.argv[1:] if argv is None else argv), {}, []
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
                raise SystemExit(f"{tree} failed:\n{got.stdout[-2000:]}\n{got.stderr[-3000:]}")
            ms = json.loads(got.stdout.strip().splitlines()[-1])
            runs.append({"turn": turn, "tree": tree, "ms": ms})
            print(f"turn {turn} {tree}: " + ", ".join(f"{r} {v:.4f} ms" for r, v in ms.items()),
                  flush=True)
    for name in rows:
        means = {t: [r["ms"][name] for r in runs if r["tree"] == t] for t in trees}
        print(f"{name} {ROWS[name]}: " + "; ".join(
            f"{t} {sum(v) / len(v):.4f} ms" for t, v in means.items()), flush=True)
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()
