"""Read the control that the Zamba2 cell's limits are set against, through
the entry's own ``judge``.

    python3 seifer_bench/tools/zamba2_control.py --workload zamba2-edge-closed \
        --seeds 1,2,3 [--device cuda] [--out FILE]

For each seed: the cell's weights and input pool (``entries/zamba2.py``)
and ``compare`` inputs drawn from the pool, served by ``reference/zamba2.py``
with TF32 products in place of the program, stage by stage with the
configured codec on every hop.  Its stage log and answers go to
``judge`` as a run's would: each hop against the codec's round trip, each
stage's output against the f32 reference on the same input.  A sound
limit reads the control not ``correct``.  The program's own readings come
from the cell's runs (``tools/calibrate.py --seeds`` runs them with every
limit open).  Every reading is a line of ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def control(cell, seed: int, device: str) -> dict:
    import numpy as np
    import torch

    from seifer_bench.entries import zamba2 as entry
    from seifer_bench.lib.bench import sub_seed
    from seifer_bench.reference import zamba2 as reference

    cfg, tr = cell.config, cell.traffic
    model, dep = cfg["model"], cfg["deployment"]
    w = entry.draw(model, seed, device)
    pool = entry.inputs(model, seed, tr["pool"], device)
    rng = np.random.default_rng(sub_seed(seed, "control") % 2**63)
    picks = sorted(int(i) for i in rng.choice(tr["pool"], size=min(tr["compare"], tr["pool"]),
                                              replace=False))
    t = time.monotonic()
    log: dict[int, list] = {i: [] for i in picks}
    x = pool[picks]
    for j, (first, stop) in enumerate(dep["stages"]):
        x = entry.hop(dep["codecs"][j], x, dep["codec_block"])
        out = reference.stage(model, w, x, first, stop, "tf32")
        for g, i in enumerate(picks):
            log[i].append((first, x[g], out[g]))
        x = out
    x = entry.hop(dep["codecs"][len(dep["stages"])], x, dep["codec_block"])
    kept = {i: x[g] for g, i in enumerate(picks)}
    checks = entry.judge(cfg["limits"], model, dep, w, pool, log, kept, set(picks))
    secs = time.monotonic() - t
    del w, pool, log, kept, x
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return {**{k: v for k, v, _ in checks}, "limits": {k: lim for k, _, lim in checks},
            "correct": all(v <= lim for _, v, lim in checks), "inputs": len(picks),
            "seconds": secs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="zamba2-edge-closed")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from seifer_bench.lib import bench

    cell = bench.cell(args.workload)
    out = Path(args.out or ROOT / "build" / "seifer_bench" / f"{args.workload}.control.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        rec = {"kind": "control", "seed": seed, **control(cell, seed, args.device)}
        print(json.dumps(rec), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
