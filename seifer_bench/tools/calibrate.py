"""Read the numbers that the limits of ``correct`` are set from.

    python3 seifer_bench/tools/calibrate.py --workload NAME --seeds 1,2,3 \
        [--seconds S] [--control-seeds 1,2,3] [--out FILE]

In one process (the kernels are loaded once): for each of ``--seeds`` the
cell's own entry runs a short window at the cell's load and compares its
sampled answers with the plain reference (the lower readings); for each of
``--control-seeds`` the reference computed with TF32 products is put in the
program's place and compared the same way, on the same weights and on as
many inputs as a run compares, at the cell's own sizes (the upper
readings).  Every reading is a line of ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def control(cell, seed: int, device: str) -> dict:
    """The TF32 reference against the f32 one on the cell's weights and on
    ``compare`` inputs of its pool."""
    import numpy as np
    import torch

    from seifer_bench.lib import weights
    from seifer_bench.lib.bench import sub_seed
    from seifer_bench.reference import models as reference

    model, dep, tr = cell.config["model"], cell.config["deployment"], cell.traffic
    block = dep.get("codec_block", dep.get("quant_block"))
    w = weights.draw(model, seed, device, gain=cell.config["weights"]["gain"])
    pool_n = tr.get("pool", tr.get("pool_runs", 1) * tr.get("n_micro", 1) * tr.get("microbatch", 1))
    pool = weights.inputs(model, seed, pool_n, device)
    rng = np.random.default_rng(sub_seed(seed, "control") % 2**63)
    picks = sorted(int(i) for i in rng.choice(pool_n, size=min(tr["compare"], pool_n),
                                              replace=False))
    errors = []
    t = time.monotonic()
    for at in range(0, len(picks), 4):
        x = pool[picks[at:at + 4]]
        ref = reference.forward(model, w, x, dep["stages"], block, "f32")
        ctl = reference.forward(model, w, x, dep["stages"], block, "tf32")
        errors += [reference.relative_errors(ctl[g], ref[g]) for g in range(len(x))]
        del ref, ctl
    secs = time.monotonic() - t
    del w, pool
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return {**reference.worst_errors(errors), "inputs": len(picks), "reference_pair_s": secs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from seifer_bench.lib import bench

    cell = bench.cell(args.workload)
    out = Path(args.out or ROOT / "build" / "seifer_bench" / f"{args.workload}.calib.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    entry = bench.load_module("entries", cell.config["entry"])
    # the limits are what is being read: every number is recorded, none judged
    from seifer_bench.reference.models import ERRORS

    open_cell = dataclasses.replace(
        cell, config={**cell.config, "limits": {k: math.inf for k in ERRORS}})
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.monotonic()
        ctx = bench.Context(cell=open_cell, seed=seed, seconds=args.seconds, trace=False,
                            device=args.device, t_start=t)
        got = entry.run(ctx)
        rec = {"kind": "program", "seed": seed, "wall_s": time.monotonic() - t,
               **{name: v for name, v, _ in got.checks}, "completed": got.completed,
               "notes": got.notes}
        print(json.dumps(rec), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        rec = {"kind": "control", "seed": seed, **control(cell, seed, args.device)}
        print(json.dumps(rec), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
