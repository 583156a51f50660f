"""Run a cell once, traced, and summarise the program's ``seifer.*`` regions.

    python3 seifer_bench/tools/regions.py --workload NAME --seed N \
        [--seconds S] [--out FILE]

Runs the cell as ``seifer_bench/run.py --trace 1`` does, keeping the
program's regions in each rank's reduced trace (``lib/regions.py``), and
prints its result line; then, a traced rank at a time: each region's
count, summed host and device milliseconds and device milliseconds a
region; the share of the rank's device-operation time (the operations'
summed durations) that the outermost regions hold; and the NCCL kernels'
seconds; and last the quantities ``lib/regions.QUANTITIES`` reads from
them (a stage's device ms, the engine's own host ms a microbatch, a
full-tick GPipe hop's device ms).  The same summary is written to
``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def summarise(data: dict) -> dict:
    """One rank's regions: by name, and the outermost regions' coverage."""
    by_name: dict[str, dict] = {}
    outer_us, end = 0.0, float("-inf")
    for name, t0, t1, device_us in data.get("program", ()):  # sorted by start
        row = by_name.setdefault(name, {"count": 0, "host_ms": 0.0, "device_ms": 0.0})
        row["count"] += 1
        row["host_ms"] += (t1 - t0) / 1e3
        row["device_ms"] += device_us / 1e3
        if t0 >= end:  # not inside an earlier region
            outer_us += device_us
            end = t1
        else:
            end = max(end, t1)
    ops_us = sum(t1 - t0 for _, t0, t1 in data["ops"])
    nccl_us = sum(t1 - t0 for name, t0, t1 in data["ops"] if "nccl" in name.lower())
    for row in by_name.values():
        row["device_ms_each"] = row["device_ms"] / row["count"]
    return {"regions": dict(sorted(by_name.items())), "ops_s": ops_us / 1e6,
            "nccl_s": nccl_us / 1e6, "outer_share": outer_us / ops_us if ops_us else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from seifer_bench import run
    from seifer_bench.lib import bench, regions

    seconds = args.seconds or bench.benchmark()["run_seconds"]
    entry = bench.load_module("entries", bench.cell(args.workload).config["entry"])
    regions.install()
    if hasattr(entry, "PRELOAD"):  # and in the ranks forked from the entry's server
        entry.PRELOAD.append("seifer_bench.tools.keep_regions")
    seen = {}
    measured = entry.run

    def keep(ctx):  # the entry's observations, which the result line leaves out
        got = measured(ctx)
        seen["obs"] = got.obs
        return got

    entry.run = keep
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed), "--seconds",
                   str(seconds), "--trace", "1"])
    if rc != 0 or "obs" not in seen:
        return rc or 1
    obs = seen["obs"]
    ranks = [summarise(d) for d in obs.get("trace", ())]
    for r, s in enumerate(ranks):
        print(f"rank {r}: device ops {s['ops_s']:.4f} s, NCCL {s['nccl_s']:.4f} s, outermost "
              f"regions hold {100 * (s['outer_share'] or 0):.3f}%", file=sys.stderr)
        for name, row in s["regions"].items():
            print(f"  {name}: {row['count']} x, host {row['host_ms']:.3f} ms, device "
                  f"{row['device_ms']:.3f} ms ({row['device_ms_each']:.4f} ms each)",
                  file=sys.stderr)
    quantities = {name: f(obs) for name, f in regions.QUANTITIES.items()}
    for name, value in quantities.items():
        print(f"{name}: {value}", file=sys.stderr)
    out = Path(args.out or ROOT / "build" / "seifer_bench" / f"regions-{args.workload}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"workload": args.workload, "seed": args.seed,
                               "microbatches": obs.get("microbatches"), "ranks": ranks,
                               "quantities": quantities},
                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
