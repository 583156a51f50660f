"""Find the knee of an open-loop edge cell: the highest rate it sustains.

    python3 seifer_bench/tools/knee_sweep.py --workload NAME --rates 60,70,80 \
        [--seconds S] [--seed N] [--out FILE]

Deploys the cell once, then offers its traffic at each rate (on each
arrival schedule, ``--repeat`` times) for a short window, through the same
entry code as a run, and reads from the due and completion times the
backlog (requests due and not yet done) at the middle of the window and
near its end, the share completed and the p95.  A rate whose backlog
grows over the window is above the knee.  Used once, when the cell is
defined; the rate a cell runs at is a number in its traffic file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def backlog_at(win, t: float) -> int:
    due = sum(1 for d in win.due.values() if d <= t)
    done = sum(1 for i, lat in win.latency_ms.items() if win.due[i] + lat / 1e3 <= t)
    return due - done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--schedules", default=None,
                    help="seeds of the arrival schedules, one window each (default: --seed)")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from seifer_bench.entries import edge
    from seifer_bench.lib import arrivals, bench, weights
    from seifer_bench.run import p95

    cell = bench.cell(args.workload)
    out = Path(args.out or ROOT / "build" / "seifer_bench" / f"{args.workload}.knee.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    ctx = bench.Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=False,
                        device="cuda", t_start=time.monotonic())
    served = edge.Served(ctx)
    pool = weights.inputs(served.model, ctx.seed, cell.traffic["pool"], ctx.device)
    served.warm_up(pool)
    schedules = [int(s) for s in (args.schedules or str(args.seed)).split(",")]
    runs = [(float(r), sched, rep) for r in args.rates.split(",") for sched in schedules
            for rep in range(args.repeat)]
    for rate, sched, rep in runs:
        times = arrivals.arrival_times(cell.traffic["process"], rate=rate,
                                       duration_s=args.seconds, seed=sched,
                                       **cell.traffic.get("process_args", {}))
        win = edge.Window(served, dataclasses.replace(ctx), set())
        win.t0 = time.monotonic()
        edge._open_loop(served, ctx, pool, win, times)
        lat = sorted(win.latency_ms.values())
        every = [win.latency_ms.get(i) for i in range(len(times))]
        rec = {"rate": rate, "schedule": sched, "repeat": rep, "seconds": args.seconds,
               "p95_all_ms": p95(every), "offered": len(times), "completed": len(lat),
               "backlog_mid": backlog_at(win, args.seconds / 2),
               "backlog_end": backlog_at(win, args.seconds * 0.95),
               "p50_ms": lat[len(lat) // 2] if lat else None,
               "p95_ms": lat[int(0.95 * (len(lat) - 1))] if lat else None}
        while served.dep.loop.backlog:  # drain before the next rate
            win.step(False)
        print(json.dumps(rec), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
