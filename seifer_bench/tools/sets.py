"""Run a cell several times, each run its own process, and read the spreads.

    python3 seifer_bench/tools/sets.py --workload NAME --seeds 11,12,13 \
        [--seconds S] [--trace 0|1] [--repeat 2] [--out FILE]

Runs ``seifer_bench/run.py`` once a seed (``--repeat`` times over the list:
two sets with the same seeds), appends each run's result line, exit code
and the end of its standard error to ``--out``, and prints, a set at a time
and for every metric, the median and the spread: the distance between the
first and third quartiles (``statistics.quantiles(values, n=4)``) as a share
of the median; then the bound five times the wider spread would give.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values: list[float]) -> tuple[float, float]:
    """(median, (q3 - q1) / median)."""
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    out = Path(args.out or ROOT / "build" / "seifer_bench" / f"{args.workload}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    sets: list[dict[str, list[float]]] = []
    for rep in range(args.repeat):
        values: dict[str, list[float]] = {}
        for seed in seeds:
            t = time.monotonic()
            proc = subprocess.run(
                [sys.executable, str(ROOT / "seifer_bench" / "run.py"), "--workload",
                 args.workload, "--seed", str(seed), "--seconds", str(seconds), "--trace",
                 str(args.trace)], cwd=ROOT, capture_output=True, text=True)
            wall = time.monotonic() - t
            lines = proc.stdout.strip().splitlines()
            result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
            with out.open("a") as f:
                f.write(json.dumps({"set": rep, "seed": seed, "rc": proc.returncode,
                                    "wall_s": wall, "result": result,
                                    "stderr": proc.stderr[-3000:]}) + "\n")
            if result is None:
                print(f"set {rep} seed {seed}: rc {proc.returncode}\n{proc.stderr[-3000:]}",
                      flush=True)
                continue
            for name, m in result["metrics"].items():
                values.setdefault(name, []).append(m["value"])
            print(f"set {rep} seed {seed} ({wall:.1f} s): correct {result['correct']} "
                  + " ".join(f"{k}={m['value']:.6g}" for k, m in result["metrics"].items())
                  + " " + " ".join(f"{k}={c['value']}" for k, c in result["checks"].items()),
                  flush=True)
        sets.append(values)
    for name in sorted({n for v in sets for n in v}):
        parts, worst = [], 0.0
        for rep, values in enumerate(sets):
            if name in values:
                med, sp = spread(values[name])
                worst = max(worst, sp)
                parts.append(f"set {rep}: median {med:.6g}, spread {100 * sp:.3f}%")
        print(f"{name}: " + "; ".join(parts) + f"; 5 x widest spread {500 * worst:.3f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
