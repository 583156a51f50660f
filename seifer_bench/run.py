"""Run one cell of BENCHMARK.json once and print its result line.

    python3 seifer_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  Loads the cell's configuration and traffic
(``configs/``, ``traffic/``), runs its entry (``entries/``) on the card:
set-up, warm-up, a window of ``--seconds``, then the check of the sampled
answers against the plain reference.  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of standard error).

Exits non-zero with no result line when there is no card or fewer cards
than the cell asks for, when a file of the cell is missing, and when the
process holds ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro``
once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.monotonic()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
MISSED_MS = 1e9  # the latency a request reads that did not complete in the window


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def p95(latencies) -> float:
    """Nearest-rank 95th percentile; a request that missed reads MISSED_MS."""
    vals = sorted(MISSED_MS if v is None else v for v in latencies)
    if not vals:
        return MISSED_MS
    return vals[max(0, math.ceil(0.95 * len(vals)) - 1)]


def end_to_end(name: str, got) -> float:
    if name == "setup_s":
        return got.setup_s
    if name == "req_per_s":
        return got.completed / got.window_s
    if name == "p95_ms":
        return p95(got.latencies_ms)
    raise KeyError(f"no end-to-end metric {name!r} in the harness")


def measure(cell, *, seed: int, seconds: float, trace: bool, device: str, t_start: float):
    """Run ``cell`` once; returns (the result line as a dict, stderr lines)."""
    from seifer_bench.lib import bench
    from seifer_bench.lib import trace as tr

    readers = {m["name"]: bench.load_module("metrics", m["name"]) for m in cell.per_layer} \
        if trace else {}
    entry = bench.load_module("entries", cell.config["entry"])
    ctx = bench.Context(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device,
                        t_start=t_start, readers=readers)
    got = entry.run(ctx)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = readers[m["name"]].read(got.obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": end_to_end(m["name"], got), "unit": m["unit"]}
    if device.startswith("cuda"):
        import torch

        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    else:
        dev = {"platform": "cpu", "kind": "cpu"}
    dev.update(count=got.count, memory_peak_bytes=got.memory_peak_bytes)
    line = {"correct": bool(got.checks) and all(math.isfinite(v) and v <= lim
                                                for _, v, lim in got.checks),
            "attempted": got.attempted, "failed": got.failed, "metrics": metrics, "device": dev}
    if trace:
        datas = got.obs.get("trace", [])
        if datas:
            n = len(datas)
            dev["busy_s"] = sum(tr.busy_s(d) for d in datas) / n
            dev["window_s"] = sum(tr.window_s(d) for d in datas) / n
            line["breakdown"] = tr.breakdown(datas)
    line["checks"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                      for name, v, lim in got.checks}
    done = sorted(v for v in got.latencies_ms if v is not None)
    notes = list(got.notes)
    if done:
        notes.append(f"latency over {len(done)} completed requests: median "
                     f"{done[len(done) // 2]:.3f} ms, max {done[-1]:.3f} ms; "
                     f"{got.attempted - len(done)} of {got.attempted} missed the window")
    notes += [f"{name} {v!r} limit {lim!r}" for name, v, lim in got.checks]
    return line, notes


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the bytecode of every module imported from here on (the port, torch, the
    # libraries torch loads at a custom op's first call) is cached in the
    # checkout, at a fixed path, whatever the environment says: only a
    # checkout's first run compiles it
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix  # and in the ranks an entry spawns
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    # this package by its full name only: not its folders as top-level names
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "seifer_bench"]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / sub)
    from seifer_bench.lib import bench

    try:
        cell = bench.cell(args.workload)
    except bench.BenchError as e:
        print(f"seifer_bench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"seifer_bench: {args.workload} needs {cell.chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    try:
        line, notes = measure(cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device="cuda", t_start=T_START)
    except bench.BenchError as e:
        print(f"seifer_bench: {e}", file=sys.stderr)
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"seifer_bench: the process holds {bad} after the window", file=sys.stderr)
        return 1
    print(f"card: {card_line()}", file=sys.stderr)
    for note in notes:
        print(note, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
