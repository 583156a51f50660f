"""Aggregate dry-run records into roofline tables.

A copy of the JAX package's ``launch/report.py``: for the same records it
prints the same tables (the column headers too: "useful/HLO" reads the
port's ``useful_flops_ratio``, model FLOPs over the counted ones).

  PYTHONPATH=src python -m repro_torch.launch.report results/dryrun_torch.json
"""

from __future__ import annotations

import glob
import json
import sys
from pathlib import Path


def load_records(patterns: list[str]) -> dict[tuple, dict]:
    """Latest record per (arch, shape, mesh): later files override earlier."""
    recs: dict[tuple, dict] = {}
    files: list[str] = []
    for p in patterns:
        files += sorted(glob.glob(p))
    for f in files:
        try:
            data = json.load(open(f))
        except Exception:
            continue
        if isinstance(data, dict):
            data = [data]
        for r in data:
            if "arch" in r and "shape" in r:
                key = (r["arch"], r["shape"], r.get("mesh", "?"))
                if r.get("ok") or key not in recs:
                    recs[key] = dict(r, _src=Path(f).name)
    return recs


def fmt_s(x) -> str:
    if x is None:
        return "-"
    if x == 0:
        return "0"
    for unit, div in (("s", 1.0), ("ms", 1e-3), ("us", 1e-6)):
        if x >= div:
            return f"{x/div:.2f}{unit}"
    return f"{x:.1e}s"


def roofline_table(recs: dict[tuple, dict], mesh: str = "16x16") -> str:
    rows = []
    hdr = ("| arch | shape | t_compute | t_memory | t_collective | bound | "
           "HBM/chip | useful/HLO | roofline |")
    sep = "|" + "---|" * 9
    rows.append(hdr)
    rows.append(sep)
    for (arch, shape, m), r in sorted(recs.items()):
        if m != mesh or not r.get("ok"):
            continue
        rows.append(
            f"| {arch} | {shape} | {fmt_s(r.get('t_compute'))} | "
            f"{fmt_s(r.get('t_memory'))} | {fmt_s(r.get('t_collective'))} | "
            f"{r.get('bottleneck','-')} | {r.get('hbm_per_chip_gb','-')}GB | "
            f"{r.get('useful_flops_ratio', 0):.2f} | "
            f"{r.get('roofline_frac', 0):.3f} |"
        )
    return "\n".join(rows)


def failures(recs: dict[tuple, dict]) -> list[str]:
    return [f"{k}: {r.get('error')}" for k, r in sorted(recs.items()) if not r.get("ok")]


def main() -> int:
    patterns = sys.argv[1:] or ["results/*.json"]
    recs = load_records(patterns)
    ok = sum(1 for r in recs.values() if r.get("ok"))
    print(f"{len(recs)} cells, {ok} ok\n")
    for mesh in ("16x16", "2x16x16"):
        print(f"### mesh {mesh}\n")
        print(roofline_table(recs, mesh))
        print()
    bad = failures(recs)
    if bad:
        print("FAILURES:")
        print("\n".join(bad))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
