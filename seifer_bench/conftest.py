"""Pytest set-up for the benchmark's CPU tests: the port and this package on
``sys.path``, the ``gpu`` marker, and cells cut to a size the CPU runs in a
second (the configured cells' files, or a held cell's definition below,
with their widths, cluster capacities and traffic made small; everything
else, limits included, as configured)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parents[1]
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY_MODEL = {
    "demo_ssm": {"d": 256, "heads": 4, "state": 64, "seq": 256},  # head width and state as published
    "demo_transformer": {"d": 32, "heads": 4, "kv_heads": 4, "seq": 128},
}
TINY_TRAFFIC = {
    "open": {"rate": 40.0, "pool": 4, "compare": 4},
    "closed": {"pool": 4, "compare": 4, "compare_first": 8},
    "gpipe": {"n_micro": 4, "microbatch": 2, "pool_runs": 2, "compare": 4,
              "compare_first": 8},
}
# The open-loop demo_ssm cell, held out of BENCHMARK.json until the port
# serves a published Mamba2 mixer (PERF.md, Open questions), as it ran on
# the card: its entry path, its readers and its limits are still held to
# the reference here, at tiny widths.  Its cluster is phi2-edge's, with
# each node's capacity the model's weight bytes / 2.5 (3 stages of 2 layers).
HELD = {
    "mamba2-edge-poisson": {
        "model": {"kind": "demo_ssm", "d": 5120, "n_layers": 6, "seq": 8192, "heads": 80,
                  "state": 64, "a": -0.5},
        "gain": {"wb": 0.25, "wc": 0.25},
        "capacity_share": 1 / 2.5,
        "deployment": {"codec": "int8", "codec_block": 256, "serving": "pipelined",
                       "queue_depth": 2, "microbatch": 4, "max_batch": 4, "seed": 3,
                       "stages": [[0, 2], [2, 4], [4, 6]],
                       "codecs": ["identity", "int8", "int8", "identity"]},
        "limits": {"rel_err": 0.0013, "row_med": 0.0012},
        "traffic": {"loop": "open", "process": "poisson-stratified", "rate": 66.0,
                    "schedule_seed": 1, "pool": 16, "compare": 8, "compare_share": 0.8},
        "end_to_end": [("p95_ms", "ms"), ("setup_s", "s")],
        "per_layer": [("engine_host_ms.open", "ms"), ("mb_size_mean.open", "req"),
                      ("ssd_scan_roofline", "%"), ("int8_codec_roofline.open", "%"),
                      ("idle_pct.open", "%"), ("mfu.open", "%")],
    },
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped where there is none")


def _param_bytes(m: dict) -> int:
    if m["kind"] == "demo_ssm":
        return (2 * m["d"] * m["state"] + m["d"] * m["heads"] + m["heads"]) * 4 * m["n_layers"]
    hd = m["d"] // m["heads"]
    proj = (m["heads"] + 2 * m["kv_heads"]) * hd
    f = m["mlp_mult"] * m["d"]
    return (m["d"] * proj + m["d"] ** 2 + 2 * m["d"] * f) * 4 * m["n_layers"]


def make_tiny_cell(workload: str, **traffic_over):
    """The configured cell ``workload`` at tiny widths on the CPU: each
    edge node's capacity scaled by the model's weight bytes, so the planner
    cuts the same stages."""
    from seifer_bench.lib import bench

    cell = _held(workload) if workload in HELD else bench.cell(workload)
    cfg = copy.deepcopy(cell.config)
    full = _param_bytes(cfg["model"])
    cfg["model"].update(TINY_MODEL[cfg["model"]["kind"]])
    cluster = cfg["deployment"].get("cluster")
    if cluster is not None:
        scale = _param_bytes(cfg["model"]) / full
        cluster["capacity"] = [c if c < 0 else c * scale for c in cluster["capacity"]]
    traffic = {**cell.traffic, **TINY_TRAFFIC[cell.traffic["loop"]], **traffic_over}
    return bench.Cell(name=cell.name, chips=cell.chips, config_name=cell.config_name,
                      config=cfg, traffic_name=cell.traffic_name, traffic=traffic,
                      end_to_end=cell.end_to_end, per_layer=cell.per_layer)


def _held(workload: str):
    """A held cell at its full widths, as ``bench.cell`` would give it."""
    from seifer_bench.lib import bench

    h = HELD[workload]
    cluster = copy.deepcopy(bench.config("phi2-edge")["deployment"]["cluster"])
    cap = _param_bytes(h["model"]) * h["capacity_share"]
    cluster["capacity"] = [c if c < 0 else cap for c in cluster["capacity"]]
    config = {"name": workload, "entry": "edge", "model": h["model"],
              "weights": {"gain": h["gain"]}, "deployment": {**h["deployment"], "cluster": cluster},
              "limits": h["limits"]}
    e2e = tuple({"name": n, "unit": u} for n, u in h["end_to_end"])
    per_layer = tuple({"name": n, "unit": u, "moves": h["end_to_end"][0][0]}
                      for n, u in h["per_layer"])
    return bench.Cell(name=workload, chips=1, config_name=workload, config=config,
                      traffic_name=workload, traffic=h["traffic"], end_to_end=e2e,
                      per_layer=per_layer)


@pytest.fixture
def tiny_cell():
    return make_tiny_cell
