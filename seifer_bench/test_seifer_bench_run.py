"""The command line and the result line, run on the CPU at tiny widths."""

from __future__ import annotations

import ast
import json
import os
import sys
from pathlib import Path

import pytest

from seifer_bench import run

BENCH = Path(__file__).resolve().parent
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", ["mamba2-edge-poisson", "attn-edge-closed"])
@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_the_result_keys(tiny_cell, workload, trace):
    cell = tiny_cell(workload)
    line, notes = run.measure(cell, seed=2**31 + 11, seconds=0.6, trace=trace, device="cpu",
                              t_start=0.0)
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True
    assert set(line["checks"]) == {"rel_err", "row_med"}
    json.loads(json.dumps(line))
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        assert all(m["value"] > 0 for m in line["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device ran here: rooflines and shares read nothing
        assert not any(n.endswith("_roofline") for n in line["metrics"])
    assert notes[-2:] == [f"{n} {line['checks'][n]['value']!r} limit {line['checks'][n]['limit']!r}"
                          for n in ("rel_err", "row_med")]


def test_the_command_line_refuses_to_measure_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # main() sets these for the run's process; the test's process keeps its own
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "pycache_prefix", sys.pycache_prefix)
    monkeypatch.setattr(sys, "dont_write_bytecode", sys.dont_write_bytecode)
    for var in ("PYTHONPYCACHEPREFIX", "PYTHONDONTWRITEBYTECODE", "TRITON_CACHE_DIR",
                "TORCHINDUCTOR_CACHE_DIR"):
        if var in os.environ:
            monkeypatch.setenv(var, os.environ[var])
        else:
            monkeypatch.delenv(var, raising=False)
    rc = run.main(["--workload", "attn-edge-closed", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    mods = dict(sys.modules)
    mods.pop("repro", None)
    mods = {k: v for k, v in mods.items() if k.split(".")[0] not in run.FORBIDDEN}
    mods["repro_torch.fake"] = object()
    monkeypatch.setattr(sys, "modules", mods)
    assert run.forbidden_modules() == []
    mods["repro.core"] = object()
    mods["jaxlib"] = object()
    assert run.forbidden_modules() == ["jaxlib", "repro"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def test_no_file_imports_jax_or_the_jax_package_and_the_reference_none_of_the_port():
    for path in BENCH.rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        if path.parent.name == "reference":
            assert "repro_torch" not in tops, path


def test_p95_counts_a_missed_request_as_missing():
    assert run.p95([1.0] * 95 + [2.0] * 5) == 1.0
    assert run.p95([1.0] * 94 + [None] * 6) == run.MISSED_MS


def test_an_open_mix_file_sets_its_process_and_its_parameters(tiny_cell, tmp_path,
                                                               monkeypatch):
    from seifer_bench.entries import edge
    from seifer_bench.lib import arrivals, bench

    (tmp_path / "traffic").mkdir()
    mix = {"loop": "open", "process": "bursty", "rate": 40.0, "schedule_seed": 3,
           "process_args": {"burst_factor": 4.0, "burst_frac": 0.2, "cycles": 2.0},
           "pool": 4, "compare": 4, "compare_share": 0.8}
    (tmp_path / "traffic" / "bursty-mix.json").write_text(json.dumps(mix))
    with monkeypatch.context() as m:
        m.setattr(bench, "BENCH_DIR", tmp_path)
        read = bench.traffic("bursty-mix")
    times = edge.schedule(read, 5.0)
    assert times == arrivals.arrival_times("bursty", rate=40.0, duration_s=5.0, seed=3,
                                           burst_factor=4.0, burst_frac=0.2, cycles=2.0)
    assert times != arrivals.arrival_times("bursty", rate=40.0, duration_s=5.0, seed=3)
    line, _ = run.measure(tiny_cell("mamba2-edge-poisson", **read), seed=2**31 + 61,
                          seconds=0.6, trace=False, device="cpu", t_start=0.0)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] == len(edge.schedule(read, 0.6))
