"""The benchmark finds every part of a cell by name, and BENCHMARK.json
keeps to the names it may use."""

from __future__ import annotations

import json
import re

import pytest

from seifer_bench.lib import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_files():
    b = bench.benchmark()
    e2e = {m["name"] for m in b["end_to_end"]}
    for w in b["workloads"]:
        cell = bench.cell(w["name"], b)
        assert cell.config["name"] == w["config"]
        bench.load_module("entries", cell.config["entry"])
        for m in cell.per_layer:
            reader = bench.load_module("metrics", m["name"])
            assert callable(reader.read)
            assert m["moves"] in {x["name"] for x in cell.end_to_end}
        assert {"setup_s"} < {m["name"] for m in cell.end_to_end} <= e2e
        assert cell.per_layer, w["name"]


def test_names_units_and_files_keep_to_their_rules():
    b = bench.benchmark()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]] + [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in b["configs"]:
        assert c["file"].startswith("seifer_bench/configs/")
        assert bench.load_json(bench.ROOT / c["file"])["reduced"] == c["reduced"]
    four = [w for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(b["workloads"]) // 4)
    assert len(json.dumps(b)) < 64 * 1024


def test_a_new_config_mix_and_metric_are_found_without_an_edit(tmp_path, monkeypatch):
    for kind in ("configs", "traffic", "metrics", "entries"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "new-model.json").write_text(
        json.dumps({"name": "new-model", "entry": "toy"}))
    (tmp_path / "traffic" / "new-mix.json").write_text(json.dumps({"loop": "open"}))
    (tmp_path / "metrics" / "new_metric.open.py").write_text(
        "def read(obs):\n    return obs['x'] * 2\n")
    (tmp_path / "entries" / "toy.py").write_text("def run(ctx):\n    return ctx\n")
    monkeypatch.setattr(bench, "BENCH_DIR", tmp_path)
    b = {"workloads": [{"name": "new-cell", "config": "new-model", "traffic": "new-mix",
                        "chips": 1}],
         "end_to_end": [{"name": "setup_s"}],
         "per_layer": [{"name": "new_metric.open", "moves": "setup_s",
                        "workloads": ["new-cell"]}]}
    cell = bench.cell("new-cell", b)
    assert cell.traffic == {"loop": "open"}
    assert [m["name"] for m in cell.per_layer] == ["new_metric.open"]
    assert bench.load_module("metrics", "new_metric.open").read({"x": 21}) == 42
    assert bench.load_module("entries", cell.config["entry"]).run("ctx") == "ctx"


def test_a_missing_or_bad_name_is_refused():
    with pytest.raises(bench.BenchError):
        bench.config("no-such-config")
    with pytest.raises(bench.BenchError):
        bench.traffic("../BENCHMARK")
    with pytest.raises(bench.BenchError):
        bench.cell("no-such-cell")


def test_sub_seeds_take_any_whole_number():
    seeds = [0, 1, 2**31 + 7, 2**40, -5]
    subs = [bench.sub_seed(s, "weights", 0) for s in seeds]
    assert len(set(subs)) == len(subs)
    assert all(0 <= s < 2**63 for s in subs)
    assert bench.sub_seed(2**31 + 7, "weights", 0) == subs[2]
