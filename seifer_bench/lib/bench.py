"""Finding a cell's parts by name, seeds, and the run's context.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
configuration names the entry that runs it.  Each is a file found by its
name, so a later cell adds files and entries and edits none:

- ``configs/<config>.json``: the model, its widths, the deployment and
  ``entry``;
- ``traffic/<traffic>.json``: the mix's parameters, read by the entry's
  generator;
- ``entries/<entry>.py``: ``run(ctx) -> Observed``;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(obs)``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# where a run keeps what it writes (the program's artifact store): a fixed
# path inside the checkout, which .gitignore lists
WORK_DIR = ROOT / "build" / "seifer_bench"


class BenchError(RuntimeError):
    """A cell that cannot run as defined (a missing file, a bad name, a
    deployment other than the configured one)."""


def load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError as e:
        raise BenchError(f"{path.relative_to(ROOT)} is missing") from e


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _named(kind: str, name: str, suffix: str) -> Path:
    if not name or "/" in name or name.startswith("."):
        raise BenchError(f"bad {kind} name {name!r}")
    return BENCH_DIR / kind / f"{name}{suffix}"


def config(name: str) -> dict:
    return load_json(_named("configs", name, ".json"))


def traffic(name: str) -> dict:
    return load_json(_named("traffic", name, ".json"))


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (a metric's name may hold dots)."""
    path = _named(kind, name, ".py")
    if not path.exists():
        raise BenchError(f"{path.relative_to(ROOT)} is missing")
    mod_name = f"seifer_bench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    loaded = sys.modules.get(mod_name)
    if loaded is not None and Path(getattr(loaded, "__file__", "")) == path:
        return loaded  # imported already (an entry's ranks import it by name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with the files it names, and the metrics
    of ``BENCHMARK.json`` that it reports."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: tuple[dict, ...]
    per_layer: tuple[dict, ...]


def _reported_in(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json; known: "
                         f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    e2e = tuple(m for m in bench["end_to_end"]
                if "workloads" not in m or name in m["workloads"])
    e2e_names = {m["name"] for m in e2e}
    per_layer = tuple(m for m in bench["per_layer"] if _reported_in(m, name, e2e_names))
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config(w["config"]), traffic_name=w["traffic"],
                traffic=traffic(w["traffic"]), end_to_end=e2e, per_layer=per_layer)


def sub_seed(seed: int, *tags: Any) -> int:
    """A 63-bit seed for one use of the run's seed (weights, inputs, ...)."""
    digest = hashlib.sha256(repr((int(seed), tags)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclasses.dataclass
class Context:
    """What an entry is given: the cell, the run's arguments, the device,
    the moment the process started (``setup_s`` counts from it) and, in a
    traced run, the metric readers whose program calls it records."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    readers: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Observed:
    """What an entry measured; ``run.py`` turns it into the result line.

    ``window_s`` and ``completed`` give ``req_per_s``, ``latencies_ms`` (one
    entry per request offered, ``None`` for one that missed the window)
    ``p95_ms``, ``setup_s`` the seconds from process start to the first
    timed request.  ``checks`` are the numbers compared, each
    ``(name, value, limit)``: the run is correct when every value is at most
    its limit.  ``obs`` is what the per-layer readers read."""

    attempted: int
    failed: int
    completed: int
    window_s: float
    setup_s: float
    latencies_ms: list
    checks: list
    memory_peak_bytes: int
    count: int
    obs: dict = dataclasses.field(default_factory=dict)
    notes: list = dataclasses.field(default_factory=list)
