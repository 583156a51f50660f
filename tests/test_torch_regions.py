"""The port's ``seifer.*`` regions (``repro_torch.obs.region``): named
``record_function`` labels around the real work of the pipelined engine
and of ``make_gpipe``, which a ``torch.profiler`` trace shows beside the
kernels they launch, and the engine's admission wait on the host clock.

Under a CPU profiler, a tiny int8 ``demo_transformer`` deployment opens
one ``seifer.stage.<s>`` region a stage compute and one hop region a
transfer, every one inside ``seifer.engine.step``; ``make_gpipe`` opens one
``seifer.gpipe.compute`` a stage-tick, in turn and on 4 gloo ranks, where
each rank's exchanges at the ticks on which every stage is active are
``exchange.full``.  With the profiler off no label is opened at all.
"""

from __future__ import annotations

import collections
import json

import pytest
import torch

from _gpipe_region_ranks import N_MICRO, WORLD, run_ranks
from repro_torch.api import ClusterSpec, DeploymentSpec, deploy
from repro_torch.core.model_zoo import demo_transformer
from repro_torch.obs import region
from repro_torch.runtime.pipeline import make_gpipe

N_REQUESTS = 16
HOP = ("encode", "transcode")


def _deployment():
    graph, ex = demo_transformer(device="cpu")
    return deploy(DeploymentSpec(
        model=graph, executor_for_version=ex,
        cluster=ClusterSpec(n_nodes=8, capacity_bytes=graph.total_param_bytes / 3, seed=3),
        codec="int8", seed=0, microbatch=4, device="cpu"))


def _serve(d, n=N_REQUESTS):
    x = torch.ones((256, 32)) * 0.1
    for _ in range(n):
        d.submit(x)
    d.drain()


def _regions(events):
    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.name.startswith("seifer.")]


@pytest.fixture(scope="module")
def served():
    """A deployment served under a CPU profiler: its regions and metrics."""
    d = _deployment()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _serve(d)
    return _regions(prof.events()), d.loop.metrics(), d.loop.host_counters()


def test_every_engine_region_nests_inside_a_step(served):
    regions, _, _ = served
    steps = [(t0, t1) for name, t0, t1 in regions if name == "seifer.engine.step"]
    inner = [r for r in regions if r[0] != "seifer.engine.step"]
    names = {name for name, _, _ in inner}
    assert steps and "seifer.engine.admit" in names
    assert {n for n in names if n.startswith("seifer.stage.")}
    assert {n for n in names if n.startswith("seifer.hop.")}
    for name, t0, t1 in inner:
        assert any(a <= t0 and t1 <= b for a, b in steps), name


def test_stage_and_hop_regions_count_the_engines_computes_and_transfers(served):
    regions, m, _ = served
    counts = collections.Counter(name for name, _, _ in regions)
    assert [counts[f"seifer.stage.{s}"] for s in range(len(m["stages"]))] == \
        [st["microbatches"] for st in m["stages"]]
    hops = [sum(counts[f"seifer.hop.{ln['hop']}.{kind}"] for kind in HOP) for ln in m["links"]]
    assert hops == [ln["transfers"] for ln in m["links"]]
    assert any(ln["codec"] == "int8" for ln in m["links"])
    # one admission a microbatch: every request rode one
    assert counts["seifer.engine.admit"] == m["microbatches"] == N_REQUESTS // 4


def test_the_admission_wait_is_counted_on_the_host_and_kept_out_of_metrics(served):
    _, m, host = served
    wait = host["admission_wait"]
    assert wait["count"] == m["completed"] == N_REQUESTS and wait["sum_s"] > 0
    assert "admission_wait" not in json.dumps(m)


def test_with_the_profiler_off_no_region_is_opened(monkeypatch):
    """``region`` never builds a label: the engine and ``make_gpipe`` run
    through with ``record_function`` raising, and the served metrics are
    those of a run under the profiler."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with the profiler off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert region("seifer.engine.step") is region("seifer.stage.0")
    d = _deployment()
    _serve(d)
    assert d.loop.metrics()["completed"] == N_REQUESTS
    pipe = make_gpipe(lambda w, x: torch.tanh(x @ w[0]), 2, n_micro=3, compress=True,
                      quant_block=8)
    assert pipe(torch.eye(8)[None, None].expand(2, 1, 8, 8), torch.ones(3, 2, 8)).shape == \
        (3, 2, 8)


def test_the_engines_metrics_are_the_same_with_the_profiler_on(served):
    _, traced, _ = served
    d = _deployment()
    _serve(d)
    assert json.dumps(d.loop.metrics(), sort_keys=True) == json.dumps(traced, sort_keys=True)


def test_make_gpipe_in_turn_opens_a_compute_region_a_stage_tick():
    n_stages, d = WORLD, 8
    pipe = make_gpipe(lambda w, x: torch.tanh(x @ w[0]), n_stages, n_micro=N_MICRO,
                      compress=True, quant_block=d)
    w = torch.randn(n_stages, 1, d, d, generator=torch.Generator().manual_seed(1)) / d ** 0.5
    x = torch.randn(N_MICRO, 2, d, generator=torch.Generator().manual_seed(2))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = pipe(w, x)
    counts = collections.Counter(name for name, _, _ in _regions(prof.events()))
    boundaries = (n_stages - 1) * N_MICRO
    assert counts == {"seifer.gpipe.compute": n_stages * N_MICRO,
                      "seifer.gpipe.encode": boundaries, "seifer.gpipe.decode": boundaries}
    assert torch.equal(out, pipe(w, x))


def test_make_gpipe_on_four_gloo_ranks_names_full_and_edge_exchanges(tmp_path):
    """16 microbatches through 4 stages: 19 ticks; a rank computes at 16,
    and exchanges at the 13 on which every stage is active (``.full``) and
    at the fill's or the drain's ticks on which it sends or receives
    (``.edge``: 3 for the first and the last stage, 4 for the middle ones)."""
    reps = run_ranks(tmp_path)
    for p, rep in enumerate(reps):
        got = collections.Counter(rep["regions"])
        assert got["seifer.gpipe.compute"] == N_MICRO, p
        assert got["seifer.gpipe.exchange.full"] == N_MICRO - WORLD + 1, p
        assert got["seifer.gpipe.exchange.edge"] == (3 if p in (0, WORLD - 1) else 4), p
        assert got["seifer.gpipe.broadcast"] == 1, p
        assert got["seifer.gpipe.encode"] == (N_MICRO if p < WORLD - 1 else 0), p
        assert got["seifer.gpipe.decode"] == (N_MICRO if p > 0 else 0), p
    assert all(rep["out"] == reps[0]["out"] for rep in reps)
