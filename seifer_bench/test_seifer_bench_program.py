"""The program's regions in a traced run: ``lib/regions`` keeps the
``seifer.*`` host regions with the device time of the kernels launched
inside them, leaves the rest of the reduction as it was, and reads its
three quantities as hand counts on synthetic observations say."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from seifer_bench import run
from seifer_bench.lib import bench, regions
from seifer_bench.lib import trace as tr


def _event(name, t0, t1, device=DeviceType.CPU, ident=0, thread=1, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=t0, end=t1),
                           device_type=device, id=ident, thread=thread,
                           is_user_annotation=annotation)


def _events(with_program: bool):
    """A window with four device operations under a bench span; with the
    program's regions, a step holding a stage, the launch calls of two of
    the operations inside the stage, of the third in the step and of the
    fourth on another thread, and the regions' mirrors on the device's timeline."""
    events = [_event("bench.window", 0.0, 100.0), _event("bench.step", 5.0, 60.0),
              _event("gemm_kernel", 10.0, 40.0, DeviceType.CUDA, ident=16),
              _event("flash_fwd_kernel", 40.0, 55.0, DeviceType.CUDA, ident=29),
              _event("Memcpy DtoD", 56.0, 58.0, DeviceType.CUDA, ident=31),
              _event("quantize_int8_kernel", 58.0, 59.0, DeviceType.CUDA, ident=33),
              _event("cuLaunchKernel", 8.0, 9.5, ident=16),
              _event("cudaLaunchKernel", 9.6, 10.0, ident=29),
              _event("cudaMemcpyAsync", 25.0, 26.0, ident=31),
              _event("cudaLaunchKernel", 25.0, 26.0, ident=33, thread=2),
              _event("aten::mm", 7.5, 9.8, ident=16)]  # an operator of the same id
    if with_program:
        events += [_event("seifer.engine.step", 6.0, 50.0), _event("seifer.stage.0", 7.0, 20.0),
                   _event("seifer.stage.0", 10.0, 45.0, DeviceType.CUDA, annotation=True),
                   _event("seifer.engine.step", 12.0, 50.0, DeviceType.CUDA, annotation=True)]
    return events


def test_install_keeps_the_reduction_as_it_was_and_adds_the_regions(monkeypatch):
    monkeypatch.setattr(tr, "reduce_events", tr.reduce_events)  # restored after the test
    plain = tr.reduce_events(_events(True), 1.5)
    regions.install()
    traced, bare = tr.reduce_events(_events(True), 1.5), tr.reduce_events(_events(False), 1.5)
    assert traced.pop("program") == [("seifer.engine.step", 6.0, 50.0, 47.0),
                                     ("seifer.stage.0", 7.0, 20.0, 45.0)]
    assert traced == plain  # ops, labels, window, wall
    assert tr.breakdown([traced]) == tr.breakdown([bare])
    assert tr.busy_s(traced) == 48e-6
    assert bare["program"] == []
    assert not any(name.startswith("seifer.") for name, _ in tr.breakdown([traced])["device_ops"])


def test_install_wraps_the_reduction_once(monkeypatch):
    monkeypatch.setattr(tr, "reduce_events", tr.reduce_events)
    regions.install()
    wrapped = tr.reduce_events
    regions.install()
    assert tr.reduce_events is wrapped


def test_program_joins_each_operation_to_its_launch_on_the_regions_thread():
    # the stage: the gemm and the flash launched in it; the step: those and
    # the copy; the quantize was launched on another thread
    assert regions.program(_events(True)) == [("seifer.engine.step", 6.0, 50.0, 47.0),
                                              ("seifer.stage.0", 7.0, 20.0, 45.0)]
    assert regions.program(_events(False)) == []


def test_region_device_time_counts_launches_on_its_thread_inside_it():
    launches = [(1, 1.0, 10.0), (1, 2.0, 20.0), (2, 2.5, 400.0), (1, 3.0, 30.0), (1, 9.0, 1.0)]
    spans = [(1, 0.5, 3.0), (1, 2.0, 2.0), (2, 0.0, 9.0), (1, 3.5, 8.5), (3, 0.0, 9.0)]
    assert regions.region_device_us(spans, launches) == [60.0, 20.0, 400.0, 0.0, 0.0]


def _read(name, obs):
    return regions.QUANTITIES[name](obs)


def test_stage_device_ms_is_the_slowest_stage_mean_over_ranks():
    one = {"program": [("seifer.stage.0", 0, 1, 2000.0), ("seifer.stage.0", 2, 3, 4000.0),
                       ("seifer.stage.1", 4, 5, 5000.0), ("seifer.engine.step", 0, 9, 11000.0)]}
    gpipe = {"program": [("seifer.gpipe.compute", 0, 1, 1000.0),
                         ("seifer.gpipe.compute", 2, 3, 3000.0),
                         ("seifer.gpipe.exchange.full", 3, 4, 9000.0)]}
    assert _read("stage_device_ms", {"trace": [one]}) == 5.0
    assert _read("stage_device_ms", {"trace": [gpipe, gpipe]}) == 2.0


def test_engine_self_ms_leaves_out_the_nested_regions():
    program = [("seifer.engine.step", 0.0, 1000.0, 10.0),
               ("seifer.engine.admit", 10.0, 60.0, 0.0),
               ("seifer.stage.0", 100.0, 400.0, 10.0),
               ("seifer.hop.1.encode", 400.0, 450.0, 0.0),
               ("seifer.engine.step", 2000.0, 2600.0, 5.0),
               ("seifer.stage.1", 2100.0, 2500.0, 5.0),
               ("seifer.hop.4.transcode", 2500.0, 2550.0, 0.0),
               ("seifer.stage.0", 3000.0, 3100.0, 0.0)]  # outside every step
    # (1000 - 50 - 300 - 50) + (600 - 400 - 50) = 750 us over 3 microbatches
    obs = {"microbatches": 3, "trace": [{"program": program}]}
    assert _read("engine_self_ms", obs) == pytest.approx(0.25)


def test_gpipe_hop_ms_is_the_slowest_ranks_mean_full_exchange():
    def rank(*full):
        return {"program": [("seifer.gpipe.exchange.full", 0, 1, us) for us in full]
                + [("seifer.gpipe.exchange.edge", 1, 2, 90000.0)]}

    obs = {"trace": [rank(1000.0, 3000.0), rank(2500.0, 3500.0), rank(500.0)]}
    assert _read("gpipe_hop_ms", obs) == 3.0


@pytest.mark.parametrize("name", sorted(regions.QUANTITIES))
def test_a_quantity_without_regions_or_device_time_reads_nothing(name):
    no_device = [("seifer.engine.step", 0, 9, 0.0), ("seifer.stage.0", 1, 2, 0.0),
                 ("seifer.gpipe.compute", 0, 1, 0.0), ("seifer.gpipe.exchange.full", 1, 2, 0.0)]
    for obs in ({}, {"trace": []}, {"microbatches": 4, "trace": [{"program": []}]},
                {"microbatches": 4, "trace": [{"program": no_device}]},
                {"microbatches": 4, "trace": [{"ops": []}]}):
        assert _read(name, obs) is None


def test_a_traced_cpu_run_leaves_the_regions_out_of_the_result_line(tiny_cell):
    line, _ = run.measure(tiny_cell("attn-edge-closed"), seed=2**31 + 5, seconds=0.4,
                          trace=True, device="cpu", t_start=0.0)
    assert line["correct"] is True
    assert not any(n.startswith("seifer.") for n, _ in line["breakdown"]["device_ops"])
    assert not any(n.startswith("seifer.") for n, _ in line["breakdown"]["idle_gaps"])


def test_a_traced_cpu_run_keeps_the_regions_and_reads_no_device_time(tiny_cell, monkeypatch):
    monkeypatch.setattr(tr, "reduce_events", tr.reduce_events)
    regions.install()
    cell = tiny_cell("attn-edge-closed")
    entry = bench.load_module("entries", cell.config["entry"])
    seen = {}

    def keep(ctx, _run=entry.run):
        got = _run(ctx)
        seen["obs"] = got.obs
        return got

    monkeypatch.setattr(entry, "run", keep)
    line, _ = run.measure(cell, seed=2**31 + 6, seconds=0.4, trace=True, device="cpu",
                          t_start=0.0)
    assert line["correct"] is True
    (data,) = seen["obs"]["trace"]
    names = {name for name, *_ in data["program"]}
    assert {"seifer.engine.step", "seifer.engine.admit", "seifer.stage.0"} <= names
    assert all(dev == 0.0 for *_, dev in data["program"])  # no device on the CPU
    assert all(f(seen["obs"]) is None for f in regions.QUANTITIES.values())
