"""The program's own regions in a traced run, for ``tools/regions.py``.

The port opens ``record_function`` labels named ``seifer.*`` around its
real work (``repro_torch.obs.region``): the engine's step, admission, each
stage's compute and each hop's codec, and ``make_gpipe``'s compute,
boundary codec, exchanges and broadcast.  ``program`` keeps each as
``(name, t0_us, t1_us, device_us)`` on the profiler's clock, where
``device_us`` is the device time of the operations launched inside it.

An operation is joined to its launch call (``cudaLaunchKernel``,
``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...) by the id the profiler gives
both.  ``FunctionEvent.device_time_total`` is not used: on torch 2.11 it
counts a kernel again for each CUPTI bookkeeping event that shares its
operator's id, and misses a kernel launched outside an aten operator (the
port's own kernels, launched through ``ctypes``).

``install`` makes every traced run of this process, and of the processes
forked from it afterwards, keep these regions under the reduced trace's
``program`` key; the reduction's other keys come out as they were.  The
benchmark's own runs do not install it, so no metric of ``BENCHMARK.json``
reads the regions.  ``stage_device_ms``, ``engine_self_ms`` and
``gpipe_hop_ms`` are the quantities the tool prints from them.
"""

from __future__ import annotations

import bisect
import re

from seifer_bench.lib import trace

PREFIX = "seifer."
STEP = "seifer.engine.step"
STAGE = re.compile(r"seifer\.(stage\.\d+|gpipe\.compute)$")
STEP_CHILD = re.compile(r"seifer\.(engine\.admit|stage\.\d+|hop\.\d+\.(encode|transcode))$")
FULL_HOP = "seifer.gpipe.exchange.full"


def region_device_us(regions, launches) -> list[float]:
    """For each region ``(thread, t0, t1)``, the summed device time of the
    operations whose launch call (``(thread, t_launch, device_us)``) began
    inside it on its thread, nested regions' launches included."""
    by_thread: dict = {}
    for thread, t, us in sorted(launches, key=lambda x: x[1]):
        times, sums = by_thread.setdefault(thread, ([], [0.0]))
        times.append(t)
        sums.append(sums[-1] + us)
    out = []
    for thread, t0, t1 in regions:
        times, sums = by_thread.get(thread, ([], [0.0]))
        out.append(sums[bisect.bisect_right(times, t1)] - sums[bisect.bisect_left(times, t0)])
    return out


def program(events) -> list[tuple[str, float, float, float]]:
    """The profiler's ``seifer.*`` host regions ``(name, t0_us, t1_us,
    device_us)``, sorted by start."""
    from torch.autograd import DeviceType

    regions, calls, op_ids = [], {}, []
    for e in events:
        t0, t1 = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            # as ``trace.reduce_events``: a label's mirror is no operation
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")):
                op_ids.append((e.id, t1 - t0))
        elif e.name.startswith(PREFIX):
            regions.append((e.name, e.thread, t0, t1))
        elif e.name.startswith("cu"):  # a CUDA runtime or driver call
            calls[e.id] = (e.thread, t0)
    launches = [(*calls[i], us) for i, us in op_ids if i in calls]
    device = region_device_us([r[1:] for r in regions], launches)
    return sorted(((name, t0, t1, us) for (name, _, t0, t1), us in zip(regions, device)),
                  key=lambda s: s[1])


def install() -> None:
    """Keep the program's regions in every traced run from here on."""
    reduce = trace.reduce_events
    if getattr(reduce, "keeps_regions", False):
        return

    def reduce_with_regions(events, wall_s: float) -> dict:
        data = reduce(events, wall_s)
        data["program"] = program(events)
        return data

    reduce_with_regions.keeps_regions = True
    trace.reduce_events = reduce_with_regions


def stage_device_ms(obs) -> float | None:
    """Device ms of one stage's compute for one microbatch, the largest over
    the stages and the ranks traced: per rank and stage (``seifer.stage.<s>``,
    or a GPipe rank's ``seifer.gpipe.compute``), the regions' device time
    over their number."""
    means = []
    for data in obs.get("trace", ()):
        by_stage: dict[str, list[float]] = {}
        for name, _, _, device_us in data.get("program", ()):
            if STAGE.match(name):
                by_stage.setdefault(name, []).append(device_us)
        means += [sum(v) / len(v) for v in by_stage.values()]
    worst = max(means, default=0.0)
    return worst / 1e3 if worst > 0 else None


def step_self_us(program_regions) -> float:
    """Host us in the outermost step regions less their nested admission,
    stage and hop regions'."""
    steps: list[tuple[float, float]] = []
    for name, t0, t1, _ in program_regions:  # sorted by start: drop steps inside steps
        if name == STEP and not (steps and t1 <= steps[-1][1]):
            steps.append((t0, t1))
    starts = [t0 for t0, _ in steps]
    total = sum(t1 - t0 for t0, t1 in steps)
    for name, t0, t1, _ in program_regions:
        i = bisect.bisect_right(starts, t0) - 1
        if STEP_CHILD.match(name) and i >= 0 and t1 <= steps[i][1]:
            total -= t1 - t0
    return total


def engine_self_ms(obs) -> float | None:
    """Host ms of the engine's own work a microbatch served: scheduling on
    the virtual clock and Python between the launches.  ``None`` in a run
    with no device time (a CPU run has no device to wait on the host)."""
    datas = [d.get("program", ()) for d in obs.get("trace", ())]
    traced = [p for p in datas if any(name == STEP for name, *_ in p)]
    if not obs.get("microbatches") or not any(dev > 0 for p in traced for *_, dev in p):
        return None
    return sum(step_self_us(p) for p in traced) / 1e3 / obs["microbatches"]


def gpipe_hop_ms(obs) -> float | None:
    """Device ms of one boundary exchange at a full tick of the GPipe (every
    stage active): per rank, the mean over its ``seifer.gpipe.exchange.full``
    regions, the largest over the ranks.  A reading far above the transfer's
    own time means the neighbours' computes are out of step."""
    means = []
    for data in obs.get("trace", ()):
        hops = [device_us for name, _, _, device_us in data.get("program", ())
                if name == FULL_HOP]
        if hops:
            means.append(sum(hops) / len(hops))
    worst = max(means, default=0.0)
    return worst / 1e3 if worst > 0 else None


QUANTITIES = {"stage_device_ms": stage_device_ms, "engine_self_ms": engine_self_ms,
              "gpipe_hop_ms": gpipe_hop_ms}
