"""The device trace of a ``--trace 1`` run, and its reduction.

``Profile`` runs ``torch.profiler`` (CPU and CUDA activities) over the
measured window, from a synchronised device to a synchronised device, so
every kernel launched in the window ends in it.  It keeps three lists:
the device's operations ``(name, start_us, end_us)`` (kernels, copies and
sets), the benchmark's own host spans (``record_function`` labels named
``bench.*``, opened around its calls into the program) and the window's
bounds, all on the profiler's clock.  ``span`` opens such a label; outside
a traced run it costs one branch.

The reductions here are the same for every cell: the seconds in which the
device was busy (the union of its operations), the longest idle gaps named
by the innermost host span that covers each, and the operations that took
the most time.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time

WINDOW_LABEL = "bench.window"


@contextlib.contextmanager
def span(label: str, on: bool):
    """A host span the trace names idle gaps by (a no-op when not traced)."""
    if not on:
        yield
        return
    import torch

    with torch.profiler.record_function(label):
        yield


class Profile:
    """``with Profile(on, device) as p:`` traces the block when ``on``;
    ``p.data`` is then the window's reduction input (``None`` when off)."""

    def __init__(self, on: bool, device: str):
        self.on = on
        self.device = device
        self.data = None
        self._prof = None
        self._label = None

    def _sync(self) -> None:
        if self.device.startswith("cuda"):
            import torch

            torch.cuda.synchronize()

    def __enter__(self):
        if not self.on:
            return self
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._label = torch.profiler.record_function(WINDOW_LABEL)
        self._label.__enter__()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        self._sync()
        wall = time.monotonic() - self._t0
        self._label.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        if exc[0] is None:
            self.data = reduce_events(self._prof.events(), wall)
        return False


def reduce_events(events, wall_s: float) -> dict:
    """The profiler's events as plain lists: device operations, the bench's
    host spans, the window (in us on the profiler's clock) and its length
    by the host clock."""
    from torch.autograd import DeviceType

    ops, labels, window = [], [], None
    for e in events:
        t0, t1 = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            # the profiler mirrors each host label onto the device's timeline
            # (a user annotation): a span, not an operation that ran there
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")):
                ops.append((e.name, t0, t1))
        elif e.name == WINDOW_LABEL:
            window = (t0, t1)
        elif e.name.startswith("bench."):
            labels.append((e.name, t0, t1))
    if window is None:  # no label came back: the operations' own span
        window = (min((o[1] for o in ops), default=0.0), max((o[2] for o in ops), default=0.0))
    ops.sort(key=lambda o: o[1])
    labels.sort(key=lambda s: s[1])
    return {"ops": ops, "labels": labels, "window_us": window, "wall_s": wall_s}


def busy_intervals(ops) -> list[tuple[float, float]]:
    """The union of the operations' intervals, merged, in order."""
    merged: list[list[float]] = []
    for _, t0, t1 in sorted(ops, key=lambda o: o[1]):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return [(a, b) for a, b in merged]


def busy_s(data: dict) -> float:
    return sum(b - a for a, b in busy_intervals(data["ops"])) / 1e6


def window_s(data: dict) -> float:
    t0, t1 = data["window_us"]
    return (t1 - t0) / 1e6


def _host_label(labels, starts, t: float) -> str:
    """The innermost (latest-starting) bench span that covers time t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 64), -1):
        name, t0, t1 = labels[j]
        if t0 <= t <= t1:
            return name
    return "host outside the bench's spans"


def idle_gaps(data: dict) -> list[tuple[str, float, float]]:
    """(host span, start_us, seconds) of every gap in the window in which no
    device operation ran."""
    w0, w1 = data["window_us"]
    labels = data["labels"]
    starts = [s[1] for s in labels]
    gaps, cursor = [], w0
    for a, b in busy_intervals(data["ops"]) + [(w1, w1)]:
        a, b = max(a, w0), min(b, w1)
        if a > cursor:
            gaps.append((_host_label(labels, starts, (cursor + a) / 2), cursor, (a - cursor) / 1e6))
        cursor = max(cursor, b)
    return gaps


def short_name(name: str) -> str:
    """A kernel's name without its return type and its argument list."""
    name = re.sub(r"^void\s+", "", name.strip())
    if name.endswith(")"):  # drop the trailing balanced (...) of the arguments
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip() or name
                break
    return name[:120]


def breakdown(datas: list[dict], top: int = 10) -> dict:
    """The device operations that took the most time and the longest idle
    gaps, each [name, seconds] and averaged over the ranks traced: gaps are
    summed by the host span they fell in."""
    n = max(1, len(datas))
    by_op: dict[str, float] = {}
    by_gap: dict[str, float] = {}
    for d in datas:
        for name, t0, t1 in d["ops"]:
            key = short_name(name)
            by_op[key] = by_op.get(key, 0.0) + (t1 - t0) / 1e6 / n
        for label, _, secs in idle_gaps(d):
            by_gap[label] = by_gap.get(label, 0.0) + secs / n
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def matching(data: dict, patterns) -> list[tuple[str, float, float]]:
    """The device operations whose name matches any of ``patterns``."""
    rx = [re.compile(p) for p in patterns]
    return [o for o in data["ops"] if any(r.search(o[0]) for r in rx)]


def op_seconds(data: dict, patterns) -> float:
    return sum(t1 - t0 for _, t0, t1 in matching(data, patterns)) / 1e6
