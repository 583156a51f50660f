"""Cells served through ``repro_torch.api.deploy``: the paper's edge pipeline.

Set-up makes the weights and a pool of distinct inputs on the device from
the seed, deploys the configured model on the configured cluster (int8 hops
between stages, the pipelined engine) and warms up every batch size the
traffic can form.  The window then drives ``Deployment.submit`` and
``Deployment.step`` on the wall clock:

- ``open`` traffic submits each request when it is due and times it from
  then: the arrival ``process`` of ``lib/arrivals.py`` at the mix's fixed
  ``rate``, with that process's own parameters (``process_args``), on the
  mix's fixed ``schedule_seed``; the sample compared is drawn from the
  first ``compare_share`` of the window's arrivals;
- ``closed`` traffic keeps ``clients`` requests in the system, each client
  sending its next request when its last one completes; the sample compared
  is drawn from the window's first ``compare_first`` requests.

Requests cycle through a pool of ``pool`` distinct inputs, and ``compare``
of them are sampled.

A request is done when its output is ready on the device: after a ``step``
that completed requests the harness records an event and synchronises on
it, as a server returning the result would.  Outputs are dropped as they
complete except a sample drawn from the seed, which is compared with the
plain reference (``reference/models.py``) once the window has closed, the
program's state has been freed and the memory peak read.
"""

from __future__ import annotations

import gc
import math
import shutil
import time

import numpy as np

from seifer_bench.lib import arrivals, calls, costs, weights
from seifer_bench.lib.bench import WORK_DIR, BenchError, Context, Observed, sub_seed
from seifer_bench.lib.trace import Profile, span
from seifer_bench.reference import models as reference

LATE_S = 60.0  # how long after the close a sampled answer is waited for


class Served:
    """The deployed model with its weights, inputs and configuration."""

    def __init__(self, ctx: Context):
        import torch

        from repro_torch.api import ClusterSpec, DeploymentSpec, deploy
        from repro_torch.core import model_zoo
        from repro_torch.core.placement import CommGraph

        cfg = ctx.cell.config
        self.model, dep, self.device = cfg["model"], cfg["deployment"], ctx.device
        self.marks = [("imports", time.monotonic())]
        if ctx.device.startswith("cuda"):
            from repro_torch.kernels import _build

            _build.lib()  # built by nvcc on a checkout's first run, loaded after
            self.marks.append(("kernel library", time.monotonic()))
        self.weights = weights.draw(self.model, ctx.seed, self.device, gain=cfg["weights"]["gain"])
        # the port takes weights as host arrays (``params_for_version``)
        host = {k: v.cpu() for k, v in self.weights.items()}
        ctor = getattr(model_zoo, self.model["kind"])
        widths = {k: v for k, v in self.model.items() if k not in ("kind", "a")}
        self.marks.append(("weights", time.monotonic()))
        graph, ex = ctor(**widths, device=self.device, params_for_version=lambda v: host)
        cluster = dep["cluster"]
        comm = CommGraph(bw=np.asarray(cluster["bw"], float),
                         node_capacity=np.asarray(cluster["capacity"], float))
        store = WORK_DIR / "store" / ctx.cell.name
        shutil.rmtree(store, ignore_errors=True)
        self.dep = deploy(DeploymentSpec(
            model=graph, executor_for_version=ex, cluster=ClusterSpec(comm=comm),
            codec=dep["codec"], serving=dep["serving"], queue_depth=dep["queue_depth"],
            microbatch=dep["microbatch"], max_batch=dep.get("max_batch"),
            seed=dep["seed"], device=self.device), store_root=str(store))
        self.marks.append(("deploy", time.monotonic()))
        self.stages = [[p.partition.start, p.partition.stop]
                       for p in self.dep.control.pipeline.pods]
        codecs = list(self.dep.plan.codecs)
        if self.stages != dep["stages"] or codecs != dep["codecs"]:
            raise BenchError(f"deployed stages {self.stages} and hop codecs {codecs}, but the "
                             f"configuration states {dep['stages']} and {dep['codecs']}")
        self.block = dep["codec_block"]
        self.batch_cap = dep.get("max_batch") or dep["microbatch"]
        self.request_flops = (
            costs.demo_ssm_request_flops(**widths) if self.model["kind"] == "demo_ssm"
            else costs.demo_transformer_request_flops(
                **{k: widths[k] for k in ("d", "n_layers", "seq", "heads", "kv_heads",
                                          "mlp_mult", "window")}))
        self.event = torch.cuda.Event() if self.device.startswith("cuda") else None

    def done(self) -> None:
        """Wait until the outputs of the steps so far are on the device."""
        if self.event is not None:
            self.event.record()
            self.event.synchronize()

    def counters(self) -> dict:
        m = self.dep.loop.metrics()
        return {"completed": m["completed"], "microbatches": m["microbatches"],
                "failed": m["failed"], "rejected": m["rejected"]}

    def warm_up(self, pool, rounds: int = 2) -> None:
        """Serve every batch size up to the cap ``rounds`` times, so that no
        shape meets the window first."""
        for r in range(rounds):
            if r:
                self.marks.append(("first warm-up round", time.monotonic()))
            for b in range(1, self.batch_cap + 1):
                reqs = [self.dep.submit(pool[i % len(pool)]) for i in range(b)]
                self.dep.drain()
                self.done()
                if r == 0 and b == 1:
                    self.marks.append(("first request", time.monotonic()))
                if any(r.result is None for r in reqs):
                    raise BenchError("a warm-up request did not complete")
                for r in reqs:
                    r.result = None


def schedule(tr: dict, seconds: float) -> list[float]:
    """An open mix's arrival offsets over ``seconds``: its ``process`` at its
    ``rate`` with the process's own parameters (``process_args``), drawn from
    the mix's ``schedule_seed``, so that every seed of a run offers the same
    arrivals and changes only the weights and inputs."""
    return arrivals.arrival_times(tr["process"], rate=tr["rate"], duration_s=seconds,
                                  seed=tr["schedule_seed"], **tr.get("process_args", {}))


def _sample(seed: int, first: int, count: int) -> set[int]:
    """``count`` request indices below ``first``, drawn from the seed."""
    rng = np.random.default_rng(sub_seed(seed, "sample") % 2**63)
    return {int(i) for i in rng.choice(first, size=min(count, first), replace=False)}


class Window:
    """Book-keeping of the measured window: per-request due times and
    latencies, the kept answers, the host's time in ``step()``."""

    def __init__(self, served: Served, ctx: Context, keep: set[int]):
        self.s, self.ctx, self.keep = served, ctx, keep
        self.index_of: dict[int, int] = {}  # req_id -> request index
        self.due: dict[int, float] = {}  # request index -> due (window seconds)
        self.latency_ms: dict[int, float] = {}
        self.kept: dict[int, object] = {}
        self.step_host_s = 0.0
        self.step_wall_s = 0.0
        self.t0 = 0.0

    def submit(self, index: int, pool, due: float) -> None:
        with span("bench.submit", self.ctx.trace):
            req = self.s.dep.submit(pool[index % len(pool)])
        self.index_of[req.req_id] = index
        self.due[index] = due

    def step(self, in_window: bool) -> list[int]:
        """One ``Deployment.step``; returns the indices it completed."""
        t = time.monotonic()
        with span("bench.step", self.ctx.trace):
            done = self.s.dep.step()
        t_host = time.monotonic()
        if done:
            with span("bench.sync", self.ctx.trace):
                self.s.done()
        t_end = time.monotonic()
        if in_window:
            self.step_host_s += t_host - t
            self.step_wall_s += t_end - t
        finished = []
        for r in done:
            i = self.index_of[r.req_id]
            if in_window:
                self.latency_ms[i] = (t_end - self.t0 - self.due[i]) * 1e3
            if i in self.keep:
                self.kept[i] = r.result.clone()
            r.result = None  # only the sampled answers are kept
            finished.append(i)
        return finished


def _open_loop(served: Served, ctx: Context, pool, win: Window, times) -> tuple[int, float]:
    """Offer ``times`` (seconds into the window) as they fall due; returns
    (requests submitted in the window, the generator's largest lag)."""
    nxt, lag = 0, 0.0
    while True:
        now = time.monotonic() - win.t0
        if now >= ctx.seconds:
            return nxt, lag
        while nxt < len(times) and times[nxt] <= now:
            lag = max(lag, now - times[nxt])
            win.submit(nxt, pool, times[nxt])
            nxt += 1
        if served.dep.loop.backlog:
            win.step(True)
        elif nxt < len(times):
            with span("bench.wait", ctx.trace):
                time.sleep(max(0.0, min(times[nxt], ctx.seconds) - (time.monotonic() - win.t0)))
        else:
            with span("bench.wait", ctx.trace):
                time.sleep(max(0.0, ctx.seconds - now))


def _closed_loop(served: Served, ctx: Context, win: Window, pool, nxt: int) -> tuple[int, float]:
    """Resubmit for every client whose request completed, until the window
    has lasted ``ctx.seconds`` at a completion; returns (the next request
    index, the window's seconds up to that completion)."""
    while True:
        finished = win.step(True)
        if finished:
            t = time.monotonic() - win.t0
            for _ in finished:
                win.submit(nxt, pool, t)
                nxt += 1
            if t >= ctx.seconds:
                return nxt, t
        elif not served.dep.loop.backlog:
            raise BenchError("the closed loop ran dry")


def run(ctx: Context) -> Observed:
    import torch

    tr = ctx.cell.traffic
    served = Served(ctx)
    pool = weights.inputs(served.model, ctx.seed, tr["pool"], ctx.device)
    served.marks.append(("inputs", time.monotonic()))
    served.warm_up(pool)
    served.marks.append(("warm-up", time.monotonic()))
    kind = tr["loop"]
    if kind not in ("open", "closed"):
        raise BenchError(f"unknown loop {kind!r}")
    sites = [s for r in ctx.readers.values() for s in getattr(r, "CALLS", ())]
    call_log: list = []
    win = Window(served, ctx, set())
    nxt = 0
    if kind == "open":
        times = schedule(tr, ctx.seconds)
        win.keep = _sample(ctx.seed, max(1, int(len(times) * tr["compare_share"])),
                           tr["compare"])
    else:  # fill the pipeline, then open the window at a completion
        win.t0 = time.monotonic()
        for _ in range(tr["clients"]):
            win.submit(nxt, pool, 0.0)
            nxt += 1
        while nxt < tr["clients"] * (1 + tr["fill_rounds"]):
            for _ in win.step(False):
                win.submit(nxt, pool, time.monotonic() - win.t0)
                nxt += 1
        win.keep = {nxt + i for i in _sample(ctx.seed, tr["compare_first"], tr["compare"])}
    if ctx.device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    c0 = served.counters()
    with calls.record(sites if ctx.trace else (), call_log), \
            Profile(ctx.trace, ctx.device) as prof:
        t0 = time.monotonic()
        if kind == "closed":  # due times so far were from the fill's start
            win.due = {i: due - (t0 - win.t0) for i, due in win.due.items()}
        win.t0 = t0
        setup_s = t0 - ctx.t_start
        if kind == "open":
            submitted, lag = _open_loop(served, ctx, pool, win, times)
            window_s = ctx.seconds
        else:
            nxt, window_s = _closed_loop(served, ctx, win, pool, nxt)
            lag = 0.0
    c1 = served.counters()
    completed = len(win.latency_ms)
    if kind == "open":
        attempted = len(times)
        latencies = [win.latency_ms.get(i) for i in range(attempted)]
        failed = attempted - completed
        for i in sorted(win.keep):  # a sampled answer not yet asked for
            if i >= submitted:
                win.submit(i, pool, times[i])
    else:
        attempted = completed + served.dep.loop.backlog
        latencies = list(win.latency_ms.values())
        failed = (c1["failed"] - c0["failed"]) + (c1["rejected"] - c0["rejected"])
        for i in sorted(win.keep):  # a sampled answer not yet asked for
            if i >= nxt:
                win.submit(i, pool, 0.0)
    t_close = time.monotonic()
    while served.dep.loop.backlog and time.monotonic() - t_close < LATE_S:
        win.step(False)
    peak = int(torch.cuda.max_memory_allocated()) if ctx.device.startswith("cuda") else 0
    microbatches = c1["microbatches"] - c0["microbatches"]
    notes = [f"window {window_s:.3f} s: {attempted} offered, {completed} done in it, "
             f"{microbatches} microbatches; generator lag at most {lag * 1e3:.3f} ms; "
             f"stages {served.stages}",
             "set-up: " + ", ".join(
                 f"{name} {t - prev:.3f} s" for (name, t), prev in
                 zip(served.marks, [ctx.t_start] + [t for _, t in served.marks]))]
    obs = {"chips": 1, "window_s": window_s, "completed": completed,
           "microbatches": microbatches,
           "engine_completed": c1["completed"] - c0["completed"], "step_host_s": win.step_host_s,
           "step_wall_s": win.step_wall_s, "request_flops": served.request_flops,
           "calls": call_log, "trace": [prof.data] if prof.data is not None else []}
    kept, keep = win.kept, win.keep
    model, stages, block, w = served.model, served.stages, served.block, served.weights
    del served, win, pool
    gc.collect()
    if ctx.device.startswith("cuda"):
        torch.cuda.empty_cache()
    checks = judge(ctx, model, w, kept, keep, stages, block)
    return Observed(attempted=attempted, failed=failed, completed=completed, window_s=window_s,
                    setup_s=setup_s, latencies_ms=latencies, checks=checks,
                    memory_peak_bytes=peak, count=1, obs=obs, notes=notes)


def judge(ctx: Context, model, w, kept: dict, keep: set, stages, block):
    """The numbers compared: each of the configuration's ``limits``, the
    worst over the sampled answers against the reference, beside its limit;
    a sampled answer that never came reads infinitely wrong."""
    pool = weights.inputs(model, ctx.seed, ctx.cell.traffic["pool"], ctx.device)
    errors = [] if set(kept) == set(keep) else [{k: math.inf for k in ("row_med", "row_max", "diff2", "ref2")}]
    by_input: dict[int, list[int]] = {}
    for i in kept:
        by_input.setdefault(i % len(pool), []).append(i)
    order = sorted(by_input)
    for at in range(0, len(order), 4):
        group = order[at:at + 4]
        ref = reference.forward(model, w, pool[group], stages, block)
        for g, p in enumerate(group):
            errors += [reference.relative_errors(kept[i], ref[g]) for i in by_input[p]]
        del ref
    worst = reference.worst_errors(errors)
    return [(k, worst[k], lim) for k, lim in ctx.cell.config["limits"].items()]
