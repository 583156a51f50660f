"""Zamba2's layers served through ``repro_torch.api.deploy``: the edge
pipeline of ``entries/edge.py`` on ``core/model_zoo.zamba2_hybrid``.

The same run as ``edge.py``'s closed loop: set-up makes the weights and a
pool of distinct inputs on the device from the seed, deploys the model on
the configured cluster (int8 hops between stages, the pipelined engine),
checks the planner's stages against the configuration's and warms up every
batch size.  The window keeps ``clients`` requests in the system and closes
at the first completion after ``--seconds`` that ends a round, every client
having completed as many requests as every other: a closed loop's
completions come at uneven intervals (two microbatches share the card), so
a window of an odd number of them reads a rate up to ~0.7% off.
``Window`` and ``_sample`` are ``edge.py``'s.

A request is [h | x0] (S, 2 d): two independent N(0, 1) activations, the
residual stream entering the first layer and the embedding output.  The
weights (``shapes``) are drawn on the device, one generator for each
Mamba2 layer, each shared block and each hybrid layer's own adapter and
linear, seeded from the run's seed: N(0, 1) / sqrt(fan-in) for every
product and the conv (fan-in: its taps) and the conv bias, A_log = log
U[1, 16], dt_bias the inverse softplus of a dt log-uniform on
[``time_step_min``, ``time_step_max``] and floored at ``time_step_floor``,
D and every norm weight 1.  The bench keeps them on the host only: the
deployment holds the one device copy while the window runs.

**How ``correct`` is decided.**  While the window runs, each stage's input
and output rows of the sampled requests (4 of the window's first 32) are
copied to pinned host buffers on a side stream (``StageLog``); the engine
names the requests of the microbatch a stage computes
(``PipelinedServingLoop.computing``).  After the window ``judge`` compares

- each hop: stage 0's input against the request, stage j's against the
  configured codec's round trip (``reference/int8.py``) of stage j-1's
  output, the answer against the last stage's output;
- each stage: its output against ``reference/zamba2.py``'s same layers run
  on the input the stage was handed.

An end-to-end comparison could not see a fault under ~1e-2 of the answer:
an int8 hop turns the last-bit differences before it into whole codes, so
the program and any other f32 computation read ~7e-3 apart after three
hops.  Stage by stage, no hop lies between program and reference.

Besides the result line, the notes give the window's kernel launches
(``repro_torch.kernels.launch_counts``: the grouped scans, flash, the
codec) and the executor's calls of each shared block, a microbatch; the
traced run records them under ``obs["counters"]`` too.
"""

from __future__ import annotations

import gc
import math
import shutil
import time

import numpy as np

from seifer_bench.entries.edge import LATE_S, Window, _sample
from seifer_bench.lib import calls, zamba2_costs
from seifer_bench.lib.bench import WORK_DIR, BenchError, Context, Observed, sub_seed
from seifer_bench.lib.trace import Profile
from seifer_bench.reference import zamba2 as reference
from seifer_bench.reference.int8 import round_trip
from seifer_bench.reference.models import relative_errors, worst_errors

COUNTED = ("ssd_chunked_cuda", "ssd_chunked_cuda_grouped", "flash_attention_cuda",
           "matmul_f32_cuda", "quantize_int8_cuda", "dequantize_int8_cuda")


def shapes(m: dict) -> dict[str, dict[str, tuple[tuple[int, ...], int]]]:
    """kind -> name -> (one copy's shape, fan-in) of the weights: each Mamba2
    layer's (``mamba``), each shared block's (``block``) and each hybrid
    layer's own (``hybrid``).  A fan-in of 0 marks a weight that is not a
    product's."""
    d, d_in, h = m["d"], m["d_in"], m["mamba_heads"]
    conv_dim = d_in + 2 * m["groups"] * m["state"]
    ad = m["attn_heads"] * m["attn_head_dim"]
    f, r, k = m["ffn"], m["adapter_rank"], m["conv"]
    return {
        "mamba": {"in_norm": ((d,), 0), "in_proj": ((d, d_in + conv_dim + h), d),
                  "conv_w": ((k, conv_dim), k), "conv_b": ((conv_dim,), k),
                  "dt_bias": ((h,), 0), "A_log": ((h,), 0), "D": ((h,), 0),
                  "norm_w": ((d_in,), 0), "out_proj": ((d_in, d), d_in)},
        "block": {"attn_norm": ((2 * d,), 0), "wqkv": ((2 * d, 3 * ad), 2 * d),
                  "wo": ((ad, d), ad), "ffn_norm": ((d,), 0), "w_gu": ((d, 2 * f), d),
                  "w_down": ((f, d), f)},
        "hybrid": {"adapter_a": ((d, r), d), "adapter_b": ((r, 2 * f), r), "w_lin": ((d, d), d)},
    }


def draw(m: dict, seed: int, device) -> dict:
    """The weights, each stacked over its copies (Mamba2 layers, blocks,
    hybrid layers) in order."""
    import torch

    counts = {"mamba": len(m["layer_types"]), "block": m["mem_blocks"],
              "hybrid": m["layer_types"].count("hybrid")}
    out = {}
    for kind, spec in shapes(m).items():
        for name, (shape, _) in spec.items():
            out[name] = torch.empty((counts[kind], *shape), dtype=torch.float32, device=device)
        for c in range(counts[kind]):
            gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "zamba2", kind, c))
            for name, (shape, fan_in) in spec.items():
                dst = out[name][c]
                if fan_in:
                    torch.randn(shape, generator=gen, device=device, out=dst).mul_(fan_in ** -0.5)
                elif name == "A_log":
                    dst.copy_(torch.log(torch.rand(shape, generator=gen, device=device) * 15 + 1))
                elif name == "dt_bias":
                    lo, hi = math.log(m["time_step_min"]), math.log(m["time_step_max"])
                    u = torch.rand(shape, generator=gen, device=device)
                    dt = torch.exp(u * (hi - lo) + lo).clamp_min(m["time_step_floor"])
                    dst.copy_(dt + torch.log(-torch.expm1(-dt)))  # softplus^-1
                else:  # D and the norms' weights
                    dst.fill_(1.0)
    return out


def inputs(m: dict, seed: int, count: int, device):
    """``count`` requests [h | x0] (count, S, 2 d), N(0, 1)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "inputs"))
    return torch.randn((count, m["seq"], 2 * m["d"]), generator=gen, device=device)


PROGRAM_KEYS = ("d", "d_in", "mamba_heads", "groups", "state", "conv", "attn_heads",
                "attn_head_dim", "ffn", "adapter_rank", "layer_types", "seq", "mem_blocks",
                "hybrid_offset", "chunk", "rope_theta", "eps")


class StageLog:
    """Each stage's input and output rows of the sampled requests, in the
    order the stages ran: request index -> [(first layer, input, output)].

    On the card a row is copied into a pinned host buffer on a side stream,
    so that neither the device's memory nor its stream carries the log; the
    buffers (``count`` rows) are allocated in set-up.  Rows past them are
    not kept, and ``judge`` reads such a request's stages as missing."""

    def __init__(self, count: int, shape: tuple[int, ...], device: str):
        import torch

        self.rows: dict[int, list] = {}
        self.watch: tuple[dict, set] | None = None  # (Window.index_of, Window.keep)
        self.used, self.count = 0, count
        self.stream = None
        if device.startswith("cuda"):
            self.buffers = torch.empty((count, *shape), dtype=torch.float32, pin_memory=True)
            self.stream = torch.cuda.Stream(device=device)

    def keep(self, row):
        import torch

        if self.used == self.count:
            return None
        self.used += 1
        if self.stream is None:
            return row.clone()
        buf = self.buffers[self.used - 1]
        self.stream.wait_stream(torch.cuda.current_stream(row.device))
        with torch.cuda.stream(self.stream):
            buf.copy_(row, non_blocking=True)
        row.record_stream(self.stream)
        return buf

    def wrap(self, inner, loop):
        """``inner`` (an ``executor(start, stop, x)``) logging the watched
        requests' rows of every stage it computes; ``loop()`` is the serving
        loop, asked only while a watch is set."""
        if inner.fused_codecs:
            raise BenchError("the stage log takes decoded inputs; this executor fuses "
                             f"{sorted(inner.fused_codecs)}")

        def executor(start, stop, x):
            rows = []
            if self.watch is not None:
                index_of, keep = self.watch
                rows = [(index_of.get(q.req_id), r) for r, q in enumerate(loop().computing(start))]
                rows = [(i, r) for i, r in rows if i in keep]
            kept_in = [self.keep(x[r]) for _, r in rows]
            y = inner(start, stop, x)
            for (i, r), xin in zip(rows, kept_in):
                self.rows.setdefault(i, []).append((start, xin, self.keep(y[r])))
            return y

        executor.fused_codecs = inner.fused_codecs
        return executor

    def close(self) -> dict:
        """Stop logging; the rows, once every copy has landed."""
        self.watch = None
        if self.stream is not None:
            self.stream.synchronize()
        return self.rows


class Served:
    """The deployed model with its weights (on the host) and configuration."""

    def __init__(self, ctx: Context):
        import torch

        from repro_torch.core import model_zoo

        ctor = getattr(model_zoo, "zamba2_hybrid", None)
        if ctor is None:  # a program without the model: fail before any work
            raise BenchError("the program has no core.model_zoo.zamba2_hybrid")
        from repro_torch.api import ClusterSpec, DeploymentSpec, deploy
        from repro_torch.core.placement import CommGraph

        cfg = ctx.cell.config
        self.model, dep, self.device = cfg["model"], cfg["deployment"], ctx.device
        self.marks = [("imports", time.monotonic())]
        if ctx.device.startswith("cuda"):
            from repro_torch.kernels import _build

            _build.lib()
            self.marks.append(("kernel library", time.monotonic()))
        self.host = {k: v.cpu() for k, v in draw(self.model, ctx.seed, self.device).items()}
        self.marks.append(("weights", time.monotonic()))
        graph, ex = ctor(**{k: self.model[k] for k in PROGRAM_KEYS}, device=self.device,
                         params_for_version=lambda v: self.host)
        self.executors = []
        self.log = StageLog(ctx.cell.traffic["compare"] * len(dep["stages"]) * 2,
                            (self.model["seq"], 2 * self.model["d"]), self.device)
        self.marks.append(("stage log buffers", time.monotonic()))

        def executor_for_version(v):
            self.executors.append(ex(v))
            return self.log.wrap(self.executors[-1], lambda: self.dep.loop)

        cluster = dep["cluster"]
        comm = CommGraph(bw=np.asarray(cluster["bw"], float),
                         node_capacity=np.asarray(cluster["capacity"], float))
        store = WORK_DIR / "store" / ctx.cell.name
        shutil.rmtree(store, ignore_errors=True)
        self.dep = deploy(DeploymentSpec(
            model=graph, executor_for_version=executor_for_version,
            cluster=ClusterSpec(comm=comm), codec=dep["codec"], serving=dep["serving"],
            queue_depth=dep["queue_depth"], microbatch=dep["microbatch"],
            max_batch=dep.get("max_batch"), seed=dep["seed"], device=self.device),
            store_root=str(store))
        if not hasattr(self.dep.loop, "computing"):
            raise BenchError("the serving loop cannot name the requests a stage computes")
        self.marks.append(("deploy", time.monotonic()))
        self.stages = [[p.partition.start, p.partition.stop]
                       for p in self.dep.control.pipeline.pods]
        codecs = list(self.dep.plan.codecs)
        if self.stages != dep["stages"] or codecs != dep["codecs"]:
            raise BenchError(f"deployed stages {self.stages} and hop codecs {codecs}, but the "
                             f"configuration states {dep['stages']} and {dep['codecs']}")
        self.batch_cap = dep.get("max_batch") or dep["microbatch"]
        self.request_flops = zamba2_costs.request_flops(self.model)
        self.event = torch.cuda.Event() if self.device.startswith("cuda") else None

    def done(self) -> None:
        if self.event is not None:
            self.event.record()
            self.event.synchronize()

    def counters(self) -> dict:
        from repro_torch.kernels import launch_counts

        m = self.dep.loop.metrics()
        launches = launch_counts()
        return {"completed": m["completed"], "microbatches": m["microbatches"],
                "failed": m["failed"], "rejected": m["rejected"],
                **{k: launches[k] for k in COUNTED},
                "shared_calls": [list(getattr(e, "shared_calls", ())) for e in self.executors]}

    def warm_up(self, pool, rounds: int = 2) -> None:
        for r in range(rounds):
            for b in range(1, self.batch_cap + 1):
                reqs = [self.dep.submit(pool[i % len(pool)]) for i in range(b)]
                self.dep.drain()
                self.done()
                if r == 0 and b == 1:
                    self.marks.append(("first request", time.monotonic()))
                if any(q.result is None for q in reqs):
                    raise BenchError("a warm-up request did not complete")
                for q in reqs:
                    q.result = None


def _per_microbatch(c0: dict, c1: dict) -> dict:
    mb = max(1, c1["microbatches"] - c0["microbatches"])
    out = {k: (c1[k] - c0[k]) / mb for k in COUNTED}
    calls0 = [x for e in c0["shared_calls"] for x in e]
    calls1 = [x for e in c1["shared_calls"] for x in e]
    out["shared_block_calls"] = [(b - a) / mb for a, b in zip(calls0, calls1)]
    return out


def _closed_rounds(served: Served, ctx: Context, win: Window, pool, nxt: int,
                   clients: int) -> tuple[int, float]:
    """``edge.py``'s closed loop, closed at whole rounds: resubmit for every
    client whose request completed, until the window has lasted
    ``ctx.seconds`` at a completion after which the window's completions
    are a multiple of ``clients``; returns (the next request index, the
    window's seconds up to that completion)."""
    done = 0
    while True:
        finished = win.step(True)
        if finished:
            t = time.monotonic() - win.t0
            for _ in finished:
                win.submit(nxt, pool, t)
                nxt += 1
            done += len(finished)
            if t >= ctx.seconds and done % clients == 0:
                return nxt, t
        elif not served.dep.loop.backlog:
            raise BenchError("the closed loop ran dry")


def run(ctx: Context) -> Observed:
    import torch

    tr = ctx.cell.traffic
    if tr["loop"] != "closed":
        raise BenchError(f"the zamba2 entry runs closed loops, got {tr['loop']!r}")
    served = Served(ctx)
    pool = inputs(served.model, ctx.seed, tr["pool"], ctx.device)
    served.marks.append(("inputs", time.monotonic()))
    served.warm_up(pool)
    served.marks.append(("warm-up", time.monotonic()))
    sites = [s for r in ctx.readers.values() for s in getattr(r, "CALLS", ())]
    call_log: list = []
    win = Window(served, ctx, set())
    nxt = 0
    win.t0 = time.monotonic()  # fill the pipeline, then open the window at a completion
    for _ in range(tr["clients"]):
        win.submit(nxt, pool, 0.0)
        nxt += 1
    while nxt < tr["clients"] * (1 + tr["fill_rounds"]):
        for _ in win.step(False):
            win.submit(nxt, pool, time.monotonic() - win.t0)
            nxt += 1
    win.keep = {nxt + i for i in _sample(ctx.seed, tr["compare_first"], tr["compare"])}
    served.log.watch = (win.index_of, win.keep)
    if ctx.device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    c0 = served.counters()
    with calls.record(sites if ctx.trace else (), call_log), \
            Profile(ctx.trace, ctx.device) as prof:
        t0 = time.monotonic()
        win.due = {i: due - (t0 - win.t0) for i, due in win.due.items()}
        win.t0 = t0
        setup_s = t0 - ctx.t_start
        nxt, window_s = _closed_rounds(served, ctx, win, pool, nxt, tr["clients"])
    c1 = served.counters()
    completed = len(win.latency_ms)
    latencies = list(win.latency_ms.values())
    attempted = completed + served.dep.loop.backlog
    failed = (c1["failed"] - c0["failed"]) + (c1["rejected"] - c0["rejected"])
    for i in sorted(win.keep):  # a sampled answer not yet asked for
        if i >= nxt:
            win.submit(i, pool, 0.0)
    t_close = time.monotonic()
    while served.dep.loop.backlog and time.monotonic() - t_close < LATE_S:
        win.step(False)
    peak = int(torch.cuda.max_memory_allocated()) if ctx.device.startswith("cuda") else 0
    log = served.log.close()
    microbatches = c1["microbatches"] - c0["microbatches"]
    counters = _per_microbatch(c0, c1)
    notes = [f"window {window_s:.3f} s: {attempted} offered, {completed} done in it, "
             f"{microbatches} microbatches; stages {served.stages}; stage log "
             f"{served.log.used} of {served.log.count} rows",
             "set-up: " + ", ".join(
                 f"{name} {t - prev:.3f} s" for (name, t), prev in
                 zip(served.marks, [ctx.t_start] + [t for _, t in served.marks])),
             "a microbatch: " + ", ".join(f"{k} {v}" for k, v in counters.items())]
    obs = {"chips": 1, "window_s": window_s, "completed": completed,
           "microbatches": microbatches,
           "engine_completed": c1["completed"] - c0["completed"], "step_host_s": win.step_host_s,
           "step_wall_s": win.step_wall_s, "request_flops": served.request_flops,
           "counters": counters, "calls": call_log,
           "trace": [prof.data] if prof.data is not None else []}
    kept, keep, host = win.kept, win.keep, served.host
    del served, win, pool
    gc.collect()
    if ctx.device.startswith("cuda"):
        torch.cuda.empty_cache()
    cfg = ctx.cell.config
    w = {k: v.to(ctx.device) for k, v in host.items()}
    pool = inputs(cfg["model"], ctx.seed, tr["pool"], ctx.device)
    checks = judge(cfg["limits"], cfg["model"], cfg["deployment"], w, pool, log, kept, keep)
    return Observed(attempted=attempted, failed=failed, completed=completed, window_s=window_s,
                    setup_s=setup_s, latencies_ms=latencies, checks=checks,
                    memory_peak_bytes=peak, count=1, obs=obs, notes=notes)


def hop(codec: str, x, block: int):
    """What a hop's receiver sees of x, as the reference computes it."""
    if codec == "identity":
        return x
    if codec == "int8":
        return round_trip(x, block)
    raise BenchError(f"no reference for the codec {codec!r}")


def judge(limits: dict, m: dict, dep: dict, w: dict, pool, log: dict, kept: dict, keep: set):
    """The configuration's ``limits``, each beside the worst reading of every
    hop and every stage of the sampled requests (``log``: ``StageLog.rows``;
    ``kept``: request index -> answer): a hop's receiver against the
    reference's codec on what its sender gave (stage 0's input against the
    request), a stage's output against ``reference.stage`` on the input it
    was handed.  A sampled request whose answer or stages are missing reads
    infinitely wrong."""
    import torch

    stages, codecs, block = dep["stages"], dep["codecs"], dep["codec_block"]
    starts = [first for first, _ in stages]
    whole = sorted(i for i in keep if i in kept and [s for s, _, _ in log.get(i, ())] == starts
                   and all(t is not None for _, a, b in log[i] for t in (a, b)))
    if len(whole) != len(keep) or not keep:
        return [(k, math.inf, lim) for k, lim in limits.items()]
    errors = []
    dev = pool.device
    for i in whole:
        sent = pool[i % len(pool)]
        for j, (_, xin, out) in enumerate(log[i]):
            errors.append(relative_errors(xin.to(dev), hop(codecs[j], sent, block)))
            sent = out.to(dev)
        errors.append(relative_errors(kept[i].to(dev), hop(codecs[len(stages)], sent, block)))
    for j, (first, stop) in enumerate(stages):
        ref = reference.stage(m, w, torch.stack([log[i][j][1] for i in whole]).to(dev),
                              first, stop)
        errors += [relative_errors(log[i][j][2].to(dev), ref[g]) for g, i in enumerate(whole)]
        del ref
    worst = worst_errors(errors)
    return [(k, worst[k], lim) for k, lim in limits.items()]
