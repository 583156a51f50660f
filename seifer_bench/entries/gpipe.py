"""Cells that drive ``repro_torch.runtime.pipeline.make_gpipe`` in group mode.

One process a card, one stage a process: the parent builds the kernels
once (ranks building at once would race on the build's stamp), starts a
rank group at a free TCP port on localhost and supervises the ranks.  The
ranks are forked from a fork server that has imported torch, the port and
the modules torch loads at a custom op's first call (``PRELOAD``): four
processes importing them at once took 37-66 s of each rank's first run.  Each
rank sets its card, starts its NCCL rank (``launch.mesh.start_rank_group``),
draws only its own layer's weights from the seed, builds that layer with the
port's model constructor and a pool of inputs (every rank the same), warms
up with two runs, and then runs the pipeline back to back: a run is
``n_micro`` microbatches of ``microbatch`` requests, int8-coded between
stages, and is atomic, so the window is a whole number of runs, as many as
the warm-up's run time says fill ``--seconds`` (rank 0 decides and tells
the others before the window).

Rank 0 keeps the sampled answers of the broadcast output.  After the window
every rank reports its memory peak, its trace and its recorded calls; the
group is torn down and rank 0 alone holds the sampled answers to the plain
reference.  A rank that fails reports and ends at once (``os._exit``): a
rank still in a collective would hold ``destroy_process_group`` for the
group's whole timeout.  The parent ends every rank as soon as one fails,
exits or outlives ``WATCHDOG_S``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import queue as queue_mod
import socket
import time
import traceback

import numpy as np

from seifer_bench.lib import calls, costs, weights
from seifer_bench.lib.bench import BenchError, Context, Observed, sub_seed
from seifer_bench.lib.trace import Profile, span

WATCHDOG_S = 300.0  # start to the last rank's report, well inside a run's 360 s
# imported once, by the fork server, before it forks the ranks
PRELOAD = ["torch", "torch.distributed", "torch._dynamo", "torch.distributed.fsdp", "sympy",
           "repro_torch.core.model_zoo", "repro_torch.runtime.pipeline",
           "repro_torch.launch.mesh", "repro_torch.kernels", "seifer_bench.entries.gpipe"]
GROUP_TIMEOUT_S = 120.0  # a collective waits this long for the other ranks


def _free_init_method() -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def _rank(rank: int, world: int, init: str, ctx: Context, sites, out_q) -> None:
    """One rank of the pipeline; reports ``(rank, dict)`` or ``(rank, error)``."""
    marks = [("rank started", time.monotonic())]
    try:
        out_q.put((rank, _rank_body(rank, world, init, ctx, sites, marks)))
    except BaseException:  # noqa: BLE001 -- report, then end at once
        out_q.put((rank, {"error": traceback.format_exc()}))
        out_q.close()
        out_q.join_thread()
        os._exit(1)


def _rank_body(rank: int, world: int, init: str, ctx: Context, sites, marks) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.core.model_zoo import demo_transformer
    from repro_torch.launch.mesh import start_rank_group
    from repro_torch.runtime.pipeline import make_gpipe

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    model, dep = cfg["model"], cfg["deployment"]
    if model["kind"] != "demo_transformer" or model["n_layers"] != world:
        raise BenchError(f"the GPipe entry runs one demo_transformer layer a rank: "
                         f"{model['kind']} of {model['n_layers']} layers on {world} ranks")
    cuda = dev.startswith("cuda")
    if cuda:
        dev = f"cuda:{rank}"
    marks.append(("imports", time.monotonic()))
    start_rank_group(rank, world, init, device="cuda" if cuda else "cpu",
                     timeout_s=GROUP_TIMEOUT_S)
    marks.append(("rank group", time.monotonic()))
    own = weights.draw(model, ctx.seed, dev, layers=[rank], gain=cfg["weights"]["gain"])
    host = {k: v.cpu() for k, v in own.items()}  # the port takes host arrays
    del own
    widths = {k: v for k, v in model.items() if k not in ("kind",)}
    widths["n_layers"] = 1
    if model["window"] > 0 and rank % 2 == 1:
        raise BenchError("a windowed odd layer cannot run as a one-layer model")
    _, ex_for = demo_transformer(**widths, device=dev, params_for_version=lambda v: host)
    ex = ex_for(0)
    marks.append(("weights", time.monotonic()))
    n_micro, mb = tr["n_micro"], tr["microbatch"]
    per_run = n_micro * mb
    pool = weights.inputs(model, ctx.seed, per_run * tr["pool_runs"], dev).reshape(
        tr["pool_runs"], n_micro, mb, model["seq"], model["d"])
    pipe = make_gpipe(lambda _, x: ex(0, 1, x), world, n_micro=n_micro,
                      compress=dep["compress"], quant_block=dep["quant_block"],
                      group=dist.group.WORLD)
    stage = torch.zeros(1, device=dev)  # stage_fn takes no params of its own

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        for r in range(2):  # warm-up: NCCL connects each pair at its first send
            sync()
            t = time.monotonic()
            pipe(stage, pool[r % tr["pool_runs"]])
            sync()
            run_s = time.monotonic() - t
            marks.append((f"warm-up run {r + 1}", time.monotonic()))
        n_runs = torch.tensor([max(1, math.ceil(ctx.seconds / run_s))], device=dev)
        dist.broadcast(n_runs, 0)
        n_runs = int(n_runs.item())
        keep = {}
        if rank == 0:
            rng = np.random.default_rng(sub_seed(ctx.seed, "sample") % 2**63)
            picks = rng.choice(min(tr["compare_first"], per_run * n_runs),
                               size=min(tr["compare"], per_run * n_runs), replace=False)
            keep = {int(i): None for i in picks}
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        call_log: list = []
        dist.barrier()
        sync()
        runs_s = []
        with calls.record(sites if ctx.trace else (), call_log), Profile(ctx.trace, dev) as prof:
            t0 = time.monotonic()
            for r in range(n_runs):
                t = time.monotonic()
                with span("bench.run", ctx.trace):
                    out = pipe(stage, pool[r % tr["pool_runs"]])
                for i in keep:
                    if i // per_run == r:
                        m, j = divmod(i % per_run, mb)
                        keep[i] = out[m, j].clone()
                with span("bench.sync", ctx.trace):
                    sync()
                runs_s.append(time.monotonic() - t)
                del out
            t1 = time.monotonic()
        peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    dist.barrier()
    dist.destroy_process_group()
    report = {"peak": peak, "trace": prof.data, "calls": call_log, "t0": t0, "marks": marks,
              "window_s": t1 - t0, "runs": n_runs, "per_run": per_run, "runs_s": runs_s}
    if rank == 0:
        del pipe, ex, ex_for, host
        if cuda:
            torch.cuda.empty_cache()
        report["checks"] = _judge(ctx, model, dep, pool, keep, per_run, mb, dev)
    return report


def _judge(ctx: Context, model, dep, pool, keep: dict, per_run: int, mb: int, dev):
    """The sampled answers against the plain reference, int8 round trips
    between the stages as the pipeline codes its boundaries."""
    import torch

    from seifer_bench.reference import models as reference

    limits = ctx.cell.config["limits"]
    w = weights.draw(model, ctx.seed, dev, gain=ctx.cell.config["weights"]["gain"])
    # uncompressed boundaries are exact: the reference is then one stage
    stages = dep["stages"] if dep["compress"] else [[0, model["n_layers"]]]
    errors = []
    for i, got in keep.items():
        if got is None:
            errors.append({k: math.inf for k in ("row_med", "row_max", "diff2", "ref2")})
            continue
        r, rest = divmod(i, per_run)
        m, j = divmod(rest, mb)
        x = pool[r % pool.shape[0], m, j][None]
        ref = reference.forward(model, w, x, stages, dep["quant_block"])[0]
        errors.append(reference.relative_errors(got, ref))
        del ref
    worst = reference.worst_errors(errors)
    del w
    if dev.startswith("cuda"):
        torch.cuda.empty_cache()
    return [(k, worst[k], lim) for k, lim in limits.items()]


def supervise(ctx: Context, world: int, sites) -> list[dict]:
    """Start ``world`` ranks of ``_rank`` and collect their reports; end
    every rank at once when one fails, exits early or outlives the
    watchdog."""
    import multiprocessing as mp
    from multiprocessing import forkserver

    server = mp.get_context("forkserver")
    server.set_forkserver_preload(PRELOAD)
    out_q = server.Queue()
    init = _free_init_method()
    plain = dataclasses.replace(ctx, readers={})  # what a rank needs, picklable
    procs = [server.Process(target=_rank, args=(r, world, init, plain, sites, out_q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    reports: dict[int, dict] = {}
    deadline = time.monotonic() + WATCHDOG_S
    failure = None
    try:
        while len(reports) < world and failure is None:
            try:
                rank, rep = out_q.get(timeout=1.0)
                if "error" in rep:
                    failure = f"rank {rank} failed:\n{rep['error']}"
                reports[rank] = rep
            except queue_mod.Empty:
                pass
            for r, p in enumerate(procs):
                if r not in reports and p.exitcode is not None and failure is None:
                    failure = f"rank {r} exited with {p.exitcode} before reporting"
            if time.monotonic() > deadline and failure is None:
                failure = f"the ranks did not report within {WATCHDOG_S:.0f} s"
    finally:
        if failure is not None:
            for p in procs:
                if p.is_alive():
                    p.kill()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        forkserver._forkserver._stop()  # the server ends with its ranks
    if failure is not None:
        raise BenchError(failure)
    return [reports[r] for r in range(world)]


def run(ctx: Context) -> Observed:
    world = ctx.cell.chips
    if ctx.device.startswith("cuda"):
        from repro_torch.kernels import _build

        _build.build()
    sites = [s for r in ctx.readers.values() for s in getattr(r, "CALLS", ())]
    reps = supervise(ctx, world, sites)
    lead = reps[0]
    completed = lead["runs"] * lead["per_run"]
    model = ctx.cell.config["model"]
    request_flops = costs.demo_transformer_request_flops(
        **{k: model[k] for k in ("d", "n_layers", "seq", "heads", "kv_heads", "mlp_mult",
                                 "window")})
    latencies = [1e3 * s for s in lead["runs_s"] for _ in range(lead["per_run"])]
    obs = {"chips": world, "window_s": lead["window_s"], "completed": completed,
           "request_flops": request_flops,
           "calls": [c for rep in reps for c in rep["calls"]],
           "trace": [rep["trace"] for rep in reps if rep["trace"] is not None]}
    notes = [f"window {lead['window_s']:.3f} s: {lead['runs']} runs of {lead['per_run']} "
             f"requests, {', '.join(f'{s:.3f}' for s in lead['runs_s'])} s each; memory "
             f"peaks by rank {[rep['peak'] for rep in reps]}",
             "rank 0 set-up: " + ", ".join(
                 f"{name} {t - prev:.3f} s" for (name, t), prev in
                 zip(lead["marks"], [ctx.t_start] + [t for _, t in lead["marks"]]))
             + f", to the window {lead['t0'] - lead['marks'][-1][1]:.3f} s"]
    return Observed(attempted=completed, failed=0, completed=completed,
                    window_s=lead["window_s"], setup_s=lead["t0"] - ctx.t_start,
                    latencies_ms=latencies, checks=lead["checks"],
                    memory_peak_bytes=max(rep["peak"] for rep in reps), count=world,
                    obs=obs, notes=notes)
