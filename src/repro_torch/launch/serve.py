"""Serving CLI: prefill-style prompt consumption + decode loop.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --tokens 16

The JAX package's ``launch/serve.py`` in PyTorch: the same flags, defaults
and printed lines, with ``--device`` (default ``cuda``; ``resolve_device``
raises without a card rather than falling back to the CPU) in place of
``--use-pallas`` and ``--interpret``: the device picks the hand-written
kernels (CUDA) or their plain versions (CPU).  ``main`` takes its
arguments, as ``launch/train.py``'s does.

Edge mode serves a request stream through the simulated edge cluster's
control plane instead of the local accelerator, reporting the reconcile
actions taken under a scripted node failure.  The partition/placement
strategies are registry names (see ``repro_torch.api.list_strategies``), so
every registered pair is one CLI flag away:

  PYTHONPATH=src python -m repro_torch.launch.serve --edge --requests 32 \\
      --partitioner min_sum --placer greedy --capacity-frac 0.33 --width 32

``--arch`` draws the params from a generator seeded 0 on the device (the
JAX CLI's ``PRNGKey(0)`` draws other numbers) and runs the port's
``make_serve_step`` eagerly, greedy from token 0.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.api import (
    ArrivalSpec,
    AutoscaleSpec,
    ClusterSpec,
    DeploymentSpec,
    TraceConfig,
    deploy,
    list_strategies,
)
from repro_torch.cluster import NodeFailed
from repro_torch.configs import get_config, reduced
from repro_torch.core.execution import resolve_device
from repro_torch.core.model_zoo import demo_mlp, demo_ssm, demo_transformer
from repro_torch.dataplane import list_codecs
from repro_torch.models import lm
from repro_torch.runtime.serve import make_serve_step
from repro_torch.workload import list_traces


def _zoo(model: str, width: int, *, device="cuda"):
    """(graph, executor_for_version, demo input) for a zoo model name, the
    executors and the input on ``device``."""
    if model in ("demo_ssm", "ssm"):
        graph, ex = demo_ssm(device=device)
        return graph, ex, torch.ones((8, 24), device=device) * 0.1
    if model in ("demo_transformer", "transformer"):
        graph, ex = demo_transformer(device=device)
        return graph, ex, torch.ones((256, 32), device=device) * 0.1
    graph, ex = demo_mlp(d=width, device=device)
    return graph, ex, torch.ones((width,), device=device) * 0.1


def serve_edge(
    requests: int,
    nodes: int,
    seed: int,
    *,
    partitioner: str | None = None,
    placer: str | None = None,
    joint: str | None = None,
    capacity_frac: float = 1 / 3,
    width: int = 32,
    serving: str = "pipelined",
    queue_depth: int = 2,
    replicas: int | str = 1,
    codec: str | None = None,
    tolerance: float | None = None,
    trace: str | None = None,
    rate: float = 400.0,
    duration_s: float = 2.0,
    autoscale: bool = False,
    max_batch: int | None = None,
    admission_depth: int | None = None,
    model: str = "demo_mlp",
    device: str | torch.device = "cuda",
    trace_sample: float | None = None,
    trace_out: str | None = None,
) -> int:
    """Edge-cluster serving demo: deploy(spec) -> stream -> kill -> recover.

    With ``trace``, the stream is open-loop: a seeded arrival trace
    (``repro_torch.workload``) admitted by timestamp on the virtual clock,
    with a latency percentile report at the end.  ``autoscale`` turns on
    backlog-driven replica scaling over the planner's widest feasible split.
    ``trace_sample`` enables per-request span tracing at that sampling rate
    and prints the critical-path attribution; ``trace_out`` additionally
    writes the Chrome trace-event export there (chrome://tracing /
    ui.perfetto.dev).
    """
    device = resolve_device(device)
    graph, executor_for_version, x0 = _zoo(model, width, device=device)
    capacity = graph.total_param_bytes * capacity_frac

    arrival = None
    if trace is not None:
        arrival = ArrivalSpec(trace=trace, rate=rate, duration_s=duration_s,
                              seed=seed)
    spec = DeploymentSpec(
        model=graph,
        executor_for_version=executor_for_version,
        cluster=ClusterSpec(n_nodes=nodes, capacity_bytes=capacity, seed=seed + 3),
        partitioner=partitioner,
        placer=placer,
        joint=joint,
        codec=codec,
        accuracy_tolerance=tolerance,
        seed=seed,
        microbatch=4,
        serving=serving,
        queue_depth=queue_depth,
        replicas=replicas,
        max_batch=max_batch,
        admission_depth=admission_depth,
        arrival=arrival,
        autoscale=AutoscaleSpec() if autoscale else None,
        trace=(TraceConfig(sample=trace_sample)
               if trace_sample is not None else None),
        device=str(device),
    )
    d = deploy(spec)
    names = dict(d.plan.strategies)
    if d.replicated:
        sets = d.replicaset
        print(f"edge serving [{names}, {serving}, x{sets.n_replicas} replicas]: "
              f"groups {[sorted(g) for g in sets.groups]}, summed predicted "
              f"{d.plan.predicted_throughput:.1f} microbatch/s")
    else:
        obs = d.observed()
        print(f"edge serving [{names}, {serving}]: {len(obs.path)} partitions on "
              f"nodes {list(obs.path)}, bottleneck {obs.bottleneck_latency*1e3:.3f} ms, "
              f"predicted {d.plan.predicted_throughput:.1f} microbatch/s, "
              f"link codecs {list(d.plan.codecs)}")
    if trace is not None:
        requests = len(d.submit_trace(make_input=lambda i, a: x0))
        print(f"open-loop trace '{trace}': {requests} arrivals over "
              f"{duration_s:g}s at nominal {rate:g} req/s"
              + (", autoscaling" if autoscale else ""))
    else:
        for _ in range(requests):
            d.submit(x0)
    half = requests // 2
    killed = half == 0  # nothing to kill mid-stream on a tiny run
    pending_arrivals = lambda: getattr(d.loop, "pending_arrivals", 0)  # noqa: E731
    while d.loop.backlog or d.pending or pending_arrivals():
        if not killed and len(d.loop.completed) >= half:
            pods = d.control.pipeline.pods
            victim = pods[1 if len(pods) > 1 else 0].node_id
            print(f"killing node {victim} mid-stream...")
            d.inject(NodeFailed(victim))
            killed = True
        if (not d.step() and not d.pending
                and not pending_arrivals() and not d.loop.backlog):
            break
    m = d.metrics()
    if d.replicated:
        s = m["serving"]
        print(f"served {s['completed']}/{requests} requests (lost {s['failed']}) "
              f"in {s['clock_s']:.3f} simulated s across "
              f"{m['live_replicas']}/{m['n_replicas']} live replicas; "
              f"router dispatched {s['router']['dispatched']}")
        for rep in m["replicas"]:
            print(f"  replica {rep['replica']}{' (retired)' if rep['retired'] else ''}: "
                  f"path {rep['path']}, actions {rep['reconcile_actions']}")
    else:
        print(f"served {m['serving']['completed']}/{requests} requests "
              f"(lost {m['serving']['failed']}) in {m['serving']['clock_s']:.3f} "
              f"simulated s; final path {m['path']}, actions: {m['reconcile_actions']}")
        for st in m["serving"].get("stages", ()):
            print(f"  stage {st['stage']} on node {st['node']}: "
                  f"occupancy {st['occupancy']:.2f}, mean queue {st['mean_queue']:.2f}, "
                  f"max queue {st['max_queue']}, {st['microbatches']} microbatches")
        for ln in m["serving"].get("links", ()):
            if ln["raw_bytes"] <= 0:
                continue  # colocated endpoints: nothing rides a wire
            print(f"  link {ln['hop']}: codec {ln['codec']}, "
                  f"{ln['raw_bytes']:.0f} -> {ln['wire_bytes']:.0f} B "
                  f"({ln['compression_x']:.2f}x), "
                  f"utilization {ln['utilization']:.2f}, "
                  f"{ln['transfers']} transfers")
    s = m["serving"]
    if trace is not None:
        lat = s["latency"]["overall"]
        print(f"latency (admit -> complete): p50 {lat['p50_s']*1e3:.2f} ms, "
              f"p95 {lat['p95_s']*1e3:.2f} ms, p99 {lat['p99_s']*1e3:.2f} ms, "
              f"max {lat['max_s']*1e3:.2f} ms; rejected {s['rejected']}")
        b = s.get("batching")
        if b:
            print(f"batching: cap {b['max_batch']}, peak batch "
                  f"{b['max_batch_seen']}, mean batch {b['mean_batch']:.2f}")
    if "autoscaler" in s:
        a = s["autoscaler"]
        print(f"autoscaler: {a['grows']} grows, {a['shrinks']} shrinks, "
              f"{a['standby_groups']} standby groups left")
        for e in a["events"]:
            print(f"  t={e['t_s']:.3f}s {e['action']} replica {e['replica']} "
                  f"({e['reason']}) -> {e['live_after']} live")
    if trace_sample is not None:
        att = d.attribution()
        f = att["fractions"]
        print(f"trace ({att['spans']} spans / {att['requests']} requests): "
              f"queue {f['queue']:.0%}, compute {f['compute']:.0%}, "
              f"wire {f['wire']:.0%}, transcode {f['transcode']:.0%}")
        bn = att["bottleneck"]
        if bn is not None:
            print(f"observed bottleneck: {bn['kind']} {bn['index']} "
                  f"({bn['service_s']*1e3:.3f} ms/visit)")
        if trace_out:
            import json

            with open(trace_out, "w") as fh:
                json.dump(d.chrome_trace(), fh)
            print(f"chrome trace written to {trace_out} "
                  f"(load in chrome://tracing or ui.perfetto.dev)")
    return 0


def _tenant_input(model: str, device="cuda"):
    """A correctly-shaped demo payload for each zoo model name."""
    if model in ("demo_ssm", "ssm"):
        return torch.ones((8, 24), device=device) * 0.1
    if model in ("demo_transformer", "transformer"):
        return torch.ones((256, 32), device=device) * 0.1
    return torch.ones((32,), device=device) * 0.1


def serve_tenants(
    tenant_models: list[str],
    requests: int,
    nodes: int,
    seed: int,
    *,
    policy: str = "partition",
    fractions: list[float] | None = None,
    weights: list[float] | None = None,
    capacity_frac: float = 1 / 3,
    device: str | torch.device = "cuda",
) -> int:
    """Multi-tenant edge demo: carve one cluster, serve every tenant, kill a
    node in tenant 0's slice, and show the other tenants unperturbed."""
    from repro_torch.api import TenantSpec

    device = resolve_device(device)
    cluster = ClusterSpec(
        n_nodes=nodes,
        capacity_bytes=demo_mlp(device=device)[0].total_param_bytes * capacity_frac,
        seed=seed + 3,
    )
    tenants = []
    for i, model in enumerate(tenant_models):
        tenants.append(TenantSpec(
            name=f"{model}-{i}",
            spec=DeploymentSpec(model=model, cluster=cluster, seed=seed, device=str(device)),
            capacity_fraction=fractions[i] if fractions else None,
            weight=weights[i] if weights else 1.0,
        ))
    d = deploy(tenants, policy=policy)
    print(f"multi-tenant edge serving [{policy}]: {nodes} nodes, "
          f"{len(tenants)} tenants")
    for p in d.plan.placements:
        print(f"  tenant {p.name}: nodes {sorted(p.nodes)} "
              f"(fraction {p.fraction:.2f}, weight {p.weight:g})")
    if d.plan.spare:
        print(f"  spare nodes: {list(d.plan.spare)}")

    inputs = {t.name: _tenant_input(t.spec.model, device) for t in tenants}
    for t in tenants:
        for _ in range(requests):
            d.submit(t.name, inputs[t.name])

    victim_tenant = tenants[0].name
    victim = d.nodes_for(victim_tenant)[0]
    killed = False
    while d.router.backlog or d.pending:
        if not killed and len(d.completed()) >= requests * len(tenants) // 2:
            print(f"killing node {victim} (tenant {victim_tenant!r}'s slice) "
                  f"mid-stream...")
            d.inject(NodeFailed(victim))
            killed = True
        if not d.step() and not d.pending and not d.router.backlog:
            break
    m = d.metrics()
    fair = m["serving"]["fairness"]
    for name, dep in d.deployments.items():
        tm = m["tenants"][name]
        served = fair[name]["served"]
        acts = (tm.get("reconcile_actions")
                or [a for r in tm.get("replicas", ()) for a in r["reconcile_actions"]])
        print(f"  tenant {name}: served {served}/{requests}, "
              f"actions {acts}")
    routed = [f"{t or 'cluster'}:{k}" for t, k in d.controlplane.routed]
    print(f"event routing: {routed}")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--edge", action="store_true",
                    help="serve through the simulated edge control plane")
    ap.add_argument("--requests", type=int, default=32, help="edge mode stream size")
    ap.add_argument("--nodes", type=int, default=8, help="edge mode cluster size")
    ap.add_argument("--partitioner", default=None,
                    choices=list_strategies("partitioner"),
                    help="edge mode partition strategy (default: registry default)")
    ap.add_argument("--placer", default=None,
                    choices=list_strategies("placer"),
                    help="edge mode placement strategy (default: registry default)")
    ap.add_argument("--joint", default=None,
                    choices=list_strategies("joint"),
                    help="edge mode joint optimizer (replaces partitioner+placer)")
    ap.add_argument("--capacity-frac", type=float, default=1 / 3,
                    help="edge mode per-node capacity as a fraction of model bytes")
    ap.add_argument("--width", type=int, default=32,
                    help="edge mode demo-MLP width (d)")
    ap.add_argument("--model", default="demo_mlp",
                    choices=("demo_mlp", "demo_ssm", "demo_transformer"),
                    help="edge mode zoo model to serve (demo_transformer and "
                         "demo_ssm run kernel-backed executors)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the hand-written kernels; raises without "
                         "a card) or cpu (their plain versions)")
    ap.add_argument("--serving", default="pipelined",
                    choices=("pipelined", "sync"),
                    help="edge mode serving engine (discrete-event pipeline "
                         "vs synchronous baseline)")
    ap.add_argument("--queue-depth", type=int, default=2,
                    help="edge mode per-stage in-queue bound (pipelined only)")
    ap.add_argument("--replicas", default="1",
                    help="edge mode pipeline replica count: an int, or 'auto' "
                         "to maximize summed predicted throughput")
    ap.add_argument("--codec", default=None,
                    choices=(*list_codecs(), "auto"),
                    help="edge mode inter-stage transfer codec; 'auto' picks "
                         "the fastest codec per link within --tolerance "
                         "(default: identity, the raw wire)")
    ap.add_argument("--tolerance", type=float, default=None,
                    help="edge mode per-link accuracy tolerance (max codec "
                         "round-trip error relative to max|x|)")
    ap.add_argument("--trace", default=None, choices=list_traces(),
                    help="edge mode open-loop arrival trace (replaces the "
                         "closed-loop --requests stream)")
    ap.add_argument("--rate", type=float, default=400.0,
                    help="edge mode trace mean arrival rate (req/s)")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="edge mode trace duration (virtual seconds)")
    ap.add_argument("--autoscale", action="store_true",
                    help="edge mode backlog-driven replica autoscaling "
                         "(scales over the widest feasible replica split)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="edge mode continuous-batching cap (coalesce up to "
                         "this many queued requests per admission)")
    ap.add_argument("--admission-depth", type=int, default=None,
                    help="edge mode admission queue bound; arrivals beyond "
                         "it are rejected (load shedding) instead of queued")
    ap.add_argument("--tenants", default=None,
                    help="edge mode multi-tenant serving: comma-separated "
                         "zoo model names (e.g. demo_mlp,demo_ssm), one "
                         "tenant each on a shared cluster")
    ap.add_argument("--tenant-policy", default="partition",
                    choices=("partition", "shared"),
                    help="tenancy placement policy (disjoint node slices "
                         "vs fractional co-residency)")
    ap.add_argument("--tenant-fractions", default=None,
                    help="comma-separated capacity fractions, one per tenant")
    ap.add_argument("--tenant-weights", default=None,
                    help="comma-separated fair-share weights, one per tenant")
    ap.add_argument("--trace-sample", type=float, default=None,
                    help="edge mode per-request span tracing: fraction of "
                         "requests traced (1.0 = all); prints the "
                         "critical-path attribution at the end")
    ap.add_argument("--trace-out", default=None,
                    help="edge mode: write the Chrome trace-event export "
                         "here (requires --trace-sample)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.edge and args.tenants:
        models = [m.strip() for m in args.tenants.split(",") if m.strip()]
        parse_floats = lambda s: (  # noqa: E731
            [float(x) for x in s.split(",")] if s else None)
        return serve_tenants(
            models, args.requests, args.nodes, args.seed,
            policy=args.tenant_policy,
            fractions=parse_floats(args.tenant_fractions),
            weights=parse_floats(args.tenant_weights),
            capacity_frac=args.capacity_frac,
            device=args.device,
        )
    if args.edge:
        replicas = args.replicas if args.replicas == "auto" else int(args.replicas)
        return serve_edge(
            args.requests, args.nodes, args.seed,
            partitioner=args.partitioner, placer=args.placer, joint=args.joint,
            capacity_frac=args.capacity_frac, width=args.width,
            serving=args.serving, queue_depth=args.queue_depth,
            replicas=replicas, codec=args.codec, tolerance=args.tolerance,
            trace=args.trace, rate=args.rate, duration_s=args.duration,
            autoscale=args.autoscale, max_batch=args.max_batch,
            admission_depth=args.admission_depth,
            model=args.model, device=args.device,
            trace_sample=args.trace_sample, trace_out=args.trace_out,
        )
    if not args.arch:
        ap.error("--arch is required unless --edge is given")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    print(f"serving {cfg.name} (reduced={not args.full})")
    params = lm.init_params(cfg, torch.Generator(device).manual_seed(0), device=device,
                            max_pos=args.max_len)
    caches = lm.init_caches(cfg, args.batch, args.max_len, enc_len=16, device=device)
    step = make_serve_step(cfg, enc_len=16)

    tok = torch.zeros((args.batch, 1), dtype=torch.int32, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    outs = []
    for _ in range(args.tokens):
        tok, caches = step(params, caches, tok)
        outs.append(tok)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"{args.tokens} tokens x batch {args.batch} in {dt:.2f}s "
          f"({args.tokens*args.batch/dt:.1f} tok/s); sample:",
          torch.cat(outs, 1)[0, :10].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
