"""Critical-path analyzer: fold span timelines into latency attributions.

Per request: what fraction of admit-to-complete latency went to queueing,
stage compute, link wire, and codec transcode (encode+decode).  Aggregate:
per-stage and per-hop observed service times, the observed bottleneck
resource, and a pin of observed per-stage service against the plan's
``core.bottleneck.service_times`` prediction -- the same
prediction-vs-measurement check a throughput benchmark makes once, as an
always-available diagnostic at per-stage granularity.

Spans are already exact on the virtual clock, so in a churn-free run the
observed medians equal the plan's numbers to float precision; the 5%
tolerance absorbs truncated spans under churn.
"""

from __future__ import annotations

import math

# span phase -> attribution group
GROUPS = {
    "queue": "queue",
    "exec": "compute",
    "wire": "wire",
    "encode": "transcode",
    "decode": "transcode",
}
GROUP_NAMES = ("queue", "compute", "wire", "transcode")


def _median(vals: list[float]) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def request_attribution(spans) -> dict:
    """Fractions of one request's total span time per attribution group.

    Fractions sum to 1 (± float addition error) because the spans tile the
    request's life contiguously and every phase maps to exactly one group.
    """
    totals = {g: 0.0 for g in GROUP_NAMES}
    for s in spans:
        totals[GROUPS[s.phase]] += s.duration_s
    total = sum(totals.values())
    if total <= 0:
        return {"total_s": 0.0, **{g: 0.0 for g in GROUP_NAMES}}
    return {"total_s": total, **{g: totals[g] / total for g in GROUP_NAMES}}


def analyze_spans(spans) -> dict:
    """Aggregate attribution over a span set (typically a whole run).

    Returns time-weighted overall fractions, per-request mean fractions,
    per-stage exec service times, per-hop link windows, and the observed
    bottleneck resource ``{"kind": "stage"|"link", "index", "service_s"}``
    (the resource whose per-visit service time is largest -- the engine's
    steady-state period is set by exactly this resource).
    """
    by_req: dict[int, list] = {}
    group_totals = {g: 0.0 for g in GROUP_NAMES}
    stage_exec: dict[int, list[float]] = {}
    hop_time: dict[int, dict[str, float]] = {}
    hop_crossings: dict[int, int] = {}
    for s in spans:
        by_req.setdefault(s.req_id, []).append(s)
        group_totals[GROUPS[s.phase]] += s.duration_s
        if s.phase == "exec" and s.stage is not None:
            stage_exec.setdefault(s.stage, []).append(s.duration_s)
        elif s.phase in ("encode", "wire", "decode") and s.hop is not None:
            agg = hop_time.setdefault(s.hop, {"wire": 0.0, "transcode": 0.0})
            agg["wire" if s.phase == "wire" else "transcode"] += s.duration_s
            if s.phase == "wire":
                hop_crossings[s.hop] = hop_crossings.get(s.hop, 0) + 1

    total = sum(group_totals.values())
    fractions = {g: (group_totals[g] / total if total > 0 else 0.0)
                 for g in GROUP_NAMES}

    per_req = [request_attribution(ss) for ss in by_req.values()]
    n_req = len(per_req)
    per_request_mean = {
        g: (sum(a[g] for a in per_req) / n_req if n_req else 0.0)
        for g in GROUP_NAMES
    }

    stages = [{
        "stage": s,
        "count": len(durs),
        "mean_s": sum(durs) / len(durs),
        "median_s": _median(durs),
    } for s, durs in sorted(stage_exec.items())]

    hops = []
    for h in sorted(hop_time):
        crossings = max(1, hop_crossings.get(h, 0))
        tot = hop_time[h]["wire"] + hop_time[h]["transcode"]
        hops.append({
            "hop": h,
            "crossings": hop_crossings.get(h, 0),
            "mean_s": tot / crossings,
            "wire_s": hop_time[h]["wire"] / crossings,
            "transcode_s": hop_time[h]["transcode"] / crossings,
        })

    bottleneck = None
    candidates = [("stage", row["stage"], row["median_s"]) for row in stages]
    candidates += [("link", row["hop"], row["mean_s"]) for row in hops]
    if candidates:
        kind, index, service = max(candidates, key=lambda c: c[2])
        bottleneck = {"kind": kind, "index": index, "service_s": service}

    return {
        "requests": n_req,
        "spans": sum(len(ss) for ss in by_req.values()),
        "fractions": fractions,
        "per_request_fractions_mean": per_request_mean,
        "stages": stages,
        "hops": hops,
        "bottleneck": bottleneck,
    }


def predicted_times(control):
    """The plan's per-stage/per-hop service times for a control plane's
    current pipeline -- the same ``core.bottleneck.service_times`` call the
    engines bind their timing to.  Returns ``(compute_s, link_s)`` or
    ``None`` when the dispatcher has no probed view yet."""
    disp = control.dispatcher
    pipe = control.pipeline
    if disp.probed is None or control.desired is None or pipe is None:
        return None
    from repro_torch.core.bottleneck import service_times

    graph = control.desired.graph
    return service_times(
        [p.partition for p in pipe.pods],
        [p.node_id for p in pipe.pods],
        disp.probed.bw,
        flops_per_node=[n.flops_per_s for n in control.cluster.nodes],
        in_bytes=graph.in_bytes,
        out_bytes=graph.layers[-1].out_bytes,
        dispatcher=disp.leader,
        compression_ratio=pipe.compression_ratio,
        codecs=pipe.link_codecs,
    )


def predicted_bottleneck(compute_s, link_s) -> dict:
    """The plan-side bottleneck resource, comparable to the observed one."""
    candidates = [("stage", i, t) for i, t in enumerate(compute_s)]
    candidates += [("link", h, t) for h, t in enumerate(link_s)
                   if math.isfinite(t)]
    kind, index, service = max(candidates, key=lambda c: c[2])
    return {"kind": kind, "index": index, "service_s": service}


def pin_service_times(analysis: dict, compute_s, link_s,
                      rel_tol: float = 0.05) -> dict:
    """Pin observed per-stage exec medians against the plan's compute
    times, and the observed bottleneck against the plan's.

    Returns a flat report with per-stage rows, the worst relative error,
    and ``within_tol`` / ``bottleneck_agrees`` verdicts.
    """
    rows = []
    worst = 0.0
    predicted = list(compute_s)
    for row in analysis["stages"]:
        s = row["stage"]
        if s >= len(predicted):
            continue
        pred = predicted[s]
        obs = row["median_s"]
        rel = abs(obs - pred) / pred if pred > 0 else abs(obs - pred)
        worst = max(worst, rel)
        rows.append({"stage": s, "observed_s": obs, "predicted_s": pred,
                     "rel_err": rel})
    plan_bn = predicted_bottleneck(compute_s, link_s)
    obs_bn = analysis["bottleneck"]
    agrees = (obs_bn is not None
              and obs_bn["kind"] == plan_bn["kind"]
              and obs_bn["index"] == plan_bn["index"])
    return {
        "stages": rows,
        "max_rel_err": worst,
        "rel_tol": rel_tol,
        "within_tol": bool(rows) and worst <= rel_tol,
        "observed_bottleneck": obs_bn,
        "predicted_bottleneck": plan_bn,
        "bottleneck_agrees": agrees,
    }
