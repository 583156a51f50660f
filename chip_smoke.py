#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, one line of output each (or a few), failing with a non-zero exit on
the first fault:

1. device  -- a CUDA device must be present; prints ``nvidia-smi``'s name and
   power limit.
2. build   -- builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, in parallel) and prints each kernel's
   registers, shared memory and spills.
3. parity  -- each kernel against its plain PyTorch version on the card, at
   the shapes the served path gives it: quantize codes and scales equal,
   dequantize exact, dequant_matmul within 1e-5 of max|plain|, flash
   attention within 2e-5 max-abs (f32) for the global and windowed,
   soft-capped layers and a plain causal one.
4. serve demo_transformer at gemma2-27b attention width (d=4096, 32 heads,
   16 kv heads, hd=128, MLP 8x, softcap 50, window 4096, S=8192, 4 layers)
   through ``deploy`` with int8 hops: 4 requests, a ``NodeFailed`` on a
   hosting node, 4 more; every result a finite CUDA tensor, each request
   completed once; the quantize, dequant_matmul and flash kernels launched.
5. serve demo_mlp(d=4096) with int8 hops: the hop decode runs the
   dequantize kernel.
6. reference -- a small demo_transformer deployed on the card and on the
   CPU (the plain versions, which the CPU tests hold to the JAX package)
   with the same weights: outputs within INT8_MAX_REL_ERROR of max|ref|.
7. times  -- each kernel (CUDA events, after warm-up, mean over launches)
   beside its bound, its plain version's time and a library call's (none
   computes these functions in one PyTorch call here).

The last two lines are a JSON object of the kernels and the device line.
Weights and requests are random, drawn from fixed seeds.

``python3 chip_smoke.py --profile`` also serves one more demo_transformer
microbatch under ``torch.profiler`` and prints the device time by kernel
and the device's idle share over that serve.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM and f32 FMA
MEM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TOL_FLASH = 2e-5
TOL_DQMM = 1e-5

# demo_transformer at gemma2-27b attention width; depth cut to 4 layers
SERVED = dict(d=4096, n_layers=4, seq=8192, heads=32, kv_heads=16, mlp_mult=8,
              window=4096, softcap=50.0, attn_block=128)
MICROBATCH = 4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
                  f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {card}")
    return card


def readable_kernel_name(mangled: str) -> str:
    """``_ZN..16flash_fwd_kernelILi128EE..`` -> ``flash_fwd_kernel<128>``."""
    for m in re.finditer(r"\d+", mangled):
        name = mangled[m.end():m.end() + int(m.group())]
        if name.endswith("_kernel") and name.isidentifier():
            rest = mangled[m.end() + len(name):]
            arg = re.match(r"I(?:Li(\d+)E|13__nv_bfloat16E|fE)", rest)
            if not arg:
                return name
            kind = arg.group(1) or ("bf16" if "bfloat16" in arg.group() else "f32")
            return f"{name}<{kind}>"
    return mangled


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.lib()
    say("build", f"{_build.BUILD / _build.LIB_NAME} in {time.perf_counter() - t0:.1f} s")
    name, spills = None, "?"
    for line in _build.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = readable_kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            say("build", f"{name}: {m.group(1)} registers, "
                         f"{smem.group(1) if smem else 0} B static shared memory, {spills}")


def randn(shape, seed, scale=1.0):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda") * scale


def phase_parity() -> dict:
    """Each kernel vs its plain version at the served shapes; max errors."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.quantize.kernel import (
        dequant_matmul_cuda,
        dequantize_int8_cuda,
        quantize_int8_cuda,
    )
    from repro_torch.kernels.quantize.ref import dequant_matmul_ref, dequantize_ref, quantize_ref

    d, s, n = SERVED["d"], SERVED["seq"], MICROBATCH
    heads, kvh = SERVED["heads"], SERVED["kv_heads"]
    hd = d // heads
    proj = (heads + 2 * kvh) * hd
    err = {}

    x = randn((n, s, d), 1)
    q, sc = quantize_int8_cuda(x, 256)
    q_ref, s_ref = quantize_ref(x, 256)
    torch.cuda.synchronize()
    if not (torch.equal(q, q_ref) and torch.equal(sc, s_ref)):
        fail(f"quantize_int8: {(q != q_ref).sum().item()} codes and "
             f"{(sc != s_ref).sum().item()} scales differ from the plain version")
    err["quantize_int8"] = 0.0
    say("parity", f"quantize_int8 {tuple(x.shape)} f32: codes and scales identical")

    qm, sm = quantize_ref(randn((n, d), 2), 256)  # demo_mlp's hop payload
    for shape_q, shape_s in ((qm, sm), (q[:1], sc[:1])):
        out = dequantize_int8_cuda(shape_q, shape_s, dtype=torch.float32, block=256)
        if not torch.equal(out, dequantize_ref(shape_q, shape_s, torch.float32, 256)):
            fail(f"dequantize_int8 {tuple(shape_q.shape)}: not exact")
    err["dequantize_int8"] = 0.0
    say("parity", f"dequantize_int8 {tuple(qm.shape)} and {tuple(q[:1].shape)} -> f32: exact")

    w = randn((d, proj), 3, 0.3)
    out = dequant_matmul_cuda(q, sc, w, dtype=torch.float32, block=256)
    ref = dequant_matmul_ref(q, sc, w, dtype=torch.float32, block=256)
    abs_err = (out - ref).abs().max().item()
    rel = abs_err / ref.abs().max().item()
    if not rel <= TOL_DQMM:
        fail(f"dequant_matmul: {rel:.3g} of max|plain| > {TOL_DQMM}")
    err["dequant_matmul"] = abs_err
    say("parity", f"dequant_matmul ({n * s}, {d}) x ({d}, {proj}): max-abs {abs_err:.3g}, "
                  f"{rel:.3g} of max|plain| (pin {TOL_DQMM})")
    del out, ref, w

    qkv = randn((1, s, proj), 4)
    fq = qkv[..., : heads * hd].reshape(1, s, heads, hd)
    fk = qkv[..., heads * hd: (heads + kvh) * hd].reshape(1, s, kvh, hd)
    fv = qkv[..., (heads + kvh) * hd:].reshape(1, s, kvh, hd)
    g = heads // kvh
    worst = 0.0
    for window, softcap in ((0, SERVED["softcap"]), (SERVED["window"], SERVED["softcap"]), (0, 0.0)):
        o = flash_attention_cuda(fq, fk, fv, causal=True, window=window, softcap=softcap)
        case = 0.0
        for j in range(kvh):  # the plain version one kv-head group at a time
            ref = attention_ref(fq[:, :, j * g:(j + 1) * g].contiguous(),
                                fk[:, :, j:j + 1].contiguous(), fv[:, :, j:j + 1].contiguous(),
                                causal=True, window=window, softcap=softcap)
            case = max(case, (o[:, :, j * g:(j + 1) * g] - ref).abs().max().item())
        if not case <= TOL_FLASH:
            fail(f"flash_attention window={window} softcap={softcap}: max-abs {case:.3g} > {TOL_FLASH}")
        worst = max(worst, case)
        say("parity", f"flash_attention (1, {s}, {heads}/{kvh}, {hd}) causal window={window} "
                      f"softcap={softcap}: max-abs {case:.3g} (pin {TOL_FLASH})")
    err["flash_attention_fwd"] = worst
    del qkv, fq, fk, fv, o, ref, x, q, sc, q_ref, s_ref
    torch.cuda.empty_cache()
    return err


def phase_serve_transformer() -> tuple[dict, dict]:
    import torch

    from repro_torch.api import ClusterSpec, DeploymentSpec, deploy
    from repro_torch.cluster import NodeFailed
    from repro_torch.core.model_zoo import demo_transformer
    from repro_torch.kernels import launch_counts, reset_launch_counts

    graph, executor_for_version = demo_transformer(**SERVED, device="cuda")
    spec = DeploymentSpec(
        model=graph, executor_for_version=executor_for_version,
        cluster=ClusterSpec(n_nodes=6, capacity_bytes=graph.total_param_bytes / 2.5, seed=5),
        codec="int8", seed=3, microbatch=MICROBATCH, device="cuda")
    t0 = time.perf_counter()
    d = deploy(spec)
    torch.cuda.synchronize()
    if "int8" not in d.plan.codecs:
        fail(f"planner put no int8 hop on the wire: {d.plan.codecs}")
    if "int8" not in d.control.pipeline.executor.fused_codecs:
        fail("demo_transformer lost its fused int8 handler")
    say("serve", f"demo_transformer {SERVED} deployed in {time.perf_counter() - t0:.1f} s: "
                 f"path {list(d.plan.path)}, codecs {list(d.plan.codecs)}, "
                 f"{graph.total_param_bytes / 1e9:.2f} GB of f32 weights")

    reset_launch_counts()
    shape = (SERVED["seq"], SERVED["d"])
    times = {}
    submitted = []
    for round_, (seed0, label) in enumerate(((100, "first"), (200, "after NodeFailed"))):
        if round_ == 1:
            victim = d.control.pipeline.pods[1].node_id
            d.inject(NodeFailed(victim))
            kinds = [a.kind for a in d.reconcile()]
            say("serve", f"NodeFailed({victim}) -> {kinds}; path now {list(d.plan.path)}")
            if victim in d.plan.path:
                fail("the failed node still hosts a stage")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MICROBATCH):
            submitted.append(d.submit(randn(shape, seed0 + i, 0.5)))
        done = d.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        times[label] = wall / MICROBATCH
        if len(done) != MICROBATCH:
            fail(f"{label}: {len(done)} of {MICROBATCH} requests completed")
        say("serve", f"{label}: {MICROBATCH} requests in {wall:.2f} s wall, "
                     f"{wall / MICROBATCH * 1e3:.1f} ms per request")
    counts = launch_counts()
    ids = [r.req_id for r in d.loop.completed]
    if sorted(ids) != sorted(r.req_id for r in submitted) or len(set(ids)) != len(ids):
        fail(f"requests not completed exactly once: {ids}")
    if d.loop.failed:
        fail(f"{len(d.loop.failed)} requests failed")
    for r in submitted:
        res = r.result
        if not (isinstance(res, torch.Tensor) and res.is_cuda and tuple(res.shape) == shape
                and bool(torch.isfinite(res).all())):
            fail(f"request {r.req_id}: result is not a finite CUDA tensor of shape {shape}")
    say("serve", f"8 of 8 requests completed once, finite CUDA tensors {shape}; "
                 f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
                 f"launches {counts}")
    for name in ("quantize_int8_cuda", "dequant_matmul_cuda", "flash_attention_cuda"):
        if counts[name] == 0:
            fail(f"{name} was never launched on the served path")
    if "--profile" in sys.argv[1:]:
        profile_serve(d, shape)
    del d, submitted
    torch.cuda.empty_cache()
    return counts, times


def profile_serve(d, shape) -> None:
    """Serve one microbatch under torch.profiler: device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(MICROBATCH):
        d.submit(randn(shape, 500 + i, 0.5))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        d.drain()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        fail("the profiler saw no device time")
    say("profile", f"one microbatch of {MICROBATCH}: {wall_ms:.1f} ms wall, {busy_ms:.1f} ms "
                   f"device busy, idle share {max(0.0, 1 - busy_ms / wall_ms):.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        say("profile", f"{ms:10.2f} ms {ms / busy_ms:6.1%} x{e.count:<4d} {e.key[:110]}")


def phase_serve_mlp() -> dict:
    import torch

    from repro_torch.api import ClusterSpec, DeploymentSpec, deploy
    from repro_torch.core.model_zoo import demo_mlp
    from repro_torch.kernels import launch_counts, reset_launch_counts

    graph, executor_for_version = demo_mlp(d=4096, device="cuda")
    d = deploy(DeploymentSpec(
        model=graph, executor_for_version=executor_for_version,
        cluster=ClusterSpec(n_nodes=6, capacity_bytes=graph.total_param_bytes / 2.5, seed=5),
        codec="int8", seed=3, microbatch=MICROBATCH, device="cuda"))
    if "int8" not in d.plan.codecs:
        fail(f"planner put no int8 hop on demo_mlp's wire: {d.plan.codecs}")
    reset_launch_counts()
    reqs = [d.submit(randn((4096,), 300 + i, 0.5)) for i in range(2 * MICROBATCH)]
    done = d.drain()
    torch.cuda.synchronize()
    counts = launch_counts()
    if len(done) != len(reqs) or not all(
            r.result.is_cuda and bool(torch.isfinite(r.result).all()) for r in reqs):
        fail("demo_mlp: not every request completed with a finite CUDA result")
    say("serve", f"demo_mlp(d=4096) codecs {list(d.plan.codecs)}: {len(done)} requests; "
                 f"launches {counts}")
    for name in ("quantize_int8_cuda", "dequantize_int8_cuda"):
        if counts[name] == 0:
            fail(f"{name} was never launched on demo_mlp's int8 hops")
    return counts


def phase_reference():
    """A small demo_transformer on the card vs the same on the CPU."""
    import numpy as np
    import torch

    from repro_torch.api import ClusterSpec, DeploymentSpec, deploy
    from repro_torch.core.model_zoo import demo_transformer
    from repro_torch.kernels.quantize import INT8_MAX_REL_ERROR

    small = dict(d=256, n_layers=4, seq=256, heads=4, kv_heads=2, mlp_mult=2,
                 window=128, softcap=50.0)
    hd = small["d"] // small["heads"]
    proj = (small["heads"] + 2 * small["kv_heads"]) * hd
    f = small["mlp_mult"] * small["d"]
    L, dm = small["n_layers"], small["d"]

    def params(version):
        rng = np.random.default_rng(1000 + version)
        return {k: rng.standard_normal(shp, dtype=np.float32) * 0.3 for k, shp in (
            ("wqkv", (L, dm, proj)), ("wo", (L, dm, dm)), ("w1", (L, dm, f)), ("w2", (L, f, dm)))}

    outs = {}
    for device in ("cuda", "cpu"):
        graph, ex = demo_transformer(**small, device=device, params_for_version=params)
        d = deploy(DeploymentSpec(
            model=graph, executor_for_version=ex,
            cluster=ClusterSpec(n_nodes=6, capacity_bytes=graph.total_param_bytes / 2.5, seed=5),
            codec="int8", seed=3, device=device))
        for i in range(3):  # constant activations: the kernel_path input family
            d.submit(torch.full((small["seq"], dm), 0.1 * (i + 1)))
        outs[device] = {r.req_id: r.result.float().cpu().numpy() for r in d.drain()}
        codecs = list(d.plan.codecs)
    worst = 0.0
    for rid, ref in outs["cpu"].items():
        rel = float(np.abs(outs["cuda"][rid] - ref).max() / np.abs(ref).max())
        worst = max(worst, rel)
    if not worst <= INT8_MAX_REL_ERROR:
        fail(f"small demo_transformer: card vs CPU {worst:.3g} of max|ref| > {INT8_MAX_REL_ERROR:.3g}")
    say("reference", f"demo_transformer {small} codecs {codecs}: card vs CPU plain path "
                     f"{worst:.3g} of max|ref| (pin {INT8_MAX_REL_ERROR:.3g})")


def phase_times(card: str, launches: dict, errors: dict) -> list[dict]:
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.quantize.kernel import (
        dequant_matmul_cuda,
        dequantize_int8_cuda,
        quantize_int8_cuda,
    )
    from repro_torch.kernels.quantize.ref import dequant_matmul_ref, dequantize_ref, quantize_ref

    d, s, n = SERVED["d"], SERVED["seq"], MICROBATCH
    heads, kvh = SERVED["heads"], SERVED["kv_heads"]
    hd = d // heads
    proj = (heads + 2 * kvh) * hd
    rows = []

    def row(name, source, replaces, kernel, plain, reps, nbytes, flops, shape):
        ms = cuda_time_ms(kernel, reps)
        plain_ms = cuda_time_ms(plain, max(1, reps // 2))
        b_ms, b_by = bound_ms(nbytes, flops)
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": errors[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
        say("times", f"{name} {shape}: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                     f"{b_ms / ms:.1%} of it), plain {plain_ms:.4f} ms, library none; {card}")

    x = randn((n, s, d), 11)
    q, sc = quantize_int8_cuda(x, 256)
    nb = sc.shape[-1]
    row("quantize_int8", "src/repro_torch/kernels/csrc/quantize.cu",
        "src/repro/kernels/quantize/kernel.py:47",
        lambda: quantize_int8_cuda(x, 256), lambda: quantize_ref(x, 256), 50,
        x.numel() * 4 + x.numel() + sc.numel() * 4, 5 * x.numel(), tuple(x.shape))

    qm, sm = quantize_int8_cuda(randn((n, d), 12), 256)  # demo_mlp's hop payload
    row("dequantize_int8", "src/repro_torch/kernels/csrc/quantize.cu",
        "src/repro/kernels/quantize/kernel.py:84",
        lambda: dequantize_int8_cuda(qm, sm, torch.float32, 256),
        lambda: dequantize_ref(qm, sm, torch.float32, 256), 200,
        qm.numel() + sm.numel() * 4 + qm.numel() * 4, qm.numel(), tuple(qm.shape))
    big = cuda_time_ms(lambda: dequantize_int8_cuda(q, sc, torch.float32, 256), 20)
    b_ms, b_by = bound_ms(q.numel() * 5 + sc.numel() * 4, q.numel())
    say("times", f"dequantize_int8 {tuple(q.shape)} (not on the served path): {big:.4f} ms, "
                 f"bound {b_ms:.4f} ms ({b_by}); {card}")

    w = randn((d, proj), 13, 0.3)
    rows_n = n * s
    row("dequant_matmul", "src/repro_torch/kernels/csrc/quantize.cu",
        "src/repro/kernels/quantize/kernel.py:122",
        lambda: dequant_matmul_cuda(q, sc, w, torch.float32, 256),
        lambda: dequant_matmul_ref(q, sc, w, torch.float32, 256), 5,
        q.numel() + sc.numel() * 4 + w.numel() * 4 + rows_n * proj * 4,
        2 * rows_n * d * proj + rows_n * d, (rows_n, d, proj))
    del x, w
    torch.cuda.empty_cache()

    qkv = randn((n, s, proj), 14)
    fq = qkv[..., : heads * hd].reshape(n, s, heads, hd)
    fk = qkv[..., heads * hd: (heads + kvh) * hd].reshape(n, s, kvh, hd)
    fv = qkv[..., (heads + kvh) * hd:].reshape(n, s, kvh, hd)
    g = heads // kvh
    softcap = SERVED["softcap"]

    def plain(window):
        def run():
            for j in range(kvh):
                attention_ref(fq[:, :, j * g:(j + 1) * g], fk[:, :, j:j + 1],
                              fv[:, :, j:j + 1], causal=True, window=window, softcap=softcap)
        return run

    def live_pairs(window):
        if window <= 0:
            return s * (s + 1) // 2
        return sum(min(i + 1, window) for i in range(s))

    io_bytes = (fq.numel() * 2 + fk.numel() * 2) * 4  # q, o, k, v read/written once
    row("flash_attention_fwd", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:96",
        lambda: flash_attention_cuda(fq, fk, fv, causal=True, window=0, softcap=softcap),
        plain(0), 3, io_bytes, 4 * hd * live_pairs(0) * n * heads,
        (n, s, heads, kvh, hd, "global causal, softcap"))
    win = SERVED["window"]
    ms = cuda_time_ms(lambda: flash_attention_cuda(fq, fk, fv, causal=True, window=win,
                                                   softcap=softcap), 3)
    b_ms, b_by = bound_ms(io_bytes, 4 * hd * live_pairs(win) * n * heads)
    say("times", f"flash_attention_fwd window={win} (the served local layers): {ms:.4f} ms, "
                 f"bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of it); {card}")
    return rows


def main() -> None:
    card = phase_device()
    sys.path.insert(0, str(SRC))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e})")
    from repro_torch.core.execution import resolve_device

    resolve_device("cuda")  # full-f32 matmuls: the plain versions are f32 references
    phase_build()
    errors = phase_parity()
    counts_tf, per_request = phase_serve_transformer()
    counts_mlp = phase_serve_mlp()
    phase_reference()
    launches = {
        "quantize_int8": counts_tf["quantize_int8_cuda"],
        "dequant_matmul": counts_tf["dequant_matmul_cuda"],
        "flash_attention_fwd": counts_tf["flash_attention_cuda"],
        "dequantize_int8": counts_mlp["dequantize_int8_cuda"],
    }
    rows = phase_times(card, launches, errors)
    say("serve", "wall time per served request (demo_transformer, 4 per microbatch): "
                 + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in per_request.items()))
    if not all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows):
        fail("a kernel time is not a positive number")
    import torch

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
