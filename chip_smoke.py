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
   the shapes the served path gives it: quantize codes and scales equal and
   dequantize exact at demo_ssm's and demo_transformer's hop payloads
   (dequantize also at demo_mlp's; the path each takes is printed),
   dequant_matmul within 1e-5 of max|plain|, flash
   attention within 2e-5 max-abs (f32) for the global and windowed,
   soft-capped layers and a plain causal one; the SSD scan within 1e-5 of
   max|plain| (``ssd_ref_segmented``: the plain version chunked at 64 and
   cut into segments as the kernel cuts them) at the served shape, on
   demo_ssm's layer-0 activations, ragged (S=96), at S=8 and at a forced
   P=5 over a ragged S=1000 with a slow decay.
4. serve demo_transformer at gemma2-27b attention width (d=4096, 32 heads,
   16 kv heads, hd=128, MLP 8x, softcap 50, window 4096, S=8192, 4 layers)
   through ``deploy`` with int8 hops: 4 requests, a ``NodeFailed`` on a
   hosting node, 4 more; every result a finite CUDA tensor, each request
   completed once; the quantize, dequant_matmul and flash kernels launched.
5. serve demo_mlp(d=4096) with int8 hops (the hop decode runs the
   dequantize kernel), then with fp16 hops (``codec="auto"`` at accuracy
   tolerance 1e-3) and with topk-sparse hops: every request completed once
   as a finite CUDA tensor, the plan carrying the named codec.
6. serve demo_ssm at zamba2-2.7b's Mamba2 mixer width (d = d_inner = 5120,
   80 heads of 64, N=64, S=8192, 6 layers) the same way as phase 4: the
   SSD scan, quantize and dequantize kernels launched.
7. serve two tenants on one cluster, ``deploy([TenantSpec("ssm", ...),
   TenantSpec("transformer", ...)])`` (phase 6's demo_ssm, and phase 4's
   demo_transformer cut to 2 layers), int8 hops in both; a ``NodeFailed``
   on a node only the ssm tenant owns leaves the transformer's plan as it
   was; every request of both completes once.
8. reference -- a small demo_transformer and a small demo_ssm deployed on
   the card and on the CPU (the plain versions, which the CPU tests hold to
   the JAX package) with the same weights: outputs within
   INT8_MAX_REL_ERROR of max|ref|.
9. replicas -- the serving branches beside one pipeline, at full width:
   demo_transformer at phase 4's width served ``serving="sync"`` and
   pipelined from one spec, whose outputs must be ``torch.equal``; demo_ssm
   (phase 6's model, weights and int8 hops) with ``replicas=2`` on a
   12-node cluster, every span traced, 16 open-loop Poisson arrivals
   through ``submit_trace``, a ``NodeFailed`` on a node of replica 0 (which
   re-places it alone: replica 1's path holds), then version 1 published
   and rolled one replica at a time by ``poll_model_updates`` under 8 more
   requests, and 2 more whose inputs version 0 served (the outputs must
   differ); and the same model autoscaled from 1 to 2 replicas under a
   bursty trace (a ``grow`` event recorded).  Every request completes once
   as a finite CUDA tensor, the spans cover every completed request and
   the attribution's fractions sum to 1; the SSD scan, quantize,
   dequantize, dequant_matmul and flash kernels are launched.  Prints wall
   time per request of each run and the virtual clock's throughputs (one
   card runs the replicas in turn, so only the virtual clock models the
   cluster).
10. times -- each kernel (CUDA events, after warm-up, mean over launches)
   beside its bound, its plain version's time and yardsticks the port never
   calls: for flash attention (global and windowed layers, each a row) the
   one PyTorch call that computes it, FlexAttention under ``torch.compile``
   with the softcap as ``score_mod`` and the masks as a ``block_mask``
   (``library_ms``); for dequant_matmul the dequantize kernel followed by
   ``torch.matmul`` (``unfused_ms``, interleaved best-of with the fused
   kernel, and their ratio).  A yardstick that fails prints as such and
   gives null.  The bound is the larger of bytes / 3.35 TB/s and FLOPs at
   the cheapest tensor-core route of an f32-accurate product: 3 TF32 passes
   (495 TFLOP/s) under split-TF32, or 2 bf16 passes (989 TFLOP/s) where one
   operand is an exact int8 code and the other two bf16 pieces; the f32 FMA bound
   stays beside it as ``bound_f32_fma_ms``.  dequantize is timed at
   demo_ssm's hop, and its scalar path (the kernel before the vector path,
   on the same codes at an odd byte offset) against its vector path there,
   interleaved turns of 20 launches, in f32 and bf16; the SSD scan's bound
   counts the fewest operations of any chunking, and the kernel's own Q=64
   count is printed beside it, with
   its segments P, the FLOPs and bytes of the segmented design (state pass
   and folds counted) and its time unsegmented (P=1) against P.

The last three lines are a JSON object of the kernels, the card's name and
power limit, and the device line.
Weights and requests are random, drawn from fixed seeds.

``python3 chip_smoke.py --profile`` also serves one more demo_transformer
and one more demo_ssm microbatch under ``torch.profiler`` and prints the
device time by kernel and the device's idle share over each serve; then the
error budget of the split-precision kernels (each against its plain
version, an f64 run and the model of its arithmetic in
``repro_torch.kernels.split_precision``, whose difference from the kernel is
the tensor cores' own accumulation; flash, dequant_matmul and the SSD scan
at its served shape) and a probe of ``mma.sync`` TF32
throughput (independent m16n8k8 products from registers, no memory
traffic): the ceiling of the route the tensor-core kernels take.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
# torch.compile's caches (the FlexAttention yardstick) stay inside the checkout
for _var, _sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(ROOT / "build" / _sub))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM, f32 FMA and
# the dense tensor cores at TF32 and bf16
MEM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
# seconds per FLOP of an f32-accurate product on the tensor cores, by the
# cheapest route whose model holds the pin with half of it to spare
# (tests/test_torch_split_precision.py).  Two f32 operands: split-TF32, 3
# passes (two bf16 pieces each miss that margin; three take 6 bf16 passes,
# the same time).  int8 codes times f32 w: the codes are exact in bf16 and
# two bf16 pieces of w hold the pin, 2 bf16 passes; the kernel takes 2
# split-TF32 passes (TF32_CODE_S_PER_FLOP), printed beside.
F32_PRODUCT_S_PER_FLOP = 3 / TF32_FLOP_PER_S
CODE_PRODUCT_S_PER_FLOP = 2 / BF16_FLOP_PER_S
TF32_CODE_S_PER_FLOP = 2 / TF32_FLOP_PER_S
TOL_FLASH = 2e-5
TOL_DQMM = 1e-5

# demo_transformer at gemma2-27b attention width; depth cut to 4 layers
SERVED = dict(d=4096, n_layers=4, seq=8192, heads=32, kv_heads=16, mlp_mult=8,
              window=4096, softcap=50.0, attn_block=128)
MICROBATCH = 4
# demo_ssm at zamba2-2.7b's Mamba2 mixer width (d_inner = 2 x 2560, headdim
# 64, d_state 64); 6 layers, the JAX package's default depth
SSM = dict(d=5120, n_layers=6, seq=8192, heads=80, state=64)
TOL_SSD = 1e-5


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


def bound_ms(nbytes: float, flops: float, s_per_flop: float = 0.0) -> tuple[float, str, float]:
    """(least time in ms, what bounds it, the f32-FMA bound in ms): bytes
    over HBM, against ``flops`` on the tensor cores at ``s_per_flop`` (0:
    the work has no products, only f32 FMA-unit arithmetic)."""
    t_bytes, t_fma = nbytes / MEM_BYTES_PER_S, flops / F32_FLOP_PER_S
    t_ops = flops * s_per_flop if s_per_flop else t_fma
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, max(t_bytes, t_fma) * 1e3


def best_interleaved_ms(fns, reps: int, launches: int = 1) -> list[float]:
    """Best-of-``reps`` device time of each fn, one turn of each in turn, so
    drift hits every candidate alike (``benchmarks/kernel_path.py``'s way).
    A turn is ``launches`` back-to-back calls (their mean): a single call
    also times the host's enqueue of it, tens of microseconds, which a
    kernel of a fraction of a millisecond does not hide."""
    for fn in fns:
        fn()
    best = [math.inf] * len(fns)
    for _ in range(reps):
        for i, fn in enumerate(fns):
            best[i] = min(best[i], cuda_time_ms(fn, launches, warmup=0))
    return best


MMA_PEAK_SRC = r"""
#include <stdint.h>
constexpr int CHAINS = 16;  // independent accumulators a warp
__global__ void mma_peak(float* out, int iters) {
  uint32_t a[4], b0 = __float_as_uint(0.5f), b1 = __float_as_uint(0.25f);
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + (threadIdx.x + i) * 1e-3f) & 0xffffe000u;
  float c[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int ch = 0; ch < CHAINS; ++ch)
      asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(c[ch][0]), "+f"(c[ch][1]), "+f"(c[ch][2]), "+f"(c[ch][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.0f;
#pragma unroll
  for (int ch = 0; ch < CHAINS; ++ch) s += c[ch][0] + c[ch][1] + c[ch][2] + c[ch][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_mma_peak(void* out, int blocks, int threads, int iters) {
  mma_peak<<<blocks, threads>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
"""


def phase_mma_peak(card: str) -> None:
    """TF32 ``mma.sync`` m16n8k8 throughput from registers: 16 independent
    accumulator chains a warp, 8 warps a block, 2 blocks an SM."""
    import ctypes

    import torch

    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "mma_peak.cu", out_dir / "libmma_peak.so"
    src.write_text(MMA_PEAK_SRC)
    build = subprocess.run([_build._nvcc(), *_build.ARCH, "-O3", "-shared", "-Xcompiler", "-fPIC",
                            str(src), "-o", str(lib)], capture_output=True, text=True, timeout=300)
    if build.returncode != 0:
        fail(f"mma probe build failed:\n{build.stdout}{build.stderr}")
    fn = ctypes.CDLL(str(lib)).run_mma_peak
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 2 * sms * 4, 256, 4096
    out = torch.empty(blocks * threads, device="cuda")
    ms = cuda_time_ms(lambda: _build.check(fn(out.data_ptr(), blocks, threads, iters), "mma_peak"), 3)
    flops = blocks * threads // 32 * iters * 16 * 2 * 16 * 8 * 8
    say("mma-peak", f"mma.sync m16n8k8 TF32 from registers: {flops / ms / 1e9:.1f} TFLOP/s "
                    f"({flops / ms / 1e9 / (TF32_FLOP_PER_S / 1e12):.1%} of the dense TF32 peak); {card}")


def phase_accuracy(card: str) -> None:
    """Where the tensor-core kernels' error comes from: each against its
    plain f32 version, an f64 run and the model of its split-precision
    arithmetic (exact products, sums rounded to nearest).  kernel - model is
    what the tensor cores' own accumulation adds."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.quantize.kernel import dequant_matmul_cuda
    from repro_torch.kernels.quantize.ref import dequant_matmul_ref, quantize_ref
    from repro_torch.kernels.split_precision import (
        attention_emulated,
        dequant_matmul_emulated,
        ssd_emulated,
    )
    from repro_torch.kernels.ssm_scan.kernel import (
        KERNEL_CHUNK,
        default_segments,
        ssd_chunked_cuda,
    )
    from repro_torch.kernels.ssm_scan.ref import ssd_ref_padded

    def diff(a, b):
        return (a.double() - b.double()).abs().max().item()

    softcap = SERVED["softcap"]
    for case, (s, std) in enumerate(((2048, 1.0), (8192, 1.0), (8192, 5.0))):
        q, k, v = (randn((1, s, 2 if i == 0 else 1, 128), 40 + 3 * case + i, std)
                   for i in range(3))
        out = flash_attention_cuda(q, k, v, causal=True, window=0, softcap=softcap)
        plain = attention_ref(q, k, v, causal=True, window=0, softcap=softcap)
        model = attention_emulated(q, k, v, causal=True, window=0, softcap=softcap)
        exact = attention_emulated(q.double(), k.double(), v.double(), causal=True, window=0,
                                   softcap=softcap, matmul=torch.matmul)  # f64 throughout
        say("accuracy", f"flash (1, {s}, 2/1, 128) std {std}, causal, softcap {softcap}: kernel "
                        f"vs plain {diff(out, plain):.3g}, model vs plain {diff(model, plain):.3g}, "
                        f"kernel vs model {diff(out, model):.3g}; vs f64: kernel "
                        f"{diff(out, exact):.3g}, plain {diff(plain, exact):.3g}, model "
                        f"{diff(model, exact):.3g}; {card}")
        del q, k, v, out, plain, model, exact
    qc, sc = quantize_ref(randn((4096, 4096), 45), 256)
    w = randn((4096, 1024), 46, 0.3)
    out = dequant_matmul_cuda(qc, sc, w, dtype=torch.float32, block=256)
    plain = dequant_matmul_ref(qc, sc, w, dtype=torch.float32, block=256)
    model = dequant_matmul_emulated(qc, sc, w, 256)
    exact = (qc.double().reshape(4096, 16, 256) * sc.double()[..., None]).reshape(4096, 4096)
    exact = exact @ w.double()
    top = plain.abs().max().item()
    say("accuracy", f"dequant_matmul (4096, 4096) x (4096, 1024) block 256, of max|plain|: kernel "
                    f"vs plain {diff(out, plain) / top:.3g}, model vs plain "
                    f"{diff(model, plain) / top:.3g}, kernel vs model {diff(out, model) / top:.3g}; "
                    f"vs f64: kernel {diff(out, exact) / top:.3g}, plain "
                    f"{diff(plain, exact) / top:.3g}; {card}")
    del qc, sc, w, out, plain, model, exact

    # the SSD scan at the served shape: the model is one segment, so the
    # kernel is held to it at one segment too, and at its own P to f64
    h, dh, n = SSM["heads"], SSM["d"] // SSM["heads"], SSM["state"]
    args = ssd_case(MICROBATCH, SSM["seq"], h, dh, n, 20)
    own = ssd_chunked_cuda(*args, chunk=SSM["seq"])
    one = ssd_chunked_cuda(*args, chunk=SSM["seq"], segments=1)
    plain = ssd_ref_padded(*args, chunk=KERNEL_CHUNK)
    model = ssd_emulated(*args, chunk=KERNEL_CHUNK)
    exact = ssd_ref_padded(*(t.double() for t in args), chunk=KERNEL_CHUNK)
    top = plain.abs().max().item()
    say("accuracy", f"ssd_chunked {tuple(args[0].shape)} N={n}, of max|plain|: kernel (P=1) vs "
                    f"model {diff(one, model) / top:.3g}, model vs plain {diff(model, plain) / top:.3g}; "
                    f"vs f64: kernel at P={default_segments(MICROBATCH, SSM['seq'], h, own.device)} "
                    f"{diff(own, exact) / top:.3g}, kernel (P=1) {diff(one, exact) / top:.3g}, "
                    f"model {diff(model, exact) / top:.3g}, plain {diff(plain, exact) / top:.3g}; {card}")
    torch.cuda.empty_cache()


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
            arg = re.match(r"I(?:Li(\d+)E|Lb([01])E|13__nv_bfloat16E|fE)", rest)
            if not arg:
                return name
            kind = (arg.group(1) or {"1": "true", "0": "false"}.get(arg.group(2))
                    or ("bf16" if "bfloat16" in arg.group() else "f32"))
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
        dequantize_path,
        quantize_int8_cuda,
    )
    from repro_torch.kernels.quantize.ref import dequant_matmul_ref, dequantize_ref, quantize_ref

    d, s, n = SERVED["d"], SERVED["seq"], MICROBATCH
    heads, kvh = SERVED["heads"], SERVED["kv_heads"]
    hd = d // heads
    proj = (heads + 2 * kvh) * hd
    err = {}

    # the hop payloads: demo_ssm's (decoded by dequantize_int8), then
    # demo_transformer's (decoded inside dequant_matmul, below)
    for shape, seed in (((n, SSM["seq"], SSM["d"]), 5), ((n, s, d), 1)):
        x = randn(shape, seed)
        q, sc = quantize_int8_cuda(x, 256)
        q_ref, s_ref = quantize_ref(x, 256)
        torch.cuda.synchronize()
        if not (torch.equal(q, q_ref) and torch.equal(sc, s_ref)):
            fail(f"quantize_int8 {shape}: {(q != q_ref).sum().item()} codes and "
                 f"{(sc != s_ref).sum().item()} scales differ from the plain version")
        say("parity", f"quantize_int8 {shape} f32: codes and scales identical")
        if shape[-1] == SSM["d"]:
            out = dequantize_int8_cuda(q, sc, dtype=torch.float32, block=256)
            if not torch.equal(out, dequantize_ref(q, sc, torch.float32, 256)):
                fail(f"dequantize_int8 {shape}: not exact")
            say("parity", f"dequantize_int8 {shape} -> f32 (demo_ssm's hop, "
                          f"{dequantize_path(q, 256)} path): exact")
            del out, x, q, sc, q_ref, s_ref
    err["quantize_int8"] = 0.0

    qm, sm = quantize_ref(randn((n, d), 2), 256)  # demo_mlp's hop payload
    for shape_q, shape_s in ((qm, sm), (q[:1], sc[:1])):
        out = dequantize_int8_cuda(shape_q, shape_s, dtype=torch.float32, block=256)
        if not torch.equal(out, dequantize_ref(shape_q, shape_s, torch.float32, 256)):
            fail(f"dequantize_int8 {tuple(shape_q.shape)}: not exact")
    err["dequantize_int8"] = 0.0
    say("parity", f"dequantize_int8 {tuple(qm.shape)} and {tuple(q[:1].shape)} -> f32: exact")
    say("parity", f"dequantize_int8 paths: demo_mlp's hop {tuple(qm.shape)} "
                  f"{dequantize_path(qm, 256)}, the unfused yardstick's {tuple(q.shape)} "
                  f"{dequantize_path(q, 256)}")

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

    qkv = randn((n, s, proj), 4)  # the microbatch the served path gives the kernel
    fq = qkv[..., : heads * hd].reshape(n, s, heads, hd)
    fk = qkv[..., heads * hd: (heads + kvh) * hd].reshape(n, s, kvh, hd)
    fv = qkv[..., (heads + kvh) * hd:].reshape(n, s, kvh, hd)
    g = heads // kvh
    worst = {"flash_attention_fwd": 0.0, "flash_attention_fwd_window": 0.0}
    for window, softcap in ((0, SERVED["softcap"]), (SERVED["window"], SERVED["softcap"]), (0, 0.0)):
        o = flash_attention_cuda(fq, fk, fv, causal=True, window=window, softcap=softcap)
        case = 0.0
        for j in range(kvh):  # the plain version one kv-head group at a time
            ref = attention_ref(fq[:, :, j * g:(j + 1) * g].contiguous(),
                                fk[:, :, j:j + 1].contiguous(), fv[:, :, j:j + 1].contiguous(),
                                causal=True, window=window, softcap=softcap)
            case = max(case, (o[:, :, j * g:(j + 1) * g] - ref).abs().max().item())
            del ref
        if not case <= TOL_FLASH:
            fail(f"flash_attention window={window} softcap={softcap}: max-abs {case:.3g} > {TOL_FLASH}")
        name = "flash_attention_fwd_window" if window else "flash_attention_fwd"
        worst[name] = max(worst[name], case)
        say("parity", f"flash_attention ({n}, {s}, {heads}/{kvh}, {hd}) causal window={window} "
                      f"softcap={softcap}: max-abs {case:.3g} (pin {TOL_FLASH})")
    err.update(worst)
    del qkv, fq, fk, fv, o, x, q, sc, q_ref, s_ref
    torch.cuda.empty_cache()
    return err


def ssm_params(version: int, cfg: dict | None = None) -> dict:
    """demo_ssm's weights (``SSM`` unless ``cfg``), N(0, 1) * 0.3 from a
    numpy seed, as numpy."""
    import numpy as np

    c = cfg or SSM
    L, d, n, h = c["n_layers"], c["d"], c["state"], c["heads"]
    rng = np.random.default_rng(2000 + version)
    return {k: rng.standard_normal(shp, dtype=np.float32) * 0.3 for k, shp in (
        ("wb", (L, d, n)), ("wc", (L, d, n)), ("wd", (L, d, h)))}


def ssd_case(b, s, h, dh, n, seed):
    """Scan inputs scaled as the JAX package's kernel test scales them."""
    import torch

    return (randn((b, s, h, dh), seed, 0.5), randn((b, s, n), seed + 1, 0.5),
            randn((b, s, n), seed + 2, 0.5),
            torch.nn.functional.softplus(randn((b, s, h), seed + 3)),
            -torch.exp(randn((h,), seed + 4, 0.3)))


def ssm_layer0_inputs(seed: int):
    """The scan's inputs in layer 0 of the served demo_ssm, on a microbatch
    of requests as phase 6 draws them."""
    import torch

    d, seq, heads = SSM["d"], SSM["seq"], SSM["heads"]
    w = {k: torch.as_tensor(v[0], device="cuda") for k, v in ssm_params(0).items()}
    x = torch.stack([randn((seq, d), seed + i, 0.5) for i in range(MICROBATCH)])
    xs = x.reshape(MICROBATCH, seq, heads, d // heads)
    a = torch.full((heads,), -0.5, device="cuda")
    return xs, x @ w["wb"], x @ w["wc"], torch.nn.functional.softplus(x @ w["wd"]), a


def phase_parity_ssd() -> float:
    """The SSD kernel vs its plain version; returns the worst max-abs."""
    import torch

    from repro_torch.kernels.ssm_scan.kernel import (
        KERNEL_CHUNK,
        default_segments,
        ssd_chunked_cuda,
    )
    from repro_torch.kernels.ssm_scan.ref import ssd_ref_padded, ssd_ref_segmented

    h, dh, n = SSM["heads"], SSM["d"] // SSM["heads"], SSM["state"]
    slow = ssd_case(2, 1000, h, dh, n, 50)
    slow = slow[:3] + (slow[3] * 0.01, slow[4])  # a state that reaches the later segments
    cases = (
        ("served shape", ssd_case(MICROBATCH, SSM["seq"], h, dh, n, 20), SSM["seq"], None),
        ("demo_ssm layer-0 activations", ssm_layer0_inputs(600), SSM["seq"], None),
        ("ragged S=96", ssd_case(2, 96, h, dh, n, 30), 32, None),
        ("S=8 (demo_ssm's default)", ssd_case(2, 8, 2, 12, 4, 40), 8, None),
        ("forced P=5, ragged S=1000, dt / 100", slow, 1000, 5),
    )
    worst = 0.0
    for label, args, chunk, forced in cases:
        b, s = args[0].shape[:2]
        p = forced or default_segments(b, s, args[0].shape[2], args[0].device)
        out = ssd_chunked_cuda(*args, chunk=chunk, segments=p)
        ref = ssd_ref_segmented(*args, chunk=KERNEL_CHUNK, segments=min(p, -(-s // KERNEL_CHUNK)))
        torch.cuda.synchronize()
        abs_err = (out - ref).abs().max().item()
        rel = abs_err / ref.abs().max().item()
        shape = tuple(args[0].shape) + (args[1].shape[-1],)
        if not (rel <= TOL_SSD and bool(torch.isfinite(out).all())):
            fail(f"ssd_chunked {label} {shape} P={p}: {rel:.3g} of max|plain| > {TOL_SSD}")
        worst = max(worst, abs_err)
        msg = (f"ssd_chunked {label} (B, S, H, dh, N)={shape} chunk={chunk} segments={p}: "
               f"max-abs {abs_err:.3g}, {rel:.3g} of max|plain| (pin {TOL_SSD})")
        if label == "served shape":  # both against an f64 run of the same scan
            unseg = ssd_ref_padded(*args, chunk=KERNEL_CHUNK)
            exact = ssd_ref_padded(*(t.double() for t in args), chunk=KERNEL_CHUNK)
            msg += (f"; vs the unsegmented plain version {(out - unseg).abs().max().item():.3g}"
                    f"; vs f64: kernel {(out - exact).abs().max().item():.3g}, "
                    f"plain {(ref - exact).abs().max().item():.3g}")
            del exact, unseg
        say("parity", msg)
        del out, ref, args
    torch.cuda.empty_cache()
    return worst


def check_served(reqs, shape, what: str) -> None:
    import torch

    for r in reqs:
        res = r.result
        if not (isinstance(res, torch.Tensor) and res.is_cuda and tuple(res.shape) == shape
                and bool(torch.isfinite(res).all())):
            fail(f"{what} request {r.req_id}: result is not a finite CUDA tensor of shape {shape}")


def phase_serve_ssm() -> tuple[dict, dict]:
    import torch

    from repro_torch.api import ClusterSpec, DeploymentSpec, deploy
    from repro_torch.cluster import NodeFailed
    from repro_torch.core.model_zoo import demo_ssm
    from repro_torch.kernels import launch_counts, reset_launch_counts

    graph, ex = demo_ssm(**SSM, device="cuda", params_for_version=ssm_params)
    d = deploy(DeploymentSpec(
        model=graph, executor_for_version=ex,
        cluster=ClusterSpec(n_nodes=6, capacity_bytes=graph.total_param_bytes / 2.5, seed=5),
        codec="int8", seed=3, microbatch=MICROBATCH, device="cuda"))
    if "int8" not in d.plan.codecs:
        fail(f"planner put no int8 hop on demo_ssm's wire: {d.plan.codecs}")
    say("serve", f"demo_ssm {SSM}: path {list(d.plan.path)}, codecs {list(d.plan.codecs)}, "
                 f"{graph.total_param_bytes / 1e6:.1f} MB of f32 weights")
    shape = (SSM["seq"], SSM["d"])
    reset_launch_counts()
    times, submitted = {}, []
    for round_, (seed0, label) in enumerate(((700, "first"), (800, "after NodeFailed"))):
        if round_ == 1:
            victim = d.control.pipeline.pods[1].node_id
            d.inject(NodeFailed(victim))
            kinds = [a.kind for a in d.reconcile()]
            say("serve", f"demo_ssm NodeFailed({victim}) -> {kinds}; path now {list(d.plan.path)}")
            if victim in d.plan.path:
                fail("the failed node still hosts a demo_ssm stage")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MICROBATCH):
            submitted.append(d.submit(randn(shape, seed0 + i, 0.5)))
        done = d.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        times[label] = wall / MICROBATCH
        if len(done) != MICROBATCH:
            fail(f"demo_ssm {label}: {len(done)} of {MICROBATCH} requests completed")
        say("serve", f"demo_ssm {label}: {MICROBATCH} requests in {wall * 1e3:.1f} ms wall, "
                     f"{wall / MICROBATCH * 1e3:.2f} ms per request")
    counts = launch_counts()
    ids = [r.req_id for r in d.loop.completed]
    if sorted(ids) != sorted(r.req_id for r in submitted) or len(set(ids)) != len(ids):
        fail(f"demo_ssm requests not completed exactly once: {ids}")
    if d.loop.failed:
        fail(f"demo_ssm: {len(d.loop.failed)} requests failed")
    check_served(submitted, shape, "demo_ssm")
    say("serve", f"demo_ssm: {len(ids)} of {len(submitted)} requests completed once, finite CUDA "
                 f"tensors {shape}; launches {counts}")
    for name in ("ssd_chunked_cuda", "quantize_int8_cuda", "dequantize_int8_cuda"):
        if counts[name] == 0:
            fail(f"{name} was never launched on demo_ssm's served path")
    if "--profile" in sys.argv[1:]:
        profile_serve(d, shape, "demo_ssm")
    del d, submitted
    torch.cuda.empty_cache()
    return counts, times


def phase_serve_tenants() -> dict:
    """demo_ssm and a 2-layer demo_transformer as two tenants of one cluster."""
    import torch

    from repro_torch.api import ClusterSpec, DeploymentSpec, TenantSpec, deploy
    from repro_torch.cluster import NodeFailed
    from repro_torch.core.model_zoo import demo_ssm, demo_transformer
    from repro_torch.kernels import launch_counts, reset_launch_counts

    tf_cfg = {**SERVED, "n_layers": 2}
    ssm_graph, ssm_ex = demo_ssm(**SSM, device="cuda", params_for_version=ssm_params)
    tf_graph, tf_ex = demo_transformer(**tf_cfg, device="cuda")
    # per tenant: ssm 2-3 layers per node, transformer one layer per node,
    # so each pipeline has int8 hops between its stages
    caps = {"ssm": ssm_graph.total_param_bytes / 2.5,
            "transformer": tf_graph.total_param_bytes / 1.5}
    cluster = ClusterSpec(n_nodes=8, capacity_bytes=max(caps.values()), seed=5)
    md = deploy([TenantSpec(name, DeploymentSpec(
        model=g, executor_for_version=ex, cluster=cluster, capacity=caps[name],
        codec="int8", seed=3, microbatch=MICROBATCH, device="cuda"))
        for name, g, ex in (("ssm", ssm_graph, ssm_ex), ("transformer", tf_graph, tf_ex))])
    for name in md.names():
        plan = md.deployment(name).plan
        if "int8" not in plan.codecs:
            fail(f"tenant {name}: no int8 hop on its wire: {plan.codecs}")
        say("tenants", f"{name}: slice {list(md.nodes_for(name))}, path {list(plan.path)}, "
                       f"codecs {list(plan.codecs)}")
    shapes = {"ssm": (SSM["seq"], SSM["d"]), "transformer": (SERVED["seq"], SERVED["d"])}
    reset_launch_counts()
    submitted = {name: [] for name in shapes}
    tf_path = list(md.deployment("transformer").plan.path)
    for round_ in range(2):
        if round_ == 1:
            victim = md.deployment("ssm").control.pipeline.pods[1].node_id
            if victim in md.nodes_for("transformer"):
                fail(f"node {victim} is in the transformer tenant's slice")
            md.inject(NodeFailed(victim))
            acts = md.reconcile()
            kinds = {n: [a.kind for a in a_] for n, a_ in acts.items()}
            say("tenants", f"NodeFailed({victim}) -> routed {md.controlplane.routed}, "
                           f"actions {kinds}")
            if acts["transformer"] or list(md.deployment("transformer").plan.path) != tf_path:
                fail("a NodeFailed in the ssm tenant's slice moved the transformer tenant")
            if victim in md.deployment("ssm").plan.path:
                fail("the failed node still hosts an ssm stage")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MICROBATCH):
            for name, shape in shapes.items():
                submitted[name].append(md.submit(name, randn(shape, 900 + 10 * round_ + i, 0.5)))
        done = md.drain()
        torch.cuda.synchronize()
        if len(done) != 2 * MICROBATCH:
            fail(f"tenants round {round_}: {len(done)} of {2 * MICROBATCH} requests completed")
        say("tenants", f"round {round_}: {len(done)} requests in "
                       f"{(time.perf_counter() - t0) * 1e3:.1f} ms wall")
    for name, reqs in submitted.items():
        ids = [r.req_id for r in md.completed(name)]
        if sorted(ids) != sorted(r.req_id for r in reqs) or len(set(ids)) != len(ids):
            fail(f"tenant {name}: requests not completed exactly once: {ids}")
        if any(r.tenant != name for r in reqs):
            fail(f"tenant {name}: a request came back stamped with another tenant")
        check_served(reqs, shapes[name], f"tenant {name}")
    counts = launch_counts()
    say("tenants", f"every request of both tenants completed once as a finite CUDA tensor; "
                   f"transformer plan path {tf_path} unchanged; launches {counts}")
    for name in ("ssd_chunked_cuda", "dequant_matmul_cuda", "flash_attention_cuda",
                 "quantize_int8_cuda", "dequantize_int8_cuda"):
        if counts[name] == 0:
            fail(f"{name} was never launched by the two tenants")
    del md, submitted
    torch.cuda.empty_cache()
    return counts


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
    check_served(submitted, shape, "demo_transformer")
    say("serve", f"8 of 8 requests completed once, finite CUDA tensors {shape}; "
                 f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
                 f"launches {counts}")
    for name in ("quantize_int8_cuda", "dequant_matmul_cuda", "flash_attention_cuda"):
        if counts[name] == 0:
            fail(f"{name} was never launched on the served path")
    if "--profile" in sys.argv[1:]:
        profile_serve(d, shape, "demo_transformer")
    del d, submitted
    torch.cuda.empty_cache()
    return counts, times


def profile_serve(d, shape, what: str) -> None:
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
    idle = max(0.0, 1 - busy_ms / wall_ms)
    say("profile", f"{what}, one microbatch of {MICROBATCH}: {wall_ms:.1f} ms wall, "
                   f"{busy_ms:.1f} ms device busy, idle share {idle:.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        say("profile", f"{ms:10.2f} ms {ms / busy_ms:6.1%} x{e.count:<4d} {e.key[:110]}")


def phase_serve_mlp() -> dict:
    """demo_mlp(d=4096): int8 hops (the quantize and dequantize kernels),
    then fp16 hops (``codec="auto"`` at tolerance 1e-3) and topk-sparse
    hops (plain torch ops on the card)."""
    import torch

    from repro_torch.api import ClusterSpec, DeploymentSpec, deploy
    from repro_torch.core.model_zoo import demo_mlp
    from repro_torch.kernels import launch_counts, reset_launch_counts

    graph, executor_for_version = demo_mlp(d=4096, device="cuda")
    int8_counts = None
    for codec, kw, want in (("int8", {}, "int8"),
                            ("auto", {"accuracy_tolerance": 1e-3}, "fp16"),
                            ("topk-sparse", {}, "topk-sparse")):
        d = deploy(DeploymentSpec(
            model=graph, executor_for_version=executor_for_version,
            cluster=ClusterSpec(n_nodes=6, capacity_bytes=graph.total_param_bytes / 2.5, seed=5),
            codec=codec, seed=3, microbatch=MICROBATCH, device="cuda", **kw))
        if want not in d.plan.codecs:
            fail(f"planner put no {want} hop on demo_mlp's wire (codec={codec!r} {kw}): "
                 f"{d.plan.codecs}")
        reset_launch_counts()
        reqs = [d.submit(randn((4096,), 300 + i, 0.5)) for i in range(2 * MICROBATCH)]
        done = d.drain()
        torch.cuda.synchronize()
        counts = launch_counts()
        ids = [r.req_id for r in done]
        if sorted(ids) != sorted(r.req_id for r in reqs) or len(set(ids)) != len(ids):
            fail(f"demo_mlp codec={codec!r}: requests not completed exactly once: {ids}")
        check_served(reqs, (4096,), f"demo_mlp codec={codec!r}")
        say("serve", f"demo_mlp(d=4096) codec={codec!r} {kw} -> codecs {list(d.plan.codecs)}: "
                     f"{len(done)} requests completed once, finite CUDA tensors; launches {counts}")
        if codec == "int8":
            int8_counts = counts
            for name in ("quantize_int8_cuda", "dequantize_int8_cuda"):
                if counts[name] == 0:
                    fail(f"{name} was never launched on demo_mlp's int8 hops")
        del d, reqs, done
    return int8_counts


def card_vs_cpu(name: str, ctor, cfg: dict, params, shape) -> None:
    """One small model deployed with int8 hops on the card and on the CPU
    (the plain versions, which the CPU tests hold to the JAX package), the
    same weights and constant activations: within INT8_MAX_REL_ERROR."""
    import numpy as np
    import torch

    from repro_torch.api import ClusterSpec, DeploymentSpec, deploy
    from repro_torch.kernels.quantize import INT8_MAX_REL_ERROR

    outs = {}
    for device in ("cuda", "cpu"):
        graph, ex = ctor(**cfg, device=device, params_for_version=params)
        d = deploy(DeploymentSpec(
            model=graph, executor_for_version=ex,
            cluster=ClusterSpec(n_nodes=6, capacity_bytes=graph.total_param_bytes / 2.5, seed=5),
            codec="int8", seed=3, device=device))
        for i in range(3):  # constant activations: the kernel_path input family
            d.submit(torch.full(shape, 0.1 * (i + 1)))
        outs[device] = {r.req_id: r.result.float().cpu().numpy() for r in d.drain()}
        codecs = list(d.plan.codecs)
    if sorted(outs["cuda"]) != sorted(outs["cpu"]) or len(outs["cpu"]) != 3:
        fail(f"small {name}: requests did not complete on both devices")
    worst = 0.0
    for rid, ref in outs["cpu"].items():
        rel = float(np.abs(outs["cuda"][rid] - ref).max() / np.abs(ref).max())
        worst = max(worst, rel)
    if not worst <= INT8_MAX_REL_ERROR:
        fail(f"small {name}: card vs CPU {worst:.3g} of max|ref| > {INT8_MAX_REL_ERROR:.3g}")
    say("reference", f"{name} {cfg} codecs {codecs}: card vs CPU plain path "
                     f"{worst:.3g} of max|ref| (pin {INT8_MAX_REL_ERROR:.3g})")


def phase_reference():
    import numpy as np

    from repro_torch.core.model_zoo import demo_ssm, demo_transformer

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

    card_vs_cpu("demo_transformer", demo_transformer, small, params, (small["seq"], dm))
    small_ssm = dict(d=256, n_layers=6, seq=256, heads=4, state=16)
    card_vs_cpu("demo_ssm", demo_ssm, small_ssm, lambda v: ssm_params(v, small_ssm),
                (small_ssm["seq"], small_ssm["d"]))


# phase 9: replicated (demo_ssm, open-loop Poisson, traced), autoscaled
# (demo_ssm, bursty) and synchronous (demo_transformer) serving
REPLICATED_ARRIVALS = 16
POISSON = dict(rate=0.15, duration_s=200.0, seed=7)  # arrivals/s on the virtual clock
BURSTY = dict(rate=0.3, duration_s=120.0, seed=3)
AUTOSCALED_ARRIVALS = (24, 32)  # at least, at most


def drain_with_kill(d, after: int, replica: int):
    """Serve until idle; once ``after`` requests have completed, fail the
    second stage's node of ``replica``.  Returns the failed node."""
    from repro_torch.cluster import NodeFailed

    victim = None
    for _ in range(100_000):
        if victim is None and len(d.loop.completed) >= after:
            victim = d.replicaset.controls[replica].pipeline.pods[1].node_id
            d.inject(NodeFailed(victim))
        if not (d.loop.backlog or d.loop.pending_arrivals or d.pending):
            return victim
        d.step()
    fail("the replicated deploy did not drain")


def release() -> None:
    """Free what a deleted deployment held on the card: a ``Deployment``
    sits in reference cycles (the journal's clock is a closure over its
    loop), so its tensors go only when the cycle collector runs."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def first_arrivals(arrival, least: int, most: int):
    """The spec's seeded trace (``ArrivalSpec``) cut to its first ``most``
    arrivals; fails when it has fewer than ``least``."""
    from repro_torch.workload import make_trace

    trace = make_trace(arrival.trace, rate=arrival.rate, duration_s=arrival.duration_s,
                       seed=arrival.seed)
    if trace.n < least:
        fail(f"the {arrival.trace} trace has {trace.n} arrivals, fewer than {least}")
    return dataclasses.replace(trace, arrivals=trace.arrivals[:most])


def check_once(what: str, d, reqs, shape) -> None:
    """Every request completed exactly once, none failed, each a finite CUDA
    tensor of ``shape``."""
    ids = [r.req_id for r in d.loop.completed]
    want = sorted(r.req_id for r in reqs)
    if len(set(ids)) != len(ids) or not set(want) <= set(ids) or d.loop.failed:
        fail(f"{what}: requests not completed exactly once ({len(d.loop.failed)} failed)")
    check_served(reqs, shape, what)


def serve_replicated(card: str, graph, ex) -> None:
    import torch

    from repro_torch.api import ArrivalSpec, ClusterSpec, DeploymentSpec, TraceConfig, deploy
    from repro_torch.kernels import launch_counts, reset_launch_counts

    arrival = ArrivalSpec("poisson", **POISSON)
    d = deploy(DeploymentSpec(
        model=graph, executor_for_version=ex, codec="int8", seed=3, replicas=2,
        microbatch=MICROBATCH, trace=TraceConfig(sample=1.0), arrival=arrival,
        cluster=ClusterSpec(n_nodes=12, capacity_bytes=graph.total_param_bytes / 2.5, seed=5),
        device="cuda"))
    plan, rset = d.plan, d.replicaset
    if plan.n_replicas != 2 or any("int8" not in p.codecs for p in plan.replicas):
        fail(f"replicated demo_ssm: want 2 replicas with int8 hops, got {plan.summary()}")
    say("replicas", f"demo_ssm replicas=2: groups {[list(g) for g in plan.groups]}, paths "
                    f"{[list(p.path) for p in plan.replicas]}, codecs "
                    f"{[list(p.codecs) for p in plan.replicas]}")
    trace = first_arrivals(arrival, REPLICATED_ARRIVALS, REPLICATED_ARRIVALS)
    shape = (SSM["seq"], SSM["d"])
    draw = lambda i, a: randn(shape, 1100 + i, 0.5)  # noqa: E731
    path1 = list(rset.controls[1].pipeline.path())
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = d.submit_trace(trace, draw)
    victim = drain_with_kill(d, 4, 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check_once("replicated demo_ssm", d, reqs, shape)
    kinds = [[a.kind for a in c.history] for c in rset.controls]
    if victim in rset.controls[0].pipeline.path() or "replace" not in kinds[0]:
        fail(f"NodeFailed({victim}) did not re-place replica 0: {kinds}")
    if list(rset.controls[1].pipeline.path()) != path1 or kinds[1]:
        fail(f"NodeFailed({victim}) on replica 0 moved replica 1: {kinds}")
    if {r.replica for r in d.loop.completed} != {0, 1}:
        fail("a replica completed no request")
    for name in ("ssd_chunked_cuda", "quantize_int8_cuda", "dequantize_int8_cuda"):
        if counts[name] == 0:
            fail(f"{name} was never launched by the replicated demo_ssm")
    traced = {ev["tid"] for ev in d.chrome_trace()["traceEvents"] if ev["ph"] == "X"}
    fractions = d.attribution()["fractions"]
    if not {r.req_id for r in d.loop.completed} <= traced:
        fail("a completed request has no span in the chrome trace")
    if abs(sum(fractions.values()) - 1.0) > 1e-6:
        fail(f"attribution fractions sum to {sum(fractions.values())}")
    say("replicas", f"{len(reqs)} Poisson arrivals, NodeFailed({victim}) after 4: replica 0 "
                    f"{kinds[0]}, path now {list(rset.controls[0].pipeline.path())}; replica 1 "
                    f"path {path1} unchanged; dispatched {d.loop.dispatched}; every request "
                    f"completed once, finite CUDA tensors {shape}; spans cover all, attribution "
                    f"{ {k: round(v, 4) for k, v in fractions.items()} }; launches {counts}")
    say("replicas", f"replicated demo_ssm wall time per request {wall / len(reqs) * 1e3:.2f} ms "
                    f"({len(reqs)} requests in {wall:.2f} s); virtual clock: steady-state "
                    f"{d.loop.steady_state_throughput():.4f} req/s beside the plan's predicted "
                    f"{plan.predicted_throughput:.4f} req/s (one card runs the replicas in "
                    f"turn: only the virtual clock models the cluster); {card}")

    v0 = {r.req_id: r.result for r in reqs[:2]}
    d.store.publish(1)
    if not d.poll_model_updates():
        fail("poll_model_updates() saw no new version after publish(1)")
    more = [d.submit(randn(shape, 1200 + i, 0.5)) for i in range(8)]
    d.drain()
    versions = [o.version for o in d.observed_replicas()]
    if versions != [1, 1] or d.pending:
        fail(f"the rollout did not bring every replica to version 1: {versions}")
    again = [d.submit(randn(shape, 1100 + i, 0.5)) for i in range(2)]
    d.drain()
    check_once("demo_ssm during and after the rollout", d, reqs + more + again, shape)
    diffs = [(r.result - v0[reqs[i].req_id]).abs().max().item() for i, r in enumerate(again)]
    if not all(x > 1e-3 for x in diffs):
        fail(f"version 1 served version 0's outputs: max-abs differences {diffs}")
    rollout = [(r.detail["replica"], r.detail["phase"]) for r in d.journal.records
               if r.kind == "rollout"]
    say("replicas", f"version 1 rolled out {rollout}: replicas at {versions}; 8 requests "
                    f"served through the rollout, 2 repeated inputs differ from version 0 by "
                    f"{', '.join(f'{x:.3g}' for x in diffs)} max-abs")
    del d, reqs, more, again, v0
    release()


def serve_autoscaled(card: str, graph, ex) -> None:
    import torch

    from repro_torch.api import ArrivalSpec, AutoscaleSpec, ClusterSpec, DeploymentSpec, deploy
    from repro_torch.kernels import launch_counts, reset_launch_counts

    arrival = ArrivalSpec("bursty", **BURSTY)
    d = deploy(DeploymentSpec(
        model=graph, executor_for_version=ex, codec="int8", seed=3, microbatch=MICROBATCH,
        arrival=arrival, autoscale=AutoscaleSpec(min_replicas=1, max_replicas=2,
                                                 backlog_high=6.0, backlog_low=1.0),
        cluster=ClusterSpec(n_nodes=12, capacity_bytes=graph.total_param_bytes / 2.5, seed=5),
        device="cuda"))
    trace = first_arrivals(arrival, *AUTOSCALED_ARRIVALS)
    shape = (SSM["seq"], SSM["d"])
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = d.submit_trace(trace, lambda i, a: randn(shape, 1400 + i, 0.5))
    d.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check_once("autoscaled demo_ssm", d, reqs, shape)
    events = [e.summary() for e in d.autoscaler.events]
    if not any(e["action"] == "grow" for e in events):
        fail(f"the autoscaler recorded no grow under the bursty trace: {events}")
    for name in ("ssd_chunked_cuda", "quantize_int8_cuda", "dequantize_int8_cuda"):
        if counts[name] == 0:
            fail(f"{name} was never launched by the autoscaled demo_ssm")
    say("replicas", f"autoscaled demo_ssm, {len(reqs)} bursty arrivals: scale events "
                    f"{[(e['action'], e['replica'], round(e['t_s'], 2)) for e in events]}, "
                    f"{len(d.loop.loops)} replicas, every request completed once; launches "
                    f"{counts}")
    say("replicas", f"autoscaled demo_ssm wall time per request {wall / len(reqs) * 1e3:.2f} ms; "
                    f"virtual clock: steady-state {d.loop.steady_state_throughput():.4f} req/s "
                    f"(one card runs the replicas in turn); {card}")
    del d, reqs
    release()


def serve_sync(card: str) -> None:
    """demo_transformer through the synchronous loop and the pipelined
    engine from one spec: the same plan, the same outputs bit for bit."""
    import torch

    from repro_torch.api import ClusterSpec, DeploymentSpec, deploy
    from repro_torch.core.model_zoo import demo_transformer
    from repro_torch.kernels import launch_counts, reset_launch_counts

    graph, ex = demo_transformer(**SERVED, device="cuda")
    shape = (SERVED["seq"], SERVED["d"])
    xs = [randn(shape, 1300 + i, 0.5) for i in range(MICROBATCH)]
    runs = {}
    for serving in ("sync", "pipelined"):
        d = deploy(DeploymentSpec(
            model=graph, executor_for_version=ex, codec="int8", seed=3, serving=serving,
            microbatch=MICROBATCH, device="cuda",
            cluster=ClusterSpec(n_nodes=6, capacity_bytes=graph.total_param_bytes / 2.5, seed=5)))
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [d.submit(x) for x in xs]
        d.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        check_once(f"demo_transformer serving={serving!r}", d, reqs, shape)
        runs[serving] = (d.plan.summary(), [r.result for r in reqs], d.loop.metrics(), wall)
        say("replicas", f"demo_transformer serving={serving!r} ({type(d.loop).__name__}): "
                        f"{len(reqs)} requests, wall time per request "
                        f"{wall / len(reqs) * 1e3:.1f} ms; virtual clock "
                        f"{d.loop.clock_s:.3f} s; launches {counts}; {card}")
        if serving == "sync":
            for name in ("quantize_int8_cuda", "dequant_matmul_cuda", "flash_attention_cuda"):
                if counts[name] == 0:
                    fail(f"{name} was never launched by the sync demo_transformer")
        del d, reqs
    (plan, outs, _, _), (pplan, pouts, _, _) = runs["sync"], runs["pipelined"]
    if plan != pplan:
        fail("sync and pipelined deploys of one spec planned differently")
    if not all(torch.equal(a, b) for a, b in zip(outs, pouts)):
        worst = max((a - b).abs().max().item() for a, b in zip(outs, pouts))
        fail(f"sync and pipelined outputs differ (max-abs {worst:.3g})")
    say("replicas", f"demo_transformer sync and pipelined: the same plan {plan['path']}, "
                    f"outputs torch.equal for all {len(outs)} requests")
    del runs, outs, pouts, xs
    release()


def phase_replicas(card: str) -> None:
    from repro_torch.core.model_zoo import demo_ssm

    # the sync demo_transformer first: phase 10's first timing (quantize) ran
    # 10% slow for ~30 ms right after its GEMMs (the card's clocks recovering)
    serve_sync(card)
    graph, ex = demo_ssm(**SSM, device="cuda", params_for_version=ssm_params)
    serve_replicated(card, graph, ex)
    serve_autoscaled(card, graph, ex)


def flex_attention_yardstick(q, k, v, window: int, softcap: float):
    """FlexAttention under ``torch.compile`` on (B, H, S, hd) copies of q, k,
    v: the softcap as ``score_mod``, causal (and the window) as a
    ``block_mask``, GQA by ``enable_gqa``.  Returns the compiled call."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    def score_mod(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    def mask_mod(b, h, q_idx, kv_idx):
        ok = q_idx >= kv_idx
        return ok & (q_idx - kv_idx < window) if window > 0 else ok

    s = q.shape[1]
    block_mask = create_block_mask(mask_mod, B=None, H=None, Q_LEN=s, KV_LEN=s, device="cuda")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    fn = torch.compile(flex_attention, dynamic=False)
    return lambda: fn(qt, kt, vt, score_mod=score_mod, block_mask=block_mask, enable_gqa=True)


def phase_times(card: str, launches: dict, errors: dict) -> list[dict]:
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.quantize.kernel import (
        dequant_matmul_cuda,
        dequantize_int8_cuda,
        dequantize_path,
        quantize_int8_cuda,
    )
    from repro_torch.kernels.quantize.ref import dequant_matmul_ref, dequantize_ref, quantize_ref
    from repro_torch.kernels.ssm_scan.kernel import (
        KERNEL_CHUNK,
        default_segments,
        ssd_chunked_cuda,
    )
    from repro_torch.kernels.ssm_scan.ref import ssd_ref

    d, s, n = SERVED["d"], SERVED["seq"], MICROBATCH
    heads, kvh = SERVED["heads"], SERVED["kv_heads"]
    hd = d // heads
    proj = (heads + 2 * kvh) * hd
    rows = []

    def row(name, source, replaces, kernel, plain, reps, nbytes, flops, s_per_flop, shape,
            library=None, **extra):
        ms = cuda_time_ms(kernel, reps)
        plain_ms = cuda_time_ms(plain, max(1, reps // 2))
        b_ms, b_by, fma_ms = bound_ms(nbytes, flops, s_per_flop)
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": errors[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library, "bound_f32_fma_ms": fma_ms, **extra})
        lib = "none" if library is None else f"{library:.4f} ms"
        say("times", f"{name} {shape}: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                     f"{b_ms / ms:.1%} of it; f32 FMA bound {fma_ms:.4f} ms), plain "
                     f"{plain_ms:.4f} ms, library {lib}; {card}")

    x = randn((n, s, d), 11)
    q, sc = quantize_int8_cuda(x, 256)
    nb = sc.shape[-1]
    row("quantize_int8", "src/repro_torch/kernels/csrc/quantize.cu",
        "src/repro/kernels/quantize/kernel.py:47",
        lambda: quantize_int8_cuda(x, 256), lambda: quantize_ref(x, 256), 50,
        x.numel() * 4 + x.numel() + sc.numel() * 4, 5 * x.numel(), 0, tuple(x.shape))

    qs, ss = quantize_int8_cuda(randn((n, SSM["seq"], SSM["d"]), 12), 256)  # demo_ssm's hop
    row("dequantize_int8", "src/repro_torch/kernels/csrc/quantize.cu",
        "src/repro/kernels/quantize/kernel.py:84",
        lambda: dequantize_int8_cuda(qs, ss, torch.float32, 256),
        lambda: dequantize_ref(qs, ss, torch.float32, 256), 50,
        qs.numel() * 5 + ss.numel() * 4, qs.numel(), 0, tuple(qs.shape))
    # the scalar path, the kernel as it was before the vector path, takes the
    # same codes at an odd byte offset
    qu = torch.empty(qs.numel() + 1, dtype=torch.int8, device="cuda")[1:].view(qs.shape)
    qu.copy_(qs)
    if (dequantize_path(qu, 256), dequantize_path(qs, 256)) != ("scalar", "vector"):
        fail("dequantize_int8: the offset codes do not take the scalar path")
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        best = best_interleaved_ms([
            lambda c=c, t=dtype: dequantize_int8_cuda(c, ss, t, 256) for c in (qu, qs, qs, qu)],
            3, launches=20)
        b_ms = bound_ms(qs.numel() * (1 + size) + ss.numel() * 4, qs.numel())[0]
        old_ms, new_ms = min(best[0], best[3]), min(best[1], best[2])
        say("times", f"dequantize_int8 {tuple(qs.shape)} -> {str(dtype)[6:]}, scalar (old) vs "
                     f"vector path, interleaved best of 3 turns of 20 launches (scalar, vector, "
                     f"vector, scalar): "
                     + " / ".join(f"{t:.4f}" for t in best) + f" ms; bound {b_ms:.4f} ms, "
                     f"{b_ms / old_ms:.1%} / {b_ms / new_ms:.1%} of it; {card}")
    del qs, qu, ss
    qm, sm = quantize_int8_cuda(randn((n, d), 12), 256)  # demo_mlp's hop payload
    small = cuda_time_ms(lambda: dequantize_int8_cuda(qm, sm, torch.float32, 256), 200)
    b_ms, b_by, _ = bound_ms(qm.numel() * 5 + sm.numel() * 4, qm.numel())
    say("times", f"dequantize_int8 {tuple(qm.shape)} (demo_mlp's hop, {dequantize_path(qm, 256)} "
                 f"path): {small:.4f} ms, bound {b_ms:.5f} ms ({b_by}); {card}")

    w = randn((d, proj), 13, 0.3)
    rows_n = n * s
    fused = lambda: dequant_matmul_cuda(q, sc, w, torch.float32, 256)  # noqa: E731
    unfused = lambda: torch.matmul(dequantize_int8_cuda(q, sc, torch.float32, 256), w)  # noqa: E731
    fused_best, unfused_best = best_interleaved_ms([fused, unfused], 5)
    dq_bytes = q.numel() + sc.numel() * 4 + w.numel() * 4 + rows_n * proj * 4
    dq_flops = 2 * rows_n * d * proj + rows_n * d
    tf32_ms = bound_ms(dq_bytes, dq_flops, TF32_CODE_S_PER_FLOP)[0]
    row("dequant_matmul", "src/repro_torch/kernels/csrc/quantize.cu",
        "src/repro/kernels/quantize/kernel.py:122", fused,
        lambda: dequant_matmul_ref(q, sc, w, torch.float32, 256), 5, dq_bytes, dq_flops,
        CODE_PRODUCT_S_PER_FLOP, (rows_n, d, proj), unfused_ms=unfused_best,
        bound_split_tf32_ms=tf32_ms)
    say("times", f"dequant_matmul at its own route (2 split-TF32 passes): bound {tf32_ms:.4f} "
                 f"ms, {tf32_ms / rows[-1]['ms']:.1%} of it; {card}")
    say("times", f"dequant_matmul fused vs unfused (dequantize kernel + torch.matmul), "
                 f"interleaved best of 5: {fused_best:.4f} / {unfused_best:.4f} ms, ratio "
                 f"{fused_best / unfused_best:.3f}; {card}")
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
    for name, window, label in (("flash_attention_fwd", 0, "global causal, softcap"),
                                ("flash_attention_fwd_window", SERVED["window"],
                                 f"causal, window {SERVED['window']}, softcap")):
        kernel = lambda w=window: flash_attention_cuda(  # noqa: E731
            fq, fk, fv, causal=True, window=w, softcap=softcap)
        library, flex = None, None
        t0 = time.perf_counter()
        try:  # a yardstick only: its failure is reported, never timed
            flex = flex_attention_yardstick(fq, fk, fv, window, softcap)
            flex_out = flex().transpose(1, 2)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001
            flex = None
            say("times", f"{name}: FlexAttention yardstick FAILED ({type(e).__name__}: "
                         f"{str(e)[:300]}); library_ms null")
        if flex is not None:
            diff = (flex_out - kernel()).abs().max().item()
            library = cuda_time_ms(flex, 3)
            say("times", f"{name}: FlexAttention compiled and run in "
                         f"{time.perf_counter() - t0:.1f} s, max-abs {diff:.3g} from the kernel")
            del flex, flex_out
            torch.cuda.empty_cache()
        row(name, "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:96", kernel, plain(window), 3,
            io_bytes, 4 * hd * live_pairs(window) * n * heads, F32_PRODUCT_S_PER_FLOP,
            (n, s, heads, kvh, hd, label), library=library)
    del qkv, fq, fk, fv
    torch.cuda.empty_cache()

    h, dh, ns, sq = SSM["heads"], SSM["d"] // SSM["heads"], SSM["state"], SSM["seq"]
    args = ssd_case(n, sq, h, dh, ns, 21)
    q = KERNEL_CHUNK
    nbytes = (sum(t.numel() for t in args) + args[0].numel()) * 4  # inputs once, y once
    # the bound counts the fewest operations of any chunking of the same scan
    q_min = min((2 ** k for k in range(sq.bit_length())),
                key=lambda c: ssd_flops(n, sq, h, dh, ns, c))
    p = default_segments(n, sq, h, args[0].device)
    row("ssd_chunked", "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssm_scan/kernel.py:66",
        lambda: ssd_chunked_cuda(*args, chunk=sq), lambda: ssd_ref(*args, chunk=q), 10,
        nbytes, ssd_flops(n, sq, h, dh, ns, q_min), F32_PRODUCT_S_PER_FLOP,
        (n, sq, h, dh, ns, f"kernel and plain at Q={q}, bound at Q={q_min}"),
        segments=p)
    flops_q = ssd_flops(n, sq, h, dh, ns, q)
    b_ms, b_by, fma_ms = bound_ms(nbytes, flops_q, F32_PRODUCT_S_PER_FLOP)
    say("times", f"ssd_chunked at this design's Q={q}: {flops_q / 1e9:.2f} GFLOP, bound "
                 f"{b_ms:.4f} ms ({b_by}, {b_ms / rows[-1]['ms']:.1%} of it; f32 FMA bound "
                 f"{fma_ms:.4f} ms), against {ssd_flops(n, sq, h, dh, ns, q_min) / 1e9:.2f} "
                 f"GFLOP at Q={q_min}; {card}")
    d_flops = ssd_design_flops(n, sq, h, dh, ns, q, p)
    d_bytes = ssd_design_bytes(n, sq, h, dh, ns, q, p)
    d_ms = bound_ms(d_bytes, d_flops, F32_PRODUCT_S_PER_FLOP)[0]
    say("times", f"ssd_chunked as this design does it, P={p} segments a sequence "
                 f"({n * h * p} blocks): {d_flops / 1e9:.2f} GFLOP (the end-state pass and "
                 f"the folds counted), {d_bytes / 1e9:.3f} GB (xs, bm, dt read again for all "
                 f"but the last segment, the end states written and folded), bound "
                 f"{d_ms:.4f} ms; {card}")
    by_p = best_interleaved_ms([lambda: ssd_chunked_cuda(*args, chunk=sq, segments=1),
                                lambda: ssd_chunked_cuda(*args, chunk=sq, segments=p)], 3)
    say("times", f"ssd_chunked unsegmented (P=1, {n * h} blocks) vs P={p}, interleaved best "
                 f"of 3: {by_p[0]:.4f} / {by_p[1]:.4f} ms; {card}")
    return rows


def ssd_flops(b: int, s: int, h: int, dh: int, n: int, q: int) -> int:
    """FLOPs of the chunked scan at chunk q: C B^T and scores @ x over each
    chunk's lower triangle, C state^T and x^T (B decay) in full, and the
    state's decay once per chunk."""
    per_head = 0
    for t0 in range(0, s, q):
        r = min(q, s - t0)
        per_head += r * (r + 1) * (n + dh) + 4 * r * n * dh + n * dh
    return b * h * per_head


def _segments(s: int, q: int, p: int) -> list[list[int]]:
    """Row counts of the chunks of each of the p segments (ref.segment_starts)."""
    rows = [min(q, s - t0) for t0 in range(0, s, q)]
    nc = len(rows)
    return [rows[i * nc // p:(i + 1) * nc // p] for i in range(p)]


def ssd_design_flops(b: int, s: int, h: int, dh: int, n: int, q: int, p: int) -> int:
    """FLOPs of the segmented kernels: every chunk in full but the state
    update after each segment's last chunk, the state pass of every segment
    but the last, and the folds (segment i folds i end states)."""
    update = lambda r: 2 * r * n * dh + n * dh  # noqa: E731
    per_head = 0
    for i, seg in enumerate(_segments(s, q, p)):
        per_head += ssd_flops(1, sum(seg), 1, dh, n, q) - update(seg[-1])  # seg is whole chunks
        if i + 1 < p:
            per_head += sum(update(r) for r in seg)
        per_head += 2 * i * n * dh
    return b * h * per_head


def ssd_design_bytes(b: int, s: int, h: int, dh: int, n: int, q: int, p: int) -> int:
    """Bytes the segmented kernels move: the inputs once and y once, xs, bm
    and dt again for the state pass, the end states (64 x 64 f32 each)
    written once and read by every later segment's fold."""
    once = (b * s * h * dh * 2 + b * s * n * 2 + b * s * h + h) * 4
    again = sum(sum(seg) for seg in _segments(s, q, p)[:-1]) * b * (h * dh + n + h) * 4
    states = b * h * (p - 1) * (64 * 64 + 1) * 4
    folds = b * h * p * (p - 1) // 2 * (64 * 64 + 1) * 4
    return once + again + states + folds


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
    errors["ssd_chunked"] = phase_parity_ssd()
    counts_tf, per_request = phase_serve_transformer()
    phase_serve_mlp()
    counts_ssm, per_request_ssm = phase_serve_ssm()
    phase_serve_tenants()
    phase_reference()
    phase_replicas(card)
    launches = {
        "quantize_int8": counts_tf["quantize_int8_cuda"],
        "dequant_matmul": counts_tf["dequant_matmul_cuda"],
        "flash_attention_fwd": (counts_tf["flash_attention_cuda"]
                                - counts_tf["flash_attention_cuda_windowed"]),
        "flash_attention_fwd_window": counts_tf["flash_attention_cuda_windowed"],
        "dequantize_int8": counts_ssm["dequantize_int8_cuda"],
        "ssd_chunked": counts_ssm["ssd_chunked_cuda"],
    }
    rows = phase_times(card, launches, errors)
    if "--profile" in sys.argv[1:]:
        phase_accuracy(card)
        phase_mma_peak(card)
    for what, times in (("demo_transformer", per_request), ("demo_ssm", per_request_ssm)):
        say("serve", f"wall time per served request ({what}, 4 per microbatch): "
                     + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in times.items()))
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
