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
8b. lm -- the LM zoo (``repro_torch.models.lm``, ``runtime.serve``).  First
   small-width gemma2- and zamba2-shaped models (``reduced()`` at d=512 with
   hd 128: 2 layers; at d=320 with hd 80: 12 Mamba2 layers, 6 shared-block
   applications; S=2048, so ``attend`` takes the flash
   op) on the card and on the CPU with the same weights and tokens, in f32
   (within 1e-4 of max|ref|) and bf16 (3e-2), the CPU tests' tolerances.
   Then each model whole at its published widths in bf16, weights drawn on
   the card: gemma2-27b (46 layers, 54.45 GB) prefilling B=2 prompts of
   S=8192 through ``make_prefill_step``, then 32 greedy steps through
   ``make_serve_step`` with caches of 8192; zamba2-2.7b (54 Mamba2 layers
   and the shared block) at B=4 x 8192, the same way.  A prefill must
   launch flash 46 times (23 windowed) for gemma2, flash 9 and the SSD scan
   54 times for zamba2, and decode neither; every logit finite.  Prints the
   prefill's wall time and tokens/s, ms a decode step, peak device memory
   and the launches; then one launch of each flash variant and one SSD
   launch on the inputs the prefill gave them, against the plain versions.
   ``--profile`` adds a prefill and a decode step under ``torch.profiler``:
   device time by kernel, the idle share, the flash kernel's and the SSD
   scan's shares.
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
   calls: for flash attention (global and windowed layers, each a row, at
   demo_transformer's shape, at gemma2-27b's B=2 and at zamba2-2.7b's hd 80) the
   one PyTorch call that computes it, FlexAttention under ``torch.compile``
   with the softcap as ``score_mod`` and the masks as a ``block_mask``
   (``library_ms``); for dequant_matmul the dequantize kernel followed by
   ``torch.matmul`` (``unfused_ms``, interleaved best-of with the fused
   kernel, and their ratio).  A yardstick that fails prints as such and
   gives null.  The bound is the larger of bytes / 3.35 TB/s and FLOPs at
   the cheapest tensor-core route of an f32-accurate product: 3 TF32 passes
   (495 TFLOP/s) under split-TF32, or 2 bf16 passes (989 TFLOP/s) where one
   operand is an exact int8 code and the other two bf16 pieces; the f32 FMA bound
   is printed beside it (the JSON rows hold only ``bound_ms`` and what was measured).  dequantize is timed at
   demo_ssm's hop, and its scalar path (the kernel before the vector path,
   on the same codes at an odd byte offset) against its vector path there,
   interleaved turns of 20 launches, in f32 and bf16; the SSD scan's bound
   counts the fewest operations of any chunking, and the kernel's own Q=64
   count is printed beside it, with
   its segments P, the FLOPs and bytes of the segmented design (state pass
   and folds counted) and its time unsegmented (P=1) against P.
11. train -- the training path (``runtime.train``, ``lm.loss_fn`` with
   every layer group rematerialized, the flash backward kernel,
   ``runtime.checkpoint``), run before phase 10 (its times come after
   phase 10's rows).  (a) The backward kernel against
   ``flash_backward_ref`` at S=2048 (and a ragged S=1999, and S=1) for each
   head dim 64-256, causal G=1, window 512 with softcap 50 at G=2,
   bidirectional G=4, causal G=8, a window of 5 (below one kv tile): the
   forward's o and logsumexp (``lse=True``) within 2e-5 of max|plain|
   against ``attention_ref_lse``, then dq, dk, dv within 2e-5 of max|plain|
   (at S=1, where dq and dk are 0 in exact math, of max|dv|) against
   ``flash_backward_ref`` fed the PLAIN o and lse, so the whole gradient is
   held to an independent reference; two runs equal, and the first case run
   again after all the others (of other shapes) equal to its first run.
   (b) llama3.2-1b whole (16 layers, d=2048, 32/8 heads of 64, vocab
   128256, tied embeddings: 1.236 B params), bf16 params and f32 moments,
   at train_4k's S=4096 with its global batch of 256 cut to 16, as 2
   microbatches of 8; 3 AdamW steps (lr 1e-3, warmup 1) on one repeated
   batch of the bigram stream of ``examples/train_lm.py``: every loss
   finite and the last below the first, 64 flash forward and 32 backward
   launches a step.  (c) gemma2-27b at full width, depth cut to one local
   and one global layer (2.31 B params), B=1 x S=8192 (its 4096 window
   masks), 2 steps: 4 forward (2 windowed) and 2 backward launches a step.
   Each prints its losses, seconds a step, tokens/s and peak memory; the
   backward's inputs of the first step of each (b)/(c) variant are kept,
   and their o and lse, then one backward launch on them, are held to the
   plain versions as in (a), one (batch, kv-head group) at a time.
   (d) llama3.2-1b at full width cut to 2 layers, under
   ``torch.use_deterministic_algorithms``: a step, a checkpoint, two steps;
   then restore and the same two steps: every leaf ``torch.equal``.  It
   runs in a child process (``chip_smoke.py --resume-check``) started with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, which deterministic cuBLAS needs,
   so every other phase keeps cuBLAS's default workspace.  (f) The SSD
   scan's backward kernel (``csrc/ssd_scan_bwd.cu``) against
   ``ssd_backward_ref`` chunked as the kernel chunks (64, padded) over a
   sweep (ragged S, dh and N below 64, dt / 100, strong decay, zamba2's
   training microbatch): dxs, dbm, dcm, ddt and da each within 5e-6 of
   max|plain| in f32, two runs equal; the kernel's and the f32 plain
   version's errors against an f64 plain run printed beside.  (g)
   zamba2-2.7b whole (54 Mamba2 layers, d=2560, 80 heads of 64, N=64; the
   shared block, 32/32 heads of 80, every 6 layers; 2.34 B params), bf16
   params and f32 moments, train_4k's S=4096 with its global batch of 256
   cut to 8, as 2 microbatches of 4; 3 AdamW steps as in (b): every loss
   finite and the last below the first; flash forward 36 and backward 18
   launches a step, the SSD scan forward 216 and backward 108.  One SSD
   backward launch on the first step's own inputs is held to the plain
   version as in (f), and one flash backward at hd 80 as in (b).  Before
   the resume check.  (e) After phase 10: the flash backward kernel timed
   on (b)'s, (c)'s and (g)'s own inputs beside its bound (10 hd FLOPs a
   live pair at 3 TF32 passes; the design's 14 hd beside it), its plain
   version per kv-head group summed, and one library call's backward
   ((forward + backward) - forward): ``scaled_dot_product_attention``
   (``enable_gqa``, held to the kernel's gradients; per batch row, summed,
   where one call does not fit the card) on every row without a softcap or
   window, FlexAttention under ``torch.compile`` on the rows with one
   (gemma2's); the SSD backward
   (``ssd_chunked_bwd``) on (g)'s own inputs beside its bound (xs, dy, dxs
   and the small tensors once; the fewest product FLOPs of any chunking at
   3 TF32 passes), the bytes and FLOPs of its own design (whole state
   walks, head groups, split-TF32), and its plain
   version (no PyTorch call computes it: library none).  (h)-(l) One arch
   of each remaining family at its published widths, bf16 params, moments
   and gradient accumulation in its ``opt_state_dtype``, every group
   rematerialized, on one repeated batch as in (b): phi3.5-moe-42b-a6.6b
   cut to 2 of 32 layers (16 experts top-2, hd 128), kimi-k2-1t-a32b cut to
   2 of 61 layers and 32 of 384 experts (top-8, hd 112, bf16 state) and
   pixtral-12b cut to 8 of 40 layers (hd 160, patches (B, 256, 1024)), each
   B=8 x 4096 as 2 microbatches of 4; whisper-small whole (12 + 12 layers,
   frames (B, 4096, 768): non-causal encoder and cross attention, causal
   decoder) at B=16 x 4096; xlstm-125m whole (none of the port's kernels)
   at B=16 and ``TRAIN_XLSTM``'s S.  Every loss finite and the last below
   the first, the launches checked every step (flash also by causal or
   not); the flash backward on each step's own inputs held as in (b), and
   timed in (e) at hd 128, 112, 160 and non-causal hd 64.  (m) ``python -m
   repro_torch.launch.train`` on whisper-small whole, B=4 x 4096: 3 steps
   with a checkpoint at 2, then the same command to 4 steps, which must
   print the JAX CLI's resume line; every loss finite.  ``--profile``
   adds one more step of each model that runs the port's kernels under
   ``torch.profiler``.

The last three lines are a JSON object of the kernels, the card's name and
power limit, and the device line.
Weights and requests are random, drawn from fixed seeds.

``python3 chip_smoke.py --profile`` also serves one more demo_transformer
and one more demo_ssm microbatch under ``torch.profiler`` and prints the
device time by kernel and the device's idle share over each serve; then the
error budget of the split-precision kernels (each against its plain
version, an f64 run and the model of its arithmetic in
``repro_torch.kernels.split_precision``, whose difference from the kernel is
the tensor cores' own accumulation; flash forward and backward (at hd 128,
160 and 64), dequant_matmul and the SSD scan at its served shape) and a
probe of ``mma.sync`` TF32
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
# phase 11(d) runs in a child process with this flag, under deterministic cuBLAS
RESUME_FLAG = "--resume-check"

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

    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda,
        flash_attention_cuda,
    )
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref,
        attention_ref_lse,
        flash_backward_ref,
    )
    from repro_torch.kernels.quantize.kernel import dequant_matmul_cuda
    from repro_torch.kernels.quantize.ref import dequant_matmul_ref, quantize_ref
    from repro_torch.kernels.split_precision import (
        attention_emulated,
        dequant_matmul_emulated,
        flash_backward_emulated,
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
    # the backward, each gradient against max|plain|: dq, dk, dv
    for case, (hd, std, softcap) in enumerate(((128, 1.0, 0.0), (160, 1.0, 50.0), (64, 5.0, 50.0))):
        q, k, v, do = (randn((1, 2048, 4 if i in (0, 3) else 1, hd), 50 + 4 * case + i, std)
                       for i in range(4))
        kw = dict(causal=True, window=0, softcap=softcap)
        o, lse = attention_ref_lse(q, k, v, **kw)
        out = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        plain = flash_backward_ref(q, k, v, o, lse, do, **kw)
        model = flash_backward_emulated(q, k, v, o, lse, do, **kw)
        exact = [t.double() for t in (q, k, v)]
        o64, lse64 = attention_ref_lse(*exact, **kw)
        exact = flash_backward_ref(*exact, o64, lse64, do.double(), **kw)  # f64 throughout
        rel = lambda a, b, w: ", ".join(  # noqa: E731
            f"{diff(x, y) / z.abs().max().item():.3g}" for x, y, z in zip(a, b, w))
        say("accuracy", f"flash backward (1, 2048, 4/1, {hd}) std {std}, causal, softcap {softcap}, "
                        f"dq, dk, dv of max|plain|: kernel vs plain {rel(out, plain, plain)}; model "
                        f"vs plain {rel(model, plain, plain)}; kernel vs model "
                        f"{rel(out, model, plain)}; vs f64: kernel {rel(out, exact, plain)}, plain "
                        f"{rel(plain, exact, plain)}, model {rel(model, exact, plain)}; {card}")
        del q, k, v, do, o, lse, out, plain, model, exact, o64, lse64
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
    say("build", f"{_build.BUILD / _build.LIB_NAME} in {time.perf_counter() - t0:.1f} s; nvcc "
                 "per source, in parallel: " + ", ".join(
                     f"{k} {v:.1f} s" for k, v in sorted(_build.build_seconds.items())))
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


# phase 8b: the LM zoo's prefill and decode steps at full width, bf16
LM_MODELS = (
    # gemma2-27b whole (46 layers, 54.45 GB of bf16 weights); B=2 is the cut
    dict(arch="gemma2-27b", batch=2, seq=8192, seed=31),
    # zamba2-2.7b whole: its Mamba2 tower at the SSD kernel's served shape
    dict(arch="zamba2-2.7b", batch=4, seq=8192, seed=32),
)
LM_DECODE_STEPS = 32
# launches a prefill: flash (all), flash with a window, the SSD scan
LM_LAUNCHES = {"gemma2-27b": (46, 23, 0), "zamba2-2.7b": (9, 0, 54)}
# the CPU tests' tolerances (tests/_lm_parity.py), of max|ref|
TOL_LM = {"float32": 1e-4, "bfloat16": 3e-2}
# small widths whose head dims the served models use: 128 (gemma2), 80 (zamba2)
LM_SMALL = (("gemma2-27b", 512), ("zamba2-2.7b", 320))
LM_SMALL_SEQ = 2048  # where attend takes the flash op


def lm_card_vs_cpu(arch: str, d_model: int) -> None:
    """A small-width model of ``arch`` (``reduced()`` depth) through
    ``forward_hidden`` and the prefill step on the card and on the CPU (the
    plain versions, which the CPU tests hold to the JAX package) with the
    same weights and tokens, in f32 and in bf16."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    from repro_torch.runtime.serve import make_prefill_step

    cfg = reduced(get_config(arch), d_model=d_model, vocab=1024)
    base = lm.init_params(cfg, torch.Generator().manual_seed(7), device="cpu",
                          max_pos=LM_SMALL_SEQ)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (1, LM_SMALL_SEQ))
    for dtype in (torch.float32, torch.bfloat16):
        params = tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, base) \
            if dtype == torch.float32 else base
        out = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), params)
            batch = {"tokens": torch.as_tensor(tokens, device=dev)}
            reset_launch_counts()
            with torch.inference_mode():
                hidden, _ = lm.forward_hidden(cfg, p, batch)
            logits = make_prefill_step(cfg)(p, batch)
            out[dev] = (hidden.float().cpu(), logits.cpu())
            counts = launch_counts()
        tol = TOL_LM[str(dtype)[6:]]
        errs = [float((c - r).abs().max() / r.abs().max())
                for c, r in zip(out["cuda"], out["cpu"])]
        flash, ssd = counts["flash_attention_cuda"], counts["ssd_chunked_cuda"]
        if flash == 0 or (cfg.family == "hybrid" and ssd == 0):
            fail(f"small {arch}: the card's run launched flash {flash}, SSD {ssd} times")
        if not max(errs) <= tol:
            fail(f"small {arch} {dtype}: card vs CPU hidden {errs[0]:.3g}, logits {errs[1]:.3g} "
                 f"of max|ref| > {tol}")
        say("lm", f"small {arch} (d={cfg.d_model}, {cfg.n_layers} layers, hd {cfg.head_dim}, "
                  f"S={LM_SMALL_SEQ}) {str(dtype)[6:]}: card vs CPU hidden {errs[0]:.3g}, prefill "
                  f"logits {errs[1]:.3g} of max|ref| (pin {tol}); card launches flash {flash}, "
                  f"SSD {ssd}")


class capture_first:
    """Wrap ``module.name`` so that its first call of each ``key(kwargs)``
    keeps a copy of its tensor arguments (the inputs a kernel took on the
    served path; nothing when ``keep`` is false) and every call is counted
    by key in ``counts``; restored on exit."""

    def __init__(self, module, name: str, key, keep: bool = True):
        self.module, self.name, self.key, self.keep = module, name, key, keep
        self.calls, self.counts = {}, {}

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapper(*args, **kw):
            k = self.key(kw)
            self.counts[k] = self.counts.get(k, 0) + 1
            if self.keep and k not in self.calls:
                self.calls[k] = (tuple(a.clone() for a in args), kw)
            return self.orig(*args, **kw)

        setattr(self.module, self.name, wrapper)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def lm_kernel_parity(arch: str, flash_calls: dict, ssd_calls: dict) -> dict:
    """One launch of each flash variant and one of the SSD scan on the
    inputs the served prefill gave them, against the plain versions (flash
    one kv-head group at a time, as phase 10 does)."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssm_scan.kernel import (
        KERNEL_CHUNK,
        default_segments,
        ssd_chunked_cuda,
    )
    from repro_torch.kernels.ssm_scan.ref import ssd_ref_segmented

    errs = {}
    for window, ((q, k, v), kw) in sorted(flash_calls.items()):
        q, k, v = q.float(), k.float(), v.float()
        o = flash_attention_cuda(q, k, v, **kw)
        kh = k.shape[2]
        g = q.shape[2] // kh
        worst = 0.0
        for j in range(kh):
            ref = attention_ref(q[:, :, j * g:(j + 1) * g], k[:, :, j:j + 1], v[:, :, j:j + 1], **kw)
            worst = max(worst, (o[:, :, j * g:(j + 1) * g] - ref).abs().max().item())
            del ref
        if not worst <= TOL_FLASH:
            fail(f"{arch} flash {tuple(q.shape)} {kw} on its served inputs: max-abs "
                 f"{worst:.3g} > {TOL_FLASH}")
        errs["window" if window else "global"] = worst
        say("lm", f"{arch} flash_attention {tuple(q.shape)} kv heads {kh} {kw}, the prefill's "
                  f"own inputs: max-abs {worst:.3g} from the plain version (pin {TOL_FLASH})")
        del q, k, v, o
    for (args, kw) in ssd_calls.values():
        b, s, h = args[0].shape[:3]
        p = default_segments(b, s, h, args[0].device)
        out = ssd_chunked_cuda(*args, **kw)
        ref = ssd_ref_segmented(*args, chunk=KERNEL_CHUNK, segments=min(p, -(-s // KERNEL_CHUNK)))
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        if not (rel <= TOL_SSD and bool(torch.isfinite(out).all())):
            fail(f"{arch} ssd_chunked {tuple(args[0].shape)} on its served inputs: {rel:.3g} of "
                 f"max|plain| > {TOL_SSD}")
        errs["ssd"] = (out - ref).abs().max().item()
        say("lm", f"{arch} ssd_chunked xs {tuple(args[0].shape)} N={args[1].shape[-1]} P={p}, the "
                  f"prefill's own inputs: {rel:.3g} of max|plain| (pin {TOL_SSD})")
        del out, ref
    torch.cuda.empty_cache()
    return errs


def profile_lm(what: str, step) -> None:
    """``step()`` under torch.profiler: device time by kernel, the idle
    share, the flash kernel's and the SSD scan's shares."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        fail("the profiler saw no device time")
    share = {what: sum(e.self_device_time_total for e in kernels if tag in e.key) / 1e3
             for what, tag in (("flash", "flash_fwd_kernel"), ("flash_bwd", "flash_bwd_"),
                               ("ssd", "ssd_"))}
    say("profile", f"{what}: {wall_ms:.1f} ms wall, {busy_ms:.1f} ms device busy, "
                   f"idle share {max(0.0, 1 - busy_ms / wall_ms):.1%}; flash kernel "
                   f"{share['flash']:.1f} ms ({share['flash'] / busy_ms:.1%}), flash backward "
                   f"kernels {share['flash_bwd']:.1f} ms ({share['flash_bwd'] / busy_ms:.1%}), "
                   f"SSD scan {share['ssd']:.1f} ms ({share['ssd'] / busy_ms:.1%})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        say("profile", f"{ms:10.2f} ms {ms / busy_ms:6.1%} x{e.count:<4d} {e.key[:110]}")


def serve_lm(card: str, arch: str, batch: int, seq: int, seed: int) -> dict:
    """``arch`` whole at its published widths in bf16, weights drawn on the
    card from ``seed``: one prefill of ``batch`` prompts of ``seq`` tokens
    through ``make_prefill_step`` (its launches counted), a second one
    timed, then ``LM_DECODE_STEPS`` greedy steps through ``make_serve_step``
    with caches of ``seq``; then the kernels held to their plain versions on
    the inputs the prefill gave them."""
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import layers, lm
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.graph_export import export_graph
    from repro_torch.runtime.serve import make_prefill_step, make_serve_step

    release()
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, device="cuda", max_pos=seq)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    graph = export_graph(cfg, ShapeConfig("prefill", seq, batch, "prefill"))
    say("lm", f"{cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, heads {cfg.n_heads}/"
              f"{cfg.n_kv_heads} of {cfg.head_dim}; {nbytes / 1e9:.2f} GB of params on the card "
              f"({graph.total_param_bytes / 1e9:.2f} GB of bf16 weights by export_graph), drawn "
              f"in {time.perf_counter() - t0:.1f} s")
    tokens = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                                      device="cuda")}
    prefill = make_prefill_step(cfg)

    torch.cuda.reset_peak_memory_stats()
    with capture_first(layers, "flash_attention", lambda kw: kw["window"]) as flash_calls, \
            capture_first(ssm_lib, "ssd_chunked", lambda kw: "ssd") as ssd_calls:
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, tokens)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = launch_counts()
    got = (counts["flash_attention_cuda"], counts["flash_attention_cuda_windowed"],
           counts["ssd_chunked_cuda"])
    if got != LM_LAUNCHES[arch]:
        fail(f"{arch} prefill launched (flash, windowed, SSD) {got}, not {LM_LAUNCHES[arch]}")
    if logits.shape != (batch, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        fail(f"{arch} prefill logits {tuple(logits.shape)} not all finite")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(params, tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if "--profile" in sys.argv[1:]:
        profile_lm(f"{cfg.name} prefill B={batch} x {seq}", lambda: prefill(params, tokens))

    caches = lm.init_caches(cfg, batch, seq, device="cuda")
    serve = make_serve_step(cfg)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    reset_launch_counts()
    steps = []
    for _ in range(LM_DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, caches = serve(params, caches, tok)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    if "--profile" in sys.argv[1:]:
        out = {}
        profile_lm(f"{cfg.name} decode step B={batch}",
                   lambda: out.update(step=serve(params, caches, tok)))
        tok, caches = out["step"]
    with torch.inference_mode():
        last, caches = lm.decode_step(cfg, params, caches, tok)
    dec = launch_counts()
    if dec["flash_attention_cuda"] or dec["ssd_chunked_cuda"]:
        fail(f"{arch} decode launched prefill kernels: {dec}")
    profiled = "--profile" in sys.argv[1:]  # one more step, under the profiler
    if caches["pos"] != LM_DECODE_STEPS + 1 + profiled or not bool(torch.isfinite(last).all()):
        fail(f"{arch} decode: pos {caches['pos']}, logits not all finite")
    peak = torch.cuda.max_memory_allocated()
    decode_ms = sum(steps[1:]) / (len(steps) - 1) * 1e3
    say("lm", f"{cfg.name} prefill B={batch} x S={seq}: first {first_s:.3f} s, then "
              f"{prefill_s:.3f} s wall ({batch * seq / prefill_s:.0f} tokens/s); decode "
              f"{LM_DECODE_STEPS} greedy steps at B={batch}, caches {seq}: {decode_ms:.2f} ms a "
              f"step after the first ({steps[0] * 1e3:.1f} ms); peak device memory "
              f"{peak / 2**30:.2f} GiB; launches a prefill: flash {got[0]} ({got[1]} windowed), "
              f"SSD {got[2]}; {card}")
    del params, caches, logits, tokens, last
    release()
    errs = lm_kernel_parity(arch, flash_calls, ssd_calls)
    del flash_calls, ssd_calls
    release()
    return {"launches": got, "errors": errs, "prefill_s": prefill_s, "decode_ms": decode_ms,
            "peak_bytes": peak}


def phase_lm(card: str) -> dict:
    for arch, d_model in LM_SMALL:
        lm_card_vs_cpu(arch, d_model)
    release()
    return {m["arch"]: serve_lm(card, **m) for m in LM_MODELS}


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


def flex_mask(s: int, window: int, softcap: float, causal: bool = True):
    """FlexAttention's (score_mod, block_mask) of attention over S tokens:
    the softcap (if any) as ``score_mod``, causal (and the window) as a
    ``block_mask``; without ``causal`` every pair the window allows."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask

    def score_mod(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    def mask_mod(b, h, q_idx, kv_idx):
        ok = q_idx >= kv_idx if causal else q_idx >= 0
        return ok & (q_idx - kv_idx < window) if window > 0 else ok

    block_mask = create_block_mask(mask_mod, B=None, H=None, Q_LEN=s, KV_LEN=s, device="cuda")
    return (score_mod if softcap > 0 else None), block_mask


def flex_attention_yardstick(q, k, v, window: int, softcap: float):
    """FlexAttention under ``torch.compile`` on (B, H, S, hd) copies of q, k,
    v (``flex_mask``; GQA by ``enable_gqa``).  Returns the compiled call."""
    import torch
    from torch.nn.attention.flex_attention import flex_attention

    mod, block_mask = flex_mask(q.shape[1], window, softcap)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    fn = torch.compile(flex_attention, dynamic=False)
    return lambda: fn(qt, kt, vt, score_mod=mod, block_mask=block_mask, enable_gqa=True)


# phase 11: the training path (repro_torch.runtime.train, lm.loss_fn, the
# flash backward kernel, runtime.checkpoint)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1)
# llama3.2-1b whole (src/repro/configs/archs.py:77-90); train_4k's S=4096,
# its global batch of 256 cut to 16 as 2 microbatches of 8.  Launches a
# step: flash forward 16 layers x 2 (remat) x 2 microbatches, backward 32
TRAIN_LLAMA = dict(arch="llama3.2-1b", layers=0, batch=16, microbatch=8, seq=4096, steps=3,
                   launches=(64, 32, 0, 0), seed=71)
# gemma2-27b at full width (archs.py:109-128), depth cut to one local +
# global group (2 of 46 layers); B=1 x S=8192, where its 4096 window masks
TRAIN_GEMMA = dict(arch="gemma2-27b", layers=2, batch=1, microbatch=0, seq=8192, steps=2,
                   launches=(4, 2, 0, 0), seed=73)
# zamba2-2.7b whole (archs.py:165-179: 54 Mamba2 layers, d=2560, 80 heads of
# 64, N=64; the shared block every 6 layers, 32/32 heads of 80); train_4k's
# S=4096, its global batch of 256 cut to 8 as 2 microbatches of 4.  Launches
# a step: flash forward 9 x 2 (remat) x 2 microbatches, backward 18; the SSD
# scan forward 54 x 2 x 2, backward 108
TRAIN_ZAMBA = dict(arch="zamba2-2.7b", layers=0, batch=8, microbatch=4, seq=4096, steps=3,
                   launches=(36, 18, 216, 108), seed=77)
# (h)-(l): one arch of each remaining family at its published widths, at
# train_4k's S=4096 (xlstm: S chosen by a step's time), every group
# rematerialized, 2 steps (the script's time limit).  Launches a step: flash forward layers x 2 (remat) x
# microbatches, backward layers x microbatches
# phi3.5-moe (archs.py:29-43: d=4096, 32/8 heads of 128, 16 experts top-2,
# d_ff 6400), depth cut to 2 of 32 layers; B=8 as 2 microbatches of 4
TRAIN_PHI = dict(arch="phi3.5-moe-42b-a6.6b", layers=2, batch=8, microbatch=4, seq=4096, steps=2,
                 launches=(8, 4, 0, 0), seed=79)
# kimi-k2 (archs.py:45-59: d=7168, 64/8 heads of 112, top-8 of 384 experts,
# d_ff 2048, bf16 optimizer state), cut to 2 of 61 layers and 32 experts
TRAIN_KIMI = dict(arch="kimi-k2-1t-a32b", layers=2, experts=32, batch=8, microbatch=4, seq=4096,
                  steps=2, launches=(8, 4, 0, 0), seed=81)
# pixtral-12b (archs.py:14-26: d=5120, 32/8 heads of 160, d_ff 14336, vocab
# 131072), cut to 8 of 40 layers; patches (B, 256, 1024) as launch/specs.py
TRAIN_PIXTRAL = dict(arch="pixtral-12b", layers=8, batch=8, microbatch=4, seq=4096, steps=2,
                     launches=(32, 16, 0, 0), seed=83)
# whisper-small whole (archs.py:131-146: 12 encoder + 12 decoder layers,
# d=768, 12 heads of 64), frames (B, 4096, 768) as launch/specs.py:28.
# Launches a step: the encoder's 12 (non-causal), the decoder's 12 causal
# and 12 cross (non-causal, Sq == Skv), x 2 (remat); backward 36
TRAIN_WHISPER = dict(arch="whisper-small", layers=0, batch=16, microbatch=0, seq=4096, steps=2,
                     launches=(72, 36, 0, 0), seed=85)
# xlstm-125m whole (archs.py:149-162: 12 layers, sLSTM at 0, 4, 8, d=768):
# none of the port's kernels; the sLSTM is a Python loop over time, so S is
# the largest of 1024, 2048, 4096 whose step stays under 30 s: a steady
# step takes 20-24 s at 2048 on an H100, twice that at 4096 (PERF.md)
TRAIN_XLSTM = dict(arch="xlstm-125m", layers=0, batch=16, microbatch=0, seq=2048, steps=2,
                   launches=(0, 0, 0, 0), seed=87)
# the CLI on the card: whisper-small whole, 3 steps with a checkpoint at 2,
# then again to 4 steps, resumed
CLI_TRAIN = ["--arch", "whisper-small", "--full", "--batch", "4", "--seq", "4096",
             "--ckpt-every", "2"]
# resume equals uninterrupted: llama3.2-1b at full width cut to 2 of 16
# layers (a checkpoint of 3.6 GB), B=4 x 4096
RESUME = dict(arch="llama3.2-1b", layers=2, batch=4, seq=4096, seed=75)
# of max|plain| per gradient: the JAX package's gradient tolerance is 1e-4;
# the kernel measured 4.7e-6 at worst over the sweep, so the pin is 2e-5
TOL_FLASH_BWD = 2e-5
# whisper-small's dq on its train step's own inputs is a sum of thousands of
# nearly cancelling terms (max|dq| 4.5e-9 beside max|dk| 2.7e-7): there the
# f32 plain version itself errs by 1.24e-4 of max|f64| per (batch, kv-head
# group) against an f64 plain run, and the kernel by 8.4e-5 (on an H100), so
# no two f32 versions agree within TOL_FLASH_BWD.  Its dq is held to the f64
# plain run at twice the f32 plain version's own error; dk and dv keep 2e-5
TOL_FLASH_BWD_DQ_F64 = 2.5e-4
# product FLOPs the backward kernels do a live (query, key) pair, in units
# of hd: S and dP in each of the dK/dV and dQ kernels, dV, dK, dQ once (the
# bound counts 10: each product once)
FLASH_BWD_FLOPS_PER_HD = 14
# of max|plain| per gradient of the SSD backward: the JAX package's gradient
# tolerance is 1e-4; the kernel measured 6.8e-7 at worst over the sweep and
# the zamba2 step's own inputs, so the pin is 5e-6
TOL_SSD_BWD = 5e-6
SSD_GRADS = ("dxs", "dbm", "dcm", "ddt", "da")
# (b, s, h, dh, n, dt scale): the SSD backward's sweep (f)
SSD_BWD_CASES = [
    (2, 256, 4, 64, 32, 1.0), (2, 256, 4, 64, 32, 0.01), (1, 512, 8, 64, 64, 1.0),
    (1, 512, 8, 64, 64, 0.01),
    (1, 40, 3, 64, 64, 1.0),       # one ragged chunk
    (1, 1000, 2, 22, 37, 0.01),    # ragged, dh and N below 64 and not multiples of 4
    (1, 512, 2, 64, 16, 200.0),    # strong decay: exp above the diagonal overflows unmasked
    (1, 256, 3, 64, 64, 0.01),     # H = 3: one head group of 8, 5 heads masked
    (2, 512, 10, 64, 64, 0.01),    # H = 10: a full head group and a short one
    (1, 1000, 9, 22, 37, 0.01),    # a short group over ragged chunks
    (4, 4096, 80, 64, 64, 1.0),    # zamba2-2.7b's Mamba2 layer at its training microbatch
]


def flash_bwd_cases() -> list[tuple]:
    """(b, s, h, kh, hd, causal, window, softcap): each head dim of the zoo
    causal at G=1, windowed and soft-capped at G=2, bidirectional at G=4,
    G=8, a window of 5 (below one kv tile), at a ragged S and at S=1."""
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS

    return [case for hd in HEAD_DIMS for case in (
        (1, 2048, 2, 2, hd, True, 0, 0.0),
        (2, 2048, 4, 2, hd, True, 512, 50.0),
        (1, 2048, 8, 2, hd, False, 0, 0.0),
        (1, 2048, 8, 1, hd, True, 0, 0.0),
        (1, 2048, 4, 2, hd, True, 5, 0.0),
        (1, 1999, 4, 2, hd, True, 0, 50.0),
        (2, 1, 4, 2, hd, True, 0, 0.0))]


def kv_groups(q, k):
    """(batch, query-head, kv-head) slices of each (batch, kv-head group)."""
    kh = k.shape[2]
    g = q.shape[2] // kh
    for b in range(q.shape[0]):
        for j in range(kh):
            yield slice(b, b + 1), slice(j * g, (j + 1) * g), slice(j, j + 1)


def plain_residuals(q, k, v, o, lse, kw, what: str):
    """The plain o and lse (``attention_ref_lse``) of q, k, v; fails unless
    the kernel's ``o`` and ``lse`` are each within ``TOL_FLASH`` of
    max|plain|.  Returns (o, lse, o's and lse's max|err| / max|plain|)."""
    from repro_torch.kernels.flash_attention.ref import attention_ref_lse

    o_ref, lse_ref = attention_ref_lse(q, k, v, **kw)
    rel = [((a - w).abs().max() / w.abs().max()).item() for a, w in ((o, o_ref), (lse, lse_ref))]
    if not max(rel) <= TOL_FLASH:
        fail(f"flash forward with lse {what} {kw}: o {rel[0]:.3g}, lse {rel[1]:.3g} of "
             f"max|plain| > {TOL_FLASH}")
    return o_ref, lse_ref, rel[0], rel[1]


def flash_bwd_group_errors(args, kw, what: str, dq_exact: bool = False) -> dict:
    """Over every (batch, kv-head group): the forward's o and lse against
    ``attention_ref_lse`` on that group's slice (``plain_residuals``), and
    the backward kernel's dq, dk, dv against ``flash_backward_ref`` fed that
    plain o and lse, each within TOL_FLASH_BWD of the group's max|plain|.
    With ``dq_exact`` dq is held instead to an f64 plain run (the exact
    yardstick) at TOL_FLASH_BWD_DQ_F64, and the f32 plain version's own dq
    error against it is kept beside the kernel's.  Returns the gradients'
    max-abs error and worst relative errors (keys "abs", "rel", "fwd",
    "dq_f32" and, with ``dq_exact``, "dq_f64" and "plain_dq_f64")."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref_lse, flash_backward_ref

    q, k, v, o, lse, do = args
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    out = {"abs": 0.0, "rel": 0.0, "fwd": 0.0, "dq_f32": 0.0}
    if dq_exact:
        out.update(dq_f64=0.0, plain_dq_f64=0.0)
    rel = lambda a, w: ((a.double() - w.double()).abs().max() / w.abs().max()).item()  # noqa: E731
    for bs, hs, ks in kv_groups(q, k):
        qs, k_s, vs = q[bs, :, hs], k[bs, :, ks], v[bs, :, ks]
        o_ref, lse_ref, o_rel, lse_rel = plain_residuals(qs, k_s, vs, o[bs, :, hs], lse[bs, hs],
                                                         kw, what)
        out["fwd"] = max(out["fwd"], o_rel, lse_rel)
        want = flash_backward_ref(qs, k_s, vs, o_ref, lse_ref, do[bs, :, hs], **kw)
        mine = (got[0][bs, :, hs], got[1][bs, :, ks], got[2][bs, :, ks])
        out["dq_f32"] = max(out["dq_f32"], rel(mine[0], want[0]))
        for a, w in zip(mine[1:] if dq_exact else mine, want[1:] if dq_exact else want):
            out["abs"] = max(out["abs"], (a - w).abs().max().item())
            out["rel"] = max(out["rel"], rel(a, w))
        if dq_exact:
            exact = [t.double() for t in (qs, k_s, vs)]
            o64, lse64 = attention_ref_lse(*exact, **kw)
            dq64 = flash_backward_ref(*exact, o64, lse64, do[bs, :, hs].double(), **kw)[0]
            out["dq_f64"] = max(out["dq_f64"], rel(mine[0], dq64))
            out["plain_dq_f64"] = max(out["plain_dq_f64"], rel(want[0], dq64))
            out["abs"] = max(out["abs"], (mine[0].double() - dq64).abs().max().item())
            del exact, o64, lse64, dq64
        del want, o_ref, lse_ref
    del got
    torch.cuda.empty_cache()
    return out


def flash_bwd_parity(card: str) -> float:
    """(a) The forward's o and lse, then the backward kernel, against their
    plain versions over the sweep; the plain backward takes the plain o and
    lse."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda,
        flash_attention_cuda,
    )
    from repro_torch.kernels.flash_attention.ref import flash_backward_ref

    worst, worst_fwd = 0.0, 0.0
    cases = flash_bwd_cases()
    inputs = lambda n, b, s, h, kh, hd: (  # noqa: E731
        *(randn((b, s, heads, hd), 80 + 4 * n + i) for i, heads in enumerate((h, kh, kh))),
        randn((b, s, h, hd), 83 + 4 * n))
    first = None
    for n, (b, s, h, kh, hd, causal, window, softcap) in enumerate(cases):
        q, k, v, do = inputs(n, b, s, h, kh, hd)
        kw = dict(causal=causal, window=window, softcap=softcap)
        o, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
        o_ref, lse_ref, o_rel, lse_rel = plain_residuals(q, k, v, o, lse, kw, (b, s, h, kh, hd))
        worst_fwd = max(worst_fwd, o_rel, lse_rel)
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        again = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        want = flash_backward_ref(q, k, v, o_ref, lse_ref, do, **kw)
        torch.cuda.synchronize()
        # at S=1 dq and dk are 0 in exact math (their plain values rounding
        # noise): held against max|dv| there
        floor = want[2].abs().max().item() if s == 1 else 0.0
        rel = [((a - w).abs().max() / max(w.abs().max().item(), floor)).item()
               for a, w in zip(got, want)]
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            fail(f"flash backward {(b, s, h, kh, hd)} {kw}: two runs differ")
        if not max(rel) <= TOL_FLASH_BWD:
            fail(f"flash backward {(b, s, h, kh, hd)} {kw}: dq, dk, dv "
                 f"{', '.join(f'{e:.3g}' for e in rel)} of max|plain| > {TOL_FLASH_BWD}")
        worst = max(worst, *rel)
        if first is None:
            first = (o, lse, got)
    # the first case once more after calls of other shapes: each call's
    # zeroed counters are its own, nothing stale carries over
    b, s, h, kh, hd, causal, window, softcap = cases[0]
    q, k, v, do = inputs(0, b, s, h, kh, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse, got = first
    if not all(torch.equal(a, c) for a, c in
               zip(got, flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw))):
        fail(f"flash backward {cases[0]}: a call after {len(cases) - 1} calls of other shapes "
             f"differs from the first")
    say("train", f"flash forward with lse and backward kernel vs plain, {len(cases)} cases (hd "
                 f"64-256; causal G=1, window 512 + softcap 50 G=2, bidirectional G=4, causal "
                 f"G=8, window 5, ragged S=1999, S=1; S=2048): o and lse worst {worst_fwd:.3g} of "
                 f"max|plain| against attention_ref_lse (pin {TOL_FLASH}); dq, dk, dv worst "
                 f"{worst:.3g} of max|plain| (at S=1 of max|dv|) against flash_backward_ref fed "
                 f"the plain o and lse (pin {TOL_FLASH_BWD}), every case deterministic (two runs "
                 f"equal), the first case equal again after the {len(cases) - 1} others")
    return worst


def ssd_bwd_errors(args, chunk: int, what: str) -> dict:
    """The SSD backward kernel on ``args`` (xs, bm, cm, dt, a, dy) against
    ``ssd_backward_ref`` chunked as the kernel chunks (at KERNEL_CHUNK,
    padded) in f32: fails unless each gradient is within TOL_SSD_BWD of
    max|plain| and two runs are equal.  The kernel and the f32 plain
    version are also held to the f64 plain version (the exact yardstick; da
    per head too), for the record.  Returns the errors."""
    import torch

    from repro_torch.kernels.ssm_scan.kernel import KERNEL_CHUNK, ssd_chunked_bwd_cuda
    from repro_torch.kernels.ssm_scan.ref import ssd_backward_ref_padded

    got = ssd_chunked_bwd_cuda(*args, chunk=chunk)
    again = ssd_chunked_bwd_cuda(*args, chunk=chunk)
    want = ssd_backward_ref_padded(*args, chunk=KERNEL_CHUNK)
    torch.cuda.synchronize()
    if not all(torch.equal(g, c) for g, c in zip(got, again)):
        fail(f"SSD backward {what}: two runs differ")
    rel = lambda a, w: ((a.double() - w.double()).abs().max() / w.abs().max()).item()  # noqa: E731
    out = {"rel": [rel(g, w) for g, w in zip(got, want)],
           "abs": max((g - w).abs().max().item() for g, w in zip(got, want))}
    del again
    if not (max(out["rel"]) <= TOL_SSD_BWD and all(bool(torch.isfinite(g).all()) for g in got)):
        fail(f"SSD backward {what}: " + ", ".join(f"{n} {e:.3g}" for n, e in
                                                   zip(SSD_GRADS, out["rel"]))
             + f" of max|plain| > {TOL_SSD_BWD}, or not finite")
    ref64 = ssd_backward_ref_padded(*(t.double() for t in args), chunk=KERNEL_CHUNK)
    out["kernel_f64"] = [rel(g, w) for g, w in zip(got, ref64)]
    out["plain_f64"] = [rel(g, w) for g, w in zip(want, ref64)]
    # da per head, where it is not ~0 against the largest head: the kernel's
    # and the f32 plain version's worst relative error
    live = ref64[4].abs() > 1e-6 * ref64[4].abs().max()
    out["da_head_f64"] = [((d.double() - ref64[4]).abs()[live] / ref64[4].abs()[live])
                          .max().item() for d in (got[4], want[4])]
    del ref64, got, want
    torch.cuda.empty_cache()
    return out


def ssd_bwd_parity(card: str) -> float:
    """(f) The SSD backward kernel against its plain version over the sweep
    (f32 pin, two runs equal), and against an f64 plain run beside the f32
    plain version's own error."""
    worst, worst_k64, worst_p64 = 0.0, 0.0, 0.0
    for i, (b, s, h, dh, n, scale) in enumerate(SSD_BWD_CASES):
        xs, bm, cm, dt, a = ssd_case(b, s, h, dh, n, 90 + 7 * i)
        args = (xs, bm, cm, dt * scale, a, randn((b, s, h, dh), 95 + 7 * i))
        e = ssd_bwd_errors(args, s, (b, s, h, dh, n, f"dt x {scale}"))
        worst = max(worst, *e["rel"])
        k64, p64 = max(e["kernel_f64"]), max(e["plain_f64"])
        worst_k64, worst_p64 = max(worst_k64, k64), max(worst_p64, p64)
        say("train", f"SSD backward {(b, s, h, dh, n)} dt x {scale}: " + ", ".join(
            f"{g} {x:.3g}" for g, x in zip(SSD_GRADS, e["rel"])) + f" of max|plain| (f32); "
            f"against f64 the kernel {k64:.3g}, the f32 plain {p64:.3g} (da per head, relative: "
            f"kernel {e['da_head_f64'][0]:.3g}, plain {e['da_head_f64'][1]:.3g})")
    say("train", f"SSD backward kernel vs plain, {len(SSD_BWD_CASES)} cases: worst {worst:.3g} of "
                 f"max|plain| (pin {TOL_SSD_BWD}), two runs equal in every case; against the f64 "
                 f"plain version the kernel's worst {worst_k64:.3g}, the f32 plain version's "
                 f"{worst_p64:.3g}; {card}")
    return worst


def bigram_tokens(vocab: int, batch: int, seq: int, seed: int):
    """``examples/train_lm.py``'s synthetic stream, drawn in torch on the
    card: a first token from a Zipf-like law, then a fixed random bigram
    table (learnable)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randint(0, vocab, (vocab,), generator=gen, device="cuda")
    law = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float32, device="cuda")
    tok = torch.multinomial(law, batch, replacement=True, generator=gen)
    out = torch.empty((batch, seq), dtype=torch.int32, device="cuda")
    for i in range(seq):
        out[:, i] = tok
        tok = table[tok]
    return out


def train_config(arch: str, layers: int, experts: int = 0):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers) if layers else cfg
    return dataclasses.replace(cfg, n_experts=experts) if experts else cfg


def train_batch(cfg, batch: int, seq: int, seed: int) -> dict:
    """The bigram stream's tokens (B, S); for audio frames (B, S, d) and for
    vlm patches (B, 256, PATCH_DIM) in bf16, drawn on the card from
    ``seed``, at the shapes ``src/repro/launch/specs.py`` gives them."""
    import torch

    from repro_torch.models import lm

    out = {"tokens": bigram_tokens(cfg.vocab_size, batch, seq, seed)}
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    if cfg.family == "audio":
        out["frames"] = (torch.randn((batch, seq, cfg.d_model), generator=gen, device="cuda")
                         * 0.5).to(torch.bfloat16)
    if cfg.family == "vlm":
        out["patches"] = (torch.randn((batch, lm.PATCH_TOKENS, lm.PATCH_DIM), generator=gen,
                                      device="cuda") * 0.1).to(torch.bfloat16)
    return out


def to_host(calls: dict) -> dict:
    """Captured kernel inputs moved to host memory, so that later models
    train with the card to themselves; ``on_card`` brings them back."""
    return {k: (tuple(a.cpu() for a in args), kw) for k, (args, kw) in calls.items()}


def on_card(args: tuple) -> tuple:
    return tuple(a.cuda() for a in args)


def train_lm(card: str, arch: str, layers: int, batch: int, microbatch: int, seq: int,
             steps: int, launches: tuple, seed: int, experts: int = 0) -> dict:
    """(b)/(c)/(g)-(l) ``arch`` at its published widths in bf16 (moments in
    its ``opt_state_dtype``, gradients accumulated in it too, every group
    rematerialized), ``steps`` AdamW steps on one repeated batch of the
    bigram stream (with frames or patches for audio and vlm); the flash
    and SSD launches of each step counted (``launches``: flash forward,
    backward, SSD forward, backward; flash also by (causal, window)), and
    the inputs of the first step's first flash backward of each (causal,
    window) and first SSD backward kept in host memory."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.runtime import train

    release()
    cfg = train_config(arch, layers, experts)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = lm.init_params(cfg, gen, device="cuda", max_pos=seq)
    n_params = sum(t.numel() for t in tree_leaves(params))
    state = train.init_state(cfg, params)
    opt = train.OptConfig(**TRAIN_OPT, microbatch=microbatch, accum_dtype=cfg.opt_state_dtype)
    step = train.make_train_step(cfg, opt)
    tokens = train_batch(cfg, batch, seq, seed + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, counts = [], [], []
    kind = lambda kw: (kw["causal"], kw["window"])  # noqa: E731
    fwd_kinds = capture_first(flash_ops, "flash_attention_cuda", kind, keep=False)
    bwd_kinds = capture_first(flash_ops, "flash_attention_bwd_cuda", kind)
    with bwd_kinds as calls, fwd_kinds, \
            capture_first(ssm_ops, "ssd_chunked_bwd_cuda", lambda kw: "ssd") as ssd_calls:
        for _ in range(steps):
            reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step(state, tokens)
            losses.append(metrics["loss"].item())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            c = launch_counts()
            counts.append((c["flash_attention_cuda"], c["flash_attention_bwd_cuda"],
                           c["ssd_chunked_cuda"], c["ssd_chunked_bwd_cuda"],
                           c["flash_attention_cuda_windowed"],
                           c["flash_attention_bwd_cuda_windowed"]))
    peak = torch.cuda.max_memory_allocated()
    full = train_config(arch, 0)
    what = (f"{cfg.name} ({n_params / 1e9:.3f} B params, {cfg.n_layers} layers"
            + (f" of {full.n_layers}" if layers else "")
            + (f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers else "")
            + f", d={cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}"
            + (f", {cfg.n_experts} experts" + (f" of {full.n_experts}" if experts else "")
               + f" top-{cfg.experts_per_token}, d_ff {cfg.d_ff}" if cfg.n_experts else "")
            + f", vocab {cfg.vocab_size})")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"{what}: losses {losses} not all finite, or the last not below the first")
    if any(c[:4] != launches for c in counts):
        fail(f"{what}: (flash forward, backward, SSD forward, backward) launches a step "
             f"{[c[:4] for c in counts]}, not {launches}")
    # a model that runs none of the port's kernels (xlstm) is not traced: its
    # sLSTM launches ~1e6 tiny ops a step
    if "--profile" in sys.argv[1:] and any(launches):
        profile_lm(f"{cfg.name} train step B={batch} x {seq}", lambda: step(state, tokens))
    steady = sum(secs[1:]) / (len(secs) - 1)
    per_kind = lambda c: ", ".join(  # noqa: E731
        f"{'causal' if k[0] else 'non-causal'}{f' window {k[1]}' if k[1] else ''} {n // steps}"
        for k, n in sorted(c.items()))
    say("train", f"{what}: B={batch} x S={seq}" + (f" as {batch // microbatch} microbatches of "
                 f"{microbatch}" if microbatch else "") + ", "
                 + ", ".join(f"{k} {tuple(v.shape)}" for k, v in tokens.items() if k != "tokens")
                 + (", " if len(tokens) > 1 else "")
                 + f"bf16 params, {cfg.opt_state_dtype} moments, remat; "
                 f"OptConfig(lr={TRAIN_OPT['lr']}, warmup_steps={TRAIN_OPT['warmup_steps']}"
                 + (f", microbatch={microbatch}" if microbatch else "")
                 + f", accum_dtype={cfg.opt_state_dtype}); "
                 f"losses {', '.join(f'{x:.4f}' for x in losses)}; seconds a step "
                 f"{', '.join(f'{x:.3f}' for x in secs)} ({batch * seq / steady:.0f} tokens/s "
                 f"after the first); peak device memory {peak / 2**30:.2f} GiB; launches a step: "
                 f"flash forward {counts[0][0]} ({counts[0][4]} windowed), backward {counts[0][1]} "
                 f"({counts[0][5]} windowed); SSD scan forward {counts[0][2]}, backward "
                 f"{counts[0][3]}"
                 + (f"; flash by kind a step: forward {per_kind(fwd_kinds.counts)}, backward "
                    f"{per_kind(bwd_kinds.counts)}" if fwd_kinds.counts else "") + f"; {card}")
    del state, params, tokens, step
    release()
    return {"calls": to_host(calls), "ssd_calls": to_host(ssd_calls), "losses": losses,
            "secs": secs, "bwd_kinds": bwd_kinds.counts,
            "peak_bytes": peak, "ssd_bwd_launches": sum(c[3] for c in counts),
            "tokens_per_s": batch * seq / steady}


def resume_check(card: str, arch: str, layers: int, batch: int, seq: int, seed: int) -> None:
    """(d) One step, a checkpoint, two more steps ("straight"); the
    checkpoint restored and the same two steps again: every leaf of the
    two states equal, under deterministic algorithms."""
    import shutil

    import torch

    from repro_torch.models import lm
    from repro_torch.models.common import sorted_leaves
    from repro_torch.runtime import train
    from repro_torch.runtime.checkpoint import Checkpointer

    release()
    directory = ROOT / "build" / "train_ckpt"
    shutil.rmtree(directory, ignore_errors=True)
    torch.use_deterministic_algorithms(True)
    try:
        cfg = train_config(arch, layers)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        state = train.init_state(cfg, lm.init_params(cfg, gen, device="cuda", max_pos=seq))
        step = train.make_train_step(cfg, train.OptConfig(**TRAIN_OPT))
        tokens = {"tokens": bigram_tokens(cfg.vocab_size, batch, seq, seed + 1)}
        state, _ = step(state, tokens)
        ck = Checkpointer(directory, keep=1)
        t0 = time.perf_counter()
        ck.save(1, state)
        save_s = time.perf_counter() - t0
        nbytes = sum(p.stat().st_size for p in directory.rglob("*") if p.is_file())
        straight = []
        for _ in range(2):
            state, m = step(state, tokens)
            straight.append(m["loss"].item())
        t0 = time.perf_counter()
        at, resumed = ck.restore(state)
        restore_s = time.perf_counter() - t0
        again = []
        for _ in range(2):
            resumed, m = step(resumed, tokens)
            again.append(m["loss"].item())
        pairs = list(zip(sorted_leaves(state), sorted_leaves(resumed)))
        differ = sum(not torch.equal(a, b) for a, b in pairs)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(directory, ignore_errors=True)
    if at != 1 or differ or straight != again:
        fail(f"resume: restored step {at}; {differ} of {len(pairs)} leaves differ from the "
             f"uninterrupted run (losses {straight} vs {again})")
    say("train", f"resume = uninterrupted, bit for bit: {cfg.name} cut to {cfg.n_layers} layers, "
                 f"B={batch} x {seq}, under torch.use_deterministic_algorithms: step 1, checkpoint "
                 f"({nbytes / 1e9:.2f} GB, saved in {save_s:.1f} s, restored in {restore_s:.1f} s), "
                 f"2 more steps (losses {', '.join(f'{x:.4f}' for x in straight)}) = restore + the "
                 f"same 2 steps: all {len(pairs)} leaves torch.equal; {card}")
    del state, resumed, pairs
    release()


def resume_in_child() -> None:
    """(d) in a child process: deterministic cuBLAS needs
    ``CUBLAS_WORKSPACE_CONFIG`` before CUDA starts, and the rest of the
    script keeps cuBLAS's default workspace."""
    release()
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), RESUME_FLAG],
                           env=env, timeout=900)
    if child.returncode != 0:
        fail(f"the resume check's child process exited with {child.returncode}")


def flash_bwd_on_step(card: str, tag: str, run: dict, key: tuple, dq_exact: bool) -> float:
    """The flash forward's o and lse, then the backward kernel, on a train
    step's own inputs against the plain versions (``flash_bwd_group_errors``);
    fails past the pins.  Returns the gradients' max-abs error."""
    args, kw = run["calls"][key]
    args = on_card(args)
    e = flash_bwd_group_errors(args, kw, f"on the {tag} step", dq_exact)
    if not e["rel"] <= TOL_FLASH_BWD:
        fail(f"flash backward on the {tag} step's own inputs {tuple(args[0].shape)} {kw}: "
             f"{e['rel']:.3g} of max|plain| > {TOL_FLASH_BWD}")
    if dq_exact and not e["dq_f64"] <= TOL_FLASH_BWD_DQ_F64:
        fail(f"flash backward on the {tag} step's own inputs {tuple(args[0].shape)} {kw}: dq "
             f"{e['dq_f64']:.3g} of max|f64 plain| > {TOL_FLASH_BWD_DQ_F64}")
    exact = (f"; dq against an f64 plain run: the kernel {e['dq_f64']:.3g}, the f32 plain "
             f"version {e['plain_dq_f64']:.3g} of max|f64| (pin {TOL_FLASH_BWD_DQ_F64}), the "
             f"kernel against the f32 plain {e['dq_f32']:.3g}" if dq_exact else "")
    say("train", f"flash on the {tag} train step's own inputs q {tuple(args[0].shape)} kv "
                 f"heads {args[1].shape[2]} {kw}, every (batch, kv-head group): the "
                 f"forward's o and lse {e['fwd']:.3g} of max|plain| against attention_ref_lse "
                 f"(pin {TOL_FLASH}); the backward against flash_backward_ref fed the plain o "
                 f"and lse: max-abs {e['abs']:.3g}, {'dk, dv' if dq_exact else 'dq, dk, dv'} "
                 f"{e['rel']:.3g} of max|plain| (pin {TOL_FLASH_BWD}){exact}; {card}")
    del args
    return e["abs"]


def cli_train_resume(card: str) -> None:
    """(m) ``python -m repro_torch.launch.train`` on the card: whisper-small
    whole, 3 steps with a checkpoint at step 2, then the same command to 4
    steps, which must print the resume line; every loss finite."""
    import shutil

    release()
    directory = ROOT / "build" / "cli_ckpt"
    shutil.rmtree(directory, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    outs = []
    try:
        for steps in (3, 4):
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *CLI_TRAIN,
                                  "--steps", str(steps), "--ckpt-dir", str(directory)],
                                 env=env, cwd=str(ROOT), capture_output=True, text=True,
                                 timeout=600)
            if run.returncode != 0:
                fail(f"launch.train --steps {steps} exited with {run.returncode}: "
                     f"{run.stderr[-2000:]}")
            outs.append((run.stdout, time.perf_counter() - t0))
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    losses = [[float(x) for x in re.findall(r"^step +\d+ loss (\S+) gnorm", out, re.MULTILINE)]
              for out, _ in outs]
    if "resumed" in outs[0][0] or "resumed from step 2\n" not in outs[1][0]:
        fail(f"launch.train did not resume from its checkpoint: {outs[1][0][-800:]}")
    if not all(losses) or not all(math.isfinite(x) for ls in losses for x in ls):
        fail(f"launch.train losses not finite: {losses}")
    for (out, wall), steps in zip(outs, (3, 4)):
        say("train", f"python -m repro_torch.launch.train {' '.join(CLI_TRAIN)} --steps {steps} "
                     f"(process {wall:.1f} s): " + " | ".join(out.strip().splitlines())
                     + f"; {card}")


# the flash backward held on each step's own inputs: (tag, run, (causal,
# window), dq held to an f64 plain run (whisper's, at TOL_FLASH_BWD_DQ_F64),
# and the label of its row of (e), None for no row)
FLASH_BWD_ON_STEPS = (
    ("llama", "llama", (True, 0), False, "llama3.2-1b microbatch, causal"),
    ("gemma2", "gemma", (True, 0), False, "gemma2-27b global, causal, softcap 50"),
    ("window_gemma2", "gemma", (True, TRAIN_GEMMA["seq"] // 2), False,
     f"gemma2-27b, causal, window {TRAIN_GEMMA['seq'] // 2}, softcap 50"),
    ("hd80_zamba2", "zamba", (True, 0), False, "zamba2-2.7b shared attention microbatch, causal"),
    ("hd128_phi35moe", "phi", (True, 0), False, "phi3.5-moe-42b-a6.6b microbatch, causal"),
    ("hd112_kimi", "kimi", (True, 0), False, "kimi-k2-1t-a32b microbatch, causal"),
    ("hd160_pixtral", "pixtral", (True, 0), False, "pixtral-12b microbatch, causal"),
    ("noncausal_whisper", "whisper", (False, 0), True,
     "whisper-small encoder and cross attention, non-causal"),
    ("causal_whisper", "whisper", (True, 0), True, None))


def phase_train(card: str) -> dict:
    """Phase 11 (a)-(d), (f)-(m): the flash backward kernel, llama3.2-1b
    whole, gemma2-27b at full width, the SSD backward kernel, zamba2-2.7b
    whole, resume, then phi3.5-moe, kimi-k2, pixtral-12b, whisper-small and
    xlstm-125m and the CLI; returns what (e) times."""
    worst = flash_bwd_parity(card)
    runs = {"llama": train_lm(card, **TRAIN_LLAMA), "gemma": train_lm(card, **TRAIN_GEMMA)}
    worst_ssd = ssd_bwd_parity(card)
    runs["zamba"] = train_lm(card, **TRAIN_ZAMBA)
    resume_in_child()
    for name, conf in (("phi", TRAIN_PHI), ("kimi", TRAIN_KIMI), ("pixtral", TRAIN_PIXTRAL),
                       ("whisper", TRAIN_WHISPER)):
        runs[name] = train_lm(card, **conf)
    runs["xlstm"] = train_lm(card, **TRAIN_XLSTM)
    cli_train_resume(card)
    errors = {}
    (args, kw), = runs["zamba"]["ssd_calls"].values()
    args = on_card(args)
    e = ssd_bwd_errors(args, kw["chunk"], f"on the zamba2 step's own inputs {tuple(args[0].shape)}")
    errors["ssd_chunked_bwd"] = e["abs"]
    say("train", f"SSD backward on the zamba2-2.7b train step's own inputs xs "
                 f"{tuple(args[0].shape)} N={args[1].shape[-1]} (chunk {kw['chunk']}; the kernel "
                 f"at 64): " + ", ".join(f"{g} {x:.3g}" for g, x in zip(SSD_GRADS, e["rel"]))
                 + f" of max|plain| (pin {TOL_SSD_BWD}), max-abs {e['abs']:.3g}, two runs equal; "
                 f"against f64 the kernel {max(e['kernel_f64']):.3g}, the f32 plain "
                 f"{max(e['plain_f64']):.3g}; da per head, relative: kernel "
                 f"{e['da_head_f64'][0]:.3g}, plain {e['da_head_f64'][1]:.3g}")
    del args
    for tag, run, key, dq_exact, _ in FLASH_BWD_ON_STEPS:
        errors[tag] = flash_bwd_on_step(card, tag, runs[run], key, dq_exact)
    return {"worst_sweep": worst, "worst_ssd_sweep": worst_ssd, **runs, "errors": errors}


def flex_backward_yardstick(q, k, v, do, window: int, softcap: float, causal: bool = True):
    """FlexAttention's backward under ``torch.compile``: the same score_mod
    and block_mask as phase 10's forward yardstick (``flex_mask``).
    Returns (forward, forward + backward) callables; the forward runs with
    grad, as the backward needs it."""
    import torch
    from torch.nn.attention.flex_attention import flex_attention

    mod, block_mask = flex_mask(q.shape[1], window, softcap, causal)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    fn = torch.compile(flex_attention, dynamic=False)

    def forward():
        return fn(qt, kt, vt, score_mod=mod, block_mask=block_mask, enable_gqa=True)

    def forward_backward():
        return torch.autograd.grad(forward(), (qt, kt, vt), dot)

    return forward, forward_backward


def sdpa_backward_yardstick(q, k, v, do, causal: bool = True):
    """``scaled_dot_product_attention`` (``enable_gqa``; PyTorch picks its
    backend) under autograd on (B, H, S, hd) copies of q, k, v: the same
    function as the kernel's where there is no softcap and no window, for
    rows whose FlexAttention template does not compile.  Returns (forward,
    forward + backward) callables."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def forward():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)

    def forward_backward():
        return torch.autograd.grad(forward(), (qt, kt, vt), dot)

    return forward, forward_backward


def train_times(card: str, trained: dict) -> list[dict]:
    """(e) The backward kernel on the train steps' own inputs: its time
    beside its bound, the plain version per kv-head group summed, and
    FlexAttention's backward ((forward + backward) - forward)."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_cuda
    from repro_torch.kernels.flash_attention.ref import flash_backward_ref

    rows = []
    for tag, run_name, key, _, label in FLASH_BWD_ON_STEPS:
        if label is None:
            continue
        run = trained[run_name]
        args, kw = run["calls"][key]
        q, k, v, o, lse, do = on_card(args)
        launches = run["bwd_kinds"][key]
        causal, w = key
        name = f"flash_attention_bwd_{tag}"
        b, s, h, hd = q.shape
        kvh = k.shape[2]

        def plain():
            for bs, hs, ks in kv_groups(q, k):
                flash_backward_ref(q[bs, :, hs], k[bs, :, ks], v[bs, :, ks], o[bs, :, hs],
                                   lse[bs, hs], do[bs, :, hs], **kw)

        ms = cuda_time_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw), 3)
        plain_ms = cuda_time_ms(plain, 1)
        if causal:
            live = (s * (s + 1) // 2 if w <= 0 else sum(min(i + 1, w) for i in range(s))) * b * h
        else:
            live = s * s * b * h
        nbytes = (4 * q.numel() + 4 * k.numel() + lse.numel()) * 4  # q o dO dq, k v dk dv, lse
        b_ms, b_by, fma_ms = bound_ms(nbytes, 10 * hd * live, F32_PRODUCT_S_PER_FLOP)
        design_ms = bound_ms(nbytes, FLASH_BWD_FLOPS_PER_HD * hd * live,
                             F32_PRODUCT_S_PER_FLOP)[0]
        library, lib_name = None, "FlexAttention backward"
        plain_attention = kw["softcap"] == 0 and w <= 0
        if not plain_attention:  # FlexAttention is the one call that takes softcap and window
            t0 = time.perf_counter()
            try:  # a yardstick only: its failure is reported, never timed
                fwd, fwd_bwd = flex_backward_yardstick(q, k, v, do, w, kw["softcap"], causal)
                fwd_bwd()
                torch.cuda.synchronize()
                library = cuda_time_ms(fwd_bwd, 3) - cuda_time_ms(fwd, 3)
                say("train", f"{name}: FlexAttention backward compiled and run in "
                             f"{time.perf_counter() - t0:.1f} s")
                del fwd, fwd_bwd
            except Exception as e:  # noqa: BLE001
                say("train", f"{name}: FlexAttention backward yardstick FAILED "
                             f"({type(e).__name__}: {str(e)[:300]})")
                torch.cuda.empty_cache()
        else:
            lib_name = "scaled_dot_product_attention backward"
            want = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
            for rows_a_call in (b, 1):  # one call; per batch row where one does not fit
                library, agree, oom = 0.0, 0.0, None
                try:
                    for r0 in range(0, b, rows_a_call):
                        sl = slice(r0, r0 + rows_a_call)
                        fwd, fwd_bwd = sdpa_backward_yardstick(q[sl], k[sl], v[sl], do[sl], causal)
                        got = [g.transpose(1, 2) for g in fwd_bwd()]
                        agree = max(agree, *(((g - x[sl]).abs().max() / x.abs().max()).item()
                                             for g, x in zip(got, want)))
                        library += cuda_time_ms(fwd_bwd, 3) - cuda_time_ms(fwd, 3)
                except torch.cuda.OutOfMemoryError as e:
                    oom = str(e)[:120]
                except Exception as e:  # noqa: BLE001
                    library = None
                    say("train", f"{name}: scaled_dot_product_attention yardstick FAILED "
                                 f"({type(e).__name__}: {str(e)[:300]})")
                    break
                fwd = fwd_bwd = got = None
                torch.cuda.empty_cache()
                if oom is None:
                    how = "one call" if rows_a_call == b else f"{b} calls of one batch row, summed"
                    say("train", f"{name}: scaled_dot_product_attention(is_causal={causal}, "
                                 f"enable_gqa=True) under autograd as the yardstick ({how}); its "
                                 f"dq, dk, dv agree with the kernel's within {agree:.3g} of "
                                 f"max|kernel|")
                    break
                library = None
                say("train", f"{name}: scaled_dot_product_attention over {rows_a_call} batch "
                             f"rows does not fit the card ({oom})")
            del want
        if library is None:
            say("train", f"{name}: library_ms null")
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                     "replaces": "src/repro/kernels/flash_attention/ops.py:254",
                     "launches": launches, "max_abs_err": trained["errors"][tag],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library})
        lib = "null" if library is None else f"{library:.4f} ms"
        say("times", f"{name} ({b}, {s}, {h}, {kvh}, {hd}, {label}): {ms:.4f} ms, bound "
                     f"{b_ms:.4f} ms ({b_by}: 10 hd FLOPs a live pair at 3 TF32 passes; "
                     f"{b_ms / ms:.1%} of it; this design does {FLASH_BWD_FLOPS_PER_HD} hd a "
                     f"live pair, bound {design_ms:.4f} ms; f32 FMA bound {fma_ms:.4f} ms), "
                     f"plain {plain_ms:.4f} ms (per kv-head group, summed), {lib_name} {lib}; "
                     f"launches {launches}; {card}")
    rows.append(ssd_bwd_times(card, trained["zamba"], trained["errors"]["ssd_chunked_bwd"]))
    return rows


def ssd_bwd_flops(b: int, s: int, h: int, dh: int, n: int, q: int) -> int:
    """Product FLOPs of the SSD backward at chunk q (ssd_backward_ref's
    formulas): per head and chunk of r rows, the lower triangles of P = dy
    x^T, of the scores' products with dy (dx) and of theirs with B and C
    (dC, dB): r (r + 1) (2 dh + 2 N); dy h, B dH^T and x dH, and the two
    state recurrences (10 r dh N); the states' decays (2 dh N).  G = C B^T
    once per (batch row, chunk): heads share it."""
    per_head, shared = 0, 0
    for t0 in range(0, s, q):
        r = min(q, s - t0)
        per_head += r * (r + 1) * (2 * dh + 2 * n) + 10 * r * dh * n + 2 * dh * n
        shared += r * (r + 1) * n
    return b * (h * per_head + shared)


def ssd_bwd_design_bytes(b: int, s: int, h: int, dh: int, n: int, group: int) -> int:
    """Bytes the backward's four kernels move (csrc/ssd_scan_bwd.cu): the
    state pass reads xs, dy, dt, bm and cm and writes h and dH of every
    chunk, (B, H, nc, 64, 64) each; the chunk kernel reads xs, dy, bm, cm,
    dt, h and dH and writes dxs, ddt, one dbm and dcm partial per head group
    (B, S, ceil(H / group), N) and the da partials; the reduction reads the
    partials and writes dbm and dcm."""
    nc = -(-s // 64)
    x, bn, t = b * s * h * dh, b * s * n, b * s * h
    st, part, dap = b * h * nc * 64 * 64, b * s * -(-h // group) * n, b * h * nc
    inputs = 2 * x + 2 * bn + t
    states = inputs + 2 * st
    chunk = inputs + 2 * st + x + t + 2 * part + dap
    return int(4 * (states + chunk + 2 * part + 2 * bn + dap + h))


def ssd_bwd_times(card: str, zamba: dict, err: float) -> dict:
    """(e) The SSD backward kernel on the zamba2 step's own inputs beside its
    bound (inputs and outputs once; the fewest product FLOPs of any chunking
    at 3 TF32 passes), the plain version at the kernel's chunk, and the
    bytes this design moves."""
    from repro_torch.kernels.ssm_scan.kernel import HEAD_GROUP, KERNEL_CHUNK, ssd_chunked_bwd_cuda
    from repro_torch.kernels.ssm_scan.ref import ssd_backward_ref_padded

    (args, kw), = zamba["ssd_calls"].values()
    args = on_card(args)
    b, s, h, dh = args[0].shape
    n = args[1].shape[-1]
    ms = cuda_time_ms(lambda: ssd_chunked_bwd_cuda(*args, **kw), 10)
    plain_ms = cuda_time_ms(lambda: ssd_backward_ref_padded(*args, chunk=KERNEL_CHUNK), 1)
    nbytes = (3 * args[0].numel() + 4 * args[1].numel() + 2 * args[3].numel() + 2 * h) * 4
    q_min = min((2 ** k for k in range(s.bit_length())),
                key=lambda c: ssd_bwd_flops(b, s, h, dh, n, c))
    flops = ssd_bwd_flops(b, s, h, dh, n, q_min)
    b_ms, b_by, fma_ms = bound_ms(nbytes, flops, F32_PRODUCT_S_PER_FLOP)
    flops_64 = ssd_bwd_flops(b, s, h, dh, n, KERNEL_CHUNK)
    design = ssd_bwd_design_bytes(b, s, h, dh, n, HEAD_GROUP)
    design_ms, design_by, _ = bound_ms(design, flops_64, F32_PRODUCT_S_PER_FLOP)
    steps = TRAIN_ZAMBA["steps"]
    say("times", f"ssd_chunked_bwd xs {(b, s, h, dh)} N={n} (zamba2-2.7b microbatch): {ms:.4f} "
                 f"ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e9:.3f} GB once, "
                 f"{flops / 1e9:.2f} GFLOP at Q={q_min} at 3 TF32 passes; {b_ms / ms:.1%} of it; "
                 f"f32 FMA bound {fma_ms:.4f} ms); this design: {flops_64 / 1e9:.2f} GFLOP at "
                 f"Q={KERNEL_CHUNK} at 3 TF32 passes, {design / 1e9:.3f} GB (h, dH and the head "
                 f"groups' partials through device memory; {HEAD_GROUP} heads a group), "
                 f"bound {design_ms:.4f} ms ({design_by}; {design_ms / ms:.1%} of it); "
                 f"plain {plain_ms:.4f} ms; library none; launches {zamba['ssd_bwd_launches']} in "
                 f"{steps} steps; {card}")
    return {"name": "ssd_chunked_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
            "replaces": "src/repro/models/ssm.py:105", "launches": zamba["ssd_bwd_launches"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


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
                     "library_ms": library, **extra})
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
        CODE_PRODUCT_S_PER_FLOP, (rows_n, d, proj), unfused_ms=unfused_best)
    say("times", f"dequant_matmul at its own route (2 split-TF32 passes): bound {tf32_ms:.4f} "
                 f"ms, {tf32_ms / rows[-1]['ms']:.1%} of it; {card}")
    say("times", f"dequant_matmul fused vs unfused (dequantize kernel + torch.matmul), "
                 f"interleaved best of 5: {fused_best:.4f} / {unfused_best:.4f} ms, ratio "
                 f"{fused_best / unfused_best:.3f}; {card}")
    del x, w
    torch.cuda.empty_cache()

    def flash_rows(fq, fk, fv, variants):
        """A row of each (name, window, softcap, label) variant over q, k, v."""
        b, s, h, hd = fq.shape
        kvh = fk.shape[2]
        g = h // kvh
        io_bytes = (fq.numel() * 2 + fk.numel() * 2) * 4  # q, o, k, v read/written once
        for name, window, softcap, label in variants:
            def plain(window=window, softcap=softcap):
                for j in range(kvh):
                    attention_ref(fq[:, :, j * g:(j + 1) * g], fk[:, :, j:j + 1],
                                  fv[:, :, j:j + 1], causal=True, window=window, softcap=softcap)

            kernel = lambda w=window, c=softcap: flash_attention_cuda(  # noqa: E731
                fq, fk, fv, causal=True, window=w, softcap=c)
            live = (s * (s + 1) // 2 if window <= 0
                    else sum(min(i + 1, window) for i in range(s)))
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
                "src/repro/kernels/flash_attention/kernel.py:96", kernel, plain, 3,
                io_bytes, 4 * hd * live * b * h, F32_PRODUCT_S_PER_FLOP,
                (b, s, h, kvh, hd, label), library=library)

    qkv = randn((n, s, proj), 14)  # demo_transformer's: slices of the fused projection
    softcap = SERVED["softcap"]
    flash_rows(qkv[..., : heads * hd].reshape(n, s, heads, hd),
               qkv[..., heads * hd: (heads + kvh) * hd].reshape(n, s, kvh, hd),
               qkv[..., (heads + kvh) * hd:].reshape(n, s, kvh, hd),
               (("flash_attention_fwd", 0, softcap, "global causal, softcap"),
                ("flash_attention_fwd_window", SERVED["window"], softcap,
                 f"causal, window {SERVED['window']}, softcap")))
    del qkv
    torch.cuda.empty_cache()
    # the LM zoo's (phase 8b): gemma2-27b's layers at B=2 and zamba2-2.7b's
    # shared attention at hd 80, each q, k, v its own tensor
    for b, h, kvh, hd, variants in (
            (2, 32, 16, 128, (("flash_attention_fwd_gemma2", 0, 50.0, "gemma2-27b global"),
                              ("flash_attention_fwd_window_gemma2", 4096, 50.0,
                               "gemma2-27b window 4096"))),
            (4, 32, 32, 80, (("flash_attention_fwd_hd80_zamba2", 0, 0.0,
                              "zamba2-2.7b shared attention, causal"),))):
        flash_rows(randn((b, s, h, hd), 15), randn((b, s, kvh, hd), 16),
                   randn((b, s, kvh, hd), 17), variants)
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
        (n, sq, h, dh, ns, f"kernel and plain at Q={q}, bound at Q={q_min}"))
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
    start = time.perf_counter()
    card = phase_device()
    sys.path.insert(0, str(SRC))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e})")
    import torch._dynamo

    from repro_torch.core.execution import resolve_device

    resolve_device("cuda")  # full-f32 matmuls: the plain versions are f32 references
    # the FlexAttention yardsticks (phases 10, 11) compile flex_attention
    # anew for each shape; past dynamo's default of 8 compiles the rest
    # would silently run its unfused fallback
    torch._dynamo.config.recompile_limit = max(torch._dynamo.config.recompile_limit, 64)
    if RESUME_FLAG in sys.argv[1:]:  # phase 11(d), in the child resume_in_child starts
        resume_check(card, **RESUME)
        return
    phase_build()
    errors = phase_parity()
    errors["ssd_chunked"] = phase_parity_ssd()
    counts_tf, per_request = phase_serve_transformer()
    phase_serve_mlp()
    counts_ssm, per_request_ssm = phase_serve_ssm()
    phase_serve_tenants()
    phase_reference()
    served_lm = phase_lm(card)
    phase_replicas(card)
    trained = phase_train(card)
    gemma, zamba = served_lm["gemma2-27b"], served_lm["zamba2-2.7b"]
    errors.update({"flash_attention_fwd_gemma2": gemma["errors"]["global"],
                   "flash_attention_fwd_window_gemma2": gemma["errors"]["window"],
                   "flash_attention_fwd_hd80_zamba2": zamba["errors"]["global"]})
    launches = {
        "quantize_int8": counts_tf["quantize_int8_cuda"],
        "dequant_matmul": counts_tf["dequant_matmul_cuda"],
        "flash_attention_fwd": (counts_tf["flash_attention_cuda"]
                                - counts_tf["flash_attention_cuda_windowed"]),
        "flash_attention_fwd_window": counts_tf["flash_attention_cuda_windowed"],
        "dequantize_int8": counts_ssm["dequantize_int8_cuda"],
        "ssd_chunked": counts_ssm["ssd_chunked_cuda"],
        # a prefill of each LM (phase 8b)
        "flash_attention_fwd_gemma2": gemma["launches"][0] - gemma["launches"][1],
        "flash_attention_fwd_window_gemma2": gemma["launches"][1],
        "flash_attention_fwd_hd80_zamba2": zamba["launches"][0],
    }
    rows = phase_times(card, launches, errors)
    rows += train_times(card, trained)
    for r in rows:  # the SSD scan's shape is zamba2-2.7b's: its launches a prefill too
        if r["name"] == "ssd_chunked":
            r["launches_zamba2_prefill"] = zamba["launches"][2]
    if "--profile" in sys.argv[1:]:
        phase_accuracy(card)
        phase_mma_peak(card)
    for what, times in (("demo_transformer", per_request), ("demo_ssm", per_request_ssm)):
        say("serve", f"wall time per served request ({what}, 4 per microbatch): "
                     + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in times.items()))
    for arch, r in served_lm.items():
        say("lm", f"{arch}: prefill {r['prefill_s']:.3f} s, decode {r['decode_ms']:.2f} ms a step, "
                  f"peak {r['peak_bytes'] / 2**30:.2f} GiB")
    for what, r in (("llama3.2-1b", trained["llama"]), ("gemma2-27b (2 layers)", trained["gemma"]),
                    ("zamba2-2.7b", trained["zamba"]),
                    ("phi3.5-moe-42b-a6.6b (2 layers)", trained["phi"]),
                    ("kimi-k2-1t-a32b (2 layers, 32 experts)", trained["kimi"]),
                    ("pixtral-12b (8 layers)", trained["pixtral"]),
                    ("whisper-small", trained["whisper"]), ("xlstm-125m", trained["xlstm"])):
        say("train", f"{what}: {r['tokens_per_s']:.0f} tokens/s, seconds a step "
                     + ", ".join(f"{x:.3f}" for x in r["secs"]) + ", losses "
                     + ", ".join(f"{x:.4f}" for x in r["losses"])
                     + f", peak {r['peak_bytes'] / 2**30:.2f} GiB; {card}")
    if not all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows):
        fail("a kernel time is not a positive number")
    import torch

    say("done", f"chip_smoke.py ran in {time.perf_counter() - start:.0f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
