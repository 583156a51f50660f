"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Marked ``gpu``: skipped (from the fixture) where ``torch.cuda.is_available()``
is False.  Run on a CUDA machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Shapes: small ragged ones, and the shapes the served path gives each kernel
(``chip_smoke.py``: demo_transformer at d=4096, H=32, KH=16, hd=128,
S=8192, and demo_ssm at d=5120, H=80, dh=N=64, S=8192, 4 requests per
microbatch).  This file imports no JAX: the
machine with the card has none.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.execution import resolve_device
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.quantize.kernel import (
    dequant_matmul_cuda,
    dequantize_int8_cuda,
    dequantize_path,
    quantize_int8_cuda,
)
from repro_torch.kernels.quantize.ref import (
    INT8_MAX_REL_ERROR,
    dequant_matmul_ref,
    dequantize_ref,
    quantize_ref,
)
from repro_torch.kernels.ssm_scan.kernel import (
    KERNEL_CHUNK,
    default_segments,
    ssd_chunked_cuda,
)
from repro_torch.kernels.ssm_scan.ref import ssd_ref, ssd_ref_padded, ssd_ref_segmented

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")  # also pins f32 matmuls to full f32


def _randn(shape, seed, device, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32) * scale,
                           device=device)


@pytest.mark.parametrize("shape,block", [
    ((3, 300), 128), ((2, 5, 256), 256), ((7, 1000), 256), ((4, 8192, 4096), 256),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_codes_equal_plain(cuda, shape, block, dtype):
    x = _randn(shape, 0, cuda).to(dtype)
    q, s = quantize_int8_cuda(x, block)
    q_ref, s_ref = quantize_ref(x, block)
    torch.cuda.synchronize()
    assert torch.equal(q, q_ref)  # bit-identical codes
    assert torch.equal(s, s_ref)


@pytest.mark.parametrize("shape,block", [
    ((3, 300), 128),           # d % 16 != 0: the scalar path
    ((4, 4096), 256),          # demo_mlp's hop: the vector path, 4 blocks
    ((2, 8192, 4096), 256),
    ((4, 8192, 5120), 256),    # demo_ssm's hop, the served shape
    ((5, 320), 128),           # 16-aligned with a ragged last block of 64
    ((3, 48), 16),             # rows of 3 vectors: a warp's 32 span many rows
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_exact(cuda, shape, block, dtype):
    q, s = quantize_ref(_randn(shape, 1, cuda), block)
    want = "vector" if shape[-1] % 16 == 0 else "scalar"
    assert dequantize_path(q, block) == want
    out = dequantize_int8_cuda(q, s, dtype=dtype, block=block)
    torch.cuda.synchronize()
    assert torch.equal(out, dequantize_ref(q, s, dtype=dtype, block=block))


def _unaligned_copy(q: torch.Tensor) -> torch.Tensor:
    """q's codes at an odd byte offset: contiguous, not 16-byte aligned."""
    buf = torch.empty(q.numel() + 1, dtype=torch.int8, device=q.device)
    out = buf[1:].view(q.shape)
    out.copy_(q)
    return out


@pytest.mark.parametrize("shape", [(3, 320), (4, 8192, 5120)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_unaligned_codes_take_the_scalar_path(cuda, shape, dtype):
    """The same codes at an odd byte offset take the scalar path, exact;
    at the served shape it gives the vector path's bits too."""
    q, s = quantize_ref(_randn(shape, 5, cuda), 256)
    qu = _unaligned_copy(q)
    assert qu.is_contiguous() and qu.data_ptr() % 16
    assert dequantize_path(qu, 256) == "scalar" and dequantize_path(q, 256) == "vector"
    ref = dequantize_ref(q, s, dtype=dtype, block=256)
    for codes in (qu, q):
        out = dequantize_int8_cuda(codes, s, dtype=dtype, block=256)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


def test_roundtrip_bounded(cuda):
    x = _randn((64, 2048), 2, cuda)
    q, s = quantize_int8_cuda(x, 256)
    y = dequantize_int8_cuda(q, s, dtype=torch.float32)
    err = (y - x).abs().max().item() / x.abs().max().item()
    assert err <= INT8_MAX_REL_ERROR * (1 + 1e-5)


@pytest.mark.parametrize("n,d,dout,block", [
    (5, 300, 70, 128), (130, 256, 129, 256), (256, 512, 384, 256),
    (32768, 4096, 8192, 256),
])
def test_dequant_matmul_matches_plain(cuda, n, d, dout, block):
    q, s = quantize_ref(_randn((n, d), 3, cuda), block)
    w = _randn((d, dout), 4, cuda, scale=0.3)
    out = dequant_matmul_cuda(q, s, w, dtype=torch.float32, block=block)
    ref = dequant_matmul_ref(q, s, w, dtype=torch.float32, block=block)
    torch.cuda.synchronize()
    # f32 sums in another order: 1e-5 of the output's magnitude
    rel = (out - ref).abs().max().item() / ref.abs().max().item()
    assert rel <= 1e-5


@pytest.mark.parametrize("n,d,dout,block,dtype", [
    (1, 4096, 512, 256, torch.float32),    # one row
    (7, 300, 136, 128, torch.float32),     # ragged d: the last block has 44 codes
    (64, 272, 264, 256, torch.float32),    # d not a multiple of the 64-deep k tile (MM_BK)
    (130, 200, 96, 128, torch.float32),    # d % 16 != 0: staged without cp.async
    (33, 520, 130, 100, torch.float32),    # blocks that end inside an 8-deep k step
    (256, 1024, 384, 256, torch.bfloat16),  # bf16 output, cast after the f32 sum
])
def test_dequant_matmul_edges(cuda, n, d, dout, block, dtype):
    """The tensor-core receive at its ragged and odd edges, against the plain
    version at the same 1e-5 of max|plain| (bf16: one bf16 rounding more)."""
    q, s = quantize_ref(_randn((n, d), 14, cuda), block)
    w = _randn((d, dout), 15, cuda, scale=0.3)
    out = dequant_matmul_cuda(q, s, w, dtype=dtype, block=block)
    ref = dequant_matmul_ref(q, s, w, dtype=torch.float32, block=block)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (n, dout)
    rel = (out.float() - ref).abs().max().item() / ref.abs().max().item()
    assert rel <= (1e-5 if dtype == torch.float32 else 2.0**-8 + 1e-5)


def _flash_case(cuda, b, s, h, kh, hd, seed):
    q = _randn((b, s, h, hd), seed, cuda)
    k = _randn((b, s, kh, hd), seed + 1, cuda)
    v = _randn((b, s, kh, hd), seed + 2, cuda)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s,hd", [(128, 64), (100, 128), (192, 256)])
def test_flash_matches_plain(cuda, causal, window, softcap, g, s, hd):
    q, k, v = _flash_case(cuda, 2, s, 2 * g, 2, hd, 5)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)
    ref = attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-5


def test_flash_takes_strided_projection_slices(cuda):
    """q/k/v as slices of one fused projection, as demo_transformer feeds them."""
    b, s, h, kh, hd = 2, 128, 4, 2, 64
    qkv = _randn((b, s, (h + 2 * kh) * hd), 6, cuda)
    q = qkv[..., : h * hd].reshape(b, s, h, hd)
    k = qkv[..., h * hd:(h + kh) * hd].reshape(b, s, kh, hd)
    v = qkv[..., (h + kh) * hd:].reshape(b, s, kh, hd)
    out = flash_attention_cuda(q, k, v, causal=True, window=0, softcap=50.0)
    ref = attention_ref(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=True, softcap=50.0)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-5


@pytest.mark.parametrize("s,g,hd,causal,window,softcap", [
    (1, 1, 64, True, 0, 50.0),        # one query: a tile of 63 masked rows
    (7, 2, 128, True, 0, 50.0),       # S below one 8-key fragment
    (65, 4, 64, True, 17, 50.0),      # one key past two 32-key tiles (BK); window below a tile
    (65, 2, 256, False, 0, 0.0),      # hd 256, non-causal
    (1000, 2, 128, True, 32, 50.0),   # window equal to a 32-key tile
    (1000, 2, 128, True, 64, 50.0),   # window of two tiles
    (1000, 4, 64, False, 1, 50.0),    # non-causal window of one key
    (1000, 1, 256, True, 0, 50.0),
    (129, 2, 128, False, 64, 0.0),
    (200, 4, 256, True, 130, 50.0),   # a window that spans three tiles
])
def test_flash_crosses_fragment_and_pipeline_edges(cuda, s, g, hd, causal, window, softcap):
    """S off the 8-key fragments, the 32-key kv tiles and the 128-query
    (64 at hd 256) query tiles, windows below, at and above a kv tile,
    G = 1, 2, 4 and hd 64/128/256: within 2e-5 of the plain version, the f32
    pin."""
    q, k, v = _flash_case(cuda, 2, s, 2 * g, 2, hd, 20)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)
    ref = attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-5


@pytest.mark.parametrize("s,hd", [(1000, 128), (77, 256)])
def test_flash_strided_slices_ragged(cuda, s, hd):
    """Slices of a fused q|k|v projection at a ragged S: rows at the
    projection's stride, staged by cp.async straight from the slices."""
    b, h, kh = 2, 4, 2
    qkv = _randn((b, s, (h + 2 * kh) * hd), 21, cuda)
    q = qkv[..., : h * hd].reshape(b, s, h, hd)
    k = qkv[..., h * hd:(h + kh) * hd].reshape(b, s, kh, hd)
    v = qkv[..., (h + kh) * hd:].reshape(b, s, kh, hd)
    out = flash_attention_cuda(q, k, v, causal=True, window=100, softcap=50.0)
    ref = attention_ref(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=True, window=100, softcap=50.0)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-5


def _attention_f64(q, k, v, softcap):
    """Causal soft-capped attention in f64 throughout (``attention_ref``
    computes in f32 whatever its inputs)."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    qg = q.double().reshape(b, s, kh, h // kh, hd) * hd**-0.5
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg, k.double())
    logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)
    logits = logits.masked_fill(pos[:, None] < pos[None, :], float("-inf"))
    o = torch.einsum("bhgqs,bshk->bqhgk", torch.softmax(logits, -1), v.double())
    return o.reshape(b, s, h, hd)


@pytest.mark.parametrize("s", [2048, 8192])
def test_flash_large_scale_as_accurate_as_f32(cuda, s):
    """std 5, softcap 50: here f32 itself is ~5e-5 from f64, over the 2e-5
    pin, so the kernel is held to an f64 run at twice the plain f32
    version's own error (the split-TF32 products must be no less accurate
    than f32 products, whatever order the sums take), also at the served
    S, where the kernel's sum over keys is longest."""
    q = _randn((1, s, 4, 128), 22, cuda, scale=5.0)
    k = _randn((1, s, 2, 128), 23, cuda, scale=5.0)
    v = _randn((1, s, 2, 128), 24, cuda, scale=5.0)
    out = flash_attention_cuda(q, k, v, causal=True, window=0, softcap=50.0)
    plain = attention_ref(q, k, v, causal=True, softcap=50.0)
    exact = _attention_f64(q, k, v, 50.0)
    torch.cuda.synchronize()
    assert (out.double() - exact).abs().max().item() <= 2 * (plain.double() - exact).abs().max().item()


def test_flash_rejects_misaligned_rows(cuda):
    buf = _randn((1 + 64 * 2 * 64,), 25, cuda)
    q = buf[1:].reshape(1, 64, 2, 64)  # rows 4 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(q, q, q)


@pytest.mark.parametrize("window", [0, 4096])
def test_flash_main_path_shape(cuda, window):
    """B=4 (the served microbatch), S=8192, H=32, KH=16, hd=128: the plain
    version one kv-head group at a time (the full logits of all heads would
    take 34 GB)."""
    b, s, h, kh, hd = 4, 8192, 32, 16, 128
    q, k, v = _flash_case(cuda, b, s, h, kh, hd, 7)
    out = flash_attention_cuda(q, k, v, causal=True, window=window, softcap=50.0)
    g = h // kh
    worst = 0.0
    for j in range(0, kh, 4):  # 4 groups checked, spread over the heads
        ref = attention_ref(q[:, :, j * g:(j + 1) * g], k[:, :, j:j + 1],
                            v[:, :, j:j + 1], causal=True, window=window,
                            softcap=50.0)
        worst = max(worst, (out[:, :, j * g:(j + 1) * g] - ref).abs().max().item())
    assert worst <= 2e-5


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = _randn((4, 64), 8, cuda)
    with pytest.raises(TypeError):
        quantize_int8_cuda(x.to(torch.float16))
    with pytest.raises(ValueError):
        quantize_int8_cuda(x.t())  # not contiguous
    q = _randn((1, 64, 2, 32), 9, cuda)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q)  # hd=32 has no kernel


def _ssd_case(cuda, b, s, h, dh, n, seed):
    """Inputs scaled as the JAX package's own kernel test scales them."""
    xs = _randn((b, s, h, dh), seed, cuda, 0.5)
    bm = _randn((b, s, n), seed + 1, cuda, 0.5)
    cm = _randn((b, s, n), seed + 2, cuda, 0.5)
    dt = torch.nn.functional.softplus(_randn((b, s, h), seed + 3, cuda))
    a = -torch.exp(_randn((h,), seed + 4, cuda, 0.3))
    return xs, bm, cm, dt, a


SSD_SHAPES = [
    (2, 256, 4, 64, 32, 64), (1, 512, 8, 64, 64, 128), (2, 8, 2, 12, 4, 8),
    (1, 96, 3, 64, 16, 32), (2, 200, 5, 32, 64, 8), (1, 130, 80, 64, 64, 130),
    (1, 64, 80, 64, 16, 64), (2, 192, 2, 64, 64, 64),
]


def _ssd_rel(out, ref) -> float:
    return (out - ref).abs().max().item() / ref.abs().max().item()


@pytest.mark.parametrize("b,s,h,dh,n,chunk", SSD_SHAPES)
def test_ssd_matches_plain(cuda, b, s, h, dh, n, chunk):
    """Against the plain version decomposed as the kernel decomposes it
    (``ssd_ref_segmented`` at ``KERNEL_CHUNK`` and the wrapper's own
    segments), cum is bit-identical and only the products' f32 order
    differs: 1e-5 of max|plain|, the JAX package's kernel-vs-ref pin.
    Against the plain version at the caller's chunk: 1e-4, its
    chunk-invariance pin."""
    args = _ssd_case(cuda, b, s, h, dh, n, 10)
    out = ssd_chunked_cuda(*args, chunk=chunk)
    p = min(default_segments(b, s, h, out.device), -(-s // KERNEL_CHUNK))
    same = ssd_ref_segmented(*args, chunk=KERNEL_CHUNK, segments=p)
    ref, _ = ssd_ref(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _ssd_rel(out, same) <= 1e-5
    assert _ssd_rel(out, ref) <= 1e-4


@pytest.mark.parametrize("segments", [2, 3, "nc"])
@pytest.mark.parametrize("b,s,h,dh,n,chunk", SSD_SHAPES)
def test_ssd_forced_segments_match_plain(cuda, b, s, h, dh, n, chunk, segments):
    """At forced segments (clamped to the chunks there are, as the wrapper
    clamps), with dt / 100 so that the carried state reaches every later
    segment: within 1e-5 of max|plain| of ``ssd_ref_segmented``."""
    xs, bm, cm, dt, a = _ssd_case(cuda, b, s, h, dh, n, 20)
    args = (xs, bm, cm, dt * 0.01, a)
    nc = -(-s // KERNEL_CHUNK)
    p = nc if segments == "nc" else segments
    out = ssd_chunked_cuda(*args, chunk=chunk, segments=p)
    same = ssd_ref_segmented(*args, chunk=KERNEL_CHUNK, segments=min(p, nc))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _ssd_rel(out, same) <= 1e-5
    assert _ssd_rel(out, ssd_ref_padded(*args, chunk=KERNEL_CHUNK)) <= 1e-5


@pytest.mark.parametrize("b,s,h,dh,n,segments", [
    (1, 40, 3, 64, 64, 1),      # S < 64: one ragged chunk
    (2, 50, 2, 20, 12, 4),      # S < 64 asked for 4 segments: clamped to 1
    (1, 448, 4, 22, 37, 7),     # P = nc, dh and N < 64 and not multiples of 4
    (1, 1000, 2, 48, 8, 5),     # ragged last chunk in the last of 5 segments
])
def test_ssd_edges_of_the_segments(cuda, b, s, h, dh, n, segments):
    xs, bm, cm, dt, a = _ssd_case(cuda, b, s, h, dh, n, 30)
    args = (xs, bm, cm, dt * 0.01, a)
    out = ssd_chunked_cuda(*args, chunk=s, segments=segments)
    same = ssd_ref_segmented(*args, chunk=KERNEL_CHUNK,
                             segments=min(segments, -(-s // KERNEL_CHUNK)))
    torch.cuda.synchronize()
    assert _ssd_rel(out, same) <= 1e-5


def test_ssd_strong_decay_stays_finite(cuda):
    """dt x 200 (the CPU NaN test's decay): every D_p underflows to 0 and
    exp(cum_t - cum_s) overflows above the diagonal, masked before exp."""
    xs, bm, cm, dt, _ = _ssd_case(cuda, 1, 512, 2, 64, 16, 40)
    args = (xs, bm, cm, dt * 200.0, torch.tensor([-5.0, -0.5], device=xs.device))
    out = ssd_chunked_cuda(*args, chunk=512, segments=4)
    same = ssd_ref_segmented(*args, chunk=KERNEL_CHUNK, segments=4)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _ssd_rel(out, same) <= 1e-5


def test_ssd_main_path_shape(cuda):
    """demo_ssm's served layer: (4, 8192, 80, 64) x N=64 at the wrapper's
    own segments, plain version decomposed alike at chunk 64."""
    args = _ssd_case(cuda, 4, 8192, 80, 64, 64, 11)
    out = ssd_chunked_cuda(*args, chunk=8192)
    p = default_segments(4, 8192, 80, out.device)
    assert p > 1
    ref = ssd_ref_segmented(*args, chunk=KERNEL_CHUNK, segments=p)
    torch.cuda.synchronize()
    assert _ssd_rel(out, ref) <= 1e-5


def test_ssd_wrapper_refuses(cuda):
    args = _ssd_case(cuda, 1, 96, 2, 64, 16, 12)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunked_cuda(*(t.cpu() for t in args))
    with pytest.raises(TypeError):
        ssd_chunked_cuda(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="must divide"):
        ssd_chunked_cuda(*args, chunk=64)  # 96 % 64
    with pytest.raises(ValueError, match="dh and N"):
        ssd_chunked_cuda(_randn((1, 96, 1, 128), 13, cuda), *args[1:3],
                         args[3][:, :, :1].contiguous(), args[4][:1])
    for bad in (0, -1):
        with pytest.raises(ValueError, match="segments"):
            ssd_chunked_cuda(*args, chunk=96, segments=bad)


def test_replicated_demo_mlp_card_matches_cpu(cuda):
    """demo_mlp with ``replicas=2`` and int8 hops on the card (quantize and
    dequantize kernels) against the same deploy on the CPU (the plain
    versions): the same plans and routing, every request completed once as
    a CUDA tensor, outputs within INT8_MAX_REL_ERROR of max|cpu|.  Requests
    are constant activations, the family ``chip_smoke.py``'s card-vs-CPU
    phase and ``benchmarks/kernel_path.py`` use: with random ones a code
    flips at a .5 tie between the card's and the CPU's f32 sums, and the
    layers after it carry the flip past the bound (ROADMAP, queue 3)."""
    from repro_torch.api import ClusterSpec, DeploymentSpec, deploy
    from repro_torch.core.model_zoo import demo_mlp
    from repro_torch.kernels import launch_counts, reset_launch_counts

    def params(version):
        rng = np.random.default_rng(100 + version)
        return {"ws": rng.standard_normal((8, 512, 512), dtype=np.float32) * 0.05}

    served = {}
    for device in ("cuda", "cpu"):
        graph, ex = demo_mlp(d=512, device=device, params_for_version=params)
        d = deploy(DeploymentSpec(
            model=graph, executor_for_version=ex, codec="int8", seed=3, replicas=2,
            cluster=ClusterSpec(n_nodes=12, capacity_bytes=graph.total_param_bytes / 2.5,
                                seed=5), device=device))
        reset_launch_counts()
        for i in range(8):
            d.submit(torch.full((512,), 0.1 * (i + 1), device=device))
        done = d.drain()
        served[device] = (d.plan.summary(), [(r.req_id, r.replica) for r in done],
                          [r.result for r in done])
        if device == "cuda":
            counts = launch_counts()
            assert counts["quantize_int8_cuda"] and counts["dequantize_int8_cuda"]
            assert all(r.is_cuda for r in served[device][2])
    (plan, order, outs), (cplan, corder, couts) = served["cuda"], served["cpu"]
    assert plan == cplan and order == corder and {r for _, r in order} == {0, 1}
    for got, ref in zip(outs, couts):
        top = ref.abs().max().item()
        assert (got.cpu() - ref).abs().max().item() <= INT8_MAX_REL_ERROR * top
