"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Marked ``gpu``: skipped (from the fixture) where ``torch.cuda.is_available()``
is False.  Run on a CUDA machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Shapes: small ragged ones, and the shapes the served path gives each kernel
(``chip_smoke.py``: demo_transformer at d=4096, H=32, KH=16, hd=128,
S=8192, and demo_ssm at d=5120, H=80, dh=N=64, S=8192, 4 requests per
microbatch).  The flash kernel also at every head dim of the LM zoo, the
flash op on bf16/f16 inputs, and a small-width LM of each family on the
card against the CPU.  This file imports no JAX: the machine with the card
has none.
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
    ssd_chunked_bwd_cuda,
    ssd_chunked_cuda,
)
from repro_torch.kernels.ssm_scan.ref import (
    ssd_backward_ref_padded,
    ssd_ref,
    ssd_ref_padded,
    ssd_ref_segmented,
)

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


# of max|plain| per gradient: the JAX package's gradient tolerance is 1e-4;
# chip_smoke.py measured 6.8e-7 at worst, so the pin is 5e-6, as there
TOL_SSD_BWD = 5e-6


def _ssd_bwd_case(cuda, b, s, h, dh, n, seed, dt_scale=1.0):
    xs, bm, cm, dt, a = _ssd_case(cuda, b, s, h, dh, n, seed)
    return xs, bm, cm, dt * dt_scale, a, _randn((b, s, h, dh), seed + 5, cuda)


def _assert_ssd_bwd(args, chunk, seed_note):
    """The backward kernel against ``ssd_backward_ref`` chunked as the kernel
    chunks (at ``KERNEL_CHUNK``, padded), all five gradients; two runs equal."""
    got = ssd_chunked_bwd_cuda(*args, chunk=chunk)
    again = ssd_chunked_bwd_cuda(*args, chunk=chunk)
    want = ssd_backward_ref_padded(*args, chunk=KERNEL_CHUNK)
    torch.cuda.synchronize()
    for name, g, c, w in zip(("dxs", "dbm", "dcm", "ddt", "da"), got, again, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), (name, seed_note)
        assert torch.equal(g, c), (name, seed_note, "two runs differ")
        assert _ssd_rel(g, w) <= TOL_SSD_BWD, (name, seed_note, _ssd_rel(g, w))


@pytest.mark.parametrize("dt_scale", [1.0, 0.01])
@pytest.mark.parametrize("b,s,h,dh,n,chunk", SSD_SHAPES)
def test_ssd_backward_matches_plain(cuda, b, s, h, dh, n, chunk, dt_scale):
    """Over the forward's shapes (ragged S, dh and N below 64 among them), at
    the plain dt and at dt / 100, where the carried states reach every
    later chunk."""
    _assert_ssd_bwd(_ssd_bwd_case(cuda, b, s, h, dh, n, 70, dt_scale), chunk, dt_scale)


@pytest.mark.parametrize("b,s,h,dh,n", [
    (1, 40, 3, 64, 64),     # S < 64: one ragged chunk
    (1, 1000, 2, 22, 37),   # dh and N < 64, not multiples of 4, ragged last chunk
    (2, 4096, 80, 64, 64),  # zamba2-2.7b's Mamba2 layer at half its training microbatch
])
def test_ssd_backward_edges(cuda, b, s, h, dh, n):
    _assert_ssd_bwd(_ssd_bwd_case(cuda, b, s, h, dh, n, 71, 0.01), s, (b, s, h, dh, n))


@pytest.mark.parametrize("b,s,h,dh,n", [
    (1, 256, 3, 64, 64),    # H = 3: one head group of 8, five heads masked
    (2, 512, 10, 64, 64),   # H = 10: a full head group and a short one
    (1, 256, 8, 64, 32),    # exactly one group
    (1, 256, 1, 64, 32),    # one head
    (1, 1000, 9, 22, 37),   # a short group over ragged chunks, dh and N not multiples of 4
])
def test_ssd_backward_head_groups(cuda, b, s, h, dh, n):
    """Head counts that are and are not a multiple of the chunk kernel's
    group of 8 heads, at dt / 100 so that every carried state and dH
    reaches every chunk."""
    _assert_ssd_bwd(_ssd_bwd_case(cuda, b, s, h, dh, n, 74, 0.01), s, (b, s, h, dh, n))


def test_ssd_backward_refuses_bad_dy(cuda):
    args = _ssd_bwd_case(cuda, 1, 128, 2, 16, 8, 75)
    with pytest.raises(ValueError, match="dy must have shape"):
        ssd_chunked_bwd_cuda(*args[:5], args[5][:, :64].contiguous(), chunk=128)
    with pytest.raises(ValueError, match="dy must be contiguous"):
        ssd_chunked_bwd_cuda(*args[:5], args[5].transpose(2, 3).contiguous().transpose(2, 3),
                             chunk=128)


def test_ssd_backward_strong_decay(cuda):
    """dt x 200 with a = (-5, -0.5) (the forward's strong-decay test): the
    masked exp above the diagonal overflows and every carried state
    underflows; every gradient finite and at the pin."""
    xs, bm, cm, dt, _, dy = _ssd_bwd_case(cuda, 1, 512, 2, 64, 16, 72)
    a = torch.tensor([-5.0, -0.5], device=xs.device)
    _assert_ssd_bwd((xs, bm, cm, dt * 200.0, a, dy), 512, "strong decay")


def test_ssd_op_gradient_through_the_kernels(cuda):
    """``ssd_chunked`` under grad on CUDA runs ``SSDScan``: one forward and
    one backward launch, and the plain gradients at the caller's chunk
    within the chunk-invariance pin."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ssm_scan.ops import ssd_chunked

    *args, dy = _ssd_bwd_case(cuda, 2, 512, 4, 64, 32, 73)
    ins = [t.clone().requires_grad_() for t in args]
    reset_launch_counts()
    y = ssd_chunked(*ins, chunk=256)
    got = torch.autograd.grad(y, ins, dy)
    counts = launch_counts()
    assert counts["ssd_chunked_cuda"] == 1 and counts["ssd_chunked_bwd_cuda"] == 1
    ref_ins = [t.detach().cpu().double().requires_grad_() for t in args]
    want = torch.autograd.grad(ssd_ref(*ref_ins, chunk=256)[0], ref_ins, dy.cpu().double())
    for g, w in zip(got, want):
        assert ((g.cpu().double() - w).abs().max() / w.abs().max()).item() <= 1e-4


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


ZOO_HEAD_DIMS = (64, 80, 112, 128, 160, 256)


@pytest.mark.parametrize("hd", ZOO_HEAD_DIMS)
@pytest.mark.parametrize("s,g,causal,window,softcap", [
    (1000, 2, True, 0, 50.0),    # causal, soft-capped GQA, ragged S
    (300, 1, True, 100, 50.0),   # a window across kv tiles
    (129, 4, False, 0, 0.0),     # non-causal, G = 4
    (65, 2, False, 17, 50.0),    # non-causal window below a tile
])
def test_flash_every_zoo_head_dim(cuda, hd, s, g, causal, window, softcap):
    """Every head dim the LM zoo's configs use (zamba2 80, kimi-k2 112,
    pixtral 160; 80 and 112 end their QK^T in a 16-wide slice) against the
    plain version at the f32 pin."""
    q, k, v = _flash_case(cuda, 2, s, 2 * g, 2, hd, 30)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)
    ref = attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("hd", [80, 128])
def test_flash_op_takes_half_inputs(cuda, dtype, hd):
    """The op upcasts bf16/f16 q, k, v to f32 (exactly), runs the kernel and
    returns q.dtype: the kernel's f32 output rounded once."""
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = (t.to(dtype) for t in _flash_case(cuda, 2, 300, 4, 2, hd, 31))
    out = flash_attention(q, k, v, causal=True, window=64, softcap=50.0)
    assert out.dtype == dtype and out.shape == q.shape
    want = flash_attention_cuda(q.float(), k.float(), v.float(), causal=True, window=64,
                                softcap=50.0)
    assert torch.equal(out, want.to(dtype))
    ref = attention_ref(q.float(), k.float(), v.float(), causal=True, window=64, softcap=50.0)
    bound = 2e-5 + torch.finfo(dtype).eps * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= bound


# one arch of each family; f32 tolerances as the CPU tests' (tests/_lm_parity.py):
# 1e-4 of max|ref|, looser where the JAX package (so the port) rounds to bf16
# inside an f32 model: the mLSTM output, the Mamba2 decode's conv window
LM_FAMILIES = ["gemma2-27b", "pixtral-12b", "whisper-small", "phi3.5-moe-42b-a6.6b",
               "xlstm-125m", "zamba2-2.7b"]
LM_F32_TOL = {("ssm", "forward"): 5e-3, ("ssm", "prefill"): 5e-3, ("ssm", "decode"): 5e-3,
              ("hybrid", "decode"): 1e-2}


def _rel(got, want) -> float:
    return ((got.float().cpu() - want.float()).abs().max() / want.float().abs().max()).item()


# xLSTM is compared in f32 only: in bf16 the reference itself is chaotic
# (one bf16 ulp of noise on its embeddings moves the JAX package's output
# by 0.81 of max|ref| at reduced(), S=16), and the card's and the CPU's bf16
# GEMMs round differently (0.099 measured); its bf16 CPU run is held to the
# JAX package at 3e-2 in tests/test_torch_lm_recurrent.py
LM_CASES = [(name, dtype) for name in LM_FAMILIES for dtype in (torch.float32, torch.bfloat16)
            if not (name == "xlstm-125m" and dtype == torch.bfloat16)]


@pytest.mark.parametrize("name,dtype", LM_CASES,
                         ids=[f"{n}-{'f32' if d == torch.float32 else 'bf16'}" for n, d in LM_CASES])
def test_small_lm_card_matches_cpu(cuda, name, dtype):
    """``reduced()`` of each family: forward_hidden, the prefill step and
    three decode steps (logits and caches) on the card against the CPU with
    the same weights and inputs; f32 within 1e-4 of max|cpu| (the families
    that round to bf16 inside, as in the CPU tests), bf16 within 3e-2."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.runtime.serve import make_prefill_step, make_serve_step

    cfg = reduced(ARCHS[name])
    base = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", max_pos=64)
    if dtype == torch.float32:
        base = tree_map(lambda t: t.float() if t.is_floating_point() else t, base)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16))}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((2, 16, cfg.d_model), dtype=np.float32) * 0.5
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((2, 4, lm.PATCH_DIM), dtype=np.float32) * 0.1
    toks = rng.integers(0, cfg.vocab_size, (3, 2, 1))
    runs = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), base)
        bt = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        bt = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in bt.items()}
        with torch.inference_mode():
            hidden, _ = lm.forward_hidden(cfg, p, bt)
            caches = lm.init_caches(cfg, 2, 32, enc_len=16, device=dev)
            steps = []
            for t in toks:
                logits, caches = lm.decode_step(cfg, p, caches, torch.as_tensor(t, device=dev),
                                                enc_len=16)
                steps.append(logits)
        prefill = make_prefill_step(cfg)(p, bt)
        nxt, _ = make_serve_step(cfg, enc_len=16)(p, caches, torch.as_tensor(toks[0], device=dev))
        assert nxt.device.type == torch.device(dev).type and nxt.dtype == torch.int32
        runs[str(dev)] = (hidden, prefill, steps, tree_leaves(dict(caches, pos=0)))
    (ch, cp, cs, cc), (gh, gp, gs, gc) = runs["cpu"], runs[str(cuda)]
    f32 = dtype == torch.float32
    tol = {step: (LM_F32_TOL.get((cfg.family, step), 1e-4) if f32 else 3e-2)
           for step in ("forward", "prefill", "decode")}
    assert gh.is_cuda and _rel(gh, ch) <= tol["forward"]
    assert _rel(gp, cp) <= tol["prefill"]
    for got, want in zip(gs, cs):
        assert _rel(got, want) <= tol["decode"]
    for got, want in zip(gc, cc):
        if isinstance(want, torch.Tensor) and want.abs().max() > 0:
            assert _rel(got, want) <= tol["decode"]


# ---------------------------------------------------------------------------
# training: the flash backward kernel, ops without a backward, a train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", ZOO_HEAD_DIMS)
@pytest.mark.parametrize("s,g,causal,window,softcap", [
    (1000, 2, True, 0, 50.0),    # causal, soft-capped GQA, ragged S
    (300, 1, True, 100, 0.0),    # a window across kv tiles
    (129, 4, False, 0, 0.0),     # non-causal, G = 4
    (65, 2, False, 17, 50.0),    # non-causal window below a tile
])
def test_flash_backward_matches_plain(cuda, hd, s, g, causal, window, softcap):
    """dq, dk, dv of the backward kernel against ``flash_backward_ref`` on
    the same residuals, each within 2e-5 of max|plain| (the JAX package's
    gradient tolerance is 1e-4; the kernel measured 4.7e-6 at worst at
    S=2048), and deterministic: a second run is equal."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_cuda
    from repro_torch.kernels.flash_attention.ref import flash_backward_ref

    q, k, v = _flash_case(cuda, 2, s, 2 * g, 2, hd, 40)
    do = _randn(q.shape, 44, cuda)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    want = flash_backward_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        assert ((a - w).abs().max() / w.abs().max()).item() <= 2e-5


def _bwd_within_pin(got, again, want, scale_floor: float = 0.0) -> None:
    """Each gradient equal to its second run and within 2e-5 of max|plain|
    (or of ``scale_floor`` where that is larger: a gradient that is 0 in
    exact math, whose plain value is rounding noise)."""
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        top = max(w.abs().max().item(), scale_floor)
        assert (a - w).abs().max().item() <= 2e-5 * top


@pytest.mark.parametrize("hd,s,g,causal,window,softcap", [
    (160, 333, 8, True, 0, 50.0),    # G = 8 where two warps share 16 keys
    (256, 333, 8, True, 0, 0.0),
    (160, 777, 8, False, 0, 0.0),
    (64, 300, 2, True, 5, 0.0),      # windows shorter than one kv tile
    (128, 300, 4, True, 7, 50.0),
    (256, 200, 2, False, 3, 0.0),
    (80, 1000, 1, True, 0, 0.0),     # S not a multiple of a kv tile (64 or 128 keys)
    (112, 1000, 1, True, 0, 50.0),
    (256, 65, 2, True, 0, 0.0),
])
def test_flash_backward_redesign_edges(cuda, hd, s, g, causal, window, softcap):
    """The one-pass backward where its design has edges: G = 8 at hd 160 and
    256 (the column-sharing warp pairs), a window shorter than one kv tile,
    S ragged against the kernel's kv tile; within 2e-5 of max|plain|, two
    runs equal."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_cuda
    from repro_torch.kernels.flash_attention.ref import flash_backward_ref

    q, k, v = _flash_case(cuda, 1, s, g, 1, hd, 70)
    do = _randn(q.shape, 74, cuda)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    _bwd_within_pin(got, again, flash_backward_ref(q, k, v, o, lse, do, **kw))


@pytest.mark.parametrize("hd", ZOO_HEAD_DIMS)
def test_flash_backward_one_token_and_back_to_back_shapes(cuda, hd):
    """S = 1 (dq and dk are 0 in exact math: held at 2e-5 of max|dv|), then
    two calls of different shapes back to back and the first again: each
    call's zeroed counters are its own, so the repeat equals the first."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_cuda
    from repro_torch.kernels.flash_attention.ref import flash_backward_ref

    runs = []
    for b, s, h, kh, causal in ((2, 1, 4, 2, True), (1, 700, 4, 1, True), (2, 300, 2, 2, False),
                                (1, 700, 4, 1, True)):
        q, k, v = _flash_case(cuda, b, s, h, kh, hd, 80 + s)
        do = _randn(q.shape, 84 + s, cuda)
        o, lse = flash_attention_cuda(q, k, v, lse=True, causal=causal)
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)
        again = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)
        want = flash_backward_ref(q, k, v, o, lse, do, causal=causal)
        _bwd_within_pin(got, again, want, want[2].abs().max().item() if s == 1 else 0.0)
        runs.append(got)
    for a, b in zip(runs[1], runs[3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hd", ZOO_HEAD_DIMS)
@pytest.mark.parametrize("s,g,causal,window,softcap,scale", [
    (1000, 2, True, 0, 50.0, 1.0),    # causal, soft-capped GQA, ragged S
    (1000, 2, True, 0, 50.0, 4.0),    # logits up to ~20: the cap bends them
    (300, 1, True, 100, 0.0, 1.0),    # a window across kv tiles
    (129, 4, False, 0, 0.0, 1.0),     # non-causal, G = 4
    (65, 2, False, 17, 50.0, 1.0),    # non-causal window below a tile
])
def test_flash_lse_and_gradient_match_independent_plain(cuda, hd, s, g, causal, window, softcap,
                                                        scale):
    """The forward's o and logsumexp (``lse=True``) against
    ``attention_ref_lse``, each within 2e-5 of max|plain|; then the backward
    kernel on the kernel's residuals against ``flash_backward_ref`` fed the
    plain o and lse, within 2e-5 of max|plain|: the whole gradient held to
    a reference that shares nothing with the kernels."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref_lse, flash_backward_ref

    q, k, v = _flash_case(cuda, 2, s, 2 * g, 2, hd, 60)
    q = q * scale
    do = _randn(q.shape, 64, cuda)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
    o_ref, lse_ref = attention_ref_lse(q, k, v, **kw)
    for a, w in ((o, o_ref), (lse, lse_ref)):
        assert ((a - w).abs().max() / w.abs().max()).item() <= 2e-5
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    want = flash_backward_ref(q, k, v, o_ref, lse_ref, do, **kw)
    for a, w in zip(got, want):
        assert ((a - w).abs().max() / w.abs().max()).item() <= 2e-5


def test_flash_backward_takes_strided_projection_slices(cuda):
    """q, k, v as slices of one fused projection, as the layers make them:
    the same gradients as from contiguous copies."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_cuda

    b, s, h, kh, hd = 2, 333, 4, 2, 64
    qkv = _randn((b, s, (h + 2 * kh) * hd), 50, cuda)
    q = qkv[..., : h * hd].view(b, s, h, hd)
    k = qkv[..., h * hd: (h + kh) * hd].view(b, s, kh, hd)
    v = qkv[..., (h + kh) * hd:].view(b, s, kh, hd)
    do = _randn((b, s, h, hd), 51, cuda)
    o, lse = flash_attention_cuda(q, k, v, lse=True, window=70, softcap=50.0)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, window=70, softcap=50.0)
    want = flash_attention_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(), o, lse, do,
                                    window=70, softcap=50.0)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_flash_op_gradient_through_the_kernels(cuda):
    """The op's autograd Function on the card: launches the forward (with
    lse) and the backward kernel once each, and gives the plain gradients."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = (t.requires_grad_() for t in _flash_case(cuda, 1, 512, 4, 2, 128, 52))
    reset_launch_counts()
    (flash_attention(q, k, v, window=100) ** 2).sum().backward()
    counts = launch_counts()
    assert counts["flash_attention_cuda"] == 1 and counts["flash_attention_bwd_cuda"] == 1
    grads = [t.grad for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (attention_ref(q, k, v, window=100) ** 2).sum().backward()
    for a, t in zip(grads, (q, k, v)):
        assert ((a - t.grad).abs().max() / t.grad.abs().max()).item() <= 1e-4


def test_ops_without_a_backward_raise_on_grad(cuda):
    """On CUDA, an op whose kernel has no backward raises where autograd
    would want a gradient through it, and runs under no_grad."""
    from repro_torch.kernels.quantize.ops import dequant_matmul, dequantize_int8, quantize_int8

    x = _randn((4, 512), 60, cuda)
    q, s = quantize_int8(x, 256)
    w = _randn((512, 64), 61, cuda)
    calls = [
        lambda grad: quantize_int8(x.clone().requires_grad_(grad), 256),
        lambda grad: dequantize_int8(q, s.clone().requires_grad_(grad), torch.float32, block=256),
        lambda grad: dequant_matmul(q, s, w.clone().requires_grad_(grad), torch.float32,
                                    block=256),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call(True)
        with torch.no_grad():
            call(True)
        call(False)


# arch, d_model (hd 64, 80, 128, 112, 160, 64 and none), and the launches of
# one step of 2 microbatches: flash forward, backward, SSD forward, backward.
# llama, phi3.5-moe, kimi-k2, pixtral: 2 layers, the forward twice (remat);
# zamba2: 12 Mamba2 layers in 6 groups, each with the shared block; whisper:
# 2 encoder layers (non-causal) and 2 decoder layers (causal, and cross at
# Sq == Skv); xlstm: no kernel of the port (the mLSTM is chunkwise in torch)
TRAIN_CASES = [("llama3.2-1b", 256, (8, 4, 0, 0)), ("zamba2-2.7b", 320, (24, 12, 48, 24)),
               ("phi3.5-moe-42b-a6.6b", 512, (8, 4, 0, 0)),
               ("kimi-k2-1t-a32b", 448, (8, 4, 0, 0)),
               ("pixtral-12b", 640, (8, 4, 0, 0)),
               ("whisper-small", 256, (24, 12, 0, 0)),
               ("xlstm-125m", 256, (0, 0, 0, 0))]
# xlstm runs in f32 only: in bf16 the reference itself is chaotic (LM_CASES)
TRAIN_RUNS = [(*case, dtype) for case in TRAIN_CASES
              for dtype in (torch.float32, torch.bfloat16)
              if not (case[0] == "xlstm-125m" and dtype == torch.bfloat16)]

# the bf16 zamba2 step's gradient leaves, card against CPU, of max|cpu|:
# the CPU's own leaves move by up to 3.98e-2 of max|ref| at this test's
# seeds (3.98e-2 to 4.99e-2 over weight seeds 0-2; 4.90e-2 and 4.59e-2 to
# 5.04e-2 before silu's backward became the logistic's JVP) when the scan
# is chunked at 64 instead of 256 (scripts/train_step_spread.py); the card
# read 3.8e-2.  Twice the reference's own spread, the largest over seeds
ZAMBA2_BF16_LEAF_TOL = 1e-1
# the bf16 MoE steps' gradient leaves, of max|cpu|: a near-tie between two
# experts in the router resolves either way once bf16 roundings upstream
# flip, a discrete change, and with capacity dispatch it moves the later
# tokens of that expert's group too.  On the CPU alone the leaves move,
# when the residual width is permuted in every param or attention's
# softmax is taken in two halves, both exact in math
# (scripts/train_step_spread.py --seeds 3, weight seeds 0-2), by up to
# 1.36e-1 of max|ref| for phi3.5-moe and 1.0e-1 for kimi-k2 (1.2e-2 at this
# test's seed, 1.0e-1 at weight seed 1): each arch's constant is twice its
# own largest.  The card's leaves read 1.32e-1 (phi) and 1.62e-1 (kimi);
# with the CPU taking the card's experts in every router call they are
# held at the bf16 tolerance (3e-2), so what the card adds is its routing
PHI35_BF16_LEAF_TOL = 2.7e-1
KIMI_BF16_LEAF_TOL = 2.0e-1
# the f32 xlstm step with the bf16 rounding of the mLSTM output lifted on
# both devices (_exact_mlstm_out; kept, that rounding makes the CPU's own
# leaves move by up to 1.14 of max|ref| under exact-in-math changes, so no
# limit below 1 could hold them).  The f32 model is still chaotic: its
# stabilizers' maxima and its normalizers' clamps break near-ties either
# way, and the sLSTM carries each flip over 2048 steps.  At this test's
# width the CPU's own leaves move by up to 2.83e-2 of max|ref| (1.9e-2 the
# median leaf) when every param moves by one f32 ulp, as the card's exp,
# log-sigmoid and tanh round otherwise than the CPU's, and by up to 6.24e-3
# when the residual width is permuted or the mLSTM chunked at 128, exact in
# math (scripts/train_step_spread.py --exact-out, weight seeds 0-1; 2.83e-2
# at this test's seed).  The leaves are held at twice the largest; loss and
# gradient norm keep 1e-4 (the gradient norm moves by 1.9e-5 under the
# exact-in-math changes)
XLSTM_F32_LEAF_TOL = 5.7e-2


def _exact_mlstm_out(cfg, p: dict, y: torch.Tensor, ogate: torch.Tensor, shape) -> torch.Tensor:
    """``models/xlstm._mlstm_out`` without its bf16 rounding."""
    from repro_torch.models import xlstm

    b, s = shape
    d_in, dh = xlstm.mlstm_dims(cfg)
    hout = y[..., :dh] / torch.clamp(y[..., dh].abs(), min=1.0)[..., None]
    return (hout.reshape(b, s, d_in) * ogate) @ p["out_proj"]


def _route_tape(moe, replay: list | None = None):
    """A stand-in for ``moe.route`` that records each call's top-k experts;
    given ``replay`` (another run's record) it takes each call's experts
    from it in call order, their probabilities renormalized as ``route``
    does.  Returns (stand-in, record)."""
    route, record = moe.route, []

    def taped(cfg, p, x):
        probs, top_p, top_e = route(cfg, p, x)
        if replay is not None:
            top_e = replay[len(record)].to(top_e.device)
            top_p = torch.gather(probs, -1, top_e)
            top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
        record.append(top_e.cpu())
        return probs, top_p, top_e

    return taped, record


def _train_batch(cfg, lm, rng, b: int, s: int) -> dict:
    """Seeded numpy tokens (+ frames (B, S, d) for audio, patches (B, 256,
    PATCH_DIM) for vlm, in f32)."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32) * 0.5
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((b, lm.PATCH_TOKENS, lm.PATCH_DIM),
                                               dtype=np.float32) * 0.1
    return batch


@pytest.mark.parametrize("arch,d_model,launches,dtype", TRAIN_RUNS,
                         ids=[f"{c[0]}-{'f32' if c[3] == torch.float32 else 'bf16'}"
                              for c in TRAIN_RUNS])
def test_small_train_step_card_matches_cpu(cuda, monkeypatch, dtype, arch, d_model, launches):
    """One AdamW step of a small model of each family: llama3.2-1b (d = 256:
    hd 64), zamba2-2.7b (d = 320: the shared block at hd 80, Mamba2 at 10
    heads of 64, N = 16), phi3.5-moe (d = 512: hd 128, 4 experts top-2),
    kimi-k2 (d = 448: hd 112), pixtral-12b (d = 640: hd 160, the flash
    backward's hd > 128 path, with patches), whisper-small (d = 256: hd 64,
    frames; non-causal encoder and cross attention) and xlstm-125m (d =
    256); S = 2048, so the flash forward and backward kernels run (and
    zamba2's SSD scan and its backward); 2 microbatches of 1; on the card
    and on the CPU from the same weights and inputs: the loss, the gradient
    norm and every accumulated gradient leaf within 1e-4 (f32) or 3e-2
    (bf16) of max|cpu|.  The updated params differ by at most 2 lr more:
    AdamW's first step moves each param by lr times the sign of its
    gradient, which flips between the two for gradients near 0.

    zamba2's bf16 gradients are chaotic: on the CPU alone they move when
    the f32 scan is only chunked at 64 instead of 256 (exact in math: its
    rounding flips bf16 roundings downstream) by about as much as the
    card's differ from the CPU's.  There each gradient leaf is held to
    ``ZAMBA2_BF16_LEAF_TOL``; loss, gradient norm and params keep 3e-2.
    The bf16 MoE steps' leaves are held to ``PHI35_BF16_LEAF_TOL`` and
    ``KIMI_BF16_LEAF_TOL`` (router near-ties), each twice the CPU's own
    spread; then the CPU takes the card's experts in every router call and
    each leaf is held at 3e-2.  xlstm runs with the bf16 rounding of its
    mLSTM output lifted on both devices, its leaves held to
    ``XLSTM_F32_LEAF_TOL``, twice the CPU's own spread then; its loss and
    gradient norm keep 1e-4."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import lm, moe, xlstm
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.runtime import train

    cfg = reduced(ARCHS[arch], d_model=d_model, vocab=512)
    if cfg.family == "ssm":
        monkeypatch.setattr(xlstm, "_mlstm_out", _exact_mlstm_out)
    base = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", max_pos=2048)
    base = tree_map(lambda t: t.to(dtype), base)
    inputs = _train_batch(cfg, lm, np.random.default_rng(3), 2, 2048)
    opt = train.OptConfig(lr=1e-3, warmup_steps=1, microbatch=1)

    def grads_on(dev, replay=None):
        # a copy on each device: the step updates its state in place, and
        # .to("cpu") of a CPU tensor would hand it base itself
        params = tree_map(lambda t: t.to(dev, copy=True), base)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
        batch = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in batch.items()}
        taped, routes = _route_tape(moe, replay)
        with monkeypatch.context() as m:
            m.setattr(moe, "route", taped)
            grads, _ = train._accumulated_grads(lambda p, b: lm.loss_fn(cfg, p, b), params,
                                                batch, 1)
        return params, batch, grads, routes

    runs, routes = {}, {}
    for dev in ("cpu", cuda):
        params, batch, grads, routes[str(dev)] = grads_on(dev)
        reset_launch_counts()
        state, metrics = train.make_train_step(cfg, opt)(train.init_state(cfg, params), batch)
        runs[str(dev)] = (metrics, tree_leaves(grads), tree_leaves(state["params"]))
        if dev != "cpu":
            counts = launch_counts()
            assert (counts["flash_attention_cuda"], counts["flash_attention_bwd_cuda"],
                    counts["ssd_chunked_cuda"], counts["ssd_chunked_bwd_cuda"]) == launches
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    (cm, cg, cp), (gm, gg, gp) = runs["cpu"], runs[str(cuda)]
    worst = max(_rel(got, want) for got, want in zip(gg, cg))
    drift = {key: abs(gm[key].item() - cm[key].item()) / abs(cm[key].item())
             for key in ("loss", "grad_norm")}
    print(f"{arch} {dtype}: card against CPU, loss {drift['loss']:.3g}, gradient norm "
          f"{drift['grad_norm']:.3g}, worst leaf {worst:.3g} of max|cpu|")
    for key in ("loss", "grad_norm"):
        assert drift[key] <= tol, (key, drift[key])
    if cfg.family == "moe" and dtype == torch.bfloat16:
        # the CPU again, each router call taking the card's experts
        card_routes = routes[str(cuda)]
        flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                    for a, b in zip(routes["cpu"], card_routes))
        *_, grads, replayed = grads_on("cpu", card_routes)
        assert len(replayed) == len(card_routes) == len(routes["cpu"])
        taking = max(_rel(got, want) for got, want in zip(gg, tree_leaves(grads)))
        print(f"{arch} bf16: card against CPU, worst leaf {worst:.3g} of max|cpu|; "
              f"{flips} tokens' top-k experts differ over {len(card_routes)} router calls; "
              f"with the CPU taking the card's experts {taking:.3g}")
        assert taking <= tol, (worst, flips, taking)
    leaf_tol = {("zamba2-2.7b", torch.bfloat16): ZAMBA2_BF16_LEAF_TOL,
                ("phi3.5-moe-42b-a6.6b", torch.bfloat16): PHI35_BF16_LEAF_TOL,
                ("kimi-k2-1t-a32b", torch.bfloat16): KIMI_BF16_LEAF_TOL,
                ("xlstm-125m", torch.float32): XLSTM_F32_LEAF_TOL}.get((arch, dtype), tol)
    for got, want in zip(gg, cg):
        assert got.is_cuda and _rel(got, want) <= leaf_tol, worst
    for got, want in zip(gp, cp):
        assert got.is_cuda and got.dtype == dtype
        diff = (got.float().cpu() - want.float()).abs().max().item()
        assert diff <= 2 * opt.lr + tol * want.float().abs().max().item()


def test_whisper_cross_length_loss_card_matches_cpu(cuda):
    """A small whisper-small (d = 256: 4 heads of 64, 2 + 2 layers) with
    2048 tokens against 1500 frames: ``loss_fn`` and its gradient in every
    leaf on the card within 1e-4 of max|cpu| (f32).  Cross attention
    (Sq != Skv) and the 1500-frame encoder take ``attention_full``; only
    the decoder's causal self-attention takes the flash kernels: 2 layers,
    the forward twice (remat), forward 4 and backward 2 launches."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.runtime import train

    cfg = reduced(ARCHS["whisper-small"], d_model=256, vocab=512)
    base = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", max_pos=2048)
    base = tree_map(lambda t: t.float(), base)
    rng = np.random.default_rng(8)
    inputs = {"tokens": rng.integers(0, cfg.vocab_size, (1, 2048), dtype=np.int32),
              "frames": rng.standard_normal((1, 1500, cfg.d_model), dtype=np.float32) * 0.5}
    runs = {}
    for dev in ("cpu", cuda):
        params = tree_map(lambda t: t.to(dev, copy=True), base)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
        reset_launch_counts()
        (loss, parts), grads = train._value_and_grad(lambda p, b: lm.loss_fn(cfg, p, b),
                                                     params, batch)
        counts = launch_counts()
        runs[str(dev)] = (loss, tree_leaves(grads))
    assert (counts["flash_attention_cuda"], counts["flash_attention_bwd_cuda"]) == (4, 2)
    (cl, cg), (gl, gg) = runs["cpu"], runs[str(cuda)]
    assert torch.isfinite(gl) and abs(gl.item() - cl.item()) <= 1e-4 * abs(cl.item())
    for got, want in zip(gg, cg):
        assert got.is_cuda and _rel(got, want) <= 1e-4

