"""The work of each kernel and of each served request, and the card's peaks.

Frozen copy of ``src/repro_torch/kernels/costs.py`` at commit f4e3f2d (the
FLOP and byte counts of the flash forward and the SSD scan, the SSD counted
at the chunk that needs the fewest operations), with ``bound_s`` taken from
``chip_smoke.py``'s ``bound_ms`` arithmetic at the same commit.  The
benchmark keeps its own copy so that a later change of the port's counts
cannot move a roofline share: a kernel's share counts the same work
whatever implements it.  Added here: the int8 codec's bytes, the fused
receive's work and the model FLOPs of one request of each demo model.

Peaks are NVIDIA's data sheet for one H100 SXM at 700 W, dense: 495e12
FLOP/s TF32 (the tensor-core rate for f32 inputs), 989e12 bf16, 3.35e12
B/s of HBM.  An f32-accurate product on the tensor cores takes 3 TF32
passes (split TF32); int8 codes times f32 weights take 2 bf16 passes.
"""

from __future__ import annotations

PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
F32_PRODUCT_S_PER_FLOP = 3 / PEAK_TF32
CODE_PRODUCT_S_PER_FLOP = 2 / PEAK_BF16


def bound_s(nbytes: float, flops: float = 0.0, s_per_flop: float = 0.0) -> float:
    """The least time of a launch: bytes over HBM against ``flops`` at
    ``s_per_flop`` (0: the work is bound by its bytes alone)."""
    return max(nbytes / HBM_BYTES_PER_S, flops * s_per_flop)


def live_pairs(s: int, *, causal: bool = True, window: int = 0) -> int:
    """Live (query, key) pairs of one (batch row, head) at sequence ``s``."""
    if not causal:
        return s * s
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_fwd_flops(b: int, s: int, h: int, hd: int, *, causal: bool = True,
                    window: int = 0) -> int:
    return 4 * hd * live_pairs(s, causal=causal, window=window) * b * h


def flash_fwd_bytes(b: int, s: int, h: int, kh: int, hd: int, *, lse: bool = False) -> int:
    """q and o (B, S, H, hd), k and v (B, S, KH, hd) in f32, and the (B, H, S)
    logsumexp where it is written."""
    return (2 * b * s * h * hd + 2 * b * s * kh * hd + (b * h * s if lse else 0)) * 4


def _chunks(s: int, q: int) -> tuple[tuple[int, int], ...]:
    """(rows, count) of the chunks of a sequence of ``s`` at chunk ``q``."""
    full, rest = divmod(s, q)
    return ((q, full), (rest, 1 if rest else 0))


def ssd_flops(b: int, s: int, h: int, dh: int, n: int, q: int) -> int:
    """FLOPs of the chunked scan at chunk q: C B^T and scores @ x over each
    chunk's lower triangle, C state^T and x^T (B decay) in full, and the
    state's decay once per chunk."""
    per_head = sum(c * (r * (r + 1) * (n + dh) + 4 * r * n * dh + n * dh)
                   for r, c in _chunks(s, q))
    return b * h * per_head


def min_flops_chunk(s: int, flops) -> int:
    """The power-of-two chunk (up to ``s``) at which ``flops(chunk)`` is
    least: the bound counts the fewest operations of any chunking."""
    return min((2 ** k for k in range(max(s, 1).bit_length())), key=flops)


def ssd_fwd_cost(b: int, s: int, h: int, dh: int, n: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one forward launch: xs, bm, cm, dt, a read and y
    written once."""
    q = min_flops_chunk(s, lambda c: ssd_flops(b, s, h, dh, n, c))
    nbytes = (2 * b * s * h * dh + 2 * b * s * n + b * s * h + h) * 4
    return ssd_flops(b, s, h, dh, n, q), nbytes


def quantize_bytes(elements: int, in_bytes: int, block: int) -> int:
    """One quantize launch: the activation read once, its int8 codes and one
    f32 scale a block written once."""
    return elements * (in_bytes + 1) + 4 * (-(-elements // block))


def dequantize_bytes(elements: int, out_bytes: int, block: int) -> int:
    """One dequantize launch: codes and scales read once, the activation
    written once."""
    return elements * (1 + out_bytes) + 4 * (-(-elements // block))


def dequant_matmul_cost(m: int, k: int, n: int, block: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one fused receive (m, k) codes @ (k, n) f32: 2 m n k,
    and the codes, scales and weight read once and the f32 product written
    once."""
    return 2 * m * n * k, m * k + 4 * m * (-(-k // block)) + 4 * k * n + 4 * m * n


def demo_ssm_request_flops(d: int, n_layers: int, seq: int, heads: int, state: int) -> int:
    """Model FLOPs of one request through ``demo_ssm``: per layer the B, C
    and dt projections (2 S d (2 N + H)) and the SSD scan at its fewest
    operations.  Elementwise work is not counted."""
    proj = 2 * seq * d * (2 * state + heads)
    scan, _ = ssd_fwd_cost(1, seq, heads, d // heads, state)
    return n_layers * (proj + scan)


def demo_transformer_request_flops(d: int, n_layers: int, seq: int, heads: int,
                                   kv_heads: int, mlp_mult: int, window: int = 0) -> int:
    """Model FLOPs of one request through ``demo_transformer``: per layer the
    fused q|k|v projection, the output projection, the two MLP products
    (2 m n k each) and causal attention over its live pairs (windowed on
    odd layers where a window is set).  Elementwise work is not counted."""
    hd = d // heads
    proj = (heads + 2 * kv_heads) * hd
    dense = 2 * seq * d * (proj + d + 2 * mlp_mult * d)
    total = 0
    for i in range(n_layers):
        win = window if (window > 0 and i % 2 == 1) else 0
        total += dense + flash_fwd_flops(1, seq, heads, hd, window=win)
    return total
