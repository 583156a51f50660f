"""The work of each LM kernel: FLOPs and bytes of one launch, from its shapes.

One home for the counts that ``chip_smoke.py``'s bounds (PERF.md's kernel
table) and the dry run's cost counter (``launch/op_cost.py``, through each
custom op's registered cost) both read, so the two count the same work
whatever implements it:

- flash attention, forward: 4 hd FLOPs a live (query, key) pair (q k and
  p v); bytes q, k, v read and o written once (and the logsumexp, where the
  forward writes it);
- flash attention, backward: 10 hd FLOPs a live pair (S, dP, dV, dK, dQ,
  each product once); bytes q, o, dO, dq, k, v, dk, dv and the logsumexp
  once;
- the SSD scan and its backward: the product FLOPs at the chunk that needs
  the fewest (``ssd_flops`` / ``ssd_bwd_flops`` at ``min_flops_chunk``);
  bytes every input read and every output written once.

A live pair is one the mask lets through: every pair without causality,
the lower triangle with it, and with a window of w the w most recent keys.
"""

from __future__ import annotations


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


def flash_bwd_flops(b: int, s: int, h: int, hd: int, *, causal: bool = True,
                    window: int = 0) -> int:
    return 10 * hd * live_pairs(s, causal=causal, window=window) * b * h


def flash_fwd_bytes(b: int, s: int, h: int, kh: int, hd: int, *, lse: bool = False) -> int:
    """q and o (B, S, H, hd), k and v (B, S, KH, hd) in f32, and the (B, H, S)
    logsumexp where it is written."""
    return (2 * b * s * h * hd + 2 * b * s * kh * hd + (b * h * s if lse else 0)) * 4


def flash_bwd_bytes(b: int, s: int, h: int, kh: int, hd: int) -> int:
    """q, o, dO, dq; k, v, dk, dv; the logsumexp, each once, in f32."""
    return (4 * b * s * h * hd + 4 * b * s * kh * hd + b * h * s) * 4


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


def ssd_bwd_flops(b: int, s: int, h: int, dh: int, n: int, q: int) -> int:
    """Product FLOPs of the SSD backward at chunk q (ssd_backward_ref's
    formulas): per head and chunk of r rows, the lower triangles of P = dy
    x^T, of the scores' products with dy (dx) and of theirs with B and C
    (dC, dB): r (r + 1) (2 dh + 2 N); dy h, B dH^T and x dH, and the two
    state recurrences (10 r dh N); the states' decays (2 dh N).  G = C B^T
    once per (batch row, chunk): heads share it."""
    per_head = sum(c * (r * (r + 1) * (2 * dh + 2 * n) + 10 * r * dh * n + 2 * dh * n)
                   for r, c in _chunks(s, q))
    shared = sum(c * r * (r + 1) * n for r, c in _chunks(s, q))
    return b * (h * per_head + shared)


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


def ssd_bwd_cost(b: int, s: int, h: int, dh: int, n: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one backward launch: xs, dy, dxs; bm, cm, dbm, dcm;
    dt, ddt; a, da, each once."""
    q = min_flops_chunk(s, lambda c: ssd_bwd_flops(b, s, h, dh, n, c))
    nbytes = (3 * b * s * h * dh + 4 * b * s * n + 2 * b * s * h + 2 * h) * 4
    return ssd_bwd_flops(b, s, h, dh, n, q), nbytes
