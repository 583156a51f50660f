"""The work of Zamba2's layers: the grouped SSD scan's least time and one
request's model FLOPs.

Counted here from the layer equations of ``reference/zamba2.py`` (Hugging
Face transformers' ``modeling_zamba2``), not from the program, and frozen
with the benchmark, as ``costs.py`` is: a later change of the program
cannot move the roofline share or the model FLOPs.  Peaks, chunk choice and
the flash forward's count are ``costs.py``'s.

The grouped scan (B and C in G groups, head h reading group h // (H / G))
needs C B^T once a group, not once a head: its fewest operations a chunk of
r rows are G r (r + 1) N for C B^T over the lower triangle, and per head
r (r + 1) dh for the scores times x, 4 r N dh for C state^T and x^T (B
decay), and N dh for the state's decay.  Its bytes are xs and y (B, S, H,
dh), bm and cm (B, S, G, N), dt (B, S, H) and a (H,), each once, in f32.
"""

from __future__ import annotations

from seifer_bench.lib import costs


def ssd_grouped_flops(b: int, s: int, h: int, dh: int, n: int, g: int, q: int) -> int:
    """FLOPs of the grouped scan at chunk q."""
    total = 0
    for r, count in costs._chunks(s, q):
        gram = g * r * (r + 1) * n
        per_head = r * (r + 1) * dh + 4 * r * n * dh + n * dh
        total += count * (gram + h * per_head)
    return b * total


def ssd_grouped_cost(b: int, s: int, h: int, dh: int, n: int, g: int) -> tuple[int, int]:
    """(FLOPs at the cheapest chunking, bytes) of one grouped scan launch."""
    q = costs.min_flops_chunk(s, lambda c: ssd_grouped_flops(b, s, h, dh, n, g, c))
    nbytes = (2 * b * s * h * dh + 2 * b * s * g * n + b * s * h + h) * 4
    return ssd_grouped_flops(b, s, h, dh, n, g, q), nbytes


def ssd_grouped_bound_s(b: int, s: int, h: int, dh: int, n: int, g: int) -> float:
    """The least time of one launch: its fewest FLOPs at 3 TF32 passes, or
    its bytes over HBM."""
    flops, nbytes = ssd_grouped_cost(b, s, h, dh, n, g)
    return costs.bound_s(nbytes, flops, costs.F32_PRODUCT_S_PER_FLOP)


def mixer_product_flops(m: dict) -> int:
    """A Mamba2 layer's two products for one request: [z | xBC | dt] = a W_in
    and g W_out."""
    conv_dim = m["d_in"] + 2 * m["groups"] * m["state"]
    w_in = m["d"] * (m["d_in"] + conv_dim + m["mamba_heads"])
    return 2 * m["seq"] * (w_in + m["d_in"] * m["d"])


def shared_product_flops(m: dict) -> int:
    """A hybrid layer's shared block with its adapter and linear, products
    only, for one request: q|k|v, o, gate|up, the adapter's two, down, the
    linear."""
    d, ad, f, r = m["d"], m["attn_heads"] * m["attn_head_dim"], m["ffn"], m["adapter_rank"]
    per_token = 2 * d * 3 * ad + ad * d + d * 2 * f + d * r + r * 2 * f + f * d + d * d
    return 2 * m["seq"] * per_token


def request_flops(m: dict) -> int:
    """Model FLOPs of one request through the configured layers: every
    product, the grouped scan at its fewest operations, and causal
    attention over its live pairs on each hybrid layer.  Elementwise work
    (norms, conv, gates, rotary) is not counted."""
    scan, _ = ssd_grouped_cost(1, m["seq"], m["mamba_heads"], m["d_in"] // m["mamba_heads"],
                               m["state"], m["groups"])
    mixer = mixer_product_flops(m) + scan
    attn = costs.flash_fwd_flops(1, m["seq"], m["attn_heads"], m["attn_head_dim"])
    hybrid = shared_product_flops(m) + attn
    return sum(mixer + (hybrid if t == "hybrid" else 0) for t in m["layer_types"])
