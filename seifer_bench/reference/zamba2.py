"""Plain PyTorch forward pass of Zamba2's layers, hop by hop.

Written from the layer equations of Hugging Face transformers'
``modeling_zamba2`` (``Zamba2MambaDecoderLayer``, ``Zamba2HybridLayer``,
``Zamba2AttentionDecoderLayer``, ``Zamba2MambaMixer``'s torch path,
``Zamba2RMSNormGated``, ``Zamba2MLP`` with its adapters), not from the
program; it imports nothing of ``repro_torch``.  The benchmark hands the
same weights and inputs to the program and to this reference.

The activation is [h | x0] (n, S, 2 d): the residual stream and the
embedding output, which every hybrid layer reads and no layer changes.  A
layer of kind ``"hybrid"`` (its k-th hybrid layer, counting the
configuration's ``hybrid_offset`` before it, uses shared block k mod
``mem_blocks``, and its own adapter and linear) first computes

    c = RMSNorm([h | x0]); q, k, v = c W_qkv, rotary on q and k over the
    whole head (theta ``rope_theta``, positions 0..S-1, rotate-half);
    o = causal softmax(q k^T (hd / 2)^-0.5) v; m = RMSNorm(o W_o);
    [gate | up] = m W_gu + (m A) B; t = ((gelu_erf(gate) up) W_down) W_lin

and every layer then runs its Mamba2 mixer on h + t (t = 0 on a Mamba2
layer), the residual h taken before t is added:

    [z | xBC | dt] = RMSNorm(h + t) W_in; xBC = silu(depthwise causal conv
    (K taps) + b); [x | B | C]; dt = softplus(dt + dt_bias); A = -exp(A_log);
    y = SSD scan, head j reading group j // (H / G) of B and C, + D x;
    h' = h + RMSNorm over each of the G groups of d_in / G channels of
    (y silu(z)) times norm_w, then W_out.

Every norm is RMSNorm at ``eps`` times its weight.  The scan is
``models.ssd_scan`` run once a group over that group's heads (chunked at 64
rows); attention is computed a few heads at a time; the conv is
``torch.nn.functional.conv1d``.  ``stage`` runs one stage's layers;
``forward`` runs every stage, the whole [h | x0] int8 round-tripped
(``int8.round_trip``) between consecutive ones.  ``precision`` is
``models.py``'s: ``"f32"`` (TF32 off) or the ``"tf32"`` control.  The
rotary angles are computed in f64 and rounded to f32 once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from seifer_bench.reference.int8 import round_trip
from seifer_bench.reference.models import mm, precision_scope, ssd_scan

ATTN_HEAD_BLOCK = 4  # heads whose (S, S) logits are held at once


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rotary_tables(seq: int, hd: int, theta: float, device):
    """cos and sin (S, hd) of rotate-half rotary embeddings."""
    freq = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64, device=device) / hd)
    ang = torch.arange(seq, dtype=torch.float64, device=device)[:, None] * freq[None]
    ang = torch.cat([ang, ang], -1)
    return ang.cos().float(), ang.sin().float()


def rotate(x, cos, sin):
    """x (n, S, H, hd) rotated at each position."""
    half = x.shape[-1] // 2
    turned = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos[:, None] + turned * sin[:, None]


def attention(q, k, v, scale: float, precision: str):
    """Causal softmax attention over q, k, v (n, S, H, hd), a few heads at a
    time."""
    n, s, h, hd = q.shape
    pos = torch.arange(s, device=q.device)
    masked = pos[None, :] > pos[:, None]
    out = torch.empty_like(q)
    for r in range(n):
        for h0 in range(0, h, ATTN_HEAD_BLOCK):
            hs = slice(h0, min(h, h0 + ATTN_HEAD_BLOCK))
            qb, kb, vb = (t[r, :, hs].transpose(0, 1) for t in (q, k, v))
            logits = mm(qb, kb.transpose(-1, -2), precision) * scale
            probs = torch.softmax(logits.masked_fill(masked, float("-inf")), dim=-1)
            out[r, :, hs] = mm(probs, vb, precision).transpose(0, 1)
            del logits, probs
    return out


def shared_block(m: dict, w: dict, hx, j: int, k: int, precision: str):
    """t of the hybrid layer whose block is j and whose own weights are the
    k-th hybrid layer's, over [h | x0] (n, S, 2 d)."""
    n, s, _ = hx.shape
    heads, hd, f, eps = m["attn_heads"], m["attn_head_dim"], m["ffn"], m["eps"]
    c = rms_norm(hx, w["attn_norm"][j], eps)
    qkv = mm(c, w["wqkv"][j], precision).reshape(n, s, 3, heads, hd)
    cos, sin = rotary_tables(s, hd, m["rope_theta"], hx.device)
    q, kk = rotate(qkv[:, :, 0], cos, sin), rotate(qkv[:, :, 1], cos, sin)
    o = attention(q, kk, qkv[:, :, 2], (hd / 2) ** -0.5, precision)
    mid = rms_norm(mm(o.reshape(n, s, heads * hd), w["wo"][j], precision), w["ffn_norm"][j], eps)
    gu = mm(mid, w["w_gu"][j], precision) + mm(mm(mid, w["adapter_a"][k], precision),
                                               w["adapter_b"][k], precision)
    act = F.gelu(gu[..., :f]) * gu[..., f:]
    return mm(mm(act, w["w_down"][j], precision), w["w_lin"][k], precision)


def mixer(m: dict, w: dict, h, t, i: int, precision: str):
    """Mamba2 layer i over h (n, S, d), its input h + t."""
    n, s, d = h.shape
    d_in, heads, g, ns, eps = m["d_in"], m["mamba_heads"], m["groups"], m["state"], m["eps"]
    conv_dim = d_in + 2 * g * ns
    a = rms_norm(h if t is None else h + t, w["in_norm"][i], eps)
    proj = mm(a, w["in_proj"][i], precision)
    z, xbc, dt = proj[..., :d_in], proj[..., d_in:d_in + conv_dim], proj[..., d_in + conv_dim:]
    taps = w["conv_w"][i].shape[0]
    conv = F.conv1d(F.pad(xbc.transpose(1, 2), (taps - 1, 0)), w["conv_w"][i].t()[:, None, :],
                    w["conv_b"][i], groups=conv_dim)
    xbc = F.silu(conv.transpose(1, 2))
    x = xbc[..., :d_in].reshape(n, s, heads, d_in // heads)
    bm = xbc[..., d_in:d_in + g * ns].reshape(n, s, g, ns)
    cm = xbc[..., d_in + g * ns:].reshape(n, s, g, ns)
    dt = F.softplus(dt + w["dt_bias"][i])
    a_h = -torch.exp(w["A_log"][i])
    per = heads // g
    y = torch.cat([ssd_scan(x[:, :, q * per:(q + 1) * per], bm[:, :, q].contiguous(),
                            cm[:, :, q].contiguous(), dt[:, :, q * per:(q + 1) * per],
                            a_h[q * per:(q + 1) * per], precision) for q in range(g)], 2)
    y = y + x * w["D"][i][:, None]
    gated = (y.reshape(n, s, d_in) * F.silu(z)).reshape(n, s, g, d_in // g)
    gated = (gated * torch.rsqrt(gated.square().mean(-1, keepdim=True) + eps)).reshape(n, s, d_in)
    return h + mm(gated * w["norm_w"][i], w["out_proj"][i], precision)


def stage(m: dict, w: dict, x, first: int, stop: int, precision: str = "f32"):
    """x = [h | x0] (n, S, 2 d) through layers [first, stop) of the
    configuration's ``model`` entry ``m``."""
    d = m["d"]
    hybrid = [i for i, kind in enumerate(m["layer_types"]) if kind == "hybrid"]
    with precision_scope(precision), torch.no_grad():
        for i in range(first, stop):
            t = None
            if i in hybrid:
                k = hybrid.index(i)
                t = shared_block(m, w, x, (m["hybrid_offset"] + k) % m["mem_blocks"], k,
                                 precision)
            x = torch.cat([mixer(m, w, x[..., :d], t, i, precision), x[..., d:]], -1)
    return x


def forward(m: dict, w: dict, x, stages, block: int, precision: str = "f32"):
    """x = [h | x0] (n, S, 2 d) through every stage (``stages``: each
    stage's [first, stop) layers), int8 round-tripped at ``block`` between
    consecutive stages."""
    for j, (first, stop) in enumerate(stages):
        if j:
            x = round_trip(x, block)
        x = stage(m, w, x, first, stop, precision)
    return x
