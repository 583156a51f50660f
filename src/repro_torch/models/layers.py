"""Transformer building blocks: norms, rotary, MLPs, GQA attention.

The JAX package's ``models/layers.py`` in PyTorch, op for op in the same
dtypes.  Attention comes in two execution strategies here:
  * ``attention_full``   -- materializes (.., Sq, Skv) logits; used for
    sequences shorter than ``attend``'s threshold.
  * ``attention_decode`` -- one-token query against a KV cache.
``attend`` sends self-attention of 2048 tokens or more to the port's
``flash_attention`` op: the hand-written CUDA kernel for CUDA tensors (bf16
q, k, v upcast to f32 for it, exactly), ``attention_ref`` on the CPU.
Cross-length shapes take ``attention_full`` on both devices.

All softmax math is fp32; params/activations are bf16 (or f32 throughout).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (
    sharded_dims,
    dense_init,
    full,
    gelu,
    is_dtensor,
    matmul,
    silu,
)

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, gemma: bool = False, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if gemma else w.float()
    return (y * scale).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, p: dict) -> torch.Tensor:
    if cfg.norm_kind == "layernorm":
        return layernorm(x, p["w"], p["b"])
    return rmsnorm(x, p["w"], gemma=cfg.gemma_norm)


def init_norm(cfg, d: int, *, lead: tuple[int, ...] = (), device="cpu") -> dict:
    if cfg.norm_kind == "layernorm":
        return {"w": full((d,), 1.0, lead=lead, device=device),
                "b": full((d,), 0.0, lead=lead, device=device)}
    return {"w": full((d,), 0.0 if cfg.gemma_norm else 1.0, lead=lead, device=device)}


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).

    The exponent multiplies by f32(1 / half), as XLA computes the JAX
    package's ``/ half`` under jit (the served path): dividing instead moves
    the frequencies by up to 14 ulps at hd 80."""
    hd = x.shape[-1]
    half = hd // 2
    inv = torch.tensor(1.0 / half, dtype=torch.float32)
    expo = -torch.arange(0, half, dtype=torch.float32) * inv
    freqs = (theta**expo).to(x.device)
    angles = positions[..., None].float() * freqs  # (..., S, half)
    sin = torch.sin(angles)[..., None, :]  # broadcast over heads
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(cfg, gen: torch.Generator, *, lead: tuple[int, ...] = (), device="cpu") -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, (d, f), lead=lead, device=device),
            "w_up": dense_init(gen, (d, f), lead=lead, device=device),
            "w_down": dense_init(gen, (f, d), lead=lead, device=device),
        }
    return {"w_up": dense_init(gen, (d, f), lead=lead, device=device),
            "w_down": dense_init(gen, (f, d), lead=lead, device=device)}


def mlp(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_kind == "swiglu":
        h = silu(matmul(x, p["w_gate"])) * matmul(x, p["w_up"])
    elif cfg.mlp_kind == "geglu":
        h = gelu(matmul(x, p["w_gate"])) * matmul(x, p["w_up"])
    else:
        h = gelu(matmul(x, p["w_up"]))
    return matmul(h, p["w_down"])


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    causal: bool = True
    window: int = 0  # 0 = unlimited
    softcap: float = 0.0


def init_attention(cfg, gen: torch.Generator, *, lead: tuple[int, ...] = (), device="cpu") -> dict:
    d = cfg.d_model
    hq = cfg.padded_heads  # padded heads: zero wo slice -> exact at init
    p = {
        "wq": dense_init(gen, (d, hq, cfg.head_dim), lead=lead, device=device),
        "wk": dense_init(gen, (d, cfg.n_kv_heads, cfg.head_dim), lead=lead, device=device),
        "wv": dense_init(gen, (d, cfg.n_kv_heads, cfg.head_dim), lead=lead, device=device),
        "wo": dense_init(gen, (hq, cfg.head_dim, d), scale=(cfg.n_heads * cfg.head_dim) ** -0.5,
                         lead=lead, device=device),
    }
    if hq > cfg.n_heads:
        p["wo"][(slice(None),) * len(lead) + (slice(cfg.n_heads, None),)] = 0
    if cfg.qkv_bias:
        p["bq"] = full((hq, cfg.head_dim), 0.0, lead=lead, device=device)
        p["bk"] = full((cfg.n_kv_heads, cfg.head_dim), 0.0, lead=lead, device=device)
        p["bv"] = full((cfg.n_kv_heads, cfg.head_dim), 0.0, lead=lead, device=device)
    return p


def qkv_proj(cfg, p: dict, x: torch.Tensor):
    q, k, v = matmul(x, p["wq"]), matmul(x, p["wk"]), matmul(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def out_proj(p: dict, o: torch.Tensor) -> torch.Tensor:
    wo = p["wo"]
    if is_dtensor(wo) and sharded_dims(wo) & {0, 1} == {1}:
        # hd sharded, heads not: DTensor cannot flatten (H, hd) so; sum over
        # (hd, H) instead
        out = (o.transpose(-1, -2).reshape(*o.shape[:-2], -1)
               @ wo.transpose(0, 1).reshape(-1, wo.shape[-1]))
        return out.to(o.dtype)
    out = o.reshape(*o.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])
    return out.to(o.dtype)


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(logits / cap) if cap > 0 else logits


def _allowed(qpos: torch.Tensor, kpos: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """(Sq, Skv) bool: True where a query may attend to a key."""
    ok = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if spec.causal:
        ok &= qpos[:, None] >= kpos[None, :]
    if spec.window > 0:
        ok &= qpos[:, None] - kpos[None, :] < spec.window
    return ok


def _gqa_split(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, KH, G, hd)."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KH, hd).  Returns (B, Sq, H, hd)."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    qg = _gqa_split(q, kh)
    scale = hd**-0.5
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg.float() * scale, k.float())
    logits = _softcap(logits, spec.softcap)
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    logits = logits.masked_fill(~_allowed(qpos, kpos, spec), float("-inf"))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqs,bshk->bqhgk", w, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     valid: torch.Tensor, softcap: float) -> torch.Tensor:
    """One query a row against a whole cache, masked by ``valid`` (Smax,).

    As the JAX package computes it: q pre-scaled and rounded to its dtype,
    q.k products summed in f32 (the bf16 cache is upcast for the product,
    which is exact: the JAX package's ``preferred_element_type=f32``), the
    softmax weights rounded to the cache's dtype before P V, f32 sums."""
    if is_dtensor(k_cache) and not any(p.is_shard(1) for p in k_cache.placements):
        return _decode_attention_by_shard(q, k_cache, v_cache, valid, softcap)
    b, _, h, hd = q.shape
    kh = k_cache.shape[2]
    qg = (_gqa_split(q, kh).float() * hd**-0.5).to(q.dtype)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg.float(), k_cache.float())
    logits = _softcap(logits, softcap)
    logits = logits.masked_fill(~valid, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bhgqs,bshk->bqhgk", w.float(), v_cache.float())
    return o.reshape(b, 1, h, hd).to(q.dtype)


def _decode_attention_by_shard(q, k_cache, v_cache, valid, softcap: float):
    """``decode_attention`` of DTensors whose cache's sequence is whole, run
    on each rank's shards (``local_map``): q placed as the cache (batch,
    heads), so each shard's rows and GQA groups are its own.  DTensor's
    einsum would flatten the batch and heads, both sharded, which torch
    2.11 refuses."""
    from torch.distributed.tensor.experimental import local_map

    pq = list(q.placements)
    run = local_map(lambda a, k, v, m: decode_attention(a, k, v, m, softcap), out_placements=pq,
                    in_placements=(pq, list(k_cache.placements), list(v_cache.placements), None),
                    redistribute_inputs=True)
    return run(q, k_cache, v_cache, valid)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: int, spec: AttnSpec) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, Smax, KH, hd); ``cache_len`` keys valid.

    The new token's K/V are assumed already written at cache_len - 1."""
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    ok = kpos < cache_len
    if spec.window > 0:
        ok &= (cache_len - 1 - kpos) < spec.window
    return decode_attention(q, k_cache, v_cache, ok, spec.softcap)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, spec: AttnSpec, *,
           chunk_threshold: int = 2048) -> torch.Tensor:
    """Dispatch: full attention for short sequences, the flash op for long
    self-attention.

    The flash kernel takes Sq == Skv only, as the JAX package's Pallas
    kernel does; cross-length shapes (whisper's decoder against an encoder
    of another length) take ``attention_full`` on every device, as the JAX
    op sends them to its dense reference when no block divides both
    lengths.  Its (B, H, Sq, Skv) f32 logits are the memory that costs."""
    if q.shape[1] >= chunk_threshold and q.shape[1] == k.shape[1]:
        return flash_attention(q, k, v, causal=spec.causal, window=spec.window,
                               softcap=spec.softcap)
    return attention_full(q, k, v, spec)
