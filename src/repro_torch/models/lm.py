"""Generic LM assembly for every assigned architecture family.

The JAX package's ``models/lm.py`` (forward and decode) in PyTorch.  One
functional model covering:
  * dense / vlm / moe decoder-only transformers (GQA, RoPE, local+global
    alternation, logit softcaps, QKV bias, GeGLU/SwiGLU, tied embeddings),
  * audio enc-dec (whisper: learned positions, cross-attention, stubbed
    conv frontend -- precomputed frame embeddings),
  * ssm (xLSTM: sLSTM + mLSTM groups),
  * hybrid (zamba2: Mamba2 towers + one shared attention block applied
    every ``attn_every`` layers).

Group params stay stacked on a leading axis, as the JAX package lays them
out for ``lax.scan``; the scan is a loop over the group index here, each
group a view of the stacked tensors.  Training: ``loss_fn`` (next-token
cross entropy through ``chunked_xent``, which never keeps more than one
chunk's (B, 512, V) f32 logits alive, plus the MoE aux loss), with every
layer group rematerialized (``torch.utils.checkpoint``) as the JAX package's
``jax.checkpoint`` does.

Decode steps carry an explicit cache tree (KV ring buffers for sliding-
window layers, recurrent states for ssm/hybrid) and are O(1) in sequence
length for the sub-quadratic families.  ``decode_step`` updates the cache
tensors IN PLACE (the JAX package returns new arrays) and returns the same
tree with ``pos`` advanced; ``pos`` is a Python int, so the cache slot is
known on the host without a device sync.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.execution import resolve_device
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.common import (
    NO_SHARDING,
    dense_init,
    embed_init,
    full,
    tree_index,
    tree_map,
)
from repro_torch.models.layers import (
    AttnSpec,
    apply_norm,
    attend,
    attention_decode,
    decode_attention,
    init_attention,
    init_mlp,
    init_norm,
    mlp,
    out_proj,
    qkv_proj,
    rope,
)

PATCH_TOKENS = 256  # vlm: patch embeddings occupy the first positions
PATCH_DIM = 1024  # vlm: precomputed patch-embedding width
XENT_CHUNK = 512  # tokens per chunk in the chunked cross-entropy


# ---------------------------------------------------------------------------
# Group structure
# ---------------------------------------------------------------------------


def group_layout(cfg) -> tuple[int, int]:
    """(n_groups, layers_per_group) of the stacked layers."""
    if cfg.family == "ssm":
        per = max(cfg.slstm_every, 1)
        return cfg.n_layers // per, per
    if cfg.family == "hybrid":
        per = max(cfg.attn_every, 1)
        return cfg.n_layers // per, per
    if cfg.local_global:
        return cfg.n_layers // 2, 2
    return cfg.n_layers, 1


def _attn_spec(cfg, *, local: bool, causal: bool = True) -> AttnSpec:
    window = cfg.sliding_window if local else 0
    return AttnSpec(causal=causal, window=window, softcap=cfg.attn_softcap)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def _init_block(cfg, gen, lead, device, *, cross: bool = False) -> dict:
    kw = dict(lead=lead, device=device)
    p = {
        "ln1": init_norm(cfg, cfg.d_model, **kw),
        "attn": init_attention(cfg, gen, **kw),
        "ln2": init_norm(cfg, cfg.d_model, **kw),
    }
    p["mlp"] = moe_lib.init_moe(cfg, gen, **kw) if cfg.is_moe else init_mlp(cfg, gen, **kw)
    if cfg.post_norm:
        p["post1"] = init_norm(cfg, cfg.d_model, **kw)
        p["post2"] = init_norm(cfg, cfg.d_model, **kw)
    if cross:
        p["ln_cross"] = init_norm(cfg, cfg.d_model, **kw)
        p["cross"] = init_attention(cfg, gen, **kw)
    return p


def _init_group(cfg, gen, lead, device) -> dict:
    if cfg.family == "ssm":
        per = max(cfg.slstm_every, 1)
        inner = lead + (max(per - 1, 1),)
        return {
            "slstm_ln": init_norm(cfg, cfg.d_model, lead=lead, device=device),
            "slstm": xlstm_lib.init_slstm(cfg, gen, lead=lead, device=device),
            "mlstm_ln": init_norm(cfg, cfg.d_model, lead=inner, device=device),
            "mlstm": xlstm_lib.init_mlstm(cfg, gen, lead=inner, device=device),
        }
    if cfg.family == "hybrid":
        inner = lead + (max(cfg.attn_every, 1),)
        return {
            "mamba_ln": init_norm(cfg, cfg.d_model, lead=inner, device=device),
            "mamba": ssm_lib.init_mamba(cfg, gen, lead=inner, device=device),
        }
    if cfg.local_global:
        return {"local": _init_block(cfg, gen, lead, device),
                "global": _init_block(cfg, gen, lead, device)}
    return _init_block(cfg, gen, lead, device, cross=cfg.family == "audio")


def init_params(cfg, generator: torch.Generator, *, device: str | torch.device = "cuda",
                max_pos: int = 32768) -> dict:
    """Random params of ``cfg`` on ``device``, drawn from ``generator`` (which
    must live on that device), in the JAX package's tree, shapes and dtypes.
    Values are drawn one layer at a time in f32 and cast, so a full-width
    model needs its own bytes plus one layer's f32 tensor."""
    dev = resolve_device(device)
    n_groups, _ = group_layout(cfg)
    params: dict[str, Any] = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, device=dev),
        "final_norm": init_norm(cfg, cfg.d_model, device=dev),
        "blocks": _init_group(cfg, generator, (n_groups,), dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size), device=dev)
    if cfg.family == "vlm":
        params["patch_proj"] = dense_init(generator, (PATCH_DIM, cfg.d_model), device=dev)
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_block(cfg, generator, (), dev)
    if cfg.family == "audio":
        params["encoder"] = {
            "blocks": _init_block(cfg, generator, (cfg.encoder_layers,), dev),
            "final_norm": init_norm(cfg, cfg.d_model, device=dev),
            "pos": dense_init(generator, (max_pos, cfg.d_model), scale=0.02, device=dev),
        }
        params["dec_pos"] = dense_init(generator, (max_pos, cfg.d_model), scale=0.02, device=dev)
    return params


# ---------------------------------------------------------------------------
# Forward blocks (full-sequence: train / prefill)
# ---------------------------------------------------------------------------


def _attn_sublayer(cfg, p, x, spec: AttnSpec, positions, *, kv_x=None, policy=NO_SHARDING):
    h = apply_norm(cfg, x, p["ln1" if kv_x is None else "ln_cross"])
    ap = p["attn"] if kv_x is None else p["cross"]
    if kv_x is None:
        q, k, v = qkv_proj(cfg, ap, h)
        if cfg.pos_emb == "rope":
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
    else:  # cross-attn keys from the raw encoder output
        q, _, _ = qkv_proj(cfg, ap, h)
        _, k, v = qkv_proj(cfg, ap, kv_x)
    q, k, v = policy.act(q, "attn_q"), policy.act(k, "attn_kv"), policy.act(v, "attn_kv")
    o = out_proj(ap, attend(q, k, v, spec))
    if cfg.post_norm and kv_x is None:
        o = apply_norm(cfg, o, p["post1"])
    return x + o


def _mlp_sublayer(cfg, p, x, *, policy=NO_SHARDING):
    h = apply_norm(cfg, x, p["ln2"])
    if cfg.is_moe:
        o, aux = moe_lib.moe_mlp(cfg, p["mlp"], h)
    else:
        o, aux = mlp(cfg, p["mlp"], h), 0.0
    o = policy.act(o, "mlp_out")
    if cfg.post_norm:
        o = apply_norm(cfg, o, p["post2"])
    return x + o, aux


def _transformer_block(cfg, p, x, spec, positions, policy, *, enc_out=None):
    x = _attn_sublayer(cfg, p, x, spec, positions, policy=policy)
    if enc_out is not None:
        x = _attn_sublayer(cfg, p, x, AttnSpec(causal=False), positions, kv_x=enc_out,
                           policy=policy)
    return _mlp_sublayer(cfg, p, x, policy=policy)


def _group_forward(cfg, gp, x, positions, policy, *, enc_out=None):
    """Run one layer-group (full sequence).  Returns (x, aux_loss)."""
    if cfg.family == "ssm":
        x = x + xlstm_lib.slstm_forward(cfg, gp["slstm"], apply_norm(cfg, x, gp["slstm_ln"]))
        for i in range(gp["mlstm_ln"]["w"].shape[0]):
            x = x + xlstm_lib.mlstm_forward(cfg, tree_index(gp["mlstm"], i),
                                            apply_norm(cfg, x, tree_index(gp["mlstm_ln"], i)))
        return x, 0.0
    if cfg.family == "hybrid":
        for i in range(gp["mamba_ln"]["w"].shape[0]):
            x = x + ssm_lib.mamba_forward(cfg, tree_index(gp["mamba"], i),
                                          apply_norm(cfg, x, tree_index(gp["mamba_ln"], i)))
        return x, 0.0  # shared attention applied by the caller
    if cfg.local_global:
        x, a1 = _transformer_block(cfg, gp["local"], x, _attn_spec(cfg, local=True), positions,
                                   policy)
        x, a2 = _transformer_block(cfg, gp["global"], x, _attn_spec(cfg, local=False),
                                   positions, policy)
        return x, a1 + a2
    return _transformer_block(cfg, gp, x, _attn_spec(cfg, local=False), positions, policy,
                              enc_out=enc_out)


def _gemma_scale(cfg, x: torch.Tensor) -> torch.Tensor:
    """x * sqrt(d) with the scale rounded to x's dtype first, as the JAX
    package rounds it (68.0 for 67.88 at d = 4608 in bf16)."""
    return x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)


def embed_inputs(cfg, params, batch) -> torch.Tensor:
    """Token (+patch) embedding.  Returns (B, S, d)."""
    if cfg.family == "audio":
        raise ValueError("audio uses encode()/decoder paths")
    x = params["embed"][batch["tokens"]]  # (B,S,d)
    if cfg.gemma_norm:
        x = _gemma_scale(cfg, x)
    if cfg.family == "vlm" and "patches" in batch:
        patches, proj = batch["patches"], params["patch_proj"]
        p_tok = patches.shape[1]  # patches occupy the first positions
        dt = torch.promote_types(patches.dtype, proj.dtype)
        pe = patches.to(dt) @ proj.to(dt)
        x = torch.cat([pe.to(x.dtype), x[:, p_tok:]], dim=1)
    return x


def _positions(s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :]


def _maybe_remat(fn, remat: bool):
    """``fn`` recomputed in the backward pass when ``remat`` (the JAX
    package's ``jax.checkpoint``): only its inputs are kept."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def forward_hidden(cfg, params, batch, *, policy=NO_SHARDING, remat: bool = False):
    """Full-sequence forward to final hidden states.  Returns (h, aux).

    ``remat`` recomputes each layer group (for hybrid archs, with its
    shared-block application) in the backward pass."""
    if cfg.family == "audio":
        return _audio_forward(cfg, params, batch, policy=policy, remat=remat)
    x = embed_inputs(cfg, params, batch)
    positions = _positions(x.shape[1], x.device)
    shared = params.get("shared_attn")

    def group_fn(x, gp):
        x, aux = _group_forward(cfg, gp, x, positions, policy)
        if shared is not None:
            x, aux2 = _transformer_block(cfg, shared, x, _attn_spec(cfg, local=False), positions,
                                         policy)
            aux = aux + aux2
        return x, aux

    group_fn = _maybe_remat(group_fn, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_groups, _ = group_layout(cfg)
    for gi in range(n_groups):
        x, a = group_fn(x, tree_index(params["blocks"], gi))
        aux = aux + a
    x = apply_norm(cfg, x, params["final_norm"])
    return policy.act(x, "final_hidden"), aux


def encode(cfg, params, frames: torch.Tensor, *, policy=NO_SHARDING,
           remat: bool = False) -> torch.Tensor:
    """Whisper encoder: frames (B, S, d) -> (B, S, d)."""
    enc = params["encoder"]
    s = frames.shape[1]
    x = frames + enc["pos"][:s][None]
    spec = AttnSpec(causal=False)
    positions = _positions(s, x.device)
    block_fn = _maybe_remat(
        lambda bp, x: _transformer_block(cfg, bp, x, spec, positions, policy)[0], remat)
    for i in range(cfg.encoder_layers):
        x = block_fn(tree_index(enc["blocks"], i), x)
    return apply_norm(cfg, x, enc["final_norm"])


def _audio_forward(cfg, params, batch, *, policy=NO_SHARDING, remat: bool = False):
    enc_out = encode(cfg, params, batch["frames"], policy=policy, remat=remat)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = params["embed"][tokens] + params["dec_pos"][:s][None]
    positions = _positions(s, x.device)
    block_fn = _maybe_remat(
        lambda bp, x, enc_out: _group_forward(cfg, bp, x, positions, policy,
                                              enc_out=enc_out)[0], remat)
    n_groups, _ = group_layout(cfg)
    for gi in range(n_groups):
        x = block_fn(tree_index(params["blocks"], gi), x, enc_out)
    x = apply_norm(cfg, x, params["final_norm"])
    return policy.act(x, "final_hidden"), torch.zeros((), dtype=torch.float32, device=x.device)


def lm_head_matrix(cfg, params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def final_logits(cfg, params, x: torch.Tensor) -> torch.Tensor:
    """Vocabulary logits of hidden states x (..., d): the product in x's
    dtype (as the JAX package's einsum), then f32 and the final softcap."""
    return _softcapped_logits(cfg, x, lm_head_matrix(cfg, params))


def _softcapped_logits(cfg, x: torch.Tensor, w: torch.Tensor, policy=NO_SHARDING) -> torch.Tensor:
    logits = policy.act((x @ w).float(), "logits")
    if cfg.final_softcap > 0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


# ---------------------------------------------------------------------------
# Chunked cross-entropy (never keeps more than one chunk's (B, c, V) logits)
# ---------------------------------------------------------------------------


def chunked_xent(cfg, params, hidden: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                 *, chunk: int = XENT_CHUNK, policy=NO_SHARDING) -> torch.Tensor:
    """Mean next-token cross entropy.  hidden (B,S,d); labels/mask (B,S).

    The JAX package's scan over chunks of ``chunk`` tokens (the whole
    sequence when ``chunk`` does not divide it), summed in the same order.
    Each chunk is rematerialized, so its f32 logits live only while the
    chunk runs, in the forward and again in the backward pass."""
    w = lm_head_matrix(cfg, params)  # (d, V)
    b, s, _ = hidden.shape
    c = min(chunk, s)
    if s % c:
        c = s

    def chunk_nll(h, w, y, m):
        logits = _softcapped_logits(cfg, h, w, policy)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y[..., None])[..., 0]
        return ((lse - gold) * m).sum()

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, c):
        m = mask[:, lo:lo + c]
        tot = tot + checkpoint(chunk_nll, hidden[:, lo:lo + c], w, labels[:, lo:lo + c], m,
                               use_reentrant=False, preserve_rng_state=False)
        cnt = cnt + m.sum()
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(cfg, params, batch, *, policy=NO_SHARDING, aux_weight: float = 0.01):
    """Next-token LM loss over the batch (every layer group rematerialized);
    adds the MoE aux loss.  Returns (loss, {"xent", "aux"})."""
    hidden, aux = forward_hidden(cfg, params, batch, policy=policy, remat=True)
    tokens = batch["tokens"]
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).long()
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    if cfg.family == "vlm" and "patches" in batch:
        mask[:, : batch["patches"].shape[1] - 1] = 0.0
    loss = chunked_xent(cfg, params, hidden, labels, mask, policy=policy)
    return loss + aux_weight * aux, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def _kv_cache(cfg, batch: int, length: int, lead, device) -> dict:
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": full(shape, 0.0, lead=lead, device=device),
            "v": full(shape, 0.0, lead=lead, device=device)}


def _group_cache(cfg, batch: int, max_len: int, lead, device) -> dict:
    if cfg.family == "ssm":
        per = max(cfg.slstm_every, 1)
        return {
            "slstm": xlstm_lib.slstm_init_state(cfg, batch, lead=lead, device=device),
            "mlstm": xlstm_lib.mlstm_init_cache(cfg, batch, lead=lead + (max(per - 1, 1),),
                                                device=device),
        }
    if cfg.family == "hybrid":
        per = max(cfg.attn_every, 1)
        return {
            "mamba": ssm_lib.mamba_init_cache(cfg, batch, lead=lead + (per,), device=device),
            "shared_kv": _kv_cache(cfg, batch, max_len, lead, device),
        }
    if cfg.local_global:
        return {
            "local": _kv_cache(cfg, batch, min(cfg.sliding_window, max_len), lead, device),
            "global": _kv_cache(cfg, batch, max_len, lead, device),
        }
    return {"kv": _kv_cache(cfg, batch, max_len, lead, device)}


def init_caches(cfg, batch: int, max_len: int, *, enc_len: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """Zeroed decode caches on ``device``; ``pos`` (the next position) 0."""
    dev = resolve_device(device)
    n_groups, _ = group_layout(cfg)
    caches: dict[str, Any] = {
        "pos": 0,
        "blocks": _group_cache(cfg, batch, max_len, (n_groups,), dev),
    }
    if cfg.family == "audio":
        caches["cross"] = _kv_cache(cfg, batch, enc_len or max_len, (n_groups,), dev)
    return caches


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------


def _attn_decode_sub(cfg, p, cache, x, pos: int, *, local: bool):
    """One-token attention vs a (ring or linear) KV cache, written in place."""
    h = apply_norm(cfg, x, p["ln1"])
    q, k, v = qkv_proj(cfg, p["attn"], h)  # (B,1,H,hd)/(B,1,KH,hd)
    if cfg.pos_emb == "rope":
        at = torch.tensor([[pos]], device=x.device)
        q = rope(q, at, cfg.rope_theta)
        k = rope(k, at, cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    length = kc.shape[1]
    # lax.dynamic_update_slice clamps the start: the JAX package's slot
    slot = pos % length if local else min(pos, length - 1)
    kc[:, slot] = k[:, 0].to(kc.dtype)
    vc[:, slot] = v[:, 0].to(vc.dtype)
    if local:
        # ring buffer: every written slot is within the window by construction
        valid = torch.arange(length, device=x.device) <= min(pos, length - 1)
        o = decode_attention(q, kc, vc, valid, cfg.attn_softcap)
    else:
        o = attention_decode(q, kc, vc, pos + 1, AttnSpec(causal=True, softcap=cfg.attn_softcap))
    o = out_proj(p["attn"], o)
    if cfg.post_norm:
        o = apply_norm(cfg, o, p["post1"])
    return x + o


def _cross_decode_sub(cfg, p, cross_cache, x, enc_len: int):
    h = apply_norm(cfg, x, p["ln_cross"])
    q, _, _ = qkv_proj(cfg, p["cross"], h)
    valid = torch.arange(cross_cache["k"].shape[1], device=x.device) < enc_len
    o = decode_attention(q, cross_cache["k"], cross_cache["v"], valid, 0.0)
    return x + out_proj(p["cross"], o)


def _block_decode(cfg, p, cache, x, pos, *, local: bool, cross_cache=None, enc_len=0):
    x = _attn_decode_sub(cfg, p, cache, x, pos, local=local)
    if cross_cache is not None:
        x = _cross_decode_sub(cfg, p, cross_cache, x, enc_len)
    return _mlp_sublayer(cfg, p, x)[0]


def _copy_into(dst, src) -> None:
    tree_map(lambda d, s: d.copy_(s), dst, src)


def _group_decode(cfg, params, gp, gc, x, pos, *, cross=None, enc_len=0):
    """Decode one group, updating its cache views in place.  Returns x."""
    if cfg.family == "ssm":
        st, y = xlstm_lib.slstm_step(cfg, gp["slstm"], gc["slstm"],
                                     apply_norm(cfg, x, gp["slstm_ln"]))
        _copy_into(gc["slstm"], st)
        x = x + y
        for i in range(gp["mlstm_ln"]["w"].shape[0]):
            mc = tree_index(gc["mlstm"], i)
            new, y = xlstm_lib.mlstm_step(cfg, tree_index(gp["mlstm"], i), mc,
                                          apply_norm(cfg, x, tree_index(gp["mlstm_ln"], i)))
            _copy_into(mc, new)
            x = x + y
        return x
    if cfg.family == "hybrid":
        for i in range(gp["mamba_ln"]["w"].shape[0]):
            mc = tree_index(gc["mamba"], i)
            new, y = ssm_lib.mamba_step(cfg, tree_index(gp["mamba"], i), mc,
                                        apply_norm(cfg, x, tree_index(gp["mamba_ln"], i)))
            _copy_into(mc, new)
            x = x + y
        return _block_decode(cfg, params["shared_attn"], gc["shared_kv"], x, pos, local=False)
    if cfg.local_global:
        x = _block_decode(cfg, gp["local"], gc["local"], x, pos, local=True)
        return _block_decode(cfg, gp["global"], gc["global"], x, pos, local=False)
    return _block_decode(cfg, gp, gc["kv"], x, pos, local=False, cross_cache=cross,
                         enc_len=enc_len)


def decode_step(cfg, params, caches, tokens: torch.Tensor, *, enc_len: int = 0):
    """One decode step.  tokens (B, 1) -> (logits (B, 1, V) f32, caches').

    The cache tensors are updated in place; the returned tree holds them
    with ``pos`` advanced by one."""
    pos = caches["pos"]
    x = params["embed"][tokens]
    if cfg.gemma_norm:
        x = _gemma_scale(cfg, x)
    if cfg.family == "audio":
        dec_pos = params["dec_pos"]
        x = x + dec_pos[min(pos, dec_pos.shape[0] - 1)][None, None]  # clamped, as dynamic_slice
    n_groups, _ = group_layout(cfg)
    cross = caches.get("cross")
    for gi in range(n_groups):
        x = _group_decode(cfg, params, tree_index(params["blocks"], gi),
                          tree_index(caches["blocks"], gi), x, pos,
                          cross=None if cross is None else tree_index(cross, gi),
                          enc_len=enc_len)
    x = apply_norm(cfg, x, params["final_norm"])
    return final_logits(cfg, params, x), dict(caches, pos=pos + 1)
