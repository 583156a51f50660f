"""Mixture-of-Experts FFN: top-k routing, capacity-based GShard dispatch.

The JAX package's ``models/moe.py`` in PyTorch: the same dispatch/combine
einsums over (G, Sg, E, C), routed within groups of ``group_size`` tokens,
tokens past an expert's capacity dropped, and the Switch load-balancing
auxiliary loss.  ``jax.lax.top_k`` is ``torch.topk(sorted=True)``: the two
agree except where two router probabilities tie exactly, which has
probability zero with real-valued (random or trained) router weights; a tie
would pick the lower expert index in JAX and an unspecified one here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, silu

DEFAULT_GROUP = 512


def init_moe(cfg, gen: torch.Generator, *, lead: tuple[int, ...] = (), device="cpu") -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": dense_init(gen, (d, e), dtype=torch.float32, scale=d**-0.5, lead=lead,
                             device=device),
        "w_gate": dense_init(gen, (e, d, f), lead=lead, device=device),
        "w_up": dense_init(gen, (e, d, f), lead=lead, device=device),
        "w_down": dense_init(gen, (e, f, d), scale=f**-0.5, lead=lead, device=device),
    }


def _capacity(group: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(-(-group * top_k * cf // n_experts))  # ceil
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def route(cfg, p: dict, x: torch.Tensor):
    """Router probabilities and top-k selection.  x: (..., d).

    Returns (probs (..., E) f32, top_p (..., k) f32, top_e (..., k) int64).
    Top-k probabilities are renormalized (Mixtral-style)."""
    # f32 whatever the router's dtype, as the JAX package's einsum promotes
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.experts_per_token, dim=-1, sorted=True)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def moe_mlp(cfg, p: dict, x: torch.Tensor, *, group_size: int = DEFAULT_GROUP):
    """Top-k MoE FFN.  x: (B, S, d).  Returns (y, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    g_sz = min(group_size, t)
    if t % g_sz:
        g_sz = t  # one group (smoke-test sizes)
    g = t // g_sz
    xg = x.reshape(g, g_sz, d)

    probs, top_p, top_e = route(cfg, p, xg)  # (G,Sg,E) (G,Sg,k) (G,Sg,k)
    cap = _capacity(g_sz, k, e, cfg.moe_capacity_factor)

    # --- position of each (token, slot) within its expert's capacity ------
    onehot_e = F.one_hot(top_e, e).float()  # (G,Sg,k,E)
    flat = onehot_e.reshape(g, g_sz * k, e)
    pos_flat = torch.cumsum(flat, dim=1) - flat  # (G,Sg*k,E)
    pos = (pos_flat.reshape(g, g_sz, k, e) * onehot_e).sum(-1)  # (G,Sg,k)
    keep = (pos < cap).float()
    # one_hot of a position past capacity is all zeros (jax.nn.one_hot's rule)
    onehot_c = (pos[..., None] == torch.arange(cap, device=x.device)).float()
    # dispatch (G,Sg,E,C): 1 where token s goes to slot c of expert e
    dispatch = torch.einsum("gske,gskc,gsk->gsec", onehot_e, onehot_c, keep)
    combine = torch.einsum("gske,gskc,gsk->gsec", onehot_e, onehot_c, keep * top_p)

    # --- expert compute -----------------------------------------------------
    xin = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
    h = silu(torch.einsum("gecd,edf->gecf", xin, p["w_gate"])) * torch.einsum(
        "gecd,edf->gecf", xin, p["w_up"])
    out = torch.einsum("gecf,efd->gecd", h.to(x.dtype), p["w_down"])
    y = torch.einsum("gsec,gecd->gsd", combine, out.float())

    # --- load-balancing auxiliary loss (Switch Eq. 4) ------------------------
    frac_tokens = onehot_e.mean(dim=(1, 2))  # (G,E) fraction routed
    frac_probs = probs.mean(dim=1)  # (G,E)
    aux = e * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    return y.reshape(b, s, d).to(x.dtype), aux
