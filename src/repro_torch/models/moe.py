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

from repro_torch.models.common import dense_init, is_dtensor, silu

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


class _Hold(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, and its gradient too."""

    @staticmethod
    def forward(ctx, t, placements):
        ctx.placements = placements
        return t.redistribute(t.device_mesh, placements).view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


class _ExpertLayout:
    """Identity on plain tensors.  On DTensors it places a (G, E, ...) or
    (G, ...) tensor, and its gradient, with the groups G over the mesh dims
    x's batch is sharded over and the experts E (with ``experts=True``)
    over those w's experts are, replicated elsewhere (each only where the
    count divides).  Left to itself DTensor shards G over the batch and
    expert dims at once, which neither the expert products' local views
    nor the (B, S, d) reshapes around them (forward or backward) can take."""

    def __init__(self, x: torch.Tensor, w: torch.Tensor):
        self.on = is_dtensor(x)
        if self.on:
            from torch.distributed.tensor import Shard

            self.sizes = tuple(x.device_mesh.shape)
            self.batch = [p == Shard(0) for p in x.placements]
            self.expert = ([p == Shard(0) for p in w.placements] if is_dtensor(w)
                           else [False] * len(self.batch))

    def _over(self, dims: list[bool], n: int) -> list[bool]:
        """``dims`` if n divides over them all, else none."""
        ways = 1
        for on, size in zip(dims, self.sizes):
            ways *= size if on else 1
        return dims if n % ways == 0 else [False] * len(dims)

    def dims(self, groups: int, experts: int) -> tuple[list[bool], list[bool]]:
        """The mesh dims that split G groups, and E experts."""
        return self._over(self.batch, groups), self._over(self.expert, experts)

    def __call__(self, t: torch.Tensor, experts: bool = False) -> torch.Tensor:
        if not self.on:
            return t
        from torch.distributed.tensor import Replicate, Shard

        g, e = self.dims(t.shape[0], t.shape[1] if experts else 1)
        pl = tuple(Shard(0) if gi else Shard(1) if ei and experts else Replicate()
                   for gi, ei in zip(g, e))
        return _Hold.apply(t, pl)


def _expert_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(G, E, C, K) x (E, K, N) -> (G, E, C, N), per expert: an einsum.  On
    DTensors (``a`` placed by ``_ExpertLayout``) the einsum runs on each
    rank's shards (``local_map``): w's experts placed as a's and w gathered
    over every other mesh dim (the FSDP gather); w's gradient comes back a
    partial sum over the mesh dims a's groups are sharded over.  DTensor's
    own einsum takes local views that a redistributed shard's strides do
    not allow, in the forward and in the rematerialized one."""
    if not is_dtensor(a):
        return torch.einsum("gecd,edf->gecf", a, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    pa = tuple(a.placements)
    pw = tuple(Shard(0) if p == Shard(1) else Replicate() for p in pa)
    grad_w = tuple(Shard(0) if p == Shard(1) else Partial() if p == Shard(0) else Replicate()
                   for p in pa)
    product = local_map(lambda x, y: torch.einsum("gecd,edf->gecf", x, y), out_placements=list(pa),
                        in_placements=(pa, pw), in_grad_placements=(pa, grad_w),
                        redistribute_inputs=True)
    return product(a, w)


def _routing_einsum(eq: str, a: torch.Tensor, b: torch.Tensor, layout: _ExpertLayout,
                    experts: int) -> torch.Tensor:
    """The dispatch ("gsec,gsd->gecd") or the combine ("gsec,gecd->gsd")
    einsum.  On DTensors it runs on each rank's shards (``local_map``), a
    (G, Sg, E, C) placed by groups and experts as ``layout`` places them:
    the dispatch is exact per shard, the combine a partial sum over the
    experts' mesh dims.  DTensor's own einsum flattens (E, C) with E
    sharded, which torch 2.11 refuses."""
    if not layout.on:
        return torch.einsum(eq, a, b)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    groups, split = layout.dims(a.shape[0], experts)
    pa = [Shard(0) if g else Shard(2) if e else Replicate() for g, e in zip(groups, split)]
    if eq.endswith("gecd"):  # dispatch: b (G, Sg, d), its gradient summed over the experts
        pb = [Shard(0) if g else Replicate() for g in groups]
        out = [Shard(0) if g else Shard(1) if e else Replicate() for g, e in zip(groups, split)]
        grad_b = [Shard(0) if g else Partial() if e else Replicate() for g, e in zip(groups, split)]
    else:  # combine: b (G, E, C, d)
        pb = [Shard(0) if g else Shard(1) if e else Replicate() for g, e in zip(groups, split)]
        out = [Shard(0) if g else Partial() if e else Replicate() for g, e in zip(groups, split)]
        grad_b = pb
    run = local_map(lambda x, y: torch.einsum(eq, x, y), out_placements=out,
                    in_placements=(pa, pb), in_grad_placements=(pa, grad_b),
                    redistribute_inputs=True)
    return run(a, b)


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
    ep = _ExpertLayout(x, p["w_gate"])
    xg = ep(x.reshape(g, g_sz, d))

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
    xin = ep(_routing_einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg, ep, e), experts=True)
    h = silu(_expert_matmul(xin, p["w_gate"])) * _expert_matmul(xin, p["w_up"])
    out = ep(_expert_matmul(ep(h.to(x.dtype), experts=True), p["w_down"]), experts=True)
    y = ep(_routing_einsum("gsec,gecd->gsd", combine, out.float(), ep, e))

    # --- load-balancing auxiliary loss (Switch Eq. 4) ------------------------
    frac_tokens = onehot_e.mean(dim=(1, 2))  # (G,E) fraction routed
    frac_probs = probs.mean(dim=1)  # (G,E)
    aux = e * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    return ep(y.reshape(b, s, d)).to(x.dtype), aux
