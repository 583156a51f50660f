"""xLSTM blocks: chunked-parallel mLSTM and sequential sLSTM.

The JAX package's ``models/xlstm.py`` in PyTorch.  mLSTM (matrix memory,
exponential gating) is a gated linear recurrence run with the same chunked
state-passing scheme as the Mamba2 SSD scan (quadratic within a chunk,
(dh_v+1, dh_k) state across chunks -- the +1 row carries the normalizer).
sLSTM (scalar memory, per-head recurrent weights) is inherently sequential.
``lax.scan`` over chunks or time steps is a Python loop here: fine at the
sizes the port runs xLSTM at (its tests), not served at full width.  All
gate math fp32 with the max-stabilizer from the paper.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import dense_init, gelu, log_sigmoid, sigmoid

MLSTM_CHUNK = 256
GATE_CLIP = 15.0  # clip exp-gate preactivations


def mlstm_dims(cfg) -> tuple[int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.n_heads  # (d_inner, head_dim)


def _gate_bias(lead: tuple[int, ...], device, parts) -> torch.Tensor:
    """f32 bias of ``parts`` = [(count, value), ...] concatenated, broadcast
    over ``lead``."""
    b = torch.cat([torch.full((c,), v, dtype=torch.float32, device=device) for c, v in parts])
    return b.expand(lead + b.shape).clone()


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(cfg, gen: torch.Generator, *, lead: tuple[int, ...] = (), device="cpu") -> dict:
    d = cfg.d_model
    d_in, _ = mlstm_dims(cfg)
    h = cfg.n_heads
    kw = dict(lead=lead, device=device)
    return {
        "wq": dense_init(gen, (d, d_in), **kw),
        "wk": dense_init(gen, (d, d_in), **kw),
        "wv": dense_init(gen, (d, d_in), **kw),
        "w_gates": dense_init(gen, (d, 2 * h), dtype=torch.float32, **kw),
        # forget-gate bias ~ sigmoid(3) = 0.95
        "b_gates": _gate_bias(lead, device, [(h, 0.0), (h, 3.0)]),
        "w_ogate": dense_init(gen, (d, d_in), **kw),
        "out_proj": dense_init(gen, (d_in, d), scale=d_in**-0.5, **kw),
    }


def _mlstm_qkvg(cfg, p: dict, x: torch.Tensor):
    b, s, _ = x.shape
    h = cfg.n_heads
    d_in, dh = mlstm_dims(cfg)
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    k = (x @ p["wk"]).reshape(b, s, h, dh)
    v = (x @ p["wv"]).reshape(b, s, h, dh)
    gates = x.float() @ p["w_gates"] + p["b_gates"]
    log_i = torch.clamp(gates[..., :h], max=GATE_CLIP)  # exp input gate, clipped
    log_f = log_sigmoid(gates[..., h:])  # (B,S,H)
    ogate = sigmoid(x.float() @ p["w_ogate"].float())
    return q, k, v, log_i, log_f, ogate


def _mlstm_out(cfg, p: dict, y: torch.Tensor, ogate: torch.Tensor, shape) -> torch.Tensor:
    b, s = shape
    d_in, dh = mlstm_dims(cfg)
    num, den = y[..., :dh], y[..., dh]
    hout = num / torch.clamp(den.abs(), min=1.0)[..., None]
    hout = hout.reshape(b, s, d_in) * ogate
    # rounded to bf16 whatever the working dtype, as in the JAX package
    w = p["out_proj"]
    return hout.to(torch.bfloat16).to(w.dtype) @ w


def mlstm_forward(cfg, p: dict, x: torch.Tensor, *, chunk: int = MLSTM_CHUNK) -> torch.Tensor:
    """Full-sequence mLSTM.  x: (B, S, d) -> (B, S, d)."""
    b, s, _ = x.shape
    hh = cfg.n_heads
    d_in, dh = mlstm_dims(cfg)
    q_sz = min(chunk, s)
    if s % q_sz:
        raise ValueError(f"seq {s} must divide chunk {q_sz}")
    nc = s // q_sz
    q, k, v, log_i, log_f, ogate = _mlstm_qkvg(cfg, p, x)
    qf = q.float() * dh**-0.5
    kf = k.float()
    vf = torch.cat([v.float(), torch.ones((b, s, hh, 1), dtype=torch.float32, device=x.device)],
                   dim=-1)  # augment with normalizer row

    def to_chunks(t):
        return t.reshape((b, nc, q_sz) + t.shape[2:])

    qc, kc, vc, lic, lfc = map(to_chunks, (qf, kf, vf, log_i, log_f))
    cumf = torch.cumsum(lfc, dim=2)  # (B,nc,Q,H)
    upper = ~torch.ones((q_sz, q_sz), dtype=torch.bool, device=x.device).tril()
    cstate = torch.zeros((b, hh, dh + 1, dh), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        qk, kk, vk, lik, cumk = qc[:, c], kc[:, c], vc[:, c], lic[:, c], cumf[:, c]
        ldiff = cumk[:, :, None, :] - cumk[:, None, :, :] + lik[:, None, :, :]
        # masked before exp: above the diagonal ldiff grows with the decay
        # over the chunk and overflows once it passes 88, and a mask after
        # exp would then multiply 0 by inf in the backward (the JAX package
        # masks after exp: its gradient is NaN there, its values the same)
        lmat = torch.exp(ldiff.masked_fill(upper[None, :, :, None], float("-inf")))  # (B,Q,S,H)
        gqk = torch.einsum("bthn,bshn->btsh", qk, kk)  # (B,Q,S,H)
        y_intra = torch.einsum("btsh,bshd->bthd", gqk * lmat, vk)
        decay_in = torch.exp(cumk)  # (B,Q,H)
        y_inter = torch.einsum("bthn,bhdn->bthd", qk, cstate) * decay_in[..., None]
        decay_out = torch.exp(cumk[:, -1:, :] - cumk + lik)  # (B,Q,H)
        contrib = torch.einsum("bsh,bshn,bshd->bhdn", decay_out, kk, vk)
        cstate = cstate * torch.exp(cumk[:, -1])[:, :, None, None] + contrib
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, s, hh, dh + 1)
    return _mlstm_out(cfg, p, y, ogate, (b, s))


def mlstm_init_cache(cfg, batch: int, *, lead: tuple[int, ...] = (), device="cpu") -> dict:
    hh = cfg.n_heads
    _, dh = mlstm_dims(cfg)
    return {"c": torch.zeros(lead + (batch, hh, dh + 1, dh), dtype=torch.float32, device=device)}


def mlstm_step(cfg, p: dict, cache: dict, x: torch.Tensor):
    """Single decode step.  x: (B, 1, d)."""
    b = x.shape[0]
    hh = cfg.n_heads
    _, dh = mlstm_dims(cfg)
    q, k, v, log_i, log_f, ogate = _mlstm_qkvg(cfg, p, x)
    qf = q[:, 0].float() * dh**-0.5  # (B,H,dh)
    kf = k[:, 0].float()
    vf = torch.cat([v[:, 0].float(), torch.ones((b, hh, 1), dtype=torch.float32,
                                                 device=x.device)], dim=-1)
    f1 = torch.exp(log_f[:, 0])  # (B,H)
    i1 = torch.exp(log_i[:, 0])
    c_new = cache["c"] * f1[:, :, None, None] + i1[:, :, None, None] * (
        vf[:, :, :, None] * kf[:, :, None, :])
    y = torch.einsum("bhn,bhdn->bhd", qf, c_new)[:, None]  # (B,1,H,dh+1)
    return {"c": c_new}, _mlstm_out(cfg, p, y, ogate, (b, 1))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(cfg, gen: torch.Generator, *, lead: tuple[int, ...] = (), device="cpu") -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    kw = dict(lead=lead, device=device)
    return {
        "w_in": dense_init(gen, (d, 4 * d), dtype=torch.float32, **kw),
        "r": dense_init(gen, (h, dh, 4 * dh), dtype=torch.float32, scale=dh**-0.5, **kw),
        "b": _gate_bias(lead, device, [(2 * d, 0.0), (d, 3.0), (d, 0.0)]),  # z, i, f(+3), o
        "w_up": dense_init(gen, (d, 2 * d), **kw),
        "w_down": dense_init(gen, (d, d), scale=d**-0.5, **kw),
    }


def _slstm_cell(cfg, p: dict, state, x_t: torch.Tensor):
    """One sLSTM step.  x_t: (B, d) fp32; state: c, n, h, m (B, H, dh)."""
    b = x_t.shape[0]
    h, d = cfg.n_heads, cfg.d_model
    dh = d // h
    c, n, hid, m = state
    rec = torch.einsum("bhd,hde->bhe", hid, p["r"])  # (B,H,4dh)
    gates = ((x_t @ p["w_in"]).reshape(b, h, 4 * dh) + rec
             + p["b"].reshape(1, 4, h, dh).transpose(1, 2).reshape(1, h, 4 * dh))
    z_r, i_r, f_r, o_r = gates.chunk(4, dim=-1)  # (B,H,dh) each
    log_f = log_sigmoid(f_r)
    i_r = torch.clamp(i_r, max=GATE_CLIP)
    m_new = torch.maximum(log_f + m, i_r)
    i_g = torch.exp(i_r - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_r)
    n_new = f_g * n + i_g
    h_new = sigmoid(o_r) * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, h_new, m_new), h_new


def slstm_init_state(cfg, batch: int, *, lead: tuple[int, ...] = (), device="cpu"):
    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    return tuple(torch.zeros(lead + (batch, h, dh), dtype=torch.float32, device=device)
                 for _ in range(4))


def _slstm_mlp(p: dict, y: torch.Tensor) -> torch.Tensor:
    g, u = (y @ p["w_up"]).chunk(2, dim=-1)
    return (gelu(g) * u) @ p["w_down"]


def slstm_forward(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Sequential sLSTM + gated MLP.  x: (B, S, d) -> (B, S, d)."""
    b, s, d = x.shape
    xf = x.float()
    state = slstm_init_state(cfg, b, device=x.device)
    hs = []
    for t in range(s):
        state, h_new = _slstm_cell(cfg, p, state, xf[:, t])
        hs.append(h_new)
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return _slstm_mlp(p, y)


def slstm_step(cfg, p: dict, state, x: torch.Tensor):
    """Single decode step.  x: (B, 1, d)."""
    state, h_new = _slstm_cell(cfg, p, state, x[:, 0].float())
    y = h_new.reshape(x.shape[0], 1, cfg.d_model).to(x.dtype)
    return state, _slstm_mlp(p, y)
