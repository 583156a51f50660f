"""Mamba2 (SSD) blocks: the chunked scan for train/prefill, O(1) decode.

The JAX package's ``models/ssm.py`` in PyTorch.  ``mamba_forward``'s scan
is the JAX package's inline chunked scan (``ssm.py``'s ``chunk_step``),
which is ``ssd_ref`` at ``chunk`` plus the D skip: here it goes through the
port's ``ssd_chunked`` op -- the hand-written SSD kernels (forward and, under
grad, backward) for CUDA tensors, the plain ``ssd_ref`` (whose in-chunk
cumsum takes XLA's CPU order) and ``ssd_backward_ref`` on the CPU -- and the
skip is added after.  All gate math is fp32.

Layout: d_inner = ssm_expand * d_model, heads of size HEAD_DIM, single B/C
group (n_groups=1), scalar-per-head A (the Mamba2 restriction).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan.ops import ssd_chunked
from repro_torch.models.common import dense_init, full, silu, softplus

HEAD_DIM = 64
DEFAULT_CHUNK = 256


def ssm_dims(cfg) -> tuple[int, int, int]:
    """(d_inner, n_heads, state N) for the mamba tower of this config."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // HEAD_DIM, max(cfg.ssm_state, 16)


def init_mamba(cfg, gen: torch.Generator, *, lead: tuple[int, ...] = (), device="cpu") -> dict:
    d = cfg.d_model
    d_in, h, n = ssm_dims(cfg)
    conv_dim = d_in + 2 * n
    kw = dict(lead=lead, device=device)
    return {
        "in_proj": dense_init(gen, (d, 2 * d_in + 2 * n + h), **kw),
        "conv_w": dense_init(gen, (cfg.ssm_conv_width, conv_dim), scale=0.3, **kw),
        "conv_b": full((conv_dim,), 0.0, **kw),
        "A_log": full((h,), 0.0, torch.float32, **kw),  # A = -exp(A_log) = -1 at init
        "D": full((h,), 1.0, torch.float32, **kw),
        "dt_bias": full((h,), 0.0, torch.float32, **kw),
        "norm_w": full((d_in,), 1.0, **kw),
        "out_proj": dense_init(gen, (d_in, d), scale=d_in**-0.5, **kw),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, C); w: (K, C).  Sum of shifts."""
    k = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _split_proj(cfg, p: dict, x: torch.Tensor):
    """x (B,S,d) -> z (B,S,d_in), xBC (B,S,d_in+2N), dt (B,S,H) fp32."""
    d_in, h, n = ssm_dims(cfg)
    zxbcdt = (x @ p["in_proj"]).to(x.dtype)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * n]
    dt = zxbcdt[..., 2 * d_in + 2 * n:].float()
    dt = softplus(dt + p["dt_bias"])
    return z, xbc, dt


def _gate_out(cfg, p: dict, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gated RMSNorm then down-projection.  y, z: (B, S, d_in)."""
    g = y.float() * silu(z.float())
    var = (g * g).mean(-1, keepdim=True)
    g = g * torch.rsqrt(var + 1e-6) * p["norm_w"].float()
    return (g.to(z.dtype) @ p["out_proj"]).to(z.dtype)


def mamba_forward(cfg, p: dict, x: torch.Tensor, *, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Full-sequence forward (train / prefill).  x: (B, S, d) -> (B, S, d)."""
    b, s, _ = x.shape
    d_in, h, n = ssm_dims(cfg)
    z, xbc, dt = _split_proj(cfg, p, x)
    xbc = silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :d_in].reshape(b, s, h, HEAD_DIM)
    bm = xbc[..., d_in:d_in + n].float().contiguous()  # (B,S,N)
    cm = xbc[..., d_in + n:].float().contiguous()
    # (H,); widened exactly, as the JAX package's dt * a promotes a bf16 a
    a = (-torch.exp(p["A_log"])).float()
    xs32 = xs.float().contiguous()
    y = ssd_chunked(xs32, bm, cm, dt.contiguous(), a.contiguous(), chunk=chunk)
    y = y + xs32 * p["D"][None, None, :, None]
    return _gate_out(cfg, p, y.reshape(b, s, d_in), z)


def mamba_init_cache(cfg, batch: int, *, lead: tuple[int, ...] = (), device="cpu") -> dict:
    d_in, h, n = ssm_dims(cfg)
    conv_dim = d_in + 2 * n
    return {
        "conv": full((batch, cfg.ssm_conv_width - 1, conv_dim), 0.0, lead=lead, device=device),
        "ssm": full((batch, h, HEAD_DIM, n), 0.0, torch.float32, lead=lead, device=device),
    }


def mamba_step(cfg, p: dict, cache: dict, x: torch.Tensor):
    """Single decode step.  x: (B, 1, d).  Returns (cache', y (B, 1, d))."""
    b = x.shape[0]
    d_in, h, n = ssm_dims(cfg)
    z, xbc, dt = _split_proj(cfg, p, x)  # (B,1,*)
    window = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)
    conv_out = (torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float())
                + p["conv_b"].float())
    xbc1 = silu(conv_out)  # (B, conv_dim)
    xs = xbc1[:, :d_in].reshape(b, h, HEAD_DIM)
    bm = xbc1[:, d_in:d_in + n]
    cm = xbc1[:, d_in + n:]
    a = -torch.exp(p["A_log"])
    dt1 = dt[:, 0]  # (B,H)
    decay = torch.exp(dt1 * a)  # (B,H)
    hstate = cache["ssm"] * decay[:, :, None, None] + torch.einsum(
        "bh,bn,bhd->bhdn", dt1, bm, xs)
    y = torch.einsum("bn,bhdn->bhd", cm, hstate) + xs * p["D"][None, :, None]
    out = _gate_out(cfg, p, y.reshape(b, 1, d_in), z)
    return {"conv": window[:, 1:], "ssm": hstate}, out
