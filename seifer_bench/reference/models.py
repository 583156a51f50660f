"""Plain PyTorch forward passes of the two demo models, hop by hop.

Written from the layer equations that ``core/model_zoo.py`` documents, not
from its code; it imports nothing of ``repro_torch``.  The benchmark makes
the weights and the inputs and hands the same tensors to the program and to
this reference, and the reference works out again everything the program
derives from them: the projections, the scan, the attention, the int8 codes
at every hop between stages.

``demo_ssm`` layer (Mamba2-style mixer): ``bm = x Wb``, ``cm = x Wc``,
``dt = softplus(x Wd)``, ``a = -0.5`` for every head, the SSD recurrence
``h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T``, ``y_t = h_t C_t``, and
``tanh(x + y)``.  The scan here is chunked at 64 rows (exact in arithmetic
for any chunk): within a chunk the quadratic form, across chunks the state.

``demo_transformer`` layer: ``qkv = x Wqkv``, causal attention (grouped
query heads, softmax of ``q k^T / sqrt(hd)``, capped by ``c tanh(l / c)``
where a softcap c is set, a sliding window on odd layers where one is set),
``y = o Wo``, ``z = y + gelu_tanh(y W1) W2``, ``tanh(z)``.

``precision`` is ``"f32"`` (every product in full f32: TF32 off) or
``"tf32"``: the products take TF32 operands, the control that the limits
are set against (the library's TF32 on a card, the operands rounded to
TF32's 10-bit mantissa on the CPU).  Everything that is not a product stays
f32 in both.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from seifer_bench.reference.int8 import round_trip

SSD_CHUNK = 64
ATTN_HEAD_BLOCK = 4  # heads whose (S, S) logits are held at once


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits, ties away from zero)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def precision_scope(precision: str):
    """TF32 for the library's f32 products on, for ``"tf32"``, or off."""
    if precision not in ("f32", "tf32"):
        raise ValueError(f"precision must be f32 or tf32, got {precision!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b; on the CPU the TF32 control rounds the operands itself."""
    if precision == "tf32" and a.device.type == "cpu":
        a, b = to_tf32(a), to_tf32(b)
    return a @ b


def ssd_scan(xs, bm, cm, dt, a, precision: str, chunk: int = SSD_CHUNK):
    """y (n, S, H, P) of the SSD recurrence over xs (n, S, H, P), bm and cm
    (n, S, N), dt (n, S, H), a (H,)."""
    n, s, h, p = xs.shape
    nst = bm.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    c = s // q
    x = xs.reshape(n, c, q, h, p).permute(0, 1, 3, 2, 4)  # (n, c, H, Q, P)
    b = bm.reshape(n, c, 1, q, nst)
    cc = cm.reshape(n, c, 1, q, nst)
    dtc = dt.reshape(n, c, q, h).permute(0, 1, 3, 2)  # (n, c, H, Q)
    cum = torch.cumsum(dtc * a[None, None, :, None], dim=-1)  # (n, c, H, Q)
    # within a chunk: y_t = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
    diff = cum[..., :, None] - cum[..., None, :]  # (n, c, H, t, s)
    upper = torch.ones(q, q, dtype=torch.bool, device=xs.device).triu(1)
    decay = torch.exp(diff.masked_fill(upper, float("-inf")))
    gram = mm(cc, b.transpose(-1, -2), precision)  # (n, c, 1, t, s)
    scores = gram * decay * dtc[..., None, :]
    y = mm(scores, x, precision)  # (n, c, H, Q, P)
    # each chunk's own state: sum_s exp(cum_end - cum_s) dt_s x_s B_s^T
    w = (torch.exp(cum[..., -1:] - cum) * dtc)[..., None] * x  # (n, c, H, Q, P)
    own = mm(w.transpose(-1, -2), b.expand(n, c, h, q, nst), precision)  # (n, c, H, P, N)
    # across chunks: the state entering each chunk
    entering = torch.zeros_like(own)
    state = torch.zeros_like(own[:, 0])
    chunk_decay = torch.exp(cum[..., -1])  # (n, c, H)
    for k in range(c):
        entering[:, k] = state
        state = state * chunk_decay[:, k, :, None, None] + own[:, k]
    carried = mm(cc.expand(n, c, h, q, nst), entering.transpose(-1, -2), precision)
    y = y + carried * torch.exp(cum)[..., None]
    return y.permute(0, 1, 3, 2, 4).reshape(n, s, h, p)


def ssm_layer(x, wb, wc, wd, heads: int, a_value: float, precision: str):
    """One ``demo_ssm`` layer over x (n, S, d)."""
    n, s, d = x.shape
    bm = mm(x, wb, precision)
    cm = mm(x, wc, precision)
    z = mm(x, wd, precision)
    dt = torch.logaddexp(z, torch.zeros_like(z))  # softplus
    a = torch.full((heads,), a_value, dtype=torch.float32, device=x.device)
    y = ssd_scan(x.reshape(n, s, heads, d // heads), bm, cm, dt, a, precision)
    return torch.tanh(x + y.reshape(n, s, d))


def attention(q, k, v, *, window: int, softcap: float, precision: str):
    """Causal attention over q (n, S, H, hd), k and v (n, S, KH, hd), a few
    heads at a time."""
    n, s, h, hd = q.shape
    kh = k.shape[2]
    group = h // kh
    pos = torch.arange(s, device=q.device)
    masked = pos[None, :] > pos[:, None]
    if window > 0:
        masked |= (pos[:, None] - pos[None, :]) >= window
    out = torch.empty_like(q)
    for r in range(n):
        for h0 in range(0, h, ATTN_HEAD_BLOCK):
            hs = list(range(h0, min(h, h0 + ATTN_HEAD_BLOCK)))
            kv = [i // group for i in hs]
            qb = q[r, :, hs].transpose(0, 1)  # (hb, S, hd)
            kb = k[r, :, kv].transpose(0, 1)
            vb = v[r, :, kv].transpose(0, 1)
            logits = mm(qb, kb.transpose(-1, -2), precision) * (hd ** -0.5)
            if softcap > 0:
                logits = softcap * torch.tanh(logits / softcap)
            probs = torch.softmax(logits.masked_fill(masked, float("-inf")), dim=-1)
            out[r, :, hs] = mm(probs, vb, precision).transpose(0, 1)
            del logits, probs
    return out


def transformer_layer(x, wqkv, wo, w1, w2, *, heads: int, kv_heads: int, window: int,
                      softcap: float, precision: str):
    """One ``demo_transformer`` layer over x (n, S, d); ``window`` is the
    layer's own (0 on even layers)."""
    n, s, d = x.shape
    hd = d // heads
    qkv = mm(x, wqkv, precision)
    q = qkv[..., : heads * hd].reshape(n, s, heads, hd)
    k = qkv[..., heads * hd: (heads + kv_heads) * hd].reshape(n, s, kv_heads, hd)
    v = qkv[..., (heads + kv_heads) * hd:].reshape(n, s, kv_heads, hd)
    o = attention(q, k, v, window=window, softcap=softcap, precision=precision)
    y = mm(o.reshape(n, s, d), wo, precision)
    z = y + mm(F.gelu(mm(y, w1, precision), approximate="tanh"), w2, precision)
    return torch.tanh(z)


def forward(model: dict, weights: dict, x: torch.Tensor, stages, block: int,
            precision: str = "f32") -> torch.Tensor:
    """x (n, S, d) through every layer of ``model`` (a configuration's
    ``model`` entry), the activation int8 round-tripped at ``block`` between
    consecutive stages (``stages``: each stage's [first, stop) layers)."""
    kind = model["kind"]
    with precision_scope(precision), torch.no_grad():
        for j, (first, stop) in enumerate(stages):
            if j:
                x = round_trip(x, block)
            for i in range(first, stop):
                if kind == "demo_ssm":
                    x = ssm_layer(x, weights["wb"][i], weights["wc"][i], weights["wd"][i],
                                  model["heads"], model["a"], precision)
                elif kind == "demo_transformer":
                    win = model["window"] if (model["window"] > 0 and i % 2 == 1) else 0
                    x = transformer_layer(
                        x, weights["wqkv"][i], weights["wo"][i], weights["w1"][i],
                        weights["w2"][i], heads=model["heads"], kv_heads=model["kv_heads"],
                        window=win, softcap=model["softcap"], precision=precision)
                else:
                    raise ValueError(f"no reference for model kind {kind!r}")
    return x


def relative_errors(out: torch.Tensor, ref: torch.Tensor) -> dict[str, float]:
    """How far a served answer (S, d) lies from the reference's:

    - ``row_med``: the median over its rows (positions) of
      ||out_t - ref_t|| / ||ref_t||;
    - ``row_max``: the largest of those;
    - ``diff2``, ``ref2``: ||out - ref||^2 and ||ref||^2 of the whole answer,
      which ``worst_errors`` pools over the answers compared into ``rel_err``.

    A non-finite answer reads infinitely wrong."""
    diff = (out.double() - ref.double())
    ref64 = ref.double()
    rows = diff.reshape(-1, diff.shape[-1]).norm(dim=-1) / ref64.reshape(
        -1, ref64.shape[-1]).norm(dim=-1).clamp_min(1e-30)
    got = {"row_med": rows.median().item(), "row_max": rows.max().item(),
           "diff2": diff.square().sum().item(), "ref2": ref64.square().sum().item()}
    return {k: v if v == v and v != float("inf") else float("inf") for k, v in got.items()}


ERRORS = ("rel_err", "row_med", "row_max")


def worst_errors(errors: list[dict]) -> dict[str, float]:
    """The numbers a run's sampled answers are judged by: ``rel_err``, the
    relative error of all of them together, sqrt(sum ||out - ref||^2 /
    sum ||ref||^2) (a code rounded the other way at a hop moves it little, an
    altered answer or row a lot); and the largest ``row_med`` and ``row_max``
    of any one.  With no answer to compare, every number reads infinitely
    wrong."""
    if not errors:
        return {k: float("inf") for k in ERRORS}
    ref2 = sum(e["ref2"] for e in errors)
    pooled = (sum(e["diff2"] for e in errors) / ref2) ** 0.5 if ref2 > 0 else float("inf")
    return {"rel_err": pooled, **{k: max(e[k] for e in errors) for k in ("row_med", "row_max")}}
