"""Plain PyTorch version of the chunked SSD (Mamba2) scan.

Inputs are the post-projection tensors of one mamba layer, in the JAX
package's layout:
  xs  (B, S, H, dh)  state inputs
  bm  (B, S, N)      input projections B_t; or (B, S, G, N) in G groups,
                     head h reading group h // (H / G) (``ssd_ref`` only)
  cm  (B, S, N)      output projections C_t, as bm
  dt  (B, S, H)      softplus'd step sizes
  a   (H,)           negative decay rates

Output: y (B, S, H, dh) f32 with
y_t = sum_{s<=t} C_t^T (prod exp(dt A)) dt_s B_s x_s, and the final state
(B, H, dh, N).  A Python loop over chunks takes the place of ``lax.scan``.
The lower-triangular decay matrix is masked *before* ``exp`` (``-inf`` ->
0): the upper triangle's ``exp(cum_t - cum_s)`` overflows for s > t, and an
``inf`` multiplied by a 0/1 mask would be NaN.

The in-chunk cumsum of ``dt * a`` is taken in one fixed order
(``chunk_cumsum``), the one XLA's cumsum takes on the CPU.  Its rounding is
amplified by ``exp(cum_t - cum_s)`` (cum reaches -1e2 within a chunk, where
one f32 ulp is ~1e-5), so the order decides whether the port holds the JAX
package's 1e-5 pin; the CUDA kernel sums in the same order, so its cum is
bit-identical to this version's.

``ssd_backward_ref`` is the gradient of ``ssd_ref``'s y, the plain
version of the backward kernel (``csrc/ssd_scan_bwd.cu``) and the CPU path
of the op's ``SSDScan`` Function.

The CUDA kernel cuts each sequence into segments of whole chunks so that
its blocks fill the card; ``ssd_ref_segmented`` is that decomposition in
plain PyTorch (end states of the segments from zero, folded in order), and
at one segment it is ``ssd_ref_padded``.  The CPU tests hold these to the
JAX package, and ``chip_smoke.py`` holds the kernel to them on the card.
``ssd_backward_ref_grouped`` is the backward kernel's decomposition: both
state recurrences walked whole, every chunk's gradients at once from its
entering state and leaving dH, and dbm / dcm summed over groups of heads,
in head order within a group and in group order after.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SCAN_BLOCK = 16  # chunk_cumsum's block length


def chunk_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive cumsum along ``dim`` in a fixed order: in order within
    blocks of ``SCAN_BLOCK`` (the last one zero-padded), plus the exclusive
    prefix of the block totals, themselves summed the same way."""
    x = x.movedim(dim, 0)
    q = x.shape[0]
    if q <= SCAN_BLOCK:
        out = torch.empty_like(x)
        run = x[0]
        out[0] = run
        for t in range(1, q):
            run = run + x[t]
            out[t] = run
        return out.movedim(0, dim)
    pad = -q % SCAN_BLOCK
    xp = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]) if pad else x
    within = chunk_cumsum(xp.reshape(-1, SCAN_BLOCK, *x.shape[1:]), 1)
    incl = chunk_cumsum(within[:, -1], 0)
    excl = torch.cat([torch.zeros_like(incl[:1]), incl[:-1]])
    out = (excl[:, None] + within).reshape(-1, *x.shape[1:])[:q]
    return out.movedim(0, dim)


def chunk_of(s: int, chunk: int) -> int:
    """The chunk actually used, ``min(chunk, s)``; raises unless it divides s."""
    q = min(chunk, s)
    if q < 1 or s % q:
        raise ValueError(f"seq {s} must divide chunk {q}")
    return q


def ssd_ref(xs, bm, cm, dt, a, *, chunk: int = 64, state0=None):
    """-> (y (B, S, H, dh), final state (B, H, dh, N)), f32 (f64 for f64
    inputs: ``chip_smoke.py`` takes that as its exact yardstick).  The
    state starts at ``state0`` (B, H, dh, N), zero when None.  Grouped bm
    and cm (B, S, G, N): the one-group walk once a group, over its heads."""
    if bm.dim() == 4:  # each group's heads, walked with that group's B and C
        g, r = bm.shape[2], xs.shape[2] // bm.shape[2]
        if xs.shape[2] % g:
            raise ValueError(f"heads {xs.shape[2]} must be a multiple of the B / C groups {g}")
        parts = [ssd_ref(xs[:, :, k * r:(k + 1) * r], bm[:, :, k], cm[:, :, k],
                         dt[:, :, k * r:(k + 1) * r], a[k * r:(k + 1) * r], chunk=chunk,
                         state0=None if state0 is None else state0[:, k * r:(k + 1) * r])
                 for k in range(g)]
        return torch.cat([y for y, _ in parts], 2), torch.cat([st for _, st in parts], 1)
    b, s, h, dh = xs.shape
    n = bm.shape[-1]
    q = chunk_of(s, chunk)
    nc = s // q
    da = dt * a  # (B, S, H)
    # f32 (bf16 inputs widen, as in the JAX package); f64 stays f64
    xs_c = xs.reshape(b, nc, q, h, dh).to(torch.promote_types(xs.dtype, torch.float32))
    bm_c = bm.reshape(b, nc, q, n)
    cm_c = cm.reshape(b, nc, q, n)
    dt_c = dt.reshape(b, nc, q, h)
    cum = chunk_cumsum(da.reshape(b, nc, q, h), 2)
    upper = ~torch.ones((q, q), dtype=torch.bool, device=xs.device).tril()

    state = (torch.zeros((b, h, dh, n), dtype=xs_c.dtype, device=xs.device)
             if state0 is None else state0)
    ys = []
    for c in range(nc):
        xs_k, bm_k, cm_k, dt_k, cum_k = (
            xs_c[:, c], bm_c[:, c], cm_c[:, c], dt_c[:, c], cum[:, c])
        ldiff = cum_k[:, :, None, :] - cum_k[:, None, :, :]  # (B, t, s, H)
        lmat = torch.exp(ldiff.masked_fill(upper[None, :, :, None], float("-inf")))
        gbc = torch.einsum("btn,bsn->bts", cm_k, bm_k)
        scores = gbc[:, :, :, None] * lmat * dt_k[:, None, :, :]
        y_intra = torch.einsum("btsh,bshd->bthd", scores, xs_k)
        y_inter = torch.einsum("btn,bhdn->bthd", cm_k, state) * torch.exp(cum_k)[..., None]
        decay_out = torch.exp(cum_k[:, -1:, :] - cum_k)
        contrib = torch.einsum("bsh,bsn,bshd->bhdn", decay_out * dt_k, bm_k, xs_k)
        state = state * torch.exp(cum_k[:, -1])[:, :, None, None] + contrib
        ys.append(y_intra + y_inter)
    return torch.stack(ys, 1).reshape(b, s, h, dh), state


def ssd_backward_ref(xs, bm, cm, dt, a, dy, *, chunk: int = 64):
    """The gradient of ``ssd_ref``'s y (the op returns y only, so the final
    state's gradient is zero) -> (dxs, dbm, dcm, ddt, da), f32 (f64 for f64
    inputs).

    The chunk-entry states h are recomputed by ``ssd_ref``'s recurrence; the
    chunks are then walked in reverse, carrying dH, the gradient of the
    state leaving the chunk.  Per chunk and per (b, h), with L_ts =
    exp(cum_t - cum_s) (s <= t, masked before exp), G_ts = C_t.B_s, P_ts =
    dy_t.x_s, e_t = exp(cum_t), o_s = exp(cum_L - cum_s) (L the last row):

      dx_s   = sum_t G_ts L_ts dt_s dy_t + o_s dt_s dH B_s
      dC_t  += sum_h [sum_s P_ts L_ts dt_s B_s + e_t h^T dy_t]
      dB_s  += sum_h [sum_t P_ts L_ts dt_s C_t + o_s dt_s dH^T x_s]
      r_s    = o_s x_s^T dH B_s
      ddt_s  = sum_t P_ts G_ts L_ts + r_s + dda_s a
      dcum_t = sum_s M_ts - sum_t' M_t't + e_t dy_t.(h C_t) - r_t dt_t,
               M_ts = P_ts G_ts L_ts dt_s;  the last row also takes
               exp(cum_L) <dH, h> + sum_s r_s dt_s
      dda    = dcum summed from the end of the chunk
      dH    <- exp(cum_L) dH + sum_t e_t dy_t C_t^T

    da_h = sum dcum_t T_t (T the in-chunk cumsum of dt) is taken pairwise,
    as sum_{s<=t} M_ts (T_t - T_s) + sum_t e_t dy_t.(h C_t) T_t + sum_s r_s
    dt_s (T_L - T_s) + exp(cum_L) <dH, h> T_L: summed as sum_t dcum_t T_t
    (or sum_s dda_s dt_s, what autograd of ``ssd_ref`` does) it cancels
    terms of size |T| M, and at strong decay (|cum| ~ 1e3) f32 keeps no
    digit of it.
    """
    b, s, h, dh = xs.shape
    n = bm.shape[-1]
    q = chunk_of(s, chunk)
    nc = s // q
    f = torch.promote_types(xs.dtype, torch.float32)
    xs_c = xs.reshape(b, nc, q, h, dh).to(f)
    dy_c = dy.reshape(b, nc, q, h, dh).to(f)
    bm_c = bm.reshape(b, nc, q, n)
    cm_c = cm.reshape(b, nc, q, n)
    dt_c = dt.reshape(b, nc, q, h)
    cum = chunk_cumsum((dt * a).reshape(b, nc, q, h), 2)
    tsum = chunk_cumsum(dt_c, 2)  # T: cum / a, for da
    upper = ~torch.ones((q, q), dtype=torch.bool, device=xs.device).tril()

    states = []
    state = torch.zeros((b, h, dh, n), dtype=f, device=xs.device)
    for c in range(nc):
        states.append(state)
        decay_out = torch.exp(cum[:, c, -1:] - cum[:, c])
        contrib = torch.einsum("bsh,bsn,bshd->bhdn", decay_out * dt_c[:, c], bm_c[:, c],
                               xs_c[:, c])
        state = state * torch.exp(cum[:, c, -1])[:, :, None, None] + contrib

    dh_state = torch.zeros((b, h, dh, n), dtype=f, device=xs.device)
    dxs, dbm, dcm, ddt = [], [], [], []
    da = torch.zeros_like(a, dtype=f)
    for c in reversed(range(nc)):
        x, bb, cc, dtk, cumk, tk, dyk, hst = (
            xs_c[:, c], bm_c[:, c], cm_c[:, c], dt_c[:, c], cum[:, c], tsum[:, c], dy_c[:, c],
            states[c])
        ldiff = cumk[:, :, None, :] - cumk[:, None, :, :]  # (B, t, s, H)
        lmat = torch.exp(ldiff.masked_fill(upper[None, :, :, None], float("-inf")))
        gbc = torch.einsum("btn,bsn->bts", cc, bb)
        pmat = torch.einsum("bthd,bshd->btsh", dyk, x)
        e = torch.exp(cumk)
        el = torch.exp(cumk[:, -1])  # (B, H)
        o = torch.exp(cumk[:, -1:] - cumk)
        z = pmat * gbc[..., None] * lmat
        m = z * dtk[:, None]
        sp = pmat * lmat * dtk[:, None]
        u = torch.einsum("bsn,bhdn->bshd", bb, dh_state)  # dH B_s
        vh = torch.einsum("bthd,bhdn->bthn", dyk, hst)  # h^T dy_t
        dxs.append(torch.einsum("btsh,bthd->bshd", gbc[..., None] * lmat * dtk[:, None], dyk)
                   + (o * dtk)[..., None] * u)
        dcm.append(torch.einsum("btsh,bsn->btn", sp, bb) + torch.einsum("bth,bthn->btn", e, vh))
        dbm.append(torch.einsum("btsh,btn->bsn", sp, cc)
                   + torch.einsum("bsh,bshd,bhdn->bsn", o * dtk, x, dh_state))
        r = o * (x * u).sum(-1)
        ev = e * torch.einsum("bthn,btn->bth", vh, cc)
        hdh = el * torch.einsum("bhdn,bhdn->bh", dh_state, hst)
        dcum = m.sum(2) - m.sum(1) + ev - r * dtk
        dcum = torch.cat([dcum[:, :-1], dcum[:, -1:] + (hdh + (r * dtk).sum(1))[:, None]], 1)
        dda = dcum.flip(1).cumsum(1).flip(1)
        ddt.append(z.sum(1) + r + dda * a)
        tdiff = (tk[:, :, None] - tk[:, None, :]).masked_fill(upper[None, :, :, None], 0.0)
        da = da + ((m * tdiff).sum((0, 1, 2)) + (ev * tk + r * dtk * (tk[:, -1:] - tk)).sum((0, 1))
                   + (hdh * tk[:, -1]).sum(0))
        dh_state = (el[:, :, None, None] * dh_state
                    + torch.einsum("bth,bthd,btn->bhdn", e, dyk, cc))
    cat = lambda parts: torch.stack(parts[::-1], 1).flatten(1, 2)  # noqa: E731
    return cat(dxs), cat(dbm), cat(dcm), cat(ddt), da


def ssd_ref_padded(xs, bm, cm, dt, a, *, chunk: int):
    """``ssd_ref`` at ``chunk`` for any S: S is zero-padded up to a multiple
    of ``chunk`` (zero rows add nothing to earlier rows of a causal scan)
    and y cut back to S.  At the kernel's chunk this is the plain version
    chunked exactly as the CUDA kernel chunks, ragged last chunk included."""
    s = xs.shape[1]
    pad = -s % chunk
    padded = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (xs, bm, cm, dt)]
    return ssd_ref(*padded, a, chunk=chunk)[0][:, :s]


def ssd_backward_ref_padded(xs, bm, cm, dt, a, dy, *, chunk: int):
    """``ssd_backward_ref`` at ``chunk`` for any S, padded as
    ``ssd_ref_padded`` pads (zero rows add nothing to any gradient) and cut
    back to S: at the kernel's chunk, the plain backward chunked exactly as
    the CUDA backward chunks it."""
    s = xs.shape[1]
    pad = -s % chunk
    padded = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (xs, bm, cm, dt, dy)]
    grads = ssd_backward_ref(*padded[:4], a, padded[4], chunk=chunk)
    return *(g[:, :s] for g in grads[:4]), grads[4]


def segment_starts(n_chunks: int, segments: int) -> list[int]:
    """First chunk of each of ``segments`` segments of whole chunks, and
    ``n_chunks`` at the end: segment p is chunks [p nc / P, (p + 1) nc / P),
    at least one each (``segments <= n_chunks``).  The kernel cuts alike."""
    if not 1 <= segments <= n_chunks:
        raise ValueError(f"segments must be in 1..{n_chunks}, got {segments}")
    return [p * n_chunks // segments for p in range(segments + 1)]


def ssd_ref_segmented(xs, bm, cm, dt, a, *, chunk: int, segments: int):
    """``ssd_ref_padded`` computed as the CUDA kernel decomposes it.  The
    padded sequence is cut into ``segments`` segments of whole chunks
    (``segment_starts``).  Each segment but the last is scanned from a zero
    state for its end state L_p, and its decay D_p is the product, in chunk
    order, of exp(cum_last) over its chunks.  Segment p then starts from
    s = 0; s = s D_p' + L_p' for p' < p, in order, and is scanned from s.
    At one segment this is ``ssd_ref_padded`` exactly."""
    b, s, h, _ = xs.shape
    pad = -s % chunk
    xs, bm, cm, dt = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (xs, bm, cm, dt))
    nc = xs.shape[1] // chunk
    starts = [c * chunk for c in segment_starts(nc, segments)]
    cum_last = chunk_cumsum((dt * a).reshape(b, nc, chunk, h), 2)[:, :, -1]  # (B, nc, H)
    ys, carried = [], None
    for p in range(segments):
        part = [t[:, starts[p]:starts[p + 1]] for t in (xs, bm, cm, dt)]
        ys.append(ssd_ref(*part, a, chunk=chunk, state0=carried)[0])
        if p + 1 == segments:
            break
        _, end = ssd_ref(*part, a, chunk=chunk)  # L_p, from a zero state
        decay = torch.ones_like(cum_last[:, 0])
        for c in range(starts[p] // chunk, starts[p + 1] // chunk):
            decay = decay * torch.exp(cum_last[:, c])
        carried = end if carried is None else carried * decay[:, :, None, None] + end
    return torch.cat(ys, 1)[:, :s]


def _walk(contrib, decay, *, reverse: bool):
    """The state entering every chunk (forward: st <- st decay_c +
    contrib_c from chunk 0) or leaving it (reverse: from the last chunk
    down), as the backward kernel's state pass computes it.  contrib (B, H,
    nc, ...), decay (B, H, nc)."""
    nc = contrib.shape[2]
    tail = (None,) * (contrib.dim() - 3)
    out = torch.empty_like(contrib)
    st = torch.zeros_like(contrib[:, :, 0])
    for c in (range(nc - 1, -1, -1) if reverse else range(nc)):
        out[:, :, c] = st
        st = st * decay[:, :, c][(...,) + tail] + contrib[:, :, c]
    return out


def ssd_backward_ref_grouped(xs, bm, cm, dt, a, dy, *, chunk: int, group: int, matmul=None):
    """``ssd_backward_ref_padded`` computed as the backward kernel
    decomposes it -> (dxs, dbm, dcm, ddt, da).

    S is zero-padded to a multiple of ``chunk``.  The states are kept
    transposed (N x dh, as the kernel's fragments hold them): h_c entering
    chunk c by st <- exp(cum_L) st + (B o dt)^T x, dH_c leaving it by st <-
    exp(cum_L) st + (C e)^T dy from the last chunk down (``_walk``).  Every
    chunk's gradients then follow from its h and dH at once, with
    ``ssd_backward_ref``'s formulas; dbm and dcm are each head's share
    summed over groups of ``group`` consecutive
    heads (the last group may be short), in head order within a group, and
    the group sums added in group order; da is the chunks' shares summed
    over batch rows, then chunks, in order.  ``matmul(name, a, b)`` takes
    every product (``torch.matmul`` when None); the names are G (C B^T), P
    (dy x^T), dx (scores^T dy), vh (dy h), dC (scores B), dB (scores^T C),
    xd (x dH), u (B dH^T), state and dstate (the recurrences' products).
    ``split_precision.ssd_backward_emulated`` passes the kernel's split
    products."""
    mm = (lambda name, x, y: x @ y) if matmul is None else matmul  # noqa: E731
    b, s, h, dh = xs.shape
    n = bm.shape[-1]
    q = chunk
    xs, bm, cm, dt, dy = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, -s % q))
                          for t in (xs, bm, cm, dt, dy))
    nc = xs.shape[1] // q
    f = torch.promote_types(xs.dtype, torch.float32)

    def heads(t):  # (B, S, H, ...) -> (B, H, nc, Q, ...)
        return t.reshape(b, nc, q, h, -1).movedim(3, 1).to(f)

    x, y = heads(xs), heads(dy)
    bb, cc = (t.reshape(b, 1, nc, q, n).to(f) for t in (bm, cm))
    dtk = heads(dt)[..., 0]  # (B, H, nc, Q)
    cum = heads(chunk_cumsum((dt * a).reshape(b, nc, q, h), 2).reshape(b, nc * q, h))[..., 0]
    tk = heads(chunk_cumsum(dt.reshape(b, nc, q, h), 2).reshape(b, nc * q, h))[..., 0]
    e = torch.exp(cum)
    el = torch.exp(cum[..., -1])  # (B, H, nc)
    o = torch.exp(cum[..., -1:] - cum)
    odt = o * dtk

    hs = _walk(mm("state", (bb * odt[..., None]).transpose(-1, -2), x), el,
               reverse=False)  # (B, H, nc, N, dh)
    dhs = _walk(mm("dstate", (cc * e[..., None]).transpose(-1, -2), y), el, reverse=True)

    upper = ~torch.ones((q, q), dtype=torch.bool, device=xs.device).tril()
    lmat = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(upper, float("-inf")))
    g = mm("G", cc, bb.transpose(-1, -2))  # [t][s], shared by the heads
    p = mm("P", y, x.transpose(-1, -2))
    w = lmat * dtk[..., None, :]
    sg, sp = g * w, p * w
    z = p * g * lmat
    m = z * dtk[..., None, :]
    u = mm("u", bb, dhs)  # [s][d] = sum_n B[s][n] dH[d][n]
    vh = mm("vh", y, hs.transpose(-1, -2))  # [t][n] = sum_d dy[t][d] h[d][n]
    xd = mm("xd", x, dhs.transpose(-1, -2))  # [s][n] = sum_d x[s][d] dH[d][n]
    dx = mm("dx", sg.transpose(-1, -2), y) + odt[..., None] * u
    dc_h = mm("dC", sp, bb) + e[..., None] * vh
    db_h = mm("dB", sp.transpose(-1, -2), cc) + odt[..., None] * xd
    r = o * (x * u).sum(-1)
    ev = e * (vh * cc).sum(-1)
    hdh = el * (dhs * hs).sum((-1, -2))
    dcum = m.sum(-1) - m.sum(-2) + ev - r * dtk
    dcum = torch.cat([dcum[..., :-1], (dcum[..., -1] + hdh + (r * dtk).sum(-1))[..., None]], -1)
    dda = dcum.flip(-1).cumsum(-1).flip(-1)
    ddt = z.sum(-2) + r + dda * a[:, None, None]
    tdiff = (tk[..., :, None] - tk[..., None, :]).masked_fill(upper, 0.0)
    dap = ((m * tdiff).sum((-1, -2)) + (ev * tk + r * dtk * (tk[..., -1:] - tk)).sum(-1)
           + hdh * tk[..., -1])  # (B, H, nc)
    da = dap.movedim(1, 0).reshape(h, -1).cumsum(-1)[:, -1]  # batch rows, then chunks

    def grouped(t):  # (B, H, nc, Q, N) -> (B, S, N): heads summed by groups
        total = None
        for g0 in range(0, h, group):
            part = t[:, g0]
            for hh in range(g0 + 1, min(g0 + group, h)):
                part = part + t[:, hh]
            total = part if total is None else total + part
        return total.reshape(b, nc * q, n)[:, :s]

    def rows_of(t):  # (B, H, nc, Q, ...) -> (B, S, H, ...)
        return t.movedim(1, 3).reshape(b, nc * q, h, *t.shape[4:])[:, :s]

    return rows_of(dx), grouped(db_h), grouped(dc_h), rows_of(ddt[..., None])[..., 0], da
