"""The split-precision arithmetic of the tensor-core kernels, in plain PyTorch.

``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``,
``csrc/quantize.cu`` (dequant_matmul), ``csrc/ssd_scan.cu``,
``csrc/ssd_scan_bwd.cu`` and ``csrc/gemm_f32.cu`` (demo_transformer's f32
products, ``matmul_3xtf32``) take their products on the TF32 tensor cores (the
SSD scan with the cheaper truncating split, ``split_trunc``; the flash
backward with Veltkamp's split on the f32 pipe, ``split_fp``, for S and the
truncating one for its other products; the SSD backward with the
truncating split everywhere).
One TF32 pass keeps 10 mantissa
bits, too few for the f32 pins, so each f32 operand x is split into
``hi = tf32_rna(x)`` and ``lo = tf32_rna(x - hi)`` and a product is
``a_lo.b_hi + a_hi.b_lo + a_hi.b_hi`` (3 passes).  int8 codes are exact in
TF32, so dequant_matmul takes ``q.w_lo + q.w_hi`` (2 passes) per
quantisation block and scales each block's sum by its scale.

This module models that arithmetic with every product exact and every sum
rounded to nearest (an f32 matmul with TF32 off): it is what the scheme
costs in accuracy, apart from the order and rounding of the tensor cores'
own accumulation, which the card adds.  It also models the bf16 routes the
bounds in ``chip_smoke.py`` weigh (``split_bf16``).  The served path never
calls it; ``tests/test_torch_split_precision.py`` and ``chip_smoke.py
--profile`` do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan.ref import chunk_cumsum, ssd_backward_ref_grouped

TF32_LOW_BITS = 0x1FFF  # the 13 mantissa bits TF32 drops


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32, to nearest with ties away from zero (``cvt.rna``):
    add half of the dropped range to the magnitude bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~TF32_LOW_BITS).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x as TF32 hi + lo, 21 bits of it."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 with its 13 low mantissa bits cleared: truncated to TF32."""
    return (x.contiguous().view(torch.int32) & ~TF32_LOW_BITS).view(torch.float32)


def split_trunc(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x as hi + lo the cheap way (``split_tf32::split_trunc``): hi = x
    truncated, lo = x - hi (exact in f32), of which the tensor core reads
    the top 10 mantissa bits -- modelled as truncated too: 20 bits of x."""
    hi = tf32_trunc(x)
    return hi, tf32_trunc(x - hi)


def split_fp(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x as hi + lo by f32 arithmetic alone (``split_tf32::split_fp``,
    Veltkamp's split): c = x (2^13 + 1), hi = c - (c - x), x rounded to 11
    significant bits; lo = x - hi exactly, of which the tensor core reads the
    top 11 bits -- modelled as truncated to TF32."""
    c = x * 8193.0
    hi = c - (c - x)
    return hi, tf32_trunc(x - hi)


def split_bf16(x: torch.Tensor, pieces: int) -> list[torch.Tensor]:
    """x as a sum of ``pieces`` bf16 values (round to nearest even), largest
    first: two keep 16 bits of x, three all 24."""
    out, rest = [], x
    for _ in range(pieces):
        part = rest.to(torch.bfloat16).to(torch.float32)
        out.append(part)
        rest = rest - part
    return out


def matmul_split3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32-accurate a @ b from three TF32 products, small terms first."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def matmul_split3_trunc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``matmul_split3`` with the truncating split."""
    ah, al = split_trunc(a)
    bh, bl = split_trunc(b)
    return al @ bh + ah @ bl + ah @ bh


def matmul_split3_fp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``matmul_split3`` with the flash backward's f32-pipe split."""
    ah, al = split_fp(a)
    bh, bl = split_fp(b)
    return al @ bh + ah @ bl + ah @ bh


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 pass: what the tensor cores give without the split."""
    return tf32_rna(a) @ tf32_rna(b)


def matmul_bf16x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from two bf16 pieces of each operand, three bf16 products."""
    ah, al = split_bf16(a, 2)
    bh, bl = split_bf16(b, 2)
    return al @ bh + ah @ bl + ah @ bh


def attention_emulated(q, k, v, *, causal, window, softcap, matmul=matmul_split3):
    """The flash kernel's arithmetic: q pre-scaled by hd^-0.5, S = Q K^T and
    O = P V through ``matmul``, P = exp(s - rowmax) unnormalised, O / l."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    qg = (q * hd**-0.5).reshape(b, s, kh, h // kh, hd).permute(0, 2, 3, 1, 4)
    logits = matmul(qg, k.permute(0, 2, 3, 1)[:, :, None])  # (b, kh, g, s, s)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= pos[:, None] >= pos[None, :]
    if window > 0:
        ok &= pos[:, None] - pos[None, :] < window
    logits = logits.masked_fill(~ok, float("-inf"))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    o = matmul(p, v.permute(0, 2, 1, 3)[:, :, None]) / p.sum(-1, keepdim=True)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)


def flash_backward_emulated(q, k, v, o, lse, do, *, causal, window, softcap):
    """The flash backward kernel's arithmetic -> (dq, dk, dv), f32.

    S through ``matmul_split3_fp`` (the kernel's rounded split; q.k scaled
    after the product), dP and the three accumulations through
    ``matmul_split3_trunc`` (its truncating split); p and ds as the kernel
    forms them (exp of the capped, masked logit minus lse; p (dp - D) (1 -
    r^2)); dv and dk summed over the 32-query tiles from the last down and
    within each over the G query heads, one product a tile (the dK/dV
    kernel's fresh fragment) added in f32, dk scaled at the end; dq summed
    over the 32-key tiles in increasing order, one product a tile (the dQ
    kernel's), then scaled.  A tile the masks leave dead adds exact zeros.
    Sq may differ from Skv (queries at positions 0..Sq-1, as the plain
    version masks)."""
    from repro_torch.kernels.flash_attention.kernel import BWD_TILE

    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = hd**-0.5
    qg = q.reshape(b, sq, kh, g, hd).permute(0, 2, 3, 1, 4)  # (b, kh, g, sq, hd)
    dog = do.reshape(b, sq, kh, g, hd).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 1, 3)[:, :, None]  # (b, kh, 1, skv, hd)
    vt = v.permute(0, 2, 1, 3)[:, :, None]
    s = matmul_split3_fp(qg, kt.transpose(-1, -2)) * scale  # (b, kh, g, sq, skv)
    dcap = None
    if softcap > 0:
        r = torch.tanh(s / softcap)
        s, dcap = softcap * r, 1.0 - r * r
    qpos, kpos = torch.arange(sq, device=q.device), torch.arange(skv, device=q.device)
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        ok &= qpos[:, None] - kpos[None, :] < window
    p = torch.where(ok, torch.exp(s - lse.reshape(b, kh, g, sq)[..., None]), 0.0)
    mm = matmul_split3_trunc
    dp = mm(dog, vt.transpose(-1, -2))
    d = (o * do).sum(-1).reshape(b, sq, kh, g).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - d)
    if dcap is not None:
        ds = ds * dcap
    dk = torch.zeros((b, kh, skv, hd), dtype=q.dtype, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in reversed(range(0, sq, BWD_TILE)):
        rows = slice(q0, q0 + BWD_TILE)
        for gi in range(g):
            dv = dv + mm(p[:, :, gi, rows].transpose(-1, -2), dog[:, :, gi, rows])
            dk = dk + mm(ds[:, :, gi, rows].transpose(-1, -2), qg[:, :, gi, rows])
    dq = torch.zeros_like(qg)
    for k0 in range(0, skv, BWD_TILE):
        cols = slice(k0, k0 + BWD_TILE)
        dq = dq + mm(ds[..., cols], kt[:, :, :, cols])
    return ((dq * scale).permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd),
            (dk * scale).permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3))


def dequant_matmul_emulated(q, scale, w, block, w_pieces=None):
    """The fused receive's arithmetic: per quantisation block, the codes
    (exact in TF32 and in bf16) times each piece of w, small pieces first,
    summed; the block's sum scaled by its scale into the output.  w is
    split as the kernel splits it (TF32 hi + lo), or into ``w_pieces`` bf16
    pieces."""
    codes = q.to(torch.float32)
    parts = split(w)[::-1] if w_pieces is None else split_bf16(w, w_pieces)[::-1]
    out = torch.zeros((q.shape[0], w.shape[1]), dtype=torch.float32, device=w.device)
    for blk, k0 in enumerate(range(0, q.shape[1], block)):
        c = codes[:, k0:k0 + block]
        part = sum(c @ p[k0:k0 + block] for p in parts)
        out = torch.addcmul(out, scale[:, blk:blk + 1], part)
    return out


def ssd_emulated(xs, bm, cm, dt, a, *, chunk: int = 64, matmul=matmul_split3_trunc):
    """The SSD kernel's arithmetic (one segment): per chunk of ``chunk``
    rows, C state^T, C B^T, scores x and (B w)^T x through ``matmul`` (the
    kernel's truncating split-TF32 by default); cum
    in the plain version's order, the decays, the mask before exp and the
    scaling by dt in f32, as the kernel keeps them on the FMA units.
    -> y (B, S, H, dh)."""
    b, s, h, dh = xs.shape
    n = bm.shape[-1]
    pad = -s % chunk
    xs, bm, cm, dt = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (xs, bm, cm, dt))
    nc = xs.shape[1] // chunk
    cum = chunk_cumsum((dt * a).reshape(b, nc, chunk, h), 2).permute(0, 1, 3, 2)  # (B, nc, H, q)
    dts = dt.reshape(b, nc, chunk, h).permute(0, 1, 3, 2)
    upper = ~torch.ones((chunk, chunk), dtype=torch.bool, device=xs.device).tril()
    state_t = torch.zeros((b, h, n, dh), dtype=xs.dtype, device=xs.device)  # state^T
    ys = []
    for c in range(nc):
        rows = slice(c * chunk, (c + 1) * chunk)
        x = xs[:, rows].permute(0, 2, 1, 3)  # (B, H, q, dh)
        bk, ck = bm[:, rows, None].transpose(1, 2), cm[:, rows, None].transpose(1, 2)  # (B, 1, q, N)
        cu, dk = cum[:, c], dts[:, c]  # (B, H, q)
        y_out = matmul(ck, state_t)
        lmat = torch.exp((cu[..., :, None] - cu[..., None, :]).masked_fill(upper, float("-inf")))
        scores = matmul(ck, bk.transpose(-1, -2)) * lmat * dk[..., None, :]
        ys.append(matmul(scores, x) + y_out * torch.exp(cu)[..., None])
        bw = bk * (torch.exp(cu[..., -1:] - cu) * dk)[..., None]  # (B, H, q, N)
        state_t = state_t * torch.exp(cu[..., -1])[..., None, None] + matmul(bw.transpose(-1, -2), x)
    return torch.cat(ys, 2).permute(0, 2, 1, 3)[:, :s]


SSD_BWD_K_GROUP = 32  # k a fresh fragment takes (4 mma k steps, 12 mma), then an f32 add


def matmul_split3_k(a, b, split_fn, k_group: int = SSD_BWD_K_GROUP):
    """a @ b in three split passes (``split_fn``), small terms first, over
    k in groups of ``k_group`` summed in f32 in order: the kernels' fresh
    fragments."""
    out = None
    for k0 in range(0, a.shape[-1], k_group):
        ah, al = split_fn(a[..., k0:k0 + k_group])
        bh, bl = split_fn(b[..., k0:k0 + k_group, :])
        part = al @ bh + ah @ bl + ah @ bh
        out = part if out is None else out + part
    return out


def ssd_backward_emulated(xs, bm, cm, dt, a, dy, *, group: int = 8, matmul=None):
    """The SSD backward kernel's arithmetic -> (dxs, dbm, dcm, ddt, da), f32.

    The kernel's decomposition (``ssm_scan.ref.ssd_backward_ref_grouped``
    at its chunk of 64: whole state walks, head groups summing dbm and dcm
    in head order) with every product in split-TF32, each operand split
    by ``split_trunc`` as the kernel splits it, over fresh fragments of 32 k;
    or every product through ``matmul`` (one TF32 pass: ``matmul_tf32``).
    The masks, decays, scalings and the row vectors' sums stay in f32, as
    the kernel keeps them on the FMA units."""
    from repro_torch.kernels.ssm_scan.kernel import KERNEL_CHUNK

    def product(name, x, y):
        return matmul(x, y) if matmul is not None else matmul_split3_k(x, y, split_trunc)

    return ssd_backward_ref_grouped(xs, bm, cm, dt, a, dy, chunk=KERNEL_CHUNK, group=group,
                                    matmul=product)


GEMM_K_SLICE = 32  # k the f32 GEMM's fresh fragment takes (12 wgmma), then an f32 add


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The f32 GEMM's arithmetic (``csrc/gemm_f32.cu``): both operands split
    by ``split`` (the activation in the kernel, the weight once a version
    into its planes), a_lo.b_hi + a_hi.b_lo + a_hi.b_hi over slices of 32 k,
    the slices' sums added in f32 in order."""
    return matmul_split3_k(a, b, split, k_group=GEMM_K_SLICE)
