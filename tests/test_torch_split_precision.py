"""The split-precision arithmetic of the port's tensor-core kernels, on the CPU.

``repro_torch.kernels.split_precision`` models the kernels' products:
split-TF32 (3 passes for attention, 2 for the fused receive's exact int8
codes), with every product exact and every sum rounded to nearest -- the
rounding of the operands, not the order or rounding of the tensor cores'
own accumulation, which only the card shows (``chip_smoke.py --profile``
holds the kernel against this model there).  Here the model is held, on the
same numpy-seeded inputs, against the port's plain versions and the JAX
package's references (its ``attention_ref``, and its ``dequant_matmul`` on
the jnp path and through the Pallas kernel in interpret mode, as its own
tests run them): 2e-5 max-abs for attention, 2e-5 of max|ref| for the
flash backward (its model also against an f64 run), 1e-5 of max|ref| for
dequant_matmul, the pins the kernels are held to on the card; the SSD
backward's model within half of its 5e-6 pin of the plain backward, and
within the JAX package's 1e-4 of ``jax.grad`` of its scan.

It also weighs the bf16 routes that ``chip_smoke.py``'s bounds consider: a
route counts as holding a pin when the model lands within half of it,
leaving the other half to the card's accumulation.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.quantize import dequant_matmul as jax_dequant_matmul
from repro.kernels.quantize.ref import quantize_ref as jax_quantize_ref
from repro.kernels.ssm_scan.kernel import ssd_chunked_tpu as jax_ssd_chunked_tpu
from repro.kernels.ssm_scan.ref import ssd_ref as jax_ssd_ref
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    attention_ref_lse,
    flash_backward_ref,
)
from repro_torch.kernels.quantize.ref import dequant_matmul_ref
from repro_torch.kernels.split_precision import (
    TF32_LOW_BITS,
    attention_emulated,
    dequant_matmul_emulated,
    flash_backward_emulated,
    matmul_bf16x3,
    matmul_tf32,
    split,
    split_bf16,
    split_trunc,
    ssd_backward_emulated,
    ssd_emulated,
    tf32_rna,
)
from repro_torch.kernels.ssm_scan.ref import ssd_backward_ref_padded, ssd_ref_padded

TOL_FLASH = 2e-5
TOL_DQMM = 1e-5
TOL_SSD = 1e-5
TOL_SSD_BWD = 5e-6  # chip_smoke.TOL_SSD_BWD: of max|plain| per gradient
LOW_BITS = TF32_LOW_BITS
CARD_SHARE = 0.5  # of a pin, left to the tensor cores' accumulation


def _normal(shape, seed, scale=1.0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * scale


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.5, 3e4])
def test_hi_plus_lo_rebuilds_x(scale):
    x = torch.from_numpy(_normal((4096,), 0, scale))
    hi, lo = split(x)
    for part in (hi, lo):  # what the tensor core reads: nothing in the dropped bits
        assert not (part.view(torch.int32) & LOW_BITS).any()
    # 11 bits of x in hi, the rounded remainder in lo: x within 2^-21
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert (err <= 2.0**-21 * x.double().abs()).all()
    # hi alone is one TF32 rounding: within 2^-11 of x, and no closer in general
    rel = ((hi - x).abs() / x.abs()).max().item()
    assert 2.0**-14 < rel <= 2.0**-11


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.5, 3e4])
def test_truncating_split_rebuilds_x(scale):
    """The SSD kernel's two-instruction split: hi truncated, lo the exact
    remainder, read by the tensor core to 10 bits -- x within 2^-20."""
    x = torch.from_numpy(_normal((4096,), 1, scale))
    hi, lo = split_trunc(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & LOW_BITS).any()
    assert (hi.abs() <= x.abs()).all()  # truncation, towards zero
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert (err <= 2.0**-20 * x.double().abs()).all()


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0**-10  # a TF32 value; the next is one + 2^-10
    ties = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), one + 2.0**-11], dtype=torch.float32)
    below = torch.tensor([1.0 + 2.0**-11 - 2.0**-23], dtype=torch.float32)
    assert tf32_rna(ties).tolist() == [one, -one, one + 2.0**-10]
    assert tf32_rna(below).tolist() == [1.0]


FLASH_CASES = [  # (window, softcap, g)
    (0, 50.0, 2), (40, 50.0, 2), (40, 50.0, 1), (0, 0.0, 2), (1, 50.0, 4),
]


@pytest.mark.parametrize("window,softcap,g", FLASH_CASES)
def test_attention_split3_holds_the_f32_pin(window, softcap, g):
    """S=256, hd=128, unit-scale inputs: within 2e-5 of the port's plain
    version and of the JAX package's ``attention_ref``."""
    q, k, v = _normal((1, 256, 2 * g, 128), 1), _normal((1, 256, 2, 128), 2), _normal((1, 256, 2, 128), 3)
    emulated = attention_emulated(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  causal=True, window=window, softcap=softcap)
    plain = attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=True, window=window, softcap=softcap)
    jax_ref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=True, window=window, softcap=softcap)
    assert _max_abs(emulated, plain) <= TOL_FLASH
    assert _max_abs(emulated, jax_ref) <= TOL_FLASH


def test_attention_one_tf32_pass_breaks_the_pin():
    """Why the split: one TF32 pass lands ~1e-3 from the f32 version."""
    q, k, v = (torch.from_numpy(_normal((1, 256, 4 if i == 0 else 2, 128), i + 1)) for i in range(3))
    one_pass = attention_emulated(q, k, v, causal=True, window=0, softcap=50.0, matmul=matmul_tf32)
    plain = attention_ref(q, k, v, causal=True, window=0, softcap=50.0)
    assert _max_abs(one_pass, plain) > 10 * TOL_FLASH


@pytest.mark.parametrize("seed", [1, 7])
def test_attention_two_bf16_pieces_leave_no_room(seed):
    """Why attention's bound stays at 3 TF32 passes: two bf16 pieces of each
    operand (3 passes at twice the TF32 rate) land over half the 2e-5 pin
    in the model alone, ~10x the split-TF32 error; three pieces would take
    6 bf16 passes, the same time as 3 TF32 ones."""
    q, k, v = (torch.from_numpy(_normal((1, 256, 4 if i == 0 else 2, 128), seed + i))
               for i in range(3))
    plain = attention_ref(q, k, v, causal=True, window=0, softcap=50.0)
    bf16 = attention_emulated(q, k, v, causal=True, window=0, softcap=50.0, matmul=matmul_bf16x3)
    split3 = attention_emulated(q, k, v, causal=True, window=0, softcap=50.0)
    assert _max_abs(bf16, plain) > CARD_SHARE * TOL_FLASH
    assert _max_abs(bf16, plain) > 5 * _max_abs(split3, plain)


def test_attention_split3_at_large_scale_as_accurate_as_f32():
    """std 5, softcap 50: f32 itself is ~7e-5 from f64 here, so the kernel's
    scheme is held to f64 at twice the plain f32 version's own error."""
    q, k, v = (torch.from_numpy(_normal((1, 256, 4 if i == 0 else 2, 128), 10 + i, 5.0))
               for i in range(3))
    exact = attention_emulated(q.double(), k.double(), v.double(), causal=True, window=0,
                               softcap=50.0, matmul=torch.matmul)
    plain = attention_ref(q, k, v, causal=True, window=0, softcap=50.0)
    emulated = attention_emulated(q, k, v, causal=True, window=0, softcap=50.0)
    assert _max_abs(emulated, exact) <= 2 * _max_abs(plain, exact)


FLASH_BWD_CASES = [  # (s, h, kh, hd, causal, window, softcap)
    (300, 1, 1, 64, True, 0, 50.0),     # G = 1, causal, soft-capped; S ragged to every tile
    (300, 4, 1, 80, True, 5, 0.0),      # G = 4, a window below one tile
    (257, 8, 1, 160, True, 0, 0.0),     # G = 8 where warp pairs share 16 keys
    (200, 8, 1, 256, True, 7, 50.0),
    (129, 4, 1, 64, False, 0, 0.0),     # non-causal
    (161, 2, 2, 160, False, 0, 50.0),
    (1, 4, 1, 80, True, 0, 0.0),        # one token: dq and dk are 0 in exact math
]


@pytest.mark.parametrize("s,h,kh,hd,causal,window,softcap", FLASH_BWD_CASES)
def test_flash_backward_model_holds_the_pin(s, h, kh, hd, causal, window, softcap):
    """The backward kernel's arithmetic (``flash_backward_emulated``: its
    split, its tiles, its orders of summation) within 2e-5 of max|ref| of
    ``flash_backward_ref`` in f32 and of an f64 run of it, on the same plain
    residuals; at S=1, dq and dk (rounding noise around 0) are held to
    2e-5 of max|dv|."""
    q, k, v = (torch.from_numpy(_normal((1, s, n, hd), 60 + i)) for i, n in enumerate((h, kh, kh)))
    do = torch.from_numpy(_normal((1, s, h, hd), 63))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = attention_ref_lse(q, k, v, **kw)
    model = flash_backward_emulated(q, k, v, o, lse, do, **kw)
    plain = flash_backward_ref(q, k, v, o, lse, do, **kw)
    exact = [t.double() for t in (q, k, v)]
    o64, lse64 = attention_ref_lse(*exact, **kw)
    f64 = flash_backward_ref(*exact, o64, lse64, do.double(), **kw)
    floor = float(plain[2].abs().max()) if s == 1 else 0.0
    for got, ref32, ref64 in zip(model, plain, f64):
        assert got.shape == ref32.shape and got.dtype == torch.float32
        assert _max_abs(got, ref32) <= TOL_FLASH * max(float(ref32.abs().max()), floor)
        assert _max_abs(got, ref64) <= TOL_FLASH * max(float(ref64.abs().max()), floor)


DQMM_CASES = [  # (n, d, dout, block)
    (64, 512, 256, 128), (64, 512, 256, 256), (33, 300, 70, 128), (1, 256, 16, 128),
]


@pytest.mark.parametrize("n,d,dout,block", DQMM_CASES)
def test_dequant_matmul_two_passes_hold_the_pin(n, d, dout, block):
    """Exact codes, w split into hi + lo: within 1e-5 of max|ref| of the
    port's plain version and of the JAX package's dequant_matmul (the jnp
    path and the Pallas kernel in interpret mode)."""
    x, w = _normal((n, d), 5), _normal((d, dout), 6, 0.3)
    jq, js = jax_quantize_ref(jnp.asarray(x), block)
    q, s = torch.tensor(np.asarray(jq)), torch.tensor(np.asarray(js))
    emulated = dequant_matmul_emulated(q, s, torch.from_numpy(w), block)
    plain = dequant_matmul_ref(q, s, torch.from_numpy(w), dtype=torch.float32, block=block)
    scale = float(plain.abs().max())
    assert _max_abs(emulated, plain) <= TOL_DQMM * scale
    for use_pallas in (False, True):
        want = jax_dequant_matmul(jq, js, jnp.asarray(w), dtype=jnp.float32, block=block,
                                  use_pallas=use_pallas, interpret=use_pallas)
        assert _max_abs(emulated, want) <= TOL_DQMM * scale


@pytest.mark.parametrize("n,d,dout,block", DQMM_CASES + [(256, 4096, 512, 256)])
def test_dequant_matmul_two_bf16_pieces_hold_the_pin(n, d, dout, block):
    """Why the fused receive's bound is 2 bf16 passes: the codes are exact in
    bf16 and w in two bf16 pieces (16 bits) lands within half the 1e-5 pin
    of the plain version; one piece does not."""
    x, w = _normal((n, d), 5), torch.from_numpy(_normal((d, dout), 6, 0.3))
    q, s = (torch.tensor(np.asarray(t)) for t in jax_quantize_ref(jnp.asarray(x), block))
    plain = dequant_matmul_ref(q, s, w, dtype=torch.float32, block=block)
    scale = float(plain.abs().max())
    assert _max_abs(dequant_matmul_emulated(q, s, w, block, w_pieces=2), plain) <= (
        CARD_SHARE * TOL_DQMM * scale)
    assert _max_abs(dequant_matmul_emulated(q, s, w, block, w_pieces=1), plain) > TOL_DQMM * scale


def test_bf16_pieces_rebuild_x():
    """Two bf16 pieces keep x within 2^-16, three rebuild it exactly."""
    x = torch.from_numpy(_normal((4096,), 0))
    two, three = split_bf16(x, 2), split_bf16(x, 3)
    assert ((two[0] + two[1]).double() - x.double()).abs().le(2.0**-16 * x.double().abs()).all()
    assert torch.equal(three[0].double() + three[1].double() + three[2].double(), x.double())


def test_dequant_matmul_codes_need_no_lo():
    """Every int8 code is exact in TF32: its lo is zero, so 2 passes suffice."""
    codes = torch.arange(-127, 128, dtype=torch.float32)
    hi, lo = split(codes)
    assert torch.equal(hi, codes) and not lo.any()


def _ssd_inputs(b, s, h, dh, n, seed):
    xs, bm, cm = _normal((b, s, h, dh), seed, 0.5), _normal((b, s, n), seed + 1, 0.5), \
        _normal((b, s, n), seed + 2, 0.5)
    dt = np.log1p(np.exp(_normal((b, s, h), seed + 3)))  # softplus
    a = -np.exp(_normal((h,), seed + 4, 0.3))
    return [np.asarray(t, np.float32) for t in (xs, bm, cm, dt, a)]


SSD_CASES = [  # (b, s, h, dh, n, the JAX package's chunk)
    (2, 256, 4, 64, 32, 64), (1, 512, 8, 64, 64, 128), (1, 192, 2, 64, 64, 64), (2, 8, 2, 12, 4, 8),
]


@pytest.mark.parametrize("b,s,h,dh,n,chunk", SSD_CASES)
def test_ssd_split3_holds_half_the_pin(b, s, h, dh, n, chunk):
    """The SSD kernel's four products in split-TF32 (at its own chunk of
    64): within half the 1e-5 pin of max|ref| of the JAX package's
    ``ssd_ref`` and of its Pallas kernel in interpret mode (``ssd_chunked_tpu``
    at the same chunk), leaving the other half to the tensor cores'
    accumulation on the card."""
    arrays = _ssd_inputs(b, s, h, dh, n, 20)
    emulated = ssd_emulated(*(torch.from_numpy(t) for t in arrays))
    jargs = [jnp.asarray(t) for t in arrays]
    for want in (jax_ssd_ref(*jargs, chunk=chunk)[0],
                 jax_ssd_chunked_tpu(*jargs, chunk=chunk, interpret=True)):
        assert _max_abs(emulated, want) <= CARD_SHARE * TOL_SSD * float(np.abs(want).max())


def test_ssd_split3_matches_the_plain_version_slow_decay():
    """dt / 100, so the state carries across many chunks and C state^T and
    the state update weigh in: still within half the pin of the plain
    version at the same chunk."""
    xs, bm, cm, dt, a = (torch.from_numpy(t) for t in _ssd_inputs(1, 640, 3, 64, 64, 30))
    args = (xs, bm, cm, dt * 0.01, a)
    plain = ssd_ref_padded(*args, chunk=64)
    assert _max_abs(ssd_emulated(*args), plain) <= CARD_SHARE * TOL_SSD * float(plain.abs().max())


def test_ssd_one_tf32_pass_breaks_the_pin():
    """Why the split: one TF32 pass of each product lands ~5e-4 of max|y| off."""
    arrays = _ssd_inputs(2, 256, 4, 64, 32, 20)
    one_pass = ssd_emulated(*(torch.from_numpy(t) for t in arrays), matmul=matmul_tf32)
    want = jax_ssd_ref(*(jnp.asarray(t) for t in arrays), chunk=64)[0]
    assert _max_abs(one_pass, want) > 10 * TOL_SSD * float(np.abs(want).max())


SSD_BWD_CASES = [  # (b, s, h, dh, n, dt scale): chip_smoke's sweep (f), cut to the CPU
    (2, 256, 4, 64, 32, 1.0), (2, 256, 4, 64, 32, 0.01), (1, 512, 8, 64, 64, 1.0),
    (1, 512, 8, 64, 64, 0.01),
    (1, 40, 3, 64, 64, 1.0),       # one ragged chunk
    (1, 1000, 2, 22, 37, 0.01),    # ragged, dh and N below 64 and not multiples of 4
    (1, 512, 2, 64, 16, 200.0),    # strong decay, a = (-5, -0.5)
    (1, 256, 10, 64, 64, 0.01),    # a short head group (10 = 8 + 2)
]


def _ssd_bwd_args(b, s, h, dh, n, scale, seed):
    xs, bm, cm, dt, a = (torch.from_numpy(t) for t in _ssd_inputs(b, s, h, dh, n, seed))
    if scale == 200.0:
        a = torch.tensor([-5.0, -0.5])
    return xs, bm, cm, dt * scale, a, torch.from_numpy(_normal((b, s, h, dh), seed + 5))


@pytest.mark.parametrize("b,s,h,dh,n,scale", SSD_BWD_CASES)
def test_ssd_backward_model_holds_half_the_pin(b, s, h, dh, n, scale):
    """The backward kernel's arithmetic (``ssd_backward_emulated``: its
    whole state walks, head groups of 8, truncating split-TF32 products over
    fresh fragments of 32 k) within half the 5e-6 pin of max|ref| of the plain
    backward at the kernel's chunk, per gradient, leaving the other half to
    the tensor cores' accumulation."""
    args = _ssd_bwd_args(b, s, h, dh, n, scale, 70)
    model = ssd_backward_emulated(*args)
    plain = ssd_backward_ref_padded(*args, chunk=64)
    for name, got, want in zip(("dxs", "dbm", "dcm", "ddt", "da"), model, plain):
        assert got.shape == want.shape and bool(torch.isfinite(got).all()), name
        assert _max_abs(got, want) <= CARD_SHARE * TOL_SSD_BWD * float(want.abs().max()), name


def test_ssd_backward_model_matches_jax_grad():
    """The model against ``jax.grad`` of the JAX package's ``ssd_ref`` from
    the same numpy inputs, within the JAX package's gradient tolerance of
    1e-4 of max|ref|.  At chunk 64: the JAX gradient is NaN once a chunk
    decays by more than 88 (its mask comes after exp), as at 128 here."""
    import jax

    arrays = _ssd_inputs(1, 256, 4, 64, 32, 80)
    dy = _normal((1, 256, 4, 64), 85)
    model = ssd_backward_emulated(*(torch.from_numpy(t) for t in arrays), torch.from_numpy(dy))

    def loss(*t):
        return jnp.sum(jax_ssd_ref(*t, chunk=64)[0] * jnp.asarray(dy))

    want = jax.grad(loss, argnums=tuple(range(5)))(*(jnp.asarray(t) for t in arrays))
    for got, w in zip(model, want):
        assert _max_abs(got, w) <= 1e-4 * float(np.abs(np.asarray(w)).max())


def test_ssd_backward_one_tf32_pass_breaks_the_pin():
    """Why the split: one TF32 pass of each product lands ~5e-4 of max|ref| off."""
    args = _ssd_bwd_args(2, 256, 4, 64, 32, 1.0, 70)
    one_pass = ssd_backward_emulated(*args, matmul=matmul_tf32)
    plain = ssd_backward_ref_padded(*args, chunk=64)
    worst = max(_max_abs(g, w) / float(w.abs().max()) for g, w in zip(one_pass, plain))
    assert worst > 10 * TOL_SSD_BWD
