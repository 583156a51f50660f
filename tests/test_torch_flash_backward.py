"""The port's differentiable flash attention against the JAX package's
custom VJP, and its plain backward against autograd, on the CPU.

``FlashAttention`` (the autograd Function the port's ``flash_attention``
applies when a gradient is wanted) runs its plain versions here:
``attention_ref_lse`` forward, ``flash_backward_ref`` backward.  It is held
to ``jax.grad`` of the JAX package's ``flash_attention`` on
``tests/test_kernels.py``'s ``SWEEP[:5]`` -- sizes where the JAX op takes
its blockwise path and custom VJP (``_backward``), not its naive fallback --
and ``flash_backward_ref``, written out from ``_bwd_block``'s formula, is
held to autograd through the port's own ``attention_ref``.  Same seeded
numpy inputs through both, f32.  The model of the CUDA backward's
arithmetic (``split_precision.flash_backward_emulated``) is held to the
same ``jax.grad`` on ``SWEEP[:5]``.  Pin: 1e-4 of max|ref| per gradient, the
JAX package's own gradient tolerance (``tests/test_kernels.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import SWEEP

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    attention_ref_lse,
    flash_backward_ref,
)
from repro_torch.kernels.split_precision import flash_backward_emulated

TOL = 1e-4


def _inputs(b, sq, skv, h, kh, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd), dtype=np.float32),
            rng.standard_normal((b, skv, kh, hd), dtype=np.float32),
            rng.standard_normal((b, skv, kh, hd), dtype=np.float32))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("case", SWEEP[:5])
def test_grads_match_jax_custom_vjp(case, monkeypatch):
    b, sq, skv, h, kh, hd, causal, window, softcap, block, _ = case
    q, k, v = _inputs(b, sq, skv, h, kh, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = jax.grad(lambda *a: (jax_flash_attention(*a, block=block, **kw) ** 2).sum(),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    calls = []
    backward = flash_ops.FlashAttention.backward
    monkeypatch.setattr(flash_ops.FlashAttention, "backward",
                        staticmethod(lambda ctx, do: calls.append(1) or backward(ctx, do)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (flash_attention(*ts, **kw) ** 2).sum().backward()
    assert calls == [1]  # the Function's own backward ran
    for name, t, w in zip("qkv", ts, want):
        err = _rel(t.grad.numpy(), w)
        assert err <= TOL, f"d{name}: {err:.3g} of max|ref| > {TOL}"


@pytest.mark.parametrize("case", SWEEP[:5])
def test_backward_model_matches_jax_grad(case):
    """The model of the backward kernel's arithmetic (``flash_backward_emulated``)
    on the port's plain residuals, against ``jax.grad`` of the JAX package's
    ``flash_attention`` on the same inputs (loss sum(o^2), so dO = 2 o)."""
    b, sq, skv, h, kh, hd, causal, window, softcap, block, _ = case
    q, k, v = _inputs(b, sq, skv, h, kh, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = jax.grad(lambda *a: (jax_flash_attention(*a, block=block, **kw) ** 2).sum(),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    o, lse = attention_ref_lse(*ts, **kw)
    got = flash_backward_emulated(*ts, o, lse, 2 * o, **kw)
    for name, g, w in zip("qkv", got, want):
        err = _rel(g.numpy(), w)
        assert err <= TOL, f"d{name}: {err:.3g} of max|ref| > {TOL}"


@pytest.mark.parametrize("b,s,h,kh,hd,causal,window,softcap", [
    (2, 48, 4, 2, 16, True, 0, 0.0),
    (1, 61, 6, 2, 32, True, 13, 50.0),
    (2, 40, 2, 2, 16, False, 0, 0.0),
    (1, 40, 4, 1, 16, False, 9, 5.0),
])
def test_backward_ref_matches_autograd(b, s, h, kh, hd, causal, window, softcap):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _inputs(b, s, s, h, kh, hd, 1))
    do = torch.from_numpy(np.random.default_rng(2).standard_normal((b, s, h, hd),
                                                                   dtype=np.float32))
    kw = dict(causal=causal, window=window, softcap=softcap)
    attention_ref(q, k, v, **kw).backward(do)
    o, lse = attention_ref_lse(q.detach(), k.detach(), v.detach(), **kw)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    assert torch.allclose(o, attention_ref(q, k, v, **kw), atol=1e-6)
    got = flash_backward_ref(q.detach(), k.detach(), v.detach(), o, lse, do, **kw)
    for name, g, t in zip("qkv", got, (q, k, v)):
        assert g.shape == t.shape and g.dtype == torch.float32
        err = _rel(g.numpy(), t.grad.numpy())
        assert err <= TOL, f"d{name}: {err:.3g} of max|autograd| > {TOL}"


def test_no_grad_serving_path_keeps_attention_ref():
    """Without a gradient the op is the plain forward, bit for bit; bf16
    inputs come back in bf16 with bf16 gradients."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 32, 32, 4, 2, 16, 3))
    with torch.no_grad():
        assert torch.equal(flash_attention(q, k, v, window=5),
                           attention_ref(q, k, v, window=5))
    qb, kb, vb = (t.bfloat16().requires_grad_() for t in (q, k, v))
    o = flash_attention(qb, kb, vb, softcap=50.0)
    assert o.dtype == torch.bfloat16 and o.grad_fn is not None
    o.float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in (qb, kb, vb))


@pytest.mark.parametrize("causal,softcap", [(False, 0.0), (True, 50.0)], ids=["cross", "causal"])
def test_cross_length_attend_takes_the_plain_path(causal, softcap, monkeypatch):
    """``layers.attend`` at Sq = 2048 against Skv = 1500 (whisper's decoder
    over an encoder of another length): the output and the gradients in q,
    k, v match the JAX package's ``layers.attend`` within 1e-4 of max|ref|,
    and the flash op is never called, since its kernel takes Sq == Skv only
    (the JAX op sends these shapes to its dense reference).  Self-attention
    of the same length still takes the flash op."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    q, k, v = _inputs(1, 2048, 1500, 4, 2, 16, 5)
    w = np.random.default_rng(6).standard_normal(q.shape, dtype=np.float32)
    jspec = jlayers.AttnSpec(causal=causal, softcap=softcap)
    tspec = tlayers.AttnSpec(causal=causal, softcap=softcap)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_o = jlayers.attend(jq, jk, jv, jspec)
    want_g = jax.grad(lambda *a: (jlayers.attend(*a, jspec) * w).sum(), argnums=(0, 1, 2))(
        jq, jk, jv)

    calls = []
    op = tlayers.flash_attention
    monkeypatch.setattr(tlayers, "flash_attention", lambda *a, **kw: calls.append(1) or op(*a, **kw))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tlayers.attend(*ts, tspec)
    (o * torch.from_numpy(w)).sum().backward()
    assert calls == [] and o.shape == q.shape
    assert _rel(o.detach().numpy(), want_o) <= TOL
    for name, t, g in zip("qkv", ts, want_g):
        err = _rel(t.grad.numpy(), g)
        assert err <= TOL, f"d{name}: {err:.3g} of max|ref| > {TOL}"
    tlayers.attend(*(torch.from_numpy(a) for a in _inputs(1, 2048, 2048, 4, 2, 16, 7)), tspec)
    assert calls == [1]
