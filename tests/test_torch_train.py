"""The port's training path against the JAX package, on the CPU.

``lm.loss_fn`` and its gradient in every param leaf (``runtime.train``'s
``_value_and_grad``) against ``jax.value_and_grad`` of the JAX
``loss_fn``, for every arch of the zoo at ``reduced()`` with params cast
to f32, at S = 16 and at S = 2048, where ``attend`` takes the flash op on
both sides (the port's ``FlashAttention`` Function, the JAX
custom VJP) and zamba2's scan runs ``SSDScan``'s plain backward; remat
on and off; ``adamw_update`` on the same numpy state and gradients as the
JAX one; microbatch accumulation, warmup, clipping and the moments' dtype
as ``tests/test_train_runtime.py`` checks them; and every arch of the zoo
training at ``reduced()``, its loss falling over 4 steps as
``tests/test_arch_smoke.py`` asks of the JAX package.  Tolerances:
``tests/_lm_parity.py``'s ``TOL_F32`` (1e-4 of max|ref|) per leaf,
xlstm-125m's at twice the JAX package's own spread (in norm at S = 2048); AdamW
1e-6 of max|ref| in f32 and one bf16 ulp in bf16.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _lm_parity import (
    MAX_POS,
    TOL_F32,
    as_f32,
    assert_trees_close,
    batch_np,
    both_params,
    configs,
    jlm,
    leaves,
    one_thread,
    rel_err,
    tlm,
    to_jax,
    to_numpy,
    to_torch,
)

from repro.runtime import train as jtrain
from repro_torch import configs as tconfigs
from repro_torch.models.common import params_from_numpy, tree_map
from repro_torch.runtime import train as ttrain


def _port_value_and_grad(tcfg, tp, batch):
    return ttrain._value_and_grad(lambda p, b: tlm.loss_fn(tcfg, p, b), tp, batch)


# xlstm-125m's gradient leaves: twice the JAX package's own spread.  It
# rounds the mLSTM output (and its cotangent) to bf16 inside the f32 model,
# so one f32 ulp flips roundings; its own leaves move when the mLSTM is
# chunked otherwise or the params move by one ulp, exact in math
# (tests/xlstm_grad_spread.py).  At S = 16 by up to 6.17e-3 of max|ref| per
# leaf (the port sits at 4.31e-3): held at XLSTM_GRAD_TOL.  At S = 2048 by
# up to 0.675 of max|ref|, which no limit below 1 holds and a leaf of zeros
# meets at 1, so there each leaf is held in norm, ||g - ref|| / ||ref||,
# which moves by up to 0.304 (the port 0.149): XLSTM_GRAD_NORM_TOL.  That
# catches gross faults only; tests/test_torch_lm_recurrent.py's
# test_xlstm_grads_match_jax_without_the_bf16_rounding holds the formulas
XLSTM_GRAD_TOL = 1.24e-2
XLSTM_GRAD_NORM_TOL = 0.61

# reduced zamba2's A_log at S = 2048: a = -0.05, so a chunk of 256 decays by
# ~10 (see test_loss_and_grads_match_jax)
SLOW_A_LOG = float(np.log(0.05))


@pytest.mark.parametrize("s", [16, 2048])
@pytest.mark.parametrize("name", sorted(tconfigs.ARCHS))
def test_loss_and_grads_match_jax(name, s):
    """At S = 2048 zamba2's shared block takes the flash op and its Mamba2
    layers four chunks of 256.  There the JAX gradient at init is NaN: its
    scan masks after exp, and exp(cum_t - cum_s) above the diagonal
    overflows once a chunk decays by more than 88 (~180 at A_log = 0), so
    the mask's VJP multiplies 0 by inf.  Both packages then take A_log =
    log(0.05); ``test_zamba2_grads_finite_where_jax_overflows`` holds the
    port at the init params.  Whisper's learned positions cover S.  Every
    leaf is held at 1e-4 of max|ref|, xlstm-125m's at ``XLSTM_GRAD_TOL``
    (S = 16) or in norm at ``XLSTM_GRAD_NORM_TOL`` (S = 2048)."""
    jcfg, tcfg = configs(name)
    jp, tp = both_params(jcfg, f32=True, max_pos=max(s, MAX_POS))
    if name == "zamba2-2.7b" and s == 2048:
        mamba = jp["blocks"]["mamba"]
        jp = {**jp, "blocks": {**jp["blocks"], "mamba": {
            **mamba, "A_log": jnp.full_like(mamba["A_log"], SLOW_A_LOG)}}}
        tp = params_from_numpy(to_numpy(jp), "cpu")
    b = 2 if s == 16 else 1
    batch = batch_np(jcfg, b, s, seed=3, f32=True)
    (jl, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p, bt: jlm.loss_fn(jcfg, p, bt), has_aux=True))(jp, to_jax(batch))
    with one_thread() if name == "xlstm-125m" else contextlib.nullcontext():
        (tl, tparts), tg = _port_value_and_grad(tcfg, tp, to_torch(batch))
    assert tl.dtype == torch.float32 and tl.shape == ()
    assert rel_err(tl, jl) <= TOL_F32 and rel_err(tparts["xent"], jparts["xent"]) <= TOL_F32
    if name == "xlstm-125m" and s == 2048:
        for (path, g), (wpath, w) in zip(leaves(tg), leaves(to_numpy(jg))):
            assert path == wpath
            err = np.linalg.norm(as_f32(g) - w) / np.linalg.norm(w)
            assert err <= XLSTM_GRAD_NORM_TOL, f"{name} S={s} grads {path}: {err:.3g} of ||ref||"
        return
    leaf_tol = XLSTM_GRAD_TOL if name == "xlstm-125m" else TOL_F32
    assert_trees_close(tg, to_numpy(jg), leaf_tol, f"{name} S={s} grads")


def test_zamba2_grads_finite_where_jax_overflows():
    """Reduced zamba2 at its init params and S = 2048, where the JAX
    gradient is NaN: the port's scan masks before exp in its backward too,
    so its loss and every gradient leaf are finite."""
    jcfg, tcfg = configs("zamba2-2.7b")
    _, tp = both_params(jcfg, f32=True)
    batch = batch_np(jcfg, 1, 2048, seed=3, f32=True)
    (tl, _), tg = _port_value_and_grad(tcfg, tp, to_torch(batch))
    assert torch.isfinite(tl)
    bad = [path for path, g in leaves(tg) if not torch.isfinite(g).all()]
    assert not bad, bad


def test_xlstm_grads_finite_where_jax_overflows():
    """Reduced xlstm-125m at S = 256 (one mLSTM chunk) with its forget
    gates' bias at -1 (log f ~ -1.3 a step): above the chunk's diagonal the
    exponent reaches ~300 and overflows.  The JAX package masks after exp,
    so its gradient is NaN; the port masks before exp, so its loss equals
    the JAX package's and every gradient leaf is finite (a full-width
    xlstm-125m reaches 194 there after one AdamW step on the card)."""
    jcfg, tcfg = configs("xlstm-125m")
    jp, _ = both_params(jcfg, f32=True)
    mlstm = jp["blocks"]["mlstm"]
    h = jcfg.n_heads
    jp = {**jp, "blocks": {**jp["blocks"], "mlstm": {
        **mlstm, "b_gates": mlstm["b_gates"].at[..., h:].set(-1.0)}}}
    tp = params_from_numpy(to_numpy(jp), "cpu")
    batch = batch_np(jcfg, 1, 256, seed=3, f32=True)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, bt: jlm.loss_fn(jcfg, p, bt), has_aux=True))(jp, to_jax(batch))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(jg))
    with one_thread():
        (tl, _), tg = _port_value_and_grad(tcfg, tp, to_torch(batch))
    assert rel_err(tl, jl) <= TOL_F32
    bad = [path for path, g in leaves(tg) if not torch.isfinite(g).all()]
    assert not bad, bad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_gradient_matches_jax_where_exp_overflows(dtype):
    """``common.silu`` (x * sigmoid(x), the sigmoid written as XLA expands
    lax.logistic) and its gradient against ``jax.vjp`` of ``jax.nn.silu``,
    bit for bit, across x < -88, where exp(-x) overflows: the port's
    backward is the logistic's own JVP, as the JAX package's is, so it stays
    finite there (autograd through 1 / (1 + exp(-x)) gives 0 * inf = NaN, as
    a full-width MoE step's expert gates met on the card)."""
    from repro_torch.models.common import silu

    x = np.array([-120, -89, -60, -3, -0.5, 0, 0.7, 5, 40, 100], np.float32)
    g = np.linspace(-2, 2, x.size).astype(np.float32)
    jy, vjp = jax.vjp(jax.nn.silu, jnp.asarray(x, dtype))
    (jgx,) = vjp(jnp.asarray(g, dtype))
    tx = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_()
    ty = silu(tx)
    ty.backward(torch.tensor(g).to(tx.dtype))
    assert np.array_equal(ty.detach().float().numpy(), np.asarray(jy, np.float32))
    assert np.array_equal(tx.grad.float().numpy(), np.asarray(jgx, np.float32))


@pytest.mark.parametrize("name", ["llama3.2-1b", "zamba2-2.7b", "whisper-small"])
def test_remat_gives_the_same_gradients(name):
    """Each group (hybrid: with its shared block; audio: the encoder's blocks
    too) recomputed in the backward pass gives what keeping it gives."""
    jcfg, tcfg = configs(name)
    _, tp = both_params(jcfg, f32=True)
    batch = to_torch(batch_np(jcfg, 2, 16, seed=4, f32=True))
    labels = batch["tokens"].roll(-1, dims=1).long()
    mask = torch.ones(labels.shape)

    def loss_of(remat):
        def fn(p, bt):
            h, aux = tlm.forward_hidden(tcfg, p, bt, remat=remat)
            return tlm.chunked_xent(tcfg, p, h, labels, mask, chunk=8) + aux, {}
        return fn

    (l0, _), g0 = ttrain._value_and_grad(loss_of(False), tp, batch)
    (l1, _), g1 = ttrain._value_and_grad(loss_of(True), tp, batch)
    assert torch.equal(l0, l1)
    for (path, a), (_, b) in zip(leaves(g1), leaves(g0)):
        assert rel_err(a, b) <= 1e-6, path


def test_chunked_xent_matches_one_chunk():
    """Chunks of 512 (and the whole sequence when 512 does not divide it)
    give the mean cross entropy of the whole logits."""
    jcfg, tcfg = configs("gemma2-27b")  # final softcap 30
    _, tp = both_params(jcfg, f32=True)
    rng = np.random.default_rng(5)
    for s in (1024, 520):
        h = torch.from_numpy(rng.standard_normal((2, s, tcfg.d_model), dtype=np.float32))
        y = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, s)))
        m = torch.from_numpy((rng.random((2, s)) > 0.2).astype(np.float32))
        logits = tlm.final_logits(tcfg, tp, h)
        nll = torch.logsumexp(logits, -1) - torch.gather(logits, -1, y[..., None])[..., 0]
        want = (nll * m).sum() / m.sum()
        got = tlm.chunked_xent(tcfg, tp, h, y, m)
        assert rel_err(got, want) <= 1e-6


def _bits(x: np.ndarray) -> np.ndarray:
    """bf16 values as ordered integers: neighbouring values differ by 1."""
    bits = np.asarray(x).view(np.uint16).astype(np.int32)
    return np.where(bits >= 0x8000, -(bits & 0x7FFF), bits)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_adamw_matches_jax(f32):
    jcfg, tcfg = configs("llama3.2-1b")
    jp, _ = both_params(jcfg, f32=f32)
    rng = np.random.default_rng(6)
    draw = lambda a, s=1.0: (rng.standard_normal(a.shape) * s).astype(np.float32)  # noqa: E731
    grads = jax.tree.map(lambda a: draw(a, 0.05).astype(a.dtype), jp)
    state = {"params": jp, "m": jax.tree.map(lambda a: draw(a, 0.01), jp),
             "v": jax.tree.map(lambda a: np.abs(draw(a, 1e-3)), jp),
             "step": np.int32(3)}
    opt = dataclasses.replace(jtrain.OptConfig(), lr=1e-2, warmup_steps=10, grad_clip=0.5)
    want = to_numpy(jax.jit(lambda s, g: jtrain.adamw_update(jcfg, opt, s, g))(
        jax.tree.map(jnp.asarray, state), jax.tree.map(jnp.asarray, grads)))
    tstate = params_from_numpy(to_numpy(state), "cpu")
    tstate["step"] = torch.tensor(3, dtype=torch.int32)
    tgrads = params_from_numpy(to_numpy(grads), "cpu")
    got = ttrain.adamw_update(tcfg, ttrain.OptConfig(**dataclasses.asdict(opt)), tstate, tgrads)
    assert got["step"].dtype == torch.int32 and int(got["step"]) == int(want["step"]) == 4
    for part in ("m", "v"):
        for (path, a), (_, b) in zip(leaves(got[part]), leaves(want[part])):
            assert rel_err(a, b) <= 1e-6, (part, path)
    for (path, a), (_, b) in zip(leaves(got["params"]), leaves(want["params"])):
        if f32:
            assert rel_err(a, b) <= 1e-6, path
        else:
            diff = np.abs(_bits(a.view(torch.int16).numpy().view(np.uint16)) - _bits(b))
            assert diff.max() <= 1, (path, int(diff.max()))


def _reduced_state(name="llama3.2-1b", **kw):
    cfg = tconfigs.reduced(tconfigs.ARCHS[name])
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", max_pos=64)
    return cfg, params, ttrain.init_state(cfg, params)


def _tokens(cfg, b=8, s=16):
    return {"tokens": torch.arange(b * s, dtype=torch.int32).reshape(b, s) % cfg.vocab_size}


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_microbatched_grads_match_full(f32):
    cfg, params, _ = _reduced_state()
    if f32:
        params = tree_map(lambda a: a.float(), params)
    batch = _tokens(cfg)

    def loss_of(p, b):
        return tlm.loss_fn(cfg, p, b)

    (loss, _), g_full = ttrain._value_and_grad(loss_of, params, batch)
    g_micro, (loss_micro, _) = ttrain._accumulated_grads(loss_of, params, batch, micro=2)
    tol = 1e-5 if f32 else 3e-2  # bf16: test_train_runtime.py's atol = rtol
    assert abs(float(loss) - float(loss_micro)) <= tol * abs(float(loss))
    for (path, a), (_, b) in zip(leaves(g_full), leaves(g_micro)):
        assert b.dtype == torch.float32
        if f32:
            assert rel_err(b, a) <= tol, path
        else:
            np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=tol, rtol=tol)


def test_microbatches_must_divide_the_batch():
    """A batch that is not a whole number of microbatches raises, as the
    JAX package's reshape does, rather than training on part of it."""
    cfg, params, state = _reduced_state()
    batch = _tokens(cfg, b=9)
    with pytest.raises(ValueError, match="multiple of the microbatch"):
        ttrain._accumulated_grads(lambda p, b: tlm.loss_fn(cfg, p, b), params, batch, micro=4)
    with pytest.raises(ValueError, match="multiple of the microbatch"):
        ttrain.make_train_step(cfg, ttrain.OptConfig(microbatch=4))(state, batch)


def test_grad_clip_bounds_update():
    cfg, params, state = _reduced_state()
    before = [t.clone() for _, t in leaves(params)]
    opt = ttrain.OptConfig(lr=1.0, grad_clip=1e-9, weight_decay=0.0, warmup_steps=1)
    new_state, metrics = ttrain.make_train_step(cfg, opt)(state, _tokens(cfg))
    assert float(metrics["grad_norm"]) > 1e-3  # the clip, not the gradient, is small
    for a, (_, b) in zip(before, leaves(new_state["params"])):
        assert float((a.float() - b.float()).abs().max()) < 1e-2


def test_warmup_schedule():
    opt = ttrain.OptConfig(lr=1e-3, warmup_steps=10)
    at = lambda s: float(ttrain._lr_at(opt, torch.tensor(s, dtype=torch.int32)))  # noqa: E731
    assert at(1) == pytest.approx(1e-4)
    assert at(10) == pytest.approx(1e-3)
    assert at(100) == pytest.approx(1e-3)


def test_opt_state_dtype_honored():
    _, _, state = _reduced_state("kimi-k2-1t-a32b")  # opt_state_dtype = bfloat16
    assert all(x.dtype == torch.bfloat16 for _, x in leaves(state["m"]))
    assert all(x.dtype == torch.bfloat16 for _, x in leaves(state["v"]))
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()


def _arch_batch(cfg, b=2, s=16):
    batch = _tokens(cfg, b, s)
    if cfg.family == "audio":
        batch["frames"] = torch.ones((b, s, cfg.d_model), dtype=torch.bfloat16) * 0.1
    if cfg.family == "vlm":
        batch["patches"] = torch.ones((b, 4, tlm.PATCH_DIM), dtype=torch.bfloat16) * 0.1
    return batch


@pytest.mark.parametrize("name", sorted(tconfigs.ARCHS))
def test_train_step_improves(name):
    cfg, _, state = _reduced_state(name)
    step = ttrain.make_train_step(cfg, ttrain.OptConfig(lr=1e-2, warmup_steps=1))
    batch = _arch_batch(cfg)
    losses = []
    for _ in range(4):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        assert torch.isfinite(metrics["grad_norm"])
    assert losses[-1] < losses[0], f"{name}: loss did not decrease: {losses}"


def test_require_no_grad_raises_only_where_a_gradient_is_wanted():
    """The guard of the CUDA ops without a backward kernel: it raises when
    grad mode is on and a floating input requires grad, and names the
    ROADMAP item; integer inputs and no_grad pass."""
    from repro_torch.core.execution import require_no_grad

    x = torch.ones(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        require_no_grad("op", torch.ones(3, dtype=torch.int8), x)
    with torch.no_grad():
        require_no_grad("op", x)
    require_no_grad("op", x.detach(), torch.ones(3, dtype=torch.int8))
