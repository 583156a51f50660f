"""Shared checks of the LM zoo parity tests (``tests/test_torch_lm_*.py``).

Every check makes its inputs from a seed with numpy and carries the JAX
package's parameters across leaf for leaf (``params_from_numpy``), then runs
the same step through the JAX package (jitted: its served form) and the
port, both on the CPU, at ``reduced()`` sizes.

Tolerances, as fractions of max|ref|:

- f32 (every floating param cast to f32 in both packages): ``TOL_F32`` =
  1e-4.  Two families round to bf16 inside the f32 model, because the JAX
  package does so whatever the working dtype: the mLSTM output before its
  projection (``xlstm._mlstm_out``) and the Mamba2 decode's conv window
  (``ssm.mamba_step``), besides the bf16 KV caches of every family.  There a
  difference of one f32 ulp in a sum flips a rounding by 2**-8, and the JAX
  package's own jitted and eager runs differ by 7.7e-4 (xLSTM forward),
  5.5e-4 (xLSTM prefill) and 3.0e-4 in logits, 4.4e-3 in caches (zamba2
  decode); the card and the CPU differ by 1.1e-3 in xLSTM decode logits.
  ``F32_TOL`` holds those steps at 5e-3 (xLSTM) and 1e-2 (zamba2 decode);
  the layers themselves are held at 1e-5 in ``test_torch_lm_recurrent.py``.
- bf16 (params as ``init_params`` makes them): ``TOL_BF16`` = 3e-2, the
  JAX package's own bf16 recurrence tolerance
  (``tests/test_ssm_recurrence.py``).  The port's activations round where
  ``jax.nn``'s do (``repro_torch.models.common``), so a dense model's port
  equals the JAX package's eager run bit for bit; the jitted run skips some
  roundings inside XLA's fusions and differs by about 1e-2.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.core.graph import Layer as JLayer
from repro.models import graph_export as jexport
from repro.models import lm as jlm
from repro.runtime import serve as jserve
from repro_torch import configs as tconfigs
from repro_torch.models import graph_export as texport
from repro_torch.models import lm as tlm
from repro_torch.models.common import params_from_numpy
from repro_torch.runtime import serve as tserve

TOL_F32 = 1e-4
TOL_BF16 = 3e-2
# (family, step) -> f32 tolerance where the JAX package rounds to bf16 inside
# its f32 model (see the module docstring)
F32_TOL = {("ssm", "forward"): 5e-3, ("ssm", "prefill"): 5e-3, ("ssm", "decode"): 5e-3,
           ("hybrid", "decode"): 1e-2}
MAX_POS = 64

DENSE = ["gemma-2b", "gemma2-27b", "llama3.2-1b", "qwen2-7b", "pixtral-12b",
         "whisper-small"]
MOE = ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"]
RECURRENT = ["xlstm-125m", "zamba2-2.7b"]


@contextlib.contextmanager
def one_thread():
    """torch on one thread inside the block.  xLSTM's sLSTM is a loop over
    time: ~1e6 tiny ops a step at S = 2048, which run over 7x slower when
    several test workers each run torch's default thread count (measured:
    six such tests at once took over 5 min each on 8 cores, 50 s on one
    thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def f32_tol(cfg, step: str) -> float:
    return F32_TOL.get((cfg.family, step), TOL_F32)


def configs(name: str, **kw):
    """(JAX config, port config) of ``name`` at ``reduced(**kw)``."""
    return (jconfigs.reduced(jconfigs.ARCHS[name], **kw),
            tconfigs.reduced(tconfigs.ARCHS[name], **kw))


def jax_params(cfg, *, f32: bool, seed: int = 0, max_pos: int = MAX_POS):
    """The JAX package's init params; ``max_pos`` learned positions (whisper)
    must cover the longest sequence a check runs."""
    p = jlm.init_params(cfg, jax.random.PRNGKey(seed), max_pos=max_pos)
    if f32:
        p = jax.tree.map(lambda a: a.astype(jnp.float32)
                         if jnp.issubdtype(a.dtype, jnp.floating) else a, p)
    return p


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def both_params(jcfg, *, f32: bool, max_pos: int = MAX_POS):
    jp = jax_params(jcfg, f32=f32, max_pos=max_pos)
    return jp, params_from_numpy(to_numpy(jp), "cpu")


def batch_np(cfg, b: int, s: int, *, seed: int, f32: bool) -> dict:
    """Seeded tokens (+ frames for audio, patches for vlm) as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32) * 0.5
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((b, 4, jlm.PATCH_DIM), dtype=np.float32) * 0.1
    if not f32:
        for k in ("frames", "patches"):
            if k in batch:
                batch[k] = np.asarray(jnp.asarray(batch[k], jnp.bfloat16))
    return batch


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch: dict) -> dict:
    return params_from_numpy(batch, "cpu")


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def rel_err(got, want) -> float:
    """max|got - want| over max|want|."""
    g, w = as_f32(got), as_f32(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def leaves(tree) -> list:
    """(path, leaf) of every leaf, dict keys in sorted order (jax.tree's)."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out.append((path, t))

    walk(tree, ())
    return out


def structure(tree) -> list:
    """(path, shape, dtype name) of every leaf, in a framework-neutral form."""
    out = []
    for path, t in leaves(tree):
        a = t if isinstance(t, torch.Tensor) else np.asarray(t)
        out.append((path, tuple(a.shape), str(a.dtype).replace("torch.", "")))
    return out


def assert_trees_close(got, want, tol: float, what: str) -> None:
    g, w = leaves(got), leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        err = rel_err(a, b)
        assert err <= tol, f"{what} {path}: {err:.3g} of max|ref| > {tol}"


# ---------------------------------------------------------------------------
# the checks, one per test of every family's file
# ---------------------------------------------------------------------------


def check_config(name: str) -> None:
    jc, tc = jconfigs.ARCHS[name], tconfigs.ARCHS[name]
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tconfigs.reduced(tc)) == dataclasses.asdict(jconfigs.reduced(jc))
    kw = dict(layers=3, d_model=128, vocab=512)
    assert (dataclasses.asdict(tconfigs.reduced(tc, **kw))
            == dataclasses.asdict(jconfigs.reduced(jc, **kw)))
    assert tconfigs.shape_cells(tc) == jconfigs.shape_cells(jc)
    assert (tc.param_count(), tc.active_param_count()) == (jc.param_count(),
                                                           jc.active_param_count())
    for alias, full_name in jconfigs.ALIASES.items():
        assert tconfigs.get_config(alias).name == full_name
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}


def _layer_tuple(layer) -> tuple:
    return (layer.name, layer.param_bytes, layer.out_bytes, layer.flops)


def check_export_graph(name: str) -> None:
    """Equal layer for layer (bytes and FLOPs) in every shape cell, full size."""
    jc, tc = jconfigs.ARCHS[name], tconfigs.ARCHS[name]
    for cell in jconfigs.shape_cells(jc):
        jg = jexport.export_graph(jc, jconfigs.SHAPES[cell])
        tg = texport.export_graph(tc, tconfigs.SHAPES[cell])
        assert isinstance(jg.layers[0], JLayer)
        assert (tg.name, tg.in_bytes) == (jg.name, jg.in_bytes), cell
        assert [_layer_tuple(x) for x in tg.layers] == [_layer_tuple(x) for x in jg.layers], cell
        assert (tg.total_param_bytes, tg.total_flops) == (jg.total_param_bytes, jg.total_flops)


def check_init_params(name: str) -> None:
    """Tree, shapes and dtypes equal to the JAX package's; every leaf the JAX
    package fills with one constant (norms, biases, A_log, D, ...) equal."""
    jcfg, tcfg = configs(name)
    jp = to_numpy(jlm.init_params(jcfg, jax.random.PRNGKey(0), max_pos=MAX_POS))
    tp = tlm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu", max_pos=MAX_POS)
    assert structure(tp) == structure(jp)
    for (path, t), (_, j) in zip(leaves(tp), leaves(jp)):
        jf = np.asarray(j, np.float32)
        tf = as_f32(t)
        if jf.size > 1 and np.all(jf == jf.flat[0]):
            assert np.array_equal(tf, jf), path
        elif jf.size > 1:
            assert not np.all(tf == tf.flat[0]), path  # drawn, not left constant
    # the draws have the JAX package's scale: fan-in truncated normal
    w = as_f32(tp["embed"])
    assert abs(w.std() - 0.02) < 0.002


def check_forward(name: str, *, f32: bool, b: int = 2, s: int = 16) -> None:
    jcfg, tcfg = configs(name)
    jp, tp = both_params(jcfg, f32=f32)
    batch = batch_np(jcfg, b, s, seed=0, f32=f32)
    jh, jaux = jax.jit(lambda p, bt: jlm.forward_hidden(jcfg, p, bt))(jp, to_jax(batch))
    th, taux = tlm.forward_hidden(tcfg, tp, to_torch(batch))
    assert isinstance(th, torch.Tensor) and th.dtype == (torch.float32 if f32 else torch.bfloat16)
    tol = f32_tol(tcfg, "forward") if f32 else TOL_BF16
    err = rel_err(th, jh)
    assert err <= tol, f"{name} forward {'f32' if f32 else 'bf16'}: {err:.3g} > {tol}"
    assert abs(float(taux) - float(jaux)) <= tol * max(abs(float(jaux)), 1.0)


def check_decode_and_prefill(name: str, *, f32: bool) -> None:
    """Three decode steps (logits, then every cache leaf), one greedy serve
    step and the prefill step, against the JAX package."""
    jcfg, tcfg = configs(name)
    jp, tp = both_params(jcfg, f32=f32)
    b, max_len, enc = 2, 32, 16
    jc = jlm.init_caches(jcfg, b, max_len, enc_len=enc)
    tc = tlm.init_caches(tcfg, b, max_len, enc_len=enc, device="cpu")
    assert structure(dict(tc, pos=0)) == structure(to_numpy(dict(jc, pos=0)))
    tol = f32_tol(tcfg, "decode") if f32 else TOL_BF16
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(jcfg, p, c, t, enc_len=enc))
    rng = np.random.default_rng(5)
    for i in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (b, 1), dtype=np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(tok))
        tl, tc = tlm.decode_step(tcfg, tp, tc, torch.from_numpy(tok), enc_len=enc)
        assert tl.dtype == torch.float32 and tl.shape == (b, 1, jcfg.vocab_size)
        err = rel_err(tl, jl)
        assert err <= tol, f"{name} decode step {i}: {err:.3g} > {tol}"
    assert tc["pos"] == int(jc["pos"]) == 3
    assert_trees_close(dict(tc, pos=0), to_numpy(dict(jc, pos=0)), tol, f"{name} caches")

    # the greedy serve step picks the JAX package's token wherever the top
    # two logits are apart by more than the tolerance
    tok = rng.integers(0, jcfg.vocab_size, (b, 1), dtype=np.int32)
    jnext, _ = jax.jit(jserve.make_serve_step(jcfg, enc_len=enc))(jp, jc, jnp.asarray(tok))
    jl, _ = jstep(jp, jc, jnp.asarray(tok))
    tnext, tc = tserve.make_serve_step(tcfg, enc_len=enc)(tp, tc, torch.from_numpy(tok))
    assert tnext.dtype == torch.int32 and tnext.shape == (b, 1) and tc["pos"] == 4
    top2 = np.sort(as_f32(jl)[:, -1], axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > tol * np.abs(as_f32(jl)).max()
    assert np.array_equal(tnext.numpy()[clear], np.asarray(jnext)[clear])

    batch = batch_np(jcfg, 2, 16, seed=1, f32=f32)
    want = jax.jit(jserve.make_prefill_step(jcfg))(jp, to_jax(batch))
    got = tserve.make_prefill_step(tcfg)(tp, to_torch(batch))
    assert got.dtype == torch.float32 and got.shape == (2, jcfg.vocab_size)
    tol = f32_tol(tcfg, "prefill") if f32 else TOL_BF16
    err = rel_err(got, want)
    assert err <= tol, f"{name} prefill: {err:.3g} > {tol}"
