"""How far the JAX package's own xlstm-125m gradients move under changes
that are exact in math, at ``test_torch_train.test_loss_and_grads_match_jax``'s
sizes and seeds (``reduced()``, params cast to f32, S = 16 and 2048).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/xlstm_grad_spread.py [--port]

The JAX package rounds the mLSTM output to bf16 inside its f32 model
(``models/xlstm.py``'s ``_mlstm_out``), and the cotangent through that cast
to bf16 too, so a difference of one f32 ulp in a sum can flip a rounding by
2**-8.  Each variant below changes the reference only in its f32 roundings:

- ``chunk=C``: the mLSTM chunked at C instead of 256 (at S = 16: one chunk
  of 16 against chunks of 8 and 4);
- ``ulp embed`` / ``ulp all``: the embedding table, or every param leaf,
  moved by one f32 ulp up or down at random (seeded).

For each it prints the largest gradient leaf's max|g - g_ref| / max|g_ref|,
the largest leaf's ||g - g_ref|| / ||g_ref|| (the norm over the whole leaf)
and the loss's relative change; the spread is the largest over variants.
``--port`` also prints the port's distance from the same reference (the
gap the parity test holds).  It runs on the CPU only and writes nothing.
"""

from __future__ import annotations

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs
from repro.models import lm, xlstm

ARCH = "xlstm-125m"
CASES = {16: dict(b=2, chunks=(8, 4)), 2048: dict(b=1, chunks=(128, 512))}


def _leaves(tree) -> list:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(x, np.float32)) for p, x in flat]


def _worst(got, want) -> tuple[float, str, float, str]:
    """The worst leaf by max|g - w| / max|w|, and by ||g - w|| / ||w||."""
    worst, where, worst2, where2 = 0.0, "", 0.0, ""
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        err = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
        err2 = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        if err > worst:
            worst, where = err, path
        if err2 > worst2:
            worst2, where2 = err2, path
    return worst, where, worst2, where2


def _ulp(tree, seed: int, only: str | None):
    rng = np.random.default_rng(seed)

    def nudge(path, a):
        if only and jax.tree_util.keystr(path) != only:
            return a
        a = np.asarray(a)
        up = rng.random(a.shape) < 0.5
        return jnp.asarray(np.where(up, np.nextafter(a, np.inf), np.nextafter(a, -np.inf))
                           .astype(a.dtype))

    return jax.tree_util.tree_map_with_path(nudge, tree)


def _exact_out(cfg, p, y, ogate, shape):
    """``xlstm._mlstm_out`` without its bf16 rounding."""
    b, s = shape
    d_in, dh = xlstm.mlstm_dims(cfg)
    hout = y[..., :dh] / jnp.maximum(jnp.abs(y[..., dh]), 1.0)[..., None]
    return jnp.einsum("bse,ed->bsd", hout.reshape(b, s, d_in) * ogate, p["out_proj"])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true", help="also the port's gap")
    ap.add_argument("--seeds", type=int, default=2, help="ulp draws per variant")
    ap.add_argument("--exact-out", action="store_true",
                    help="lift the bf16 rounding of the mLSTM output (both packages)")
    args = ap.parse_args()
    if args.exact_out:
        xlstm._mlstm_out = _exact_out
    cfg = configs.reduced(configs.ARCHS[ARCH])
    orig = xlstm.mlstm_forward
    for s, case in CASES.items():
        params = lm.init_params(cfg, jax.random.PRNGKey(0), max_pos=max(s, 64))
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        rng = np.random.default_rng(3)  # the parity test's batch
        batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (case["b"], s),
                                                    dtype=np.int32))}

        def value_and_grad(p):
            return jax.jit(jax.value_and_grad(lambda p, b: lm.loss_fn(cfg, p, b),
                                              has_aux=True))(p, batch)

        (loss, _), ref = value_and_grad(params)
        rows = []
        for c in case["chunks"]:
            xlstm.mlstm_forward = functools.partial(orig, chunk=c)
            try:
                (l2, _), g = value_and_grad(params)
            finally:
                xlstm.mlstm_forward = orig
            rows.append((f"chunk={c}", *_worst(g, ref), float(abs(l2 - loss) / abs(loss))))
        for what, only in (("ulp embed", "['embed']"), ("ulp all", None)):
            for seed in range(args.seeds):
                (l2, _), g = value_and_grad(_ulp(params, 100 + seed, only))
                rows.append((f"{what} seed {seed}", *_worst(g, ref),
                             float(abs(l2 - loss) / abs(loss))))
        for name, err, where, err2, where2, dl in rows:
            print(f"S={s} {name}: grads {err:.3g} of max|ref| (leaf {where}), {err2:.3g} of "
                  f"||ref|| (leaf {where2}), loss {dl:.3g}")
        print(f"S={s} spread: {max(r[1] for r in rows):.3g} of max|ref|, "
              f"{max(r[3] for r in rows):.3g} of ||ref||")
        if args.port:
            import torch

            from repro_torch import configs as tconfigs
            from repro_torch.models import lm as tlm
            from repro_torch.models.common import params_from_numpy
            from repro_torch.models import xlstm as txlstm
            from repro_torch.runtime import train as ttrain

            if args.exact_out:
                def exact(cfg, p, y, ogate, shape):
                    b, s = shape
                    d_in, dh = txlstm.mlstm_dims(cfg)
                    hout = y[..., :dh] / torch.clamp(y[..., dh].abs(), min=1.0)[..., None]
                    return (hout.reshape(b, s, d_in) * ogate) @ p["out_proj"]

                txlstm._mlstm_out = exact

            tcfg = tconfigs.reduced(tconfigs.ARCHS[ARCH])
            tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
            tb = {"tokens": torch.from_numpy(np.asarray(batch["tokens"]))}
            (tl, _), tg = ttrain._value_and_grad(lambda p, b: tlm.loss_fn(tcfg, p, b), tp, tb)
            tg = jax.tree.map(lambda t: t.numpy(), tg)
            err, where, err2, where2 = _worst(tg, ref)
            print(f"S={s} the port: grads {err:.3g} of max|ref| (leaf {where}), {err2:.3g} of "
                  f"||ref|| (leaf {where2}), loss "
                  f"{abs(float(tl) - float(loss)) / abs(float(loss)):.3g}")


if __name__ == "__main__":
    main()
