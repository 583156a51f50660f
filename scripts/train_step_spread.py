"""How far a small train step's loss, gradient norm and gradient leaves move
on the CPU alone under a change that is exact in math.

    PYTHONPATH=src python scripts/train_step_spread.py --arch phi3.5-moe-42b-a6.6b [--seeds 1]

The model, weights, inputs and step are those of
``tests/test_torch_gpu.py::test_small_train_step_card_matches_cpu`` for
``--arch`` (its ``TRAIN_CASES`` width, S = 2048, 2 microbatches of 1;
weights from seed 0, inputs from seed 3), in the dtype that test holds the
arch to with a measured constant:

- MoE archs in bf16: (a) attention's f32 softmax taken over the keys in
  two halves and combined by their logsumexps (flash-style, as the card's
  kernel takes it) instead of at once; (b) the residual stream's width
  permuted in every param (the embedding's columns too), so every product
  over it sums in another order, as the card's GEMMs do.  Either flips bf16
  roundings of the hidden states, and a near-tie between two experts in
  the router can then resolve the other way;
- xlstm-125m in f32: (a) the mLSTM chunked at 128 instead of 256; (b) the
  width permuted as above (the JAX package's bf16 rounding of the mLSTM
  output, which the port keeps, flips with the f32 sums); (c) every param
  moved by one f32 ulp up or down at random, as the card's own
  transcendentals (exp, log-sigmoid, tanh) round otherwise than the CPU's:
  the stabilizers' maxima and the normalizers' clamps then break near-ties
  the other way, as a router does.  ``--exact-out`` lifts the bf16 rounding
  (as the card test does for xlstm) before it reads;
- zamba2-2.7b in bf16: the SSD scan chunked at 64 instead of 256 (its f32
  roundings flip bf16 roundings downstream).

It prints each variant's spread of each quantity (loss and gradient norm
relative, each leaf max|g' - g| / max|g|), and for MoE archs how many
tokens' top-k experts differ from the unchanged run's in any router call;
the card test's constants are twice the largest.  ``--seeds N`` repeats it for weight seeds 0..N-1
(inputs from seed 3 + the weight seed).  Runs on the CPU; the last line
is a JSON object of every seed's spreads.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.runtime import train

WIDTH = {"phi3.5-moe-42b-a6.6b": 512, "kimi-k2-1t-a32b": 448, "xlstm-125m": 256,
         "zamba2-2.7b": 320}
VARIANTS = {"moe": ["attention in halves", "width permuted"],
            "ssm": ["mLSTM chunk 128", "width permuted", "params one ulp"],
            "hybrid": ["SSD chunk 64"]}


def _attention_in_halves(q, k, v, *, causal=True, window=0, softcap=0.0):
    """``attention_ref_lse`` with the softmax over the keys taken in two
    halves and combined by their logsumexps: equal in exact arithmetic."""
    b, sq, h, _ = q.shape
    logits = flash_ref._logits(q, k, causal, window, softcap)  # (B, KH, G, Sq, Skv)
    half = logits.shape[-1] // 2
    parts = [(logits[..., :half], v[:, :half]), (logits[..., half:], v[:, half:])]
    lses = [torch.logsumexp(lg, dim=-1) for lg, _ in parts]
    lse = torch.logaddexp(*lses)
    o = 0.0
    for (lg, vs), part_lse in zip(parts, lses):
        live = torch.isfinite(part_lse)  # rows the causal mask hides from this half
        w = torch.exp(lg - torch.where(live, lse, 0.0)[..., None]).masked_fill(~live[..., None], 0)
        o = o + flash_ref._weighted(w, vs, torch.float32)
    return o.to(q.dtype), lse.reshape(b, h, sq)


def _width_axes(path: tuple, shape: tuple, d: int) -> list[int]:
    """The axes of a leaf that run over the residual stream's width d: its
    every axis of size d, but the embedding's last only, and of the sLSTM
    only the input of ``w_in`` and the output of ``w_down`` (its cell state
    and MLP run over heads, whatever their size)."""
    if path == ("embed",):
        return [len(shape) - 1]
    if "slstm" in path:
        return {"w_in": [len(shape) - 2], "w_down": [len(shape) - 1]}.get(path[-1], [])
    return [i for i, n in enumerate(shape) if n == d]


def _permute_width(tree, perm: torch.Tensor):
    """Every axis of the residual stream's width permuted by ``perm``."""

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        for i in _width_axes(path, tuple(t.shape), perm.numel()):
            t = t.index_select(i, perm)
        return t

    return walk(tree, ())


def _exact_out(cfg, p: dict, y: torch.Tensor, ogate: torch.Tensor, shape) -> torch.Tensor:
    """``xlstm._mlstm_out`` without its bf16 rounding."""
    b, s = shape
    d_in, dh = xlstm_lib.mlstm_dims(cfg)
    hout = y[..., :dh] / torch.clamp(y[..., dh].abs(), min=1.0)[..., None]
    return (hout.reshape(b, s, d_in) * ogate) @ p["out_proj"]


def route_flips(got: list, want: list) -> int:
    """Tokens whose set of top-k experts differs, summed over router calls."""
    return sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
               for a, b in zip(got, want))


def step_at(cfg, base, inputs, dtype, variant: str | None):
    """(loss, grad norm, gradient leaves, each router call's top-k experts)
    of one step's accumulated gradients, with the exact-in-math change
    ``variant`` applied (the leaves then put back in the model's own
    order)."""
    attention, route, routes = flash_ops.attention_ref_lse, moe_lib.route, []

    def recorded_route(*args):
        out = route(*args)
        routes.append(out[2])
        return out

    defaults, ssd_defaults = (xlstm_lib.mlstm_forward.__kwdefaults__,
                              ssm_lib.mamba_forward.__kwdefaults__)
    chunk, ssd_chunk = defaults["chunk"], ssd_defaults["chunk"]
    params = tree_map(lambda t: t.clone(), base)
    perm = torch.randperm(cfg.d_model, generator=torch.Generator().manual_seed(11))
    if variant == "attention in halves":
        flash_ops.attention_ref_lse = _attention_in_halves
    elif variant == "width permuted":
        params = _permute_width(params, perm)
    elif variant == "params one ulp":
        up = torch.Generator().manual_seed(12)
        params = tree_map(lambda t: torch.nextafter(
            t, torch.where(torch.rand(t.shape, generator=up) < 0.5, torch.inf, -torch.inf)
            .to(t.dtype)), params)
    elif variant == "mLSTM chunk 128":
        defaults["chunk"] = 128
    elif variant == "SSD chunk 64":
        ssd_defaults["chunk"] = 64
    moe_lib.route = recorded_route
    try:
        batch = {k: torch.as_tensor(v) for k, v in inputs.items()}
        batch = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in batch.items()}
        grads, (loss, _) = train._accumulated_grads(lambda p, b: lm.loss_fn(cfg, p, b), params,
                                                    batch, 1)
    finally:
        flash_ops.attention_ref_lse, moe_lib.route = attention, route
        defaults["chunk"], ssd_defaults["chunk"] = chunk, ssd_chunk
    if variant == "width permuted":
        grads = _permute_width(grads, torch.argsort(perm))
    return float(loss), float(train._global_norm(grads)), tree_leaves(grads), routes


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=sorted(WIDTH))
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--exact-out", action="store_true",
                    help="xlstm: lift the bf16 rounding of the mLSTM output")
    args = ap.parse_args()
    if args.exact_out:
        xlstm_lib._mlstm_out = _exact_out
    cfg = reduced(ARCHS[args.arch], d_model=WIDTH[args.arch], vocab=512)
    if cfg.family == "ssm":
        # xlstm's sLSTM loop launches ~1e6 tiny ops a step, which crawl when
        # torch's threads contend with other work for the cores
        torch.set_num_threads(1)
    dtype = torch.float32 if cfg.family == "ssm" else torch.bfloat16
    out = {}
    for seed in range(args.seeds):
        base = lm.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu",
                              max_pos=2048)
        base = tree_map(lambda t: t.to(dtype), base)
        rng = np.random.default_rng(3 + seed)
        inputs = {"tokens": rng.integers(0, cfg.vocab_size, (2, 2048), dtype=np.int32)}
        l0, n0, g0, r0 = step_at(cfg, base, inputs, dtype, None)
        for variant in VARIANTS[cfg.family]:
            l1, n1, g1, r1 = step_at(cfg, base, inputs, dtype, variant)
            leaves = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                      for a, b in zip(g1, g0)]
            out[f"{seed} {variant}"] = {"loss": abs(l1 - l0) / abs(l0),
                                        "grad_norm": abs(n1 - n0) / abs(n0), "leaf": max(leaves),
                                        "route_flips": route_flips(r1, r0)}
            r = out[f"{seed} {variant}"]
            flips = (f", top-k differing for {r['route_flips']} tokens over {len(r0)} router calls"
                     if r0 else "")
            print(f"{args.arch} {str(dtype)[6:]} seed {seed}, {variant}: loss {r['loss']:.4e}, "
                  f"grad norm {r['grad_norm']:.4e}, worst of {len(leaves)} leaves {r['leaf']:.4e} "
                  f"(median {sorted(leaves)[len(leaves) // 2]:.4e}){flips}", flush=True)
    print(json.dumps({args.arch: out}))


if __name__ == "__main__":
    main()
