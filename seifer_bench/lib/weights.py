"""The weights and the inputs of a run, made on the device from the seed.

Each layer's weights come from one ``torch.Generator`` on the run's device,
seeded from ``(seed, layer)``, in one ``randn`` call, in f32 (the type they
are served in), scaled by 1/sqrt(fan-in) (the usual initialisation, which
keeps every layer's activations of order one) and by the configuration's
gain for that weight, where it sets one.  A stage that holds only
some layers draws only those, and gets the same numbers as a run that
draws them all.  Inputs are N(0, 1) activations (S, d), one generator for
the whole pool.  The program and the reference get the same tensors.
"""

from __future__ import annotations

import math

import torch

from seifer_bench.lib.bench import sub_seed


def shapes(model: dict) -> dict[str, tuple[tuple[int, ...], int]]:
    """name -> (one layer's shape, fan-in) of ``model``'s weights."""
    d = model["d"]
    if model["kind"] == "demo_ssm":
        return {"wb": ((d, model["state"]), d), "wc": ((d, model["state"]), d),
                "wd": ((d, model["heads"]), d)}
    if model["kind"] == "demo_transformer":
        hd = d // model["heads"]
        proj = (model["heads"] + 2 * model["kv_heads"]) * hd
        f = model["mlp_mult"] * d
        return {"wqkv": ((d, proj), d), "wo": ((d, d), d), "w1": ((d, f), d),
                "w2": ((f, d), f)}
    raise ValueError(f"no weights for model kind {model['kind']!r}")


def draw(model: dict, seed: int, device, layers=None, gain=None) -> dict[str, torch.Tensor]:
    """Weights of ``layers`` (default: every layer), stacked on a leading
    axis in that order; ``gain`` scales named weights further (a
    configuration's ``weights.gain``)."""
    gain = gain or {}
    layers = list(range(model["n_layers"])) if layers is None else list(layers)
    spec = shapes(model)
    out = {name: torch.empty((len(layers), *shape), dtype=torch.float32, device=device)
           for name, (shape, _) in spec.items()}
    total = sum(math.prod(shape) for shape, _ in spec.values())
    for j, i in enumerate(layers):
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights", i))
        flat = torch.randn(total, generator=gen, device=device)
        at = 0
        for name, (shape, fan_in) in spec.items():
            size = math.prod(shape)
            scale = gain.get(name, 1.0) * fan_in ** -0.5
            torch.mul(flat[at:at + size].view(shape), scale, out=out[name][j])
            at += size
        del flat
    return out


def inputs(model: dict, seed: int, count: int, device) -> torch.Tensor:
    """``count`` request activations (count, S, d), N(0, 1)."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "inputs"))
    return torch.randn((count, model["seq"], model["d"]), generator=gen, device=device)
