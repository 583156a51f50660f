"""The plain reference against the port's plain path (CPU), at tiny widths,
for both demo models with int8 hops between stages."""

from __future__ import annotations

import pytest
import torch

from seifer_bench.lib import weights
from seifer_bench.reference import models as reference

MODELS = {
    "demo_ssm": dict(kind="demo_ssm", d=64, n_layers=4, seq=128, heads=2, state=16, a=-0.5),
    "demo_transformer": dict(kind="demo_transformer", d=32, n_layers=4, seq=64, heads=4,
                             kv_heads=2, mlp_mult=2, window=16, softcap=20.0),
}
STAGES = [[0, 1], [1, 3], [3, 4]]


def _port(model: dict, w: dict, x: torch.Tensor) -> torch.Tensor:
    """x through the port's executor stage by stage, each hop through the
    port's int8 codec (its plain versions on the CPU)."""
    from repro_torch.core import model_zoo
    from repro_torch.kernels.quantize.ops import dequantize_int8, quantize_int8

    widths = {k: v for k, v in model.items() if k not in ("kind", "a")}
    _, ex_for = getattr(model_zoo, model["kind"])(**widths, device="cpu",
                                                  params_for_version=lambda v: w)
    ex = ex_for(0)
    with torch.no_grad():
        for j, (first, stop) in enumerate(STAGES):
            if j:
                q, s = quantize_int8(x, 256)
                x = dequantize_int8(q, s, torch.float32, block=256)
            x = ex(first, stop, x)
    return x


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_the_reference_follows_the_port(kind):
    model = MODELS[kind]
    gain = {"wb": 0.25, "wc": 0.25} if kind == "demo_ssm" else {}
    w = weights.draw(model, 2**31 + 5, "cpu", gain=gain)
    x = weights.inputs(model, 2**31 + 5, 2, "cpu")
    got = _port(model, w, x)
    ref = reference.forward(model, w, x, STAGES, 256)
    for g in range(len(x)):
        errs = reference.relative_errors(got[g], ref[g])
        assert errs["row_max"] < 1e-5, errs
    # the TF32 control moves the same answers by far more than the port does
    ctl = reference.forward(model, w, x, STAGES, 256, "tf32")
    assert reference.relative_errors(ctl[0], ref[0])["row_med"] > 1e-4


def test_one_layer_drawn_alone_equals_its_slice_of_the_stack():
    model = MODELS["demo_transformer"]
    whole = weights.draw(model, 7, "cpu")
    one = weights.draw(model, 7, "cpu", layers=[2])
    assert all(torch.equal(one[k][0], whole[k][2]) for k in whole)
