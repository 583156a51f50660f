"""SEIFER pipeline over pods (PyTorch port): GPipe + placement + int8 boundaries.

``examples/pipeline_pods.py`` over ``repro_torch``.  One process runs the
four pods' stages in turn on ``--device`` (default cuda; raises without a
card); under ``torch.distributed`` each pod would be a rank
(``make_gpipe(..., group=...)``).  Weights and inputs come from generators
seeded 0 and 1 on the device.

    PYTHONPATH=src python examples/torch_pipeline_pods.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core.execution import resolve_device
from repro_torch.core.graph import chain
from repro_torch.runtime.pipeline import (
    make_gpipe,
    plan_pipeline,
    reorder_stage_params,
)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
device = resolve_device(ap.parse_args().device)

D, LAYERS, N_MICRO = 64, 8, 8

ws = torch.randn((LAYERS, D, D), generator=torch.Generator(device).manual_seed(0),
                 device=device) * 0.1
stage_ws = ws.reshape(4, 2, D, D)


def stage_fn(local_w, x):
    for i in range(2):
        x = torch.tanh(x @ local_w[i])
    return x


# pods with heterogeneous links: SEIFER places the chain on the fastest
graph = chain("mlp8", [(D * D * 4, 32 * D * 4)] * LAYERS)
pod_bw = np.array(
    [[0, 12e9, 2e9, 2e9], [12e9, 0, 6e9, 2e9],
     [2e9, 6e9, 0, 3e9], [2e9, 2e9, 3e9, 0]], float)
plan = plan_pipeline(graph, 4, stage_capacity=2 * D * D * 4, pod_bw=pod_bw)
print(f"SEIFER cuts: {plan.cuts}; stage->pod order: {plan.stage_order}; "
      f"est bottleneck {plan.est_bottleneck_s*1e6:.2f} us")

x = torch.randn((N_MICRO, 32, D), generator=torch.Generator(device).manual_seed(1),
                device=device)
ref = x
for i in range(LAYERS):
    ref = torch.tanh(ref @ ws[i])

for compress in (False, True):
    pipe = make_gpipe(stage_fn, 4, n_micro=N_MICRO, compress=compress, quant_block=64,
                      stage_order=plan.stage_order)
    y = pipe(reorder_stage_params(stage_ws, plan), x)
    err = float((y - ref).abs().max())
    label = "int8-compressed boundaries" if compress else "f32 boundaries"
    print(f"{label}: max |err| vs sequential = {err:.5f}")
print("pipeline example complete.")
