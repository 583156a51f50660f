"""The GPipe cases that the group-mode tests run, in turn and on 4 ranks.

``gpipe(case)`` runs one case of the port's ``make_gpipe`` in one process;
``run_ranks(directory)`` runs every case on 4 gloo ranks of a
``torch.distributed`` group in a child process and returns each rank's
outputs.  In the "identity" case every rank passes the whole stack of stage
params; in "seifer" and "compressed" each passes only its own stage's.

    PYTHONPATH=src python tests/_gpipe_ranks.py DIRECTORY
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.graph import chain
from repro_torch.runtime.pipeline import make_gpipe, plan_pipeline, reorder_stage_params

ROOT = Path(__file__).resolve().parent.parent
D, N_MICRO, MB, LAYERS = 32, 8, 16, 8
# tests/test_pipeline_multidev.py's pods (bytes/s)
MULTIDEV_BW = np.array([[0, 10e9, 1e9, 1e9], [10e9, 0, 5e9, 1e9],
                        [1e9, 5e9, 0, 2e9], [1e9, 1e9, 2e9, 0]], float)
CASES = ("identity", "seifer", "compressed")
RANKS_TIMEOUT_S = 180


def inputs() -> tuple[np.ndarray, np.ndarray]:
    """The chain's weights (LAYERS, D, D) and x (N_MICRO, MB, D), f32."""
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((LAYERS, D, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    return ws, x


def stage_fn(local_w, x):
    for i in range(2):
        x = torch.tanh(x @ local_w[i])
    return x


def plan():
    sizes = [(D * D * 4, 16 * D * 4)] * LAYERS
    return plan_pipeline(chain("mlp", sizes), 4, stage_capacity=2 * D * D * 4,
                         pod_bw=MULTIDEV_BW)


def gpipe(case: str, group=None, rank: int | None = None):
    """``case`` through ``make_gpipe`` on the CPU: in turn without a
    ``group``, else as ``rank`` of it."""
    ws, x = inputs()
    stage_ws = torch.from_numpy(ws).reshape(4, 2, D, D)
    x = torch.from_numpy(x)
    kw = dict(n_micro=N_MICRO, group=group)
    if case == "identity":
        return make_gpipe(stage_fn, 4, **kw)(stage_ws, x)
    p = plan()
    params = reorder_stage_params(stage_ws, p)
    if rank is not None:
        params = params[rank:rank + 1]  # this rank's own stage only
    pipe = make_gpipe(stage_fn, 4, stage_order=p.stage_order,
                      compress=case == "compressed", quant_block=32, **kw)
    return pipe(params, x)


def _rank(p: int, directory: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{directory}/rendezvous", rank=p,
                            world_size=4, timeout=datetime.timedelta(seconds=60))
    try:
        outs = {case: gpipe(case, group=dist.group.WORLD, rank=p) for case in CASES}
        torch.save(outs, f"{directory}/rank{p}.pt")  # every rank returns the output
    finally:
        dist.destroy_process_group()


def run_ranks(directory: Path) -> list[dict]:
    """Every case on 4 gloo ranks in a child process, killed after
    ``RANKS_TIMEOUT_S``; each rank's outputs."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, __file__, str(directory)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            cwd=str(directory))
    try:
        out, err = proc.communicate(timeout=RANKS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"the 4 gloo ranks hung past {RANKS_TIMEOUT_S} s: "
                             f"{err[-2000:]}") from None
    assert proc.returncode == 0 and "RANKS_OK" in out, err[-3000:]
    return [torch.load(directory / f"rank{p}.pt") for p in range(4)]


if __name__ == "__main__":
    mp.spawn(_rank, args=(sys.argv[1],), nprocs=4)
    print("RANKS_OK")
