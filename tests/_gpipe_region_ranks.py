"""``make_gpipe``'s regions on 4 gloo CPU ranks: each rank runs a 4-stage
GPipe of ``N_MICRO`` int8-coded microbatches under a CPU ``torch.profiler``
and writes how many of each ``seifer.gpipe.*`` region it opened, and its
output, to ``DIRECTORY/rank<r>.json``.

    PYTHONPATH=src python tests/_gpipe_region_ranks.py DIRECTORY
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORLD, N_MICRO, MB, D = 4, 16, 2, 8
RANKS_TIMEOUT_S = 180


def rank(p: int, directory: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import start_rank_group
    from repro_torch.runtime.pipeline import make_gpipe

    torch.set_num_threads(1)
    start_rank_group(p, WORLD, f"file://{directory}/rendezvous", device="cpu", timeout_s=60)
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(WORLD, D, D, generator=gen) / D ** 0.5
    x = torch.randn(N_MICRO, MB, D, generator=gen)
    pipe = make_gpipe(lambda wp, xm: torch.tanh(xm @ wp), WORLD, n_micro=N_MICRO,
                      compress=True, quant_block=D, group=dist.group.WORLD)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = pipe(w, x)
    counts = collections.Counter(e.name for e in prof.events()
                                 if e.name.startswith("seifer."))
    Path(directory, f"rank{p}.json").write_text(json.dumps(
        {"regions": counts, "out": out.tolist()}))
    dist.barrier()
    dist.destroy_process_group()


def run_ranks(directory: Path) -> list[dict]:
    """The 4 ranks in a child process, killed after ``RANKS_TIMEOUT_S``;
    each rank's report."""
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, __file__, str(directory)], capture_output=True,
                          text=True, env=env, cwd=str(directory), timeout=RANKS_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads((directory / f"rank{p}.json").read_text()) for p in range(WORLD)]


if __name__ == "__main__":
    import torch.multiprocessing as mp

    mp.spawn(rank, args=(sys.argv[1],), nprocs=WORLD)
