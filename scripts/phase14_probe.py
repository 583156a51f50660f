"""One-card probes behind two settings of ``chip_smoke.py``'s phase 14.

    python3 scripts/phase14_probe.py batch 24 28
    python3 scripts/phase14_probe.py spread [SEEDS]

``batch``: llama3.2-1b's plain f32 train step (``MULTI_LLAMA``, rank 0's
reference of phase 14 (b)) at each batch, each in a fresh process: its
seconds and peak device memory, or that it ran out of memory.

``spread``: zamba2-2.7b's plain f32 serving run (``MULTI_ZAMBA``, phase 14
(c)'s reference), then the same run with the residual stream's width
permuted in every param (``scripts/train_step_spread.py``'s
``_permute_width``, exact in math; seeds 0..SEEDS-1, default 3): how far
each output's logits move, max|l' - l| / max|l| at worst.  A placement
over the "model" axis sums the same products in another order;
``MULTI_LEAF_TOL`` holds an output that misses TOL_SHARD at twice this.

Both need a CUDA card; the last line of each run is a JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def batch(b: int) -> None:
    import torch

    from repro_torch.core.execution import resolve_device
    from repro_torch.launch.mesh import make_test_mesh

    resolve_device("cuda")
    make_test_mesh()  # multi_llama's barriers need a group: one rank
    try:
        r = cs.multi_llama(0, cs.MultiCard(llama=dict(cs.MULTI_LLAMA, batch=b)), {})
        print(json.dumps({"batch": b, "plain_s": r["plain_s"],
                          "peak_gib": r["plain_peak"] / 2**30}))
    except torch.OutOfMemoryError as e:
        print(json.dumps({"batch": b, "out_of_memory": str(e).splitlines()[0]}))


def spread(seeds: int) -> None:
    import torch
    from train_step_spread import _permute_width

    from repro_torch.core.execution import resolve_device

    resolve_device("cuda")
    mc = cs.MultiCard()
    kw = mc.zamba
    cfg = cs.multi_config(mc, kw["arch"])
    ref, secs, peak = cs.zamba_run(mc)
    worst: dict[str, float] = {}
    for seed in range(seeds):
        perm = torch.randperm(cfg.d_model, generator=torch.Generator().manual_seed(seed))
        params = _permute_width(cs.multi_params_f32(mc, cfg, kw["seed"], kw["seq"]),
                                perm.to(mc.device))
        got, _, _ = cs.zamba_run(mc, params=params)
        del params
        for k, want in ref.items():
            d = ((got[k].double() - want.double()).abs().max()
                 / want.double().abs().max()).item()
            worst[k] = max(worst.get(k, 0.0), d)
        del got
        cs.release()
        print(f"seed {seed}: " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()), flush=True)
    print(json.dumps({"arch": kw["arch"], "batch": kw["batch"], "seq": kw["seq"],
                      "seeds": seeds, "plain_s": secs, "peak_gib": peak / 2**30,
                      "spread": worst}))


if __name__ == "__main__":
    card = cs.phase_device()
    if sys.argv[1] == "batch":
        cs.phase_build()
        for b in sys.argv[2:]:  # a fresh process each: the allocator starts empty
            subprocess.run([sys.executable, __file__, "batch-one", b], check=True)
    elif sys.argv[1] == "batch-one":
        batch(int(sys.argv[2]))
    else:
        spread(int(sys.argv[2]) if len(sys.argv) > 2 else 3)
    print(card)
