"""The sharded LM steps that ``tests/test_torch_sharding_ranks.py`` holds to the
unsharded ones, on 4 gloo ranks of a (2, 2) ("data", "model") CPU mesh.

Each case is an arch at ``reduced()`` size, params in f32, placed by the
port's ``ShardingPolicy``: llama3.2-1b (tp; 1 kv head, so q's heads shard
and k/v replicate, and flash-free attention), gemma2-27b (fsdp; 2 kv heads,
both shard), phi3.5-moe (ep_fsdp: the experts over "model"), zamba2-2.7b
(tp; the SSD scan's heads over "model").  Every rank runs the unsharded
step on plain tensors and the sharded one on DTensors, and rank 0 writes
both results: the loss and every gradient leaf of one batch (and the
train step's loss and gradient norm), the prefill's logits, and three
decode steps' logits from zeroed caches (llama's KV caches take the
split-KV spec: the sequence over "model").

    PYTHONPATH=src python tests/_sharding_ranks.py DIRECTORY [ARCH ...]
    PYTHONPATH=src python tests/_sharding_ranks.py --spread ARCH

``--spread`` prints how far the unsharded gradient leaves move under the
residual width permuted (``width_spread``): zamba2-2.7b's Mamba2 leaves
move by up to 1.7e-5 of max|g| there, so the sharded step's are held at
twice that, ``ZAMBA2_LEAF_TOL``.
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

ROOT = Path(__file__).resolve().parent.parent
CASES = ("llama3.2-1b", "gemma2-27b", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b")
B, S, DECODE_STEPS = 4, 16, 3
RANKS_TIMEOUT_S = 240


def case_config(arch: str):
    from repro_torch.configs import get_config, reduced

    return reduced(get_config(arch))


def batch(cfg) -> dict:
    rng = np.random.default_rng(1)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32))}


def params_f32(cfg):
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map

    params = lm.init_params(cfg, torch.Generator("cpu").manual_seed(0), device="cpu")
    return tree_map(lambda t: t.float(), params)


def run_case(arch: str, mesh=None) -> dict:
    """The case's results, unsharded without ``mesh``, else on it (whole
    tensors, gathered)."""
    from repro_torch.models import lm
    from repro_torch.models.common import NO_SHARDING, tree_leaves, tree_map
    from repro_torch.runtime import serve as serve_lib
    from repro_torch.runtime import train as train_lib
    from repro_torch.sharding import policy as pol

    cfg = case_config(arch)
    params, b = params_f32(cfg), batch(cfg)
    # f32 caches, as the params: bf16 would round the sharded and unsharded
    # k, v (equal to f32 precision) apart wherever they straddle a bf16 tie
    caches = tree_map(lambda t: t.float() if isinstance(t, torch.Tensor) else t,
                      lm.init_caches(cfg, B, S, device="cpu"))
    policy = NO_SHARDING
    if mesh is not None:
        policy = pol.ShardingPolicy(cfg, mesh)
        params = pol.place(params, pol.param_shardings(cfg, mesh, params), mesh)
        b = pol.place(b, pol.batch_shardings(mesh, b), mesh)
        caches = pol.place(caches, pol.cache_shardings(cfg, mesh, caches, B), mesh)
    out: dict = {}
    # one train step (on copies: it updates its state in place), its
    # gradients as the update receives them
    update = train_lib.adamw_update

    def keep_grads(cfg_, opt_, state_, grads):
        out["grads"] = grads
        return update(cfg_, opt_, state_, grads)

    train_lib.adamw_update = keep_grads
    try:
        state = train_lib.init_state(cfg, tree_map(torch.clone, params))
        opt = train_lib.OptConfig(lr=1e-3, warmup_steps=1)
        _, metrics = train_lib.make_train_step(cfg, opt, policy)(state, b)
    finally:
        train_lib.adamw_update = update
    out["loss"], out["grad_norm"] = metrics["loss"], metrics["grad_norm"]
    out["prefill"] = serve_lib.make_prefill_step(cfg, policy)(params, b)
    tokens = b["tokens"][:, :1]
    out["decode"] = []
    with torch.no_grad(), policy.scope():
        for _ in range(DECODE_STEPS):
            logits, caches = lm.decode_step(cfg, params, caches, tokens)
            out["decode"].append(logits)
            tokens = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    if mesh is None:
        return out
    # how many param leaves are sharded over some mesh dim
    out["sharded_leaves"] = sum(any(p.is_shard() for p in t.placements)
                                for t in tree_leaves(params))
    return pol.to_local(out)


def rel_errors(ref, got) -> dict[str, float]:
    """max|got - ref| / max|ref| of every tensor leaf, by path."""
    from repro_torch.sharding.policy import _at, _map_with_path

    errs: dict[str, float] = {}

    def leaf(path, want):
        if isinstance(want, torch.Tensor):
            have = _at(got, path)
            errs[path] = ((have.double() - want.double()).abs().max()
                          / want.double().abs().max().clamp(min=1e-30)).item()

    _map_with_path(leaf, ref)
    return errs


def width_spread(arch: str, seeds: int = 3) -> dict[str, float]:
    """How far the unsharded step's gradient leaves move under a change
    exact in math, the residual width permuted in every param
    (``scripts/train_step_spread.py``'s): the largest max|g' - g| / max|g|
    of each leaf over ``seeds`` permutations.  Sharding over "model" sums
    the same products in another order."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from train_step_spread import _permute_width

    from repro_torch.models import lm
    from repro_torch.runtime import train as train_lib
    from repro_torch.sharding.policy import _map_with_path

    cfg = case_config(arch)
    params, b = params_f32(cfg), batch(cfg)
    loss_of = lambda p, bb: lm.loss_fn(cfg, p, bb)  # noqa: E731
    _, ref = train_lib._value_and_grad(loss_of, params, b)
    spread: dict[str, float] = {}
    for seed in range(seeds):
        perm = torch.randperm(cfg.d_model, generator=torch.Generator().manual_seed(seed))
        _, g = train_lib._value_and_grad(loss_of, _permute_width(params, perm), b)
        g = _permute_width(g, torch.argsort(perm))

        def leaf(path, want, got=g):
            from repro_torch.sharding.policy import _at

            d = ((_at(got, path) - want).abs().max() / want.abs().max()).item()
            spread[path] = max(spread.get(path, 0.0), d)

        _map_with_path(leaf, ref)
    return spread


def place_takes_rank_0s(mesh, p: int) -> bool:
    """Whether ``place``, given a different tree on each rank, leaves every
    rank with rank 0's values: a sharded leaf and a replicated one alike."""
    from repro_torch.sharding import policy as pol

    want = {"w": torch.arange(24.0).reshape(4, 6), "norm": torch.arange(6.0)}
    placed = pol.place({k: t + 100 * p for k, t in want.items()},
                       {"w": ("data", "model"), "norm": (None,)}, mesh)
    return all(torch.equal(placed[k].full_tensor(), want[k]) for k in want)


def _rank(p: int, directory: str, cases: list[str]) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{directory}/rendezvous", rank=p,
                            world_size=4, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        placed = [None] * 4
        dist.all_gather_object(placed, place_takes_rank_0s(mesh, p))
        sharded = {arch: run_case(arch, mesh) for arch in cases}
        if p == 0:  # the unsharded steps once, on rank 0
            torch.save({"place_takes_rank_0s": placed,
                        **{arch: (run_case(arch), sharded[arch]) for arch in cases}},
                       f"{directory}/results.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(directory: Path, cases: tuple[str, ...] = CASES) -> dict:
    """``cases`` on 4 gloo ranks in a child process, killed after
    ``RANKS_TIMEOUT_S``; {arch: (unsharded, sharded)} of rank 0, and under
    "place_takes_rank_0s" ``place_takes_rank_0s`` of each rank."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, __file__, str(directory), *cases],
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
    return torch.load(directory / "results.pt")


if __name__ == "__main__":
    if sys.argv[1] == "--spread":  # python tests/_sharding_ranks.py --spread ARCH
        top = sorted(width_spread(sys.argv[2]).items(), key=lambda kv: -kv[1])
        print("\n".join(f"{path}: {d:.3g}" for path, d in top))
    else:
        mp.spawn(_rank, args=(sys.argv[1], sys.argv[2:] or list(CASES)), nprocs=4)
        print("RANKS_OK")
