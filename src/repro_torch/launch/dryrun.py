"""Multi-pod dry run: run every (arch x shape) step once on the production
meshes, with fake tensors, and record memory, cost and collective
statistics of one rank.

The JAX package's ``launch/dryrun.py`` in PyTorch, with the same CLI.
Where it lowers and compiles each step for 256 or 512 forced host devices
and reads the HLO, this builds the production mesh of CUDA devices on a
fake process group (``launch/mesh.py``), places params, state, caches and
batch on it by the sharding policy as DTensors whose local tensors are
rank 0's shards on the meta device (shapes only, no storage), and runs the
step once under ``OpCostMode`` (``op_cost.py``): the ops rank 0 runs, with
the collectives DTensor inserts, counted as they run.  Meta tensors take
the kernels' path (``core/execution.on_kernel_path``), so the LM kernels'
custom ops run their fake implementations and count their registered
costs.  No card is needed.  (Meta local tensors, not ``FakeTensorMode``:
DTensor sizes a strided shard with ``torch.arange(...).tolist()``, which
an enclosing ``FakeTensorMode`` refuses as data-dependent.)

Record keys are the JAX record's where the meaning holds; ``gflops_per_chip``
and ``gbytes_per_chip`` replace ``hlo_*``, ``trace_s`` replaces
``compile_s``, and ``hbm_per_chip_gb`` is the peak of live local bytes (the
params, state and batch included).  The XLA-only keys (``xla_flops_once``,
``*_size_in_bytes``) have no counterpart.  The roofline terms use the
H100's constants (``launch/mesh.py``).

The fake process group is process-wide: one process runs one mesh's
cells, and ``--mesh both`` runs each mesh in a child process of its own,
the two at once.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out results/dryrun_torch.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_cells
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import (
    HBM_BW,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
    make_production_mesh,
)
from repro_torch.launch.op_cost import OpCostMode
from repro_torch.runtime import serve as serve_lib
from repro_torch.runtime import train as train_lib
from repro_torch.sharding import (
    ShardingPolicy,
    batch_shardings,
    cache_shardings,
    param_shardings,
    state_shardings,
)
from repro_torch.sharding.policy import _at, _map_with_path, local_shape, placements

BIG_PARAMS = 1e9  # models above this train with gradient accumulation


def fake_placed(tree, specs, mesh):
    """Each meta leaf of ``tree`` as a DTensor whose local tensor is this
    rank's shard, a meta tensor, placed by the spec on the same path.  Ints
    (a cache's ``pos``) stay as they are."""
    from torch.distributed.tensor import DTensor

    def leaf(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        spec = _at(specs, path)
        local = torch.empty(local_shape(tuple(x.shape), spec, mesh), dtype=x.dtype,
                            device="meta")
        return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                                  shape=x.shape, stride=torch.empty(x.shape,
                                                                    device="meta").stride())

    return _map_with_path(leaf, tree)


def build_cell(arch: str, shape_name: str, mesh):
    """(step, args, cfg, shape): the step function of one dry-run cell and
    its placed, shape-only arguments."""
    return build_step(get_config(arch), SHAPES[shape_name], mesh)


def microbatch_for(cfg, shape) -> int:
    """The train step's microbatch: a model of ``BIG_PARAMS`` or more
    accumulates over 8 microbatches (``REPRO_MICROBATCH`` sets it)."""
    micro = 0
    if cfg.param_count() >= BIG_PARAMS:
        micro = max(shape.global_batch // 8, 1)
    if os.environ.get("REPRO_MICROBATCH"):  # microbatch sweeps
        micro = int(os.environ["REPRO_MICROBATCH"])
    return micro


def build_step(cfg, shape, mesh, *, microbatch: int | None = None):
    """``build_cell`` for any config and shape (reduced ones in the tests);
    ``microbatch`` in place of ``microbatch_for``'s."""
    policy = ShardingPolicy(cfg, mesh)

    if shape.kind == "train":
        micro = microbatch_for(cfg, shape) if microbatch is None else microbatch
        opt = train_lib.OptConfig(microbatch=micro, accum_dtype=cfg.opt_state_dtype)
        step = train_lib.make_train_step(cfg, opt, policy)
        state = specs_lib.state_specs(cfg, shape)
        batch = specs_lib.input_specs(cfg, shape)
        args = (fake_placed(state, state_shardings(cfg, mesh, state), mesh),
                fake_placed(batch, batch_shardings(mesh, batch), mesh))
        return step, args, cfg, shape

    params = specs_lib.param_specs(cfg, shape)
    p = fake_placed(params, param_shardings(cfg, mesh, params), mesh)
    if shape.kind == "prefill":
        step = serve_lib.make_prefill_step(cfg, policy)
        batch = specs_lib.input_specs(cfg, shape)
        return step, (p, fake_placed(batch, batch_shardings(mesh, batch), mesh)), cfg, shape

    # decode
    enc_len = shape.seq_len if cfg.family == "audio" else 0
    step = serve_lib.make_serve_step(cfg, policy, enc_len=enc_len)
    caches = specs_lib.cache_specs(cfg, shape)
    c = fake_placed(caches, cache_shardings(cfg, mesh, caches, shape.global_batch), mesh)
    tokens = specs_lib.input_specs(cfg, shape)
    t = fake_placed(tokens, batch_shardings(mesh, tokens), mesh)["tokens"]
    return step, (p, c, t), cfg, shape


def model_flops(cfg, shape) -> float:
    """6·N_active·D (train) or 2·N_active·D (inference) useful FLOPs."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    return (6.0 if shape.kind == "train" else 2.0) * n * tokens


def analyse(step, args, cfg, shape, mesh) -> dict:
    """Run the step once under op counting; the record of the cell."""
    chips = mesh.size()
    rec: dict = {
        "arch": cfg.name, "shape": shape.name, "chips": chips,
        "mesh": "x".join(map(str, tuple(mesh.shape))),
    }
    t0 = time.time()
    with OpCostMode(track_memory=True, external=args) as counter:
        step(*args)
    rec["trace_s"] = round(time.time() - t0, 1)
    cost = counter.result()
    rec["gflops_per_chip"] = cost.flops / 1e9
    rec["gbytes_per_chip"] = cost.bytes / 1e9
    rec["hbm_per_chip_gb"] = round(cost.peak_bytes / 1e9, 3)
    rec["collective_bytes_per_chip"] = cost.total_collective_bytes
    rec["collective_ops"] = cost.collective_count
    rec["collective_bytes_by_op"] = cost.collective_bytes

    # --- roofline terms (seconds) ---
    rec["t_compute"] = cost.flops / PEAK_FLOPS_BF16
    rec["t_memory"] = cost.bytes / HBM_BW
    # every byte at NVLink's rate: a lower bound (mesh.py)
    rec["t_collective"] = cost.total_collective_bytes / NVLINK_BW
    terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
             "collective": rec["t_collective"]}
    rec["bottleneck"] = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    rec["model_gflops_total"] = mf / 1e9
    rec["useful_flops_ratio"] = mf / (cost.flops * chips) if cost.flops else 0.0
    rec["roofline_frac"] = (
        rec["t_compute"] / max(terms.values()) if max(terms.values()) > 0 else 0.0
    )
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, mesh=None) -> dict:
    """One cell's record (``ok`` False with the error where it fails).  The
    production mesh is built here unless given; a process holds one."""
    try:
        if mesh is None:
            mesh = make_production_mesh(multi_pod=multi_pod)
        step, args, cfg, shape = build_cell(arch, shape_name, mesh)
        rec = analyse(step, args, cfg, shape, mesh)
        rec["ok"] = True
    except Exception as e:  # record failures; the report lists them
        rec = {
            "arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "ok": False, "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:],
        }
    return rec


def _print(rec: dict) -> None:
    status = "OK " if rec.get("ok") else "FAIL"
    extra = (
        f"trace={rec.get('trace_s')}s hbm/chip={rec.get('hbm_per_chip_gb')}GB "
        f"bottleneck={rec.get('bottleneck')} roofline={rec.get('roofline_frac', 0):.2f}"
        if rec.get("ok") else rec.get("error", "")
    )
    print(f"[{status}] {rec['arch']} x {rec['shape']} @ {rec.get('mesh')}  {extra}", flush=True)


def run_cells(cells: list[tuple[str, str]], multi_pod: bool) -> list[dict]:
    """The cells of one mesh, in this process (which holds that mesh)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    results = []
    for arch, sh in cells:
        rec = run_cell(arch, sh, multi_pod=multi_pod, mesh=mesh)
        results.append(rec)
        _print(rec)
    return results


def _in_children(cells: list[tuple[str, str]], meshes: list[bool]) -> list[dict]:
    """The cells of each mesh in a child process of its own (its own fake
    group), the children running at once."""
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for multi_pod in meshes:
            name = "multi" if multi_pod else "single"
            out = os.path.join(tmp, f"{name}.json")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
                   json.dumps(cells), "--mesh", name, "--out", out]
            runs.append((name, out, subprocess.Popen(cmd)))
        results = []
        for name, out, proc in runs:
            proc.wait()
            if not os.path.exists(out):
                raise RuntimeError(f"the dry run's child process for the {name}-pod mesh "
                                   f"wrote nothing (exit {proc.returncode})")
            with open(out) as f:
                results += json.load(f)
        return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cells", default=None, help=argparse.SUPPRESS)  # JSON [[arch, shape]]
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.cells:
        cells = [tuple(c) for c in json.loads(args.cells)]
    elif args.all:
        cells = [(name, sh) for name, cfg in ARCHS.items() for sh in shape_cells(cfg)]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    results = run_cells(cells, meshes[0]) if len(meshes) == 1 else _in_children(cells, meshes)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {len(results)} records to {args.out}")
    return 0 if all(r.get("ok") for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
