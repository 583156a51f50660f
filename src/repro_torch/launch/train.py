"""Training CLI.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --steps 20 \
      [--full] [--batch 8] [--seq 128] [--ckpt-dir /tmp/ckpt] [--device cuda]

The JAX package's ``launch/train.py`` in PyTorch: the same flags, defaults
and printed lines.  Without ``--full`` the arch runs at ``reduced()`` size.
The run goes to the card unless ``--device cpu`` is given; with no CUDA
device it raises (``resolve_device``) rather than falling back to the CPU.
Params are drawn from a generator seeded 0 on the device, each step's
tokens from a second one seeded 1 (a resumed run draws from the start
again, as the JAX CLI's key does); audio archs get ones frames (B, S, d)
and vlm archs ones patches (B, 8, PATCH_DIM), in bf16.  The train step
updates its state in place (``runtime.train``).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.execution import resolve_device
from repro_torch.models import lm
from repro_torch.runtime import train as train_lib
from repro_torch.runtime.checkpoint import Checkpointer


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full", action="store_true", help="full (published-width) config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"family={cfg.family} sharding={cfg.sharding}")

    params = lm.init_params(cfg, torch.Generator(device).manual_seed(0), device=device,
                            max_pos=args.seq)
    state = train_lib.init_state(cfg, params)
    opt = train_lib.OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                              microbatch=args.microbatch,
                              accum_dtype=cfg.opt_state_dtype)
    step_fn = train_lib.make_train_step(cfg, opt)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() >= 0:
        start, state = ckpt.restore(state)
        print(f"resumed from step {start}")

    data = torch.Generator(device).manual_seed(1)
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                                         generator=data, device=device, dtype=torch.int32)}
        if cfg.family == "audio":
            batch["frames"] = torch.ones((args.batch, args.seq, cfg.d_model),
                                         dtype=torch.bfloat16, device=device)
        if cfg.family == "vlm":
            batch["patches"] = torch.ones((args.batch, 8, lm.PATCH_DIM), dtype=torch.bfloat16,
                                          device=device)
        state, m = step_fn(state, batch)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {float(m['loss']):.4f} gnorm {float(m['grad_norm']):.3f}")
        if ckpt and (i + 1) % args.ckpt_every == 0:
            ckpt.save(i + 1, state)
    print(f"{args.steps - start} steps in {time.perf_counter()-t0:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
