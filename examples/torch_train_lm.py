"""Train a small LM end-to-end (PyTorch port): synthetic data pipeline,
AdamW, grad clip, checkpoint/restore mid-run (fault-tolerance path
exercised for real).

``examples/train_lm.py`` over ``repro_torch``, on ``--device`` (default
cuda; raises without a card).  The stream is the JAX script's law drawn in
torch (``repro_torch.workload.tokens.bigram_stream``); params come from a
generator seeded 0 on the device.  The train step updates its state in
place.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 60] [--device cpu]
"""

import argparse
import tempfile
import time

import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.core.execution import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves
from repro_torch.runtime import train as train_lib
from repro_torch.runtime.checkpoint import Checkpointer
from repro_torch.workload.tokens import bigram_stream


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = reduced(ARCHS["llama3.2-1b"], layers=4, d_model=256, vocab=2048)
    params = lm.init_params(cfg, torch.Generator(device).manual_seed(0), device=device,
                            max_pos=args.seq)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"training {cfg.name} (reduced, {n_params/1e6:.1f}M params)")

    state = train_lib.init_state(cfg, params)
    opt = train_lib.OptConfig(lr=3e-3, warmup_steps=10)
    step_fn = train_lib.make_train_step(cfg, opt)
    stream = bigram_stream(cfg.vocab_size, args.batch, args.seq, device=device)

    with tempfile.TemporaryDirectory(prefix="ckpt-") as directory:
        ckpt = Checkpointer(directory)
        t0 = time.perf_counter()
        for i in range(args.steps):
            state, metrics = step_fn(state, next(stream))
            if i % 10 == 0 or i == args.steps - 1:
                print(f"step {i:4d}  loss {float(metrics['loss']):.4f}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
            if i == args.steps // 2:
                ckpt.save(i, state)  # mid-run checkpoint
                _, state = ckpt.restore(state)  # ...and prove restore works
                print(f"checkpoint saved+restored at step {i}")
        print(f"done in {time.perf_counter()-t0:.1f}s")


if __name__ == "__main__":
    main()
