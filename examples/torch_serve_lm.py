"""Serve a small LM with batched requests: prefill + decode loop (PyTorch port).

``examples/serve_lm.py`` over ``repro_torch``: drives the real serve step
(KV caches, GQA attention, argmax sampling) for a reduced llama3.2 config on
``--device`` (default cuda; raises without a card).  Params come from a
generator seeded 0 on the device, the prompt from one seeded 1.

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch llama3.2-1b] [--tokens 24] \
        [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.core.execution import resolve_device
from repro_torch.models import lm
from repro_torch.runtime.serve import make_serve_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = reduced(ARCHS[args.arch], layers=4, d_model=256, vocab=4096)
    print(f"serving {cfg.name} (reduced: {cfg.n_layers}L d={cfg.d_model})")
    params = lm.init_params(cfg, torch.Generator(device).manual_seed(0), device=device,
                            max_pos=256)

    b, max_len = args.batch, 128
    caches = lm.init_caches(cfg, b, max_len, enc_len=16, device=device)
    step = make_serve_step(cfg, enc_len=16)

    # "prefill" a short prompt token-by-token (engine-level prefill fills
    # caches in one pass; see runtime/serve.py's make_prefill_step)
    prompt = torch.randint(0, cfg.vocab_size, (b, 4), dtype=torch.int32, device=device,
                           generator=torch.Generator(device).manual_seed(1))
    tok = prompt[:, :1]
    for i in range(prompt.shape[1]):
        tok, caches = step(params, caches, prompt[:, i : i + 1])

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    generated = []
    for _ in range(args.tokens):
        tok, caches = step(params, caches, tok)
        generated.append(tok)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    out = torch.cat(generated, dim=1)
    print(f"generated {args.tokens} tokens x batch {b} in {dt:.2f}s "
          f"({args.tokens * b / dt:.1f} tok/s on {device.type.upper()})")
    print("sample:", out[0, :12].tolist())


if __name__ == "__main__":
    main()
