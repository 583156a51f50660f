"""The flash-attention backward kernel against edited copies of itself, on one card.

    python scripts/flash_bwd_variants.py [--variants noring,round_all] [--rows llama,pixtral]

Each variant is ``csrc/flash_attention_bwd.cu`` with one design choice undone
(``VARIANTS``), compiled by ``nvcc`` under ``build/flash_bwd_variants/`` and
loaded with ctypes beside the unedited kernel ("base").  At each of phase
11e's rows (``flash_bwd_ab.ROWS``, inputs drawn from fixed seeds, o and lse
from the forward kernel) every build is timed (CUDA events, the mean of 3
launches after one warm-up) in turns, base first, then in reverse, and its
gradients compared with the base's.  Prints the card's name and power limit
first and a JSON object of every time last.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "flash_bwd_variants"
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

# name -> (what it undoes, [(text of the kernel, its replacement)])
VARIANTS = {
    "noring": ("tile n + 1 awaited as soon as it is issued: no copy overlaps a product", [(
        "    if (n + 1 < n_steps) load_step(n + 1);\n    cp_async_commit();\n",
        "    if (n + 1 < n_steps) load_step(n + 1);\n    cp_async_commit();\n"
        "    cp_async_wait<0>();\n    __syncthreads();\n")]),
    "round_all": ("every operand split rounded on the f32 pipe (split_fp), none truncated", [(
        "    split_tf32::split_trunc(x, hi, lo);", "    split_tf32::split_fp(x, hi, lo);")]),
    "int_split": ("S's operands split rounded on the integer pipe (split), not split_fp", [(
        "    split_tf32::split_fp(x, hi, lo);", "    split_tf32::split(x, hi, lo);")]),
    "hd64_two_blocks": ("hd 64 at two blocks an SM (more registers), not three", [(
        "static constexpr int MINB = HD == 64 ? 3 : HD == 80 ? 2 : 1;",
        "static constexpr int MINB = HD <= 80 ? 2 : 1;")]),
}


def build(names: list[str]) -> dict[str, Path]:
    """Compile the base and each variant (all at once); returns their libraries."""
    source = (CSRC / "flash_attention_bwd.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ["base", *names]:
        text = source
        for old, new in ([] if name == "base" else VARIANTS[name][1]):
            if old not in text:
                raise SystemExit(f"variant {name}: its edit no longer applies to the kernel")
            text = text.replace(old, new)
        cu, lib = OUT / f"{name}.cu", OUT / f"lib_{name}.so"
        cu.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", "-I", str(CSRC), str(cu), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (_, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log[-3000:]}")
    return {name: lib for name, (lib, _) in procs.items()}


def main() -> None:
    args = sys.argv[1:]
    opt = lambda flag, default: args[args.index(flag) + 1] if flag in args else default  # noqa: E731
    from flash_bwd_ab import ROWS

    names = opt("--variants", ",".join(VARIANTS)).split(",")
    rows = opt("--rows", ",".join(ROWS)).split(",")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    for name in names:
        print(f"{name}: {VARIANTS[name][0]}", flush=True)
    libs = build(names)

    import numpy as np
    import torch

    from repro_torch.core.execution import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    fns = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).seifer_flash_attention_bwd
        fn.argtypes, fn.restype = _build.SIGNATURES["seifer_flash_attention_bwd"], ctypes.c_int
        fns[name] = fn
    dev = resolve_device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = {}
    for n, row in enumerate(rows):
        b, s, h, kh, hd, causal, window, softcap = ROWS[row]
        rng = np.random.default_rng(90 + n)
        q, k, v, do = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)
                       for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd), (b, s, h, hd)))
        o, lse = flash_attention_cuda(q, k, v, lse=True, causal=causal, window=window,
                                      softcap=softcap)
        dsum = torch.empty((b, h, s), dtype=torch.float32, device=dev)

        def run(fn):
            out = [torch.empty_like(t) for t in (q, k, v)]
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), dsum.data_ptr(), *(t.data_ptr() for t in out), b, s, h, kh,
                     hd, q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
                     v.stride(1), int(causal), window, softcap, hd**-0.5, stream)
            _build.check(err, "flash_attention_bwd variant")
            return out

        grads, ms = {}, {name: [] for name in fns}
        order = list(fns)
        for turn in (order, order[::-1]):
            for name in turn:
                grads[name] = run(fns[name])
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(3):
                    run(fns[name])
                end.record()
                torch.cuda.synchronize()
                ms[name].append(start.elapsed_time(end) / 3)
        base = grads["base"]
        diff = {name: max(((a - w).abs().max() / w.abs().max()).item()
                          for a, w in zip(grads[name], base)) for name in fns}
        times[row] = {name: sum(t) / len(t) for name, t in ms.items()}
        print(f"{row} {ROWS[row]}: " + "; ".join(
            f"{name} {times[row][name]:.3f} ms (grads {diff[name]:.2g} of max|base| off)"
            for name in fns), flush=True)
        del q, k, v, do, o, lse, dsum, grads
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "ms": times}))


if __name__ == "__main__":
    main()
