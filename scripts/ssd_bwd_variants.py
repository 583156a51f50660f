"""The SSD backward kernel against copies of itself with one design step undone.

    python scripts/ssd_bwd_variants.py [EXTRA_TREE ...] [--turns 1] [--rows zamba2,zamba2_b1]
        [--variants no_defer,no_head_ring]

Copies this checkout's ``src/`` into ``build/ssd_bwd_variants/<name>/``
with each variant's text edit (an edit that no longer matches the source
raises), then times this checkout, the variants (all, or those named by
``--variants``) and any extra trees (a
parent unpacked with ``git archive``) with ``scripts/ssd_bwd_ab.py``:
each tree in its own process, turns in order and then in reverse, CUDA
events, two launches equal.  Add a variant as a text edit in ``VARIANTS``.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import ssd_bwd_ab  # noqa: E402

KERNEL_PY = "repro_torch/kernels/ssm_scan/kernel.py"
CU = "repro_torch/kernels/csrc/ssd_scan_bwd.cu"

# step 3 undone: every product on the FMA units in f32, at the same tiling:
# each lane reads the k step's A rows and B columns of its own outputs
FMA_RANGE = '''template <int NTILES, class FA, class FB>
__device__ __forceinline__ void mma_range(float (&acc)[NTILES][4], int ntiles, int ks_begin,
                                          int ks_end, FA fa, FB fb) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  for (int ks = ks_begin; ks < ks_end; ++ks) {
    float ar[2][8];
#pragma unroll
    for (int tp = 0; tp < 4; ++tp) {
      float av[4];
      fa(ks, g, tp, av);
      ar[0][2 * tp] = av[0];
      ar[1][2 * tp] = av[1];
      ar[0][2 * tp + 1] = av[2];
      ar[1][2 * tp + 1] = av[3];
    }
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      if (nt >= ntiles) continue;
      float bc[2][8];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int tp = 0; tp < 4; ++tp) {
          float bv[2];
          fb(ks, nt, 2 * t + j, tp, bv);
          bc[j][2 * tp] = bv[0];
          bc[j][2 * tp + 1] = bv[1];
        }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[nt][e] += ar[e >> 1][k] * bc[e & 1][k];
    }
  }
}

'''

# name: [(file under src/, old text or (start, end) markers, new text)]
VARIANTS = {
    # step 1: the state pass's ring (each chunk's tiles waited for at once)
    "no_ring": [(CU, "    cp_async_wait<1>();\n    __syncthreads();  // chunk k landed",
                 "    cp_async_wait<0>();\n    __syncthreads();  // chunk k landed")],
    # step 2: one head a block (C B^T per head, dB and dC partials per head)
    "head_group_1": [(KERNEL_PY, "HEAD_GROUP = 8", "HEAD_GROUP = 1")],
    # step 2: the chunk kernel's head ring (heads 0 and 1 land before any
    # math, every later head's tiles are waited for as soon as they are asked)
    "no_head_ring": [
        (CU, "  cp_async_wait<1>();\n  __syncthreads();\n\n  // warp k: head k's cum",
         "  cp_async_wait<0>();\n  __syncthreads();\n\n  // warp k: head k's cum"),
        (CU, "    cp_async_wait<1>();  // head k + 1 landed",
         "    cp_async_wait<0>();  // head k + 1 landed")],
    # step 2: warp 0 takes a head's row vectors after its last phase, with
    # the other warps waiting, not beside the next head's first phase
    "no_defer": [
        (CU, "    if (warp == 0 && k > 0) row_vectors(k - 1);  // beside the other warps' phase 1\n",
         ""),
        (CU, "    if (k + 2 < gn) stage_head(k + 2);",
         "    if (warp == 0) row_vectors(k);\n    if (k + 2 < gn) stage_head(k + 2);"),
        (CU, "  if (warp == 0) row_vectors(gn - 1);\n", "")],
    # step 3: the products on the FMA units
    "fma": [(CU, ("template <int NTILES, class FA, class FB>",
                  "// Fragment reads of a shared tile"), FMA_RANGE)],
}


def make_variant(name: str) -> Path:
    """A copy of this checkout's src/ with ``name``'s edits applied."""
    tree = ROOT / "build" / "ssd_bwd_variants" / name
    if (tree / "src").exists():
        shutil.rmtree(tree / "src")
    shutil.copytree(ROOT / "src", tree / "src",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    for rel, old, new in VARIANTS[name]:
        path = tree / "src" / rel
        text = path.read_text()
        if isinstance(old, tuple):
            start, end = text.find(old[0]), text.find(old[1])
            if start < 0 or end < start:
                raise SystemExit(f"variant {name}: markers not found in {rel}")
            text = text[:start] + new + text[end:]
        else:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} not found once in {rel}")
            text = text.replace(old, new)
        path.write_text(text)
    return tree


def main() -> None:
    args = sys.argv[1:]
    extra = [a for i, a in enumerate(args) if not a.startswith("--")
             and (i == 0 or not args[i - 1].startswith("--"))]
    opts = [a for a in args if a not in extra]
    names = list(VARIANTS)
    if "--variants" in opts:
        at = opts.index("--variants")
        names = opts[at + 1].split(",")
        del opts[at:at + 2]
    trees = [str(ROOT)] + [str(make_variant(name)) for name in names] + extra
    ssd_bwd_ab.main(trees + opts)


if __name__ == "__main__":
    main()
