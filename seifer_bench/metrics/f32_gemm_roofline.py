"""The f32 products' share of their roofline: the least time of every
``matmul_f32_cuda`` launch in the window (2 m n k FLOPs at 3 TF32 passes,
or the activation, the weight's two TF32 planes and the product over HBM)
over the device time of the split-TF32 GEMM kernel.  It moves
``req_per_s``."""

import importlib.util

from seifer_bench.lib import costs
from seifer_bench.lib.readers import elements, roofline, shape


def _importable(module: str) -> bool:
    try:
        return importlib.util.find_spec(module) is not None
    except ModuleNotFoundError:  # a package above it is missing
        return False


# a program that has no such kernel records no call here, and the metric is
# left out of its line
_OPS = "repro_torch.kernels.gemm.ops"
CALLS = (f"{_OPS}:matmul_f32_cuda",) if _importable(_OPS) else ()
PATTERNS = (r"seifer_gemm_tf32x3",)


def bound(call):
    a, planes = shape(call, 0), shape(call, 1)
    m, k, n = elements(a[:-1]), a[-1], planes[0]
    nbytes = 4 * (m * k + 2 * n * k + m * n)
    return costs.bound_s(nbytes, 2 * m * n * k, costs.F32_PRODUCT_S_PER_FLOP)


def read(obs):
    return roofline(obs, CALLS, PATTERNS, bound)
