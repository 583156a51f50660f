"""The fused receive's share of its roofline: the least time of every
``dequant_matmul`` launch in the window (2 m n k FLOPs at 2 bf16 passes, or
its bytes over HBM, ``costs.dequant_matmul_cost``) over the device time of
its kernel.  It moves ``req_per_s``."""

from seifer_bench.lib import costs
from seifer_bench.lib.readers import arg, elements, roofline, shape

CALLS = ("repro_torch.kernels.quantize.ops:dequant_matmul_cuda",)
PATTERNS = (r"dequant_matmul_kernel",)


def bound(call):
    q, w = shape(call, 0), shape(call, 2)
    block = arg(call, 4, "block") or q[-1] // shape(call, 1)[-1]
    flops, nbytes = costs.dequant_matmul_cost(elements(q[:-1]), q[-1], w[-1], block)
    return costs.bound_s(nbytes, flops, costs.CODE_PRODUCT_S_PER_FLOP)


def read(obs):
    return roofline(obs, CALLS, PATTERNS, bound)
